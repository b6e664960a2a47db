"""RT-DETR with a ResNet-50-vd backbone (Zhao et al., "DETRs Beat YOLOs on
Real-time Object Detection", CVPR 2024; github.com/lyuwenyu/RT-DETR; the
published configuration huggingface.co/PekingU/rtdetr_r50vd) at the
configuration's widths: the forward in plain f32 PyTorch on the reference's
graph, the published NMS-free answer, the FLOP count, the leaf shapes and
the calibration of seeded weights.

Written from the published equations (``transformers``' ``modeling_rt_
detr.py`` and ``modeling_rt_detr_resnet.py`` in eval form), not from the
program: BN unfolded, both branches of every RepVGG unit, attention as two
matrix products and a softmax, the deformable sampling as one
``grid_sample`` a level (``align_corners=False``, zero padding) and a
weighted sum. The harness runs it with TF32 off; ``forward`` refuses a CUDA
input where TF32 is allowed.

Departures from the published model: the denoising queries and their
class embedding are training-only and left out; only the last decoder
layer's class head is evaluated (the earlier ones feed the training
losses); the class count is the configuration's ``nc``.

Weights are flax-format paths (``params/backbone/s1/b0/cv2/conv/kernel``,
``params/decoder/layer0/cross/offsets/kernel`` as a 1x1 HWIO kernel,
``params/decoder/enc_norm/scale``), the names of the program's module tree.

Seeded weights (``seeded_unit_variance``; the configuration's ``weights``):
each convolution is rescaled, in the order it runs, to output deviation
``conv_output_std`` over the calibration tiles; the decoder's residual
branches (self-attention output, cross-attention output, FFN) to
``residual_std``, their outputs made orthogonal to the encoder class
head's directions and to the mean, so that they move a query's box and
not its class evidence; the sampling offsets get the published
directional bias and a kernel of deviation ``offset_std``; each class of
the encoder's class head unit deviation over the tokens; every decoder class head the encoder class
head's directions, with one scale and offset for all classes: the best
class's logit of unit deviation over the selected queries, and that of
``class_share_above`` of them clearing ``threshold``; the box
heads' last layers deviation ``box_logit_std``, and the encoder box head a
bias on (w, h) that makes the median box of the queries it selects
``box_prior_px`` across, about a car. A query's final score then follows its encoder score: the queries
that clear the threshold are the encoder's best, far from rank
``num_queries``, where bf16 and f32 swap queries in and out.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference import models


class Net(models.Graph):
    """The family's ops on the flat weights: ConvBN with any activation,
    linear layers (1x1 HWIO kernels), layer norms and attention, each
    counting its FLOPs; ``_tune_*`` are the calibration's hooks."""

    def __init__(self, weights, cfg):
        super().__init__(weights, "none", cfg["batch_norm_eps"])
        self.ln_eps = cfg["layer_norm_eps"]

    def _tune_conv(self, name, x, stride):
        pass

    def _tune_linear(self, name, x):
        pass

    def cbn(self, name, x, stride=1, act="none"):
        self._tune_conv(name, x, stride)
        k = self.w[f"params/{name}/conv/kernel"].permute(3, 2, 0, 1)
        y = F.conv2d(x, k, stride=stride, padding=(k.shape[-1] - 1) // 2)
        self.flops += 2.0 * k[0].numel() * y.numel()
        mean = self.w[f"batch_stats/{name}/bn/mean"]
        var = self.w[f"batch_stats/{name}/bn/var"]
        scale = self.w[f"params/{name}/bn/scale"] / torch.sqrt(var + self.eps)
        y = (y - mean[:, None, None]) * scale[:, None, None] \
            + self.w[f"params/{name}/bn/bias"][:, None, None]
        return {"relu": F.relu, "silu": F.silu,
                "none": lambda t: t}[act](y)

    def linear(self, name, x):
        self._tune_linear(name, x)
        k = self.w[f"params/{name}/kernel"][0, 0]            # [I, O]
        self.flops += 2.0 * (x.numel() // x.shape[-1]) * k.numel()
        return x @ k + self.w[f"params/{name}/bias"]

    def ln(self, name, x):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"params/{name}/scale"],
                            self.w[f"params/{name}/bias"], self.ln_eps)

    def mlp(self, name, x, n):
        for i in range(n):
            x = self.linear(f"{name}/l{i}", x)
            if i < n - 1:
                x = F.relu(x)
        return x

    def attention(self, name, x, pos, heads):
        """Multi-head self-attention, position on queries and keys."""
        b, n, d = x.shape
        dh = d // heads

        def split(t):
            return t.view(b, n, heads, dh).transpose(1, 2)
        q = split(self.linear(f"{name}/q", x + pos) * dh ** -0.5)
        k = split(self.linear(f"{name}/k", x + pos))
        v = split(self.linear(f"{name}/v", x))
        a = torch.softmax(q @ k.transpose(-1, -2), -1) @ v
        self.flops += 2.0 * 2.0 * b * heads * n * n * dh
        return self.linear(f"{name}/out", a.transpose(1, 2).reshape(b, n, d))


def _backbone(g, cfg, x):
    x = g.cbn("backbone/stem0", x, 2, "relu")
    x = g.cbn("backbone/stem1", x, 1, "relu")
    x = g.cbn("backbone/stem2", x, 1, "relu")
    x = F.max_pool2d(x, 3, 2, 1)
    c = cfg["backbone_embedding_size"]
    outs = []
    for i, (w, depth) in enumerate(zip(cfg["backbone_hidden_sizes"],
                                       cfg["backbone_depths"])):
        for j in range(depth):
            stride = 2 if i > 0 and j == 0 else 1
            p = f"backbone/s{i}/b{j}"
            y = g.cbn(f"{p}/cv1", x, 1, "relu")
            y = g.cbn(f"{p}/cv2", y, stride, "relu")
            y = g.cbn(f"{p}/cv3", y)
            s = x
            if stride == 2:
                s = F.avg_pool2d(s, 2, 2, 0, ceil_mode=True)
            if j == 0 and (c != w or stride != 1):
                s = g.cbn(f"{p}/short", s)
            x = F.relu(y + s)
            c = w
        outs.append(x)
    return outs[1:]


def sincos(h, w, d, temperature, device):
    """The published 2-D sin-cos positions, [1, h*w, d] (its meshgrid is
    indexed (w, h))."""
    gw, gh = torch.meshgrid(torch.arange(w, device=device).float(),
                            torch.arange(h, device=device).float(),
                            indexing="ij")
    q = d // 4
    omega = 1.0 / temperature ** (torch.arange(q, device=device).float() / q)
    ow = gw.flatten()[..., None] @ omega[None]
    oh = gh.flatten()[..., None] @ omega[None]
    return torch.concat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1)[None]


def _csp(g, name, x, blocks=3):
    y = g.cbn(f"{name}/cv1", x, 1, "silu")
    for k in range(blocks):
        y = F.silu(g.cbn(f"{name}/m{k}/c3", y) + g.cbn(f"{name}/m{k}/c1", y))
    return y + g.cbn(f"{name}/cv2", x, 1, "silu")


def _encoder(g, cfg, feats):
    feats = [g.cbn(f"encoder/proj{i}", f) for i, f in enumerate(feats)]
    top = feats[2]
    b, c, h, w = top.shape
    src = top.flatten(2).permute(0, 2, 1)
    pos = sincos(h, w, c, cfg["positional_encoding_temperature"],
                 top.device)
    src = g.ln("encoder/aifi/ln1", src + g.attention(
        "encoder/aifi/attn", src, pos, cfg["encoder_attention_heads"]))
    ffn = g.linear("encoder/aifi/fc2",
                   F.gelu(g.linear("encoder/aifi/fc1", src)))
    src = g.ln("encoder/aifi/ln2", src + ffn)
    feats[2] = src.permute(0, 2, 1).reshape(b, c, h, w)
    fpn = [feats[2]]
    for i in range(2):
        lat = g.cbn(f"encoder/lateral{i}", fpn[-1], 1, "silu")
        fpn[-1] = lat
        up = F.interpolate(lat, scale_factor=2.0, mode="nearest")
        fpn.append(_csp(g, f"encoder/fpn{i}", torch.cat([up, feats[1 - i]],
                                                         1)))
    fpn = fpn[::-1]
    pan = [fpn[0]]
    for i in range(2):
        down = g.cbn(f"encoder/down{i}", pan[-1], 2, "silu")
        pan.append(_csp(g, f"encoder/pan{i}", torch.cat([down, fpn[i + 1]],
                                                        1)))
    return pan


def _anchors(shapes, device):
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, device=device).float(),
                                torch.arange(w, device=device).float(),
                                indexing="ij")
        xy = torch.stack([gx, gy], -1)[None] + 0.5
        xy[..., 0] /= w
        xy[..., 1] /= h
        wh = torch.ones_like(xy) * 0.05 * (2.0 ** lvl)
        out.append(torch.concat([xy, wh], -1).reshape(-1, h * w, 4))
    a = torch.concat(out, 1)
    valid = ((a > 1e-2) * (a < 1 - 1e-2)).all(-1, keepdim=True)
    a = torch.log(a / (1 - a))
    return torch.where(valid, a, torch.tensor(torch.finfo(torch.float32).max,
                                              device=device)), valid


def sample(value, shapes, loc, weights):
    """The deformable sampling as published: value [B,L,heads,D], loc
    [B,Q,heads,levels,points,2] in [0,1], weights [B,Q,heads,levels,points]
    → [B,Q,heads*D]."""
    b, _, heads, d = value.shape
    _, q, _, levels, points, _ = loc.shape
    parts = value.split([h * w for h, w in shapes], 1)
    grids = 2 * loc - 1
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        v = parts[lvl].flatten(2).transpose(1, 2).reshape(b * heads, d, h, w)
        gl = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, gl, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    wt = weights.transpose(1, 2).reshape(b * heads, 1, q, levels * points)
    out = (torch.stack(sampled, -2).flatten(-2) * wt).sum(-1)
    return out.view(b, heads * d, q).transpose(1, 2)


def _inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _decoder_layer(g, cfg, i, h, pos, ref, memory, shapes):
    p = f"decoder/layer{i}"
    heads = cfg["decoder_attention_heads"]
    h = g.ln(f"{p}/ln1", h + g.attention(f"{p}/attn", h, pos, heads))
    b, q, d = h.shape
    lv, pt = cfg["num_feature_levels"], cfg["decoder_n_points"]
    query = h + pos
    value = g.linear(f"{p}/cross/value", memory).view(b, -1, heads,
                                                      d // heads)
    off = g.linear(f"{p}/cross/offsets", query).view(b, q, heads, lv, pt, 2)
    w = torch.softmax(g.linear(f"{p}/cross/weights", query)
                      .view(b, q, heads, lv * pt), -1).view(b, q, heads, lv,
                                                            pt)
    r = ref[:, :, None, None, None]
    loc = r[..., :2] + off / pt * r[..., 2:] * 0.5
    cross = g.linear(f"{p}/cross/out", sample(value, shapes, loc, w))
    h = g.ln(f"{p}/ln2", h + cross)
    ffn = g.linear(f"{p}/fc2", F.relu(g.linear(f"{p}/fc1", h)))
    return g.ln(f"{p}/ln3", h + ffn)


def forward(cfg, w, x):
    """x [B,3,S,S] in [0,1] → {"enc_scores" [B,L,nc] (the encoder's class
    logits over every token), "topk" [B,Q] (the selected tokens), "logits"
    [B,Q,nc], "boxes" [B,Q,4] (cx, cy, w, h in [0, 1])}."""
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("the reference runs in f32: turn TF32 off")
    g = w if isinstance(w, models.Graph) else Net(w, cfg)
    feats = _encoder(g, cfg, _backbone(g, cfg, x))
    srcs = [g.cbn(f"decoder/proj{i}", f) for i, f in enumerate(feats)]
    shapes = [tuple(s.shape[-2:]) for s in srcs]
    memory = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
    anchors, valid = _anchors(shapes, x.device)
    g.anchors, g.size = anchors, x.shape[-1]
    om = g.ln("decoder/enc_norm", g.linear("decoder/enc_output",
                                           valid.float() * memory))
    enc_scores = g.linear("decoder/enc_score", om)
    enc_boxes = g.mlp("decoder/enc_bbox", om, 3) + anchors
    topk = torch.topk(enc_scores.max(-1).values, cfg["num_queries"],
                      dim=1).indices
    ref = torch.sigmoid(enc_boxes.gather(
        1, topk.unsqueeze(-1).repeat(1, 1, 4)))
    h = om.gather(1, topk.unsqueeze(-1).repeat(1, 1, om.shape[-1]))
    n = cfg["decoder_layers"]
    for i in range(n):
        pos = g.mlp("decoder/query_pos", ref, 2)
        h = _decoder_layer(g, cfg, i, h, pos, ref, memory, shapes)
        ref = torch.sigmoid(g.mlp(f"decoder/bbox{i}", h, 3)
                            + _inverse_sigmoid(ref))
    logits = g.linear(f"decoder/class{n - 1}", h)
    return {"enc_scores": enc_scores, "topk": topk, "logits": logits,
            "boxes": ref}


def answer(cfg, w, x, *, conf, iou_thr, max_det, pre_topk):
    """Per image of x, (box [N,4] cxcywh px, score [N], class [N]): the
    published post-process with focal-loss scores, no NMS: sigmoid, the
    top ``max_det`` over query x class, kept where the score exceeds
    ``conf``. ``iou_thr`` and ``pre_topk`` are not used."""
    out = forward(cfg, w, x)
    scores = torch.sigmoid(out["logits"])
    b, q, nc = scores.shape
    top, idx = torch.topk(scores.flatten(1), min(max_det, q * nc), dim=-1)
    labels = idx % nc
    boxes = out["boxes"].gather(1, (idx // nc).unsqueeze(-1).repeat(1, 1, 4))
    boxes = boxes * x.shape[-1]
    res = []
    for r in range(b):
        k = top[r] > conf
        res.append((boxes[r, k].double().cpu().numpy(),
                    top[r, k].double().cpu().numpy(),
                    labels[r, k].cpu().numpy()))
    return res


def flops(cfg, weights, batch, size):
    """Twice the multiply-adds of the convolutions, linear layers and
    attention products of one forward over [batch, 3, size, size], on the
    meta device; the bilinear sampling's arithmetic (0.05 GFLOP a 640-px
    tile, under 0.1 % of the forward's) is left out."""
    meta = {k: torch.empty(v.shape, device="meta")
            for k, v in weights.items()}
    g = Net(meta, cfg)
    forward(cfg, g, torch.empty(batch, 3, size, size, device="meta"))
    return g.flops


def shapes(cfg):
    """Flax-path leaf shapes at the configuration's widths: {path: shape}."""
    out = {}
    nc = cfg["nc"]

    def conv(name, cin, cout, k=1):
        out[f"params/{name}/conv/kernel"] = (k, k, cin, cout)
        for leaf in ("params/{}/bn/scale", "params/{}/bn/bias",
                     "batch_stats/{}/bn/mean", "batch_stats/{}/bn/var"):
            out[leaf.format(name)] = (cout,)

    def linear(name, cin, cout):
        out[f"params/{name}/kernel"] = (1, 1, cin, cout)
        out[f"params/{name}/bias"] = (cout,)

    def ln(name, d):
        out[f"params/{name}/scale"] = (d,)
        out[f"params/{name}/bias"] = (d,)

    def mlp(name, dims):
        for i in range(len(dims) - 1):
            linear(f"{name}/l{i}", dims[i], dims[i + 1])

    def attn(name, d):
        for p in ("q", "k", "v", "out"):
            linear(f"{name}/{p}", d, d)

    e = cfg["backbone_embedding_size"]
    conv("backbone/stem0", 3, e // 2, 3)
    conv("backbone/stem1", e // 2, e // 2, 3)
    conv("backbone/stem2", e // 2, e, 3)
    c = e
    for i, (w, depth) in enumerate(zip(cfg["backbone_hidden_sizes"],
                                       cfg["backbone_depths"])):
        for j in range(depth):
            p = f"backbone/s{i}/b{j}"
            cin = c if j == 0 else w
            conv(f"{p}/cv1", cin, w // 4)
            conv(f"{p}/cv2", w // 4, w // 4, 3)
            conv(f"{p}/cv3", w // 4, w)
            if j == 0:
                conv(f"{p}/short", cin, w)
        c = w
    d = cfg["encoder_hidden_dim"]
    for i, cin in enumerate(cfg["encoder_in_channels"]):
        conv(f"encoder/proj{i}", cin, d)
    attn("encoder/aifi/attn", d)
    ln("encoder/aifi/ln1", d)
    linear("encoder/aifi/fc1", d, cfg["encoder_ffn_dim"])
    linear("encoder/aifi/fc2", cfg["encoder_ffn_dim"], d)
    ln("encoder/aifi/ln2", d)
    for i in range(2):
        conv(f"encoder/lateral{i}", d, d)
        conv(f"encoder/down{i}", d, d, 3)
        for blk in (f"encoder/fpn{i}", f"encoder/pan{i}"):
            conv(f"{blk}/cv1", 2 * d, d)
            conv(f"{blk}/cv2", 2 * d, d)
            for k in range(3):
                conv(f"{blk}/m{k}/c3", d, d, 3)
                conv(f"{blk}/m{k}/c1", d, d)
    dm = cfg["d_model"]
    heads, lv = cfg["decoder_attention_heads"], cfg["num_feature_levels"]
    pt, ffn = cfg["decoder_n_points"], cfg["decoder_ffn_dim"]
    for i in range(lv):
        conv(f"decoder/proj{i}", d, dm)
    linear("decoder/enc_output", dm, dm)
    ln("decoder/enc_norm", dm)
    linear("decoder/enc_score", dm, nc)
    mlp("decoder/enc_bbox", (dm, dm, dm, 4))
    mlp("decoder/query_pos", (4, 2 * dm, dm))
    for i in range(cfg["decoder_layers"]):
        p = f"decoder/layer{i}"
        attn(f"{p}/attn", dm)
        ln(f"{p}/ln1", dm)
        linear(f"{p}/cross/offsets", dm, heads * lv * pt * 2)
        linear(f"{p}/cross/weights", dm, heads * lv * pt)
        linear(f"{p}/cross/value", dm, dm)
        linear(f"{p}/cross/out", dm, dm)
        ln(f"{p}/ln2", dm)
        linear(f"{p}/fc1", dm, ffn)
        linear(f"{p}/fc2", ffn, dm)
        ln(f"{p}/ln3", dm)
        linear(f"decoder/class{i}", dm, nc)
        mlp(f"decoder/bbox{i}", (dm, dm, dm, 4))
    return out


class _Calibrate(Net):
    """The forward with the weights set as the module's docstring says,
    in the order they run."""

    RESIDUAL = ("/attn/out", "/cross/out", "/fc2")

    def __init__(self, weights, cfg):
        super().__init__(weights, cfg)
        self.cfg = cfg
        self.spec = cfg["weights"]

    def _rescale(self, key, out, std):
        self.w[key] *= std / out.std()

    def _tune_conv(self, name, x, stride):
        key = f"params/{name}/conv/kernel"
        k = self.w[key].permute(3, 2, 0, 1)
        out = F.conv2d(x, k, stride=stride, padding=(k.shape[-1] - 1) // 2)
        self._rescale(key, out, self.spec["conv_output_std"])

    def _tune_linear(self, name, x):
        key = f"params/{name}/kernel"
        bias = self.w[f"params/{name}/bias"]
        out = x @ self.w[key][0, 0]
        if name.startswith("decoder/layer") and name.endswith(self.RESIDUAL):
            self._rescale(key, out, self.spec["residual_std"])
            # the branch's output orthogonal to the class directions and
            # to the mean, which the layer norm after it subtracts
            k = self.w[key][0, 0]
            basis = torch.cat([torch.ones_like(k[:1]).T, self.w[
                "params/decoder/enc_score/kernel"][0, 0]], 1)
            q, _ = torch.linalg.qr(basis)
            self.w[key][0, 0] = k - (k @ q) @ q.T
        elif name.endswith("/cross/offsets"):
            self._rescale(key, out, self.spec["offset_std"])
            bias.copy_(_grid_bias(self.cfg).to(bias))
        elif name == "decoder/enc_score":
            # each class at unit deviation over the tokens
            self.w[key][0, 0] /= out.reshape(-1, out.shape[-1]).std(0)
            self.om = x
        elif name.endswith("/l2") and "bbox" in name:
            self._rescale(key, out, self.spec["box_logit_std"])
            if name == "decoder/enc_bbox/l2":
                # (w, h) of the queries the encoder will select about
                # box_prior_px, whichever levels they come from
                best = self.linear("decoder/enc_score", self.om).max(-1)
                top = torch.topk(best.values, self.cfg["num_queries"],
                                 dim=1).indices
                wh = self.anchors[0, :, 2][top].median()
                p = self.spec["box_prior_px"] / self.size
                bias.copy_(torch.tensor([0.0, 0.0] + [
                    float(math.log(p / (1 - p)) - wh)] * 2))
        elif name.startswith("decoder/class"):
            # the encoder class head's directions, one scale and offset for
            # every class, so that the best class of the share
            # class_share_above of the selected queries clears threshold
            # and the best class ranks the queries as the selection did
            k = self.w["params/decoder/enc_score/kernel"][0, 0].clone()
            best = (x @ k).max(-1).values.flatten()
            mean, std = best.mean(), best.std()
            self.w[key][0, 0] = k / std
            top = torch.quantile((best - mean) / std,
                                 1.0 - self.spec["class_share_above"])
            t = self.spec["threshold"]
            bias.fill_(float(-mean / std + math.log(t / (1 - t)) - top))


def _grid_bias(cfg):
    """The published initial sampling offsets: head h's points along the
    direction 2 pi h / heads, point p at p + 1 times the unit step, the
    same on every level."""
    heads, lv = cfg["decoder_attention_heads"], cfg["num_feature_levels"]
    pt = cfg["decoder_n_points"]
    theta = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid.view(heads, 1, 1, 2).repeat(1, lv, pt, 1)
    grid *= torch.arange(1, pt + 1, dtype=torch.float32).view(1, 1, pt, 1)
    return grid.flatten()


def calibrate(cfg, w, x):
    """Rescales the drawn weights ``w`` in place over the calibration
    images x [B,3,S,S] f32 in [0,1]."""
    forward(cfg, _Calibrate(w, cfg), x)
