"""RT-DETR with a ResNet-50-vd backbone (Zhao et al., "DETRs Beat YOLOs on
Real-time Object Detection", CVPR 2024; github.com/lyuwenyu/RT-DETR) as a
torch ``nn.Module``: a set-prediction detector with no NMS.

The layers follow ``transformers``' ``RTDetrForObjectDetection`` in eval
form (``RTDetrResNetBackbone``, ``RTDetrHybridEncoder``, ``RTDetrModel``'s
anchors, valid mask and top-k query selection, ``RTDetrDecoder`` with
iterative box refinement); the denoising queries are training-only and
are left out. The published widths are the defaults below
(huggingface.co/PekingU/rtdetr_r50vd):

* backbone: ResNet-50-vd, a deep stem (3x3 convs of 32, 32, 64, the first
  of stride 2, then a 3x3 stride-2 max pool), bottleneck stages of 256,
  512, 1024 and 2048 channels and depths 3, 4, 6, 3, the stride on the
  3x3, average-pooled shortcuts where a stage halves the map; ReLU (at
  the residual joins in place, ``ops/residual_relu``, where autograd
  records nothing);
* hybrid encoder: the stride-8/16/32 maps projected to 256 channels, one
  post-norm transformer layer (AIFI: 8 heads, FFN 1024, GELU, 2-D sin-cos
  positions at temperature 10000) on the stride-32 map, then the CCFM
  neck: top-down and bottom-up CSPRep blocks of three RepVGG units
  (3x3 + 1x1, SiLU);
* decoder: 300 queries chosen by the encoder's own class head over every
  token, their first boxes by its box head on those 300 tokens alone (no
  other token's box is read), 6 post-norm layers of self-attention,
  multi-scale deformable cross-attention (8 heads, 3 levels x 4 points;
  ``ops/ms_deform_attn``) and a ReLU FFN of 1024, each refining the
  boxes.

Submodule names equal the flax-format paths of the weights
(``backbone.s2.b0.cv2``, ``decoder.layer3.cross.offsets``), so the weight
bridge (``models/weights.py``) maps them leaf for leaf; linear layers are
1x1 ``kernel``s there, layer norms ``scale`` and ``bias``.

Precision: the backbone and the hybrid encoder run in the trunk's dtype;
everything from the decoder's input projection on runs in f32: the value
map the deformable sampling reads, the encoder's class and box heads, the
query selection, the sampling locations and attention weights and the
box refinement (a bf16 location near the far edge of an 80-px level lies
on a grid about 0.3 px apart). ``fold`` (``models/layers.fold_batchnorm``)
merges each RepVGG unit's 1x1 branch into its 3x3 once BN is folded.
``forward`` returns f32 class logits and boxes (cx, cy, w, h in [0, 1] of
the input) for every query.
"""

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aerial_image_recognition_tpu_torch.models.layers import (
    ConvBN, upsample2)
from aerial_image_recognition_tpu_torch.ops.ms_deform_attn import (
    ms_deform_attn)
from aerial_image_recognition_tpu_torch.ops.residual_relu import (
    residual_relu)
from aerial_image_recognition_tpu_torch.runtime.observability import Tracer

# the published configuration (transformers' RTDetrConfig defaults)
R50VD = dict(embedding_size=64, hidden_sizes=(256, 512, 1024, 2048),
             depths=(3, 4, 6, 3), hidden_dim=256, encoder_heads=8,
             encoder_ffn_dim=1024, csp_blocks=3, d_model=256,
             num_queries=300, decoder_layers=6, decoder_heads=8,
             decoder_ffn_dim=1024, points=4, temperature=10000.0,
             eps=1e-5)


class LayerNorm(nn.Module):
    """Layer norm over the last axis with flax's leaf names (``scale``,
    ``bias``)."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias,
                            self.eps)


class MLP(nn.Module):
    """Linear layers ``l0``..``l{n-1}`` with ReLU between them."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            setattr(self, f"l{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"l{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class Bottleneck(nn.Module):
    """ResNet-vd bottleneck: 1x1, 3x3 (the stride), 1x1 without activation,
    the shortcut added, then ReLU. A stride-2 block average-pools its
    shortcut before the projection (the "d" of vd).

    Where autograd records nothing (the detect step runs under inference
    mode), the join is ``ops/residual_relu``: the add and the ReLU in one
    pass in place into the last conv's output, so the block holds x, y and
    s and not also their sum and its ReLU (at the first stage, batch 64 and
    640 px, two maps of 839 MB: the forward pass's memory peak). Where
    autograd records, it stays ``F.relu(y + s)``, which back-propagates."""

    def __init__(self, c_in: int, c_out: int, stride: int, eps: float):
        super().__init__()
        mid = c_out // 4
        self.stride = stride
        self.cv1 = ConvBN(c_in, mid, 1, act="relu", bn_eps=eps)
        self.cv2 = ConvBN(mid, mid, 3, stride, act="relu", bn_eps=eps)
        self.cv3 = ConvBN(mid, c_out, 1, act="none", bn_eps=eps)
        self.short = ConvBN(c_in, c_out, 1, act="none", bn_eps=eps) \
            if c_in != c_out or stride != 1 else None

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        s = x
        if self.stride == 2:
            s = F.avg_pool2d(s, 2, 2, ceil_mode=True)
        if self.short is not None:
            s = self.short(s)
        if torch.is_grad_enabled() and (y.requires_grad or s.requires_grad):
            return F.relu(y + s)
        return residual_relu(y, s)


class Stage(nn.Module):
    def __init__(self, c_in: int, c_out: int, depth: int, stride: int,
                 eps: float):
        super().__init__()
        self.depth = depth
        for j in range(depth):
            setattr(self, f"b{j}", Bottleneck(c_in if j == 0 else c_out,
                                              c_out, stride if j == 0 else 1,
                                              eps))

    def forward(self, x):
        for j in range(self.depth):
            x = getattr(self, f"b{j}")(x)
        return x


class ResNetVd(nn.Module):
    """The backbone: the stride-8, 16 and 32 maps of stages 2-4."""

    def __init__(self, embedding_size, hidden_sizes, depths, eps):
        super().__init__()
        e = embedding_size
        self.stem0 = ConvBN(3, e // 2, 3, 2, act="relu", bn_eps=eps)
        self.stem1 = ConvBN(e // 2, e // 2, 3, act="relu", bn_eps=eps)
        self.stem2 = ConvBN(e // 2, e, 3, act="relu", bn_eps=eps)
        c = e
        for i, (w, d) in enumerate(zip(hidden_sizes, depths)):
            setattr(self, f"s{i}", Stage(c, w, d, 1 if i == 0 else 2, eps))
            c = w

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem2(self.stem1(self.stem0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(4):
            x = getattr(self, f"s{i}")(x)
            outs.append(x)
        return outs[1:]


class RepVgg(nn.Module):
    """SiLU(3x3 ConvBN + 1x1 ConvBN); ``reparameterize`` merges the 1x1
    branch into the 3x3 once both are BN-folded."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.c3 = ConvBN(c, c, 3, act="none", bn_eps=eps)
        self.c1 = ConvBN(c, c, 1, act="none", bn_eps=eps)

    def forward(self, x):
        if self.c1 is None:
            return F.silu(self.c3(x))
        return F.silu(self.c3(x) + self.c1(x))

    @torch.no_grad()
    def reparameterize(self) -> None:
        if self.c1 is None or not isinstance(self.c3.bn, nn.Identity) \
                or not isinstance(self.c1.bn, nn.Identity):
            return
        self.c3.conv.weight[:, :, 1:2, 1:2] += self.c1.conv.weight
        self.c3.conv.bias += self.c1.conv.bias
        self.c1 = None


class CSPRep(nn.Module):
    """CSPRep block at expansion 1.0: two 1x1 ConvBNs (SiLU) of the
    concatenated input, RepVGG units on the first, the two summed."""

    def __init__(self, c: int, blocks: int, eps: float):
        super().__init__()
        self.blocks = blocks
        self.cv1 = ConvBN(2 * c, c, 1, act="silu", bn_eps=eps)
        self.cv2 = ConvBN(2 * c, c, 1, act="silu", bn_eps=eps)
        for k in range(blocks):
            setattr(self, f"m{k}", RepVgg(c, eps))

    def forward(self, x):
        y = self.cv1(x)
        for k in range(self.blocks):
            y = getattr(self, f"m{k}")(y)
        return y + self.cv2(x)


class SelfAttention(nn.Module):
    """Multi-head attention whose queries and keys carry the position
    embedding and whose values do not (DETR's form), through
    ``scaled_dot_product_attention``."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def forward(self, x, pos):
        b, n, d = x.shape
        qk = x + pos

        def split(t):
            return t.view(b, n, self.heads, d // self.heads).transpose(1, 2)
        a = F.scaled_dot_product_attention(split(self.q(qk)),
                                           split(self.k(qk)),
                                           split(self.v(x)))
        return self.out(a.transpose(1, 2).reshape(b, n, d))


class AIFI(nn.Module):
    """The encoder's one transformer layer, post-norm, GELU FFN."""

    def __init__(self, d: int, heads: int, ffn: int, eps: float):
        super().__init__()
        self.attn = SelfAttention(d, heads)
        self.ln1 = LayerNorm(d, eps)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.ln2 = LayerNorm(d, eps)

    def forward(self, x, pos):
        x = self.ln1(x + self.attn(x, pos))
        return self.ln2(x + self.fc2(F.gelu(self.fc1(x))))


def sincos_2d(h: int, w: int, d: int, temperature: float,
              device) -> torch.Tensor:
    """[1, h*w, d] f32 2-D sin-cos positions as the published encoder makes
    them: its meshgrid is indexed (w, h), so token t of the row-major map
    gets the "w" position t // h and the "h" position t % h."""
    gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32,
                                         device=device),
                            torch.arange(h, dtype=torch.float32,
                                         device=device), indexing="ij")
    q = d // 4
    omega = 1.0 / temperature ** (torch.arange(q, dtype=torch.float32,
                                               device=device) / q)
    ow = gw.flatten()[:, None] @ omega[None]
    oh = gh.flatten()[:, None] @ omega[None]
    return torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1)[None]


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] → [B,H*W,C] (a view of a channels-last map)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


class HybridEncoder(nn.Module):
    """Input projections, AIFI on the stride-32 map, then the CCFM neck's
    top-down (lateral 1x1, upsample, CSPRep) and bottom-up (3x3 stride 2,
    CSPRep) paths; returns the stride-8, 16 and 32 maps."""

    def __init__(self, in_channels, d, heads, ffn, blocks, temperature, eps):
        super().__init__()
        self.temperature = temperature
        for i, c in enumerate(in_channels):
            setattr(self, f"proj{i}", ConvBN(c, d, 1, act="none",
                                             bn_eps=eps))
        self.aifi = AIFI(d, heads, ffn, eps)
        for i in range(2):
            setattr(self, f"lateral{i}", ConvBN(d, d, 1, act="silu",
                                                bn_eps=eps))
            setattr(self, f"fpn{i}", CSPRep(d, blocks, eps))
            setattr(self, f"down{i}", ConvBN(d, d, 3, 2, act="silu",
                                             bn_eps=eps))
            setattr(self, f"pan{i}", CSPRep(d, blocks, eps))

    def forward(self, feats):
        feats = [getattr(self, f"proj{i}")(f) for i, f in enumerate(feats)]
        top = feats[2]
        b, c, h, w = top.shape
        pos = sincos_2d(h, w, c, self.temperature, top.device)
        y = self.aifi(_tokens(top), pos.to(top.dtype))
        feats[2] = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        inner = [feats[2]]
        for i in range(2):
            lat = getattr(self, f"lateral{i}")(inner[-1])
            inner[-1] = lat
            inner.append(getattr(self, f"fpn{i}")(
                torch.cat([upsample2(lat), feats[1 - i]], 1)))
        inner = inner[::-1]
        outs = [inner[0]]
        for i in range(2):
            outs.append(getattr(self, f"pan{i}")(torch.cat(
                [getattr(self, f"down{i}")(outs[-1]), inner[i + 1]], 1)))
        return outs


class DeformableAttention(nn.Module):
    """Multi-scale deformable cross-attention: each query's sampling
    offsets and weights from its content + position, locations relative to
    its box, the value map sampled by ``ops/ms_deform_attn``."""

    def __init__(self, d: int, heads: int, levels: int, points: int):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.offsets = nn.Linear(d, heads * levels * points * 2)
        self.weights = nn.Linear(d, heads * levels * points)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def forward(self, query, ref, memory, shapes):
        b, q, d = query.shape
        hd, lv, pt = self.heads, self.levels, self.points
        value = self.value(memory).view(b, memory.shape[1], hd, d // hd)
        off = self.offsets(query).view(b, q, hd, lv, pt, 2)
        w = F.softmax(self.weights(query).view(b, q, hd, lv * pt), -1) \
            .view(b, q, hd, lv, pt)
        r = ref[:, :, None, None, None]
        loc = r[..., :2] + off / pt * r[..., 2:] * 0.5
        return self.out(ms_deform_attn(value, shapes, loc.contiguous(), w))


class DecoderLayer(nn.Module):
    def __init__(self, d: int, heads: int, ffn: int, levels: int,
                 points: int, eps: float):
        super().__init__()
        self.attn = SelfAttention(d, heads)
        self.ln1 = LayerNorm(d, eps)
        self.cross = DeformableAttention(d, heads, levels, points)
        self.ln2 = LayerNorm(d, eps)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.ln3 = LayerNorm(d, eps)

    def forward(self, h, pos, ref, memory, shapes):
        h = self.ln1(h + self.attn(h, pos))
        h = self.ln2(h + self.cross(h + pos, ref, memory, shapes))
        return self.ln3(h + self.fc2(F.relu(self.fc1(h))))


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def anchors(shapes, device, grid_size: float = 0.05):
    """(anchor logits [1,L,4] f32, valid mask [1,L,1] bool) of the levels'
    (H, W): each cell's centre and a size of grid_size * 2^level, as
    logits; cells within 1 % of the border are not valid and read f32's
    largest value."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing="ij")
        xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)
        wh = torch.full_like(xy, grid_size * 2.0 ** lvl)
        out.append(torch.cat([xy, wh], -1).reshape(1, h * w, 4))
    a = torch.cat(out, 1)
    valid = ((a > 0.01) & (a < 0.99)).all(-1, keepdim=True)
    logits = torch.log(a / (1 - a))
    return torch.where(valid, logits, torch.finfo(torch.float32).max), valid


class Decoder(nn.Module):
    """Input projections, the encoder's output head, the top-k query
    selection and the refining layers; all f32.

    The class head scores every token; the box head runs on the ``queries``
    selected tokens alone (at B=64 and 640 px, 19,200 rows and not 537,600,
    so the select holds no [B,L,256] hidden map of the box MLP).
    ``Decoder.enc_box_rows`` counts the rows the box head ran on, summed
    over forwards."""

    enc_box_rows = 0

    def __init__(self, in_dim, num_classes, d, queries, layers, heads, ffn,
                 levels, points, eps):
        super().__init__()
        self.queries, self.layers = queries, layers
        for i in range(levels):
            setattr(self, f"proj{i}", ConvBN(in_dim, d, 1, act="none",
                                             bn_eps=eps))
        self.enc_output = nn.Linear(d, d)
        self.enc_norm = LayerNorm(d, eps)
        self.enc_score = nn.Linear(d, num_classes)
        self.enc_bbox = MLP((d, d, d, 4))
        self.query_pos = MLP((4, 2 * d, d))
        for i in range(layers):
            setattr(self, f"layer{i}", DecoderLayer(d, heads, ffn, levels,
                                                    points, eps))
            setattr(self, f"class{i}", nn.Linear(d, num_classes))
            setattr(self, f"bbox{i}", MLP((d, d, d, 4)))
        self._anchors: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _project(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Level i's map → f32 tokens [B,HW,d]: a BN-folded projection as
        the f32 matrix product it is, an unfolded one as its ConvBN."""
        p = getattr(self, f"proj{i}")
        if isinstance(p.bn, nn.Identity):
            return F.linear(_tokens(x).float(), p.conv.weight[:, :, 0, 0],
                            p.conv.bias)
        return _tokens(p(x.float()))

    def _anchors_for(self, shapes, device):
        key = (tuple(shapes), str(device))
        if key not in self._anchors:
            self._anchors[key] = anchors(shapes, device)
        return self._anchors[key]

    def forward(self, feats) -> Dict[str, torch.Tensor]:
        with Tracer.annotate("rtdetr.select"):
            shapes = [(int(f.shape[2]), int(f.shape[3])) for f in feats]
            memory = torch.cat([self._project(i, f)
                                for i, f in enumerate(feats)], 1)
            anc, valid = self._anchors_for(shapes, memory.device)
            om = self.enc_norm(self.enc_output(memory * valid))
            enc_scores = self.enc_score(om)
            top = torch.topk(enc_scores.max(-1).values, self.queries,
                             dim=1).indices
            h = om.gather(1, top[..., None].expand(-1, -1, om.shape[-1]))
            # the box head on the selected rows alone: no other row's box
            # is read, and each row's arithmetic is the whole-token one's
            ref = torch.sigmoid(self.enc_bbox(h) + anc[0][top])
            Decoder.enc_box_rows += top.numel()
        with Tracer.annotate("rtdetr.decoder"):
            for i in range(self.layers):
                pos = self.query_pos(ref)
                h = getattr(self, f"layer{i}")(h, pos, ref, memory, shapes)
                ref = torch.sigmoid(getattr(self, f"bbox{i}")(h)
                                    + inverse_sigmoid(ref))
            logits = getattr(self, f"class{self.layers - 1}")(h)
        return {"enc_scores": enc_scores, "topk": top, "logits": logits,
                "boxes": ref}


class RTDETR(nn.Module):
    """The whole detector; ``forward(x)`` takes [B,3,S,S] in [0, 1] in the
    trunk's dtype and returns ``logits`` [B,Q,nc] and ``boxes`` [B,Q,4]
    (f32), the encoder's scores over every token ``enc_scores`` [B,L,nc]
    and the selected tokens ``topk`` [B,Q]."""

    # a set prediction: one box a query, finished without NMS
    # (``pipeline/inference.make_detect_fn``)
    nms_free = True

    def __init__(self, num_classes: int = 2, **overrides):
        super().__init__()
        c = dict(R50VD, **overrides)
        self.num_classes = num_classes
        self.config = c
        self.backbone = ResNetVd(c["embedding_size"], c["hidden_sizes"],
                                 c["depths"], c["eps"])
        self.encoder = HybridEncoder(
            c["hidden_sizes"][1:], c["hidden_dim"], c["encoder_heads"],
            c["encoder_ffn_dim"], c["csp_blocks"], c["temperature"],
            c["eps"])
        self.decoder = Decoder(
            c["hidden_dim"], num_classes, c["d_model"], c["num_queries"],
            c["decoder_layers"], c["decoder_heads"], c["decoder_ffn_dim"],
            3, c["points"], c["eps"])

    def set_dtype(self, dtype: torch.dtype) -> "RTDETR":
        """Backbone and hybrid encoder in ``dtype``; the decoder f32."""
        self.backbone.to(dtype)
        self.encoder.to(dtype)
        self.decoder.float()
        return self

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(
                "RT-DETR's f32 decoder needs full-precision f32 matmuls; "
                "torch.get_float32_matmul_precision() is "
                f"{torch.get_float32_matmul_precision()!r} (TF32) — set it "
                "back to 'highest'")
        with Tracer.annotate("rtdetr.backbone"):
            feats = self.backbone(x)
        with Tracer.annotate("rtdetr.encoder"):
            feats = self.encoder(feats)
        return self.decoder(feats)

    def decode(self, outs: Dict[str, torch.Tensor], size: int):
        """``forward``'s outputs → (boxes [B,Q,4] cxcywh pixels at the input
        edge ``size``, sigmoid class scores [B,Q,nc]), both f32."""
        return outs["boxes"] * size, torch.sigmoid(outs["logits"])

