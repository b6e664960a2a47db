"""Plain PyTorch forward passes of the benchmark's two detectors.

Frozen copies, written from the published graphs, of YOLOv7-tiny
(github.com/WongKinYiu/yolov7, cfg/training/yolov7-tiny.yaml) and YOLOv8
(github.com/ultralytics/ultralytics, cfg/models/v8/yolov8.yaml), with their
decodes. They read a flat dict of f32 tensors keyed by the flax-format
paths of the weight files (``params/elan1/cv1/conv/kernel`` in HWIO,
``batch_stats/elan1/cv1/bn/mean`` ...) and compute with plain
``torch.nn.functional`` calls: BN unfolded, the stems as 3x3 stride-2
convolutions over the image, SPP as parallel 5/9/13 pools. Nothing here
imports the program under test.

``count_flops`` runs the same graph on the meta device and counts twice the
multiply-adds of every convolution and head matmul.
"""

import torch
import torch.nn.functional as F

V7_ANCHORS = (((10, 13), (16, 30), (33, 23)),
              ((30, 61), (62, 45), (59, 119)),
              ((116, 90), (156, 198), (373, 326)))
STRIDES = (8, 16, 32)
REG_MAX = 16


class Graph:
    """Weights and the ops of one family: conv + BN + activation blocks
    and the 1x1 f32 heads, with an optional FLOP counter."""

    def __init__(self, weights, act: str, bn_eps: float):
        self.w = weights
        self.act = act
        self.eps = bn_eps
        self.flops = 0.0

    def conv(self, name, x, stride=1):
        k = self.w[f"params/{name}/conv/kernel"].permute(3, 2, 0, 1)
        y = F.conv2d(x, k, self.w.get(f"params/{name}/conv/bias"),
                     stride=stride, padding=k.shape[-1] // 2)
        self.flops += 2.0 * k[0].numel() * y.numel()
        if f"params/{name}/bn/scale" in self.w:
            mean = self.w[f"batch_stats/{name}/bn/mean"]
            var = self.w[f"batch_stats/{name}/bn/var"]
            scale = self.w[f"params/{name}/bn/scale"] / torch.sqrt(
                var + self.eps)
            y = (y - mean[:, None, None]) * scale[:, None, None] \
                + self.w[f"params/{name}/bn/bias"][:, None, None]
        if self.act == "leaky":
            return F.leaky_relu(y, 0.1)
        return F.silu(y)

    def head(self, name, feat):
        """1x1 conv with bias on an NCHW map -> NHWC f32 logits."""
        k = self.w[f"params/{name}/kernel"][0, 0]           # [I, O]
        x = feat.permute(0, 2, 3, 1)
        self.flops += 2.0 * k.shape[0] * x.shape[0] * x.shape[1] \
            * x.shape[2] * k.shape[1]
        return x @ k + self.w[f"params/{name}/bias"]


def _pool(x, k):
    return F.max_pool2d(x, k, 1, k // 2)


def _elan_tiny(g, name, x):
    a = g.conv(f"{name}/cv1", x)
    b = g.conv(f"{name}/cv2", x)
    c = g.conv(f"{name}/cv3", b)
    d = g.conv(f"{name}/cv4", c)
    return g.conv(f"{name}/out", torch.cat([d, c, b, a], 1))


def yolov7_tiny(w, x):
    """x [B,3,S,S] in [0,1] -> the three raw head maps, NHWC."""
    g = w if isinstance(w, Graph) else Graph(w, "leaky", 1e-5)
    x = g.conv("stem1", g.conv("stem0", x, 2), 2)
    x = _elan_tiny(g, "elan1", x)
    p3 = _elan_tiny(g, "elan2", F.max_pool2d(x, 2))
    p4 = _elan_tiny(g, "elan3", F.max_pool2d(p3, 2))
    p5 = _elan_tiny(g, "elan4", F.max_pool2d(p4, 2))
    a = g.conv("sppcspc/cv1", p5)
    b = g.conv("sppcspc/cv2", p5)
    y = g.conv("sppcspc/cv3", torch.cat(
        [_pool(b, 13), _pool(b, 9), _pool(b, 5), b], 1))
    spp = g.conv("sppcspc/out", torch.cat([y, a], 1))
    up = F.interpolate(g.conv("up4_cv", spp), scale_factor=2, mode="nearest")
    f4 = _elan_tiny(g, "head_elan4", torch.cat([g.conv("route4", p4), up], 1))
    up = F.interpolate(g.conv("up3_cv", f4), scale_factor=2, mode="nearest")
    f3 = _elan_tiny(g, "head_elan3", torch.cat([g.conv("route3", p3), up], 1))
    f4b = _elan_tiny(g, "pan_elan4",
                     torch.cat([g.conv("down4_cv", f3, 2), f4], 1))
    f5b = _elan_tiny(g, "pan_elan5",
                     torch.cat([g.conv("down5_cv", f4b, 2), spp], 1))
    return [g.head(f"detect{i}", g.conv(o, f)) for i, (o, f) in enumerate(
        (("out3", f3), ("out4", f4b), ("out5", f5b)))]


def _c2f(g, name, x, n, shortcut):
    y = g.conv(f"{name}/cv1", x)
    ys = list(y.chunk(2, 1))
    for i in range(n):
        t = g.conv(f"{name}/m{i}/cv2", g.conv(f"{name}/m{i}/cv1", ys[-1]))
        ys.append(t + ys[-1] if shortcut else t)
    return g.conv(f"{name}/cv2", torch.cat(ys, 1))


def yolov8(w, x, depth=(3, 6)):
    """YOLOv8 at depth (n3, n6) = (3, 6), the l and x scales: x [B,3,S,S]
    in [0,1] -> per level [B,H,W,4*16+nc] NHWC logits."""
    g = w if isinstance(w, Graph) else Graph(w, "silu", 1e-3)
    n3, n6 = depth
    x = g.conv("down2", g.conv("stem", x, 2), 2)
    x = _c2f(g, "c2f1", x, n3, True)
    p3 = _c2f(g, "c2f2", g.conv("down3", x, 2), n6, True)
    p4 = _c2f(g, "c2f3", g.conv("down4", p3, 2), n6, True)
    y = g.conv("sppf/cv1", _c2f(g, "c2f4", g.conv("down5", p4, 2), n3, True))
    q1 = _pool(y, 5)
    q2 = _pool(q1, 5)
    p5 = g.conv("sppf/cv2", torch.cat([y, q1, q2, _pool(q2, 5)], 1))

    def up(t):
        return F.interpolate(t, scale_factor=2, mode="nearest")
    f4 = _c2f(g, "fpn4", torch.cat([up(p5), p4], 1), n3, False)
    f3 = _c2f(g, "fpn3", torch.cat([up(f4), p3], 1), n3, False)
    f4b = _c2f(g, "pan4", torch.cat([g.conv("pan_down4", f3, 2), f4], 1),
               n3, False)
    f5b = _c2f(g, "pan5", torch.cat([g.conv("pan_down5", f4b, 2), p5], 1),
               n3, False)
    outs = []
    for i, f in enumerate((f3, f4b, f5b)):
        b = g.conv(f"detect/box{i}_cv2", g.conv(f"detect/box{i}_cv1", f))
        c = g.conv(f"detect/cls{i}_cv2", g.conv(f"detect/cls{i}_cv1", f))
        outs.append(torch.cat([g.head(f"detect/box{i}_out", b),
                               g.head(f"detect/cls{i}_out", c)], -1))
    return outs


def _grid(h, w, device):
    gy, gx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    return gx, gy


def decode_v7(outs, nc):
    """YOLOv5/v7 decode -> boxes [B,A,4] cxcywh px, scores [B,A,nc]
    (objectness alone at nc=1, obj*cls otherwise)."""
    boxes, scores = [], []
    for out, anchors, s in zip(outs, V7_ANCHORS, STRIDES):
        b, h, w, _ = out.shape
        y = torch.sigmoid(out.reshape(b, h, w, 3, 5 + nc))
        gx, gy = _grid(h, w, out.device)
        grid = torch.stack([gx, gy], -1)[None, :, :, None]
        anc = torch.tensor(anchors, dtype=torch.float32, device=out.device)
        xy = (y[..., :2] * 2 - 0.5 + grid) * s
        wh = (y[..., 2:4] * 2) ** 2 * anc
        sc = y[..., 4:5] if nc == 1 else y[..., 4:5] * y[..., 5:]
        boxes.append(torch.cat([xy, wh], -1).reshape(b, -1, 4))
        scores.append(sc.reshape(b, -1, nc))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def decode_v8(outs, nc):
    """Anchor-free DFL decode -> boxes [B,A,4] cxcywh px, scores sigmoid."""
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=outs[0].device)
    boxes, scores = [], []
    for out, s in zip(outs, STRIDES):
        b, h, w, _ = out.shape
        dist = torch.softmax(out[..., :4 * REG_MAX].reshape(
            b, h, w, 4, REG_MAX), -1) @ bins
        gx, gy = _grid(h, w, out.device)
        x1 = gx + 0.5 - dist[..., 0]
        y1 = gy + 0.5 - dist[..., 1]
        x2 = gx + 0.5 + dist[..., 2]
        y2 = gy + 0.5 + dist[..., 3]
        box = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                          -1) * s
        boxes.append(box.reshape(b, -1, 4))
        scores.append(torch.sigmoid(out[..., 4 * REG_MAX:]).reshape(b, -1, nc))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


FAMILIES = {"yolov7-tiny": (yolov7_tiny, decode_v7),
            "yolov8-l": (yolov8, decode_v8)}


def detect(family: str, weights, images, nc: int):
    """images [B,3,S,S] f32 in [0,1] -> (boxes, scores) of the family."""
    forward, decode = FAMILIES[family]
    return decode(forward(weights, images), nc)


def count_flops(family: str, weights, batch: int, size: int) -> float:
    """Twice the multiply-adds of every conv and head matmul of one
    forward over [batch, 3, size, size], counted on the meta device."""
    meta = {k: torch.empty(v.shape, device="meta") for k, v in weights.items()}
    g = Graph(meta, "leaky" if family == "yolov7-tiny" else "silu", 1e-5)
    FAMILIES[family][0](g, torch.empty(batch, 3, size, size, device="meta"))
    return g.flops


def yolov8_shapes(nc: int, widths=(64, 128, 256, 512, 512), depth=(3, 6)):
    """Flax-path leaf shapes of YOLOv8 at the given (stem, P2..P5) widths
    and (n3, n6) depths, as yolov8.yaml lays it out: {path: shape}."""
    c1, c2, c3, c4, c5 = widths
    n3, n6 = depth
    shapes = {}

    def conv(name, cin, cout, k=1):
        shapes[f"params/{name}/conv/kernel"] = (k, k, cin, cout)
        for leaf in ("params/{}/bn/scale", "params/{}/bn/bias",
                     "batch_stats/{}/bn/mean", "batch_stats/{}/bn/var"):
            shapes[leaf.format(name)] = (cout,)

    def c2f(name, cin, cout, n):
        h = cout // 2
        conv(f"{name}/cv1", cin, 2 * h)
        for i in range(n):
            conv(f"{name}/m{i}/cv1", h, h, 3)
            conv(f"{name}/m{i}/cv2", h, h, 3)
        conv(f"{name}/cv2", (2 + n) * h, cout)

    conv("stem", 3, c1, 3)
    conv("down2", c1, c2, 3)
    c2f("c2f1", c2, c2, n3)
    conv("down3", c2, c3, 3)
    c2f("c2f2", c3, c3, n6)
    conv("down4", c3, c4, 3)
    c2f("c2f3", c4, c4, n6)
    conv("down5", c4, c5, 3)
    c2f("c2f4", c5, c5, n3)
    conv("sppf/cv1", c5, c5 // 2)
    conv("sppf/cv2", 2 * c5, c5)
    c2f("fpn4", c5 + c4, c4, n3)
    c2f("fpn3", c4 + c3, c3, n3)
    conv("pan_down4", c3, c3, 3)
    c2f("pan4", c3 + c4, c4, n3)
    conv("pan_down5", c4, c4, 3)
    c2f("pan5", c4 + c5, c5, n3)
    box_w, cls_w = max(16, c3 // 4, REG_MAX * 4), max(c3, min(nc, 100))
    for i, c in enumerate((c3, c4, c5)):
        for kind, width, out in (("box", box_w, 4 * REG_MAX), ("cls", cls_w, nc)):
            conv(f"detect/{kind}{i}_cv1", c, width, 3)
            conv(f"detect/{kind}{i}_cv2", width, width, 3)
            shapes[f"params/detect/{kind}{i}_out/kernel"] = (1, 1, width, out)
            shapes[f"params/detect/{kind}{i}_out/bias"] = (out,)
    return shapes
