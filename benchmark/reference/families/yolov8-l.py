"""YOLOv8 (github.com/ultralytics/ultralytics, cfg/models/v8/yolov8.yaml)
at the configuration's ``widths`` and ``depths``: the forward on the
reference's graph (SPPF as three chained 5-pools), the anchor-free DFL
decode over ``reg_max`` bins and class-aware greedy NMS; its leaf shapes
and the calibration of seeded weights.

Seeded weights (``seeded_unit_variance``, after
``chip_smoke.unit_variance_tree``, chip_smoke.py:2392): past the shared
conv rescale, each class head is set to unit deviation with a fixed share
of each level's anchors above the threshold, and each box head to
deviation ``box_logit_std`` about a prior that puts ``box_prior_logit`` on
bin ``box_prior_bin`` of every side's distance distribution (boxes about 2
* box_bin strides across, stable under rounding, where unit-deviation box
logits give boxes half a tile across that overlap one another).
"""

import math

import torch
import torch.nn.functional as F

from benchmark.lib.weights import ConvRescale
from benchmark.reference import models, post

ACT = "silu"
STRIDES = (8, 16, 32)


def _c2f(g, name, x, n, shortcut):
    y = g.conv(f"{name}/cv1", x)
    ys = list(y.chunk(2, 1))
    for i in range(n):
        t = g.conv(f"{name}/m{i}/cv2", g.conv(f"{name}/m{i}/cv1", ys[-1]))
        ys.append(t + ys[-1] if shortcut else t)
    return g.conv(f"{name}/cv2", torch.cat(ys, 1))


def forward(cfg, w, x):
    """x [B,3,S,S] in [0,1] -> per level [B,H,W,4*reg_max+nc] NHWC
    logits; the depths (n3, n6) from the configuration, the widths from
    the weights."""
    g = w if isinstance(w, models.Graph) else models.Graph(w, ACT,
                                                           cfg["bn_eps"])
    n3, n6 = cfg["depths"]
    x = g.conv("down2", g.conv("stem", x, 2), 2)
    x = _c2f(g, "c2f1", x, n3, True)
    p3 = _c2f(g, "c2f2", g.conv("down3", x, 2), n6, True)
    p4 = _c2f(g, "c2f3", g.conv("down4", p3, 2), n6, True)
    y = g.conv("sppf/cv1", _c2f(g, "c2f4", g.conv("down5", p4, 2), n3, True))
    q1 = models.pool(y, 5)
    q2 = models.pool(q1, 5)
    p5 = g.conv("sppf/cv2", torch.cat([y, q1, q2, models.pool(q2, 5)], 1))

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


def decode(cfg, outs):
    """Anchor-free DFL decode -> boxes [B,A,4] cxcywh px, scores sigmoid
    [B,A,nc]."""
    nc, reg_max = cfg["nc"], cfg["reg_max"]
    bins = torch.arange(reg_max, dtype=torch.float32, device=outs[0].device)
    boxes, scores = [], []
    for out, s in zip(outs, STRIDES):
        b, h, w, _ = out.shape
        dist = torch.softmax(out[..., :4 * reg_max].reshape(
            b, h, w, 4, reg_max), -1) @ bins
        gx, gy = models.grid(h, w, out.device)
        x1 = gx + 0.5 - dist[..., 0]
        y1 = gy + 0.5 - dist[..., 1]
        x2 = gx + 0.5 + dist[..., 2]
        y2 = gy + 0.5 + dist[..., 3]
        box = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                          -1) * s
        boxes.append(box.reshape(b, -1, 4))
        scores.append(torch.sigmoid(out[..., 4 * reg_max:]).reshape(b, -1, nc))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def answer(cfg, w, x, *, conf, iou_thr, max_det, pre_topk):
    """Per image of x, the kept (box [N,4] cxcywh px, score [N], class
    [N]): the decode, then greedy NMS, class-aware at nc > 1."""
    boxes, scores = decode(cfg, forward(cfg, w, x))
    return post.greedy_nms(boxes, scores, conf=conf, iou_thr=iou_thr,
                           max_det=max_det, pre_topk=pre_topk)


def flops(cfg, weights, batch, size):
    return models.count_flops(forward, ACT, cfg, weights, batch, size)


def shapes(cfg):
    """Flax-path leaf shapes at the configuration's (stem, P2..P5)
    ``widths`` and (n3, n6) ``depths``, as yolov8.yaml lays it out:
    {path: shape}."""
    nc, reg_max = cfg["nc"], cfg["reg_max"]
    c1, c2, c3, c4, c5 = cfg["widths"]
    n3, n6 = cfg["depths"]
    out = {}

    def conv(name, cin, cout, k=1):
        out[f"params/{name}/conv/kernel"] = (k, k, cin, cout)
        for leaf in ("params/{}/bn/scale", "params/{}/bn/bias",
                     "batch_stats/{}/bn/mean", "batch_stats/{}/bn/var"):
            out[leaf.format(name)] = (cout,)

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
    box_w, cls_w = max(16, c3 // 4, reg_max * 4), max(c3, min(nc, 100))
    for i, c in enumerate((c3, c4, c5)):
        for kind, width, o in (("box", box_w, 4 * reg_max),
                               ("cls", cls_w, nc)):
            conv(f"detect/{kind}{i}_cv1", c, width, 3)
            conv(f"detect/{kind}{i}_cv2", width, width, 3)
            out[f"params/detect/{kind}{i}_out/kernel"] = (1, 1, width, o)
            out[f"params/detect/{kind}{i}_out/bias"] = (o,)
    return out


class _Calibrate(ConvRescale):
    """The shared conv rescale, and the heads set as the module's
    docstring says."""

    def __init__(self, weights, bn_eps, spec):
        super().__init__(weights, ACT, bn_eps, spec)
        self.cls_share = spec["class_share_above"]
        self.threshold = spec["threshold"]
        self.box_std = spec["box_logit_std"]
        self.box_bin = spec["box_prior_bin"]
        self.box_logit = spec["box_prior_logit"]

    def head(self, name, feat):
        out = super().head(name, feat)
        kernel = self.w[f"params/{name}/kernel"]
        bias = self.w[f"params/{name}/bias"]
        if "/cls" in name:
            # unit deviation, then the share cls_share of this level's
            # logits above the threshold's logit
            mean, std = out.mean((0, 1, 2)), out.std((0, 1, 2))
            z = ((out - mean) / std).reshape(-1, out.shape[-1])
            top = torch.quantile(z, 1.0 - self.cls_share, dim=0)
            kernel /= std
            bias.sub_(mean).div_(std).add_(
                math.log(self.threshold / (1 - self.threshold)) - top)
        else:
            kernel *= self.box_std / out.std()
            bias.zero_()
            bias.view(4, -1)[:, self.box_bin] = self.box_logit
        return super().head(name, feat)


def calibrate(cfg, w, x):
    """Rescales the drawn weights ``w`` in place over the calibration
    images x [B,3,S,S] f32 in [0,1]."""
    forward(cfg, _Calibrate(w, cfg["bn_eps"], cfg["weights"]), x)
