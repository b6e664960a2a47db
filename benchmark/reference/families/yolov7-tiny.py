"""YOLOv7-tiny (github.com/WongKinYiu/yolov7, cfg/training/yolov7-tiny.yaml):
the forward on the reference's graph, the YOLOv5/v7 anchor decode and
greedy NMS. SPP runs as parallel 5/9/13 pools. Its weights are a file
(the ``file`` kind), so this family draws no seeded ones.
"""

import torch
import torch.nn.functional as F

from benchmark.reference import models, post

ACT = "leaky"
STRIDES = (8, 16, 32)


def _elan_tiny(g, name, x):
    a = g.conv(f"{name}/cv1", x)
    b = g.conv(f"{name}/cv2", x)
    c = g.conv(f"{name}/cv3", b)
    d = g.conv(f"{name}/cv4", c)
    return g.conv(f"{name}/out", torch.cat([d, c, b, a], 1))


def forward(cfg, w, x):
    """x [B,3,S,S] in [0,1] -> the three raw head maps, NHWC."""
    g = w if isinstance(w, models.Graph) else models.Graph(w, ACT,
                                                           cfg["bn_eps"])
    x = g.conv("stem1", g.conv("stem0", x, 2), 2)
    x = _elan_tiny(g, "elan1", x)
    p3 = _elan_tiny(g, "elan2", F.max_pool2d(x, 2))
    p4 = _elan_tiny(g, "elan3", F.max_pool2d(p3, 2))
    p5 = _elan_tiny(g, "elan4", F.max_pool2d(p4, 2))
    a = g.conv("sppcspc/cv1", p5)
    b = g.conv("sppcspc/cv2", p5)
    y = g.conv("sppcspc/cv3", torch.cat(
        [models.pool(b, 13), models.pool(b, 9), models.pool(b, 5), b], 1))
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


def decode(cfg, outs):
    """YOLOv5/v7 decode over the configuration's anchors -> boxes [B,A,4]
    cxcywh px, scores [B,A,nc] (objectness alone at nc=1, obj*cls
    otherwise)."""
    nc = cfg["nc"]
    boxes, scores = [], []
    for out, anchors, s in zip(outs, cfg["anchors"], STRIDES):
        b, h, w, _ = out.shape
        y = torch.sigmoid(out.reshape(b, h, w, 3, 5 + nc))
        gx, gy = models.grid(h, w, out.device)
        grid = torch.stack([gx, gy], -1)[None, :, :, None]
        anc = torch.tensor(anchors, dtype=torch.float32,
                           device=out.device).view(3, 2)
        xy = (y[..., :2] * 2 - 0.5 + grid) * s
        wh = (y[..., 2:4] * 2) ** 2 * anc
        sc = y[..., 4:5] if nc == 1 else y[..., 4:5] * y[..., 5:]
        boxes.append(torch.cat([xy, wh], -1).reshape(b, -1, 4))
        scores.append(sc.reshape(b, -1, nc))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def answer(cfg, w, x, *, conf, iou_thr, max_det, pre_topk):
    """Per image of x, the kept (box [N,4] cxcywh px, score [N], class
    [N]): the decode, then greedy NMS."""
    boxes, scores = decode(cfg, forward(cfg, w, x))
    return post.greedy_nms(boxes, scores, conf=conf, iou_thr=iou_thr,
                           max_det=max_det, pre_topk=pre_topk)


def flops(cfg, weights, batch, size):
    return models.count_flops(forward, ACT, cfg, weights, batch, size)
