"""Plain PyTorch and NumPy post-processing of the reference: the
antialiased bilinear resize, greedy NMS, pixel -> lon/lat and the
confidence-greedy metric dedup of a scan's records.

Written from the semantics the program documents, not from its code:
NMS keeps the highest-scoring box and drops every box of the same class
(any class at nc=1) whose IoU with it exceeds the threshold, in score
order (ties to the lower anchor index); dedup keeps a record iff no kept
record of higher confidence lies within the radius.
"""

import math

import numpy as np
import torch

M_PER_DEG = 111319.9


def resize_matrix(src: int, dst: int) -> torch.Tensor:
    """[dst, src] f64 weights of an antialiased linear (triangle) resize:
    sample centres at (i + 0.5) * src/dst - 0.5, the triangle widened by
    src/dst when shrinking, each row normalised to sum 1."""
    scale = src / dst
    width = max(scale, 1.0)
    centre = (torch.arange(dst, dtype=torch.float64) + 0.5) * scale - 0.5
    dist = (centre[:, None] - torch.arange(src, dtype=torch.float64)[None])
    w = torch.clamp(1.0 - dist.abs() / width, min=0.0)
    return w / w.sum(1, keepdim=True)


def to_model_input(tiles_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 [B,H,W,3] -> f32 [B,3,size,size] in [0,1] (resized when H is
    not size)."""
    x = tiles_u8.permute(0, 3, 1, 2).float() / 255.0
    h = x.shape[-1]
    if h != size:
        m = resize_matrix(h, size).float().to(x.device)
        x = m @ x @ m.T
    return x


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cxcywh [..., N, 4] x [..., M, 4] -> IoU [..., N, M]."""
    def corners(t):
        return (t[..., 0] - t[..., 2] / 2, t[..., 1] - t[..., 3] / 2,
                t[..., 0] + t[..., 2] / 2, t[..., 1] + t[..., 3] / 2)
    ax1, ay1, ax2, ay2 = corners(a)
    bx1, by1, bx2, by2 = corners(b)
    iw = (torch.minimum(ax2[..., :, None], bx2[..., None, :])
          - torch.maximum(ax1[..., :, None], bx1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(ay2[..., :, None], by2[..., None, :])
          - torch.maximum(ay1[..., :, None], by1[..., None, :])).clamp(min=0)
    inter = iw * ih
    area_a = ((ax2 - ax1) * (ay2 - ay1))[..., :, None]
    area_b = ((bx2 - bx1) * (by2 - by1))[..., None, :]
    return inter / (area_a + area_b - inter).clamp(min=1e-9)


def greedy_nms(boxes, scores, *, conf: float, iou_thr: float, max_det: int,
               pre_topk: int):
    """boxes [B,A,4], scores [B,A,nc] -> per image a list of
    (box [4], score, class) kept by greedy NMS over the ``pre_topk`` best
    candidates at or above ``conf``; class-aware when nc > 1."""
    best, cls = scores.max(-1)
    order = torch.sort(best, dim=1, descending=True, stable=True).indices
    order = order[:, :min(pre_topk, order.shape[1])]
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    s = torch.gather(best, 1, order)
    c = torch.gather(cls, 1, order)
    over = iou(b, b) > iou_thr
    if scores.shape[-1] > 1:
        over &= c[:, :, None] == c[:, None, :]
    alive = s >= conf
    keep = torch.zeros_like(alive)
    rows = torch.arange(b.shape[0], device=b.device)
    for _ in range(max_det):
        masked = torch.where(alive, s, torch.full_like(s, -1.0))
        i = masked.argmax(1)
        ok = alive[rows, i]
        keep[rows, i] |= ok
        alive &= ~(over[rows, i] & ok[:, None])
        alive[rows, i] = False
        if not bool(alive.any()):
            break
    out = []
    for r in range(b.shape[0]):
        k = keep[r].nonzero()[:, 0]
        out.append((b[r, k].double().cpu().numpy(),
                    s[r, k].double().cpu().numpy(),
                    c[r, k].cpu().numpy()))
    return out


def lonlat(box_xy: np.ndarray, bounds, size: int):
    """cx, cy model pixels [N,2] and a tile's (w, s, e, n) -> lon, lat f64."""
    w, s, e, n = (float(v) for v in bounds)
    return (w + box_xy[:, 0] / size * (e - w),
            n - box_xy[:, 1] / size * (n - s))


def local_metres(lon, lat, lat0: float):
    """Equirectangular metres about latitude lat0."""
    return (np.asarray(lon) * M_PER_DEG * math.cos(math.radians(lat0)),
            np.asarray(lat) * M_PER_DEG)


def dedup(lon, lat, conf, radius_m: float) -> np.ndarray:
    """Keep-mask: confidence-greedy, a record is kept iff no kept record
    lies within ``radius_m`` metres."""
    lon, lat, conf = (np.asarray(v, np.float64) for v in (lon, lat, conf))
    if not len(lon):
        return np.zeros(0, bool)
    x, y = local_metres(lon, lat, float(lat.mean()))
    cells = {}
    keep = np.zeros(len(lon), bool)
    for i in np.argsort(-conf, kind="stable"):
        cx, cy = int(x[i] // radius_m), int(y[i] // radius_m)
        near = [j for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for j in cells.get((cx + dx, cy + dy), ())]
        if near and np.min(np.hypot(x[near] - x[i], y[near] - y[i])) \
                <= radius_m:
            continue
        keep[i] = True
        cells.setdefault((cx, cy), []).append(i)
    return keep
