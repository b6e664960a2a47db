"""Detection losses (YOLOv7 anchor-based, YOLOv8 anchor-free, XUnet BCE).

Counterpart of ``aerial_image_recognition_tpu/ops/losses.py``, on the
port's NHWC f32 head maps. Targets are a padded ``[B, T, 5]`` tensor (cls,
cx, cy, w, h in input pixels; cls = −1 pads); assignment is the
v5/v7-style wh-ratio rule (YOLOv7) or a size band per level (YOLOv8) at the
cell holding the box centre, with static shapes: cell gathers are advanced
indexing and the target maps are scatter-max.

The reference scatters with ``.at[idx].max(..., mode="drop")`` after
pointing unmatched rows at index −1, which JAX wraps to the last cell
rather than dropping; it is harmless there because an unmatched row
carries the value 0 into a max over a map of non-negative values. Here
unmatched rows are masked out instead (index 0, value 0: the same no-op),
since a −1 index is an error in torch.
"""

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from aerial_image_recognition_tpu_torch.models.yolov7 import STRIDES
from aerial_image_recognition_tpu_torch.models.yolov8 import REG_MAX


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: the gradient at a tie is split in half, as
    the reference's (``clamp_min`` would pass all of it)."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype,
                                       device=x.device))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``: derivative +1 at 0, as the reference's (``torch.abs``
    has 0 there)."""
    return torch.where(x >= 0, x, -x)


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE. Its kinks at a logit of exactly 0 —
    a dead ReLU trunk under a zero bias gives many — take the reference's
    subgradients (``_max``, ``_abs``)."""
    return _max(logits, 0.0) - logits * labels + torch.log1p(
        torch.exp(-_abs(logits)))


def ciou(box_a: torch.Tensor, box_b: torch.Tensor,
         eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between cxcywh boxes (broadcasting); the aspect term's
    weight ``alpha`` is detached, as the reference's ``stop_gradient``."""
    ax1, ay1 = box_a[..., 0] - box_a[..., 2] / 2, box_a[..., 1] - box_a[..., 3] / 2
    ax2, ay2 = box_a[..., 0] + box_a[..., 2] / 2, box_a[..., 1] + box_a[..., 3] / 2
    bx1, by1 = box_b[..., 0] - box_b[..., 2] / 2, box_b[..., 1] - box_b[..., 3] / 2
    bx2, by2 = box_b[..., 0] + box_b[..., 2] / 2, box_b[..., 1] + box_b[..., 3] / 2
    iw = _max(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), 0.0)
    ih = _max(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), 0.0)
    inter = iw * ih
    union = (box_a[..., 2] * box_a[..., 3] + box_b[..., 2] * box_b[..., 3]
             - inter + eps)
    iou = inter / union
    # enclosing box diagonal
    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((box_a[..., 0] - box_b[..., 0]) ** 2
            + (box_a[..., 1] - box_b[..., 1]) ** 2)
    v = (4 / math.pi ** 2) * (torch.atan(box_b[..., 2] / (box_b[..., 3] + eps))
                              - torch.atan(box_a[..., 2] / (box_a[..., 3] + eps))) ** 2
    alpha = v / (1.0 - iou + v + eps)
    return iou - rho2 / c2 - alpha.detach() * v


def _one_hot(cls: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``jax.nn.one_hot``: all zeros for a class outside [0, nc)."""
    return (cls.long()[..., None] == torch.arange(
        num_classes, device=cls.device)).float()


def _cells(txy: torch.Tensor, stride: int, h: int, w: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cx, cy) cell of each box centre, clipped into the map."""
    cell = torch.floor(txy / stride)
    cx = torch.clamp(cell[..., 0].to(torch.int32), 0, w - 1).long()
    cy = torch.clamp(cell[..., 1].to(torch.int32), 0, h - 1).long()
    return cx, cy


def scatter_max(size: int, flat_idx: torch.Tensor, values: torch.Tensor,
                match: torch.Tensor) -> torch.Tensor:
    """A zero map of ``size`` rows, each row the max of the ``values`` of
    the matched entries that index it. ``flat_idx`` and ``match`` share a
    shape S; ``values`` is S or S + [C] (the map is then [size, C]).
    ``values`` must be 0 where ``match`` is False and ≥ 0 elsewhere
    (unmatched entries go to row 0 with that 0: a no-op under the max)."""
    idx = torch.where(match, flat_idx, torch.zeros_like(flat_idx)).reshape(-1)
    if values.dim() == match.dim():
        vals = values.reshape(-1)
        out = torch.zeros(size, dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce_(0, idx, vals, "amax")
    c = values.shape[-1]
    vals = values.reshape(-1, c)
    out = torch.zeros(size, c, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx[:, None].expand(-1, c), vals, "amax")


def yolov7_targets(targets: torch.Tensor, anc: Sequence[Sequence[float]],
                   stride: int, h: int, w: int, anchor_t: float = 4.0):
    """One level's assignment: (match [B,T,3], cx, cy [B,T], anchors
    [3,2] f32) — a target matches an anchor whose wh ratio is below
    ``anchor_t`` either way, at the cell holding its centre."""
    twh = targets[..., 3:5]
    anc_a = torch.tensor(anc, dtype=torch.float32, device=targets.device)
    ratio = twh[..., None, :] / anc_a[None, None]            # [B,T,3,2]
    ratio = torch.maximum(ratio, 1.0 / (ratio + 1e-9))
    match = (torch.amax(ratio, dim=-1) < anchor_t) \
        & (targets[..., 0] >= 0)[..., None]
    cx, cy = _cells(targets[..., 1:3], stride, h, w)
    return match, cx, cy, anc_a


def yolov7_loss(outs: List[torch.Tensor], targets: torch.Tensor,
                anchors, num_classes: int,
                strides: Sequence[int] = STRIDES,
                box_w: float = 0.05, obj_w: float = 1.0, cls_w: float = 0.5,
                anchor_t: float = 4.0, obj_iou_scored: bool = False,
                obj_pos_weight: float = 1.0, return_targets: bool = False):
    """outs[i] [B,Hi,Wi,3·(5+nc)] raw logits; targets [B,T,5] padded.

    Returns (scalar loss, metrics {box, obj, cls}). Per level: targets are
    matched to anchors by wh-ratio < anchor_t at the cell containing the box
    centre; box CIoU + objectness BCE + class BCE.

    obj_iou_scored: True = detached-IoU objectness targets (v5/v7); False
    (default) = binary targets at matched cells. obj_pos_weight weights
    the positive cells of the objectness BCE (renormalized to mean 1).
    return_targets: also put the objectness target maps ([B,H,W,3] a
    level) under metrics["obj_targets"].
    """
    tcls = targets[..., 0]
    txy = targets[..., 1:3]
    twh = targets[..., 3:5]
    total_box = total_obj = total_cls = 0.0
    obj_balance = (4.0, 1.0, 0.4)  # v7's per-level objectness weights
    maps = []

    for li, (out, anc, s) in enumerate(zip(outs, anchors, strides)):
        b, h, w, _ = out.shape
        p = out.reshape(b, h, w, 3, 5 + num_classes).float()
        match, cx, cy, anc_a = yolov7_targets(targets, anc, s, h, w, anchor_t)

        # predictions at the matched cells: [B,T,3,5+nc]
        bi = torch.arange(b, device=out.device)[:, None, None]
        ki = torch.arange(3, device=out.device)[None, None, :]
        pm = p[bi, cy[..., None], cx[..., None], ki]

        sig = torch.sigmoid(pm)
        cxy = torch.stack([cx, cy], -1).float()[..., None, :]
        pxy = (sig[..., 0:2] * 2.0 - 0.5 + cxy) * s
        pwh = (sig[..., 2:4] * 2.0) ** 2 * anc_a[None, None]
        pbox = torch.cat([pxy, pwh], -1)
        tbox = torch.cat([txy, twh], -1)[..., None, :].expand_as(pbox)

        iou = ciou(pbox, tbox)                                # [B,T,3]
        mf = match.float()
        n_match = torch.clamp_min(mf.sum(), 1.0)
        total_box = total_box + ((1.0 - iou) * mf).sum() / n_match

        if num_classes > 1:
            onehot = _one_hot(torch.clamp_min(tcls, 0), num_classes)
            cls_l = bce_logits(pm[..., 5:], onehot[..., None, :]).sum(-1)
            total_cls = total_cls + (cls_l * mf).sum() / n_match

        # objectness targets scattered into [B,H,W,3]
        if obj_iou_scored:
            score = torch.clamp(iou.detach(), 0.0, 1.0) * mf
        else:
            score = mf
        flat_idx = ((bi * h + cy[..., None]) * w + cx[..., None]) * 3 + ki
        tobj = scatter_max(b * h * w * 3, flat_idx, score, match)
        tobj = tobj.reshape(b, h, w, 3)
        maps.append(tobj)
        obj_bce = bce_logits(p[..., 4], tobj)
        if obj_pos_weight != 1.0:
            w_map = torch.where(tobj > 0, obj_pos_weight, 1.0)
            obj_bce = obj_bce * w_map / w_map.mean()
        total_obj = total_obj + obj_balance[li] * obj_bce.mean()

    loss = box_w * total_box + obj_w * total_obj + cls_w * total_cls
    metrics: Dict = {"box": total_box, "obj": total_obj, "cls": total_cls}
    if return_targets:
        metrics["obj_targets"] = maps
    return loss, metrics


def yolov8_loss(outs: List[torch.Tensor], targets: torch.Tensor,
                num_classes: int,
                strides: Sequence[int] = STRIDES,
                box_w: float = 7.5, cls_w: float = 0.5, dfl_w: float = 1.5,
                return_targets: bool = False):
    """Anchor-free detection loss for the YOLOv8 head.

    Each target is assigned to the cell containing its centre at every
    level whose size band it falls in (√(w·h) ∈ [2s, 16s), the first
    level open below and the last open above). Losses: CIoU (box),
    distribution focal loss on the ltrb bin histograms, BCE (cls) over the
    whole map with zero targets at unassigned cells. return_targets: also
    put the class target maps ([B,H,W,nc] a level) under
    metrics["cls_targets"].
    """
    tcls = targets[..., 0]
    txy = targets[..., 1:3]
    twh = targets[..., 3:5]
    tvalid = tcls >= 0
    size = torch.sqrt(torch.clamp_min(twh[..., 0] * twh[..., 1], 1e-6))
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=targets.device)

    total_box = total_cls = total_dfl = 0.0
    maps = []
    for li, (out, s) in enumerate(zip(outs, strides)):
        b, h, w, _ = out.shape
        p = out.float()
        lo = 0.0 if li == 0 else 2.0 * s
        hi = math.inf if li == len(outs) - 1 else 16.0 * s
        match = tvalid & (size >= lo) & (size < hi)

        cx, cy = _cells(txy, s, h, w)
        bi = torch.arange(b, device=out.device)[:, None]
        pm = p[bi, cy, cx]                      # [B,T,4·REG_MAX+nc]

        # DFL decode at the matched cells
        box_logits = pm[..., :4 * REG_MAX].reshape(*pm.shape[:-1], 4, REG_MAX)
        ltrb = (torch.softmax(box_logits, -1) * bins).sum(-1)
        anchor = torch.stack([cx, cy], -1).float() + 0.5
        px1y1 = (anchor - ltrb[..., 0:2]) * s
        px2y2 = (anchor + ltrb[..., 2:4]) * s
        pbox = torch.cat([(px1y1 + px2y2) / 2, px2y2 - px1y1], -1)
        tbox = torch.cat([txy, twh], -1)

        mf = match.float()
        n_match = torch.clamp_min(mf.sum(), 1.0)
        iou = ciou(pbox, tbox)
        total_box = total_box + ((1.0 - iou) * mf).sum() / n_match

        # DFL: cross-entropy against the two bins bracketing the true ltrb
        # distances from the anchor point (stride units, clamped)
        ax = cx.float() + 0.5
        ay = cy.float() + 0.5
        t_l = ax - (txy[..., 0] - twh[..., 0] / 2) / s
        t_t = ay - (txy[..., 1] - twh[..., 1] / 2) / s
        t_r = (txy[..., 0] + twh[..., 0] / 2) / s - ax
        t_b = (txy[..., 1] + twh[..., 1] / 2) / s - ay
        t_ltrb = torch.clamp(torch.stack([t_l, t_t, t_r, t_b], -1),
                             0.0, REG_MAX - 1.001)
        lo_bin = torch.floor(t_ltrb)
        frac = t_ltrb - lo_bin
        logp = F.log_softmax(box_logits, dim=-1)
        lo_i = lo_bin.long()
        lp_lo = torch.gather(logp, -1, lo_i[..., None])[..., 0]
        lp_hi = torch.gather(logp, -1, (lo_i + 1)[..., None])[..., 0]
        dfl = -((1.0 - frac) * lp_lo + frac * lp_hi).mean(-1)
        total_dfl = total_dfl + (dfl * mf).sum() / n_match

        # class BCE over the whole map (cls sigmoid is the confidence)
        onehot = _one_hot(torch.clamp_min(tcls, 0), num_classes)
        flat_idx = (bi * h + cy) * w + cx                     # [B,T]
        tmap = scatter_max(b * h * w, flat_idx, onehot * mf[..., None],
                           match).reshape(b, h, w, num_classes)
        maps.append(tmap)
        total_cls = total_cls \
            + bce_logits(p[..., 4 * REG_MAX:], tmap).sum() / n_match

    loss = box_w * total_box + dfl_w * total_dfl + cls_w * total_cls
    metrics: Dict = {"box": total_box, "dfl": total_dfl, "cls": total_cls}
    if return_targets:
        metrics["cls_targets"] = maps
    return loss, metrics


def xunet_loss(logits: torch.Tensor, masks: torch.Tensor):
    """Per-pixel BCE + soft-dice for the segmentation head (logits and
    masks [B,H,W,1])."""
    bce = bce_logits(logits, masks).mean()
    p = torch.sigmoid(logits)
    inter = (p * masks).sum((1, 2, 3))
    dice = 1.0 - (2 * inter + 1.0) / (p.sum((1, 2, 3))
                                      + masks.sum((1, 2, 3)) + 1.0)
    return bce + dice.mean(), {"bce": bce, "dice": dice.mean()}
