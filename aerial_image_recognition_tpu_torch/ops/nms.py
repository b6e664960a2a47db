"""Batched greedy NMS with fixed output slots, and box voting.

Counterpart of ``aerial_image_recognition_tpu/ops/nms.py`` (``Detections``,
``iou_matrix``, ``_nms_single``, ``_nms_fixpoint``, ``box_voting``,
``batched_nms``). Exact greedy NMS: the highest remaining score wins, and
its IoU > threshold neighbours (of the same class when class-aware) drop
out, for ``max_det`` rounds over a top-K preselection.

The suppression tail has three forms with one contract and bit-identical
picks:
  * ``_suppress_plain`` — the port of ``_nms_single`` in plain torch ops:
    the CPU path, and the reference the tests and the card's smoke hold
    the kernel against;
  * ``ops/nms_kernel.nms_suppress`` — the hand-written CUDA kernel, which
    ``batched_nms`` launches for tensors on the card. The preselect below
    is a stable descending sort and the mask to −1 keeps the row
    non-increasing, so the pick of a round is the first candidate not yet
    knocked out: the kernel sweeps an alive bitmask in that order, a warp's
    32 candidates per step, and stops when it is empty. A row in any other
    order takes the kernel's general path (one explicit argmax round per
    slot), with the same picks;
  * ``_suppress_fixpoint`` — the port of ``_nms_fixpoint``
    (``suppression="fixpoint"``): no serial pick loop.
"""

from typing import NamedTuple, Optional

import torch


class Detections(NamedTuple):
    """Fixed-slot detection batch (invalid slots masked, not removed)."""
    boxes: torch.Tensor    # [B, D, 4] cx,cy,w,h (model pixels) f32
    scores: torch.Tensor   # [B, D] f32
    classes: torch.Tensor  # [B, D] int32
    valid: torch.Tensor    # [B, D] bool


def _corners(boxes_t: torch.Tensor):
    """[..., 4, K] cxcywh → x1, y1, x2, y2, area, each [..., K]."""
    cx, cy, w, h = boxes_t.unbind(-2)
    hw, hh = w * 0.5, h * 0.5
    x1, x2 = cx - hw, cx + hw
    y1, y2 = cy - hh, cy + hh
    return x1, y1, x2, y2, (x2 - x1) * (y2 - y1)


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of cxcywh boxes: [..., N, 4] × [..., M, 4] → [..., N, M].

    Operation order is the reference's, and the CUDA kernel's: corners as
    c ∓ w·0.5, then inter / max(area_a + area_b − inter, 1e-9).
    """
    ax1, ay1, ax2, ay2, area_a = _corners(boxes_a.transpose(-1, -2))
    bx1, by1, bx2, by2, area_b = _corners(boxes_b.transpose(-1, -2))
    ix = torch.clamp_min(
        torch.minimum(ax2[..., :, None], bx2[..., None, :])
        - torch.maximum(ax1[..., :, None], bx1[..., None, :]), 0.0)
    iy = torch.clamp_min(
        torch.minimum(ay2[..., :, None], by2[..., None, :])
        - torch.maximum(ay1[..., :, None], by1[..., None, :]), 0.0)
    inter = ix * iy
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def _suppress_plain(boxes_t: torch.Tensor, scores: torch.Tensor,
                    classes: torch.Tensor, *, iou_threshold: float,
                    max_det: int, class_aware: bool):
    """Greedy suppression in plain torch — the port of ``_nms_single``.

    boxes_t [B,4,K] f32 cxcywh (coordinate-major), scores [B,K] f32 with −1
    marking candidates below the confidence threshold, classes [B,K] int32
    → (idx [B,D] int32, conf [B,D] f32, cls [B,D] int32).

    Each round picks the argmax of the available scores (ties, including
    the all −1 case, go to the lowest index), records it, and sets to −1 the
    pick and every box whose IoU with it exceeds the threshold.
    """
    boxes = boxes_t.transpose(1, 2)
    iou = iou_matrix(boxes, boxes)                                # [B,K,K]
    if class_aware:
        same = classes[:, :, None] == classes[:, None, :]
        iou = torch.where(same, iou, torch.zeros((), dtype=iou.dtype,
                                                 device=iou.device))
    avail = scores.clone()
    rows = torch.arange(scores.shape[0], device=scores.device)
    idx, conf = [], []
    for _ in range(max_det):
        i = torch.argmax(avail, dim=1)              # first max wins ties
        idx.append(i)
        conf.append(avail[rows, i])
        suppress = iou[rows, i] > iou_threshold
        avail = torch.where(suppress, -1.0, avail)
        avail[rows, i] = -1.0
    idx = torch.stack(idx, 1)
    return (idx.to(torch.int32), torch.stack(conf, 1),
            torch.gather(classes, 1, idx))


def _suppress_fixpoint(boxes_t: torch.Tensor, scores: torch.Tensor,
                       classes: torch.Tensor, *, iou_threshold: float,
                       max_det: int, class_aware: bool):
    """Greedy suppression without the serial pick loop — the port of
    ``_nms_fixpoint``; the contract of ``_suppress_plain``.

    Box i survives iff no surviving box of higher priority (score
    descending, index ascending: argmax's tie rule) overlaps it. The
    dependency graph is acyclic, so iterating from all-survive reaches the
    unique fixpoint in as many rounds as the longest suppression chain (a
    handful on real tiles, against ``max_det`` serial rounds). Each round
    is one [B,K,K] masked any-reduce; the loop's end test reads one flag
    back to the host. The survivors in score order are the greedy pick
    sequence: the same valid picks as ``_suppress_plain``, bit for bit
    (slots past the last valid pick hold conf −1 and an arbitrary index).
    """
    b, k = scores.shape
    boxes = boxes_t.transpose(1, 2)
    iou = iou_matrix(boxes, boxes)                                # [B,K,K]
    if class_aware:
        iou = iou * (classes[:, :, None] == classes[:, None, :])
    lane = torch.arange(k, device=scores.device)
    s_j, s_i = scores[:, None, :], scores[:, :, None]
    # dom[b,i,j]: j may suppress i (overlaps and strictly higher priority)
    dom = (iou > iou_threshold) & (
        (s_j > s_i) | ((s_j == s_i) & (lane[None, :] < lane[:, None])))
    kept = torch.ones_like(scores, dtype=torch.bool)
    while True:
        new = ~(dom & kept[:, None, :]).any(2)
        if torch.equal(new, kept):
            break
        kept = new
    d = min(max_det, k)
    # stable descending sort: ties keep the lower index, as lax.top_k does
    conf, idx = torch.sort(torch.where(kept, scores, -1.0), dim=1,
                           descending=True, stable=True)
    conf, idx = conf[:, :d], idx[:, :d]
    if d < max_det:                       # fewer candidates than slots
        pad = (0, max_det - d)
        conf = torch.nn.functional.pad(conf, pad, value=-1.0)
        idx = torch.nn.functional.pad(idx, pad)
    return idx.to(torch.int32), conf, torch.gather(classes, 1, idx)


def box_voting(det: Detections, cand_boxes: torch.Tensor,
               cand_scores: torch.Tensor, cand_cls: torch.Tensor, *,
               vote_iou: float, conf_threshold: float,
               class_aware: bool) -> Detections:
    """Score-weighted box refinement of NMS survivors (box voting): each
    kept box is replaced by the score-weighted mean of every candidate box
    that overlaps it at IoU >= vote_iou (same class when class_aware),
    including the suppressed near-duplicates NMS discarded. Recovers
    localization precision that argmax-keep throws away.

    det: the NMS output. cand_*: the preselected candidate set the
    suppression ran over ([B,K,4] / [B,K] / [B,K]). Scores, classes and
    validity pass through unchanged; only boxes move.

    The weighted sum is written elementwise in f32, never as a matrix
    product: on tensor cores at reduced precision a 640-px coordinate
    would lose the pixels that a small car's IoU margin consists of.
    """
    m = iou_matrix(det.boxes, cand_boxes) >= vote_iou             # [B,D,K]
    m = m & (cand_scores >= conf_threshold)[:, None, :]
    if class_aware:
        m = m & (det.classes[:, :, None] == cand_cls[:, None, :])
    w = m * cand_scores[:, None, :].to(torch.float32)
    tot = w.sum(2, keepdim=True)                                  # [B,D,1]
    voted = (w[..., None] * cand_boxes[:, None].to(torch.float32)).sum(2) \
        / torch.clamp_min(tot, 1e-9)
    # invalid slots keep zeros; a valid box always matches itself, but
    # guard tot==0 anyway (degenerate zero-area boxes)
    keep_orig = (tot <= 0.0) | ~det.valid[..., None]
    return det._replace(boxes=torch.where(keep_orig, det.boxes,
                                          voted.to(det.boxes.dtype)))


_SUPPRESSIONS = (None, "pallas", "scan", "fixpoint")


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, *,
                num_classes: int,
                conf_threshold: float = 0.3,
                iou_threshold: float = 0.45,
                max_det: int = 128,
                pre_topk: int = 512,
                class_aware: bool = True,
                preselect: str = "exact",
                suppression: Optional[str] = None,
                vote_iou: Optional[float] = None) -> Detections:
    """boxes [B,A,4] cxcywh, scores [B,A,nc] → Detections with D=max_det.

    preselect: the top ``pre_topk`` candidates by best-class score, by a
    stable descending sort, so ties keep the lower index as
    ``lax.top_k`` does (``torch.topk`` promises no tie order). 'approx'
    (the reference's TPU partial sort) maps to this exact preselect.

    suppression: None, 'pallas' or 'scan' — the serial greedy form: the
    CUDA kernel for tensors on the card, ``_suppress_plain`` for tensors
    on the CPU ('pallas' and 'scan' are the reference's names for its
    kernel and its XLA loop, kept so that a config written for it works
    unchanged; both mean this one path here); 'fixpoint' —
    ``_suppress_fixpoint``. All give the same picks. Class-aware
    suppression applies only when ``num_classes > 1``.

    vote_iou: when set, survivors' boxes are refined by score-weighted
    box voting over the preselected candidates at this IoU gate
    (``box_voting``); None = off.
    """
    if preselect not in ("exact", "approx"):
        raise ValueError(f"unknown preselect {preselect!r}")
    if suppression not in _SUPPRESSIONS:
        raise ValueError(f"unknown nms suppression {suppression!r} "
                         "(expected 'pallas', 'scan' or 'fixpoint')")
    if suppression == "fixpoint":
        suppress = _suppress_fixpoint
    else:
        from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
            nms_suppress as suppress)

    b, a, _ = boxes.shape
    k = min(pre_topk, a)
    best = torch.amax(scores, dim=-1)                             # [B, A]
    cls = torch.argmax(scores, dim=-1).to(torch.int32)
    top_scores, idx = torch.sort(best, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(b, k, 4))
    top_cls = torch.gather(cls, 1, idx)

    masked = torch.where(top_scores >= conf_threshold,
                         top_scores.float(), -1.0)
    aware = class_aware and num_classes > 1
    pidx, pconf, pcls = suppress(
        top_boxes.float().transpose(1, 2).contiguous(), masked.contiguous(),
        top_cls.contiguous(), iou_threshold=float(iou_threshold),
        max_det=max_det, class_aware=aware)
    valid = pconf >= conf_threshold
    out_boxes = torch.gather(top_boxes, 1,
                             pidx.long()[..., None].expand(b, max_det, 4))
    det = Detections(
        boxes=torch.where(valid[..., None], out_boxes, 0.0),
        scores=torch.where(valid, pconf, 0.0),
        classes=torch.where(valid, pcls, -1),
        valid=valid,
    )
    if vote_iou is not None:
        det = box_voting(det, top_boxes, top_scores, top_cls,
                         vote_iou=float(vote_iou),
                         conf_threshold=conf_threshold, class_aware=aware)
    return det
