"""Detection metrics: mAP@50, mAP@50:95 (COCO-style 101-point AP).

Copy of ``aerial_image_recognition_tpu/ops/metrics.py`` (numpy only):
the notebook's ultralytics ``model.val()`` step, host-side.
"""

from typing import Dict, Sequence

import numpy as np


def iou_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of [N,4] vs [M,4] cxcywh boxes → [N,M]."""
    ax1, ay1 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax2, ay2 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx1, by1 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx2, by2 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    ix = np.maximum(0, np.minimum(ax2[:, None], bx2) - np.maximum(ax1[:, None], bx1))
    iy = np.maximum(0, np.minimum(ay2[:, None], by2) - np.maximum(ay1[:, None], by1))
    inter = ix * iy
    union = ((ax2 - ax1) * (ay2 - ay1))[:, None] + (bx2 - bx1) * (by2 - by1) - inter
    return inter / np.maximum(union, 1e-9)


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO 101-point interpolated AP (step interpolation: the precision at
    recall g is the max precision among samples with recall ≥ g)."""
    r = np.concatenate([recall, [1.0]])
    p = np.concatenate([precision, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]
    grid = np.linspace(0, 1, 101)
    idx = np.searchsorted(r, grid, side="left")
    vals = np.where(idx < len(p), p[np.minimum(idx, len(p) - 1)], 0.0)
    return float(np.mean(vals))


def evaluate_detections(
        preds: Sequence[Dict], gts: Sequence[Dict], num_classes: int,
        iou_thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
) -> Dict[str, float]:
    """preds/gts: per-image dicts {boxes [N,4] cxcywh, classes [N],
    scores [N] (preds only)} → {'mAP50', 'mAP50_95', per-class AP50}."""
    aps = np.zeros((len(iou_thresholds), num_classes))
    for ci in range(num_classes):
        # flatten predictions of this class across images
        rows = []      # (score, image_idx, box)
        n_gt = 0
        gt_boxes_per_img = []
        for ii, (p, g) in enumerate(zip(preds, gts)):
            gmask = np.asarray(g["classes"]) == ci
            gt_boxes_per_img.append(np.asarray(g["boxes"])[gmask])
            n_gt += int(gmask.sum())
            pmask = np.asarray(p["classes"]) == ci
            for b, s in zip(np.asarray(p["boxes"])[pmask],
                            np.asarray(p["scores"])[pmask]):
                rows.append((float(s), ii, b))
        if n_gt == 0:
            aps[:, ci] = np.nan
            continue
        rows.sort(key=lambda r: -r[0])
        for ti, thr in enumerate(iou_thresholds):
            matched = [np.zeros(len(g), bool) for g in gt_boxes_per_img]
            tp = np.zeros(len(rows))
            fp = np.zeros(len(rows))
            for ri, (score, ii, box) in enumerate(rows):
                g = gt_boxes_per_img[ii]
                if len(g) == 0:
                    fp[ri] = 1
                    continue
                ious = iou_xywh(box[None, :], g)[0]
                # best-IoU UNMATCHED gt above threshold (COCO semantics —
                # argmax alone counts a pred FP when its top gt is taken,
                # even though another gt qualifies; that biases AP low on
                # clustered objects)
                cand = np.where((ious >= thr) & ~matched[ii])[0]
                if len(cand):
                    j = int(cand[np.argmax(ious[cand])])
                    tp[ri] = 1
                    matched[ii][j] = True
                else:
                    fp[ri] = 1
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recall = ctp / n_gt
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            aps[ti, ci] = average_precision(recall, precision)
    valid = ~np.isnan(aps[0])
    out = {
        "mAP50": float(np.nanmean(aps[0])) if valid.any() else 0.0,
        "mAP50_95": float(np.nanmean(aps)) if valid.any() else 0.0,
    }
    for ci in range(num_classes):
        out[f"AP50_class{ci}"] = float(aps[0, ci])
    return out
