"""Detect-head decode: raw per-level maps → (boxes, scores).

Counterpart of ``aerial_image_recognition_tpu/ops/decode.py``
(``decode_yolov7``, ``decode_yolov8``). The anchor index runs (level, y, x,
anchor) for yolov7 and (level, y, x) for yolov8, exactly as there: NMS
breaks score ties toward the lower index, so this order is part of the
result. Box arithmetic is elementwise f32 throughout (no matrix product, so
TF32 on the card can never touch a coordinate).
"""

from typing import List, Sequence, Tuple

import torch

from aerial_image_recognition_tpu_torch.models.yolov7 import STRIDES
from aerial_image_recognition_tpu_torch.models.yolov8 import REG_MAX
from aerial_image_recognition_tpu_torch.models.yolov8 import (
    STRIDES as V8_STRIDES)


def _grid(h: int, w: int, device):
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return gx, gy


_anchors_on_device = {}


def _device_anchors(anc, device) -> torch.Tensor:
    """One level's anchors [1,1,1,3,2] f32 on ``device``, uploaded once: a
    tensor built from a Python list on the card is a synchronous copy, which
    would stall the host in every step and serialize the ingest pipeline."""
    key = (tuple(tuple(float(v) for v in a) for a in anc), device)
    if key not in _anchors_on_device:
        _anchors_on_device[key] = torch.tensor(
            key[0], dtype=torch.float32, device=device)[None, None, None]
    return _anchors_on_device[key]


def decode_yolov7(outs: List[torch.Tensor],
                  anchors: Sequence[Sequence[Tuple[float, float]]],
                  num_classes: int,
                  strides: Sequence[int] = STRIDES):
    """YOLOv5/v7 decode: xy = (2σ−0.5 + grid)·stride, wh = (2σ)²·anchor.

    outs[i]: [B, H, W, 3·(5+nc)] raw f32 logits (NHWC, as the heads emit
    them). Returns (boxes [B, A, 4] cx,cy,w,h in input pixels; scores
    [B, A, nc] = obj·cls, or objectness alone at nc=1).
    """
    boxes_all, scores_all = [], []
    for out, anc, s in zip(outs, anchors, strides):
        b, h, w, _ = out.shape
        y = torch.sigmoid(out.reshape(b, h, w, 3, 5 + num_classes))
        gx, gy = _grid(h, w, out.device)
        grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
        anc_a = _device_anchors(anc, out.device)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * float(s)
        wh = (y[..., 2:4] * 2.0) ** 2 * anc_a
        if num_classes == 1:
            # single-class: confidence is objectness alone (no class loss is
            # trained at nc=1)
            scores = y[..., 4:5]
        else:
            scores = y[..., 4:5] * y[..., 5:]
        boxes_all.append(torch.cat([xy, wh], -1).reshape(b, -1, 4))
        scores_all.append(scores.reshape(b, -1, num_classes))
    return torch.cat(boxes_all, 1), torch.cat(scores_all, 1)


def decode_yolov8(outs: List[torch.Tensor], num_classes: int,
                  strides: Sequence[int] = V8_STRIDES):
    """Anchor-free DFL decode: per side the softmax expectation over
    REG_MAX bins → ltrb distances from the cell centres → cxcywh pixels;
    scores = σ(cls).

    outs[i]: [B, H, W, 4·REG_MAX + nc] raw f32 logits (NHWC). The
    expectation is an elementwise product with the bin values summed over
    the bins, where the reference writes an einsum.
    """
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=outs[0].device)
    boxes_all, scores_all = [], []
    for out, s in zip(outs, strides):
        b, h, w, _ = out.shape
        box_logits = out[..., : 4 * REG_MAX].reshape(b, h, w, 4, REG_MAX)
        ltrb = (torch.softmax(box_logits, dim=-1) * bins).sum(-1)
        gx, gy = _grid(h, w, out.device)
        cx = gx[None] + 0.5
        cy = gy[None] + 0.5
        x1 = cx - ltrb[..., 0]
        y1 = cy - ltrb[..., 1]
        x2 = cx + ltrb[..., 2]
        y2 = cy + ltrb[..., 3]
        boxes = torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1,
                             y2 - y1], dim=-1) * float(s)
        scores = torch.sigmoid(out[..., 4 * REG_MAX:])
        boxes_all.append(boxes.reshape(b, -1, 4))
        scores_all.append(scores.reshape(b, -1, num_classes))
    return torch.cat(boxes_all, 1), torch.cat(scores_all, 1)
