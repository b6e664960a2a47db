"""Detect-head decode: raw per-level maps → (boxes, scores).

Counterpart of ``aerial_image_recognition_tpu/ops/decode.py:decode_yolov7``.
The anchor index runs (level, y, x, anchor) exactly as there: NMS breaks
score ties toward the lower index, so this order is part of the result.
"""

from typing import List, Sequence, Tuple

import torch

from aerial_image_recognition_tpu_torch.models.yolov7 import STRIDES


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
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=out.device),
            torch.arange(w, dtype=torch.float32, device=out.device),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
        anc_a = torch.tensor(anc, dtype=torch.float32,
                             device=out.device)[None, None, None]
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
