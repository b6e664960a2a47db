"""Georeferencing: model-pixel detections → WGS84 lon/lat.

Counterpart of ``aerial_image_recognition_tpu/post/georef.py``: the linear
pixel→geo map x_frac = x/model_size, lon = west + x_frac·(east−west),
lat = north − y_frac·(north−south).

Precision split, as in the reference: ``lonlat`` runs on the device in f32
beside the detect step; the records that leave the system come from the
host in f64 numpy (tile spans are ~1e-3°, so f32 absolute longitudes would
quantize at ~0.1 m, too coarse for the 1 m dedup radius).
"""

from typing import Sequence

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """Tensor (any device) or array-like → numpy (copies off the card)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def detections_to_lonlat(boxes_xy, bounds, model_size: int = 640
                         ) -> np.ndarray:
    """boxes_xy [B,D,2] (cx,cy model pixels) + bounds [B,4] (w,s,e,n)
    → [B,D,2] (lon,lat), f64."""
    boxes_xy = to_numpy(boxes_xy).astype(np.float64)
    bounds = to_numpy(bounds).astype(np.float64)
    w = bounds[:, 0:1]
    s = bounds[:, 1:2]
    e = bounds[:, 2:3]
    n = bounds[:, 3:4]
    x_frac = boxes_xy[..., 0] / model_size
    y_frac = boxes_xy[..., 1] / model_size
    lon = w + x_frac * (e - w)
    lat = n - y_frac * (n - s)
    return np.stack([lon, lat], axis=-1)


def detections_to_records(det, bounds, model_size: int = 640,
                          class_names: Sequence[str] = ("car",)):
    """Fixed-slot Detections → list of detection-record dicts
    (lon/lat/confidence/class + model-space box + tile_index)."""
    boxes = to_numpy(det.boxes).astype(np.float64)
    scores = to_numpy(det.scores).astype(np.float64)
    classes = to_numpy(det.classes)
    valid = to_numpy(det.valid)
    lonlat = detections_to_lonlat(boxes[..., :2], bounds, model_size)
    records = []
    b_idx, d_idx = np.nonzero(valid)
    for bi, di in zip(b_idx.tolist(), d_idx.tolist()):
        cls = int(classes[bi, di])
        records.append({
            "lon": float(lonlat[bi, di, 0]),
            "lat": float(lonlat[bi, di, 1]),
            "confidence": float(scores[bi, di]),
            "class": class_names[cls] if 0 <= cls < len(class_names) else str(cls),
            "yolo": {"x": float(boxes[bi, di, 0]), "y": float(boxes[bi, di, 1]),
                     "w": float(boxes[bi, di, 2]), "h": float(boxes[bi, di, 3])},
            "tile_index": bi,
        })
    return records


def lonlat(boxes_xy: torch.Tensor, bounds: torch.Tensor,
           model_size: int = 640):
    """Device variant: boxes_xy [B,D,2], bounds [B,4] → (lon, lat) [B,D]
    each, in the bounds' dtype (f32 on the detect path)."""
    w = bounds[:, 0:1]
    s = bounds[:, 1:2]
    e = bounds[:, 2:3]
    n = bounds[:, 3:4]
    # a 0-dim divisor: a true division on the card as on the CPU
    size = torch.full((), model_size, dtype=boxes_xy.dtype,
                      device=boxes_xy.device)
    x_frac = boxes_xy[..., 0] / size
    y_frac = boxes_xy[..., 1] / size
    return w + x_frac * (e - w), n - y_frac * (n - s)
