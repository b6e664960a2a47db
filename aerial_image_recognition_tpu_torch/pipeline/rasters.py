"""Raster (GeoTIFF) workflows: sliding-window detection.

Counterpart of the detect half of
``aerial_image_recognition_tpu/pipeline/rasters.py`` (``iter_windows``,
``_extract``, ``detect_geotiff``): the reference's archived GDAL workflow
(x_arch/02_analyze_images cell 6: window 1200 / stride 600, conf > 0.4,
class ∈ {0,1} → GeoJSON). Windows are packed into fixed-shape batches for
the detect step on the card, which resizes them to the model size; the
detections are georeferenced on the host in f64 through the raster's
affine transform. The segmentation half (``segment_geotiff`` and the mask
vectorization) arrives with the segmentation slice.
"""

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from aerial_image_recognition_tpu_torch.gio.geojson import write_geojson
from aerial_image_recognition_tpu_torch.gio.geotiff import GeoTiff, read_geotiff
from aerial_image_recognition_tpu_torch.post.georef import to_numpy
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig


def iter_windows(h: int, w: int, window: int, stride: int
                 ) -> Iterator[Tuple[int, int]]:
    """Top-left corners covering [0,h)×[0,w), edge-clamped like the
    reference's range walk."""
    rows = list(range(0, max(h - window, 0) + 1, stride)) or [0]
    cols = list(range(0, max(w - window, 0) + 1, stride)) or [0]
    if rows[-1] + window < h:
        rows.append(h - window)
    if cols[-1] + window < w:
        cols.append(w - window)
    for r in rows:
        for c in cols:
            yield r, c


def _extract(img: np.ndarray, r: int, c: int, window: int) -> np.ndarray:
    patch = img[r:r + window, c:c + window]
    if patch.shape[:2] != (window, window):
        pad = np.zeros((window, window, img.shape[2]), img.dtype)
        pad[:patch.shape[0], :patch.shape[1]] = patch
        patch = pad
    return patch[:, :, :3]


def detect_geotiff(src, *, window: int = 1200, stride: int = 600,
                   confidence: float = 0.4, model: str = "yolov8_tokyo",
                   batch: int = 16, detect_step=None,
                   params: Optional[str] = None,
                   quantize: Optional[str] = None,
                   quantize_calib: Optional[str] = None,
                   output_geojson: Optional[str] = None,
                   dedup_m: float = 2.0, device=None) -> List[Dict]:
    """Sliding-window detection over a GeoTIFF → georeferenced records.

    Without ``detect_step`` the step is built on ``device`` (default
    ``cuda``; raises without CUDA) for ``window``-px tiles, which it resizes
    to the model size on the card. quantize="int8" + quantize_calib=<json
    from the ``calibrate`` verb>: int8-PTQ the detector trunk
    (build_detect_step's config route). Model pixels map back to raster
    pixels and geo coordinates in f64 on the host; overlapping windows are
    deduplicated within ``dedup_m`` (metric UTM dedup for a geographic
    raster, euclidean in a projected one)."""
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.post.dedup import dedup_records

    cfg = DetectorConfig(model_path=model, confidence_threshold=confidence,
                         params_path=params)
    if quantize is not None:
        if detect_step is not None:
            raise ValueError(
                "quantize= only applies when detect_geotiff builds the "
                "step itself; quantize before building your detect_step")
        cfg.extra["quantize"] = quantize
        cfg.extra["quantize_calib"] = quantize_calib
    elif quantize_calib is not None:
        raise ValueError(
            "quantize_calib given without quantize — pass quantize='int8' "
            "(CLI --quantize int8) or drop the calibration")
    # the step first: without CUDA and without a device this raises before
    # the raster is read
    step = detect_step or build_detect_step(cfg, batch=batch,
                                            src_size=window, device=device)
    gt = src if isinstance(src, GeoTiff) else read_geotiff(src)
    h, w = gt.data.shape[:2]
    corners = list(iter_windows(h, w, window, stride))
    records: List[Dict] = []
    class_names = step.bundle.spec.class_names
    scale = window / step.model_size               # model px → window px
    # bounds unused for raster georef — pass degenerate, map via affine
    bounds = np.tile(np.asarray([[0, 0, 1, 1]], np.float32), (step.batch, 1))
    for i0 in range(0, len(corners), step.batch):
        group = corners[i0:i0 + step.batch]
        imgs = np.zeros((step.batch, window, window, 3), np.uint8)
        for k, (r, c) in enumerate(group):
            imgs[k] = _extract(gt.data, r, c, window)
        det, _, _ = step(imgs, bounds)
        boxes = to_numpy(det.boxes).astype(np.float64)
        scores = to_numpy(det.scores)
        classes = to_numpy(det.classes)
        valid = to_numpy(det.valid)
        for k, (r, c) in enumerate(group):
            for d in np.nonzero(valid[k])[0]:
                # model px → window px → global px → geo, all in f64
                px = c + boxes[k, d, 0] * scale
                py = r + boxes[k, d, 1] * scale
                x, y = gt.pixel_to_geo(px, py)
                cls = int(classes[k, d])
                records.append({
                    "lon": float(x), "lat": float(y),
                    "x": float(x), "y": float(y),
                    "confidence": float(scores[k, d]),
                    "class": (class_names[cls]
                              if 0 <= cls < len(class_names) else str(cls)),
                    "w_px": float(boxes[k, d, 2] * scale),
                    "h_px": float(boxes[k, d, 3] * scale),
                })
    # overlap dedup in the raster CRS (if geographic, metric UTM dedup)
    if dedup_m > 0 and records:
        if gt.epsg in (4326, None):
            records = dedup_records(records, dedup_m)
        else:
            # projected CRS: euclidean dedup directly
            from aerial_image_recognition_tpu_torch.utils.native import (
                dedup_grid_native)
            x = np.array([r["x"] for r in records])
            y = np.array([r["y"] for r in records])
            conf = np.array([r["confidence"] for r in records], np.float32)
            keep = dedup_grid_native(x, y, conf, dedup_m)
            if keep is None:
                from aerial_image_recognition_tpu_torch.post.dedup import (
                    dedup_host)
                keep = dedup_host(x, y, conf, dedup_m)   # approximate path
            records = [r for r, k in zip(records, keep) if k]
    if output_geojson:
        feats = [{"type": "Feature",
                  "geometry": {"type": "Point",
                               "coordinates": [r["x"], r["y"]]},
                  "properties": {"confidence": r["confidence"],
                                 "class": r["class"]}} for r in records]
        write_geojson({"type": "FeatureCollection", "features": feats,
                       "metadata": {"epsg": gt.epsg, "window": window,
                                    "stride": stride}}, output_geojson)
    return records
