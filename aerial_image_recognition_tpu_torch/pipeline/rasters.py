"""Raster (GeoTIFF) workflows: sliding-window detection and segmentation.

Counterpart of ``aerial_image_recognition_tpu/pipeline/rasters.py``.
Detection (``iter_windows``, ``_extract``, ``detect_geotiff``) is the
reference's archived GDAL workflow (x_arch/02_analyze_images cell 6:
window 1200 / stride 600, conf > 0.4, class ∈ {0,1} → GeoJSON). Windows
are packed into fixed-shape batches for the detect step on the card, which
resizes them to the model size; the detections are georeferenced on the
host in f64 through the raster's affine transform.

Segmentation (``build_xunet_segment_fn``, ``stitch_probability_map``,
``segment_geotiff``, ``mask_to_polygons``) runs XUnet-256 over the
raster's windows in fixed-shape batches on the card, resizes the model-
resolution probabilities back to the window on the host, averages them
where windows overlap, and thresholds the stitched map into a mask GeoTIFF
and boundary polygons. A ``segment_fn`` here carries its weights: it maps
uint8 windows [B,w,w,3] to probabilities [B,S,S,1] (the reference's takes
a params tree beside them).
"""

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from aerial_image_recognition_tpu_torch.gio.geojson import write_geojson
from aerial_image_recognition_tpu_torch.gio.geotiff import (
    GeoTiff, read_geotiff, write_geotiff)
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


def build_xunet_segment_fn(gt: GeoTiff, *, window: int, batch: int,
                           params=None, quantize: Optional[str] = None,
                           device=None):
    """Build the XUnet executor shared by ``segment_geotiff`` and
    ``automask.probability_map``: the bf16 bundle on ``device`` (default
    ``cuda``; raises without CUDA) from a checkpoint path or an in-memory
    flax-format tree (random weights without either), optionally int8-PTQ
    (``models/int8.quantize_xunet``) self-calibrated on the raster's own
    first ``batch`` windows in chunks of 8 (the imagery being scanned is
    the representative imagery). Returns (segment_fn, bundle)."""
    import torch

    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        make_segment_fn)

    bundle = create_model(
        "xunet_256", dtype=torch.bfloat16,
        params_path=params if isinstance(params, str) else None,
        variables=None if isinstance(params, str) else params,
        device=device, fold_bn=True)
    if quantize == "int8":
        from aerial_image_recognition_tpu_torch.models.int8 import (
            quantize_xunet)
        h, w = gt.data.shape[:2]
        corners = list(iter_windows(h, w, window, window))[:batch]
        calib = np.stack([_extract(gt.data, r, c, window)
                          for r, c in corners])
        # absmax is a running maximum: chunks of 8 bound the calibration
        # forward's memory
        bundle = quantize_xunet(
            bundle, [calib[i:i + 8] for i in range(0, len(calib), 8)])
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    cfg = DetectorConfig(model_family="xunet")
    return make_segment_fn(bundle, cfg), bundle


def _place_probs(probs: np.ndarray, window: int) -> np.ndarray:
    """Model-resolution [B,S,S] probabilities → window-resolution [B,w,w]
    for stitching: the bilinear resize of ``jax.image.resize`` (triangle
    kernel, antialiased when it shrinks) as two f32 matrix products on the
    host, with the weights of ``ops/preprocess._resize_matrix``."""
    if probs.shape[1] == window:
        return probs
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        _resize_matrix)
    r = _resize_matrix(probs.shape[1], window, "bilinear")      # [w, S]
    return np.matmul(np.matmul(r, np.asarray(probs, np.float32)), r.T)


def stitch_probability_map(gt: GeoTiff, segment_fn, *, window: int = 256,
                           stride: Optional[int] = None,
                           batch: int = 16) -> np.ndarray:
    """Batched sliding-window segmentation probabilities stitched over the
    whole raster → float32 [H, W].

    Every batch has the fixed shape [batch, window, window, 3] (the last
    one zero-padded). stride < window averages the predictions where
    windows overlap: a U-Net's border pixels see the least context, so
    non-overlapping tiles leave seams. The default steps by the window;
    the edge-clamped last row and column (``iter_windows``) overlap their
    neighbours and are averaged too."""
    h, w = gt.data.shape[:2]
    stride = stride or window
    if stride > window:
        raise ValueError(
            f"stride {stride} > window {window} would leave uncovered "
            "pixels silently scored as background")
    acc = np.zeros((h, w), np.float32)
    cnt = np.zeros((h, w), np.float32)
    corners = list(iter_windows(h, w, window, stride))
    for i0 in range(0, len(corners), batch):
        group = corners[i0:i0 + batch]
        imgs = np.zeros((batch, window, window, 3), np.uint8)
        for k, (r, c) in enumerate(group):
            imgs[k] = _extract(gt.data, r, c, window)
        probs = _place_probs(
            to_numpy(segment_fn(imgs)).astype(np.float32)[..., 0], window)
        for k, (r, c) in enumerate(group):
            hh = min(window, h - r)
            ww = min(window, w - c)
            acc[r:r + hh, c:c + ww] += probs[k, :hh, :ww]
            cnt[r:r + hh, c:c + ww] += 1.0
    return acc / np.maximum(cnt, 1.0)


def segment_geotiff(src, *, window: int = 256, threshold: float = 0.5,
                    batch: int = 16, stride: Optional[int] = None,
                    segment_fn=None, params=None,
                    quantize: Optional[str] = None,
                    output_mask: Optional[str] = None,
                    output_polygons: Optional[str] = None,
                    device=None) -> np.ndarray:
    """XUnet sliding-window segmentation → stitched binary mask uint8
    [H, W] (+ a mask GeoTIFF, 0/255, and a polygon GeoJSON).

    Without ``segment_fn`` the executor is built on ``device`` (default
    ``cuda``; raises without CUDA before the raster is read) from
    ``params`` (a checkpoint path or a flax-format tree).
    quantize="int8": int8-PTQ the XUnet trunk, self-calibrating on this
    raster's own first windows (see ``build_xunet_segment_fn``).
    stride < window: overlap-averaged stitching."""
    if segment_fn is None:
        from aerial_image_recognition_tpu_torch.runtime.device import (
            resolve_device)
        device = resolve_device(device)
    elif quantize is not None:
        raise ValueError(
            "quantize= only applies when segment_geotiff builds the "
            "executor itself; quantize before building your segment_fn")
    gt = src if isinstance(src, GeoTiff) else read_geotiff(src)
    if segment_fn is None:
        segment_fn, _ = build_xunet_segment_fn(
            gt, window=window, batch=batch, params=params,
            quantize=quantize, device=device)

    probs = stitch_probability_map(gt, segment_fn, window=window,
                                   stride=stride, batch=batch)
    mask = (probs >= threshold).astype(np.uint8)
    if output_mask:
        write_geotiff(output_mask, mask * 255, gt.transform, gt.epsg)
    if output_polygons:
        feats = []
        for ring in mask_to_polygons(mask):
            x, y = gt.pixel_to_geo(ring[:, 0], ring[:, 1])
            coords = np.stack([x, y], axis=1).tolist()
            feats.append({"type": "Feature",
                          "geometry": {"type": "Polygon",
                                       "coordinates": [coords]},
                          "properties": {}})
        write_geojson({"type": "FeatureCollection", "features": feats,
                       "metadata": {"epsg": gt.epsg}}, output_polygons)
    return mask


def mask_to_polygons(mask: np.ndarray) -> List[np.ndarray]:
    """Binary mask → boundary rings [(N,2) arrays of (col,row) vertices].

    Axis-aligned boundary tracing (marching squares for a binary input):
    collect the directed edges where a 1-cell borders a 0-cell (interior
    on the left), then chain them into closed rings."""
    m = np.pad(mask.astype(bool), 1)
    edges = {}   # start vertex -> [end vertices]
    ys, xs = np.nonzero(m)
    for r, c in zip(ys, xs):
        # vertices in unpadded pixel coordinates
        tl = (c - 1, r - 1)
        tr = (c, r - 1)
        br = (c, r)
        bl = (c - 1, r)
        if not m[r - 1, c]:
            edges.setdefault(tl, []).append(tr)   # top edge, eastward
        if not m[r, c + 1]:
            edges.setdefault(tr, []).append(br)   # right edge, southward
        if not m[r + 1, c]:
            edges.setdefault(br, []).append(bl)   # bottom edge, westward
        if not m[r, c - 1]:
            edges.setdefault(bl, []).append(tl)   # left edge, northward
    rings = []
    while edges:
        start = next(iter(edges))
        ring = [start]
        cur = start
        while True:
            outs = edges.get(cur)
            if not outs:
                break
            nxt = outs.pop()
            if not outs:
                del edges[cur]
            ring.append(nxt)
            cur = nxt
            if cur == start:
                break
        if len(ring) > 3:
            rings.append(np.asarray(ring, dtype=np.float64))
    return rings
