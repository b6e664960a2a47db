"""Automatic instance masks over GeoTIFFs (the SAM2 workflow).

Counterpart of ``aerial_image_recognition_tpu/pipeline/automask.py``: the
reference's archived SAM2 script (x_arch/car_recognition_on_tiff.py:12-46)
runs SamGeo2 automatic mask generation on a GeoTIFF and writes a mask
raster plus vectorized instances. Here the per-pixel scoring is the XUnet
sweep of ``pipeline/rasters.py`` on the card, and the instances are
extracted on the host SAM-style: connected components at the middle of a
threshold ladder, each scored by its stability across the ladder (kept
when its shape hardly depends on the cutoff), area and stability filters,
then polygons with per-instance scores (GeoJSON, or a GeoPackage for a
``.gpkg`` path).
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from aerial_image_recognition_tpu_torch.gio.geojson import write_geojson
from aerial_image_recognition_tpu_torch.gio.geotiff import (
    GeoTiff, read_geotiff, write_geotiff)


def probability_map(gt: GeoTiff, *, window: int = 256, batch: int = 16,
                    stride: Optional[int] = None, segment_fn=None,
                    params=None, quantize: Optional[str] = None,
                    device=None) -> np.ndarray:
    """Stitched [H, W] float32 foreground probability by batched XUnet.

    Without ``segment_fn`` the executor is built on ``device`` (default
    ``cuda``) from ``params`` (a checkpoint path or a flax-format tree);
    quantize="int8": int8-PTQ the trunk, self-calibrating on this raster's
    own first windows (``rasters.build_xunet_segment_fn``). stride <
    window: overlap-averaged stitching (``rasters.stitch_probability_map``).
    """
    from aerial_image_recognition_tpu_torch.pipeline.rasters import (
        build_xunet_segment_fn, stitch_probability_map)

    if segment_fn is None:
        segment_fn, _ = build_xunet_segment_fn(
            gt, window=window, batch=batch, params=params,
            quantize=quantize, device=device)
    elif quantize is not None:
        raise ValueError(
            "quantize= only applies when probability_map builds the "
            "executor itself; quantize before building your segment_fn")
    return stitch_probability_map(gt, segment_fn, window=window,
                                  stride=stride, batch=batch)


def extract_instances(probs: np.ndarray, *,
                      thresholds: Sequence[float] = (0.35, 0.5, 0.65),
                      min_area_px: int = 20,
                      stability_min: float = 0.6) -> List[Dict]:
    """SAM-style instance extraction from a probability map.

    Instances are the connected components at the middle threshold; each
    gets a stability score, IoU(component at the high cutoff, component
    at the low cutoff) — SAM's stability_score — and its mean probability
    as a quality score. Components below ``min_area_px`` or
    ``stability_min`` are dropped.
    Returns [{'id', 'area_px', 'stability', 'score', 'mask_slice', 'mask'}].
    """
    from scipy import ndimage as ndi

    ladder = sorted(thresholds)
    lo, mid, hi = ladder[0], ladder[len(ladder) // 2], ladder[-1]
    labels, _ = ndi.label(probs >= mid)
    out: List[Dict] = []
    for idx, sl in enumerate(ndi.find_objects(labels), start=1):
        if sl is None:
            continue
        comp = labels[sl] == idx
        area = int(comp.sum())
        if area < min_area_px:
            continue
        p = probs[sl]
        m_lo = (p >= lo) & _grow_region(comp)
        m_hi = (p >= hi) & comp
        union = (m_lo | comp).sum()
        stability = float(m_hi.sum() / union) if union else 0.0
        if stability < stability_min:
            continue
        out.append({"id": len(out) + 1, "area_px": area,
                    "stability": round(stability, 4),
                    "score": round(float(p[comp].mean()), 4),
                    "mask_slice": sl, "mask": comp})
    return out


def _grow_region(mask: np.ndarray) -> np.ndarray:
    """One-pixel dilation (4-neighbourhood)."""
    g = mask.copy()
    g[1:] |= mask[:-1]
    g[:-1] |= mask[1:]
    g[:, 1:] |= mask[:, :-1]
    g[:, :-1] |= mask[:, 1:]
    return g


def automask_geotiff(src, *, window: int = 256, batch: int = 16,
                     stride: Optional[int] = None,
                     segment_fn=None, params=None,
                     quantize: Optional[str] = None,
                     thresholds: Sequence[float] = (0.35, 0.5, 0.65),
                     min_area_px: int = 20, stability_min: float = 0.6,
                     output_mask: Optional[str] = None,
                     output_polygons: Optional[str] = None,
                     device=None) -> List[Dict]:
    """GeoTIFF → instance list (+ an instance mask raster, 0/255, and
    polygons with per-instance stability and score: the SamGeo2 outputs).
    Without ``segment_fn`` the XUnet runs on ``device`` (default ``cuda``;
    raises without CUDA before the raster is read)."""
    from aerial_image_recognition_tpu_torch.pipeline.rasters import (
        mask_to_polygons)

    if segment_fn is None:
        from aerial_image_recognition_tpu_torch.runtime.device import (
            resolve_device)
        device = resolve_device(device)
    gt = src if isinstance(src, GeoTiff) else read_geotiff(src)
    probs = probability_map(gt, window=window, batch=batch, stride=stride,
                            segment_fn=segment_fn, params=params,
                            quantize=quantize, device=device)
    instances = extract_instances(probs, thresholds=thresholds,
                                  min_area_px=min_area_px,
                                  stability_min=stability_min)

    ids = np.zeros(probs.shape, np.int32)
    for inst in instances:
        ids[inst["mask_slice"]][inst["mask"]] = inst["id"]

    if output_mask:
        write_geotiff(output_mask, (ids > 0).astype(np.uint8) * 255,
                      gt.transform, gt.epsg)
    if output_polygons:
        feats = []
        for inst in instances:
            full = np.zeros(probs.shape, np.uint8)
            full[inst["mask_slice"]] = inst["mask"]
            for ring in mask_to_polygons(full):
                x, y = gt.pixel_to_geo(ring[:, 0], ring[:, 1])
                feats.append({
                    "type": "Feature",
                    "geometry": {"type": "Polygon",
                                 "coordinates": [np.stack([x, y], 1)
                                                 .tolist()]},
                    "properties": {"instance": inst["id"],
                                   "stability": inst["stability"],
                                   "score": inst["score"],
                                   "area_px": inst["area_px"]}})
        if output_polygons.endswith(".gpkg"):
            # the reference's SamGeo2 workflow vectorizes to GPKG
            from aerial_image_recognition_tpu_torch.gio.geopackage import (
                write_gpkg)
            write_gpkg(output_polygons, feats, layer="instances",
                       geometry_type="POLYGON", srs_id=gt.epsg or 4326)
        else:
            write_geojson({"type": "FeatureCollection", "features": feats,
                           "metadata": {"epsg": gt.epsg,
                                        "thresholds": list(thresholds)}},
                          output_polygons)
    return instances
