"""Cross-tile detection dedup: confidence-greedy metric radius suppression.

A copy of the host half of ``aerial_image_recognition_tpu/post/dedup.py``
(``dedup_device``, the fixed-slot device scan whose only caller is the
striped multi-chip scan, arrives with the multi-GPU slice).

Semantics match the reference's R-tree NMS exactly
(simple_detector.py:540-596 and _script/utils.py:212-274): project to the
AOI's UTM zone, sort by confidence descending, keep a detection iff no
already-kept detection lies within ``radius_m`` meters.

``dedup_host`` is exact and grid-bucketed (uniform hash grid of cell size =
radius; only the 3×3 neighborhood is scanned): O(n·k) instead of the
reference's O(n log n) rtree with python-loop constants. It runs the native
fastgeo grid kernel (``utils/native.py``) where that builds, and the numpy
loop otherwise; the two give the same mask.
"""

from typing import Dict, List, Tuple

import numpy as np

from aerial_image_recognition_tpu_torch.geo.tmerc import tm_forward, utm_params_for


def _to_utm(lon: np.ndarray, lat: np.ndarray):
    p, _ = utm_params_for(float(lon[0]), float(lat[0]))
    x, y = tm_forward(lon, lat, p)
    return np.asarray(x), np.asarray(y)


def dedup_host(lon: np.ndarray, lat: np.ndarray, conf: np.ndarray,
               radius_m: float, use_native: bool = True) -> np.ndarray:
    """Returns a boolean keep-mask over the input order.

    UTM zone selected from the first detection (same rule as
    simple_detector.py:545-549). Uses the C++ fastgeo grid kernel when
    available (city-scale path: millions of points), numpy/python otherwise.
    """
    n = len(lon)
    if n == 0 or radius_m <= 0:
        return np.ones(n, dtype=bool)
    x, y = _to_utm(np.asarray(lon, np.float64), np.asarray(lat, np.float64))
    conf = np.asarray(conf)

    if use_native:
        from aerial_image_recognition_tpu_torch.utils.native import dedup_grid_native
        keep = dedup_grid_native(x, y, conf.astype(np.float32), radius_m)
        if keep is not None:
            return keep

    order = np.argsort(-conf, kind="stable")   # confidence desc, stable ties
    inv_cell = 1.0 / radius_m
    r2 = radius_m * radius_m
    # Uniform grid hash: kept points bucketed by cell; candidates only in 3×3.
    grid: Dict[Tuple[int, int], List[int]] = {}
    keep = np.zeros(n, dtype=bool)
    xs, ys = x[order], y[order]
    cxs = np.floor(xs * inv_cell).astype(np.int64)
    cys = np.floor(ys * inv_cell).astype(np.int64)
    for i in range(len(order)):
        cx, cy = int(cxs[i]), int(cys[i])
        xi, yi = xs[i], ys[i]
        suppressed = False
        for nx in (cx - 1, cx, cx + 1):
            for ny in (cy - 1, cy, cy + 1):
                for j in grid.get((nx, ny), ()):
                    dx = xi - xs[j]
                    dy = yi - ys[j]
                    if dx * dx + dy * dy <= r2:
                        suppressed = True
                        break
                if suppressed:
                    break
            if suppressed:
                break
        if not suppressed:
            keep[order[i]] = True
            grid.setdefault((cx, cy), []).append(i)
    return keep


def dedup_records(records: List[dict], radius_m: float) -> List[dict]:
    """Reference-shape API: list of {'lon','lat','confidence',...} dicts →
    deduplicated list (simple_detector.py:540 signature)."""
    if not records or radius_m <= 0:
        return list(records)
    lon = np.array([r["lon"] for r in records])
    lat = np.array([r["lat"] for r in records])
    conf = np.array([r["confidence"] for r in records])
    keep = dedup_host(lon, lat, conf, radius_m)
    return [r for r, k in zip(records, keep) if k]


def nms_geographic(detections: List[dict],
                   distance_threshold: float = 2.0) -> List[dict]:
    """Standalone geographic NMS — API parity with the reference's
    nms_geographic (car_detection_on_wms.py:49-75 / xyz_handler.py:250-273),
    minus its hardcoded UTM 32611: the zone follows the data."""
    return dedup_records(detections, distance_threshold)
