"""Cross-tile detection dedup: confidence-greedy metric radius suppression.

Counterpart of ``aerial_image_recognition_tpu/post/dedup.py``: the host
half is a copy; ``dedup_device``, the fixed-slot greedy scan the striped
halo dedup runs on each shard's device (``parallel/stripes.py``), is plain
PyTorch, as the reference's is a ``lax.scan`` and not a Pallas kernel.

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
import torch

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


def dedup_device(x: torch.Tensor, y: torch.Tensor, conf: torch.Tensor,
                 radius_m: float, max_keep: int, tie_id=None):
    """Fixed-slot dedup on the tensors' device: local-meter coords [N] f32,
    conf [N] f32 (−inf for invalid slots) → (idx [max_keep] int64,
    keep_conf [max_keep] f32, valid mask).

    Greedy highest-confidence-first over ``max_keep`` rounds, as the
    reference's ``lax.scan``: each round picks the best available slot and
    suppresses every slot within ``radius_m`` of it (itself included).
    Ties go to the first maximum; with ``tie_id`` (int32 [N]) to the lowest
    id among the slots at the round's maximum, which the striped dedup
    needs so that every shard resolves an exact tie the same way. A round
    that finds only −inf returns conf −inf (index 0, or the lowest id, as
    the reference's). Distances are elementwise f32 with no matrix product,
    so TF32 cannot touch them. One round is a handful of small kernels: a
    Python loop over rounds, no host sync inside it.
    """
    r2 = radius_m * radius_m
    avail = conf
    big = None if tie_id is None else torch.full_like(tie_id, 2**31 - 1)
    idx, kept = [], []
    for _ in range(max_keep):
        c = avail.max()
        if tie_id is None:
            i = torch.argmax(avail)
        else:
            i = torch.argmin(torch.where(avail == c, tie_id, big))
        j = i.reshape(1)                  # index_select: no host sync
        d2 = (x - x.index_select(0, j)) ** 2 \
            + (y - y.index_select(0, j)) ** 2
        avail = torch.where(d2 <= r2, float("-inf"), avail)
        idx.append(i)
        kept.append(c)
    idx = torch.stack(idx) if idx else torch.zeros(0, dtype=torch.int64,
                                                   device=conf.device)
    kept = torch.stack(kept) if kept else conf.new_zeros(0)
    return idx, kept, torch.isfinite(kept) & (kept > float("-inf"))
