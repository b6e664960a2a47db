"""The comparison that decides ``correct``.

Each side's answer for a tile (or, in a scan, for a region: the grid tile
whose centre is nearest) is a set of detections: lon, lat, confidence,
class, and, where the answer carries boxes, the box's width and height in
metres. The reference is computed at a lower confidence floor than the
program's threshold, so that a detection just above the threshold on one
side finds its counterpart just below it on the other.

Two detections of one class are counterparts when their boxes overlap at
IoU >= ``match_iou`` (answers with boxes) or their centres lie within
``match_m`` metres (a scan's records, which carry none).

* A program detection is *unsupported* when no reference detection at or
  above ``floor`` is its counterpart; a reference detection at or above
  ``clear`` is *missed* when no program detection is its counterpart.
* ``miss_share.worst``: over the tiles (regions) compared, the largest
  (unsupported + missed) / (program detections + clear reference ones).
  A tile left out, altered or misplaced reads 1.
* ``score_gap.mean``, ``.median``, ``.p99``: over every supported program
  detection, |its confidence - its best counterpart's|.
* ``offset_m.mean``, ``.median``, ``.max``: the distance between their
  centres.
* ``tiles.lost``: tiles due in the window that never came back, or came
  back twice.

The cell's check file (``checks/<cell>.json``) names the numbers held to a
limit and the limits; the others are printed beside them.
"""

import math

import numpy as np

M_PER_DEG = 111319.9


class Dets:
    """One tile's detections as arrays (w_m, h_m empty without boxes)."""

    def __init__(self, lon, lat, conf, cls, w_m=(), h_m=()):
        self.lon = np.asarray(lon, np.float64)
        self.lat = np.asarray(lat, np.float64)
        self.conf = np.asarray(conf, np.float64)
        self.cls = np.asarray(cls)
        self.w = np.asarray(w_m, np.float64)
        self.h = np.asarray(h_m, np.float64)

    def __len__(self):
        return len(self.lon)

    def take(self, mask):
        boxed = len(self.w) == len(self)
        return Dets(self.lon[mask], self.lat[mask], self.conf[mask],
                    self.cls[mask], self.w[mask] if boxed else (),
                    self.h[mask] if boxed else ())


def _metres(a: Dets, lat0: float):
    kx = M_PER_DEG * math.cos(math.radians(lat0))
    return a.lon * kx, a.lat * M_PER_DEG


def affinity(a: Dets, b: Dets, match_iou: float, match_m: float):
    """([len(a), len(b)] score, higher is closer, with -inf where the two
    are not counterparts; [len(a), len(b)] centre distances in metres)."""
    lat0 = float(np.concatenate([a.lat, b.lat]).mean())
    ax, ay = _metres(a, lat0)
    bx, by = _metres(b, lat0)
    dx = ax[:, None] - bx[None, :]
    dy = ay[:, None] - by[None, :]
    dist = np.hypot(dx, dy)
    if len(a.w) == len(a) and len(b.w) == len(b):
        iw = np.clip((a.w[:, None] + b.w[None, :]) / 2 - np.abs(dx), 0, None)
        ih = np.clip((a.h[:, None] + b.h[None, :]) / 2 - np.abs(dy), 0, None)
        inter = np.minimum(iw, np.minimum(a.w[:, None], b.w[None, :])) \
            * np.minimum(ih, np.minimum(a.h[:, None], b.h[None, :]))
        union = (a.w * a.h)[:, None] + (b.w * b.h)[None, :] - inter
        score = inter / np.maximum(union, 1e-12)
        score[score < match_iou] = -np.inf
    else:
        score = -dist
        score[dist > match_m] = -np.inf
    score[a.cls[:, None] != b.cls[None, :]] = -np.inf
    return score, dist


def compare_tile(prog: Dets, ref: Dets, p: dict):
    """(miss share, score gaps, centre offsets) of one tile."""
    support = ref.take(ref.conf >= p["floor"])
    wanted = ref.take(ref.conf >= p["clear"])
    gaps, offsets = [], []
    unsupported = len(prog)
    if len(prog) and len(support):
        score, dist = affinity(prog, support, p["match_iou"], p["match_m"])
        ok = np.isfinite(score).any(1)
        unsupported = int((~ok).sum())
        best = np.argmax(score, 1)
        for i in np.nonzero(ok)[0]:
            gaps.append(abs(prog.conf[i] - support.conf[best[i]]))
            offsets.append(dist[i, best[i]])
    missed = len(wanted)
    if len(wanted) and len(prog):
        score, _ = affinity(wanted, prog, p["match_iou"], p["match_m"])
        missed = int((~np.isfinite(score).any(1)).sum())
    total = len(prog) + len(wanted)
    return ((unsupported + missed) / total if total else 0.0), gaps, offsets


def compare(prog: dict, ref: dict, lost: int, params: dict) -> dict:
    """prog, ref: {tile key: Dets} -> the numbers, over ref's keys."""
    worst, gaps, offsets = 0.0, [], []
    for key in ref:
        share, g, o = compare_tile(prog.get(key, Dets([], [], [], [])),
                                   ref[key], params)
        worst = max(worst, share)
        gaps += g
        offsets += o
    return {"miss_share.worst": worst,
            "score_gap.mean": float(np.mean(gaps)) if gaps else 0.0,
            "score_gap.median": float(np.median(gaps)) if gaps else 0.0,
            "score_gap.p99": float(np.quantile(gaps, 0.99)) if gaps else 0.0,
            "offset_m.mean": float(np.mean(offsets)) if offsets else 0.0,
            "offset_m.median": float(np.median(offsets)) if offsets else 0.0,
            "offset_m.max": float(np.max(offsets)) if offsets else 0.0,
            "tiles.lost": float(lost),
            "tiles.compared": len(ref),
            "detections.compared": len(gaps)}


def verdict(numbers: dict, limits: dict):
    """(correct, [[name, number, limit], ...]) over the limited numbers."""
    rows = [[name, numbers[name], limit] for name, limit in limits.items()]
    return all(n <= lim for _, n, lim in rows), rows
