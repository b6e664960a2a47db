"""AOI stripe sharding + halo-exchange dedup over the device mesh.

Counterpart of ``aerial_image_recognition_tpu/parallel/stripes.py``. A city
AOI is split into per-shard UTM stripes whose borders carry a halo ≥ the
dedup radius, so every car is fully seen by at least one shard
(``split_aoi_stripes``, ``assign_to_stripes``: numpy copies of the
reference's, bit-equal). Each shard dedups on its own device; the
reference's ring exchange (``lax.ppermute`` to both neighbours) becomes
cross-device copies inside the process: shard k gathers the raw slot sets
of shards k−1 and k+1 onto its device and runs one greedy scan
(``post/dedup.dedup_device``) over the combined 3K slots.

Tie-break: global slot ids (shard·K + slot) travel with the detections, so
an exact-confidence tie across a border resolves to the lowest id on every
shard and keeps one survivor. With one shard the ring's neighbours are the
shard itself, as in the reference.
"""

from typing import Tuple

import numpy as np
import torch

from aerial_image_recognition_tpu_torch.geo.tmerc import (
    tm_forward, tm_inverse, utm_epsg, utm_extent, utm_params)
from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh
from aerial_image_recognition_tpu_torch.post.dedup import dedup_device


def split_aoi_stripes(bounds, n_shards: int, halo_m: float = 64.0):
    """WGS84 AOI bounds → per-shard WGS84 stripe bounds (vertical stripes in
    the AOI's UTM frame), each widened by halo_m on interior borders.

    Returns (stripes [n,4] WGS84, utm_params, (x0, x1) stripe edges in UTM).
    Each host/shard fetches only its stripe's tiles — mirrors the
    per-server queue sharding idea of the reference's mt0-mt3 round-robin
    (simple_detector.py:176-179) lifted to AOI space.
    """
    minx, miny, maxx, maxy = bounds
    epsg = utm_epsg((minx + maxx) / 2, (miny + maxy) / 2)
    p = utm_params(epsg % 100, south=epsg >= 32700)
    # full covering UTM extent (meridian convergence — see
    # geo.tmerc.utm_extent; two corners would under-cover)
    ux0, uy0, ux1, uy1 = utm_extent(bounds, p)
    edges = np.linspace(ux0, ux1, n_shards + 1)
    stripes = []
    for i in range(n_shards):
        x0 = edges[i] - (halo_m if i > 0 else 0.0)
        x1 = edges[i + 1] + (halo_m if i < n_shards - 1 else 0.0)
        # stripe rect in WGS84 from all four stripe corners, expanded
        # outward: constant-UTM-x boundaries tilt vs meridians, so taking
        # one corner per edge leaves unfetched slivers between stripes
        sx, sy = tm_inverse(np.array([x0, x0, x1, x1]),
                            np.array([uy0, uy1, uy0, uy1]), p)
        stripes.append((float(np.min(sx)), float(np.min(sy)),
                        float(np.max(sx)), float(np.max(sy))))
    return np.asarray(stripes), p, (edges[:-1], edges[1:])


def assign_to_stripes(x_utm: np.ndarray, edges: Tuple[np.ndarray, np.ndarray],
                      n_shards: int) -> np.ndarray:
    """Owner shard of each detection: by its UTM x against interior edges
    (halo duplicates get the same owner on every shard — dedup handles the
    rest)."""
    lo = np.asarray(edges[0])
    owner = np.clip(np.searchsorted(lo, x_utm, side="right") - 1,
                    0, n_shards - 1)
    return owner.astype(np.int32)


def make_halo_dedup(mesh: Mesh, *, k_slots: int, radius_m: float):
    """The sharded dedup: per-shard lists of [K] (x, y, conf) f32 tensors,
    each on its shard's device, in local UTM meters relative to an AOI
    anchor; −inf conf marks empty slots. Returns the per-shard lists
    (x, y, keep_conf) with suppressed slots at −inf, on the same devices.
    Work is queued shard by shard; nothing waits for the card."""
    n = mesh.local_size
    if mesh.process_count != 1:
        raise ValueError("the halo dedup runs over one process's devices; "
                         "merge across processes with "
                         "distributed.merge_host_detections")

    def run(xs, ys, cs):
        if not len(xs) == len(ys) == len(cs) == n:
            raise ValueError(f"expected {n} shards of (x, y, conf)")
        out_x, out_y, out_c = [], [], []
        for k, dev in enumerate(mesh.devices):
            left, right = (k - 1) % n, (k + 1) % n
            # the ring exchange: shift(+1) hands shard k−1's set to shard
            # k, shift(−1) shard k+1's
            cx = torch.cat([xs[k], xs[left].to(dev), xs[right].to(dev)])
            cy = torch.cat([ys[k], ys[left].to(dev), ys[right].to(dev)])
            cc = torch.cat([cs[k], cs[left].to(dev), cs[right].to(dev)])
            slots = torch.arange(k_slots, dtype=torch.int32, device=dev)
            cid = torch.cat([k * k_slots + slots, left * k_slots + slots,
                             right * k_slots + slots])
            idx, kconf, _ = dedup_device(cx, cy, cc, radius_m, 3 * k_slots,
                                         tie_id=cid)
            picked = torch.isfinite(kconf) & (kconf > float("-inf"))
            keep = torch.zeros(3 * k_slots, dtype=torch.bool, device=dev)
            keep[idx[picked]] = True
            own_keep = keep[:k_slots] & torch.isfinite(cs[k])
            out_x.append(xs[k])
            out_y.append(ys[k])
            out_c.append(torch.where(own_keep, cs[k], float("-inf")))
        return out_x, out_y, out_c

    return run


def halo_dedup_host(lon: np.ndarray, lat: np.ndarray, conf: np.ndarray,
                    bounds, mesh: Mesh, *, radius_m: float,
                    k_slots: int = 4096):
    """Host wrapper: WGS84 detections → sharded halo dedup → the kept set
    (lon, lat, conf) as numpy (order not preserved)."""
    n_shards = mesh.local_size
    stripes, p, edges = split_aoi_stripes(bounds, n_shards, halo_m=radius_m)
    x, y = tm_forward(np.asarray(lon, np.float64),
                      np.asarray(lat, np.float64), p)
    anchor = (float(np.min(x)) if len(x) else 0.0,
              float(np.min(y)) if len(y) else 0.0)
    owner = assign_to_stripes(np.asarray(x), edges, n_shards)

    # pack per-shard fixed slots (empty slots parked far away so the
    # distance gate can never couple them to real detections)
    xs = np.full((n_shards, k_slots), 1e9, np.float32)
    ys = np.full((n_shards, k_slots), 1e9, np.float32)
    cs = np.full((n_shards, k_slots), -np.inf, np.float32)
    fill = np.zeros(n_shards, np.int64)
    dropped = 0
    for i in range(len(lon)):
        s = owner[i]
        if fill[s] >= k_slots:
            dropped += 1
            continue
        xs[s, fill[s]] = x[i] - anchor[0]
        ys[s, fill[s]] = y[i] - anchor[1]
        cs[s, fill[s]] = conf[i]
        fill[s] += 1
    if dropped:
        raise ValueError(f"k_slots={k_slots} too small: {dropped} dropped")

    fn = make_halo_dedup(mesh, k_slots=k_slots, radius_m=radius_m)
    kx, ky, kconf = fn(*([torch.from_numpy(a[k]).to(d)
                          for k, d in enumerate(mesh.devices)]
                         for a in (xs, ys, cs)))
    kx = np.concatenate([t.cpu().numpy() for t in kx])
    ky = np.concatenate([t.cpu().numpy() for t in ky])
    kconf = np.concatenate([t.cpu().numpy() for t in kconf])
    keep = np.isfinite(kconf)
    klon, klat = tm_inverse(kx[keep].astype(np.float64) + anchor[0],
                            ky[keep].astype(np.float64) + anchor[1], p)
    return klon, klat, kconf[keep]
