"""XYZ (slippy-map) tile fetcher — mosaic → metric center-crop tiles.

A copy of ``aerial_image_recognition_tpu/fetch/xyz.py``.

Functional equivalent of the reference's two XYZ paths:
  * modular XYZHandler (_script/xyz_handler.py): zoom 21, 4×4×256 px mosaic
    → 864 px center crop ≈ 64 m, LANCZOS to 640
  * monolith get_image (simple_detector.py:326-453): arbitrary tile-range
    mosaic around a (lat, lon) center with per-latitude pixel math, LRU
    cache, {s} server sharding over mt0-mt3

Differences by design (accelerator-first): the fetcher returns *uint8
mosaics + geographic bounds*; crop/resize/normalize happen on the device
(ops.preprocess.preprocess_batch), so the host never runs PIL resizes in the
hot path.
"""

import concurrent.futures as cf
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from aerial_image_recognition_tpu_torch.fetch.cache import TileCache
from aerial_image_recognition_tpu_torch.fetch.http import TileHTTP
from aerial_image_recognition_tpu_torch.geo.webmercator import meters_per_pixel, tile_xy


@dataclass
class TileImage:
    """One model-ready tile: uint8 pixels + the geo bounds of those pixels."""
    pixels: np.ndarray               # [S, S, 3] uint8
    bounds: Tuple[float, float, float, float]   # (west, south, east, north)
    meta: Optional[Dict] = None


class XYZFetcher:
    def __init__(self, url_template: str, *, zoom: int = 21,
                 tile_px: int = 256, target_size_m: float = 64.0,
                 num_workers: int = 25, cache_size: int = 10000,
                 timeout: float = 10.0, retries: int = 5,
                 subdomains: Sequence[str] = ("0", "1", "2", "3")):
        self.url_template = url_template
        self.zoom = zoom
        self.tile_px = tile_px
        self.target_size_m = target_size_m
        self.num_workers = num_workers
        self.http = TileHTTP(timeout=timeout, retries=retries)
        self.cache = TileCache(cache_size)
        self.subdomains = list(subdomains) or [""]
        self._sub_idx = 0
        self._sub_lock = threading.Lock()
        # Two pools: image-level tasks must never share a pool with the
        # tile GETs they wait on (self-deadlock when the outer tasks occupy
        # every worker).
        self._pool = cf.ThreadPoolExecutor(max_workers=num_workers,
                                           thread_name_prefix="xyz-tile")
        self._img_pool = cf.ThreadPoolExecutor(
            max_workers=max(2, num_workers // 4),
            thread_name_prefix="xyz-img")

    # ------------------------------------------------------------ tiles

    def _tile_url(self, x: int, y: int, z: int) -> str:
        with self._sub_lock:
            s = self.subdomains[self._sub_idx % len(self.subdomains)]
            self._sub_idx += 1
        return self.url_template.format(s=s, x=x, y=y, z=z)

    def _fetch_tile(self, x: int, y: int, z: int) -> Optional[np.ndarray]:
        key = (x, y, z)
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        body = self.http.get(self._tile_url(x, y, z))
        if body is None:
            return None
        arr = self.http.decode(body)    # native libjpeg path, PIL fallback
        if arr is None:
            self.http.failures.add(self._tile_url(x, y, z), "DecodeError", 0)
            return None
        self.cache.put(key, arr)
        return arr

    # ---------------------------------------------------------- mosaics

    def window_px(self, lat: float,
                  target_size_m: Optional[float] = None) -> int:
        """Pixels covering target_size_m ground at this zoom and latitude
        (per-latitude mpp, simple_detector.py:327-329 semantics)."""
        size_m = target_size_m or self.target_size_m
        mpp = meters_per_pixel(self.zoom, lat=lat, xp=np)
        return int(size_m / float(mpp))

    def get_image(self, lat: float, lon: float,
                  target_size_m: Optional[float] = None,
                  window_px: Optional[int] = None) -> Optional[TileImage]:
        """Mosaic the slippy tiles around (lat, lon) and extract the pixel
        window covering a target_size_m square (monolith get_image
        semantics, simple_detector.py:326-453).

        window_px pins the window to a fixed pixel size (static shapes for
        the batched device path); the returned ``bounds`` are the *exact*
        geographic bounds of the returned pixels, computed in Mercator space
        where slippy pixels are linear — so georeferencing stays exact even
        when the window is pinned.
        """
        size_m = target_size_m or self.target_size_m
        pixels_needed = window_px or self.window_px(lat, size_m)

        m2lon = 1.0 / (111319.9 * math.cos(math.radians(lat)))
        m2lat = 1.0 / 111319.9
        half = size_m / 2.0
        west, east = lon - half * m2lon, lon + half * m2lon
        south, north = lat - half * m2lat, lat + half * m2lat

        nwx, nwy = tile_xy(west, north, self.zoom)
        sex, sey = tile_xy(east, south, self.zoom)
        min_x, max_x = int(min(nwx, sex)) - 1, int(max(nwx, sex)) + 1
        min_y, max_y = int(min(nwy, sey)) - 1, int(max(nwy, sey)) + 1

        coords = [(x, y) for y in range(min_y, max_y + 1)
                  for x in range(min_x, max_x + 1)]
        futures = {c: self._pool.submit(self._fetch_tile, c[0], c[1], self.zoom)
                   for c in coords}
        t = self.tile_px
        gw, gh = max_x - min_x + 1, max_y - min_y + 1
        mosaic = np.zeros((gh * t, gw * t, 3), dtype=np.uint8)
        ok = 0
        for (x, y), fut in futures.items():
            arr = fut.result()
            if arr is not None and arr.shape[:2] == (t, t):
                mosaic[(y - min_y) * t:(y - min_y + 1) * t,
                       (x - min_x) * t:(x - min_x + 1) * t] = arr
                ok += 1
        if ok == 0:
            return None

        # Pixel ↔ geography mapping, exact in slippy space: 2^z·256 pixels
        # span the world both in x and in Mercator y.
        n_world = (2 ** self.zoom) * t
        px_per_deg = n_world / 360.0

        def lat_to_py(la):
            return (1.0 - math.asinh(math.tan(math.radians(la))) / math.pi) \
                / 2.0 * n_world

        def py_to_lat(py):
            return math.degrees(math.atan(math.sinh(
                math.pi * (1.0 - 2.0 * py / n_world))))

        origin_px = min_x * t                 # world pixel x of mosaic left
        origin_py = min_y * t                 # world pixel y of mosaic top
        left = int(round((west + 180.0) * px_per_deg - origin_px))
        top = int(round(lat_to_py(north) - origin_py))
        left = max(0, min(left, mosaic.shape[1] - pixels_needed))
        top = max(0, min(top, mosaic.shape[0] - pixels_needed))
        window = mosaic[top:top + pixels_needed, left:left + pixels_needed]

        # Exact bounds of the returned pixels
        w_exact = (origin_px + left) / px_per_deg - 180.0
        e_exact = (origin_px + left + pixels_needed) / px_per_deg - 180.0
        n_exact = py_to_lat(origin_py + top)
        s_exact = py_to_lat(origin_py + top + pixels_needed)
        mpp = meters_per_pixel(self.zoom, lat=lat, xp=np)
        return TileImage(
            pixels=np.ascontiguousarray(window),
            bounds=(w_exact, s_exact, e_exact, n_exact),
            meta={"zoom": self.zoom,
                  "tiles_total": len(coords), "tiles_ok": ok,
                  "meters_per_pixel": float(mpp),
                  "crop_size": pixels_needed})

    def fetch_batch(self, bboxes: Sequence[Tuple[float, float, float, float]],
                    progress=None, window_px: Optional[int] = None
                    ) -> List[Optional[TileImage]]:
        """WGS84 tile bboxes → tile images (modular fetch_batch signature,
        _script/xyz_handler.py:228-248: center computed from the bbox)."""
        def one(bbox):
            lon_c = (bbox[0] + bbox[2]) / 2
            lat_c = (bbox[1] + bbox[3]) / 2
            out = self.get_image(lat_c, lon_c, window_px=window_px)
            if progress is not None:
                progress.update(1)
            return out
        futures = [self._img_pool.submit(one, b) for b in bboxes]
        return [f.result() for f in futures]

    def save_preview(self, tile: TileImage, path: str) -> None:
        """Write a tile-boundary preview GeoJSON (the monolith's
        preview_tile.geojson emission, xyz_handler.py:117-146)."""
        import json
        import os
        w, s, e, n = tile.bounds
        doc = {"type": "FeatureCollection", "features": [{
            "type": "Feature",
            "geometry": {"type": "Polygon", "coordinates": [[
                [w, s], [e, s], [e, n], [w, n], [w, s]]]},
            "properties": dict(tile.meta or {}, type="tile_boundary",
                               bbox=[w, s, e, n]),
        }]}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, default=float)

    def close(self):
        self._img_pool.shutdown(wait=False, cancel_futures=True)
        self._pool.shutdown(wait=False, cancel_futures=True)
        self.http.close()
