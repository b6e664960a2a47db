"""Tile renderers of the traffic: numpy and PIL only, so that the WMS
server's processes import neither torch nor the program.

``render_tiles`` is a copy of ``chip_smoke.render_tiles``
(chip_smoke.py:391): synthetic aerial tiles at the trained fixture's scale
(0.5 m/px), the asphalt texture and bright 4.5 x 2 m cars of its training
world. ``World`` is a copy of the car part of the port's
``fetch/fake.FakeWorld.render`` (aerial_image_recognition_tpu_torch/
fetch/fake.py:128): its pixels are a function of geography, not of the
request, so overlapping tiles agree and a car seen by two tiles is a real
duplicate.
"""

import io
import math

import numpy as np
from PIL import Image

M_PER_DEG = 111319.9


def render_tiles(rng, n: int, size: int, px_per_m: float = 2.0,
                 cars=(10, 25)):
    """n tiles [n,size,size,3] uint8 side by side along 52.2 N from 21 E,
    with bounds [n,4] (w, s, e, n) f64 and ``rng.integers(*cars)`` cars
    each, kept 8 px apart."""
    lat0 = 52.2
    m2lon = 1.0 / (M_PER_DEG * math.cos(math.radians(lat0)))
    m2lat = 1.0 / M_PER_DEG
    span = size / px_per_m
    tiles, bounds = [], []
    for t in range(n):
        west = 21.0 + t * span * m2lon
        south = lat0
        east, north = west + span * m2lon, south + span * m2lat
        xs = np.linspace(west, east, size, endpoint=False)
        ys = np.linspace(north, south, size, endpoint=False)
        lon_g, lat_g = np.meshgrid(xs, ys)
        tex = np.sin(lon_g * 201000.0) * np.cos(lat_g * 173000.0) * 0.5 + 0.5
        img = (90 + 40 * tex).astype(np.uint8)
        img = np.stack([img, img, img + 8], axis=-1).astype(np.uint8)
        for _ in range(int(rng.integers(*cars))):
            cx = rng.uniform(5.0, span - 5.0)
            cy = rng.uniform(5.0, span - 5.0)
            x1, x2 = int((cx - 2.25) * px_per_m), int((cx + 2.25) * px_per_m)
            y1, y2 = int((cy - 1.0) * px_per_m), int((cy + 1.0) * px_per_m)
            if (img[y1 - 8:y2 + 8, x1 - 8:x2 + 8] > 200).any():
                continue
            img[y1:y2, x1:x2] = (230, 235, 240)
        tiles.append(img)
        bounds.append((west, south, east, north))
    return np.stack(tiles), np.asarray(bounds, np.float64)


class World:
    """Cars at seeded positions over a square of ``extent_m`` metres centred
    on (lon0, lat0), ``cars_per_km2`` of them, each 4.5 x 2 m."""

    def __init__(self, seed: int, lon0: float, lat0: float, extent_m: float,
                 cars_per_km2: float):
        rng = np.random.default_rng(seed)
        n = int(round(cars_per_km2 * (extent_m / 1000.0) ** 2))
        m2lon = 1.0 / (M_PER_DEG * math.cos(math.radians(lat0)))
        self.lon = lon0 + (rng.random(n) - 0.5) * extent_m * m2lon
        self.lat = lat0 + (rng.random(n) - 0.5) * extent_m / M_PER_DEG

    def render(self, bbox, width: int, height: int) -> np.ndarray:
        west, south, east, north = bbox
        xs = np.linspace(west, east, width, endpoint=False)
        ys = np.linspace(north, south, height, endpoint=False)
        lon_g, lat_g = np.meshgrid(xs, ys)
        t = np.sin(lon_g * 201000.0) * np.cos(lat_g * 173000.0) * 0.5 + 0.5
        img = (90 + 40 * t).astype(np.uint8)
        img = np.stack([img, img, img + 8], axis=-1).astype(np.uint8)
        m2lon = 1.0 / (M_PER_DEG * math.cos(math.radians((south + north) / 2)))
        m2lat = 1.0 / M_PER_DEG
        ppd_x = width / (east - west)
        ppd_y = height / (north - south)
        dx, dy = 2.25 * m2lon, 1.0 * m2lat
        near = np.where((self.lon >= west - 1e-4) & (self.lon <= east + 1e-4)
                        & (self.lat >= south - 1e-4)
                        & (self.lat <= north + 1e-4))[0]
        for lon, lat in zip(self.lon[near], self.lat[near]):
            x1 = max(int((lon - dx - west) * ppd_x), 0)
            x2 = min(int((lon + dx - west) * ppd_x), width)
            y1 = max(int((north - (lat + dy)) * ppd_y), 0)
            y2 = min(int((north - (lat - dy)) * ppd_y), height)
            if x2 > x1 and y2 > y1:
                img[y1:y2, x1:x2] = (230, 235, 240)
        return img


def jpeg(img: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()
