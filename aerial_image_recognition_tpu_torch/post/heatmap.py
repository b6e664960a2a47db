"""Hexagonal density heatmap from detection points.

A copy of ``aerial_image_recognition_tpu/post/heatmap.py``.

Parity slot for the reference's hex-heatmap product
(output/warsaw/hex_heatmap_output.gpkg ships in the reference repo as a
derived artifact; no generating code survives in the snapshot — this is the
reconstruction of that output). Detections are binned into a flat-top
hexagonal grid in the AOI's UTM frame; emitted as a GeoJSON polygon layer
with per-hex counts and mean confidence, QGIS-ready.
"""

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from aerial_image_recognition_tpu_torch.geo.tmerc import (
    tm_forward, tm_inverse, utm_params_for,
)


def _hex_center(q: int, r: int, size: float):
    """Axial (q, r) → center (x, y) for flat-top hexagons of circumradius
    ``size``."""
    x = size * 1.5 * q
    y = size * math.sqrt(3.0) * (r + 0.5 * (q & 1))
    return x, y


def _hex_of(x: float, y: float, size: float):
    """Nearest flat-top hex (odd-q offset coordinates) containing (x, y)."""
    q = int(round(x / (size * 1.5)))
    r = int(round(y / (size * math.sqrt(3.0)) - 0.5 * (q & 1)))
    # check the candidate and its neighbors, pick the closest center
    best, best_d = (q, r), float("inf")
    for dq in (-1, 0, 1):
        for dr in (-1, 0, 1):
            cx, cy = _hex_center(q + dq, r + dr, size)
            d = (cx - x) ** 2 + (cy - y) ** 2
            if d < best_d:
                best, best_d = (q + dq, r + dr), d
    return best


def hex_heatmap(records: Sequence[dict], hex_size_m: float = 50.0,
                output_geojson: Optional[str] = None) -> Dict:
    """Detection records → hex-density FeatureCollection.

    Each feature: hexagon polygon (WGS84) with properties
    {count, mean_confidence}.
    """
    feats: List[Dict] = []
    if records:
        lon = np.array([d["lon"] for d in records])
        lat = np.array([d["lat"] for d in records])
        conf = np.array([d.get("confidence", 1.0) for d in records])
        p, epsg = utm_params_for(float(lon[0]), float(lat[0]))
        x, y = tm_forward(lon, lat, p)
        x0, y0 = float(np.min(x)), float(np.min(y))

        bins: Dict[tuple, List[int]] = {}
        for i in range(len(records)):
            key = _hex_of(float(x[i]) - x0, float(y[i]) - y0, hex_size_m)
            bins.setdefault(key, []).append(i)

        for (q, r), idxs in sorted(bins.items()):
            cx, cy = _hex_center(q, r, hex_size_m)
            corners = [(cx + hex_size_m * math.cos(a),
                        cy + hex_size_m * math.sin(a))
                       for a in (k * math.pi / 3.0 for k in range(6))]
            corners.append(corners[0])
            ring = []
            for hx, hy in corners:
                glon, glat = tm_inverse(hx + x0, hy + y0, p)
                ring.append([float(glon), float(glat)])
            feats.append({
                "type": "Feature",
                "geometry": {"type": "Polygon", "coordinates": [ring]},
                "properties": {
                    "count": len(idxs),
                    "mean_confidence": round(float(conf[idxs].mean()), 4),
                },
            })
    fc = {"type": "FeatureCollection", "features": feats,
          "metadata": {"hex_size_m": hex_size_m, "points": len(records)}}
    if output_geojson:
        if output_geojson.endswith(".gpkg"):
            # the reference ships this artifact as a GeoPackage
            # (output/warsaw/hex_heatmap_output.gpkg) — same layer name
            from aerial_image_recognition_tpu_torch.gio.geopackage import (
                write_gpkg)
            write_gpkg(output_geojson, fc["features"],
                       layer="hex_heatmap_output",
                       geometry_type="POLYGON")
        else:
            from aerial_image_recognition_tpu_torch.gio.geojson import (
                write_geojson)
            write_geojson(fc, output_geojson)
    return fc
