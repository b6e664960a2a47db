"""Vectorized polygon operations (replaces shapely/GEOS for the AOI mask).

A copy of ``aerial_image_recognition_tpu/geo/polygon.py``.

The reference uses shapely ``polygon.contains(Point)`` per grid point
(simple_detector.py:777-782) and geopandas containment. Here point-in-polygon
is a vectorized even-odd ray cast over all ring edges at once — O(P·E) numpy,
fine for city-scale grids (~1e5 points × ~1e3 edges), and trivially
sharded if ever needed.
"""

from typing import List, Sequence

import numpy as np


def ring_area(ring: np.ndarray) -> float:
    """Signed area of a ring [N,2] via the shoelace formula (CCW positive)."""
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def polygon_bounds(rings: Sequence[np.ndarray]):
    """(minx, miny, maxx, maxy) over all rings."""
    pts = np.concatenate([np.asarray(r, dtype=np.float64) for r in rings], axis=0)
    return (float(pts[:, 0].min()), float(pts[:, 1].min()),
            float(pts[:, 0].max()), float(pts[:, 1].max()))


def points_in_rings(points: np.ndarray, rings: Sequence[np.ndarray]) -> np.ndarray:
    """Even-odd containment of points [P,2] in a polygon given as rings.

    Holes are handled automatically by even-odd parity (a point inside an
    odd number of rings is inside the polygon). Points exactly on an edge
    may land on either side — matching shapely's `contains` only up to
    boundary cases, which the tile grid never hits in practice.
    """
    points = np.asarray(points, dtype=np.float64)
    inside = np.zeros(len(points), dtype=bool)
    px = points[:, 0][:, None]
    py = points[:, 1][:, None]
    for ring in rings:
        ring = np.asarray(ring, dtype=np.float64)
        if len(ring) >= 2 and np.allclose(ring[0], ring[-1]):
            ring = ring[:-1]
        x1, y1 = ring[:, 0][None, :], ring[:, 1][None, :]
        x2 = np.roll(ring[:, 0], -1)[None, :]
        y2 = np.roll(ring[:, 1], -1)[None, :]
        # Edge straddles the horizontal ray from the point
        cond = (y1 > py) != (y2 > py)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_int = x1 + (py - y1) * (x2 - x1) / (y2 - y1)
        crossings = cond & (px < x_int)
        inside ^= (np.sum(crossings, axis=1) % 2).astype(bool)
    return inside


def points_in_polygon(points: np.ndarray,
                      polygons: List[List[np.ndarray]]) -> np.ndarray:
    """Containment of points in a multi-polygon (list of ring-lists)."""
    result = np.zeros(len(points), dtype=bool)
    for rings in polygons:
        result |= points_in_rings(points, rings)
    return result
