"""Web-Mercator (EPSG:3857) and slippy-map (XYZ) tile math.

A copy of ``aerial_image_recognition_tpu/geo/webmercator.py``. Replaces
mercantile (used by the reference at simple_detector.py:342-348,
_script/xyz_handler.py throughout). All functions are vectorized over numpy
arrays (``xp=numpy``; the port has no ``jax.numpy``).
"""

import math

import numpy as np

# Matches the constant the reference hardcodes at simple_detector.py:34.
EARTH_CIRCUMFERENCE = 40075016.686
_R = 6378137.0  # WGS84 semi-major axis (spherical web-mercator radius)
_MAX_LAT = 85.051128779806604  # atan(sinh(pi)) in degrees


def meters_per_pixel(zoom: int, lat=None, tile_px: int = 256, xp=np):
    """Ground meters per pixel at a zoom level (equator unless lat given).

    Mirrors simple_detector.py:34-35 (equatorial) and its per-point
    cos(lat) correction at simple_detector.py:328.
    """
    mpp = EARTH_CIRCUMFERENCE / (2 ** zoom) / tile_px
    if lat is None:
        return mpp
    return mpp * xp.cos(xp.radians(lat))


def lonlat_to_webmercator(lon, lat, xp=np):
    """EPSG:4326 → EPSG:3857 meters."""
    lon = xp.asarray(lon, dtype=xp.float64) if xp is np else xp.asarray(lon)
    x = _R * xp.radians(lon)
    phi = xp.radians(xp.asarray(lat))
    y = _R * xp.arcsinh(xp.tan(phi))
    return x, y


def webmercator_to_lonlat(x, y, xp=np):
    """EPSG:3857 meters → EPSG:4326 degrees."""
    lon = xp.degrees(xp.asarray(x) / _R)
    lat = xp.degrees(xp.arctan(xp.sinh(xp.asarray(y) / _R)))
    return lon, lat


def tile_xy(lon, lat, zoom: int, xp=np):
    """Slippy tile (x, y) containing (lon, lat) at zoom.

    Equivalent to mercantile.tile (reference simple_detector.py:342-343).
    Returns integer arrays.
    """
    lat = xp.clip(xp.asarray(lat), -_MAX_LAT, _MAX_LAT)
    lon = xp.asarray(lon)
    n = 2 ** zoom
    xf = (lon + 180.0) / 360.0 * n
    phi = xp.radians(lat)
    yf = (1.0 - xp.arcsinh(xp.tan(phi)) / math.pi) / 2.0 * n
    # Clamp like mercantile does at the antimeridian/pole edges.
    x = xp.clip(xp.floor(xf), 0, n - 1).astype(xp.int64 if xp is np else xp.int32)
    y = xp.clip(xp.floor(yf), 0, n - 1).astype(xp.int64 if xp is np else xp.int32)
    return x, y


def tile_ul(x, y, zoom: int, xp=np):
    """Upper-left (lon, lat) corner of slippy tile (x, y, zoom)."""
    n = 2 ** zoom
    lon = xp.asarray(x) / n * 360.0 - 180.0
    lat = xp.degrees(xp.arctan(xp.sinh(math.pi * (1.0 - 2.0 * xp.asarray(y) / n))))
    return lon, lat


def tile_bounds(x, y, zoom: int, xp=np):
    """(west, south, east, north) degrees of a slippy tile.

    Equivalent to mercantile.bounds (reference simple_detector.py:412-416).
    """
    west, north = tile_ul(x, y, zoom, xp=xp)
    east, south = tile_ul(xp.asarray(x) + 1, xp.asarray(y) + 1, zoom, xp=xp)
    return west, south, east, north
