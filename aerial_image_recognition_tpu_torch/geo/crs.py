"""Minimal CRS registry + point transforms between the CRSs this pipeline uses.

A copy of ``aerial_image_recognition_tpu/geo/crs.py``.

The reference leans on pyproj Transformers for EPSG:4326 ↔ UTM ↔ 2180 ↔ 3857
(e.g. _script/utils.py:36-41, _script/test_coordinates.py:3-39). Here each
transform is a closed-form vectorized function; everything routes through
lon/lat (EPSG:4326) as the hub.
"""

from typing import Union

import numpy as np

from aerial_image_recognition_tpu_torch.geo.tmerc import (
    TMParams, EPSG_2180, tm_forward, tm_inverse, utm_params,
)
from aerial_image_recognition_tpu_torch.geo.webmercator import (
    lonlat_to_webmercator, webmercator_to_lonlat,
)

CRSLike = Union[int, str, TMParams]


def crs_params(crs: CRSLike):
    """Normalize an EPSG int / 'EPSG:xxxx' string / TMParams to a key."""
    if isinstance(crs, TMParams):
        return crs
    if isinstance(crs, str):
        crs = int(crs.upper().replace("EPSG:", ""))
    if crs == 2180:
        return EPSG_2180
    if 32601 <= crs <= 32660:
        return utm_params(crs - 32600, south=False)
    if 32701 <= crs <= 32760:
        return utm_params(crs - 32700, south=True)
    if crs in (4326, 3857):
        return crs
    raise ValueError(f"Unsupported CRS: EPSG:{crs}")


def _to_lonlat(x, y, crs, xp):
    p = crs_params(crs)
    if p == 4326:
        return x, y
    if p == 3857:
        return webmercator_to_lonlat(x, y, xp=xp)
    return tm_inverse(x, y, p, xp=xp)


def _from_lonlat(lon, lat, crs, xp):
    p = crs_params(crs)
    if p == 4326:
        return lon, lat
    if p == 3857:
        return lonlat_to_webmercator(lon, lat, xp=xp)
    return tm_forward(lon, lat, p, xp=xp)


def transform_points(x, y, src: CRSLike, dst: CRSLike, xp=np):
    """Transform coordinate arrays between CRSs (always_xy order)."""
    lon, lat = _to_lonlat(x, y, src, xp)
    return _from_lonlat(lon, lat, dst, xp)
