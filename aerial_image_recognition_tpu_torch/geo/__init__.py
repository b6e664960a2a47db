"""Pure geodesy and tiling math.

A copy of ``aerial_image_recognition_tpu/geo/``: the same numpy code, so
grids, projections and CRS transforms are bit-identical between the two
packages (resume and the grid fingerprint depend on it). Everything here is
dependency-free (numpy only). This replaces what the reference delegated to
pyproj / mercantile (see SURVEY.md §2.2): closed-form Web-Mercator and
Karney-series transverse-Mercator/UTM implemented directly. The port has no
``jax.numpy``: the functions that take ``xp=`` take numpy there (or any
module with numpy's names).
"""

from aerial_image_recognition_tpu_torch.geo.ellipsoid import WGS84, GRS80
from aerial_image_recognition_tpu_torch.geo.tmerc import (
    TMParams,
    tm_forward,
    tm_inverse,
    utm_params,
    utm_epsg,
    utm_zone,
    EPSG_2180,
)
from aerial_image_recognition_tpu_torch.geo.webmercator import (
    lonlat_to_webmercator,
    webmercator_to_lonlat,
    tile_xy,
    tile_bounds,
    tile_ul,
    meters_per_pixel,
    EARTH_CIRCUMFERENCE,
)
from aerial_image_recognition_tpu_torch.geo.crs import transform_points, crs_params
from aerial_image_recognition_tpu_torch.geo.tiles import (
    generate_tiles,
    generate_point_grid,
    tile_grid_utm,
)
from aerial_image_recognition_tpu_torch.geo.polygon import (
    points_in_polygon,
    points_in_rings,
    ring_area,
    polygon_bounds,
)

__all__ = [
    "WGS84", "GRS80",
    "TMParams", "tm_forward", "tm_inverse", "utm_params", "utm_epsg",
    "utm_zone", "EPSG_2180",
    "lonlat_to_webmercator", "webmercator_to_lonlat", "tile_xy",
    "tile_bounds", "tile_ul", "meters_per_pixel", "EARTH_CIRCUMFERENCE",
    "transform_points", "crs_params",
    "generate_tiles", "generate_point_grid", "tile_grid_utm",
    "points_in_polygon", "points_in_rings", "ring_area", "polygon_bounds",
]
