"""The port's geo copies against the JAX package's, at tolerance 0.

The port keeps its own copy of ``geo/`` (the same numpy code), so tile
grids, UTM forward/inverse, Web-Mercator math, CRS transforms and polygon
containment must agree bit for bit on the same inputs: a scan's resume and
its grid fingerprint depend on ``generate_tiles`` giving the same grid.
Inputs come from seeds with numpy.
"""

import numpy as np
import pytest

from aerial_image_recognition_tpu import geo as J
from aerial_image_recognition_tpu.geo import tmerc as JT
from aerial_image_recognition_tpu_torch import geo as P
from aerial_image_recognition_tpu_torch.geo import tmerc as PT

AOIS = [
    (20.998, 52.198, 21.002, 52.202),        # the e2e tests' AOI
    (20.98, 52.18, 21.02, 52.22),            # the card scan's AOI
    (4.85, 52.33, 4.95, 52.40),              # Amsterdam
    (139.60, 35.60, 139.80, 35.75),          # Tokyo
    (-58.50, -34.70, -58.30, -34.55),        # southern hemisphere
    (17.95, 50.0, 18.05, 50.05),             # the zone 33/34 meridian
]


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bounds", AOIS)
@pytest.mark.parametrize("size_m,overlap", [(64.0, 0.2), (320.0, 0.25),
                                            (128.0, 0.1)])
def test_generate_tiles_bit_identical(bounds, size_m, overlap):
    got = P.generate_tiles(bounds, size_m, overlap)
    _equal(got, J.generate_tiles(bounds, size_m, overlap))
    assert len(got) > 0


def test_generate_tiles_small_tiles_bit_identical():
    """The trained yolov8n's 9.6 m tiles, over the e2e tests' AOI."""
    _equal(P.generate_tiles(AOIS[0], 9.6, 0.2),
           J.generate_tiles(AOIS[0], 9.6, 0.2))


@pytest.mark.parametrize("bounds", AOIS)
def test_tile_grid_utm_and_extent(bounds):
    xs, ys, params, epsg = P.tile_grid_utm(bounds, 64.0, 0.2)
    jxs, jys, jparams, jepsg = J.tile_grid_utm(bounds, 64.0, 0.2)
    _equal(xs, jxs)
    _equal(ys, jys)
    assert epsg == jepsg and params.lon0 == jparams.lon0 \
        and params.false_northing == jparams.false_northing


@pytest.mark.parametrize("zone,south", [(31, False), (34, False),
                                        (54, False), (21, True),
                                        (60, False)])
def test_utm_forward_inverse_bit_identical(zone, south):
    rng = np.random.default_rng(zone)
    lon0 = zone * 6 - 183
    lon = lon0 + rng.uniform(-3.5, 3.5, 500)
    lat = rng.uniform(-60, -1, 500) if south else rng.uniform(1, 70, 500)
    pp, jp = PT.utm_params(zone, south), JT.utm_params(zone, south)
    e, n = PT.tm_forward(lon, lat, pp)
    je, jn = JT.tm_forward(lon, lat, jp)
    _equal(e, je)
    _equal(n, jn)
    blon, blat = PT.tm_inverse(e, n, pp)
    jlon, jlat = JT.tm_inverse(je, jn, jp)
    _equal(blon, jlon)
    _equal(blat, jlat)
    np.testing.assert_allclose(blon, lon, atol=1e-9, rtol=0)


@pytest.mark.parametrize("src,dst", [(4326, 2180), (2180, 4326),
                                     (4326, 3857), (3857, 4326),
                                     (4326, 32634), (32634, 4326),
                                     ("EPSG:32734", 4326)])
def test_transform_points_bit_identical(src, dst):
    rng = np.random.default_rng(7)
    lon = rng.uniform(20.5, 21.5, 200)
    lat = rng.uniform(51.5, 52.5, 200)
    x, y = J.transform_points(lon, lat, 4326, src)
    got = P.transform_points(x, y, src, dst)
    want = J.transform_points(x, y, src, dst)
    _equal(got[0], want[0])
    _equal(got[1], want[1])
    with pytest.raises(ValueError, match="Unsupported CRS"):
        P.crs_params(27700)


def test_utm_selection_and_extent():
    for lon, lat in [(21.0, 52.2), (-58.4, -34.6), (179.9, 10.0),
                     (-180.0, 0.0), (18.0, 50.0)]:
        assert P.utm_epsg(lon, lat) == J.utm_epsg(lon, lat)
        assert P.utm_zone(lon) == J.utm_zone(lon)
        pp, pe = PT.utm_params_for(lon, lat)
        jp, je = JT.utm_params_for(lon, lat)
        assert pe == je and pp.lon0 == jp.lon0
    # a bbox across zone 34's central meridian (21°E): the extent adds the
    # meridian's intersections with the south and north edges
    for b in ((20.5, 50.0, 21.5, 50.5), (17.5, 50.0, 18.5, 50.5)):
        pp, _ = PT.utm_params_for(21.0, 50.2)
        jp, _ = JT.utm_params_for(21.0, 50.2)
        assert PT.utm_extent(b, pp) == JT.utm_extent(b, jp)


@pytest.mark.parametrize("zoom", [12, 17, 21])
def test_webmercator_bit_identical(zoom):
    rng = np.random.default_rng(zoom)
    lon = rng.uniform(-179, 179, 300)
    lat = rng.uniform(-84, 84, 300)
    for pf, jf in ((P.lonlat_to_webmercator, J.lonlat_to_webmercator),):
        for g, w in zip(pf(lon, lat), jf(lon, lat)):
            _equal(g, w)
    x, y = P.lonlat_to_webmercator(lon, lat)
    for g, w in zip(P.webmercator_to_lonlat(x, y),
                    J.webmercator_to_lonlat(x, y)):
        _equal(g, w)
    tx, ty = P.tile_xy(lon, lat, zoom)
    jx, jy = J.tile_xy(lon, lat, zoom)
    _equal(tx, jx)
    _equal(ty, jy)
    for g, w in zip(P.tile_bounds(tx, ty, zoom), J.tile_bounds(jx, jy, zoom)):
        _equal(g, w)
    _equal(P.meters_per_pixel(zoom, lat=lat), J.meters_per_pixel(zoom,
                                                                  lat=lat))
    assert P.EARTH_CIRCUMFERENCE == J.EARTH_CIRCUMFERENCE


def test_polygons_and_point_grid_bit_identical():
    rng = np.random.default_rng(3)
    outer = np.array([[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]], float)
    hole = np.array([[4, 4], [6, 4], [6, 6], [4, 6], [4, 4]], float)
    pts = rng.random((800, 2)) * 12 - 1
    _equal(P.points_in_rings(pts, [outer, hole]),
           J.points_in_rings(pts, [outer, hole]))
    polys = [[outer, hole], [outer + 20.0]]
    _equal(P.points_in_polygon(pts * 3, polys),
           J.points_in_polygon(pts * 3, polys))
    assert P.ring_area(outer) == J.ring_area(outer) == 100.0
    assert P.polygon_bounds([outer, hole]) == J.polygon_bounds([outer, hole])
    aoi = [[np.array([[20.99, 52.19], [21.01, 52.19], [21.0, 52.21],
                      [20.99, 52.19]])]]
    b = P.polygon_bounds(aoi[0])
    _equal(P.generate_point_grid(b, aoi, 60.0),
           J.generate_point_grid(b, aoi, 60.0))


def test_ellipsoids_equal():
    for name in ("WGS84", "GRS80"):
        pe, je = getattr(P, name), getattr(J, name)
        assert (pe.a, pe.f, pe.b, pe.e2, pe.e, pe.n) == \
            (je.a, je.f, je.b, je.e2, je.e, je.n)
    assert P.EPSG_2180.lon0 == J.EPSG_2180.lon0 == 19.0
