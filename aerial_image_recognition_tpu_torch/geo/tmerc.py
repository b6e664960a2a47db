"""Transverse Mercator (Gauss–Krüger) projection, Karney (2011) series, order n^6.

A copy of ``aerial_image_recognition_tpu/geo/tmerc.py``. It replaces the
pyproj WGS84↔UTM transforms the reference uses everywhere (tile grids at
reference _script/utils.py:25-65, UTM dedup at simple_detector.py:540-596,
EPSG:2180 WMTS math at test_wmts.py:24-47). Implemented as closed-form
series so it runs vectorized over numpy arrays (``xp=numpy``, the default;
the port has no ``jax.numpy``) for host-side grid setup and dedup.

Accuracy: the order-6 Krüger series is accurate to well under 1 µm within
UTM-width zones (|λ−λ0| ≤ 3.5°), far beyond the centimeter scale this
pipeline needs; tests cross-check against an independent Snyder-series
implementation and a numerically integrated meridian arc.
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from aerial_image_recognition_tpu_torch.geo.ellipsoid import Ellipsoid, WGS84, GRS80


@dataclass(frozen=True)
class TMParams:
    """Parameters of one transverse-Mercator CRS."""
    ellipsoid: Ellipsoid
    lon0: float        # central meridian [deg]
    k0: float          # scale at central meridian
    false_easting: float
    false_northing: float


# EPSG:2180 — ETRS89 / Poland CS92 (the WMTS tile-matrix CRS probed by the
# reference's test_wmts.py): TM on GRS80, lon0=19°E, k0=0.9993,
# FE=500 000, FN=−5 300 000.
EPSG_2180 = TMParams(GRS80, lon0=19.0, k0=0.9993,
                     false_easting=500000.0, false_northing=-5300000.0)


def utm_zone(lon: float) -> int:
    """UTM zone number for a longitude (matches reference utils.py:16-23)."""
    return int((lon + 180.0) / 6.0) + 1


def utm_epsg(lon: float, lat: float) -> int:
    """EPSG code of the UTM zone containing (lon, lat).

    Same rule as the reference TileGenerator.get_utm_epsg
    (_script/utils.py:16-23): 326xx north, 327xx south.
    """
    epsg = 32600 + utm_zone(lon)
    if lat < 0:
        epsg += 100
    return epsg


@lru_cache(maxsize=None)
def utm_extent(bounds, params) -> tuple:
    """(min_e, min_n, max_e, max_n) of a WGS84 bbox in the TM frame,
    covering the whole bbox: corner points plus — when the central
    meridian crosses the bbox — the CM intersections of the south/north
    edges, where constant-latitude northing is extremal (grid lines curve
    away from the CM; two-corner extents under-cover)."""
    import numpy as np

    minx, miny, maxx, maxy = bounds
    lons = [minx, maxx]
    if minx < params.lon0 < maxx:
        lons.append(params.lon0)
    pts_lon, pts_lat = [], []
    for lo in lons:
        pts_lon += [lo, lo]
        pts_lat += [miny, maxy]
    x, y = tm_forward(np.asarray(pts_lon), np.asarray(pts_lat), params)
    return (float(np.min(x)), float(np.min(y)),
            float(np.max(x)), float(np.max(y)))


def utm_params_for(lon: float, lat: float):
    """(TMParams, epsg) of the UTM zone containing (lon, lat) — the
    zone-selection idiom shared by tiling, dedup, and the heatmap."""
    epsg = utm_epsg(float(lon), float(lat))
    return utm_params(epsg % 100, south=epsg >= 32700), epsg


def utm_params(zone: int, south: bool = False) -> TMParams:
    return TMParams(
        WGS84,
        lon0=float(zone * 6 - 183),
        k0=0.9996,
        false_easting=500000.0,
        false_northing=10000000.0 if south else 0.0,
    )


@lru_cache(maxsize=None)
def _series_coeffs(a: float, f: float):
    """Krüger series coefficients (alpha forward, beta inverse) to n^6."""
    n = f / (2.0 - f)
    n2, n3, n4, n5, n6 = n * n, n**3, n**4, n**5, n**6
    # Rectifying radius
    A = a / (1 + n) * (1 + n2 / 4 + n4 / 64 + n6 / 256)
    alpha = np.array([
        n / 2 - 2 * n2 / 3 + 5 * n3 / 16 + 41 * n4 / 180 - 127 * n5 / 288
        + 7891 * n6 / 37800,
        13 * n2 / 48 - 3 * n3 / 5 + 557 * n4 / 1440 + 281 * n5 / 630
        - 1983433 * n6 / 1935360,
        61 * n3 / 240 - 103 * n4 / 140 + 15061 * n5 / 26880
        + 167603 * n6 / 181440,
        49561 * n4 / 161280 - 179 * n5 / 168 + 6601661 * n6 / 7257600,
        34729 * n5 / 80640 - 3418889 * n6 / 1995840,
        212378941 * n6 / 319334400,
    ])
    beta = np.array([
        n / 2 - 2 * n2 / 3 + 37 * n3 / 96 - n4 / 360 - 81 * n5 / 512
        + 96199 * n6 / 604800,
        n2 / 48 + n3 / 15 - 437 * n4 / 1440 + 46 * n5 / 105
        - 1118711 * n6 / 3870720,
        17 * n3 / 480 - 37 * n4 / 840 - 209 * n5 / 4480 + 5569 * n6 / 90720,
        4397 * n4 / 161280 - 11 * n5 / 504 - 830251 * n6 / 7257600,
        4583 * n5 / 161280 - 108847 * n6 / 3991680,
        20648693 * n6 / 638668800,
    ])
    return A, alpha, beta


def tm_forward(lon, lat, params: TMParams, xp=np):
    """(lon, lat) degrees → (easting, northing) meters. Vectorized.

    ``xp`` is numpy (or a module with numpy's names); the code does no
    python branching on data.
    """
    ell = params.ellipsoid
    A, alpha, _ = _series_coeffs(ell.a, ell.f)
    e = ell.e

    # wrap into [-180, 180] so AOIs crossing the antimeridian (zone 60
    # data at lon=-179.9 with lon0=+177) don't produce garbage eastings
    dlon = (xp.asarray(lon) - params.lon0 + 180.0) % 360.0 - 180.0
    lam = xp.radians(dlon)
    phi = xp.radians(xp.asarray(lat))

    sphi = xp.sin(phi)
    # Conformal latitude via Karney's tau-chain: t = sinh(asinh-form)
    t = xp.sinh(xp.arctanh(sphi) - e * xp.arctanh(e * sphi))
    xi_p = xp.arctan2(t, xp.cos(lam))
    eta_p = xp.arcsinh(xp.sin(lam) / xp.sqrt(t * t + xp.cos(lam) ** 2))

    xi = xi_p
    eta = eta_p
    for j in range(6):
        k = 2.0 * (j + 1)
        xi = xi + alpha[j] * xp.sin(k * xi_p) * xp.cosh(k * eta_p)
        eta = eta + alpha[j] * xp.cos(k * xi_p) * xp.sinh(k * eta_p)

    easting = params.false_easting + params.k0 * A * eta
    northing = params.false_northing + params.k0 * A * xi
    return easting, northing


def tm_inverse(easting, northing, params: TMParams, xp=np, newton_iters: int = 3):
    """(easting, northing) meters → (lon, lat) degrees. Vectorized."""
    ell = params.ellipsoid
    A, _, beta = _series_coeffs(ell.a, ell.f)
    e = ell.e
    e2 = ell.e2

    xi = (xp.asarray(northing) - params.false_northing) / (params.k0 * A)
    eta = (xp.asarray(easting) - params.false_easting) / (params.k0 * A)

    xi_p = xi
    eta_p = eta
    for j in range(6):
        k = 2.0 * (j + 1)
        xi_p = xi_p - beta[j] * xp.sin(k * xi) * xp.cosh(k * eta)
        eta_p = eta_p - beta[j] * xp.cos(k * xi) * xp.sinh(k * eta)

    lam = xp.arctan2(xp.sinh(eta_p), xp.cos(xi_p))
    tau_p = xp.sin(xi_p) / xp.sqrt(xp.sinh(eta_p) ** 2 + xp.cos(xi_p) ** 2)

    # Invert tau' = tau*sqrt(1+sigma^2) - sigma*sqrt(1+tau^2) by Newton
    # (Karney 2011 eq. 19-21, geographiclib Math::tauf formulation); a few
    # fixed iterations converge to machine epsilon.
    e2m = 1.0 - e2
    tau = tau_p / e2m
    for _ in range(newton_iters):
        sq1t = xp.sqrt(1.0 + tau * tau)
        sigma = xp.sinh(e * xp.arctanh(e * tau / sq1t))
        taupa = tau * xp.sqrt(1.0 + sigma * sigma) - sigma * sq1t
        dtau = ((tau_p - taupa) * (1.0 + e2m * tau * tau)
                / (e2m * sq1t * xp.sqrt(1.0 + taupa * taupa)))
        tau = tau + dtau

    lat = xp.degrees(xp.arctan(tau))
    lon = xp.degrees(lam) + params.lon0
    return lon, lat
