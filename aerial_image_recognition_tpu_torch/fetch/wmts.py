"""WMTS fetcher — projected tile-matrix math + capabilities probing.

A copy of ``aerial_image_recognition_tpu/fetch/wmts.py``.

Functional equivalent of the reference's WMTS prober (test_wmts.py:8-143):
enumerate zoom levels from ScaleDenominator (pixel span = scale·0.00028 m),
compute (row, col) from projected coordinates against the matrix TopLeft
corner, and fetch radius-N tile neighborhoods. Capabilities XML is parsed
with xml.etree (owslib replacement); KVP GetTile requests.
"""

import concurrent.futures as cf
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from aerial_image_recognition_tpu_torch.fetch.http import TileHTTP
from aerial_image_recognition_tpu_torch.fetch.xyz import TileImage
from aerial_image_recognition_tpu_torch.geo.crs import transform_points

# OGC standardized rendering pixel size (meters)
PIXEL_SIZE = 0.00028

_NS = {
    "wmts": "http://www.opengis.net/wmts/1.0",
    "ows": "http://www.opengis.net/ows/1.1",
}


@dataclass
class TileMatrix:
    identifier: str
    scale_denominator: float
    top_left: Tuple[float, float]      # (x, y) projected
    tile_width: int
    tile_height: int
    matrix_width: int
    matrix_height: int

    @property
    def pixel_span(self) -> float:
        """Ground meters per pixel = ScaleDenominator · 0.00028
        (test_wmts.py:14-22 semantics)."""
        return self.scale_denominator * PIXEL_SIZE

    @property
    def tile_span(self) -> Tuple[float, float]:
        return (self.pixel_span * self.tile_width,
                self.pixel_span * self.tile_height)

    def tile_of(self, x: float, y: float) -> Tuple[int, int]:
        """(col, row) of the tile containing projected (x, y)
        (test_wmts.py:24-47 semantics: col east from TopLeft.x, row south
        from TopLeft.y)."""
        sx, sy = self.tile_span
        col = int(math.floor((x - self.top_left[0]) / sx))
        row = int(math.floor((self.top_left[1] - y) / sy))
        return col, row

    def tile_bounds(self, col: int, row: int):
        sx, sy = self.tile_span
        west = self.top_left[0] + col * sx
        north = self.top_left[1] - row * sy
        return (west, north - sy, west + sx, north)


# Projected CRSs whose authority axis order is (northing, easting); WMTS
# capabilities publish TopLeftCorner in authority order, so these need a
# swap into our internal (x=easting, y=northing) convention. Includes the
# reference's target EPSG:2180 (Polish CS92 — geoportal.gov.pl publishes
# TopLeftCorner north-first; test_wmts.py:31-39 hardcodes the xy-swapped
# values) and the CS2000 zones / common European north-first grids.
_NORTH_FIRST_EPSG = {2180, 2176, 2177, 2178, 2179, 3006, 3035}


def _epsg_of(crs_text: Optional[str]) -> Optional[int]:
    """'urn:ogc:def:crs:EPSG::2180' / 'EPSG:2180' → 2180."""
    if not crs_text:
        return None
    tail = crs_text.strip().split(":")[-1]
    return int(tail) if tail.isdigit() else None


# projected (east-first) CRSs that live inside the otherwise-geographic
# 4xxx block (e.g. World Equidistant Cylindrical / Mercator variants)
_EAST_FIRST_4XXX = {4087, 4088}


def _is_north_first(epsg: Optional[int]) -> bool:
    if epsg is None:
        return False
    if epsg in _EAST_FIRST_4XXX:
        return False
    # geographic CRSs (lat,lon authority order) live in the 4xxx block
    return epsg in _NORTH_FIRST_EPSG or 4000 <= epsg < 5000


def parse_capabilities(xml_bytes: bytes,
                       matrix_set: Optional[str] = None,
                       axis_order: str = "auto",
                       default_epsg: Optional[int] = None) -> Dict[str, TileMatrix]:
    """Capabilities XML → {matrix identifier: TileMatrix}.

    axis_order: 'auto' swaps TopLeftCorner into (easting, northing) when the
    matrix set's SupportedCRS has north-first authority axes (e.g. EPSG:2180,
    EPSG:4326); 'xy' trusts the document as (x, y); 'yx' always swaps.
    default_epsg is used when the document omits SupportedCRS.
    """
    root = ET.fromstring(xml_bytes)
    out: Dict[str, TileMatrix] = {}
    for tms in root.iter(f"{{{_NS['wmts']}}}TileMatrixSet"):
        ident_el = tms.find("ows:Identifier", _NS)
        if matrix_set and (ident_el is None or ident_el.text != matrix_set):
            continue
        crs_el = tms.find("ows:SupportedCRS", _NS)
        epsg = _epsg_of(crs_el.text if crs_el is not None else None)
        swap = (axis_order == "yx" or
                (axis_order == "auto" and
                 _is_north_first(epsg if epsg is not None else default_epsg)))
        for tm in tms.findall("wmts:TileMatrix", _NS):
            ident = tm.find("ows:Identifier", _NS).text
            scale = float(tm.find("wmts:ScaleDenominator", _NS).text)
            tl = tm.find("wmts:TopLeftCorner", _NS).text.split()
            if swap:
                tl = [tl[1], tl[0]]
            out[ident] = TileMatrix(
                identifier=ident,
                scale_denominator=scale,
                top_left=(float(tl[0]), float(tl[1])),
                tile_width=int(tm.find("wmts:TileWidth", _NS).text),
                tile_height=int(tm.find("wmts:TileHeight", _NS).text),
                matrix_width=int(tm.find("wmts:MatrixWidth", _NS).text),
                matrix_height=int(tm.find("wmts:MatrixHeight", _NS).text),
            )
    return out


class WMTSFetcher:
    def __init__(self, url: str, layer: str, *, matrix_set: str,
                 crs: int = 2180, image_format: str = "image/jpeg",
                 style: str = "default", num_workers: int = 25,
                 timeout: float = 10.0, retries: int = 5,
                 axis_order: str = "auto"):
        self.url = url
        self.layer = layer
        self.matrix_set = matrix_set
        self.crs = crs
        self.axis_order = axis_order
        self.image_format = image_format
        self.style = style
        self.http = TileHTTP(timeout=timeout, retries=retries)
        # separate pools: neighborhood tasks wait on tile GETs (sharing one
        # pool would self-deadlock once outer tasks occupy every worker)
        self._pool = cf.ThreadPoolExecutor(max_workers=num_workers,
                                           thread_name_prefix="wmts-tile")
        self._img_pool = cf.ThreadPoolExecutor(
            max_workers=max(2, num_workers // 4),
            thread_name_prefix="wmts-img")
        self._matrices: Optional[Dict[str, TileMatrix]] = None
        self.default_radius = 1

    def matrices(self) -> Dict[str, TileMatrix]:
        if self._matrices is None:
            body = self.http.get(self.url, params={
                "SERVICE": "WMTS", "REQUEST": "GetCapabilities",
                "VERSION": "1.0.0"})
            if body is None:
                raise RuntimeError("WMTS GetCapabilities failed")
            self._matrices = parse_capabilities(body, self.matrix_set,
                                                axis_order=self.axis_order,
                                                default_epsg=self.crs)
        return self._matrices

    def available_zooms(self) -> List[Tuple[str, float]]:
        """[(matrix id, meters/pixel)] sorted fine→coarse."""
        ms = self.matrices()
        return sorted(((k, m.pixel_span) for k, m in ms.items()),
                      key=lambda kv: kv[1])

    def _get_tile(self, matrix: TileMatrix, col: int, row: int
                  ) -> Optional[np.ndarray]:
        body = self.http.get(self.url, params={
            "SERVICE": "WMTS", "REQUEST": "GetTile", "VERSION": "1.0.0",
            "LAYER": self.layer, "STYLE": self.style,
            "FORMAT": self.image_format,
            "TILEMATRIXSET": self.matrix_set,
            "TILEMATRIX": matrix.identifier,
            "TILEROW": str(row), "TILECOL": str(col)})
        if body is None:
            return None
        return self.http.decode(body)   # native libjpeg path, PIL fallback

    def fetch_neighborhood(self, lon: float, lat: float, matrix_id: str,
                           radius: int = 1) -> Optional[TileImage]:
        """Mosaic the (2r+1)² tile neighborhood around a WGS84 point
        (test_wmts.py:53-97 semantics) → TileImage with WGS84 bounds."""
        m = self.matrices()[matrix_id]
        x, y = transform_points(lon, lat, 4326, self.crs)
        ccol, crow = m.tile_of(float(x), float(y))
        coords = [(c, r) for r in range(crow - radius, crow + radius + 1)
                  for c in range(ccol - radius, ccol + radius + 1)]
        futs = {cr: self._pool.submit(self._get_tile, m, cr[0], cr[1])
                for cr in coords}
        t_w, t_h = m.tile_width, m.tile_height
        n = 2 * radius + 1
        mosaic = np.zeros((n * t_h, n * t_w, 3), dtype=np.uint8)
        ok = 0
        for (c, r), fut in futs.items():
            arr = fut.result()
            if arr is not None and arr.shape[:2] == (t_h, t_w):
                mosaic[(r - (crow - radius)) * t_h:(r - (crow - radius) + 1) * t_h,
                       (c - (ccol - radius)) * t_w:(c - (ccol - radius) + 1) * t_w] = arr
                ok += 1
        if ok == 0:
            return None
        w_proj = m.tile_bounds(ccol - radius, crow - radius)
        e_proj = m.tile_bounds(ccol + radius, crow + radius)
        west, north = transform_points(w_proj[0], w_proj[3], self.crs, 4326)
        east, south = transform_points(e_proj[2], e_proj[1], self.crs, 4326)
        return TileImage(pixels=mosaic,
                         bounds=(float(west), float(south),
                                 float(east), float(north)),
                         meta={"matrix": matrix_id, "tiles_ok": ok,
                               "crs": self.crs})

    def finest_matrix(self) -> str:
        return self.available_zooms()[0][0]

    def window_px(self, radius: Optional[int] = None) -> int:
        m = next(iter(self.matrices().values()))
        return (2 * (radius or self.default_radius) + 1) * m.tile_width

    def fetch_batch(self, bboxes: Sequence, progress=None,
                    matrix_id: Optional[str] = None,
                    radius: Optional[int] = None) -> List[Optional[TileImage]]:
        """WGS84 bboxes → neighborhood mosaics centered on each bbox
        (fetch-plane API parity with the XYZ/WMS fetchers)."""
        mid = matrix_id or self.finest_matrix()
        rad = radius or self.default_radius

        def one(bbox):
            lon_c = (bbox[0] + bbox[2]) / 2
            lat_c = (bbox[1] + bbox[3]) / 2
            out = self.fetch_neighborhood(lon_c, lat_c, mid, radius=rad)
            if progress is not None:
                progress.update(1)
            return out

        futures = [self._img_pool.submit(one, b) for b in bboxes]
        return [f.result() for f in futures]

    def close(self):
        self._img_pool.shutdown(wait=False, cancel_futures=True)
        self._pool.shutdown(wait=False, cancel_futures=True)
        self.http.close()
