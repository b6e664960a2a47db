"""Hermetic fake tile server for tests + fault injection.

A copy of ``aerial_image_recognition_tpu/fetch/fake.py``: the same world
renders the same pixels and the server sends the same JPEG bytes.

The reference has no offline test fixture — every "test" hits live WMS/XYZ
endpoints (SURVEY.md §4). This server renders a deterministic synthetic
world (procedural ground texture + rectangular "cars" at seeded lon/lat
positions) for any requested XYZ tile, WMS GetMap bbox, or WMTS tile, so
city-scan integration tests run with zero network. Fault injection knobs
reproduce the failure taxonomy the fetch plane must survive: drop rate,
HTTP-429 rate (with Retry-After), latency, truncated bodies.
"""

import io
import math
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
from PIL import Image

from aerial_image_recognition_tpu_torch.geo.webmercator import tile_bounds


@dataclass
class FakeWorld:
    """Deterministic synthetic ground truth: cars (and, opt-in, buildings)
    at known lon/lat.

    n_buildings defaults to 0 so detection worlds are unchanged; the
    segmentation workflow (XUnet / automask — the reference's
    ramp_XUnet_256.onnx slot) enables them to get pixel-exact ground-truth
    footprint masks via render_mask()."""
    center_lon: float = 21.0
    center_lat: float = 52.2
    extent_deg: float = 0.02
    n_cars: int = 200
    seed: int = 7
    car_size_m: Tuple[float, float] = (4.5, 2.0)
    n_buildings: int = 0
    building_size_m: Tuple[float, float] = (22.0, 14.0)
    # opt-in hard cases (accuracy A/B of the TTA/multiscale modes —
    # the reference ran those modes to catch exactly these:
    # x_arch/03_analyze_wms.ipynb cell 8, gpu_handler.py:94-140): this
    # fraction of cars renders LOW-CONTRAST with an adjacent cast shadow,
    # and every second hard car is additionally ~40% occluded by a dark
    # "tree" blob. 0.0 keeps every existing world byte-identical.
    hard_fraction: float = 0.0
    cars: np.ndarray = field(init=False)      # [N, 3]: lon, lat, heading
    buildings: np.ndarray = field(init=False)  # [M, 4]: lon, lat, len_m, wid_m
    car_hard: np.ndarray = field(init=False)   # [N] bool

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        lon = self.center_lon + (rng.random(self.n_cars) - 0.5) * self.extent_deg
        lat = self.center_lat + (rng.random(self.n_cars) - 0.5) * self.extent_deg
        heading = rng.random(self.n_cars) * math.pi
        self.cars = np.stack([lon, lat, heading], axis=1)
        # separate stream so existing seeds keep their car/building layout
        hrng = np.random.default_rng(self.seed + 2000)
        self.car_hard = hrng.random(self.n_cars) < self.hard_fraction
        brng = np.random.default_rng(self.seed + 1000)
        blon = self.center_lon + (brng.random(self.n_buildings) - 0.5) * self.extent_deg
        blat = self.center_lat + (brng.random(self.n_buildings) - 0.5) * self.extent_deg
        L, W = self.building_size_m
        blen = L * (0.6 + 0.8 * brng.random(self.n_buildings))
        bwid = W * (0.6 + 0.8 * brng.random(self.n_buildings))
        self.buildings = np.stack([blon, blat, blen, bwid], axis=1)

    def _building_px(self, bbox, width: int, height: int):
        """Per-building integer pixel rects (x1,x2,y1,y2) within a bbox
        render — the single geometry used by BOTH render() and
        render_mask(), so image and mask are pixel-consistent."""
        west, south, east, north = bbox
        m2lon = 1.0 / (111319.9 * math.cos(math.radians((south + north) / 2)))
        m2lat = 1.0 / 111319.9
        ppd_x = width / (east - west)
        ppd_y = height / (north - south)
        b = self.buildings
        if not len(b):
            return []
        margin = 3e-4        # buildings are big; keep partial overlaps
        near = ((b[:, 0] >= west - margin) & (b[:, 0] <= east + margin)
                & (b[:, 1] >= south - margin) & (b[:, 1] <= north + margin))
        rects = []
        for lon, lat, blen, bwid in b[near]:
            dx = blen / 2 * m2lon
            dy = bwid / 2 * m2lat
            x1 = int((lon - dx - west) * ppd_x)
            x2 = int((lon + dx - west) * ppd_x)
            y1 = int((north - (lat + dy)) * ppd_y)
            y2 = int((north - (lat - dy)) * ppd_y)
            x1, x2 = max(x1, 0), min(x2, width)
            y1, y2 = max(y1, 0), min(y2, height)
            if x2 > x1 and y2 > y1:
                rects.append((x1, x2, y1, y2))
        return rects

    def render_mask(self, bbox, width: int, height: int) -> np.ndarray:
        """Ground-truth building-footprint mask for a bbox → uint8 [H, W]
        (1 = building). Pixel-aligned with render()."""
        mask = np.zeros((height, width), np.uint8)
        for x1, x2, y1, y2 in self._building_px(bbox, width, height):
            mask[y1:y2, x1:x2] = 1
        return mask

    def render(self, bbox, width: int, height: int) -> np.ndarray:
        """Render (west, south, east, north) → uint8 [H, W, 3].

        Ground texture is a deterministic function of geography (not of the
        request), so overlapping requests are pixel-consistent — needed for
        cross-tile dedup tests.
        """
        west, south, east, north = bbox
        xs = np.linspace(west, east, width, endpoint=False)
        ys = np.linspace(north, south, height, endpoint=False)
        lon_g, lat_g = np.meshgrid(xs, ys)
        # cheap deterministic "asphalt" texture
        t = (np.sin(lon_g * 201000.0) * np.cos(lat_g * 173000.0) * 0.5 + 0.5)
        img = (90 + 40 * t).astype(np.uint8)
        img = np.stack([img, img, img + 8], axis=-1).astype(np.uint8)

        # buildings first (under the cars): matte "roofs" with a rim so
        # the segmentation task has real edges to learn
        for x1, x2, y1, y2 in self._building_px(bbox, width, height):
            img[y1:y2, x1:x2] = (168, 130, 118)
            img[y1:min(y1 + 1, y2), x1:x2] = (200, 160, 148)
            img[y1:y2, x1:min(x1 + 1, x2)] = (200, 160, 148)

        m2lon = 1.0 / (111319.9 * math.cos(math.radians((south + north) / 2)))
        m2lat = 1.0 / 111319.9
        half_l = self.car_size_m[0] / 2
        half_w = self.car_size_m[1] / 2
        ppd_x = width / (east - west)
        ppd_y = height / (north - south)
        # vectorized prefilter: only iterate cars near this tile (the
        # python loop over ALL cars per request dominated fetch throughput
        # at city scale — 3000 cars × 10k tiles)
        c = self.cars
        near = ((c[:, 0] >= west - 1e-4) & (c[:, 0] <= east + 1e-4)
                & (c[:, 1] >= south - 1e-4) & (c[:, 1] <= north + 1e-4))
        for i in np.where(near)[0]:
            lon, lat, hd = c[i]
            # draw an axis-aligned bright box (heading ignored for speed)
            dx = half_l * m2lon
            dy = half_w * m2lat
            fx1 = (lon - dx - west) * ppd_x
            fx2 = (lon + dx - west) * ppd_x
            fy1 = (north - (lat + dy)) * ppd_y
            fy2 = (north - (lat - dy)) * ppd_y
            x1, x2 = max(int(fx1), 0), min(int(fx2), width)
            y1, y2 = max(int(fy1), 0), min(int(fy2), height)
            if x2 <= x1 or y2 <= y1:
                continue
            if not self.car_hard[i]:
                img[y1:y2, x1:x2] = (230, 235, 240)
                continue
            # hard case: cast shadow east of the car (sun from the west),
            # then a LOW-CONTRAST body; every second hard car also gets a
            # dark occluder over its western ~40% (tree canopy)
            sw = max(1, int(round((fx2 - fx1) * 0.8)))
            sx1, sx2 = min(x2, width), min(x2 + sw, width)
            if sx2 > sx1:
                img[y1:y2, sx1:sx2] = (
                    img[y1:y2, sx1:sx2].astype(np.int16) * 45 // 100
                ).astype(np.uint8)
            img[y1:y2, x1:x2] = (152, 155, 162)
            if i % 2 == 0:
                ox2 = x1 + max(1, int(round((fx2 - fx1) * 0.4)))
                oy1 = max(y1 - 1, 0)
                oy2 = min(y2 + 1, height)
                img[oy1:oy2, x1:min(ox2, width)] = (46, 58, 40)
        return img


@dataclass
class FaultConfig:
    drop_rate: float = 0.0       # probability of HTTP 500
    rate_limit_rate: float = 0.0  # probability of HTTP 429
    latency_s: float = 0.0
    truncate_rate: float = 0.0   # send half the body
    retry_after: float = 0.1


class FakeTileServer:
    """Threaded HTTP server speaking XYZ, WMS GetMap, and WMTS KVP."""

    def __init__(self, world: Optional[FakeWorld] = None,
                 faults: Optional[FaultConfig] = None,
                 tile_px: int = 256, seed: int = 3):
        self.world = world or FakeWorld()
        self.faults = faults or FaultConfig()
        self.tile_px = tile_px
        self.request_count = 0
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                server.request_count += 1
                fc = server.faults
                with server._rng_lock:
                    r1, r2, r3 = server._rng.random(3)
                if fc.latency_s:
                    import time as _t
                    _t.sleep(fc.latency_s)
                if r1 < fc.rate_limit_rate:
                    self.send_response(429)
                    # HTTP spec: delta-seconds must be an integer
                    self.send_header("Retry-After", str(int(fc.retry_after)))
                    self.end_headers()
                    return
                if r2 < fc.drop_rate:
                    self.send_response(500)
                    self.end_headers()
                    return
                body = server._route(self.path)
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                if r3 < fc.truncate_rate:
                    body = body[: len(body) // 2]
                self.send_response(200)
                ctype = ("text/xml" if body[:5] == b"<?xml"
                         else "image/jpeg")
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    # ----------------------------------------------------------- routing

    def _route(self, path: str) -> Optional[bytes]:
        url = urlparse(path)
        q = {k.upper(): v[0] for k, v in parse_qs(url.query).items()}
        if url.path.startswith("/xyz/"):
            parts = url.path.split("/")     # /xyz/{z}/{x}/{y}.jpg
            z, x = int(parts[2]), int(parts[3])
            y = int(parts[4].split(".")[0])
            w, s, e, n = tile_bounds(x, y, z)
            return self._jpeg(self.world.render((float(w), float(s),
                                                 float(e), float(n)),
                                                self.tile_px, self.tile_px))
        req = q.get("REQUEST", "")
        if req == "GetMap":
            bbox = [float(v) for v in q["BBOX"].split(",")]
            if q.get("VERSION") == "1.3.0" and q.get("CRS", "").upper() == "EPSG:4326":
                bbox = [bbox[1], bbox[0], bbox[3], bbox[2]]
            return self._jpeg(self.world.render(
                tuple(bbox), int(q["WIDTH"]), int(q["HEIGHT"])))
        if req == "GetCapabilities":
            if q.get("SERVICE", "").upper() == "WMS":
                return self._wms_capabilities()
            return self._capabilities()
        if req == "GetTile":
            return self._wmts_tile(q)
        return None

    def _jpeg(self, arr: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=88)
        return buf.getvalue()

    # WMTS fake matrix set: EPSG:2180-style, TopLeft chosen near the world.
    # Stored internally as (easting, northing); the capabilities document
    # publishes it north-first like the real geoportal (authority axis order
    # for EPSG:2180), so clients must axis-swap — same as production.
    _WMTS_TOPLEFT = (100000.0, 850000.0)
    _WMTS_SCALES = {"z0": 3571.428571428571, "z1": 1785.7142857142856}

    def _wms_capabilities(self) -> bytes:
        """Minimal WMS 1.1.1 capabilities: one layer 'fake', the CRS and
        formats the fake GetMap route actually serves — lets
        WMSFetcher.validate() run hermetically."""
        xml = """<?xml version="1.0" encoding="UTF-8"?>
<WMT_MS_Capabilities version="1.1.1">
  <Capability>
    <Request>
      <GetMap>
        <Format>image/jpeg</Format>
        <Format>image/png</Format>
      </GetMap>
    </Request>
    <Layer>
      <Title>fake world</Title>
      <SRS>EPSG:4326 EPSG:3857</SRS>
      <Layer queryable="0">
        <Name>fake</Name>
        <Title>fake imagery</Title>
      </Layer>
    </Layer>
  </Capability>
</WMT_MS_Capabilities>"""
        return xml.encode()

    def _capabilities(self) -> bytes:
        tms = []
        for ident, scale in self._WMTS_SCALES.items():
            tms.append(f"""
      <TileMatrix>
        <ows:Identifier>{ident}</ows:Identifier>
        <ScaleDenominator>{scale}</ScaleDenominator>
        <TopLeftCorner>{self._WMTS_TOPLEFT[1]} {self._WMTS_TOPLEFT[0]}</TopLeftCorner>
        <TileWidth>256</TileWidth>
        <TileHeight>256</TileHeight>
        <MatrixWidth>100000</MatrixWidth>
        <MatrixHeight>100000</MatrixHeight>
      </TileMatrix>""")
        xml = f"""<?xml version="1.0" encoding="UTF-8"?>
<Capabilities xmlns="http://www.opengis.net/wmts/1.0"
              xmlns:ows="http://www.opengis.net/ows/1.1">
  <Contents>
    <TileMatrixSet>
      <ows:Identifier>FAKE2180</ows:Identifier>
      <ows:SupportedCRS>urn:ogc:def:crs:EPSG::2180</ows:SupportedCRS>
      {''.join(tms)}
    </TileMatrixSet>
  </Contents>
</Capabilities>"""
        return xml.encode()

    def _wmts_tile(self, q: Dict[str, str]) -> Optional[bytes]:
        from aerial_image_recognition_tpu_torch.fetch.wmts import TileMatrix
        from aerial_image_recognition_tpu_torch.geo.crs import transform_points
        ident = q["TILEMATRIX"]
        scale = self._WMTS_SCALES.get(ident)
        if scale is None:
            return None
        m = TileMatrix(ident, scale, self._WMTS_TOPLEFT, 256, 256, 10**5, 10**5)
        col, row = int(q["TILECOL"]), int(q["TILEROW"])
        w, s, e, n = m.tile_bounds(col, row)
        # projected (EPSG:2180) bounds → WGS84 for the renderer
        west, south = transform_points(w, s, 2180, 4326)
        east, north = transform_points(e, n, 2180, 4326)
        return self._jpeg(self.world.render(
            (float(west), float(south), float(east), float(north)), 256, 256))

    # ---------------------------------------------------------- control

    def start(self) -> str:
        self._thread.start()
        host, port = self._httpd.server_address
        return f"http://{host}:{port}"

    @property
    def base_url(self) -> str:
        host, port = self._httpd.server_address
        return f"http://{host}:{port}"

    @property
    def xyz_template(self) -> str:
        return self.base_url + "/xyz/{z}/{x}/{y}.jpg"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
