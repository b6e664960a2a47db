"""The port's fetch plane against the JAX package's, over their fake tile
servers.

The same world renders the same pixels and each server sends the same JPEG
bytes; the port's XYZ, WMS and WMTS fetchers return the JAX fetchers' arrays
for the same bboxes (both decode with the native libjpeg path here); under
the same injected faults the retry loop, the Retry-After parse and the
failure statistics agree. Tolerance 0 throughout. Worlds and bboxes come
from fixed seeds.
"""

import io
import urllib.request

import numpy as np
import pytest
from PIL import Image

from aerial_image_recognition_tpu.fetch import fake as JF
from aerial_image_recognition_tpu.fetch import http as JH
from aerial_image_recognition_tpu.fetch.wms import WMSFetcher as JWMS
from aerial_image_recognition_tpu.fetch.wmts import WMTSFetcher as JWMTS
from aerial_image_recognition_tpu.fetch.xyz import XYZFetcher as JXYZ
from aerial_image_recognition_tpu_torch.fetch import fake as PF
from aerial_image_recognition_tpu_torch.fetch import http as PH
from aerial_image_recognition_tpu_torch.fetch.cache import TileCache
from aerial_image_recognition_tpu_torch.fetch.wms import (
    WMSFetcher, parse_wms_capabilities)
from aerial_image_recognition_tpu_torch.fetch.wmts import (
    WMTSFetcher, parse_capabilities)
from aerial_image_recognition_tpu_torch.fetch.xyz import XYZFetcher
from aerial_image_recognition_tpu_torch.geo import generate_tiles
from aerial_image_recognition_tpu_torch.utils.native import native_paths

WORLD = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.01, n_cars=80,
             seed=7, n_buildings=6, hard_fraction=0.3)
BBOXES = [tuple(t) for t in
          generate_tiles((20.998, 52.198, 21.001, 52.2), 64.0, 0.2)[:6]]


@pytest.fixture(scope="module")
def servers():
    jsrv = JF.FakeTileServer(JF.FakeWorld(**WORLD))
    psrv = PF.FakeTileServer(PF.FakeWorld(**WORLD))
    jsrv.start()
    psrv.start()
    yield jsrv, psrv
    jsrv.stop()
    psrv.stop()


@pytest.mark.parametrize("bbox,size", [
    ((20.999, 52.199, 21.001, 52.201), 256),
    ((20.995, 52.195, 21.005, 52.205), 640),
    ((21.0, 52.2, 21.0003, 52.2002), 96)])
def test_world_renders_equal(bbox, size):
    pw, jw = PF.FakeWorld(**WORLD), JF.FakeWorld(**WORLD)
    np.testing.assert_array_equal(pw.cars, jw.cars)
    np.testing.assert_array_equal(pw.car_hard, jw.car_hard)
    np.testing.assert_array_equal(pw.buildings, jw.buildings)
    img = pw.render(bbox, size, size)
    np.testing.assert_array_equal(img, jw.render(bbox, size, size))
    np.testing.assert_array_equal(pw.render_mask(bbox, size, size),
                                  jw.render_mask(bbox, size, size))
    assert img.max() >= 200                # cars or buildings in view


@pytest.mark.parametrize("path", [
    "/xyz/17/73181/43058.jpg",
    "/wms?SERVICE=WMS&VERSION=1.1.1&REQUEST=GetMap&LAYERS=fake&STYLES=&"
    "SRS=EPSG:4326&BBOX=20.999,52.199,21.001,52.201&WIDTH=640&HEIGHT=640&"
    "FORMAT=image/jpeg",
    "/wms?SERVICE=WMS&VERSION=1.3.0&REQUEST=GetMap&LAYERS=fake&STYLES=&"
    "CRS=EPSG:4326&BBOX=52.199,20.999,52.201,21.001&WIDTH=96&HEIGHT=96&"
    "FORMAT=image/jpeg",
    "/wms?SERVICE=WMS&REQUEST=GetCapabilities&VERSION=1.1.1",
    "/wmts?SERVICE=WMTS&REQUEST=GetCapabilities&VERSION=1.0.0",
    "/wmts?SERVICE=WMTS&REQUEST=GetTile&VERSION=1.0.0&LAYER=fake&"
    "STYLE=default&FORMAT=image/jpeg&TILEMATRIXSET=FAKE2180&TILEMATRIX=z1&"
    "TILEROW=1147&TILECOL=1586"])
def test_server_sends_the_same_bytes(servers, path):
    jsrv, psrv = servers
    bodies = []
    for srv in (jsrv, psrv):
        with urllib.request.urlopen(srv.base_url + path, timeout=30) as r:
            assert r.status == 200
            bodies.append(r.read())
    assert bodies[0] == bodies[1] and len(bodies[0]) > 100
    assert psrv._route(path) == bodies[0]


def test_native_decode_ran_here():
    """The fetchers below decode with libjpeg: g++ and libjpeg are here."""
    assert native_paths() == {"fastgeo": True, "fastdecode": True,
                              "fastpack": True}


def test_xyz_fetchers_return_equal_arrays(servers):
    jsrv, psrv = servers
    pf = XYZFetcher(psrv.xyz_template, zoom=18, num_workers=8,
                    subdomains=("",))
    jf = JXYZ(jsrv.xyz_template, zoom=18, num_workers=8, subdomains=("",))
    try:
        got = pf.fetch_batch(BBOXES, window_px=96)
        want = jf.fetch_batch(BBOXES, window_px=96)
        for g, w in zip(got, want):
            assert g.bounds == w.bounds and g.meta == w.meta
            np.testing.assert_array_equal(g.pixels, w.pixels)
        img = pf.get_image(52.2, 21.0, target_size_m=64.0)
        jimg = jf.get_image(52.2, 21.0, target_size_m=64.0)
        np.testing.assert_array_equal(img.pixels, jimg.pixels)
        assert img.bounds == jimg.bounds
        before = psrv.request_count
        pf.get_image(52.2, 21.0)             # every slippy tile cached
        assert psrv.request_count == before and pf.cache.stats()[0] > 0
        assert pf.window_px(52.2, 64.0) == jf.window_px(52.2, 64.0)
    finally:
        pf.close()
        jf.close()


@pytest.mark.parametrize("size,version", [((128, 128), "1.1.1"),
                                          ((96, 96), "1.3.0")])
def test_wms_fetchers_return_equal_arrays(servers, size, version):
    jsrv, psrv = servers
    pf = WMSFetcher(psrv.base_url + "/wms", "fake", size=size,
                    num_workers=4, submit_spacing=0.0, version=version)
    jf = JWMS(jsrv.base_url + "/wms", "fake", size=size, num_workers=4,
              submit_spacing=0.0, version=version)
    try:
        assert pf.getmap_params(BBOXES[0]) == jf.getmap_params(BBOXES[0])
        got, want = pf.fetch_batch(BBOXES), jf.fetch_batch(BBOXES)
        for g, w in zip(got, want):
            assert g.bounds == w.bounds
            np.testing.assert_array_equal(g.pixels, w.pixels)
        assert pf.validate()["layers"] == {"fake"}
        pv = pf.preview_geojson(BBOXES)
        assert len(pv["features"]) == len(BBOXES)
        assert pv["properties"]["stats"]["successes"] >= len(BBOXES)
    finally:
        pf.close()
        jf.close()


def test_wmts_fetchers_return_equal_arrays(servers):
    jsrv, psrv = servers
    pf = WMTSFetcher(psrv.base_url + "/wmts", "fake", matrix_set="FAKE2180",
                     crs=2180, num_workers=4)
    jf = JWMTS(jsrv.base_url + "/wmts", "fake", matrix_set="FAKE2180",
               crs=2180, num_workers=4)
    try:
        assert pf.available_zooms() == jf.available_zooms()
        assert pf.window_px() == jf.window_px() == 768
        got, want = pf.fetch_batch(BBOXES[:3]), jf.fetch_batch(BBOXES[:3])
        for g, w in zip(got, want):
            assert g.bounds == w.bounds and g.pixels.shape == (768, 768, 3)
            np.testing.assert_array_equal(g.pixels, w.pixels)
    finally:
        pf.close()
        jf.close()


def _faulted_stats(http_mod, srv_mod, faults, n=10):
    """``n`` GetMap requests, one after another, through ``http_mod``'s
    TileHTTP against a fresh server of the same package with the given
    faults: the server draws its faults in request order, so both packages
    see the same sequence."""
    srv = srv_mod.FakeTileServer(srv_mod.FakeWorld(**WORLD),
                                 faults=srv_mod.FaultConfig(**faults))
    srv.start()
    try:
        http = http_mod.TileHTTP(timeout=10.0, retries=3, backoff=0.01)
        bodies = []
        for k in range(n):
            bb = BBOXES[k % len(BBOXES)]
            bodies.append(http.get(srv.base_url + "/wms", params={
                "REQUEST": "GetMap", "BBOX": ",".join(map(str, bb)),
                "WIDTH": "64", "HEIGHT": "64"}))
        s = http.stats
        counts = (s.requests, s.successes, s.failures, s.timeouts,
                  s.rate_limited, s.bytes_fetched)
        analysis = http.failures.analyze()
        http.close()
        return bodies, counts, analysis["total"], analysis["by_type"], \
            srv.request_count
    finally:
        srv.stop()


@pytest.mark.parametrize("faults", [
    {"drop_rate": 0.3},
    {"rate_limit_rate": 0.8, "retry_after": 0.01},
    {"drop_rate": 0.3, "rate_limit_rate": 0.6, "retry_after": 0.01},
    {"drop_rate": 0.95}])
def test_faults_give_the_same_retries_and_stats(faults):
    got = _faulted_stats(PH, PF, faults)
    want = _faulted_stats(JH, JF, faults)
    assert got[1:] == want[1:]
    assert got[0] == want[0]                   # the same bodies, or None
    counts, total = got[1], got[2]
    assert total > 0 and counts[2] == total    # failures were logged
    if faults.get("rate_limit_rate"):
        assert counts[4] > 0                   # 429s reached the loop
    if faults.get("drop_rate", 0) > 0.9:
        assert None in got[0]                  # retries ran out


@pytest.mark.parametrize("value", [
    None, "", "3", "0.5", "-4", "soon",
    "Wed, 21 Oct 2015 07:28:00 GMT", "Fri, 01 Jan 2100 00:00:00 GMT"])
def test_retry_after_parse_agrees(value):
    got = PH._retry_after_seconds(value, 1.5)
    want = JH._retry_after_seconds(value, 1.5)
    if value and value.startswith("Fri"):      # future date: seconds left
        assert abs(got - want) < 5.0 and got > 1e9
    else:
        assert got == want


def test_failure_log_and_stats_summary_agree():
    logs = (PH.FailureLog(), JH.FailureLog())
    stats = (PH.FetchStats(), JH.FetchStats())
    for log in logs:
        for k in range(9):
            log.add(f"u{k}", "HTTP500" if k % 3 else "Timeout", k % 2)
    for st in stats:
        st.record(True, 0.1, 1000)
        st.record(False, 0.2, timeout=True)
        st.record(False, 0.2, ratelimited=True)
    assert logs[0].analyze() == logs[1].analyze()
    sp, sj = (s.summary() for s in stats)
    sp.pop("img_per_s"), sj.pop("img_per_s")         # wall-clock rates
    assert sp == sj and len(logs[0]) == 9


def test_capabilities_parsers_and_cache(servers):
    _, psrv = servers
    m = parse_capabilities(psrv._capabilities(), "FAKE2180")["z0"]
    assert m.top_left == (100000.0, 850000.0)        # axis-swapped
    caps = parse_wms_capabilities(psrv._wms_capabilities())
    assert caps["layers"] == {"fake"} and "EPSG:4326" in caps["srs"]
    c = TileCache(capacity=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert c.get("b") is None and c.get("a") == 1 and len(c) == 2


def test_fetched_jpeg_pixels_are_the_native_decode(servers):
    """The fetched pixels are libjpeg's decode of the server's bytes, not
    PIL's (which differs by up to ±2 per channel)."""
    _, psrv = servers
    path = ("/wms?SERVICE=WMS&VERSION=1.1.1&REQUEST=GetMap&LAYERS=fake&"
            "STYLES=&SRS=EPSG:4326&BBOX=" + ",".join(map(str, BBOXES[0]))
            + "&WIDTH=128&HEIGHT=128&FORMAT=image/jpeg")
    body = psrv._route(path)
    f = WMSFetcher(psrv.base_url + "/wms", "fake", size=(128, 128),
                   num_workers=1, submit_spacing=0.0)
    try:
        img = f.get_single_image(BBOXES[0])
    finally:
        f.close()
    from aerial_image_recognition_tpu_torch.utils.native import (
        decode_jpeg_native)
    np.testing.assert_array_equal(img.pixels, decode_jpeg_native(body))
    pil = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    assert np.abs(img.pixels.astype(int) - pil.astype(int)).max() <= 2
