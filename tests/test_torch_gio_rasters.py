"""The port's GeoTIFF and GeoPackage IO and its GeoTIFF sliding-window
detection, against the JAX package's.

IO: files each package writes read back equal (tolerance 0) in the other,
the port's ``write_geotiff`` bytes equal JAX's, and both read the same
compressed layouts (stripped and tiled; LZW, deflate, packbits; predictor
2) to the same pixels. The heatmap's GeoPackage equals the JAX heatmap's.

``detect_geotiff``: the trained fixture ``yolov7_tiny_fakeworld.npz`` in
f32 on the CPU, steps injected at ``model_size=64`` (128-px windows of a
0.25 m/px raster, resized on the device to the fixture's 0.5 m/px), on an
EPSG:4326 raster and a projected (UTM) one. The port georeferences in f64;
the JAX package's arithmetic stays in f32 there (NumPy 2 keeps the type of
the f32 box it scales), so each JAX coordinate is rounded to f32: held
within one f32 spacing of the JAX value (1.9e-6° of longitude at 21°,
3.8e-6° of latitude at 52°, 0.06 m of easting at 5e5 m, 0.5 m of northing
at 5.79e6 m), confidence within 1e-5, box size within 1e-3 px, same
classes and count. Each case runs with both packages' native fastgeo
loaded, and again with both loaders off (the host fallback, which on a
projected raster reads metres as lon/lat in both packages); one more case
shows that mixing the two paths changes a projected raster's records.
"""

import fcntl
import math
import os
import shutil
import sqlite3
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from aerial_image_recognition_tpu.fetch.fake import FakeWorld as JaxWorld
from aerial_image_recognition_tpu.gio import geopackage as JG
from aerial_image_recognition_tpu.gio import geotiff as JT
from aerial_image_recognition_tpu.pipeline import rasters as JR
from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step)
from aerial_image_recognition_tpu.post.dedup import (
    dedup_host as jax_dedup_host)
from aerial_image_recognition_tpu.post.heatmap import (
    hex_heatmap as jax_hex_heatmap)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu.utils import native as JN
from aerial_image_recognition_tpu_torch.gio import geopackage as PG
from aerial_image_recognition_tpu_torch.gio import geotiff as PT
from aerial_image_recognition_tpu_torch.gio.geojson import read_geojson
from aerial_image_recognition_tpu_torch.pipeline import rasters as PRS
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    build_detect_step)
from aerial_image_recognition_tpu_torch.post.heatmap import hex_heatmap
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from aerial_image_recognition_tpu_torch.utils import native as PN
from test_geotiff_rasters import _aerial_like, _lzw_encode

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")
UTM = (500000.0, 0.1, 0.0, 5788000.0, 0.0, -0.1)            # 10 cm/px
GEO = (21.0, 1e-5, 0.0, 52.2, 0.0, -1e-5)

torch.set_num_threads(2)


# ------------------------------------------------------------- GeoTIFF

@pytest.mark.parametrize("shape,transform,epsg", [
    ((120, 160, 3), UTM, 32634),
    ((64, 64), GEO, 4326),
    ((33, 47, 4), GEO, None),
], ids=["rgb-utm", "gray-4326", "rgba-no-epsg"])
def test_geotiff_both_ways(tmp_path, shape, transform, epsg):
    data = np.random.default_rng(1).integers(0, 255, shape, dtype=np.uint8)
    want = data if data.ndim == 3 else data[:, :, None]
    for write, read in ((PT.write_geotiff, JT.read_geotiff),
                        (JT.write_geotiff, PT.read_geotiff)):
        p = str(tmp_path / f"{write.__module__}.tif")
        write(p, data, transform, epsg=epsg)
        gt = read(p)
        np.testing.assert_array_equal(gt.data, want)
        assert gt.transform == pytest.approx(transform, rel=0, abs=0)
        assert gt.epsg == epsg
    with open(str(tmp_path / f"{PT.__name__}.tif"), "rb") as f:
        port_bytes = f.read()
    with open(str(tmp_path / f"{JT.__name__}.tif"), "rb") as f:
        assert port_bytes == f.read()
    # pixel_to_geo: the same affine, scalars and arrays
    gp = PT.read_geotiff(str(tmp_path / f"{JT.__name__}.tif"))
    gj = JT.read_geotiff(str(tmp_path / f"{PT.__name__}.tif"))
    cols, rows = np.array([0.0, 10.5, 31.0]), np.array([2.0, 20.25, 0.0])
    for got, ref in zip(gp.pixel_to_geo(cols, rows),
                        gj.pixel_to_geo(cols, rows)):
        np.testing.assert_array_equal(got, ref)


def _packbits(data: bytes) -> bytes:
    """Literal-run PackBits (≤ 128 bytes a run) with a repeat run for
    every stretch of ≥ 3 equal bytes."""
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        lit = data[i:i + 128]
        out += bytes([len(lit) - 1]) + lit
        i += len(lit)
    return bytes(out)


_CODECS = {5: _lzw_encode, 8: lambda b: zlib.compress(b, 6),
           32773: _packbits}


def _tiled_tiff(path, a, compression, predictor, tile=64):
    """A tiled classic TIFF (PIL's libtiff writes strips only): ``tile``-px
    tiles, edge tiles zero-padded, each compressed alone."""
    h, w, spp = a.shape
    tiles_x, tiles_y = -(-w // tile), -(-h // tile)
    payloads = []
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            t = np.zeros((tile, tile, spp), np.uint8)
            sub = a[ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile]
            t[:sub.shape[0], :sub.shape[1]] = sub
            if predictor == 2:
                d = t.astype(np.int16)
                d[:, 1:] -= t[:, :-1].astype(np.int16)
                t = (d & 0xFF).astype(np.uint8)
            payloads.append(_CODECS[compression](t.tobytes()))
    n_t = len(payloads)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
            (259, 3, [compression]), (262, 3, [2 if spp >= 3 else 1]),
            (277, 3, [spp]), (284, 3, [1]), (317, 3, [predictor]),
            (322, 4, [tile]), (323, 4, [tile]), (324, 4, None),
            (325, 4, [len(p) for p in payloads])]
    fmt = {3: "H", 4: "I"}
    cursor = 8 + 2 + len(tags) * 12 + 4
    where = {}
    for tag, typ, vals in tags:
        size = (n_t if vals is None else len(vals)) * struct.calcsize(fmt[typ])
        if size > 4:
            where[tag] = cursor
            cursor += size + size % 2
    offsets = list(np.cumsum([cursor] + [len(p) for p in payloads[:-1]]))
    buf = bytearray(struct.pack("<2sHI", b"II", 42, 8))
    buf += struct.pack("<H", len(tags))
    blobs = b""
    for tag, typ, vals in tags:
        vals = offsets if vals is None else vals
        raw = struct.pack(f"<{len(vals)}{fmt[typ]}", *map(int, vals))
        if len(raw) > 4:
            buf += struct.pack("<HHII", tag, typ, len(vals), where[tag])
            blobs += raw + b"\0" * (len(raw) % 2)
        else:
            buf += struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
    buf += struct.pack("<I", 0) + blobs + b"".join(payloads)
    with open(path, "wb") as f:
        f.write(bytes(buf))


@pytest.mark.parametrize("layout,compression,predictor", [
    ("strip", "tiff_lzw", 1), ("strip", "tiff_lzw", 2),
    ("strip", "tiff_deflate", 2), ("strip", "packbits", 1),
    ("strip", "gray_lzw", 2),
    ("tile", 5, 2), ("tile", 8, 1), ("tile", 32773, 1),
])
def test_geotiff_compressed_layouts_read_alike(tmp_path, layout,
                                               compression, predictor):
    """Stripped files written by libtiff (PIL) and hand-assembled tiled
    files: both packages read them to the same pixels, which are the
    written ones."""
    a = _aerial_like(np.random.default_rng(2), 150, 200, 3)
    p = str(tmp_path / "c.tif")
    if layout == "tile":
        _tiled_tiff(p, a, compression, predictor)
        want = a
    else:
        arr = a[:, :, 0] if compression == "gray_lzw" else a
        kw = {"compression": "tiff_lzw" if compression == "gray_lzw"
              else compression}
        if predictor == 2:
            kw["tiffinfo"] = {317: 2}
        Image.fromarray(arr).save(p, **kw)
        want = arr if arr.ndim == 3 else arr[:, :, None]
    got = PT.read_geotiff(p).data
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JT.read_geotiff(p).data)


# ----------------------------------------------------------- GeoPackage

FEATURES = [
    {"type": "Feature",
     "properties": {"count": 3, "mean_confidence": 0.75, "name": "hex_a",
                    "flag": True, "late": None},
     "geometry": {"type": "Polygon", "coordinates": [
         [[21.0, 52.2], [21.001, 52.2], [21.001, 52.201], [21.0, 52.2]],
         [[21.0002, 52.2002], [21.0004, 52.2002], [21.0004, 52.2004],
          [21.0002, 52.2002]]]}},
    {"type": "Feature",
     "properties": {"count": 1, "mean_confidence": None, "name": "hex_b",
                    "flag": False, "late": 7},
     "geometry": {"type": "MultiPolygon", "coordinates": [
         [[[21.01, 52.21], [21.011, 52.21], [21.011, 52.211],
           [21.01, 52.21]]]]}},
]


@pytest.mark.parametrize("geom", [f["geometry"] for f in FEATURES] + [
    {"type": "Point", "coordinates": [21.0, 52.2]},
    {"type": "LineString", "coordinates": [[0.0, 0.0], [1.0, 2.0]]}],
    ids=["polygon", "multipolygon", "point", "linestring"])
def test_wkb_equals_jax(geom):
    wkb = PG.encode_wkb(geom)
    assert wkb == JG.encode_wkb(geom)
    assert PG.decode_wkb(wkb) == JG.decode_wkb(wkb)
    assert PG.decode_wkb(wkb)[0] == geom


def _tables(path):
    con = sqlite3.connect(path)
    try:
        rows = {t: con.execute(f'SELECT * FROM "{t}"').fetchall()
                for t in ("gpkg_spatial_ref_sys", "gpkg_geometry_columns")}
        rows["contents"] = con.execute(
            "SELECT table_name, data_type, identifier, min_x, min_y, max_x,"
            " max_y, srs_id FROM gpkg_contents").fetchall()
        rows["app"] = con.execute("PRAGMA application_id").fetchall()
        return rows
    finally:
        con.close()


@pytest.mark.parametrize("srs_id", [4326, 2180])
def test_geopackage_both_ways(tmp_path, srs_id):
    pp, pj = str(tmp_path / "port.gpkg"), str(tmp_path / "jax.gpkg")
    PG.write_gpkg(pp, FEATURES, layer="hexes", geometry_type="POLYGON",
                  srs_id=srs_id)
    JG.write_gpkg(pj, FEATURES, layer="hexes", geometry_type="POLYGON",
                  srs_id=srs_id)
    for path in (pp, pj):
        got = PG.read_gpkg(path)
        assert got == JG.read_gpkg(path)
        assert got["layer"] == "hexes"
        assert [f["properties"] for f in got["features"]] == \
            [f["properties"] for f in FEATURES]
        assert [f["geometry"] for f in got["features"]] == \
            [f["geometry"] for f in FEATURES]
    assert _tables(pp) == _tables(pj)


def test_heatmap_geopackage_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    recs = [{"lon": 21.0 + float(rng.uniform(0, 0.004)),
             "lat": 52.2 + float(rng.uniform(0, 0.003)),
             "confidence": float(rng.uniform(0.3, 1.0))} for _ in range(60)]
    pp, pj = str(tmp_path / "port.gpkg"), str(tmp_path / "jax.gpkg")
    fc_p = hex_heatmap(recs, hex_size_m=50.0, output_geojson=pp)
    fc_j = jax_hex_heatmap(recs, hex_size_m=50.0, output_geojson=pj)
    assert fc_p == fc_j and len(fc_p["features"]) > 3
    got, want = PG.read_gpkg(pp), JG.read_gpkg(pj)
    assert got["layer"] == want["layer"] == "hex_heatmap_output"
    assert got["features"] == want["features"]
    assert _tables(pp) == _tables(pj)


# ------------------------------------------------------- detect_geotiff

@pytest.mark.parametrize("h,w,window,stride", [
    (100, 100, 64, 32), (64, 64, 64, 64), (30, 200, 64, 48),
    (1200, 1800, 1200, 600), (257, 513, 128, 96)])
def test_iter_windows_equal(h, w, window, stride):
    assert list(PRS.iter_windows(h, w, window, stride)) == \
        list(JR.iter_windows(h, w, window, stride))
    img = np.random.default_rng(4).integers(0, 255, (h, w, 4), np.uint8)
    for r, c in list(PRS.iter_windows(h, w, window, stride))[-3:]:
        np.testing.assert_array_equal(PRS._extract(img, r, c, window),
                                      JR._extract(img, r, c, window))


WINDOW, STRIDE, MODEL, BATCH = 128, 96, 64, 4
WORLD = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.004, n_cars=400,
             seed=4)
CFG = dict(dtype="float32", params_path=FIXTURE, confidence_threshold=0.3,
           nms_preselect="exact", quad_stem=False)


@pytest.fixture(scope="module")
def scene():
    """A 256-px raster of the FakeWorld at 0.25 m/px (64 m a side) and the
    two injected steps (128-px windows → the fixture's 64 px)."""
    clon, clat = 21.0, 52.2
    m2lon = 1.0 / (111319.9 * math.cos(math.radians(clat)))
    m2lat = 1.0 / 111319.9
    side = 256
    bbox = (clon, clat - side * 0.25 * m2lat, clon + side * 0.25 * m2lon,
            clat)
    img = JaxWorld(**WORLD).render(bbox, side, side)
    geo = (bbox[0], 0.25 * m2lon, 0.0, bbox[3], 0.0, -0.25 * m2lat)
    kw = dict(batch=BATCH, src_size=WINDOW, model_size=MODEL)
    return dict(img=img, geo=geo, m2lon=m2lon, m2lat=m2lat,
                jax=jax_build_detect_step(JaxDetectorConfig.from_dict(CFG),
                                          **kw),
                port=build_detect_step(DetectorConfig.from_dict(CFG),
                                       device="cpu", **kw))


def _recs(records):
    return sorted(records, key=lambda r: (round(r["x"], 3), r["y"]))


def _jax_fastgeo(monkeypatch, tmp_path_factory):
    """Make the JAX package's fastgeo loader resolve in this process.

    Its loader builds into one shared path beside the source and keeps a
    failed build for the life of the process, so parallel workers that
    build at the same time can leave a worker without it. Under a lock
    shared by the workers of this run, the loader's state is reset and it
    is asked again (three times at most: a build of a worker that does
    not take the lock may still collide with ours)."""
    if shutil.which("g++") is None:
        pytest.fail("g++ not found: the native dedup path of both packages "
                    "needs it")
    lock = tmp_path_factory.getbasetemp().parent / "jax_fastgeo.lock"
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for _ in range(3):
                monkeypatch.setattr(JN, "_failed", False)
                monkeypatch.setattr(JN, "_lib", None)
                if JN.load() is not None:
                    break
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    assert JN.load() is not None, "the JAX package's fastgeo did not load"
    assert PN.load() is not None, "the port's fastgeo did not load"


def _detect_both(tmp_path, scene, crs, dedup_m=2.0):
    """Both packages' ``detect_geotiff`` over the scene (records unsorted)."""
    if crs == "epsg4326":
        transform, epsg = scene["geo"], 4326
    else:
        transform, epsg = (500000.0, 0.25, 0.0, 5788000.0, 0.0, -0.25), 32634
    tif = str(tmp_path / "scene.tif")
    PT.write_geotiff(tif, scene["img"], transform, epsg=epsg)
    out_p, out_j = str(tmp_path / "p.geojson"), str(tmp_path / "j.geojson")
    got = PRS.detect_geotiff(tif, window=WINDOW, stride=STRIDE,
                            detect_step=scene["port"], output_geojson=out_p,
                            dedup_m=dedup_m)
    want = JR.detect_geotiff(tif, window=WINDOW, stride=STRIDE,
                             detect_step=scene["jax"], output_geojson=out_j,
                             dedup_m=dedup_m)
    return got, want, transform, epsg, out_p, out_j


def _assert_records_close(got, want):
    """Same count and classes; coordinates within one f32 spacing of the
    JAX value, confidence within 1e-5, box size within 1e-3 px. Records
    are paired by the assignment that is cheapest in units of those
    tolerances (overlapping windows before dedup give near-twins, which a
    sort could interleave)."""
    from scipy.optimize import linear_sum_assignment
    assert len(got) == len(want) >= 10
    key = np.array([[r["x"], r["y"], r["confidence"]] for r in want])
    pos = np.array([[r["x"], r["y"], r["confidence"]] for r in got])
    unit = np.concatenate([np.spacing(np.abs(key[:, :2]).astype(
        np.float32)).astype(np.float64), np.full((len(key), 1), 1e-5)], 1)
    cost = (np.abs(key[:, None] - pos[None]) / unit[:, None]).sum(axis=2)
    rows, cols = linear_sum_assignment(cost)
    want = [want[i] for i in rows]
    got = [got[i] for i in cols]
    assert [r["class"] for r in got] == [r["class"] for r in want]
    a = np.array([[r["x"], r["y"], r["confidence"], r["w_px"], r["h_px"]]
                  for r in got])
    b = np.array([[r["x"], r["y"], r["confidence"], r["w_px"], r["h_px"]]
                  for r in want])
    spacing = np.spacing(np.abs(b[:, :2]).astype(np.float32)).astype(
        np.float64)
    assert (np.abs(a[:, :2] - b[:, :2]) <= spacing).all()
    np.testing.assert_allclose(a[:, 2], b[:, 2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], atol=1e-3, rtol=0)
    return a


@pytest.mark.parametrize("dedup", ["native", "host"])
@pytest.mark.parametrize("crs", ["epsg4326", "utm"])
def test_detect_geotiff_equals_jax(tmp_path, tmp_path_factory, monkeypatch,
                                   scene, crs, dedup):
    """Both packages on the same dedup path: ``native`` makes each one's
    fastgeo load first (and fails where it cannot); ``host`` turns both
    loaders off, so a projected raster takes the reference's approximate
    host fallback in both.

    That fallback reads metres as lon/lat, which magnifies the JAX
    georeference's f32 rounding (0.5 m of northing) into other picks; there
    the port's picks are held to the JAX package's fallback applied to the
    port's own coordinates, and both packages' records before dedup to
    each other."""
    if dedup == "native":
        _jax_fastgeo(monkeypatch, tmp_path_factory)
    else:
        monkeypatch.setattr(JN, "load", lambda: None)
        monkeypatch.setattr(PN, "load", lambda: None)
    got, want, transform, epsg, out_p, out_j = _detect_both(tmp_path, scene,
                                                            crs)
    if crs == "utm" and dedup == "host":
        raw, raw_j, *_ = _detect_both(tmp_path, scene, crs, dedup_m=0)
        _assert_records_close(raw, raw_j)
        keep = jax_dedup_host(np.array([r["x"] for r in raw]),
                              np.array([r["y"] for r in raw]),
                              np.array([r["confidence"] for r in raw],
                                       np.float32), 2.0)
        want = [r for r, k in zip(raw, keep) if k]
    a = _assert_records_close(got, want)
    assert all(r["lon"] == r["x"] and r["lat"] == r["y"] for r in got)
    # inside the raster, and the output layer carries the raster's CRS
    x0, y0 = transform[0], transform[3]
    x1, y1 = x0 + 256 * transform[1], y0 + 256 * transform[5]
    assert ((a[:, 0] >= x0) & (a[:, 0] <= x1)).all()
    assert ((a[:, 1] <= y0) & (a[:, 1] >= y1)).all()
    doc_p, doc_j = read_geojson(out_p), read_geojson(out_j)
    assert doc_p["metadata"] == doc_j["metadata"] == {
        "epsg": epsg, "window": WINDOW, "stride": STRIDE}
    assert len(doc_p["features"]) == len(got)


def test_detect_geotiff_dedup_path_changes_projected_records(
        tmp_path, tmp_path_factory, monkeypatch, scene):
    """Why the test above pins the dedup path: on a projected raster the
    JAX package without its fastgeo reads metres as lon/lat in its host
    fallback, so with the port's fastgeo on the two keep other records."""
    _jax_fastgeo(monkeypatch, tmp_path_factory)
    monkeypatch.setattr(JN, "load", lambda: None)
    got, want, *_ = _detect_both(tmp_path, scene, "utm")
    assert len(want) >= 10 and len(got) != len(want)


def test_detect_geotiff_builds_its_own_step_on_the_cpu(tmp_path,
                                                       monkeypatch):
    """No injected step: the port builds one on ``device="cpu"`` at the
    registry's 640 px with the fixture's weights in the config's bf16, as
    the JAX package builds its own, here for one 1280-px window of a 0.25
    m/px raster (resized on the device to the fixture's 0.5 m/px). Their
    detections agree: the same count within 10 %, and ≥ 0.9 of the port's
    records within 1 m of a JAX record (bf16 trunks)."""
    clon, clat, side = 21.0, 52.2, 1280
    m2lon = 1.0 / (111319.9 * math.cos(math.radians(clat)))
    m2lat = 1.0 / 111319.9
    half = side * 0.25 / 2
    bbox = (clon - half * m2lon, clat - half * m2lat, clon + half * m2lon,
            clat + half * m2lat)
    img = JaxWorld(center_lon=clon, center_lat=clat, extent_deg=0.01,
                   n_cars=400, seed=4).render(bbox, side, side)
    tif = str(tmp_path / "scene.tif")
    PT.write_geotiff(tif, img, (bbox[0], 0.25 * m2lon, 0.0, bbox[3], 0.0,
                                -0.25 * m2lat), epsg=4326)
    built = []
    real = build_detect_step

    def spy(cfg, **kw):
        step = real(cfg, **kw)
        built.append((kw, step))
        return step

    monkeypatch.setattr(
        "aerial_image_recognition_tpu_torch.pipeline.inference."
        "build_detect_step", spy)
    kw = dict(window=side, stride=side, model="yolov7_itcvd",
              params=FIXTURE, confidence=0.3, batch=1)
    got = PRS.detect_geotiff(tif, device="cpu", **kw)
    want = JR.detect_geotiff(tif, **kw)
    ((kwargs, step),) = built
    assert kwargs == {"batch": 1, "src_size": side, "device": "cpu"}
    assert step.device.type == "cpu" and step.model_size == 640
    assert len(want) >= 10 and abs(len(got) - len(want)) <= 0.1 * len(want)
    pg = np.array([[r["x"] / m2lon, r["y"] / m2lat] for r in got])
    pj = np.array([[r["x"] / m2lon, r["y"] / m2lat] for r in want])
    d = np.linalg.norm(pg[:, None] - pj[None], axis=2).min(axis=1)
    assert (d <= 1.0).mean() >= 0.9
