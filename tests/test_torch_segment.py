"""The port's segmentation workflows against the JAX package's: the segment
half of ``pipeline/rasters.py``, ``pipeline/automask.py`` and the server's
``/segment`` plane.

The trained fixture ``xunet_fakeworld.npz`` in f32 on the CPU, each
package's own ``make_segment_fn`` injected; rasters rendered from the
FakeWorld's buildings at the training scale (0.25 m/px). Tolerances, each
stated where it is used:

* ``_place_probs``: within 1e-6 when it shrinks; within 1e-5 when it
  grows, where ``jax.image.resize``'s own 256→320 weights are 7.6e-6 off
  the exact bilinear ones (its result 8.8e-6 from an f64 product of
  them, the port's 1.0e-7);
* stitched probabilities within 5e-5 (f32 logits within ~1e-4), 2e-3
  where windows are resized (the bf16 matrix resize first); masks, rings,
  instances and files equal where a deterministic stand-in model scores
  the windows;
* ``/segment`` payloads equal to the JAX server's for the same images:
  masks and polygons pixel for pixel, ``mean_prob`` within 5e-5.

Where the port builds its own executor (bf16 on the CPU; int8
self-calibrated), it is held to the bars of
tests/test_segmentation_quality.py and tests/test_int8.py.
"""

import base64
import concurrent.futures as cf
import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch
from PIL import Image
from scipy import ndimage as ndi

from aerial_image_recognition_tpu.fetch.fake import FakeWorld
from aerial_image_recognition_tpu.gio.geopackage import (
    read_gpkg as jax_read_gpkg)
from aerial_image_recognition_tpu.gio.geotiff import (
    GeoTiff as JaxGeoTiff)
from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model, load_params as jax_load_params)
from aerial_image_recognition_tpu.pipeline import automask as JA
from aerial_image_recognition_tpu.pipeline import rasters as JR
from aerial_image_recognition_tpu.pipeline.inference import (
    make_segment_fn as jax_make_segment_fn)
from aerial_image_recognition_tpu.pipeline.serve import (
    DetectionServer as JaxServer)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.gio.geojson import read_geojson
from aerial_image_recognition_tpu_torch.gio.geopackage import read_gpkg
from aerial_image_recognition_tpu_torch.gio.geotiff import (
    GeoTiff, read_geotiff, write_geotiff)
from aerial_image_recognition_tpu_torch.models.registry import create_model
from aerial_image_recognition_tpu_torch.pipeline import automask as PA
from aerial_image_recognition_tpu_torch.pipeline import rasters as PR
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    build_detect_step, make_segment_fn)
from aerial_image_recognition_tpu_torch.pipeline.serve import (
    DetectionServer)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from test_serve_segment import _tiny_detect_step as jax_tiny_detect_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "xunet_fakeworld.npz")
DET_FIXTURE = os.path.join(FIXTURES, "yolov7_tiny_fakeworld.npz")
WORLD = FakeWorld(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                  n_cars=150, n_buildings=120, seed=4)
M2LON = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
M2LAT = 1.0 / 111319.9

torch.set_num_threads(2)


def raster(w_px, h_px, path=None):
    """The world around its centre at 0.25 m/px → (image, transform),
    written as an EPSG:4326 GeoTIFF when ``path`` is given."""
    half_w, half_h = w_px * 0.125, h_px * 0.125           # metres
    bbox = (WORLD.center_lon - half_w * M2LON,
            WORLD.center_lat - half_h * M2LAT,
            WORLD.center_lon + half_w * M2LON,
            WORLD.center_lat + half_h * M2LAT)
    img = WORLD.render(bbox, w_px, h_px)
    transform = (bbox[0], (bbox[2] - bbox[0]) / w_px, 0.0, bbox[3], 0.0,
                 -(bbox[3] - bbox[1]) / h_px)
    if path:
        write_geotiff(path, img, transform, 4326)
    return img, transform, bbox


@pytest.fixture(scope="module")
def fns():
    """Each package's f32 segment function over the trained fixture."""
    jb = jax_create_model("xunet_256", dtype=jnp.float32)
    jb.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                       jax_load_params(FIXTURE))
    jfn = jax.jit(jax_make_segment_fn(
        jb, JaxDetectorConfig(model_family="xunet", dtype="float32")))
    pb = create_model("xunet_256", params_path=FIXTURE, dtype=torch.float32,
                      device="cpu", fold_bn=True)
    pfn = make_segment_fn(pb, DetectorConfig(model_family="xunet",
                                             dtype="float32"))
    return dict(jfn=jfn, jparams=jb.params, pfn=pfn)


def _fake_probs(imgs):
    """A deterministic stand-in model: the red channel of [B,w,w,3] as a
    [B,256,256,1] probability (nearest sampling to the model size)."""
    imgs = np.asarray(imgs)
    idx = np.arange(256) * imgs.shape[1] // 256
    return (imgs[:, idx][:, :, idx][..., :1].astype(np.float32) / 255.0)


# --------------------------------------------------------------- rasters

@pytest.mark.parametrize("window", [200, 320], ids=["shrink", "grow"])
def test_place_probs_equals_jax(window):
    rng = np.random.default_rng(7)
    probs = rng.random((2, 256, 256), dtype=np.float32)
    got = PR._place_probs(probs, window)
    want = JR._place_probs(probs, window)
    assert got.shape == want.shape == (2, window, window)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 if window < 256 else 1e-5)
    assert PR._place_probs(probs, 256) is probs


@pytest.mark.parametrize("window,stride", [(256, None), (256, 128),
                                           (200, 150)])
def test_stitch_probability_map_equals_jax(fns, window, stride):
    """A 384×320 raster, four windows in one fixed-shape batch of 4: the
    same probability map within 5e-5 (2e-3 for 200-px windows, resized to
    the model and back)."""
    img, transform, _ = raster(384, 320)
    gt = GeoTiff(data=img, transform=transform, epsg=4326)
    got = PR.stitch_probability_map(gt, fns["pfn"], window=window,
                                    stride=stride, batch=4)
    want = JR.stitch_probability_map(
        JaxGeoTiff(data=img, transform=transform, epsg=4326), fns["jfn"],
        fns["jparams"], window=window, stride=stride, batch=4)
    assert got.shape == want.shape == (320, 384) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-5 if window == 256 else 2e-3)
    assert (want > 0.5).mean() >= 0.02        # buildings in the raster
    with pytest.raises(ValueError, match="stride"):
        PR.stitch_probability_map(gt, fns["pfn"], window=128, stride=160)


def test_segment_geotiff_equals_jax(tmp_path):
    """The stand-in model over a 300×200 raster with overlap (window 128,
    stride 96): the same mask, the same mask GeoTIFF and the same polygon
    GeoJSON."""
    tif = str(tmp_path / "r.tif")
    raster(300, 200, tif)
    out = {}
    for name, fn, mod in (("port", _fake_probs, PR),
                          ("jax", lambda _p, imgs: _fake_probs(imgs), JR)):
        kw = dict(window=128, stride=96, batch=4, segment_fn=fn,
                  threshold=0.3,
                  output_mask=str(tmp_path / f"{name}.tif"),
                  output_polygons=str(tmp_path / f"{name}.geojson"))
        if name == "jax":
            kw["params"] = None
        out[name] = mod.segment_geotiff(tif, **kw)
    np.testing.assert_array_equal(out["port"], out["jax"])
    assert out["port"].dtype == np.uint8 and out["port"].any()
    np.testing.assert_array_equal(read_geotiff(str(tmp_path / "port.tif"))
                                  .data,
                                  read_geotiff(str(tmp_path / "jax.tif"))
                                  .data)
    doc_p = read_geojson(str(tmp_path / "port.geojson"))
    doc_j = read_geojson(str(tmp_path / "jax.geojson"))
    assert doc_p == doc_j and len(doc_p["features"]) >= 1
    with pytest.raises(ValueError, match="quantize"):
        PR.segment_geotiff(tif, segment_fn=_fake_probs, quantize="int8")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_to_polygons_equals_jax(seed):
    """Seeded blob masks (holes, touching corners, the border): the same
    rings in the same order."""
    rng = np.random.default_rng(seed)
    mask = ndi.binary_opening(rng.random((60, 80)) > 0.55) \
        .astype(np.uint8)
    got, want = PR.mask_to_polygons(mask), JR.mask_to_polygons(mask)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------- automask

def _blob_probs(rng):
    """Sharp and soft blobs of seeded sizes and places."""
    h = w = 128
    ys, xs = np.mgrid[0:h, 0:w]
    probs = np.zeros((h, w), np.float32)
    for _ in range(10):
        cy, cx = rng.uniform(8, 120, 2)
        r = rng.uniform(2, 12)
        d = np.hypot(ys - cy, xs - cx)
        blob = np.clip(1.0 - (d / r) ** 8, 0, 1) if rng.random() < 0.6 \
            else np.clip(1.0 - d / (3 * r), 0, 1)
        probs = np.maximum(probs, blob.astype(np.float32))
    return probs


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_instances_equals_jax(seed):
    probs = _blob_probs(np.random.default_rng(seed))
    kw = dict(min_area_px=15, stability_min=0.5)
    got = PA.extract_instances(probs, **kw)
    want = JA.extract_instances(probs, **kw)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("id", "area_px", "stability", "score",
                                  "mask_slice")} == \
            {k: w[k] for k in ("id", "area_px", "stability", "score",
                               "mask_slice")}
        np.testing.assert_array_equal(g["mask"], w["mask"])


@pytest.mark.parametrize("fmt", ["geojson", "gpkg"])
def test_automask_geotiff_equals_jax(tmp_path, fmt):
    """The stand-in model over a 96-px raster with two red instances (the
    scene of tests/test_automask.py): the same instances, instance mask
    GeoTIFF and polygons (GeoJSON, or the ``instances`` layer of a
    GeoPackage)."""
    img = np.zeros((96, 96, 3), np.uint8)
    img[10:30, 10:40, 0] = 255
    img[60:80, 50:70, 0] = 255
    transform = (21.0, 1e-5, 0.0, 52.2, 0.0, -1e-5)
    res = {}
    for name, fn, mod, gt in (
            ("port", _fake_probs, PA, GeoTiff(data=img, transform=transform, epsg=4326)),
            ("jax", lambda _p, imgs: _fake_probs(imgs), JA,
             JaxGeoTiff(data=img, transform=transform, epsg=4326))):
        res[name] = mod.automask_geotiff(
            gt, window=48, batch=4, segment_fn=fn, min_area_px=50,
            stability_min=0.5, output_mask=str(tmp_path / f"{name}.tif"),
            output_polygons=str(tmp_path / f"{name}.{fmt}"))
    assert len(res["port"]) == len(res["jax"]) == 2
    for g, w in zip(res["port"], res["jax"]):
        assert g["stability"] == w["stability"] > 0.9
        assert (g["id"], g["area_px"], g["score"], g["mask_slice"]) == \
            (w["id"], w["area_px"], w["score"], w["mask_slice"])
    np.testing.assert_array_equal(
        read_geotiff(str(tmp_path / "port.tif")).data,
        read_geotiff(str(tmp_path / "jax.tif")).data)
    if fmt == "gpkg":
        got = read_gpkg(str(tmp_path / "port.gpkg"))
        want = jax_read_gpkg(str(tmp_path / "jax.gpkg"))
        assert got["layer"] == "instances"
    else:
        got = json.load(open(tmp_path / "port.geojson"))
        want = json.load(open(tmp_path / "jax.geojson"))
    assert got == want and len(got["features"]) == 2


def test_automask_recovers_buildings_on_the_cpu(tmp_path):
    """The port building its own bf16 XUnet (``device="cpu"``) over a 512-px
    raster of the training world (2×2 windows): every building component
    recovered as an instance to the bar of
    tests/test_segmentation_quality.py (≥ 0.7 and ≤ 1.5× + 2 of the
    ground-truth components, raster IoU ≥ 0.7)."""
    tif = str(tmp_path / "w.tif")
    _, _, bbox = raster(512, 512, tif)
    gt_mask = WORLD.render_mask(bbox, 512, 512) > 0
    inst = PA.automask_geotiff(tif, window=256, params=FIXTURE,
                               min_area_px=100,
                               output_mask=str(tmp_path / "m.tif"),
                               device="cpu")
    labels, n_all = ndi.label(gt_mask)
    n_gt = sum(1 for i in range(1, n_all + 1) if (labels == i).sum() >= 100)
    assert n_gt > 0
    assert 0.7 * n_gt <= len(inst) <= 1.5 * n_gt + 2
    pred = read_geotiff(str(tmp_path / "m.tif")).data.reshape(512, 512) > 0
    assert (pred & gt_mask).sum() / max((pred | gt_mask).sum(), 1) >= 0.7


def test_segment_geotiff_int8_self_calibrates_on_the_cpu(tmp_path):
    """The counterpart of
    tests/test_int8.py::test_segment_geotiff_int8_self_calibrates:
    ``quantize="int8"`` calibrates on the raster's own windows and gives
    the bf16 path's stitched mask at IoU ≥ 0.99 (512×256, two windows)."""
    tif = str(tmp_path / "a.tif")
    raster(512, 256, tif)
    kw = dict(window=256, batch=2, params=FIXTURE, device="cpu")
    mask_f = PR.segment_geotiff(tif, **kw)
    mask_q = PR.segment_geotiff(tif, quantize="int8", **kw)
    union = (mask_f | mask_q).sum()
    assert union > 0 and (mask_f & mask_q).sum() / union >= 0.99
    with pytest.raises(ValueError, match="quantize"):
        PR.segment_geotiff(tif, quantize="int4", **kw)


# --------------------------------------------------------------- server

def _tiles():
    """Eight held-out building tiles of 256 px as JPEG (seed 321, as
    tests/test_serve_segment.py draws them), the last one 320 px."""
    import sys
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from train_xunet_fakeworld import build_tiles
    bodies = []
    for bbox in build_tiles(WORLD, 32, size=256, tile_m=64.0, seed=321):
        if WORLD.render_mask(bbox, 256, 256).mean() >= 0.03:
            size = 320 if len(bodies) == 7 else 256
            buf = io.BytesIO()
            Image.fromarray(WORLD.render(bbox, size, size)).save(
                buf, "JPEG", quality=95)
            bodies.append(buf.getvalue())
        if len(bodies) == 8:
            return bodies
    raise AssertionError("fake world unexpectedly sparse")


@pytest.fixture(scope="module")
def servers(fns):
    """The port's server (f32 detect step at 96 px, the f32 segment
    function, warmed up) and the JAX package's, each with a segment plane
    of batch 8."""
    step = build_detect_step(
        DetectorConfig.from_dict({"params_path": DET_FIXTURE,
                                  "dtype": "float32",
                                  "confidence_threshold": 0.4}),
        batch=4, model_size=96, device="cpu")
    port = DetectionServer(detect_step=step, segment_fn=fns["pfn"],
                           segment_batch=8, max_wait_ms=100.0).start()
    jax_srv = JaxServer(detect_step=jax_tiny_detect_step(),
                        segment_fn=fns["jfn"], segment_params=fns["jparams"],
                        segment_batch=8,
                        max_wait_ms=100.0).start(warmup=False)
    yield port, jax_srv
    port.stop()
    jax_srv.stop()


def _post_all(url, bodies, **params):
    def one(body):
        return requests.post(url + "/segment", data=body, params=params,
                             timeout=120)

    with cf.ThreadPoolExecutor(len(bodies)) as pool:
        return list(pool.map(one, bodies))


def _mask(payload):
    return np.asarray(Image.open(io.BytesIO(
        base64.b64decode(payload["mask_png"]))))


def test_segment_payloads_equal_jax_server(servers):
    """Eight requests at once to each server (one of them 320 px, resized
    in and its probabilities resized back before thresholding): the same
    masks, coverage and polygons; mean_prob within 5e-5; one batch or two
    of the plane, not eight."""
    port, jax_srv = servers
    bodies = _tiles()
    assert requests.get(port.url + "/healthz", timeout=10).json()[
        "segment"] is True
    before = requests.get(port.url + "/stats", timeout=10).json()
    got = _post_all(port.url, bodies, polygons="1", threshold="0.5")
    want = _post_all(jax_srv.url, bodies, polygons="1", threshold="0.5")
    for g, w in zip(got, want):
        assert g.status_code == w.status_code == 200, g.text
        g, w = g.json(), w.json()
        assert set(g) == set(w) == {"shape", "mean_prob", "coverage",
                                    "mask_png", "polygons"}
        assert g["shape"] == w["shape"]
        np.testing.assert_array_equal(_mask(g), _mask(w))
        assert g["coverage"] == w["coverage"] > 0
        assert abs(g["mean_prob"] - w["mean_prob"]) <= 5e-5
        assert g["polygons"] == w["polygons"]
    assert got[-1].json()["shape"] == [320, 320]
    after = requests.get(port.url + "/stats", timeout=10).json()
    assert after["segment_requests"] - before["segment_requests"] == 8
    assert after["resized"] - before["resized"] == 1
    seg = after["planes"]["segment"]["batches"] \
        - before["planes"]["segment"]["batches"]
    assert 1 <= seg <= 6


def test_segment_plane_replies_like_jax(servers):
    """A bad threshold is 400, an undecodable body 400 in both; a
    threshold moves the mask; /detect still answers beside the plane."""
    port, jax_srv = servers
    for srv in (port, jax_srv):
        r = requests.post(srv.url + "/segment?threshold=x", data=b"x",
                          timeout=30)
        assert r.status_code == 400 and r.json() == {"error":
                                                     "bad threshold"}
        r = requests.post(srv.url + "/segment", data=b"not an image",
                          timeout=30)
        assert r.status_code == 400
    body = _tiles()[0]
    lo = requests.post(port.url + "/segment", params={"threshold": "0.05"},
                       data=body, timeout=60).json()
    hi = requests.post(port.url + "/segment", params={"threshold": "0.95"},
                       data=body, timeout=60).json()
    assert "polygons" not in lo and lo["coverage"] >= hi["coverage"]
    img = np.asarray(Image.open(io.BytesIO(body)).resize((96, 96)))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=95)
    r = requests.post(port.url + "/detect",
                      params={"west": 21.0, "south": 52.2, "east": 21.001,
                              "north": 52.201},
                      data=buf.getvalue(), timeout=60)
    assert r.status_code == 200 and "detections" in r.json()


def test_segment_404_when_not_enabled():
    step = build_detect_step(DetectorConfig(dtype="float32"), batch=1,
                             model_size=64, device="cpu")
    srv = DetectionServer(detect_step=step).start(warmup=False)
    try:
        r = requests.post(srv.url + "/segment", data=b"x", timeout=10)
        assert r.status_code == 404
        assert requests.get(srv.url + "/healthz", timeout=10).json()[
            "segment"] is False
    finally:
        srv.stop()
