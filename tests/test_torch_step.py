"""The port's whole detect step against the JAX step, then driven by the
port's CarDetector city scan (against the JAX CarDetector with the JAX
step) and by the port's DetectionServer.

f32 on the CPU, 64-px model on the trained fixture. Tolerances: valid slots
identical, boxes within 1e-3 px, scores within 1e-5, lon/lat within 1e-6°.

The accuracy modes (TTA, multiscale, box voting, shadow enhancement, the
fixpoint suppression, a resizing src_size) run at batch 2 against the JAX
``build_detect_step`` with the same extras: same valid slots, boxes within
1e-2 px (voting sums up to 256 weighted f32 coordinates in another order;
CLAHE may differ by one level on a rare pixel), scores within 1e-4,
lon/lat within 1e-6°.
"""

import io
import json
import math
import os
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from aerial_image_recognition_tpu.fetch.fake import FakeTileServer, FakeWorld
from aerial_image_recognition_tpu.gio.geojson import read_geojson, write_geojson
from aerial_image_recognition_tpu.pipeline.detector import CarDetector
from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.fetch.fake import (
    FakeTileServer as PortFakeTileServer, FakeWorld as PortFakeWorld)
from aerial_image_recognition_tpu_torch.pipeline.detector import (
    CarDetector as PortCarDetector)
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    build_detect_step, detection_sets_agree)
from aerial_image_recognition_tpu_torch.pipeline.serve import DetectionServer
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")
SIZE, BATCH = 64, 8
M2LON = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
M2LAT = 1.0 / 111319.9
CFG = dict(dtype="float32", params_path=FIXTURE, confidence_threshold=0.3,
           nms_preselect="exact", quad_stem=False)
# the e2e scan's world and AOI (tests/test_pipeline_e2e.py)
WORLD = FakeWorld(center_lon=21.0, center_lat=52.2, extent_deg=0.004,
                  n_cars=30, seed=11)
PORT_WORLD = PortFakeWorld(center_lon=21.0, center_lat=52.2,
                           extent_deg=0.004, n_cars=30, seed=11)
AOI = {"type": "FeatureCollection", "features": [{
    "type": "Feature", "properties": {},
    "geometry": {"type": "Polygon", "coordinates": [[
        [20.998, 52.198], [21.002, 52.198], [21.002, 52.202],
        [20.998, 52.202], [20.998, 52.198]]]},
}]}

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def steps():
    jax_step = jax_build_detect_step(JaxDetectorConfig.from_dict(CFG),
                                     batch=BATCH, src_size=SIZE,
                                     model_size=SIZE)
    assert jax_step.input_layout == "hwc"
    port_step = build_detect_step(DetectorConfig.from_dict(CFG),
                                  batch=BATCH, model_size=SIZE, device="cpu")
    return jax_step, port_step


def _tiles(batch=BATCH, src=SIZE):
    """batch tiles around FakeWorld cars, + their bounds: src px over the
    32 m that a 64-px tile covers at the fixture's training scale (0.5
    m/px), so a larger src keeps the cars' trained size after the resize."""
    world = FakeWorld(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                      n_cars=500, seed=9)
    tiles, bounds = [], []
    for k in range(batch):
        lon, lat, _ = world.cars[k * 11]
        bbox = (lon - 15.0 * M2LON, lat - 17.0 * M2LAT,
                lon + 17.0 * M2LON, lat + 15.0 * M2LAT)
        tiles.append(world.render(bbox, src, src))
        bounds.append(bbox)
    return np.stack(tiles), np.asarray(bounds, np.float32)


def test_step_matches_jax_step(steps):
    jax_step, port_step = steps
    assert (port_step.batch, port_step.input_size, port_step.model_size,
            port_step.input_layout, port_step.input_shardings) == \
        (BATCH, SIZE, SIZE, "hwc", None)
    images, bounds = _tiles()
    jdet, jlon, jlat = jax_step(images, bounds)
    pdet, plon, plat = port_step(images, bounds)
    valid = np.asarray(jdet.valid)
    assert valid.sum() >= BATCH          # the fixture sees the cars
    np.testing.assert_array_equal(pdet.valid.numpy(), valid)
    np.testing.assert_array_equal(pdet.classes.numpy(),
                                  np.asarray(jdet.classes))
    np.testing.assert_allclose(pdet.boxes.numpy(), np.asarray(jdet.boxes),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(pdet.scores.numpy(), np.asarray(jdet.scores),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(plon.numpy()[valid], np.asarray(jlon)[valid],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(plat.numpy()[valid], np.asarray(jlat)[valid],
                               atol=1e-6, rtol=0)
    ok, stats = detection_sets_agree((pdet, plon, plat),
                                     (jdet, jlon, jlat))
    assert ok and stats["matched"] == valid.sum()


def _scan(tmp_path, server, step, monkeypatch, detector=CarDetector):
    from aerial_image_recognition_tpu.fetch.xyz import XYZFetcher
    from aerial_image_recognition_tpu_torch.fetch.xyz import (
        XYZFetcher as PortXYZFetcher)
    for cls in (XYZFetcher, PortXYZFetcher):
        monkeypatch.setattr(cls, "window_px", lambda self, lat, m=None: SIZE)
    base = str(tmp_path)
    frame = os.path.join(base, "aoi.geojson")
    write_geojson(AOI, frame)
    det = detector(base, {
        "frame_path": frame, "use_xyz": True, "xyz_url": server.xyz_template,
        "zoom": 17, "tile_size_meters": 64.0, "tile_overlap": 0.2,
        "batch_size": 16, "device_batch": BATCH, "num_workers": 8,
        "duplicate_distance": 1.0, "checkpoint_interval": 10**9,
        "confidence_threshold": 0.3}, detect_step=step)
    out = det.detect(force_restart=True)
    doc = read_geojson(os.path.join(base, "output",
                                    "detections_results.geojson"))
    return out, sorted(
        (f["geometry"]["coordinates"][0], f["geometry"]["coordinates"][1],
         f["properties"]["confidence"]) for f in doc["features"])


def test_city_scan_with_port_step_matches_jax_step(tmp_path, steps,
                                                    monkeypatch):
    jax_step, port_step = steps
    srv = FakeTileServer(WORLD)
    psrv = PortFakeTileServer(PORT_WORLD)
    srv.start()
    psrv.start()
    try:
        out_j, recs_j = _scan(tmp_path / "jax", srv, jax_step, monkeypatch)
        out_p, recs_p = _scan(tmp_path / "port", psrv, port_step,
                              monkeypatch, detector=PortCarDetector)
    finally:
        srv.stop()
        psrv.stop()
    assert out_p["tiles"] == out_j["tiles"] > 20
    assert len(recs_p) == len(recs_j) > 0
    recs_p, recs_j = np.asarray(recs_p), np.asarray(recs_j)
    np.testing.assert_allclose(recs_p[:, :2], recs_j[:, :2], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(recs_p[:, 2], recs_j[:, 2], atol=1e-5, rtol=0)


def test_server_answers_detect_requests(steps):
    _, port_step = steps
    images, bounds = _tiles()
    srv = DetectionServer(detect_step=port_step, max_wait_ms=20.0).start()
    try:
        with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
            health = json.load(r)
        assert health["ok"] and health["input_size"] == SIZE
        direct = port_step(images, bounds)[0]
        for k in range(3):
            buf = io.BytesIO()
            Image.fromarray(images[k]).save(buf, "PNG")
            w, s, e, n = (float(v) for v in bounds[k])
            req = urllib.request.Request(
                f"{srv.url}/detect?west={w!r}&south={s!r}&east={e!r}"
                f"&north={n!r}", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                body = json.load(r)
            assert r.status == 200
            assert body["count"] == len(body["detections"]) \
                == int(direct.valid[k].sum()) > 0
            got = sorted(d["confidence"] for d in body["detections"])
            want = sorted(direct.scores[k][direct.valid[k]].tolist())
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["requests"] == 3 and stats["planes"]["detect"]["batches"]
    finally:
        srv.stop()


# ------------------------------------------------------- accuracy modes

MODE_BATCH = 2
MODES = {
    "tta": dict(tta=True),
    "tta-subsample2-voting": dict(tta=True, tta_hist_subsample=2,
                                  tta_clahe_backend="xla", box_voting=0.5),
    "multiscale-defaults": dict(multiscale=[0.5, 1.0, 1.5]),
    "multiscale-no-voting": dict(multiscale=[0.5, 1.0, 1.5], box_voting=0,
                                 multiscale_weights=[0.9, 1.0, 0.7]),
    "box-voting": dict(box_voting=0.5),
    "enhance-shadows": dict(enhance_shadows=True),
    "fixpoint": dict(nms_suppression="fixpoint"),
    "scan": dict(nms_suppression="scan"),
    "src96": dict(),
    "src128-crop96": dict(),
}
SRC = {"src96": (96, None), "src128-crop96": (128, 96)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_accuracy_mode_matches_jax_step(mode):
    cfg = dict(CFG, confidence_threshold=0.1, **MODES[mode])
    src, crop = SRC.get(mode, (SIZE, None))
    kw = dict(batch=MODE_BATCH, src_size=src, crop_size=crop,
              model_size=SIZE)
    jax_step = jax_build_detect_step(JaxDetectorConfig.from_dict(cfg), **kw)
    port_step = build_detect_step(DetectorConfig.from_dict(cfg),
                                  device="cpu", **kw)
    assert (port_step.input_size, port_step.model_size) == (src, SIZE) \
        == (jax_step.input_size, jax_step.model_size)
    images, bounds = _tiles(MODE_BATCH, src)
    jdet, jlon, jlat = jax_step(images, bounds)
    pdet, plon, plat = port_step(images, bounds)
    valid = np.asarray(jdet.valid)
    assert valid.sum() >= MODE_BATCH
    np.testing.assert_array_equal(pdet.valid.numpy(), valid)
    np.testing.assert_array_equal(pdet.classes.numpy(),
                                  np.asarray(jdet.classes))
    np.testing.assert_allclose(pdet.boxes.numpy(), np.asarray(jdet.boxes),
                               atol=1e-2, rtol=0)
    np.testing.assert_allclose(pdet.scores.numpy(), np.asarray(jdet.scores),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(plon.numpy()[valid], np.asarray(jlon)[valid],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(plat.numpy()[valid], np.asarray(jlat)[valid],
                               atol=1e-6, rtol=0)


def _port_detect(extra, seed, conf=0.02):
    """The port's step on noise tiles at a low threshold: many overlapping
    candidates, as the contract tests of the JAX package use."""
    cfg = DetectorConfig.from_dict(dict(CFG, confidence_threshold=conf,
                                        **extra))
    step = build_detect_step(cfg, batch=2, model_size=SIZE, device="cpu")
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    bounds = np.tile(np.asarray([[20.99, 52.21, 21.0, 52.22]], np.float32),
                     (2, 1))
    return step(imgs, bounds)[0]


def _det_set(det):
    out = []
    for k in range(det.valid.shape[0]):
        v = det.valid[k]
        rows = torch.cat([det.boxes[k][v], det.scores[k][v][:, None]],
                         1).numpy()
        out.append(rows[np.lexsort(rows.T)])
    return out


def test_multiscale_weights_zero_offscale_equals_single_scale():
    det_s = _port_detect({}, 3)
    det_m = _port_detect({"multiscale": [0.5, 1.0, 1.5],
                          "multiscale_weights": [0.0, 1.0, 0.0],
                          "box_voting": 0}, 3)
    assert int(det_s.valid.sum()) > 0
    for a, b in zip(_det_set(det_s), _det_set(det_m)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_multiscale_default_box_voting_is_05():
    ms = {"multiscale": [0.5, 1.0, 1.5]}
    det_d = _port_detect(dict(ms), 7)
    det_e = _port_detect(dict(ms, box_voting=0.5), 7)
    det_0 = _port_detect(dict(ms, box_voting=0), 7)
    assert int(det_d.valid.sum()) > 0
    for a, b in zip(_det_set(det_d), _det_set(det_e)):
        np.testing.assert_array_equal(a, b)
    assert any(np.abs(a - b).max() > 1e-6
               for a, b in zip(_det_set(det_d), _det_set(det_0)))
    # single-scale stays vote-free
    for a, b in zip(_det_set(_port_detect({}, 7)),
                    _det_set(_port_detect({"box_voting": 0}, 7))):
        np.testing.assert_array_equal(a, b)


def test_multiscale_default_weights_are_offscale_08():
    det_d = _port_detect({"multiscale": [0.5, 1.0, 1.5]}, 5)
    det_e = _port_detect({"multiscale": [0.5, 1.0, 1.5],
                          "multiscale_weights": [0.8, 1.0, 0.8]}, 5)
    assert int(det_d.valid.sum()) > 0
    for a, b in zip(_det_set(det_d), _det_set(det_e)):
        np.testing.assert_array_equal(a, b)


def test_multiscale_weights_validate_length():
    cfg = DetectorConfig.from_dict(dict(
        CFG, multiscale=[0.85, 1.0, 1.15], multiscale_weights=[1.0, 1.0]))
    with pytest.raises(ValueError, match="multiscale_weights"):
        build_detect_step(cfg, model_size=SIZE, device="cpu")


def test_unknown_tta_clahe_backend_raises():
    """The reference's backend names are accepted (one path here); any
    other name is a config error."""
    cfg = DetectorConfig.from_dict(dict(CFG, tta=True,
                                        tta_clahe_backend="cuda"))
    with pytest.raises(ValueError, match="tta_clahe_backend"):
        build_detect_step(cfg, model_size=SIZE, device="cpu")


def test_vote_iou_resolution_mirrors_the_reference():
    from aerial_image_recognition_tpu.pipeline.inference import (
        _resolve_vote_iou as jax_resolve)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        _resolve_vote_iou)
    for extra in ({}, {"multiscale": [0.85, 1.0]}, {"box_voting": 0.6},
                  {"box_voting": 0}, {"box_voting": False},
                  {"box_voting": None}, {"box_voting": True},
                  {"multiscale": [1.0], "box_voting": 0}):
        assert _resolve_vote_iou(DetectorConfig(extra=dict(extra))) \
            == jax_resolve(JaxDetectorConfig(extra=dict(extra))), extra


def test_server_serves_a_tta_step():
    cfg = dict(CFG, tta=True, device_batch=MODE_BATCH)
    step = build_detect_step(DetectorConfig.from_dict(cfg),
                             batch=MODE_BATCH, model_size=SIZE, device="cpu")
    images, bounds = _tiles(MODE_BATCH)
    direct = step(images, bounds)[0]
    srv = DetectionServer(detect_step=step, max_wait_ms=5.0).start()
    try:
        buf = io.BytesIO()
        Image.fromarray(images[0]).save(buf, "PNG")
        w, s, e, n = (float(v) for v in bounds[0])
        req = urllib.request.Request(
            f"{srv.url}/detect?west={w!r}&south={s!r}&east={e!r}"
            f"&north={n!r}", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.load(r)
        assert body["count"] == int(direct.valid[0].sum()) > 0
    finally:
        srv.stop()
