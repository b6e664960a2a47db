"""The port's whole detect step against the JAX step, then driven by the
JAX CarDetector city scan and by the port's DetectionServer.

f32 on the CPU, 64-px model on the trained fixture. Tolerances: valid slots
identical, boxes within 1e-3 px, scores within 1e-5, lon/lat within 1e-6°.
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


def _tiles():
    """BATCH 64-px tiles at the fixture's training scale (0.5 m/px) around
    FakeWorld cars, + their bounds."""
    world = FakeWorld(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                      n_cars=500, seed=9)
    tiles, bounds = [], []
    for k in range(BATCH):
        lon, lat, _ = world.cars[k * 11]
        bbox = (lon - 15.0 * M2LON, lat - 17.0 * M2LAT,
                lon + 17.0 * M2LON, lat + 15.0 * M2LAT)
        tiles.append(world.render(bbox, SIZE, SIZE))
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


def _scan(tmp_path, server, step, monkeypatch):
    from aerial_image_recognition_tpu.fetch.xyz import XYZFetcher
    monkeypatch.setattr(XYZFetcher, "window_px",
                        lambda self, lat, m=None: SIZE)
    base = str(tmp_path)
    frame = os.path.join(base, "aoi.geojson")
    write_geojson(AOI, frame)
    det = CarDetector(base, {
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
    srv.start()
    try:
        out_j, recs_j = _scan(tmp_path / "jax", srv, jax_step, monkeypatch)
        out_p, recs_p = _scan(tmp_path / "port", srv, port_step, monkeypatch)
    finally:
        srv.stop()
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
