"""The whole city scan: the port's ``CarDetector`` over the port's
``FakeTileServer`` against the JAX ``CarDetector`` over the JAX server.

Each package drives its own f32 step (the trained fixture
``yolov7_tiny_fakeworld.npz``, 64 px, ``quad_stem: false`` on the JAX side)
on the CPU. Held as tests/test_torch_families.py holds the port's scans:
the same record count and classes, lon/lat within 1e-6°, confidence within
1e-5; the same metadata keys, coverage layer and shapefile record count;
the checkpoint an interrupted scan leaves equals the JAX package's, a
resumed port scan ends with the uninterrupted scan's records, and a changed
grid is refused.
"""

import json
import os

import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.fetch import fake as JF
from aerial_image_recognition_tpu.fetch.xyz import XYZFetcher as JXYZ
from aerial_image_recognition_tpu.pipeline.detector import (
    CarDetector as JaxCarDetector)
from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.fetch import fake as PF
from aerial_image_recognition_tpu_torch.fetch.wms import WMSFetcher
from aerial_image_recognition_tpu_torch.fetch.xyz import XYZFetcher
from aerial_image_recognition_tpu_torch.gio.geojson import (
    read_geojson, write_geojson)
from aerial_image_recognition_tpu_torch.gio.shapefile import read_shapefile
from aerial_image_recognition_tpu_torch.pipeline.detector import CarDetector
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    build_detect_step)
from aerial_image_recognition_tpu_torch.runtime.checkpoint import (
    CheckpointManager, CheckpointState)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")
SIZE, BATCH = 64, 8
CFG = dict(dtype="float32", params_path=FIXTURE, confidence_threshold=0.3,
           nms_preselect="exact", quad_stem=False)
WORLD = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.004, n_cars=60,
             seed=11)
AOI = {"type": "FeatureCollection", "features": [{
    "type": "Feature", "properties": {},
    "geometry": {"type": "Polygon", "coordinates": [[
        [20.9985, 52.1988], [21.0015, 52.1988], [21.0015, 52.2012],
        [20.9985, 52.2012], [20.9985, 52.1988]]]},
}]}
STATE = os.path.join("output", "checkpoints",
                     "detections_processing_state.json")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def env():
    kw = dict(batch=BATCH, src_size=SIZE, model_size=SIZE)
    jsrv = JF.FakeTileServer(JF.FakeWorld(**WORLD))
    psrv = PF.FakeTileServer(PF.FakeWorld(**WORLD))
    jsrv.start()
    psrv.start()
    yield {"jax": (jax_build_detect_step(JaxDetectorConfig.from_dict(CFG),
                                         **kw), jsrv, JaxCarDetector),
           "port": (build_detect_step(DetectorConfig.from_dict(CFG),
                                      device="cpu", **kw), psrv,
                    CarDetector)}
    jsrv.stop()
    psrv.stop()


@pytest.fixture()
def pinned_xyz_window(monkeypatch):
    """Pin both packages' XYZ windows to the step's 64-px input."""
    for cls in (XYZFetcher, JXYZ):
        monkeypatch.setattr(cls, "window_px", lambda self, lat, m=None: SIZE)


def _config(base, srv, route, **over):
    frame = os.path.join(base, "aoi.geojson")
    write_geojson(AOI, frame)
    conf = {"frame_path": frame, "batch_size": 16, "device_batch": BATCH,
            "num_workers": 8, "duplicate_distance": 1.0,
            "checkpoint_interval": 10**9, "confidence_threshold": 0.3,
            "event_log": os.path.join(base, "events.jsonl")}
    if route == "xyz":
        conf.update(use_xyz=True, xyz_url=srv.xyz_template, zoom=17,
                    tile_size_meters=64.0, tile_overlap=0.2)
    else:                               # WMS at the fixture's 0.5 m/px
        conf.update(use_xyz=False, wms_url=srv.base_url + "/wms",
                    wms_layer="fake", wms_size=(SIZE, SIZE),
                    tile_size_meters=32.0, tile_overlap=0.2,
                    submit_spacing=0.0)
    conf.update(over)
    return conf


def _scan(env, pkg, base, route, step=None, expect=None, force=True,
          **over):
    s, srv, cls = env[pkg]
    os.makedirs(base, exist_ok=True)
    det = cls(base, _config(base, srv, route, **over),
              detect_step=step or s)
    if expect is not None:
        with pytest.raises(expect[0], match=expect[1]):
            det.detect(force_restart=force)
        return None
    return det.detect(force_restart=force)


def _outputs(base):
    out = os.path.join(base, "output")
    doc = read_geojson(os.path.join(out, "detections_results.geojson"))
    recs = sorted((f["geometry"]["coordinates"][0],
                   f["geometry"]["coordinates"][1],
                   f["properties"]["confidence"], f["properties"]["class"])
                  for f in doc["features"])
    cov = read_geojson(os.path.join(out, "detections_coverage.geojson"))
    shp = os.path.join(out, "detections_results.shp")
    n_shp = len(read_shapefile(shp)) if os.path.exists(shp) else 0
    return doc, recs, cov, n_shp


def _same_records(recs_p, recs_j):
    assert len(recs_p) == len(recs_j) > 0
    assert [r[3] for r in recs_p] == [r[3] for r in recs_j]
    a = np.asarray([r[:3] for r in recs_p])
    b = np.asarray([r[:3] for r in recs_j])
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-6, rtol=0)
    np.testing.assert_allclose(a[:, 2], b[:, 2], atol=1e-5, rtol=0)


@pytest.mark.parametrize("route", ["xyz", "wms"])
def test_scan_equals_jax_scan(env, tmp_path, pinned_xyz_window, route):
    outs = {pkg: _scan(env, pkg, str(tmp_path / pkg), route)
            for pkg in ("jax", "port")}
    assert outs["port"]["tiles"] == outs["jax"]["tiles"] > 20
    assert outs["port"].keys() == outs["jax"].keys()
    assert outs["port"]["detections"] == outs["jax"]["detections"]
    doc_p, recs_p, cov_p, shp_p = _outputs(str(tmp_path / "port"))
    doc_j, recs_j, cov_j, shp_j = _outputs(str(tmp_path / "jax"))
    _same_records(recs_p, recs_j)
    assert doc_p["metadata"].keys() == doc_j["metadata"].keys()
    assert doc_p["metadata"]["config"] == doc_j["metadata"]["config"]
    assert doc_p["metadata"]["ingest_stats"].keys() == \
        doc_j["metadata"]["ingest_stats"].keys()
    for k in ("batches", "tiles", "failed"):
        assert doc_p["metadata"]["ingest_stats"][k] == \
            doc_j["metadata"]["ingest_stats"][k]
    succ = [d["metadata"]["fetch_stats"]["successes"] for d in (doc_p, doc_j)]
    # one GetMap a WMS tile; XYZ fetches overlapping slippy tiles in
    # parallel, so a tile may be fetched twice before the cache holds it
    assert min(succ) > 0 and (route == "xyz" or succ[0] == succ[1])
    assert cov_p == cov_j                       # the coverage layer
    assert shp_p == shp_j == len(recs_p)
    base = str(tmp_path / "port")
    assert not os.path.exists(os.path.join(base, STATE))   # cleared
    kinds = [json.loads(line)["kind"]
             for line in open(os.path.join(base, "events.jsonl"))]
    assert "grid" in kinds and "done" in kinds


def test_scan_times_its_host_phases(env, tmp_path):
    """A port WMS scan names its host time in ``phase_timings``: the
    main thread's ingest waits, dispatches and drains, the prefetch
    thread's packing, the fetch workers' request and decode seconds
    (the scan's part of the fetcher's ``FetchStats``)."""
    s, srv, _ = env["port"]
    base = str(tmp_path)
    fetcher = WMSFetcher(srv.base_url + "/wms", "fake", size=(SIZE, SIZE),
                         num_workers=8, submit_spacing=0.0)
    try:
        det = CarDetector(base, _config(base, srv, "wms"), fetcher=fetcher,
                          detect_step=s)
        det.detect(force_restart=True)
    finally:
        fetcher.close()
    doc, _, _, _ = _outputs(base)
    phases = ("tile_request", "tile_decode", "batch_packing", "ingest_wait",
              "batch_dispatch", "result_drain")
    assert set(phases) <= doc["metadata"]["phase_timings"].keys()
    assert all(det.timers.totals[k] > 0 for k in phases)
    batches = doc["metadata"]["ingest_stats"]["batches"]
    assert batches > 1
    assert det.timers.counts["result_drain"] == batches
    assert det.timers.counts["ingest_wait"] == batches + 1
    st = fetcher.http.stats
    assert st.request_s > 0 and st.decode_s > 0
    # the capabilities request is set-up's, before the scan's deltas
    assert det.timers.totals["tile_request"] < st.request_s
    assert det.timers.totals["tile_decode"] == st.decode_s


class _Aborting:
    """Wraps a step; the ``at``-th call raises."""

    def __init__(self, step, at):
        self._step, self._at, self.calls = step, at, 0

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self, images, bounds):
        self.calls += 1
        if self.calls == self._at:
            raise RuntimeError("injected crash")
        return self._step(images, bounds)


def test_checkpoint_resume_equals_jax_and_the_uninterrupted_scan(
        env, tmp_path):
    states, dets = {}, {}
    for pkg in ("jax", "port"):
        base = str(tmp_path / pkg)
        _scan(env, pkg, base, "wms", step=_Aborting(env[pkg][0], 4),
              expect=(RuntimeError, "injected crash"),
              checkpoint_interval=16)
        states[pkg] = json.load(open(os.path.join(base, STATE)))
        dets[pkg] = sorted(
            (f["geometry"]["coordinates"][0],
             f["geometry"]["coordinates"][1],
             f["properties"]["confidence"], "car")
            for f in read_geojson(os.path.join(
                base, "output", "checkpoints",
                "detections_latest_detections.geojson"))["features"])
    for k in ("processed_count", "total_tiles", "grid_fingerprint"):
        assert states["port"][k] == states["jax"][k]
    assert 0 < states["port"]["processed_count"] \
        < states["port"]["total_tiles"]
    _same_records(dets["port"], dets["jax"])
    # resume the port's scan; it ends with the uninterrupted scan's records
    base = str(tmp_path / "port")
    s, srv, _ = env["port"]
    det = CarDetector(base, _config(base, srv, "wms",
                                    checkpoint_interval=16), detect_step=s)
    out = det.detect(force_restart=False)
    assert out["tiles"] == states["port"]["total_tiles"]
    assert not os.path.exists(os.path.join(base, STATE))
    whole = str(tmp_path / "whole")
    _scan(env, "port", whole, "wms", checkpoint_interval=16)
    _, recs_resumed, _, _ = _outputs(base)
    _, recs_whole, _, _ = _outputs(whole)
    assert recs_resumed == recs_whole


def test_resume_refuses_a_changed_grid(env, tmp_path):
    base = str(tmp_path)
    CheckpointManager(os.path.join(base, "output", "checkpoints"),
                      prefix="detections").save(CheckpointState(
                          processed_count=5, total_tiles=10, detections=[],
                          grid_fingerprint="bogus"))
    _scan(env, "port", base, "wms", expect=(RuntimeError, "grid mismatch"),
          force=False)
