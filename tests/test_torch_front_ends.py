"""The port's front ends against the JAX package's: image-file prediction
(``predict_images``, ``draw_predictions``), the resolution sweep
(``run_sweep``), the point-grid ``SimpleDetector`` and the asyncio fetch
facades, each over its own package's fake tile server where it fetches.

Tolerances: ``predict_images`` runs bf16 in both packages (the reference
hardcodes it), so their boxes are matched: ≥ 0.9 of the detections of each
at IoU ≥ 0.5, and the port's boxes land on the rendered cars as the JAX
tests require of JAX's. The sweep and ``SimpleDetector`` drive f32 steps
of the trained fixture ``yolov7_tiny_fakeworld.npz`` (96-px windows, 64-px
model): the same tile and detection counts, records within 1e-6° and 1e-5
in confidence. The facades return the fetchers' pixels unchanged
(tolerance 0).
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.fetch import fake as JF
from aerial_image_recognition_tpu.fetch.aio import (
    AsyncWMS as JaxAsyncWMS, AsyncXYZ as JaxAsyncXYZ)
from aerial_image_recognition_tpu.fetch.wms import WMSFetcher as JWMS
from aerial_image_recognition_tpu.fetch.xyz import XYZFetcher as JXYZ
from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step)
from aerial_image_recognition_tpu.pipeline.predict import (
    predict_images as jax_predict_images)
from aerial_image_recognition_tpu.pipeline.simple import (
    SimpleDetector as JaxSimpleDetector)
from aerial_image_recognition_tpu.pipeline.sweep import (
    run_sweep as jax_run_sweep)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.fetch import fake as PF
from aerial_image_recognition_tpu_torch.fetch.aio import AsyncWMS, AsyncXYZ
from aerial_image_recognition_tpu_torch.fetch.wms import WMSFetcher
from aerial_image_recognition_tpu_torch.fetch.xyz import XYZFetcher
from aerial_image_recognition_tpu_torch.gio.geojson import (
    read_geojson, write_geojson)
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    build_detect_step)
from aerial_image_recognition_tpu_torch.pipeline.predict import (
    _load_rgb, draw_predictions, predict_images)
from aerial_image_recognition_tpu_torch.pipeline.simple import SimpleDetector
from aerial_image_recognition_tpu_torch.pipeline.sweep import run_sweep
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from test_predict_val import (
    SIZE as PRED_SIZE, WORLD as PRED_WORLD, _bbox, _dense_center,
    _gt_boxes_xyxy, _match_stats, _save)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")
CFG = dict(dtype="float32", params_path=FIXTURE, confidence_threshold=0.3,
           nms_preselect="exact", quad_stem=False)
WINDOW, MODEL, BATCH = 96, 64, 8
WORLD = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.004, n_cars=200,
             seed=3)
AOI = {"type": "FeatureCollection", "features": [{
    "type": "Feature", "properties": {},
    "geometry": {"type": "Polygon", "coordinates": [[
        [20.9988, 52.1988], [21.0012, 52.1988], [21.0012, 52.2012],
        [20.9988, 52.2012], [20.9988, 52.1988]]]}}]}

torch.set_num_threads(2)


# ------------------------------------------------------------- predict

def _iou(a, b):
    """IoU matrix of xyxy boxes a [N,4] and b [M,4]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=2)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], axis=1)
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def _matched(p, j):
    """Fractions of p's and of j's boxes with an IoU ≥ 0.5 partner of the
    same class in the other set."""
    if not len(p.boxes_xyxy) or not len(j.boxes_xyxy):
        return float(len(p.boxes_xyxy) == len(j.boxes_xyxy)), 1.0
    iou = _iou(p.boxes_xyxy, j.boxes_xyxy) \
        * (p.classes[:, None] == j.classes[None])
    return float((iou.max(1) >= 0.5).mean()), float((iou.max(0) >= 0.5).mean())


@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    """Four crops of the trained world at its 0.5 m/px: a dense 96-px tile
    as PNG and as JPEG, the same tile rendered at 192 px (to be resized to
    96 and mapped back), and a ragged 150×110 crop."""
    d = tmp_path_factory.mktemp("crops")
    clon, clat = _dense_center()
    bbox = _bbox(clon, clat)
    paths = []
    for name, (w, h) in (("tile.png", (96, 96)), ("tile.jpg", (96, 96)),
                         ("tile192.png", (192, 192)),
                         ("ragged.png", (150, 110))):
        p = str(d / name)
        _save(PRED_WORLD.render(bbox, w, h), p)
        paths.append(p)
    return dict(paths=paths, bbox=bbox)


def test_predict_images_equals_jax(crops):
    kw = dict(params=FIXTURE, imgsz=PRED_SIZE, confidence=0.4)
    got = predict_images(crops["paths"], device="cpu", **kw)
    want = jax_predict_images(crops["paths"], **kw)
    assert [(p.path, p.width, p.height) for p in got] == \
        [(j.path, j.width, j.height) for j in want]
    n = 0
    for p, j in zip(got, want):
        assert tuple(p.class_names) == tuple(j.class_names) == ("car",)
        fp, fj = _matched(p, j)
        assert fp >= 0.9 and fj >= 0.9, (p.path, fp, fj)
        n += len(p.boxes_xyxy)
        assert p.to_json().keys() == j.to_json().keys()
    assert n >= 8
    # the boxes land on the rendered cars, in each image's own pixels
    gt = _gt_boxes_xyxy(crops["bbox"], PRED_SIZE)
    recall, precise = _match_stats(got[0].boxes_xyxy, gt, tol_px=4.0)
    assert recall >= 0.8 and precise
    gt192 = _gt_boxes_xyxy(crops["bbox"], 192)
    assert got[2].width == 192
    recall, precise = _match_stats(got[2].boxes_xyxy, gt192, tol_px=8.0)
    assert recall >= 0.7 and precise


def test_predict_last_short_chunk_gets_full_chunk_results(crops):
    """Chunks of 3: the fourth image alone in the last chunk gets what it
    gets inside a full chunk (tolerance 0), and the first three what they
    get in one chunk of all four."""
    kw = dict(params=FIXTURE, imgsz=PRED_SIZE, confidence=0.4, device="cpu")
    paths = crops["paths"]
    split = predict_images(paths, batch=3, **kw)
    whole = predict_images(paths, batch=4, **kw)
    moved = predict_images(paths[3:] + paths[:2], batch=3, **kw)
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a.boxes_xyxy, b.boxes_xyxy)
        np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(split[3].boxes_xyxy, moved[0].boxes_xyxy)
    assert len(split[3].boxes_xyxy) > 0


def test_draw_predictions_writes_an_annotated_copy(crops, tmp_path):
    (pred,) = predict_images(crops["paths"][:1], params=FIXTURE,
                             imgsz=PRED_SIZE, confidence=0.4, device="cpu")
    assert len(pred.boxes_xyxy)
    out = str(tmp_path / "ann.png")
    draw_predictions(pred, out)
    drawn, orig = _load_rgb(out), _load_rgb(pred.path)
    assert drawn.shape == orig.shape and not np.array_equal(drawn, orig)


# ----------------------------------------------------- sweep and simple

@pytest.fixture(scope="module")
def env():
    kw = dict(batch=BATCH, src_size=WINDOW, model_size=MODEL)
    jsrv = JF.FakeTileServer(JF.FakeWorld(**WORLD))
    psrv = PF.FakeTileServer(PF.FakeWorld(**WORLD))
    jsrv.start()
    psrv.start()
    yield {"jax": dict(step=jax_build_detect_step(
                           JaxDetectorConfig.from_dict(CFG), **kw),
                       srv=jsrv, xyz=JXYZ),
           "port": dict(step=build_detect_step(
                            DetectorConfig.from_dict(CFG), device="cpu",
                            **kw),
                        srv=psrv, xyz=XYZFetcher)}
    jsrv.stop()
    psrv.stop()


@pytest.fixture()
def pinned_window(monkeypatch):
    for cls in (XYZFetcher, JXYZ):
        monkeypatch.setattr(cls, "window_px",
                            lambda self, lat, m=None: WINDOW)


def _fetcher(e):
    return e["xyz"](e["srv"].xyz_template, zoom=18, num_workers=8,
                    subdomains=("",))


def _features(path):
    doc = read_geojson(path)
    return doc, sorted((f["geometry"]["coordinates"][0],
                        f["geometry"]["coordinates"][1],
                        f["properties"]["confidence"])
                       for f in doc["features"])


def _same(recs_p, recs_j):
    assert len(recs_p) == len(recs_j) > 0
    a, b = np.asarray(recs_p), np.asarray(recs_j)
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=1e-6, rtol=0)
    np.testing.assert_allclose(a[:, 2], b[:, 2], atol=1e-5, rtol=0)


def test_run_sweep_equals_jax(env, tmp_path, pinned_window):
    out = {}
    for pkg, sweep in (("jax", jax_run_sweep), ("port", run_sweep)):
        base = str(tmp_path / pkg)
        os.makedirs(base)
        frame = os.path.join(base, "aoi.geojson")
        write_geojson(AOI, frame)
        fetcher = _fetcher(env[pkg])
        out[pkg] = sweep(base, {"frame_path": frame, "use_xyz": True,
                                "xyz_url": env[pkg]["srv"].xyz_template,
                                "batch_size": 16, "device_batch": BATCH,
                                "checkpoint_interval": 10**9},
                         tile_sizes=(100.0, 50.0), fetcher=fetcher,
                         detect_step=env[pkg]["step"])
        fetcher.close()
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in out["port"]]
    assert strip == [{k: v for k, v in r.items() if k != "wall_s"}
                     for r in out["jax"]]
    assert all("error" not in r for r in out["port"])
    assert out["port"][1]["tiles"] > out["port"][0]["tiles"]
    assert out["port"][0]["cm_per_px"] == pytest.approx(15.62, abs=0.01)
    for size in ("100m", "50m"):
        name = os.path.join("output", f"detections_{size}_results.geojson")
        _, recs_p = _features(str(tmp_path / "port" / name))
        _, recs_j = _features(str(tmp_path / "jax" / name))
        _same(recs_p, recs_j)


class _FailsOnce:
    """The port's step, except that its first call raises."""

    def __init__(self, step):
        self._step, self.calls = step, 0

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self, *args):
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("the card went away")
        return self._step(*args)


def test_run_sweep_records_a_failing_configuration(env, tmp_path,
                                                   pinned_window):
    """One configuration's error during its scan is recorded in its entry
    and the sweep goes on (the reference's contract)."""
    frame = str(tmp_path / "aoi.geojson")
    write_geojson(AOI, frame)
    fetcher = _fetcher(env["port"])
    out = run_sweep(str(tmp_path), {"frame_path": frame, "use_xyz": True,
                                    "xyz_url": env["port"]["srv"].xyz_template,
                                    "batch_size": 16, "device_batch": BATCH,
                                    "checkpoint_interval": 10**9},
                    tile_sizes=(100.0, 50.0), fetcher=fetcher,
                    detect_step=_FailsOnce(env["port"]["step"]))
    fetcher.close()
    assert set(out[0]) == {"tile_size_m", "error"}
    assert "the card went away" in out[0]["error"]
    assert "error" not in out[1] and out[1]["tiles"] > 0


def _simple(env, pkg, out_dir):
    cls = SimpleDetector if pkg == "port" else JaxSimpleDetector
    return cls("yolov7_itcvd", out_dir, xyz_url=env[pkg]["srv"].xyz_template,
               zoom=18, detect_step=env[pkg]["step"], num_workers=8,
               fetcher=_fetcher(env[pkg]))


def test_simple_detector_run_equals_jax(env, tmp_path, pinned_window):
    frame = str(tmp_path / "aoi.geojson")
    write_geojson(AOI, frame)
    outs, docs = {}, {}
    for pkg in ("jax", "port"):
        det = _simple(env, pkg, str(tmp_path / pkg))
        outs[pkg] = det.run(frame, spacing_meters=30.0, batch_size=8,
                            force_restart=True)
        docs[pkg] = _features(outs[pkg]["output"])
        det.close()
    assert outs["port"]["points"] == outs["jax"]["points"] >= 9
    assert outs["port"]["detections"] == outs["jax"]["detections"]
    _same(docs["port"][1], docs["jax"][1])
    meta_p, meta_j = docs["port"][0]["metadata"], docs["jax"][0]["metadata"]
    assert meta_p["grid_points"] == meta_j["grid_points"]
    assert meta_p.keys() == meta_j.keys()


def test_simple_detector_get_image_and_process_batch_equal_jax(
        env, tmp_path, pinned_window):
    dets = {pkg: _simple(env, pkg, str(tmp_path / pkg))
            for pkg in ("jax", "port")}
    img_p, prev_p, b_p = dets["port"].get_image(52.2, 21.0)
    img_j, prev_j, b_j = dets["jax"].get_image(52.2, 21.0)
    np.testing.assert_array_equal(img_p, img_j)
    assert prev_p == prev_j and b_p == b_j
    assert prev_p["image_info"]["crop_size"] == img_p.shape[0] == WINDOW
    points = [(52.2 + 0.0003 * i, 21.0 + 0.0004 * j)
              for i in range(-2, 3) for j in range(-1, 2)]
    recs, covs = {}, {}
    for pkg, det in dets.items():
        found, covs[pkg], timing = det.process_batch(points,
                                                     window_px=WINDOW)
        assert set(timing) == {"tile_fetching", "inference"}
        recs[pkg] = sorted((r["lon"], r["lat"], r["confidence"])
                           for r in found)
        det.close()
    assert covs["port"] == covs["jax"] and len(covs["port"]) == len(points)
    _same(recs["port"], recs["jax"])


# ------------------------------------------------------------- asyncio

def test_async_facades_equal_jax(env):
    async def run(xyz, wms):
        img = await xyz.get_image(52.2, 21.0, window_px=WINDOW)
        tiles = await xyz.fetch_batch([(20.9995, 52.1995, 21.0005, 52.2005),
                                       (21.0, 52.2, 21.001, 52.201)],
                                      window_px=WINDOW)
        batch = await wms.fetch_batch([(20.999, 52.199, 21.0, 52.2)] * 3)
        single = await wms.get_single_image((21.0, 52.2, 21.001, 52.201))
        return [img] + tiles + batch + [single]

    got = {}
    for pkg, (axyz, awms, wms_cls) in (
            ("port", (AsyncXYZ, AsyncWMS, WMSFetcher)),
            ("jax", (JaxAsyncXYZ, JaxAsyncWMS, JWMS))):
        srv = env[pkg]["srv"]
        xyz = axyz(_fetcher(env[pkg]))
        wms = awms(wms_cls(srv.base_url + "/wms", layer="f", size=(64, 64),
                           num_workers=4, submit_spacing=0.0))
        got[pkg] = asyncio.run(run(xyz, wms))
        xyz.fetcher.close()
        wms.fetcher.close()
    assert len(got["port"]) == 7 and all(t is not None for t in got["port"])
    for p, j in zip(got["port"], got["jax"]):
        assert p.pixels.dtype == np.uint8
        np.testing.assert_array_equal(p.pixels, j.pixels)
        assert p.bounds == pytest.approx(j.bounds, abs=0, rel=0)
