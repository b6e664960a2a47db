"""Data parallelism in the port (``parallel/``, the data-parallel detect
step, ``dedup_device``, the halo stripe dedup) against the JAX package.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py), the
port on ``Mesh([cpu] * 8)`` unless a case says otherwise; inputs are
seeded numpy. Tolerances are the JAX package's own tests'
(tests/test_parallel.py, test_int8.py, test_pipeline_e2e.py) for a mesh
against one device, and the port's step tests' (tests/test_torch_step.py:
valid and classes equal, boxes within 1e-3 px, scores within 1e-5, lon/lat
within 1e-6°) for the port against the JAX package. The stripe helpers and
``pad_to_multiple`` are bit-equal copies, and the dedups keep the same
sets, exact ties included.
"""

import io
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aerial_image_recognition_tpu.parallel import mesh as JM
from aerial_image_recognition_tpu.parallel import stripes as JS
from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step)
from aerial_image_recognition_tpu.post.dedup import (
    dedup_device as jax_dedup_device)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.geo.tmerc import (
    tm_forward, tm_inverse)
from aerial_image_recognition_tpu_torch.ingest.pipeline import (
    assemble_batches, run_pipeline)
from aerial_image_recognition_tpu_torch.fetch.xyz import TileImage
from aerial_image_recognition_tpu_torch.parallel import mesh as PM
from aerial_image_recognition_tpu_torch.parallel import stripes as PS
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    SelfQuantizingStep, build_detect_step, detection_sets_agree)
from aerial_image_recognition_tpu_torch.pipeline.serve import DetectionServer
from aerial_image_recognition_tpu_torch.post.dedup import (
    dedup_device, dedup_host)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from test_torch_step import CFG, SIZE, _tiles

BOUNDS = (20.98, 52.19, 21.02, 52.21)
CPU8 = PM.Mesh([torch.device("cpu")] * 8)

torch.set_num_threads(2)


# ------------------------------------------------------------- the mesh

def test_cpu_mesh_mirrors_the_virtual_devices():
    assert CPU8.shape == JM.make_mesh().shape == {"data": 8}
    assert CPU8.local_size == CPU8.size == 8 and CPU8.process_count == 1
    assert CPU8.distinct_devices == (torch.device("cpu"),)
    assert CPU8.rows(16)[3] == (torch.device("cpu"), 6, 8)
    with pytest.raises(ValueError, match="mesh"):
        CPU8.rows(6)


def test_shard_batch_and_replicate():
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    parts = PM.shard_batch(CPU8, x)
    assert len(parts) == 8 and all(p.shape == (2, 4) for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    a, b = PM.shard_batch(CPU8, x, x[:, :1])
    assert len(a) == len(b) == 8 and b[0].shape == (2, 1)
    tree = {"w": torch.ones(3), "l": [torch.zeros(2)], "n": 1}
    rep = PM.replicate(CPU8, tree)
    assert list(rep) == [torch.device("cpu")]
    assert rep[torch.device("cpu")]["w"] is tree["w"]


@pytest.mark.parametrize("shape,multiple,axis,fill", [
    ((13, 2), 8, 0, 0), ((16, 3), 8, 0, 0), ((5, 7), 4, 1, -1),
    ((1,), 3, 0, 7), ((0, 2), 8, 0, 0)])
def test_pad_to_multiple_equals_jax(shape, multiple, axis, fill):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    got, n = PM.pad_to_multiple(x, multiple, axis, fill)
    want, m = JM.pad_to_multiple(x, multiple, axis, fill)
    assert n == m and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_entry_points_pin_the_callers_card(monkeypatch):
    """A process that drives card 1 (``initialize`` makes a process's card
    current in its main thread) and builds with the default device: the
    device it resolves names card 1, so that the threads that use it (the
    server's batch thread, the device monitor's) stay there. CUDA's
    current card belongs to the thread and a new thread starts on card 0,
    which the stand-in ``current_device`` mirrors."""
    import threading
    import time
    from aerial_image_recognition_tpu_torch.runtime import device as RD
    from aerial_image_recognition_tpu_torch.runtime.observability import (
        DeviceMonitor)
    main = threading.main_thread()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: int(
        threading.current_thread() is main))
    asked = []
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: asked.append(dev) or (1, 2))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "card")
    card = torch.device("cuda", 1)
    assert RD.resolve_device() == RD.resolve_device("cuda") == card
    assert RD.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert RD.resolve_device("cpu") == torch.device("cpu")
    # CarDetector gives its monitor the resolved device; the monitor
    # samples from its own thread
    mon = DeviceMonitor(interval=0.01, device=RD.resolve_device(),
                        print_line=False)
    mon.start()
    try:
        deadline = time.monotonic() + 5.0
        while not asked and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        mon.stop()
    assert asked and all(torch.device(d) == card for d in asked), asked


def test_mesh_flags_never_repeat_a_card(monkeypatch):
    assert PM.mesh_from_flag(None) is None and PM.mesh_from_flag(0) is None
    assert PM.mesh_from_flag(False, "cpu") is None
    assert PM.mesh_from_flag(3, "cpu").devices == (torch.device("cpu"),) * 3
    assert PM.mesh_from_flag(True, "cpu").size == 1
    with pytest.raises(RuntimeError, match="no CUDA"):
        PM.make_mesh()
    # with two cards visible: the first n, truncating silently past them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert list(PM.make_mesh().devices) == cards
    assert list(PM.make_mesh(1).devices) == cards[:1]
    assert list(PM.make_mesh(8).devices) == cards
    assert list(PM.mesh_from_flag(True, "cuda").devices) == cards
    assert list(PM.mesh_from_flag(5).devices) == cards
    # under a process group a process drives one device, its current card
    group = object()
    monkeypatch.setattr(PM, "_default_group", lambda: group)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    for mesh in (PM.make_mesh(), PM.make_mesh(2), PM.mesh_from_flag(True),
                 PM.mesh_from_flag(4, "cuda:1")):
        assert list(mesh.devices) == cards[1:] and mesh.group is group
    for dp in (True, 1, 3):
        mesh = PM.mesh_from_flag(dp, "cpu")
        assert mesh.devices == (torch.device("cpu"),) and mesh.group is group


# --------------------------------------------------------- the stripes

@pytest.mark.parametrize("n,halo", [(1, 64.0), (2, 0.0), (4, 32.0),
                                    (8, 2.0), (3, 100.0)])
def test_stripes_bit_equal_jax(n, halo):
    got, p_got, (lo, hi) = PS.split_aoi_stripes(BOUNDS, n, halo_m=halo)
    want, p_want, (jlo, jhi) = JS.split_aoi_stripes(BOUNDS, n, halo_m=halo)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    x = np.concatenate([lo - 1.0, lo, lo + 0.5, hi, [lo[0] - 1e6,
                                                     hi[-1] + 1e6]])
    np.testing.assert_array_equal(PS.assign_to_stripes(x, (lo, hi), n),
                                  JS.assign_to_stripes(x, (jlo, jhi), n))


# ---------------------------------------------------------- dedup_device

def _dedup_case(kind, n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random(n) * 60).astype(np.float32)
    y = (rng.random(n) * 60).astype(np.float32)
    conf = rng.random(n).astype(np.float32)
    tie = rng.permutation(n).astype(np.int32)
    if kind == "ties":          # confidences on a coarse grid: many ties
        conf = (np.round(conf * 8) / 8).astype(np.float32)
    elif kind == "empty":       # a third of the slots unused
        conf[::3] = -np.inf
        x[::3] = y[::3] = 1e9
    elif kind == "all-empty":
        conf[:] = -np.inf
    return x, y, conf, tie


@pytest.mark.parametrize("tied", [False, True], ids=["no-tie-id", "tie-id"])
@pytest.mark.parametrize("kind", ["random", "ties", "empty", "all-empty"])
def test_dedup_device_equals_jax(kind, tied):
    x, y, conf, tie = _dedup_case(kind)
    rounds = len(x) + 20                  # past the last pick: −inf rounds
    tie_p = torch.from_numpy(tie) if tied else None
    idx, kc, valid = dedup_device(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(conf), 2.0, rounds,
                                  tie_id=tie_p)
    jidx, jkc, jvalid = jax_dedup_device(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(conf), 2.0, rounds,
        tie_id=jnp.asarray(tie) if tied else None)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(kc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    if kind != "all-empty" and not tied:
        # and the set is the exact host dedup's (f32 meters: no pair sits
        # on the radius in these seeds)
        keep = np.zeros(len(x), bool)
        keep[idx.numpy()[valid.numpy()]] = True
        ref = np.zeros(len(x), bool)
        for i in np.argsort(-conf, kind="stable"):
            if np.isfinite(conf[i]) and all(
                    (x[i] - x[j]) ** 2 + (y[i] - y[j]) ** 2 > 4.0
                    for j in np.where(ref)[0]):
                ref[i] = True
        np.testing.assert_array_equal(keep, ref)


# ----------------------------------------------------- the halo dedup

def _border_set(n_shards=8, seed=5, n=600):
    rng = np.random.default_rng(seed)
    lon = BOUNDS[0] + rng.random(n) * (BOUNDS[2] - BOUNDS[0])
    lat = BOUNDS[1] + rng.random(n) * (BOUNDS[3] - BOUNDS[1])
    _, p, (lo, _) = PS.split_aoi_stripes(BOUNDS, n_shards, halo_m=0.0)
    uy = tm_forward(21.0, 52.2, p)[1]
    extra = [tm_inverse(edge + dx, uy, p) for edge in lo[1:]
             for dx in (-1.35, -0.45, 0.45, 1.35)]
    lon = np.concatenate([lon, [float(e[0]) for e in extra]])
    lat = np.concatenate([lat, [float(e[1]) for e in extra]])
    conf = rng.random(len(lon)) * 0.7 + 0.3
    return lon, lat, conf


@pytest.mark.parametrize("n_shards", [8, 3, 1])
def test_halo_dedup_equals_jax_and_host(n_shards):
    """The sharded halo dedup keeps the exact host dedup's set (clusters
    straddling the stripe borders included), as the JAX package's does
    (tests/test_parallel.py::test_halo_dedup_matches_host_dedup)."""
    lon, lat, conf = _border_set()
    klon, klat, kconf = PS.halo_dedup_host(
        lon, lat, conf, BOUNDS, PM.Mesh(["cpu"] * n_shards), radius_m=2.0,
        k_slots=640 if n_shards == 1 else 256)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n_shards]),
                              ("data",))
    jlon, jlat, jconf = JS.halo_dedup_host(
        lon, lat, conf, BOUNDS, jmesh, radius_m=2.0,
        k_slots=640 if n_shards == 1 else 256)
    keep = dedup_host(lon, lat, conf, radius_m=2.0)
    assert len(kconf) == len(jconf) == keep.sum()
    np.testing.assert_allclose(np.sort(kconf), np.sort(conf[keep]),
                               rtol=1e-6)
    order_p, order_j = np.argsort(kconf), np.argsort(np.asarray(jconf))
    np.testing.assert_array_equal(kconf[order_p], np.asarray(jconf)[order_j])
    np.testing.assert_array_equal(klon[order_p], np.asarray(jlon)[order_j])
    np.testing.assert_array_equal(klat[order_p], np.asarray(jlat)[order_j])


def test_halo_dedup_exact_tie_across_border():
    """Equal-confidence pairs 1 m apart across each interior border keep
    one survivor each (the global slot ids), as the JAX package's
    (tests/test_parallel.py::test_halo_dedup_exact_tie_across_border)."""
    _, p, (lo, _) = PS.split_aoi_stripes(BOUNDS, 8, halo_m=0.0)
    uy = tm_forward(21.0, 52.2, p)[1]
    pts = [tm_inverse(edge + dx, uy, p) for edge in lo[1:]
           for dx in (-0.5, 0.5)]
    lon = np.asarray([float(q[0]) for q in pts])
    lat = np.asarray([float(q[1]) for q in pts])
    conf = np.full(len(lon), 0.5, np.float32)
    _, _, kconf = PS.halo_dedup_host(lon, lat, conf, BOUNDS, CPU8,
                                     radius_m=2.0, k_slots=64)
    _, _, jconf = JS.halo_dedup_host(lon, lat, conf, BOUNDS, JM.make_mesh(),
                                     radius_m=2.0, k_slots=64)
    assert len(kconf) == len(jconf) == len(lo) - 1


def test_halo_dedup_refuses_overflow():
    lon, lat, conf = _border_set(n=100)
    with pytest.raises(ValueError, match="k_slots"):
        PS.halo_dedup_host(lon, lat, conf, BOUNDS, CPU8, radius_m=2.0,
                           k_slots=4)


# ------------------------------------------------ the detect step, DP

@pytest.fixture(scope="module")
def dp_steps():
    cfg = DetectorConfig.from_dict(CFG)
    single = build_detect_step(cfg, batch=8, model_size=SIZE, device="cpu")
    dp = build_detect_step(cfg, batch=8, model_size=SIZE, mesh=CPU8)
    jdp = jax_build_detect_step(JaxDetectorConfig.from_dict(CFG), batch=8,
                                src_size=SIZE, model_size=SIZE,
                                mesh=JM.make_mesh())
    return single, dp, jdp


def test_dp_step_equals_single_device_and_jax(dp_steps):
    single, dp, jdp = dp_steps
    assert dp.input_shardings == CPU8.rows(8)
    assert jdp.input_shardings is not None
    assert (dp.batch, dp.input_size, dp.model_size) == (8, SIZE, SIZE)
    images, bounds = _tiles()
    det_s, lon_s, lat_s = single(images, bounds)
    det_d, lon_d, lat_d = dp(images, bounds)
    jdet, jlon, jlat = jdp(images, bounds)
    valid = det_s.valid.numpy()
    assert valid.sum() >= 8
    # one device against eight (tests/test_parallel.py's bars)
    np.testing.assert_array_equal(det_d.valid.numpy(), valid)
    np.testing.assert_allclose(det_d.boxes.numpy(), det_s.boxes.numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(lon_d.numpy(), lon_s.numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(lat_d.numpy(), lat_s.numpy(), rtol=0,
                               atol=1e-7)
    # the port's DP step against the JAX package's (test_torch_step's bars)
    np.testing.assert_array_equal(det_d.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(det_d.classes.numpy(),
                                  np.asarray(jdet.classes))
    np.testing.assert_allclose(det_d.boxes.numpy(), np.asarray(jdet.boxes),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(det_d.scores.numpy(), np.asarray(jdet.scores),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(lon_d.numpy()[valid], np.asarray(jlon)[valid],
                               atol=1e-6, rtol=0)
    # per-shard tensors (what the upload ring hands the step) give the same
    parts = [torch.from_numpy(images[lo:hi]) for _, lo, hi in CPU8.rows(8)]
    bparts = [torch.from_numpy(bounds[lo:hi]) for _, lo, hi in CPU8.rows(8)]
    det_p, lon_p, _ = dp(parts, bparts)
    assert torch.equal(det_p.boxes, det_d.boxes)
    assert torch.equal(lon_p, lon_d)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_over_fewer_shards(dp_steps, n):
    single, _, _ = dp_steps
    dp = build_detect_step(DetectorConfig.from_dict(CFG), batch=8,
                           model_size=SIZE, mesh=PM.Mesh(["cpu"] * n))
    images, bounds = _tiles()
    want, got = single(images, bounds), dp(images, bounds)
    for a, b in zip(want[0], got[0]):
        assert torch.equal(a, b)
    assert torch.equal(want[1], got[1]) and torch.equal(want[2], got[2])


def test_dp_step_rejects_ragged_batch():
    with pytest.raises(ValueError, match="mesh"):
        build_detect_step(DetectorConfig(), batch=6, mesh=CPU8)
    with pytest.raises(ValueError, match="mesh"):
        build_detect_step(DetectorConfig(extra={"quantize": "int8"}),
                          batch=6, mesh=CPU8)


def test_dp_step_through_run_pipeline(dp_steps):
    """The ingest plane drives the DP step, and its per-tile outputs equal
    the single-device step's (tests/test_parallel.py::
    test_dp_step_through_run_pipeline)."""
    single, dp, _ = dp_steps
    images, _ = _tiles(12)
    tiles = [(i, TileImage(pixels=images[i],
                           bounds=(20.99, 52.21, 21.0, 52.22)))
             for i in range(12)]
    got = []
    stats = run_pipeline(
        assemble_batches(iter(tiles), batch_size=8, src_size=SIZE), dp,
        lambda b, o: got.append((b, o)))
    assert stats["batches"] == 2 and stats["tiles"] == 12
    for b, (det, lon, lat) in got:
        det_r, lon_r, lat_r = single(b.images, b.bounds)
        assert torch.equal(det_r.valid, det.valid)
        np.testing.assert_allclose(lon.numpy(), lon_r.numpy(), rtol=0,
                                   atol=1e-7)


def test_city_scan_with_data_parallel_equals_jax(tmp_path, monkeypatch):
    """``CarDetector`` with ``data_parallel`` builds its own DP step (the
    port on 8 CPU shards, the JAX package on its 8 virtual devices); the
    scans' records agree (tests/test_pipeline_e2e.py::
    test_full_scan_data_parallel_matches_single_device, and the port's
    scan bars: lon/lat within 1e-6°, confidence within 1e-5)."""
    from aerial_image_recognition_tpu.fetch import fake as JF
    from aerial_image_recognition_tpu.pipeline.detector import (
        CarDetector as JaxCarDetector)
    from aerial_image_recognition_tpu_torch.fetch import fake as PF
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    import test_torch_pipeline_e2e as E

    conf = dict(CFG, model_input_size=[SIZE, SIZE])
    outs, steps = {}, {}
    for pkg, fake, cls, dp in (("port", PF, CarDetector, 8),
                               ("jax", JF, JaxCarDetector, True)):
        srv = fake.FakeTileServer(fake.FakeWorld(**E.WORLD))
        srv.start()
        try:
            base = str(tmp_path / pkg)
            os.makedirs(base)
            kw = {"device": "cpu"} if pkg == "port" else {}
            det = cls(base, E._config(base, srv, "wms", data_parallel=dp,
                                      **conf), **kw)
            outs[pkg] = det.detect(force_restart=True)
            steps[pkg] = det.last_step
        finally:
            srv.stop()
    assert steps["port"].input_shardings == CPU8.rows(E.BATCH)
    assert steps["jax"].input_shardings is not None
    assert outs["port"]["tiles"] == outs["jax"]["tiles"] > 20
    _, recs_p, _, _ = E._outputs(str(tmp_path / "port"))
    _, recs_j, _, _ = E._outputs(str(tmp_path / "jax"))
    E._same_records(recs_p, recs_j)


# ------------------------------------------------------- int8 under a mesh

def test_int8_dp_step_equals_single_device():
    """A calibrated int8 step over 8 shards reproduces the single-device
    int8 step (tests/test_int8.py::
    test_int8_data_parallel_matches_single_device: valid equal, lon within
    1e-12, scores rtol 1e-6): each shard runs the int8 trunk and the
    epilogue on its own replica."""
    from aerial_image_recognition_tpu_torch.models.int8 import (
        Int8Bundle, quantize_bundle)
    from test_torch_int8 import SIZE as QSIZE, scene_tiles
    tiles = scene_tiles()[:8]
    cfg = DetectorConfig.from_dict(dict(CFG, confidence_threshold=0.4))
    base = build_detect_step(cfg, batch=8, model_size=QSIZE, device="cpu")
    qb = quantize_bundle(base.bundle, [tiles], model_size=QSIZE)
    one = build_detect_step(cfg, batch=8, bundle=qb, model_size=QSIZE,
                            device="cpu")
    many = build_detect_step(cfg, batch=8, bundle=qb, model_size=QSIZE,
                             mesh=CPU8)
    assert isinstance(many.bundle, Int8Bundle)
    bounds = np.tile(np.asarray([[20.999, 52.199, 21.001, 52.201]],
                                np.float32), (8, 1))
    det_1, lon_1, _ = one(tiles, bounds)
    det_n, lon_n, _ = many(tiles, bounds)
    assert int(det_1.valid.sum()) >= 8
    np.testing.assert_array_equal(det_n.valid.numpy(), det_1.valid.numpy())
    np.testing.assert_allclose(lon_n.numpy(), lon_1.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(det_n.scores.numpy(), det_1.scores.numpy(),
                               rtol=1e-6)
    # a replica on another device carries the int8 graph's tensors alone
    rep = qb.to("cpu")
    assert rep.module is not qb.module and rep.params is qb.params
    assert rep.q["convs"].keys() == qb.q["convs"].keys()


def test_int8_self_calibration_on_dp_mesh(tmp_path):
    """Turnkey int8 under the mesh (tests/test_int8.py::
    test_int8_self_calibration_on_dp_mesh): calibration reads the sharded
    batch, the int8 rebuild keeps the mesh, and post-swap sharded batches
    match the float DP step; the port's DP int8 step matches the JAX
    package's DP int8 step built from the same calibration file."""
    from aerial_image_recognition_tpu_torch.models.int8 import save_absmax
    from test_torch_int8 import SIZE as QSIZE, scene_tiles
    tiles = scene_tiles()
    bnds = np.tile(np.asarray([[20.999, 52.199, 21.001, 52.201]],
                              np.float32), (8, 1))
    cfg = DetectorConfig.from_dict(dict(
        CFG, confidence_threshold=0.4, quantize="int8",
        quantize_calib_batches=1))
    step = build_detect_step(cfg, batch=8, model_size=QSIZE, mesh=CPU8)
    assert isinstance(step, SelfQuantizingStep)
    assert step.input_shardings is not None
    imgs, bds = step.place(tiles[:8], bnds)          # per-shard tensors
    assert len(imgs) == 8
    step(imgs, bds)
    assert step.quantize_state == "int8", step.fallback_reason
    assert step.parity["total_a"] >= 1 and step.parity["matched"] >= 1
    assert type(step.bundle).__name__ == "Int8Bundle"
    assert step.input_shardings == CPU8.rows(8)      # rebuild kept the mesh
    out_q = step(tiles[4:12], bnds)
    out_f = step.base_step(tiles[4:12], bnds)
    ok, stats = detection_sets_agree(out_f, out_q)
    assert ok and stats["matched"] >= 1, stats
    # against the JAX package's DP int8 step from the same calibration
    path = str(tmp_path / "absmax.json")
    save_absmax(path, step.bundle.absmax)
    extra = dict(CFG, confidence_threshold=0.4, quantize="int8",
                 quantize_calib=path)
    jstep = jax_build_detect_step(JaxDetectorConfig.from_dict(extra),
                                  batch=8, model_size=QSIZE,
                                  mesh=JM.make_mesh())
    jout = jstep(tiles[4:12], bnds)
    ok, stats = detection_sets_agree(out_q, jout, min_match_frac=1.0)
    assert ok and stats["total_a"] == stats["total_b"] == stats["matched"] \
        >= 8, stats


# ---------------------------------------------------------- the server

def test_server_with_data_parallel_answers_as_single_device():
    """``DetectionServer({"data_parallel": 2}, device="cpu")`` builds a
    two-shard step and answers every request as the single-device server
    does."""
    images, bounds = _tiles()
    cfg = dict(CFG, device_batch=4, model_input_size=[SIZE, SIZE])
    replies = {}
    for dp in (None, 2):
        srv = DetectionServer(dict(cfg, data_parallel=dp), device="cpu",
                              max_wait_ms=20.0).start()
        try:
            assert (srv.step.input_shardings is None) == (dp is None)
            got = []
            for k in range(3):
                buf = io.BytesIO()
                Image.fromarray(images[k]).save(buf, "PNG")
                w, s, e, n = (float(v) for v in bounds[k])
                req = urllib.request.Request(
                    f"{srv.url}/detect?west={w!r}&south={s!r}&east={e!r}"
                    f"&north={n!r}", data=buf.getvalue(), method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    got.append(json.load(r))
            replies[dp] = got
        finally:
            srv.stop()
    assert srv.step.input_shardings == PM.Mesh(["cpu"] * 2).rows(4)
    for a, b in zip(replies[None], replies[2]):
        assert a["count"] == b["count"] > 0
        assert a["detections"] == b["detections"]


# ------------------------------------------------------------- spatial

def _spatial_tiles(n=2, size=256):
    """n tiles of 128 m around FakeWorld cars at the fixture's 0.5 m/px."""
    from aerial_image_recognition_tpu_torch.fetch.fake import FakeWorld
    from test_torch_step import M2LAT, M2LON
    world = FakeWorld(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                      n_cars=500, seed=9)
    tiles, bounds = [], []
    for k in range(n):
        lon, lat, _ = world.cars[k * 17]
        bbox = (lon - 60 * M2LON, lat - 68 * M2LAT, lon + 68 * M2LON,
                lat + 60 * M2LAT)
        tiles.append(world.render(bbox, size, size))
        bounds.append(bbox)
    return np.stack(tiles), np.asarray(bounds, np.float32)


def test_spatial_detect_equals_single_device_and_jax():
    """The trunk's rows over 8 CPU shards at 256 px (one row a shard at
    stride 32: SPP's chained pools reach several shards away) against
    ``make_detect_fn`` and the JAX package's ``make_spatial_detect`` over
    its 8 devices (tests/test_parallel.py::
    test_spatial_partitioned_forward_matches_single_device: valid equal,
    boxes rtol 2e-4 atol 2e-3, lon within 1e-6)."""
    from aerial_image_recognition_tpu.parallel.spatial import (
        make_spatial_detect as jax_make_spatial_detect)
    from aerial_image_recognition_tpu.models.registry import (
        create_model as jax_create_model, load_params)
    from aerial_image_recognition_tpu_torch.parallel.spatial import (
        make_spatial_detect)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        make_detect_fn)
    size = 256
    cfg = DetectorConfig.from_dict(CFG)
    single = build_detect_step(cfg, batch=2, model_size=size, device="cpu")
    imgs, bnds = _spatial_tiles()
    det_r, lon_r, lat_r = make_detect_fn(single.bundle, cfg,
                                         model_size=size)(
        torch.from_numpy(imgs), torch.from_numpy(bnds))
    det_s, lon_s, lat_s = make_spatial_detect(single.bundle, cfg, CPU8,
                                              model_size=size)(imgs, bnds)
    v = det_r.valid.numpy()
    assert v.sum() >= 2
    np.testing.assert_array_equal(det_s.valid.numpy(), v)
    np.testing.assert_allclose(det_s.boxes.numpy()[v], det_r.boxes.numpy()[v],
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(lon_s.numpy()[v], lon_r.numpy()[v], rtol=0,
                               atol=1e-6)
    jb = jax_create_model("yolov7_itcvd", dtype=jnp.float32)
    jb.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                       load_params(CFG["params_path"]))
    jcfg = JaxDetectorConfig.from_dict(CFG)
    jdet, jlon, _ = jax_make_spatial_detect(jb, jcfg, JM.make_mesh(),
                                            model_size=size)(
        jb.params, jnp.asarray(imgs), jnp.asarray(bnds))
    np.testing.assert_array_equal(det_s.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_allclose(det_s.boxes.numpy()[v],
                               np.asarray(jdet.boxes)[v], atol=1e-3, rtol=0)
    np.testing.assert_allclose(lon_s.numpy()[v], np.asarray(jlon)[v],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,n", [("yolov7_itcvd", 3), ("yolov7_base", 8),
                                    ("yolov8n", 8), ("yolov8n", 5)])
def test_spatial_trunk_is_sharded_and_exact(name, n, monkeypatch):
    """Each family's raw head maps with the rows over n CPU shards (even
    and uneven splits) equal the unsharded forward (tolerance 0: the same
    convolutions on the same rows), and nothing before the heads' NHWC
    permute is gathered whole."""
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.parallel import spatial as SP
    gathered = []
    real = SP._gathered
    monkeypatch.setattr(SP, "_gathered", lambda f, a, k: (
        gathered.append(f.__name__), real(f, a, k))[1])
    b = create_model(name, dtype=torch.float32, seed=1, device="cpu",
                     fold_bn=True)
    x = torch.from_numpy(np.random.default_rng(4).random(
        (2, 3, 256, 256), dtype=np.float32))
    with torch.inference_mode():
        want = b.module(x)
        got = SP._whole(b.module(SP.RowShards.split(
            x, [torch.device("cpu")] * n)))
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert set(gathered) == {"permute"}


class _OpLog:
    """Wraps an int8 trunk graph runner (``g``) and keeps every
    operation's output."""

    def __init__(self, g):
        self.g, self.outs = g, []

    def __getattr__(self, name):
        def call(*args, **kwargs):
            out = getattr(self.g, name)(*args, **kwargs)
            self.outs.append((name, out))
            return out
        return call


@pytest.mark.parametrize("name,n", [("yolov7_base", 8), ("yolov8n", 5)])
def test_spatial_int8_trunk_is_sharded_and_exact(name, n, monkeypatch):
    """A seeded ``Int8Bundle`` of each other family (yolov7-base's MP
    convs, yolov8's split, residual adds and SPPF) with the rows over n
    CPU shards at 96 px: every trunk operation's output, gathered, equals
    the unsharded run's (tolerance 0; a seeded trunk's last taps saturate,
    so each layer is held), the boxes and scores equal the unsharded int8
    forward's, and nothing is gathered before the head taps."""
    from aerial_image_recognition_tpu_torch.models.int8 import (
        _Run, quantize_bundle)
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.parallel import spatial as SP
    gathered = []
    real = SP._gathered
    monkeypatch.setattr(SP, "_gathered", lambda f, a, k: (
        gathered.append(f.__name__), real(f, a, k))[1])
    tiles = np.random.default_rng(2).integers(0, 256, (2, 96, 96, 3),
                                              dtype=np.uint8)
    qb = quantize_bundle(create_model(name, dtype=torch.float32, seed=1,
                                      device="cpu", fold_bn=True),
                         [tiles], model_size=96)
    x = torch.from_numpy(tiles).permute(0, 3, 1, 2).float() / 255.0
    sb = SP._SpatialBundle(qb, [torch.device("cpu")] * n)
    with torch.inference_mode():
        want = qb.forward(x)
        got = sb.forward(x)
        p2 = qb.module.stems(x)
        plain = _OpLog(_Run(qb.q["convs"], act=qb.act,
                            scales=qb.static_scales))
        qb.trunk_codes(qb._p2_quantize(p2), g=plain)
        split = _OpLog(sb.int8[1])
        e = SP.row_edges(p2.shape[2], n)
        qb.trunk_codes(SP._Rows([qb._p2_quantize(p2[:, :, e[k]:e[k + 1]])
                                 for k in range(n)], sb.devices), g=split)
    assert len(plain.outs) == len(split.outs) > 50
    for (op, a), (_, b) in zip(plain.outs, split.outs):
        for qa, qs in zip(a if isinstance(a, tuple) else (a,),
                          b if isinstance(b, tuple) else (b,)):
            assert torch.equal(qa.v, qs.v.whole()), op
            assert qa.s == qs.s
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert gathered == []


def test_spatial_rows_and_refusals():
    from aerial_image_recognition_tpu_torch.parallel.spatial import (
        RowShards, make_spatial_detect, row_edges)
    assert row_edges(8, 8) == tuple(range(9))
    assert row_edges(5, 8) == (0, 0, 1, 1, 2, 3, 3, 4, 5)
    x = torch.arange(2 * 3 * 5 * 4, dtype=torch.float32).reshape(2, 3, 5, 4)
    r = RowShards.split(x, [torch.device("cpu")] * 8)
    assert torch.equal(r.whole(), x)
    assert torch.equal(r.rows(-2, 7, torch.device("cpu"), -1.0)[:, :, 2:7],
                       x)
    assert (r.rows(-2, 0, torch.device("cpu"), -1.0) == -1).all()
    # an operation without a sharded rule never runs on the first device
    # alone: it is refused while the rows are split
    import torch.nn.functional as F
    w = torch.ones(3, 3, 3, 3)
    for op in (lambda: F.conv2d(r, w, padding="same"),
               lambda: F.max_pool2d(r, 2, ceil_mode=True),
               lambda: F.interpolate(r, scale_factor=2, mode="bilinear"),
               lambda: F.interpolate(r, size=(10, 8)),
               lambda: torch.cat([r, r], dim=0),
               lambda: r.chunk(2, dim=2),
               lambda: r[:, :, 1:],
               lambda: r.sum()):
        with pytest.raises(NotImplementedError, match="spatial inference"):
            op()
    assert torch.equal(r.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1))
    b = build_detect_step(DetectorConfig.from_dict(CFG), batch=2,
                          model_size=64, device="cpu").bundle
    with pytest.raises(ValueError, match="mesh starts"):
        make_spatial_detect(b, DetectorConfig(),
                            PM.Mesh([torch.device("meta")]))


def test_spatial_int8_exact_when_float_sums_depend_on_the_slab(monkeypatch):
    """On the card a float convolution's sums over a slab of rows may round
    otherwise than over the whole image (cuDNN picks its algorithm by
    shape): on an H100, over four shards of 160 rows of a 64-tile batch,
    100 of YOLOv7-tiny's P2 codes flipped, and the integer trunk carried
    them to the detections (0.0138 in score, 0.64 px). A stand-in makes every float convolution that
    spatial inference runs on a slab depend on the slab's height: the int8
    spatial function must still equal the unsharded int8 function, bit
    for bit."""
    import types
    from aerial_image_recognition_tpu_torch.models.int8 import (
        quantize_bundle)
    from aerial_image_recognition_tpu_torch.parallel import spatial as SP
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        make_detect_fn)
    from test_torch_int8 import SIZE as QSIZE, scene_tiles
    tiles = torch.from_numpy(scene_tiles()[:8])
    cfg = DetectorConfig.from_dict(dict(CFG, confidence_threshold=0.4))
    base = build_detect_step(cfg, batch=8, model_size=QSIZE, device="cpu")
    qb = quantize_bundle(base.bundle, [tiles.numpy()], model_size=QSIZE)
    bnds = torch.tensor([[20.999, 52.199, 21.001, 52.201]] * 8)
    want = make_detect_fn(qb, cfg, model_size=QSIZE)(tiles, bnds)
    real = torch.nn.functional

    def slab_conv2d(x, w, *args, **kw):
        return real.conv2d(x, w, *args, **kw) + 0.01 * (x.shape[2] % 5 + 1)
    monkeypatch.setattr(SP, "F", types.SimpleNamespace(
        conv2d=slab_conv2d, max_pool2d=real.max_pool2d,
        interpolate=real.interpolate))
    got = SP.make_spatial_detect(qb, cfg, PM.Mesh(["cpu"] * 4),
                                 model_size=QSIZE)(tiles, bnds)
    assert int(want[0].valid.sum()) >= 8
    for a, b in zip(want[0], got[0]):
        assert torch.equal(a, b)
    assert torch.equal(want[1], got[1]) and torch.equal(want[2], got[2])


def test_spatial_with_an_int8_bundle(monkeypatch):
    """An ``Int8Bundle`` under spatial inference: its float stems run
    whole and its int8 trunk on the shards' rows (halos of the 3×3 convs,
    the stride-2 convs and SPP's chained pools included), nothing is
    gathered before the head taps; the detections equal the unsharded int8
    function's (tolerance 0)."""
    from aerial_image_recognition_tpu_torch.models.int8 import (
        quantize_bundle)
    from aerial_image_recognition_tpu_torch.parallel.spatial import (
        make_spatial_detect)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        make_detect_fn)
    from test_torch_int8 import SIZE as QSIZE, scene_tiles
    tiles = torch.from_numpy(scene_tiles()[:8])
    cfg = DetectorConfig.from_dict(dict(CFG, confidence_threshold=0.4))
    base = build_detect_step(cfg, batch=8, model_size=QSIZE, device="cpu")
    qb = quantize_bundle(base.bundle, [tiles.numpy()], model_size=QSIZE)
    bnds = torch.tensor([[20.999, 52.199, 21.001, 52.201]] * 8)
    want = make_detect_fn(qb, cfg, model_size=QSIZE)(tiles, bnds)
    from aerial_image_recognition_tpu_torch.parallel import spatial as SP
    gathered = []
    real = SP._gathered
    monkeypatch.setattr(SP, "_gathered", lambda f, a, k: (
        gathered.append(f.__name__), real(f, a, k))[1])
    got = make_spatial_detect(qb, cfg, PM.Mesh(["cpu"] * 4),
                              model_size=QSIZE)(tiles, bnds)
    assert gathered == []
    assert int(want[0].valid.sum()) >= 8
    for a, b in zip(want[0], got[0]):
        assert torch.equal(a, b)
    assert torch.equal(want[1], got[1]) and torch.equal(want[2], got[2])
