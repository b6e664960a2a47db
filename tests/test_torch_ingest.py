"""The port's ingest plane against the JAX package's.

``assemble_batches`` gives the JAX package's batches (padding, failures,
ragged tiles resized); ``run_pipeline`` with a CPU step gives the JAX
``run_pipeline``'s per-batch results with the JAX step (f32, the trained
fixture, 64 px; the step tolerances of tests/test_torch_step.py) and the
same stats keys; ``ThreadedPrefetcher`` surfaces producer errors and stops
on ``close()``. The CUDA upload ring's ordering is checked on the CPU with
stand-ins for the CUDA streams and events, which log what the ring asks of
them. Inputs come from seeds with numpy.
"""

import contextlib
import itertools
import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.fetch.xyz import TileImage as JaxTile
from aerial_image_recognition_tpu.ingest import pipeline as JP
from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.fetch.fake import FakeWorld
from aerial_image_recognition_tpu_torch.fetch.xyz import TileImage
from aerial_image_recognition_tpu_torch.ingest import pipeline as PP
from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    build_detect_step)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")
SIZE, BATCH = 64, 4
CFG = dict(dtype="float32", params_path=FIXTURE, confidence_threshold=0.3,
           nms_preselect="exact", quad_stem=False)
M2LON = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
M2LAT = 1.0 / 111319.9

torch.set_num_threads(2)


def _tiles(n, size=32, fail_every=None, ragged_at=None, cls=TileImage):
    for i in range(n):
        if fail_every and i % fail_every == 0:
            yield i, None
            continue
        s = size // 2 if i == ragged_at else size
        px = np.full((s, s, 3), (i * 37) % 255, np.uint8)
        px[: s // 2] = 255 - px[: s // 2]
        yield i, cls(px, (20.0 + i * 1e-4, 52.0, 20.0 + (i + 1) * 1e-4,
                          52.0001))


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.indices, y.indices)
        np.testing.assert_array_equal(x.images, y.images)
        np.testing.assert_array_equal(x.bounds, y.bounds)
        assert (x.n_valid, x.failed_indices) == (y.n_valid, y.failed_indices)
        assert (x.images.dtype, x.bounds.dtype, x.indices.dtype) == \
            (y.images.dtype, y.bounds.dtype, y.indices.dtype)


@pytest.mark.parametrize("n,batch,fail_every,ragged_at", [
    (10, 4, None, None), (9, 4, 3, None), (7, 8, None, 3), (12, 4, 5, 6),
    (3, 4, 1, None)])
def test_assemble_batches_equal_jax(n, batch, fail_every, ragged_at):
    got = list(PP.assemble_batches(
        _tiles(n, fail_every=fail_every, ragged_at=ragged_at),
        batch_size=batch, src_size=32))
    want = list(JP.assemble_batches(
        _tiles(n, fail_every=fail_every, ragged_at=ragged_at, cls=JaxTile),
        batch_size=batch, src_size=32))
    _same_batches(got, want)
    last = got[-1]
    assert (last.indices[last.n_valid:] == -1).all()
    assert np.isfinite(last.bounds).all()


def test_assemble_batches_layouts():
    """The quad stem's s2d2 layout packs each tile as JAX's does (its
    cases against JAX are in tests/test_torch_quadstem.py); an unknown
    layout raises."""
    got = list(PP.assemble_batches(_tiles(3), batch_size=2, src_size=32,
                                   layout="s2d2"))
    want = list(JP.assemble_batches(_tiles(3, cls=JaxTile), batch_size=2,
                                    src_size=32, layout="s2d2"))
    assert [b.images.shape for b in got] == [(2, 8, 8, 48)] * 2
    _same_batches(got, want)
    with pytest.raises(ValueError, match="layout"):
        list(PP.assemble_batches(_tiles(2), batch_size=2, src_size=32,
                                 layout="chw"))


def test_threaded_prefetcher_order_errors_and_close():
    batches = list(PP.assemble_batches(_tiles(8), batch_size=4, src_size=32))
    assert [b.n_valid for b in PP.ThreadedPrefetcher(iter(batches),
                                                      depth=2)] == [4, 4]

    def boom():
        yield batches[0]
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(PP.ThreadedPrefetcher(boom(), depth=2))

    produced = []

    def endless():
        while True:
            produced.append(1)
            yield batches[0]

    pf = PP.ThreadedPrefetcher(endless(), depth=2)
    it = iter(pf)
    next(it)
    pf.close(join_timeout=5.0)
    assert not pf._thread.is_alive()
    n = len(produced)
    time.sleep(0.05)
    assert len(produced) == n                 # the producer stopped


def _scene(n):
    world = FakeWorld(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                      n_cars=500, seed=9)
    for k in range(n):
        lon, lat, _ = world.cars[k * 7]
        bbox = (lon - 15.0 * M2LON, lat - 17.0 * M2LAT,
                lon + 17.0 * M2LON, lat + 15.0 * M2LAT)
        yield k, TileImage(world.render(bbox, SIZE, SIZE), bbox)


@pytest.fixture(scope="module")
def steps():
    kw = dict(batch=BATCH, src_size=SIZE, model_size=SIZE)
    return (jax_build_detect_step(JaxDetectorConfig.from_dict(CFG), **kw),
            build_detect_step(DetectorConfig.from_dict(CFG), device="cpu",
                              **kw))


def _collect(batches, step, run):
    seen = []

    def on_result(b, out):
        det, lon, lat = out
        seen.append((b.n_valid, np.asarray(det.valid), np.asarray(det.boxes),
                     np.asarray(det.scores), np.asarray(det.classes),
                     np.asarray(lon), np.asarray(lat)))

    return seen, run(batches, step, on_result)


@pytest.mark.parametrize("depth", [1, 2])
def test_run_pipeline_with_a_cpu_step_equals_jax(steps, depth):
    jax_step, port_step = steps
    batches = list(PP.assemble_batches(_scene(10), batch_size=BATCH,
                                       src_size=SIZE))
    got, pstats = _collect(
        batches, port_step,
        lambda b, s, f: PP.run_pipeline(b, s, f, depth=depth))
    want, jstats = _collect(
        batches, jax_step,
        lambda b, s, f: JP.run_pipeline(b, s, f, depth=depth))
    assert pstats.keys() == jstats.keys()
    for k in ("batches", "tiles", "failed"):
        assert pstats[k] == jstats[k]
    assert pstats["batches"] == 3 and pstats["tiles"] == 10
    assert sum(int(g[1].sum()) for g in got) >= 10      # the cars are seen
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])          # valid
        np.testing.assert_array_equal(g[4], w[4])          # classes
        np.testing.assert_allclose(g[2], w[2], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g[3], w[3], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g[5][g[1]], w[5][w[1]], atol=1e-6, rtol=0)
        np.testing.assert_allclose(g[6][g[1]], w[6][w[1]], atol=1e-6, rtol=0)


def test_run_pipeline_plain_callable_and_host_handoff():
    """A callable without a device gets CPU tensors; prefetch_device=False
    hands it the host arrays; both give the JAX pipeline's sums."""
    batches = list(PP.assemble_batches(_tiles(12), batch_size=4,
                                       src_size=32))
    got = {}
    for pf in (True, False):
        seen = []
        stats = PP.run_pipeline(
            batches,
            lambda im, bd: (torch.as_tensor(im).float().sum(dim=(1, 2, 3)),
                            bd),
            lambda b, o: seen.append(float(o[0].sum())), prefetch_device=pf)
        got[pf] = seen
        assert stats["batches"] == 3 and stats["tiles"] == 12
    jseen = []
    JP.run_pipeline(batches, lambda im, bd: (np.asarray(im, np.float64)
                                             .sum(axis=(1, 2, 3)), bd),
                    lambda b, o: jseen.append(float(o[0].sum())))
    assert got[True] == got[False] == jseen


# ------------------------------------------------ the CUDA ring, on the CPU

class _Log:
    def __init__(self):
        self.ops = []                  # list.append is atomic
        self.ids = itertools.count(1)


class _FakeEvent:
    def __init__(self, log):
        self.id, self.log = next(log.ids), log

    def record(self, stream):
        self.log.ops.append(("record", stream.name, self.id))

    def synchronize(self):
        self.log.ops.append(("host-sync", self.id))


class _FakeStream:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def wait_event(self, ev):
        self.log.ops.append(("wait", self.name, ev.id))

    def synchronize(self):
        self.log.ops.append(("stream-sync", self.name))


@pytest.mark.parametrize("n,switch", [(5, None), (60, 1e-6)])
def test_upload_ring_orders_its_copies_and_steps(monkeypatch, n, switch):
    """Slots are reused in turn; the copy into a reused slot waits (on the
    copy stream) for the event of the step that read it and (on the host)
    for its previous copy; every step waits for its own copy; the step sees
    its batch's pixels; each result is read back on the readback stream
    after its own step's event, once the next step is queued. torch.cuda's
    streams and events are stand-ins that log, and the buffers live on the
    CPU. The second case runs 60 batches with the interpreter switching
    threads every microsecond, so the staging thread and the main thread
    interleave as much as they can."""
    log = _Log()
    compute = _FakeStream(log, "compute")
    local = threading.local()          # the current stream is per thread

    def stack():
        if not hasattr(local, "streams"):
            local.streams = [compute]
        return local.streams

    @contextlib.contextmanager
    def stream_ctx(s):
        stack().append(s)
        try:
            yield
        finally:
            stack().pop()

    names = iter(["copy", "readback"])          # in the order made
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device: _FakeStream(log, next(names)))
    monkeypatch.setattr(torch.cuda, "Event", lambda: _FakeEvent(log))
    monkeypatch.setattr(torch.cuda, "stream", stream_ctx)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stack()[-1])

    def allocate(self, images, bounds):
        self._shapes = (images.shape, bounds.shape)
        self.shards = self.mesh.rows(images.shape[0])
        self._bufs = [(torch.empty(images.shape, dtype=torch.uint8),
                       torch.empty(bounds.shape),
                       [torch.empty(images.shape, dtype=torch.uint8)],
                       [torch.empty(bounds.shape)])
                      for _ in range(self.slots)]

    monkeypatch.setattr(PP._UploadRing, "_allocate", allocate)

    class CardStep:
        """A one-shard DetectStep's surface: per-shard lists in."""
        device = torch.device("cuda", 0)
        mesh = Mesh([device])

        def __init__(self):
            self.seen = []

        def __call__(self, images, bounds):
            (images,), (bounds,) = images, bounds
            log.ops.append(("step", stack()[-1].name,
                            int(images[0, 0, 0, 0])))
            self.seen.append((images.clone(), bounds.clone()))
            return (images.float().sum(dim=(1, 2, 3)),)

    batches = list(PP.assemble_batches(_tiles(4 * n), batch_size=4,
                                       src_size=32))
    step = CardStep()
    sums = []

    def on_result(b, o):
        log.ops.append(("result", stack()[-1].name, len(sums)))
        sums.append(o[0].numpy().copy())

    before = sys.getswitchinterval()
    if switch:
        sys.setswitchinterval(switch)
    try:
        stats = PP.run_pipeline(batches, step, on_result)
    finally:
        sys.setswitchinterval(before)
    assert stats["batches"] == n
    for b, (images, bounds), s in zip(batches, step.seen, sums):
        np.testing.assert_array_equal(images.numpy(), b.images)
        np.testing.assert_array_equal(bounds.numpy(), b.bounds)
        np.testing.assert_array_equal(s, b.images.astype(np.float32)
                                      .sum(axis=(1, 2, 3)))
    ops = log.ops
    copies = [op for op in ops if op[0] == "record" and op[1] == "copy"]
    releases = [op for op in ops if op[0] == "record" and op[1] == "compute"]
    steps_ = [i for i, op in enumerate(ops) if op[0] == "step"]
    assert len(copies) == len(releases) == len(steps_) == n
    assert all(ops[i][1] == "compute" for i in steps_)
    for k, i in enumerate(steps_):
        # the step's own copy is waited for on the compute stream
        assert ("wait", "compute", copies[k][2]) in ops[:i]
    for k in range(2, n):                       # slot k % 2 reused
        at = ops.index(copies[k])
        before = ops[:at]
        assert ("host-sync", copies[k - 2][2]) in before
        assert ("wait", "copy", releases[k - 2][2]) in before
        # ... and the copy into it does not wait for the step before
        assert ("wait", "copy", releases[k - 1][2]) not in before
    # read back on the readback stream, after that batch's step only, and
    # synchronized before its outputs may be freed (the staging thread's
    # ops interleave with these, so they are taken out first)
    readback = [op for op in ops if op[0] == "result"
                or (op[0] in ("wait", "stream-sync") and op[1] == "readback")]
    assert readback == [op for k in range(n) for op in (
        ("wait", "readback", releases[k][2]), ("result", "readback", k),
        ("stream-sync", "readback"))]
    results = [i for i, op in enumerate(ops) if op[0] == "result"]
    for k, i in enumerate(results[:-1]):
        assert steps_[k + 1] < i                # the next step is queued
    assert ops[-1] == ("stream-sync", "copy")   # ring closed


def test_upload_ring_refuses_a_changed_shape(monkeypatch):
    ring = PP._UploadRing.__new__(PP._UploadRing)
    ring._bufs, ring._shapes = [()], ((4, 32, 32, 3), (4, 4))
    b = next(iter(PP.assemble_batches(_tiles(2), batch_size=2,
                                      src_size=32)))
    with pytest.raises(ValueError, match="one shape"):
        ring.upload(b)
    b.images = b.images.astype(np.float32)
    with pytest.raises(ValueError, match="uint8"):
        ring.upload(b)
