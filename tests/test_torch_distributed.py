"""Processes on ``torch.distributed`` (``parallel/distributed.py``): the
helpers against the JAX package's, then two and four port processes on one
gloo group, spawned from the test as tests/test_distributed_multihost.py
spawns the JAX package's (tests/torch_dist_worker.py):

* a stripe scan: each process scans its stripe of the global tile grid;
  the merged, deduped records equal a single-process port scan of the
  whole grid exactly, and the counts cross ``process_allgather``;
* training: three data-parallel XUnet steps (frozen BN) and one yolov8n
  step in ``batch`` BN mode (the BN sync on the cross-process path), each
  process on its own rows: the processes end bit-equal, and equal to
  one process on the global batch within the 2·lr-a-step rule
  (tests/test_torch_train.py: every element within 2·lr a step, fewer than
  1 % of all elements beyond 1e-6), the losses within rtol 1e-4 and the
  running statistics within 2e-5 of each leaf's largest.
"""

import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.parallel import distributed as JD
from aerial_image_recognition_tpu_torch.parallel import distributed as PD

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_dist_worker.py")
sys.path.insert(0, HERE)
import torch_dist_worker as W  # noqa: E402

WORLD = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.01, n_cars=400,
             seed=4)
M2LON = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
M2LAT = 1.0 / 111319.9
BOUNDS = (20.98, 52.19, 21.02, 52.21)

torch.set_num_threads(2)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(mode, tmp_path, outs, *extra):
    """Run a worker for each of ``outs`` on one fresh coordinator address;
    their logs if any fails."""
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    coord = f"127.0.0.1:{_free_port()}"
    n = len(outs)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, coord, str(i), str(n), outs[i],
         *extra], env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)


# ------------------------------------------------------------- helpers

def test_world_of_one_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    ctx = PD.initialize(backend="gloo")
    assert (ctx.process_index, ctx.process_count) == (0, 1)
    assert ctx.local_devices == ctx.global_devices == 1
    np.testing.assert_array_equal(PD.process_allgather(np.arange(3)),
                                  np.arange(3)[None])


@pytest.mark.parametrize("n,pid", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_host_stripe_equals_jax(n, pid):
    ctx = PD.DistributedContext(pid, n, 1, n)
    jctx = JD.DistributedContext(pid, n, 1, n)
    for halo in (0.0, 64.0):
        assert PD.host_stripe(BOUNDS, ctx, halo_m=halo) == \
            JD.host_stripe(BOUNDS, jctx, halo_m=halo)


def test_merge_host_detections_equals_jax():
    rng = np.random.default_rng(3)
    recs = [{"lon": 21.0 + float(a) * 1e-4, "lat": 52.2 + float(b) * 1e-4,
             "confidence": float(c)}
            for a, b, c in rng.random((300, 3))]
    got = PD.merge_host_detections(recs, radius_m=2.0)
    want = JD.merge_host_detections(recs, radius_m=2.0)
    assert got == want and 0 < len(got) < len(recs)


def test_initialize_reads_the_reference_variables(monkeypatch):
    """The address, count and rank come from JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES and JAX_PROCESS_ID; the backend is passed as it is."""
    import torch.distributed as dist
    seen = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(kw, b=backend))
    monkeypatch.setattr(PD, "context", lambda: "ctx")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PD.initialize(backend="gloo") == "ctx"
    assert (seen["b"], seen["init_method"], seen["world_size"],
            seen["rank"]) == ("gloo", "tcp://10.0.0.1:1234", 4, 3)
    # a card per process: rank 3 of 4 takes card 3 % 2 of two, whatever
    # the backend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: seen.update(card=i))
    for backend in ("nccl", "gloo"):
        seen.pop("card", None)
        PD.initialize(backend=backend)
        assert (seen["b"], seen["card"]) == (backend, 1)


# ------------------------------------------------------ two processes

def _write_frame(path):
    from aerial_image_recognition_tpu_torch.gio.geojson import write_geojson
    hl, ht = 120 * M2LON, 80 * M2LAT
    ring = [[21.0 - hl, 52.2 - ht], [21.0 + hl, 52.2 - ht],
            [21.0 + hl, 52.2 + ht], [21.0 - hl, 52.2 + ht],
            [21.0 - hl, 52.2 - ht]]
    write_geojson({"type": "FeatureCollection", "features": [{
        "type": "Feature", "properties": {},
        "geometry": {"type": "Polygon", "coordinates": [ring]}}]}, path)


@pytest.mark.parametrize("world", [2, 4])
def test_two_process_stripe_scan_merges_to_single_process_result(tmp_path,
                                                                 world):
    from aerial_image_recognition_tpu_torch.fetch.fake import (
        FakeTileServer, FakeWorld)
    from aerial_image_recognition_tpu_torch.post.dedup import dedup_records
    frame = str(tmp_path / "aoi.geojson")
    _write_frame(frame)
    srv = FakeTileServer(FakeWorld(**WORLD))
    srv.start()
    try:
        outs = [str(tmp_path / f"host{i}.json") for i in range(world)]
        _spawn("scan", tmp_path, outs, srv.base_url, frame)
        results = sorted((json.load(open(o)) for o in outs),
                         key=lambda r: r["process_index"])
        assert [r["process_index"] for r in results] == list(range(world))
        assert all(r["process_count"] == world for r in results)
        counts = [len(r["records"]) for r in results]
        assert all(r["counts_allgather"] == counts for r in results)
        assert all(c > 0 for c in counts)
        assert all(r["tiles_scanned"] > 0 for r in results)
        summary, single_raw = W.scan(str(tmp_path / "single"),
                                     srv.base_url, frame)
    finally:
        srv.stop()
    assert sum(r["tiles_scanned"] for r in results) == summary["tiles"]
    all_recs = [rec for r in results for rec in r["records"]]
    assert len(all_recs) == len(single_raw)
    merged = PD.merge_host_detections(all_recs, radius_m=1.0)
    single = dedup_records(single_raw, radius_m=1.0)

    def key(recs):
        return sorted((r["lon"], r["lat"], r["confidence"]) for r in recs)
    assert key(all_recs) == key(single_raw)           # bit-equal records
    assert key(merged) == key(single)
    assert len(merged) < len(all_recs)                # the merge deduped


@pytest.mark.parametrize("world", [2, 4])
def test_two_process_training_matches_one_process(tmp_path, world):
    outs = [str(tmp_path / f"train{i}.npz") for i in range(world)]
    _spawn("train", tmp_path, outs)
    got = [dict(np.load(o)) for o in outs]
    # every process ends with the same parameters and statistics, bit for
    # bit, and saw the others' sums
    keys = [k for k in got[0] if ":" in k]
    for other in got[1:]:
        for k in keys:
            np.testing.assert_array_equal(got[0][k], other[k], err_msg=k)
        np.testing.assert_array_equal(got[0]["sums_allgather"],
                                      other["sums_allgather"])
    for row in got[0]["sums_allgather"][1:]:
        np.testing.assert_array_equal(got[0]["sums_allgather"][0], row)
    # one process, one device, the global batch
    losses, want = W.train()
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got[0]["v8:loss"], want["v8:loss"],
                               rtol=1e-4)
    far = total = 0
    for k in keys:
        if k.startswith("v8stats:"):
            np.testing.assert_allclose(
                got[0][k], want[k], rtol=0,
                atol=2e-5 * np.abs(want[k]).max(), err_msg=k)
        elif k != "v8:loss":
            steps = W.XUNET_STEPS if k.startswith("xunet:") else 1
            d = np.abs(got[0][k] - want[k])
            assert (d <= 2 * 1e-3 * steps * (1 + 1e-3)).all(), k
            far += int((d > 1e-6).sum())
            total += d.size
    assert far < 0.01 * total, (far, total)
