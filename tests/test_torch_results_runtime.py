"""The port's results, heatmap, checkpoint and observability copies against
the JAX package's.

Compaction keeps long suppression chains and drops what is final, as the
JAX ``ResultsManager`` does, on the same records; checkpoints round-trip
atomically in both formats and each package reads the other's; the grid
fingerprint is the same string; ``PhaseTimer``, ``EventLog`` and
``ProgressBar`` behave alike; ``DeviceMonitor.sample`` on a CPU step gives
no device fields. Inputs come from seeds with numpy; tolerance 0.
"""

import io
import json
import os
import re
import threading
import time

import numpy as np
import pytest

from aerial_image_recognition_tpu.post import heatmap as JHM
from aerial_image_recognition_tpu.post import results as JR
from aerial_image_recognition_tpu.runtime import checkpoint as JC
from aerial_image_recognition_tpu.runtime import observability as JO
from aerial_image_recognition_tpu_torch.gio.geojson import read_geojson
from aerial_image_recognition_tpu_torch.gio.shapefile import read_shapefile
from aerial_image_recognition_tpu_torch.post import heatmap as PHM
from aerial_image_recognition_tpu_torch.post import results as PR
from aerial_image_recognition_tpu_torch.runtime import checkpoint as PC
from aerial_image_recognition_tpu_torch.runtime import observability as PO

LAT0 = 52.2
M2LON = 1.0 / (111319.9 * np.cos(np.radians(LAT0)))
M2LAT = 1.0 / 111319.9
DETS = [{"lon": 21.0, "lat": 52.2, "confidence": 0.9, "class": "car"},
        {"lon": 21.001, "lat": 52.201, "confidence": 0.5, "class": "car"}]


def _rec(x_m, conf):
    return {"lon": 21.0 + x_m * M2LON, "lat": LAT0, "confidence": conf,
            "class": "car"}


def test_proximity_components_equal():
    rng = np.random.default_rng(0)
    x, y = rng.random(400) * 60, rng.random(400) * 60
    got = PR._proximity_components(x, y, 2.0)
    np.testing.assert_array_equal(got, JR._proximity_components(x, y, 2.0))
    line = PR._proximity_components(np.array([0.0, 1.5, 3.0, 10.0, 11.0]),
                                    np.zeros(5), 2.0)
    assert line[0] == line[1] == line[2] != line[3] == line[4]


def test_compact_keeps_long_suppression_chains(tmp_path):
    """A chain A>B>C>D (1.8 m links, radius 2 m) bridged to the active
    region: nothing may be destroyed; without the bridge the suppressed B
    and D are final and go — in both packages."""
    active = (21.0 - 22.0 * M2LON, LAT0 - M2LAT, 21.0 - 20.0 * M2LON,
              LAT0 + M2LAT)
    chain = [_rec(x, c) for x, c in zip([0.0, 1.8, 3.6, 5.4],
                                        [0.9, 0.8, 0.7, 0.6])]
    bridge = [_rec(x, 0.3 + 0.001 * i)
              for i, x in enumerate(np.arange(-20.0 + 1.8, 0.0, 1.8))]
    for recs, removed in ((chain + bridge, 0), (chain, 2)):
        pm = PR.ResultsManager(str(tmp_path / "p"), duplicate_distance=2.0)
        jm = JR.ResultsManager(str(tmp_path / "j"), duplicate_distance=2.0)
        pm.add([dict(r) for r in recs])
        jm.add([dict(r) for r in recs])
        assert pm.compact(active_bounds=active) == removed
        assert jm.compact(active_bounds=active) == removed
        assert pm.detections == jm.detections


@pytest.mark.parametrize("active", [None, (21.0, 52.2, 21.0005, 52.2005)])
def test_compact_and_dedup_equal_jax_on_random_records(tmp_path, active):
    rng = np.random.default_rng(5)
    recs = [{"lon": 21.0 + a * 1e-3, "lat": 52.2 + b * 1e-3,
             "confidence": float(c), "class": "car"}
            for a, b, c in rng.random((700, 3))]
    pm = PR.ResultsManager(str(tmp_path / "p"), duplicate_distance=1.5)
    jm = JR.ResultsManager(str(tmp_path / "j"), duplicate_distance=1.5)
    pm.add(list(recs))
    jm.add(list(recs))
    assert pm.compact(active) == jm.compact(active)
    assert pm.detections == jm.detections
    assert pm.remove_duplicates() == jm.remove_duplicates()
    assert pm.detections == jm.detections


def test_process_results_writes_the_jax_files(tmp_path):
    rng = np.random.default_rng(6)
    recs = [{"lon": 21.0 + a * 1e-3, "lat": 52.2 + b * 1e-3,
             "confidence": float(c), "class": "car"}
            for a, b, c in rng.random((120, 3))]
    covs = [(21.0, 52.2, 21.001, 52.201), (21.001, 52.2, 21.002, 52.201)]
    docs = []
    for mod, sub in ((PR, "p"), (JR, "j")):
        m = mod.ResultsManager(str(tmp_path / sub), duplicate_distance=1.0,
                               heatmap_hex_m=50.0)
        m.add(list(recs), covs)
        path = m.process_results(metadata={"run": 1})
        doc = read_geojson(path)
        doc["metadata"].pop("generated")
        cov = read_geojson(os.path.join(str(tmp_path / sub),
                                        "detections_coverage.geojson"))
        hexes = read_geojson(os.path.join(
            str(tmp_path / sub), "detections_hex_heatmap.geojson"))
        shp = read_shapefile(os.path.join(str(tmp_path / sub),
                                          "detections_results.shp"))
        docs.append((doc, cov, hexes, len(shp),
                     [r.attributes for r in shp]))
    assert docs[0] == docs[1]
    assert docs[0][0]["metadata"]["utm_epsg"] == 32634
    assert docs[0][3] == len(docs[0][0]["features"]) > 0


def test_heatmap_equal_and_gpkg_names_its_slice(tmp_path):
    rng = np.random.default_rng(8)
    recs = [{"lon": 21.0 + a * 2e-3, "lat": 52.2 + b * 2e-3,
             "confidence": float(c)} for a, b, c in rng.random((300, 3))]
    assert PHM.hex_heatmap(recs, 40.0) == JHM.hex_heatmap(recs, 40.0)
    # the GeoPackage output, refused until the port had its writer, now
    # holds the JAX heatmap's layer
    from aerial_image_recognition_tpu.gio.geopackage import read_gpkg
    PHM.hex_heatmap(recs, 40.0, output_geojson=str(tmp_path / "p.gpkg"))
    JHM.hex_heatmap(recs, 40.0, output_geojson=str(tmp_path / "j.gpkg"))
    assert read_gpkg(str(tmp_path / "p.gpkg")) == \
        read_gpkg(str(tmp_path / "j.gpkg"))
    assert PHM.hex_heatmap([], 40.0)["features"] == []


@pytest.mark.parametrize("style", ["split", "combined"])
def test_checkpoint_round_trip_and_cross_package(tmp_path, style):
    state = dict(processed_count=42, total_tiles=100, detections=DETS,
                 grid_fingerprint="fp1")
    pm = PC.CheckpointManager(str(tmp_path / "p"), prefix="t", style=style)
    pm.save(PC.CheckpointState(**state))
    back = pm.load()
    assert (back.processed_count, back.total_tiles, back.grid_fingerprint) \
        == (42, 100, "fp1")
    assert back.detections == JC.CheckpointManager(
        str(tmp_path / "p"), prefix="t", style=style).load().detections
    # the JAX package's checkpoint reads in the port, and the files agree
    jm = JC.CheckpointManager(str(tmp_path / "j"), prefix="t", style=style)
    jm.save(JC.CheckpointState(**state))
    jback = PC.CheckpointManager(str(tmp_path / "j"), prefix="t",
                                 style=style).load()
    assert jback.detections == back.detections
    for name in os.listdir(str(tmp_path / "p")):
        a = json.load(open(os.path.join(str(tmp_path / "p"), name)))
        b = json.load(open(os.path.join(str(tmp_path / "j"), name)))
        for doc in (a, b):                       # save times differ
            doc.pop("timestamp", None)
            doc.get("metadata", {}).pop("timestamp", None)
        assert a == b
    assert not [f for f in os.listdir(str(tmp_path / "p"))
                if f.endswith(".tmp")]           # atomic writes
    pm.clear()
    assert pm.load() is None


def test_grid_fingerprint_equal_and_sensitive():
    b = (20.98, 52.19, 21.02, 52.21)
    f = PC.grid_fingerprint(b, 64.0, 0.2, 100)
    assert f == JC.grid_fingerprint(b, 64.0, 0.2, 100)
    assert f != PC.grid_fingerprint(b, 64.0, 0.2, 101)
    assert f != PC.grid_fingerprint(b, 32.0, 0.2, 100)
    assert f != PC.grid_fingerprint(b, 64.0, 0.25, 100)
    assert f == PC.grid_fingerprint(list(b), 64.0, 0.2, 100)


def test_phase_timer_and_event_log(tmp_path):
    t = PO.PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    t.add("b", 2.0)
    rep = t.report()
    assert rep["a"] >= 0.01 and rep["b"] == 2.0
    jt = JO.PhaseTimer()
    jt.add("b", 2.0)
    jt.add("a", t.totals["a"])
    assert t.format_report() == jt.format_report()
    for mod, name in ((PO, "p.jsonl"), (JO, "j.jsonl")):
        log = mod.EventLog(str(tmp_path / name))
        log.emit("grid", tiles=5)
        log.emit("done", detections=2)
    rows = [[{k: v for k, v in json.loads(line).items() if k != "ts"}
             for line in open(tmp_path / n)] for n in ("p.jsonl", "j.jsonl")]
    assert rows[0] == rows[1] == [{"kind": "grid", "tiles": 5},
                                  {"kind": "done", "detections": 2}]
    PO.EventLog(None).emit("nothing")             # no path: no file


def test_progress_bar_renders_alike():
    outs = []
    for mod in (PO, JO):
        buf = io.StringIO()
        bar = mod.ProgressBar(100, desc="tiles", stream=buf, enabled=True,
                              min_interval=0.0)
        mod._FetchProgress(bar).update(3)
        bar.update(50)
        bar.set_postfix(det=7)
        bar.close()
        outs.append(buf.getvalue())
    assert "50/100" in outs[0] and "fetched=3" in outs[0] \
        and outs[0].endswith("\n")
    rate = re.compile(r"[0-9.]+ tile/s")           # wall-clock rates differ
    assert rate.sub("r", outs[0]) == rate.sub("r", outs[1])


def test_device_monitor_on_a_cpu_step(tmp_path):
    mon = PO.DeviceMonitor(interval=0.05, log_path=str(tmp_path / "m.jsonl"),
                           print_line=False, device="cpu")
    s = mon.sample()
    assert "device_error" in s and "hbm_used_mb" not in s \
        and "hbm_limit_mb" not in s and s["host_rss_mb"] > 0
    mon.start()
    time.sleep(0.2)
    mon.stop()
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert rows and all("hbm_used_mb" not in r for r in rows)


def test_device_monitor_reads_the_cuda_allocator(monkeypatch):
    """On a CUDA step the monitor reports the allocator's bytes and the
    card's total under the JAX monitor's field names."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (30_000_000_000, 80_000_000_000))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev: 1_234_567_890)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev: "NVIDIA H100 80GB HBM3")
    s = PO.DeviceMonitor(device="cuda").sample()
    assert s["hbm_used_mb"] == 1234.6 and s["hbm_limit_mb"] == 80000.0
    assert s["device"] == "cuda:0 NVIDIA H100 80GB HBM3"
    assert "device_error" not in s


def test_tracer_writes_a_chrome_trace(tmp_path):
    import torch
    with PO.Tracer(str(tmp_path / "trace")):
        with PO.Tracer.annotate("scan-batch"):
            torch.ones(8).sum()
    doc = json.load(open(tmp_path / "trace" / "trace.json"))
    assert any(ev.get("name") == "scan-batch"
               for ev in doc.get("traceEvents", []))
    with PO.Tracer(None):                          # no directory: no trace
        pass


@pytest.mark.parametrize("thread", ["main", "worker"])
def test_phase_shows_in_the_tracer_trace(tmp_path, thread):
    """A ``PhaseTimer`` phase is a user annotation of the trace, on the
    thread that entered it: the main thread or one started by the scan."""
    import torch
    timer, tids = PO.PhaseTimer(), []

    def body():
        tids.append(threading.get_native_id())
        with timer.phase("ingest_wait"):
            torch.ones(8).sum()

    with PO.Tracer(str(tmp_path)):
        if thread == "main":
            body()
        else:
            worker = threading.Thread(target=body)
            worker.start()
            worker.join(timeout=60)
            assert not worker.is_alive()
    doc = json.load(open(tmp_path / "trace.json"))
    ev = [e for e in doc["traceEvents"] if e.get("name") == "ingest_wait"]
    assert [(e["cat"], e["tid"]) for e in ev] == \
        [("user_annotation", tids[0])]
    assert timer.counts["ingest_wait"] == 1


def test_annotate_skips_record_function_without_a_profiler(
        monkeypatch, tmp_path):
    import torch
    calls, real = [], torch.profiler.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with PO.Tracer.annotate("untraced"):
        pass
    with PO.PhaseTimer().phase("untraced_phase"):
        pass
    assert calls == []
    with PO.Tracer(str(tmp_path)):
        with PO.Tracer.annotate("traced"):
            pass
    assert calls == ["traced"]
