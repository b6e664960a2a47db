"""Scans of the ``scan-1280`` mix timed by the program's own phases, the
last one under the program's ``Tracer``.

    python3 benchmark/tools/scan_trace.py [--seed N] [--scans 3] \
        [--out chiprun_out/scan_trace]

Sets up as the scan cell does (the WMS server, the step, one warm scan
that renders the grid), runs ``--scans`` scans, then one more inside
``runtime.observability.Tracer``, which records every thread's phases
(``PhaseTimer`` annotations) beside the card's kernels and copies on one
clock. Prints one JSON line, also written to ``<out>/summary.json``, and
keeps the trace as ``<out>/trace.json.gz``:

* ``scans``: each scan's tiles a second, phase seconds and counts, and
  the main thread's account: ``setup`` + ``grid_creation`` +
  ``ingest_wait`` + ``batch_dispatch`` + ``result_drain`` +
  ``duplicate_removal`` against the GeoJSON's ``wall_clock_s``; the
  traced scan last;
* ``trace``: the traced scan's card busy time and idle share between its
  first and last main-thread phase, its idle seconds by the main thread's
  phase at each gap's middle, and its longest idle gaps, each with the
  innermost phase open on the main thread and on the prefetch thread.
"""

import argparse
import contextlib
import gzip
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run as bench  # noqa: E402
from benchmark.drivers.scan import Server, aoi, scan_config  # noqa: E402
from benchmark.lib import program, registry, tiles, weights  # noqa: E402
from benchmark.lib.trace import DEVICE_CATS, _union  # noqa: E402

CELL = "v7tiny-scan-1280"
MAIN = ("setup", "grid_creation", "ingest_wait", "batch_dispatch",
        "result_drain", "duplicate_removal")


def _innermost(spans, t):
    """The latest-opened of ``spans`` (start, end, name) open at ``t``."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else None


def reduce(path: str, main_tid: int, n: int = 10) -> dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ann.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    main = ann.get(main_tid, [])
    packing = [tid for tid, v in ann.items()
               if any(name == "batch_packing" for _, _, name in v)]
    prefetch = ann.get(packing[0], []) if packing else []
    lo = min(s for s, _, _ in main)
    hi = max(e for _, e, _ in main)
    busy = [(max(a, lo), min(b, hi)) for a, b in _union(
        (e["ts"], e["ts"] + e.get("dur", 0)) for e in events
        if e.get("cat") in DEVICE_CATS) if b > lo and a < hi]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((b - a, (a + b) / 2) for a, b in zip(edges[::2],
                                                       edges[1::2])
                   if b > a), reverse=True)
    by_phase = {}
    for g, mid in gaps:
        tag = _innermost(main, mid) or "none"
        by_phase[tag] = by_phase.get(tag, 0.0) + g / 1e6
    window = (hi - lo) / 1e6
    busy_s = sum(e - s for s, e in busy) / 1e6
    return {"window_s": window, "busy_s": busy_s,
            "idle_share": 1.0 - busy_s / window,
            "idle_s_by_main_phase": dict(sorted(
                by_phase.items(), key=lambda kv: -kv[1])),
            "threads_annotated": len(ann),
            "idle_gaps": [{"s": g / 1e6, "main": _innermost(main, mid),
                           "prefetch": _innermost(prefetch, mid)}
                          for g, mid in gaps[:n]]}


def trace_scan(t: dict, cfg_model: dict, device, seed: int, scans: int,
               out: str) -> dict:
    """Set up as the scan cell does, run ``scans`` scans and one traced
    into ``out``; the summary (see the module's docstring)."""
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    from aerial_image_recognition_tpu_torch.runtime.observability import (
        Tracer)
    base = tempfile.mkdtemp(prefix="scan-trace-")
    frame = os.path.join(base, "aoi.geojson")
    w, s, e, n = aoi(t)
    with open(frame, "w") as f:
        json.dump({"type": "FeatureCollection", "features": [{
            "type": "Feature", "properties": {}, "geometry": {
                "type": "Polygon", "coordinates": [[[w, s], [e, s], [e, n],
                                                    [w, n], [w, s]]]}}]}, f)
    server = Server({"seed": seed, "lon0": t["lon0"], "lat0": t["lat0"],
                     "extent_m": (t["grid"] + 2) * t["tile_m"],
                     "cars_per_km2": t["cars_per_km2"],
                     "jpeg_quality": t["jpeg_quality"],
                     "render_workers": t["render_workers"]})
    try:
        conf = scan_config(t, frame, server.url, t["confidence"])
        calib, _ = tiles.render_tiles(np.random.default_rng(seed),
                                      t["calib_tiles"],
                                      cfg_model["input_size"])
        _, tree = weights.make(cfg_model, registry.family(
            cfg_model["reference"]), seed, device, ROOT, calib)
        cfg = CarDetector(base, dict(conf, **{
            "model_path": cfg_model["registry"],
            "model_family": cfg_model["family"],
            "num_classes": cfg_model["nc"],
            "dtype": cfg_model["dtype"]}))._step_config()
        step = program.detect_step(cfg, program.bundle(cfg_model, tree,
                                                       device),
                                   [device], t["batch"],
                                   src_size=t["tile_px"])

        def scan():
            det = CarDetector(base, conf, detect_step=step)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                got = det.detect(force_restart=True)
            dt = time.perf_counter() - t0
            with open(os.path.join(base, "output",
                                   "detections_results.geojson")) as f:
                wall = json.load(f)["metadata"]["wall_clock_s"]
            main = sum(det.timers.totals.get(k, 0.0) for k in MAIN)
            return {"tiles": got["tiles"], "tiles_per_s": got["tiles"] / dt,
                    "wall_clock_s": wall, "main_phases_s": main,
                    "main_share": main / wall,
                    "phases": dict(det.timers.totals),
                    "counts": dict(det.timers.counts)}

        scan()                                   # renders every tile
        rows = [scan() for _ in range(scans)]
        with Tracer(out):
            rows.append(scan())
        program.synchronize([device])
    finally:
        server.close()
        shutil.rmtree(base, ignore_errors=True)
    path = os.path.join(out, "trace.json")
    summary = {"scans": rows,
               "trace": reduce(path, threading.get_native_id())}
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--scans", type=int, default=3)
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "scan_trace"))
    args = p.parse_args()
    import torch
    device = bench.cards(1)[0]
    bench._setup_torch()
    spec = registry.load_spec()
    cell = registry.cell(spec, CELL)
    summary = trace_scan(registry.load_traffic(cell["traffic"]),
                         registry.load_config(spec, cell["config"]),
                         device, args.seed, args.scans, args.out)
    summary["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
