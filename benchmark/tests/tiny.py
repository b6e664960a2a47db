"""Runs a cell of the benchmark end to end on the CPU at a tiny size: a
copy of ``BENCHMARK.json`` and this folder in a temporary directory, each
mix shrunk (2-tile batches over a 6-tile pool; a 2 x 2 scan grid), the
cards replaced by the CPU, the spare cells' entries added. The harness's look for a card is skipped;
everything after it runs as on the chip."""

import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

RING = dict(batch_per_card=2, pool_tiles=6, warm_batches=1, sample_share=1.0,
            calib_tiles=2, trace_seconds=1.0, reference_block=2)
SCAN = dict(grid=2, batch=4, render_workers=2, calib_tiles=2,
            reference_block=2)
# cells whose mix and check are kept as files without an entry in
# BENCHMARK.json: the copy gets their entries, so they stay tested
SPARE = [{"name": "v7tiny-ring-640", "config": "yolov7-tiny-itcvd",
          "traffic": "ring-640", "chips": 1,
          "why": "decoded 640-px tiles, batch 64, prefetch 4"},
         {"name": "v7tiny-dp4-640", "config": "yolov7-tiny-itcvd",
          "traffic": "dp4-ring-640", "chips": 4,
          "why": "the ring over a four-card mesh"}]


def spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        s = json.load(f)
    names = {w["name"] for w in s["workloads"]}
    s["workloads"] += [w for w in SPARE if w["name"] not in names]
    return s


def spec_copy(dst: str) -> str:
    """``dst`` holding BENCHMARK.json and benchmark/, the mixes shrunk."""
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(spec(), f)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = os.path.join(dst, "benchmark", "traffic")
    for name in os.listdir(traffic):
        with open(os.path.join(traffic, name)) as f:
            t = json.load(f)
        t.update(RING if t["driver"] == "ring" else SCAN)
        with open(os.path.join(traffic, name), "w") as f:
            json.dump(t, f)
    return dst


def run_cell(cell: str, seed: int, seconds: float = 2.0, trace: int = 0,
             control=None, root=None):
    """The result line of one CPU run of ``cell`` in ``root``, a copy made
    by ``spec_copy`` that a test may have added files and entries to; in a
    fresh copy when ``root`` is None."""
    if root is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_cell(cell, seed, seconds, trace, control,
                            spec_copy(tmp))
    import torch
    from benchmark import run
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        chips = next(w["chips"] for w in json.load(f)["workloads"]
                     if w["name"] == cell)
    args = run.parse(["--workload", cell, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)]
                     + (["--control", control] if control else []))
    line, _ = run.measure(args, devices=[torch.device("cpu")] * chips,
                          spec_root=root)
    return line
