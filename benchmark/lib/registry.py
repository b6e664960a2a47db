"""Discovery by name: ``BENCHMARK.json`` names each configuration, traffic
mix and per-layer metric, and each lives in files of its own under this
folder, which nothing else lists:

* ``configs/<config>.json``: the model, its weights, ``assumed`` and
  ``reduced``;
* ``traffic/<mix>.json``: the mix's parameters, and the general driver
  (``drivers/<driver>.py``) that reads them;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(run)`` that returns a number or None;
* ``reference/families/<reference>.py``: the plain reference of the model
  family a configuration's ``reference`` key names (see ``family``).

A later cell, configuration, model family or metric adds files and
entries and edits none of these.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str, root: str = ROOT) -> dict:
    entry = config_entry(spec, name)
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "traffic", f"{name}.json")


def load_traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(traffic_path(name, bench_dir)) as f:
        return json.load(f)


def _module(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict, bench_dir: str = BENCH_DIR):
    """The general driver module a mix names (``drivers/<driver>.py``)."""
    return _module(os.path.join(bench_dir, "drivers",
                                f"{traffic['driver']}.py"),
                   f"bench_driver_{traffic['driver']}")


def family(name: str, bench_dir: str = BENCH_DIR):
    """The module ``reference/families/<name>.py``: the plain reference of
    one model family, written on ``reference.models.Graph`` in f32, which
    answers every question the harness asks of a model:

    * ``forward(cfg, w, x)``: the raw outputs over x [B,3,S,S] f32 in
      [0,1]; ``w`` a flat dict of f32 tensors or a ``Graph`` over one;
      widths and depths from the weights and the configuration ``cfg``;
    * ``answer(cfg, w, x, *, conf, iou_thr, max_det, pre_topk)``: per
      image, the kept detections that the check compares, as (box [N,4]:
      centre x, y and width, height in model pixels; score [N]; class
      index [N]), after the family's own decode and suppression (the
      drivers pass the check's ``floor``, ``reference_max_det`` and
      ``reference_pre_topk`` and the program's NMS IoU threshold; a family
      without NMS ignores them);
    * ``flops(cfg, weights, batch, size)``: twice the multiply-adds of one
      forward over [batch,3,size,size], counted on the meta device;
    * for the ``seeded_unit_variance`` weights kind (``lib/weights.py``):
      ``shapes(cfg)``, the leaf shapes {path: shape}, and
      ``calibrate(cfg, w, x)``, which rescales the drawn leaves in place
      over calibration images."""
    path = os.path.join(bench_dir, "reference", "families", f"{name}.py")
    return _module(path, "bench_family_" + name.replace("-", "_")
                   .replace(".", "_"))


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    return _module(path, "bench_metric_" + name.replace(".", "_")).read


def metrics_for(spec: dict, cell_name: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those whose ``workloads`` list it; without such a list, an end-to-end
    metric is every cell's and a per-layer one that of every cell that
    reports the end-to-end metric it ``moves``."""
    e2e = {m["name"] for m in metrics_for(spec, cell_name, "end_to_end")} \
        if kind == "per_layer" else set()
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out
