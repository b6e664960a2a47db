"""Discovery by name and the shape of ``BENCHMARK.json``.

Every entry resolves to its files; a configuration, a mix, a check and a
per-layer metric added as new files and entries in a copy of the
benchmark are found without any existing file changing; so is a model
family, whose cells then run end to end on the CPU; the harness's code
names no family; each per-layer metric moves one end-to-end metric that
every cell it lists reports; names, units and keys keep to the
benchmark's contract.
"""

import ast
import hashlib
import json
import os
import re

import pytest

from benchmark.lib import registry

SPEC = registry.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keys_names_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and isinstance(e[key], str):
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        for key in e.get("reduced", ()):
            assert NAME.match(key)


def test_every_entry_resolves():
    for c in SPEC["configs"]:
        cfg = registry.load_config(SPEC, c["name"])
        assert c["file"].startswith("benchmark/configs/")
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert cfg["source"] == c["source"]
    for w in SPEC["workloads"]:
        traffic = registry.load_traffic(w["traffic"])
        assert hasattr(registry.driver(traffic), "run")
        registry.config_entry(SPEC, w["config"])
        with open(os.path.join(registry.BENCH_DIR, "checks",
                               f"{w['name']}.json")) as f:
            assert json.load(f)["limits"]
        assert w["chips"] in (1, 4)
    for m in SPEC["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))
    for c in SPEC["configs"]:
        family = registry.family(registry.load_config(SPEC, c["name"])
                                 ["reference"])
        assert callable(family.forward) and callable(family.answer)
        assert callable(family.flops)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) \
        <= max(1, len(SPEC["workloads"]) // 4)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in registry.metrics_for(SPEC, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_for(SPEC, w["name"], "per_layer")


def test_per_layer_metrics_move_a_reported_metric():
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            e2e = {e["name"] for e in registry.metrics_for(SPEC, cell,
                                                           "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)
    for e in SPEC["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_added_files_are_found_without_edits(tmp_path):
    import tiny
    root = tiny.spec_copy(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    before = _digest(bench)
    with open(os.path.join(bench, "configs", "yolov7-tiny-copy.json"),
              "w") as f:
        json.dump(dict(registry.load_config(SPEC, "yolov7-tiny-itcvd"),
                       reduced=[]), f)
    with open(os.path.join(bench, "traffic", "ring-320.json"), "w") as f:
        json.dump(dict(registry.load_traffic("ring-640", bench),
                       tile_px=320), f)
    with open(os.path.join(bench, "checks", "copy-ring-320.json"), "w") as f:
        json.dump({"limits": {"tiles.lost": 0}}, f)
    with open(os.path.join(bench, "metrics", "tiles_read.detect.py"),
              "w") as f:
        f.write("def read(run):\n    return run.layer.get('tiles')\n")
    spec = registry.load_spec(root)
    spec["configs"].append({"name": "yolov7-tiny-copy", "source": "x",
                            "file": "benchmark/configs/yolov7-tiny-copy.json",
                            "reduced": [], "why": "a copy"})
    spec["workloads"].append({"name": "copy-ring-320",
                              "config": "yolov7-tiny-copy",
                              "traffic": "ring-320", "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "detect_tiles_per_s",
                               "unit": "tiles/s", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["copy-ring-320"]})
    spec["per_layer"].append({"name": "tiles_read.detect", "unit": "tiles",
                              "better": "higher", "source": "host_clock",
                              "layer": "ingest", "moves": "detect_tiles_per_s",
                              "workloads": ["copy-ring-320"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    spec = registry.load_spec(root)
    cell = registry.cell(spec, "copy-ring-320")
    assert registry.load_config(spec, cell["config"], root)["reduced"] == []
    assert registry.load_traffic(cell["traffic"], bench)["tile_px"] == 320
    assert registry.driver(registry.load_traffic("ring-320", bench),
                           bench).__name__ == "bench_driver_ring"
    names = [m["name"] for m in registry.metrics_for(spec, "copy-ring-320",
                                                     "per_layer")]
    assert names == ["tiles_read.detect"]
    reader = registry.metric_reader("tiles_read.detect", bench)

    class Run:
        layer = {"tiles": 7}
    assert reader(Run()) == 7
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def _code(path: str) -> str:
    """The Python file's code without its comments and docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.unparse(tree)


def test_harness_names_no_family():
    """Only ``reference/families/`` knows a model family: the shared
    reference has no table of them, and no code under ``lib/``,
    ``drivers/`` or ``run.py`` names one or a family's functions."""
    from benchmark.reference import models
    assert not hasattr(models, "FAMILIES")
    bench = registry.BENCH_DIR
    files = [os.path.join(bench, "run.py")] + [
        os.path.join(bench, d, f) for d in ("lib", "drivers")
        for f in sorted(os.listdir(os.path.join(bench, d)))
        if f.endswith(".py")]
    assert len(files) > 3
    for path in files:
        code = _code(path)
        for word in ("yolov7", "yolov8", "decode_v"):
            assert word not in code, (path, word)


def _family_source(name: str, extra: str) -> str:
    """A copy of the ``yolov7-tiny`` family that logs each call of its
    answer and calibration to ``<this file>.calls``, with ``extra``."""
    with open(os.path.join(registry.BENCH_DIR, "reference", "families",
                           "yolov7-tiny.py")) as f:
        src = f.read()
    return src + extra + """

def _log(what):
    with open(__file__ + ".calls", "a") as f:
        f.write(what + "\\n")


_answer = answer


def answer(*args, **kw):
    _log("answer")
    return _answer(*args, **kw)
"""


# seeded weights of its own: the leaf shapes the configuration lists, the
# shared conv rescale, and the heads at unit deviation with a share of
# each level's objectness logits above the threshold
SEEDED = """

import math

from benchmark.lib.weights import ConvRescale


def shapes(cfg):
    return {k: tuple(v) for k, v in cfg["leaf_shapes"].items()}


class _Calibrate(ConvRescale):
    def head(self, name, feat):
        out = super().head(name, feat)
        kernel = self.w[f"params/{name}/kernel"]
        bias = self.w[f"params/{name}/bias"]
        mean, std = out.mean((0, 1, 2)), out.std((0, 1, 2))
        z = ((out - mean) / std).reshape(-1, out.shape[-1])
        obj = torch.arange(4, out.shape[-1], out.shape[-1] // 3)
        kernel /= std
        bias.sub_(mean).div_(std)
        bias[obj] += math.log(0.3 / 0.7) - torch.quantile(
            z[:, obj], 1.0 - self.spec["class_share_above"], dim=0)
        return super().head(name, feat)


def calibrate(cfg, w, x):
    _log("calibrate")
    forward(cfg, _Calibrate(w, ACT, cfg["bn_eps"], cfg["weights"]), x)
"""


@pytest.mark.parametrize("kind", ["file", "seeded_unit_variance"])
def test_added_family_runs_without_edits(tmp_path, kind):
    """A model family, its configuration, checks and a scan and a ring
    cell, added as new files and entries in a copy of the benchmark: both
    cells run end to end on the CPU through the new family's answer (and,
    seeded, its own weights) and are correct, and no file that was there
    changed."""
    import numpy as np
    import tiny
    root = tiny.spec_copy(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    before = _digest(bench)
    name = "yolov7-tiny-" + kind.split("_")[0]
    cfg = dict(registry.load_config(SPEC, "yolov7-tiny-itcvd"),
               reference=name)
    scan = "scan-1280"
    if kind == "file":
        extra = ""
    else:
        extra = SEEDED
        # seeded logits sit near the threshold, where the scan's bf16
        # 1280 -> 640 resize moves them past its limits: native tiles
        scan = "scan-640"
        with open(os.path.join(bench, "traffic", f"{scan}.json"), "w") as f:
            json.dump(dict(registry.load_traffic("scan-1280", bench),
                           tile_px=640), f)
        with np.load(os.path.join(registry.ROOT, cfg["weights"]["path"])) \
                as z:
            cfg["leaf_shapes"] = {k: list(z[k].shape) for k in z.keys()}
        # bf16 moves unit-deviation logits past the limits that a
        # trained model's meet: f32, so only the family is on trial
        cfg["dtype"] = "float32"
        cfg["weights"] = {"kind": kind, "calib_tiles": 2,
                          "conv_output_std": 0.3,
                          "class_share_above": 0.002}
    family = os.path.join(bench, "reference", "families", f"{name}.py")
    with open(family, "w") as f:
        f.write(_family_source(name, extra))
    with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    spec = registry.load_spec(root)
    spec["configs"].append({"name": name, "source": "x",
                            "file": f"benchmark/configs/{name}.json",
                            "reduced": cfg["reduced"], "why": "a copy"})
    for cell, mix in ((scan, "v7tiny-scan-1280"),
                      ("ring-640", "v7tiny-ring-640")):
        with open(os.path.join(bench, "checks", f"{mix}.json")) as f:
            check = json.load(f)
        with open(os.path.join(bench, "checks", f"{name}.{cell}.json"),
                  "w") as f:
            json.dump(check, f)
        spec["workloads"].append({"name": f"{name}.{cell}", "config": name,
                                  "traffic": cell, "chips": 1, "why": "x"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for cell in (scan, "ring-640"):
        line = tiny.run_cell(f"{name}.{cell}", 23, root=root)
        assert line["correct"] is True, (cell, line["checks"])
        with open(family + ".calls") as f:
            calls = f.read().split()
        os.remove(family + ".calls")
        assert "answer" in calls, cell
        assert ("calibrate" in calls) == (kind != "file"), cell
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
