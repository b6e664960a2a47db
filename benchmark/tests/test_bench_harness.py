"""Discovery by name and the shape of ``BENCHMARK.json``.

Every entry resolves to its files; a configuration, a mix, a check and a
per-layer metric added as new files and entries in a copy of the
benchmark are found without any existing file changing; each per-layer
metric moves one end-to-end metric that every cell it lists reports;
names, units and keys keep to the benchmark's contract.
"""

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
