"""The readers of the scan's host phases (``metrics/*_ms_per_tile.scan``),
of its step's share of the peak (``step_mfu.scan``) and of its rate
(``tiles_per_s.scan``).

Each phase reader reads its phase of ``CarDetector.timers`` (as the scan
driver hands them over, summed over the window's scans) in milliseconds a
tile, and reads nothing where the program has no such phase (a commit
before the phases existed) or the window finished no tile. The entries are
checked as every other by ``test_bench_harness.py``.
"""

import pytest

from benchmark.lib import registry
from benchmark.lib.result import Result

PHASES = {"request_ms_per_tile.scan": "tile_request",
          "decode_ms_per_tile.scan": "tile_decode",
          "pack_ms_per_tile.scan": "batch_packing",
          "ingest_wait_ms_per_tile.scan": "ingest_wait",
          "dispatch_ms_per_tile.scan": "batch_dispatch",
          "drain_ms_per_tile.scan": "result_drain"}
# the phases a scan timed before these readers' phases existed
OLDER = {"setup": 0.5, "grid_creation": 0.01, "processing": 9.0,
         "tile_fetching": 5.9, "duplicate_removal": 0.4, "saving": 0.6}


def run(timers, tiles):
    return Result(attempted=tiles, failed=0, e2e={}, numbers={},
                  layer={"timers": timers, "tiles": tiles})


@pytest.mark.parametrize("name", sorted(PHASES))
def test_reads_its_phase_in_ms_a_tile(name):
    read = registry.metric_reader(name)
    timers = dict(OLDER, **{p: 0.1 * (k + 1)
                            for k, p in enumerate(PHASES.values())})
    want = timers[PHASES[name]] / 576 * 1e3
    assert read(run(timers, 576)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(PHASES))
def test_reads_nothing_without_its_phase_or_tiles(name):
    read = registry.metric_reader(name)
    assert read(run(dict(OLDER), 576)) is None
    assert read(run(dict(OLDER, **{PHASES[name]: 1.0}), 0)) is None
    assert read(run({}, 576)) is None
    assert read(Result(attempted=0, failed=0, e2e={}, numbers={})) is None


def test_entries_name_the_scan_cell():
    got = {m["name"]: m for m in registry.load_spec()["per_layer"]
           if m["name"] in PHASES}
    assert got.keys() == PHASES.keys()
    for m in got.values():
        assert (m["unit"], m["better"], m["moves"], m["workloads"]) == \
            ("ms/tile", "lower", "card_memory_peak_gib",
             ["v7tiny-scan-1280"])


def test_step_mfu_scan_reads_the_share_of_the_peak():
    read = registry.metric_reader("step_mfu.scan")
    layer = {"timers": dict(OLDER), "tiles": 3 * 576, "window_s": 21.1,
             "chips": 1, "flops_per_tile": 13.02e9}
    ran = Result(attempted=1728, failed=0, e2e={}, numbers={}, layer=layer)
    want = 100.0 * 13.02e9 * 1728 / 21.1 / 989e12
    assert read(ran) == pytest.approx(want, rel=1e-12)
    ran.layer = dict(layer, tiles=0)
    assert read(ran) is None
    entry = {m["name"]: m for m in registry.load_spec()["per_layer"]}[
        "step_mfu.scan"]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"],
            entry["moves"], entry["workloads"]) == \
        ("%", "higher", "host_clock", "step", "card_memory_peak_gib",
         ["v7tiny-scan-1280"])


def test_scan_rate_reads_the_window_s_tiles_a_second():
    read = registry.metric_reader("tiles_per_s.scan")
    layer = {"timers": dict(OLDER), "tiles": 9 * 576, "window_s": 53.4}
    ran = Result(attempted=5184, failed=0, e2e={}, numbers={}, layer=layer)
    assert read(ran) == 9 * 576 / 53.4
    ran.layer = dict(layer, tiles=0)
    assert read(ran) is None
    assert read(Result(attempted=0, failed=0, e2e={}, numbers={})) is None
    entry = {m["name"]: m for m in registry.load_spec()["per_layer"]}[
        "tiles_per_s.scan"]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"],
            entry["moves"], entry["workloads"]) == \
        ("tiles/s", "higher", "host_clock", "scan", "card_memory_peak_gib",
         ["v7tiny-scan-1280"])


def test_scan_cell_reports_step_mfu_when_traced():
    """A traced CPU run of the scan cell (``tiny.run_cell``): the driver
    counts the family's FLOPs a tile after the window, and the share
    reads above 0 (a CPU number, never a card's)."""
    import tiny
    line = tiny.run_cell("v7tiny-scan-1280", 24, trace=1)
    assert line["correct"] is True, line["checks"]
    assert 0.0 < line["metrics"]["step_mfu.scan"]["value"] < 100.0
    assert line["metrics"]["tiles_per_s.scan"]["value"] > 0.0
