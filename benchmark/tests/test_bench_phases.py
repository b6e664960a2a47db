"""The readers of the scan's host phases (``metrics/*_ms_per_tile.scan``).

Each reads its phase of ``CarDetector.timers`` (as the scan driver hands
them over, summed over the window's scans) in milliseconds a tile, and
reads nothing where the program has no such phase (a commit before the
phases existed) or the window finished no tile. The entries are checked
as every other by ``test_bench_harness.py``.
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
            ("ms/tile", "lower", "scan_tiles_per_s", ["v7tiny-scan-1280"])
