"""Milliseconds a tile of the main thread's result drains: the phase
``result_drain`` of ``CarDetector.timers`` (``ingest/pipeline.py``,
``run_pipeline``: the readback stream's wait and the scan's records,
results and checkpoints), summed over the window's scans. None where the
program has no such phase."""

PHASE = "result_drain"


def read(run):
    timers = run.layer.get("timers") or {}
    if PHASE not in timers or not run.layer.get("tiles"):
        return None
    return timers[PHASE] / run.layer["tiles"] * 1e3
