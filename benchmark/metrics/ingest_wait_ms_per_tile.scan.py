"""Milliseconds a tile that the main thread waits for batches: the phase
``ingest_wait`` of ``CarDetector.timers`` (``ingest/pipeline.py``,
``run_pipeline``: each ``next()`` on the prefetcher, the card's starved
time as the program sees it), summed over the window's scans. None where
the program has no such phase."""

PHASE = "ingest_wait"


def read(run):
    timers = run.layer.get("timers") or {}
    if PHASE not in timers or not run.layer.get("tiles"):
        return None
    return timers[PHASE] / run.layer["tiles"] * 1e3
