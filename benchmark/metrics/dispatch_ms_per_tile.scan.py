"""Milliseconds a tile of the main thread's uploads and step dispatches:
the phase ``batch_dispatch`` of ``CarDetector.timers``
(``ingest/pipeline.py``, ``run_pipeline``; the upload ring's first
pinned allocation falls here), summed over the window's scans. None
where the program has no such phase."""

PHASE = "batch_dispatch"


def read(run):
    timers = run.layer.get("timers") or {}
    if PHASE not in timers or not run.layer.get("tiles"):
        return None
    return timers[PHASE] / run.layer["tiles"] * 1e3
