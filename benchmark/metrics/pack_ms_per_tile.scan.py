"""Milliseconds a tile of the prefetch thread's batch packing: the phase
``batch_packing`` of ``CarDetector.timers`` (``ingest/pipeline.py``,
``assemble_batches``: each tile's copy into the batch buffer and each
batch's copies out, not the pulls from the fetch), summed over the
window's scans. None where the program has no such phase."""

PHASE = "batch_packing"


def read(run):
    timers = run.layer.get("timers") or {}
    if PHASE not in timers or not run.layer.get("tiles"):
        return None
    return timers[PHASE] / run.layer["tiles"] * 1e3
