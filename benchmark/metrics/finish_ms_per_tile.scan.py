"""Milliseconds a tile in the scans' ``duplicate_removal``, ``saving`` and
``checkpointing`` phases (``CarDetector.timers``), summed over the
window's scans."""


def read(run):
    timers = run.layer.get("timers")
    if not timers or not run.layer.get("tiles"):
        return None
    return sum(timers.get(k, 0.0) for k in (
        "duplicate_removal", "saving", "checkpointing")) \
        / run.layer["tiles"] * 1e3
