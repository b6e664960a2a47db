"""Milliseconds a tile in the scans' ``tile_fetching`` phase
(``CarDetector.timers``: WMS requests and decode, chunk by chunk, on the
prefetch thread), summed over the window's scans."""


def read(run):
    timers = run.layer.get("timers")
    if not timers or not run.layer.get("tiles"):
        return None
    return timers.get("tile_fetching", 0.0) / run.layer["tiles"] * 1e3
