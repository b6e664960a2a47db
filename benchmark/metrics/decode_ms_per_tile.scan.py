"""Milliseconds a tile of the fetch workers' JPEG decodes: the phase
``tile_decode`` of ``CarDetector.timers``, which adds a scan's part of
``FetchStats.decode_s`` (``fetch/http.py``, ``TileHTTP.decode``), summed
over the window's scans. Thread-seconds of the fetch workers, not wall
time. None where the program has no such phase."""

PHASE = "tile_decode"


def read(run):
    timers = run.layer.get("timers") or {}
    if PHASE not in timers or not run.layer.get("tiles"):
        return None
    return timers[PHASE] / run.layer["tiles"] * 1e3
