"""Milliseconds a tile of the fetch workers' requests: the phase
``tile_request`` of ``CarDetector.timers``, which adds a scan's part of
``FetchStats.request_s`` (``fetch/http.py``, every attempt of
``TileHTTP.get``), summed over the window's scans. Thread-seconds of
the fetch workers, not wall time. None where the program has no such
phase."""

PHASE = "tile_request"


def read(run):
    timers = run.layer.get("timers") or {}
    if PHASE not in timers or not run.layer.get("tiles"):
        return None
    return timers[PHASE] / run.layer["tiles"] * 1e3
