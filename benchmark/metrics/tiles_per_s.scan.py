"""The scan's rate, in tiles/s: the tiles of the window's whole scans
over the time from the window's start to the end of its last scan, as a
user of the scan feels it. It follows the speed of the host's cores,
which drifts between runs by more than any end-to-end bound holds."""


def read(run):
    lay = run.layer
    if not lay.get("tiles") or not lay.get("window_s"):
        return None
    return lay["tiles"] / lay["window_s"]
