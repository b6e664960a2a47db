"""The scan cell's WMS server measured alone, without the program.

    python3 benchmark/tools/server_rate.py [--seed N] [--workers 25]

Starts the server of the ``scan-1280`` mix, asks for every tile of a
grid of the mix's size and tile footprint once (so that the server's pool
renders them), then fetches the whole grid again with ``--workers``
threads, first the bytes alone and then decoded with PIL, and prints the
tiles a second of each as one JSON line. A scan that reads far below
these rates is not held back by its load generator.
"""

import argparse
import io
import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.drivers.scan import Server, aoi  # noqa: E402
from benchmark.lib import registry  # noqa: E402


def grid(t: dict):
    w, s, _, _ = aoi(t)
    step = t["tile_m"] * (1 - t["overlap"])
    kx = 111319.9 * math.cos(math.radians(t["lat0"]))
    out = []
    for j in range(t["grid"]):
        for i in range(t["grid"]):
            x0, y0 = w + i * step / kx, s + j * step / 111319.9
            out.append((x0, y0, x0 + t["tile_m"] / kx,
                        y0 + t["tile_m"] / 111319.9))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--workers", type=int, default=25)
    args = p.parse_args()
    t = registry.load_traffic("scan-1280")
    server = Server({"seed": args.seed, "lon0": t["lon0"], "lat0": t["lat0"],
                     "extent_m": (t["grid"] + 2) * t["tile_m"],
                     "cars_per_km2": t["cars_per_km2"],
                     "jpeg_quality": t["jpeg_quality"],
                     "render_workers": t["render_workers"]})
    try:
        boxes = grid(t)
        px = t["tile_px"]
        out = {"tiles": len(boxes)}
        with ThreadPoolExecutor(args.workers) as pool:
            t0 = time.perf_counter()
            sizes = list(pool.map(lambda b: len(server.tile(b, px)), boxes))
            out["render_s"] = time.perf_counter() - t0
            out["jpeg_bytes_mean"] = float(np.mean(sizes))
            t0 = time.perf_counter()
            list(pool.map(lambda b: server.tile(b, px), boxes))
            out["fetch_tiles_per_s"] = len(boxes) / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            list(pool.map(lambda b: np.asarray(Image.open(io.BytesIO(
                server.tile(b, px))).convert("RGB")), boxes))
            out["fetch_decode_tiles_per_s"] = len(boxes) / (
                time.perf_counter() - t0)
    finally:
        server.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
