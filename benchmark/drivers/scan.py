"""Scan driver: whole ``CarDetector`` city scans against the benchmark's
own WMS server, back to back.

The mix's file gives the grid (``grid`` x ``grid`` tiles of ``tile_m``
metres at ``overlap``, ``tile_px`` pixels each, around (lon0, lat0)), the
world's car density, the JPEG quality, the scan's batch, fetch workers and
dedup radius. Set-up starts the server (``lib/wms_server.py``, a process of
its own), builds the step as ``CarDetector.detect`` would
(``_step_config``, batch, the fetcher's tile size) and injects it, and runs
one whole scan: the server's pool renders every tile of the grid then, and
serves them from memory after. In the window, scans run one after another
until one ends past ``--seconds``; each writes its GeoJSON and shapefile
over the previous one's. The rate (``tiles_per_s.scan``, per layer) is
the tiles of those scans over the time from the window's start to the
end of its last scan; end to end the run reports the card's memory peak.

After the window the reference decodes the last scan's tiles as the
server sends them, resizes them to the model's size, runs the
configuration's family (its f32 forward, decode and suppression),
lon/lat and dedup, and the records of the last scan's GeoJSON are
compared with it region by region (each record to the tile whose centre
is nearest). The family's FLOPs a tile are counted then too, for
``step_mfu.scan``.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from benchmark.lib import check, program, tiles, weights
from benchmark.lib.result import Result
from benchmark.lib.spans import Spans, StepProxy
from benchmark.lib.trace import TracedWindow
from benchmark.reference import post as ref_post

M_PER_DEG = 111319.9
SERVER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "lib", "wms_server.py")


class Server:
    """The WMS server process, stopped and waited for on close."""

    def __init__(self, params: dict):
        self.proc = subprocess.Popen(
            [sys.executable, SERVER, json.dumps(params)],
            stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line.startswith("PORT "):
            self.close()
            raise RuntimeError(f"the WMS server did not start: {line!r}")
        self.url = f"http://127.0.0.1:{int(line.split()[1])}"

    def get(self, path: str) -> bytes:
        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            return r.read()

    def tile(self, bbox, px: int) -> bytes:
        box = ",".join(repr(float(v)) for v in bbox)
        return self.get(f"/wms?SERVICE=WMS&VERSION=1.1.1&REQUEST=GetMap"
                        f"&LAYERS=aerial&STYLES=&SRS=EPSG:4326&BBOX={box}"
                        f"&WIDTH={px}&HEIGHT={px}&FORMAT=image/jpeg")

    def close(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.proc.stdout.close()


def aoi(t: dict):
    """(w, s, e, n) of a square that the scan's grid covers with
    ``grid`` tiles a side: (grid - 1/2) steps of tile_m * (1 - overlap)."""
    half = (t["grid"] - 0.5) * t["tile_m"] * (1 - t["overlap"]) / 2
    dlon = half / (M_PER_DEG * math.cos(math.radians(t["lat0"])))
    dlat = half / M_PER_DEG
    return (t["lon0"] - dlon, t["lat0"] - dlat, t["lon0"] + dlon,
            t["lat0"] + dlat)


def scan_config(t: dict, frame: str, url: str, confidence: float) -> dict:
    return {"frame_path": frame, "wms_url": url + "/wms",
            "wms_layer": "aerial", "wms_srs": "EPSG:4326",
            "wms_size": (t["tile_px"], t["tile_px"]),
            "tile_size_meters": t["tile_m"], "tile_overlap": t["overlap"],
            "confidence_threshold": confidence,
            "duplicate_distance": t["dedup_m"], "batch_size": t["batch"],
            "device_batch": t["batch"], "num_workers": t["fetch_workers"],
            "submit_spacing": t["submit_spacing"]}


def _read_records(path: str, names):
    with open(path) as f:
        doc = json.load(f)
    rows = [(*f["geometry"]["coordinates"][:2], f["properties"]["confidence"],
             f["properties"].get("class", names[0]))
            for f in doc["features"]]
    return rows, doc.get("metadata", {})


def run(ctx) -> Result:
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    t = ctx.traffic
    cfg_model = ctx.config
    devices = ctx.devices
    base = os.path.join(ctx.tmp, "scan")
    os.makedirs(base, exist_ok=True)
    frame = os.path.join(base, "aoi.geojson")
    w, s, e, n = aoi(t)
    with open(frame, "w") as f:
        json.dump({"type": "FeatureCollection", "features": [{
            "type": "Feature", "properties": {}, "geometry": {
                "type": "Polygon", "coordinates": [[[w, s], [e, s], [e, n],
                                                    [w, n], [w, s]]]}}]}, f)
    extent = (t["grid"] + 2) * t["tile_m"]
    server = Server({"seed": ctx.seed, "lon0": t["lon0"], "lat0": t["lat0"],
                     "extent_m": extent, "cars_per_km2": t["cars_per_km2"],
                     "jpeg_quality": t["jpeg_quality"],
                     "render_workers": t["render_workers"]})
    try:
        return _run(ctx, t, cfg_model, devices, base, frame, server,
                    CarDetector)
    finally:
        server.close()


def _run(ctx, t, cfg_model, devices, base, frame, server, CarDetector):
    conf = scan_config(t, frame, server.url, t["confidence"])
    calib, _ = tiles.render_tiles(np.random.default_rng(ctx.seed),
                                  t["calib_tiles"], cfg_model["input_size"])
    flat, tree = weights.make(cfg_model, ctx.family, ctx.seed, devices[0],
                              ctx.root, calib)
    cfg = CarDetector(base, dict(conf, **{
        "model_path": cfg_model["registry"],
        "model_family": cfg_model["family"],
        "num_classes": cfg_model["nc"],
        "dtype": cfg_model["dtype"]}))._step_config()
    step = program.detect_step(cfg, program.bundle(cfg_model, tree,
                                                   devices[0]),
                               devices, t["batch"], src_size=t["tile_px"],
                               control=ctx.control, calib=calib)
    spans = Spans() if ctx.trace else None
    driven = StepProxy(step, spans) if ctx.trace else step

    def scan():
        det = CarDetector(base, conf, detect_step=driven)
        with contextlib.redirect_stdout(sys.stderr):
            out = det.detect(force_restart=True)
        return out, dict(det.timers.totals)

    scan()                                   # set-up: renders every tile
    program.synchronize(devices)
    rendered = json.loads(server.get("/served"))["renders"]
    setup_s = time.perf_counter() - ctx.t_start

    traced = TracedWindow(os.path.join(ctx.tmp, "scan-trace.json")) \
        if ctx.trace else None
    scans = []
    t0 = time.perf_counter()
    cpu0 = time.process_time()
    while not scans or time.perf_counter() < t0 + ctx.seconds:
        if traced is not None and len(scans) == 1:
            traced.start()
            try:
                with spans.span("scan"):
                    scans.append(scan())
            finally:
                traced.stop(devices)
        else:
            scans.append(scan())
    window_s = time.perf_counter() - t0
    cpu_s = time.process_time() - cpu0
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) \
        if devices[0].type == "cuda" else 0
    summary = traced.reduce() if traced is not None \
        and traced.window_s is not None else None
    names = cfg_model["class_names"]
    rows, meta = _read_records(os.path.join(
        base, "output", "detections_results.geojson"), names)
    served = json.loads(server.get("/served"))
    del step, driven
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()

    # the reference over the last scan's tiles, as the server sends them
    bboxes = np.asarray(served["bboxes"], np.float64)
    with ThreadPoolExecutor(8) as pool:
        pixels = list(pool.map(lambda b: np.asarray(Image.open(io.BytesIO(
            server.tile(b, t["tile_px"]))).convert("RGB")), bboxes))
    lon_l, lat_l, conf_l, cls_l = [], [], [], []
    size = cfg_model["input_size"]
    with torch.no_grad():
        for lo in range(0, len(pixels), t["reference_block"]):
            block = np.stack(pixels[lo:lo + t["reference_block"]])
            x = ref_post.to_model_input(torch.from_numpy(block)
                                        .to(devices[0]), size)
            kept = ctx.family.answer(
                cfg_model, flat, x, conf=ctx.check["floor"],
                iou_thr=cfg.nms_iou_threshold,
                max_det=ctx.check["reference_max_det"],
                pre_topk=ctx.check["reference_pre_topk"])
            for k, (box, score, cls) in enumerate(kept):
                lon, lat = ref_post.lonlat(box[:, :2], bboxes[lo + k], size)
                lon_l.append(lon)
                lat_l.append(lat)
                conf_l.append(score)
                cls_l += [names[c] for c in cls]
    lon, lat, conf_r = (np.concatenate(v) if v else np.zeros(0)
                        for v in (lon_l, lat_l, conf_l))
    flops_per_tile = ctx.family.flops(cfg_model, flat, 1, size)
    keep = ref_post.dedup(lon, lat, conf_r, t["dedup_m"])
    ref_rows = list(zip(lon[keep], lat[keep], conf_r[keep],
                        np.asarray(cls_l)[keep]))
    centres = np.stack([(bboxes[:, 0] + bboxes[:, 2]) / 2,
                        (bboxes[:, 1] + bboxes[:, 3]) / 2], 1)

    def by_region(rs):
        groups = {}
        if rs:
            pts = np.asarray([(r[0], r[1]) for r in rs])
            kx = math.cos(math.radians(t["lat0"]))
            d = ((pts[:, None, 0] - centres[None, :, 0]) * kx) ** 2 \
                + (pts[:, None, 1] - centres[None, :, 1]) ** 2
            for r, g in zip(rs, np.argmin(d, 1).tolist()):
                groups.setdefault(g, []).append(r)
        return {g: check.Dets(*zip(*v)) for g, v in groups.items()}

    prog = by_region(rows)
    ref = by_region(ref_rows)
    for g in range(len(bboxes)):
        ref.setdefault(g, check.Dets([], [], [], []))
    last = scans[-1][0]
    ingest = meta.get("ingest_stats", {})
    lost = last["tiles"] - int(ingest.get("tiles", 0))
    numbers = check.compare(prog, ref, lost, ctx.check)

    tiles_done = sum(o["tiles"] for o, _ in scans)
    timers = {}
    for _, tm in scans:
        for k, v in tm.items():
            timers[k] = timers.get(k, 0.0) + v
    layer = {"window_s": window_s, "tiles": tiles_done, "scans": len(scans),
             "timers": timers, "chips": len(devices), "cpu_s": cpu_s,
             "renders_in_window": served["renders"] - rendered,
             "flops_per_tile": flops_per_tile}
    return Result(attempted=tiles_done, failed=lost,
                  e2e={"card_memory_peak_gib": peak / 2 ** 30,
                       "setup_s": setup_s},
                  numbers=numbers, layer=layer, spans=spans, trace=summary,
                  cards=[d.index or 0 for d in devices],
                  memory_peak_bytes=peak)
