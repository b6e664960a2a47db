"""Ring driver: bulk detection over decoded host tiles, the city scan's
path with the fetch left out.

The mix's file gives the pool (``pool_tiles`` distinct tiles rendered from
the seed by ``lib.tiles.render_tiles``, ``tile_px`` at ``px_per_m``), the
batch, the prefetch depth and the confidence threshold. In the window the
program runs ``ingest.pipeline.run_pipeline`` over a
``ThreadedPrefetcher(assemble_batches(tiles, batch, tile_px,
layout=step.input_layout), depth)``, closed loop: the tiles come as fast
as the pipeline takes them, each with bounds of its own, until
``--seconds`` have passed (checked at batch boundaries); the window ends
when the last batch has been read back. ``on_result`` reads each batch
back as ``CarDetector._collect`` does, through
``post.georef.detections_to_records``.

Set-up renders the pool, makes the weights, builds the step and runs
``warm_batches`` batches through the same pipeline. After the window the
configuration's family (f32, TF32 off) runs over the pool, and the
records of a sample of the window's tiles drawn from the seed are
compared with it.
"""

import math
import time

import numpy as np
import torch

from benchmark.lib import check, program, roofline, tiles, weights
from benchmark.lib.result import Result
from benchmark.lib.spans import Spans, StepProxy
from benchmark.lib.trace import TracedWindow
from benchmark.reference import post as ref_post

MAX_TILES = 1 << 21
M_PER_DEG = 111319.9


class TileStream:
    """The window's tiles: index i shows pool tile ``order[i % pool]`` and
    has bounds of its own, ``span_m`` square, on a grid of 4096 columns
    from (21 E, 52.2 N), held as f32 as a batch holds them."""

    def __init__(self, pool: np.ndarray, order: np.ndarray, span_m: float):
        self.pool = pool
        self.order = order
        self.dlat = span_m / M_PER_DEG
        self.dlon = span_m / (M_PER_DEG * math.cos(math.radians(52.2)))
        self.stop_at = None
        self.count = None
        self.produced = 0

    def pool_index(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def bounds(self, i: int) -> tuple:
        west = 21.0 + (i % 4096) * self.dlon
        south = 52.2 + (i // 4096) * self.dlat
        b = np.asarray((west, south, west + self.dlon, south + self.dlat),
                       np.float32)
        return tuple(float(v) for v in b)

    def tiles(self, batch: int):
        from aerial_image_recognition_tpu_torch.fetch.xyz import TileImage
        i = 0
        while True:
            if i % batch == 0 and (
                    (self.count is not None and i >= self.count)
                    or (self.stop_at is not None
                        and time.perf_counter() >= self.stop_at)):
                self.produced = i
                return
            yield i, TileImage(self.pool[self.pool_index(i)], self.bounds(i))
            i += 1


class NmsSpy:
    """Counts the NMS kernel's calls while installed: shapes, and the
    picks each made (summed on the device), for ``nms_roofline``."""

    def __init__(self):
        from aerial_image_recognition_tpu_torch.ops import nms_kernel
        self.mod = nms_kernel
        self.kernel = nms_kernel.nms_suppress
        self.calls = []
        self.picks = []

    def __call__(self, boxes_t, scores, classes, **kw):
        out = self.kernel(boxes_t, scores, classes, **kw)
        b, _, k = boxes_t.shape
        self.calls.append((b, k, kw["max_det"]))
        self.picks.append((out[1] > -1.0).sum())
        return out

    def install(self):
        # the wrapper counts its launches on the module's nms_suppress
        self.launches = self.kernel.launches
        self.mod.nms_suppress = self

    def remove(self):
        self.mod.nms_suppress = self.kernel
        self.kernel.launches = self.launches

    def bound_s(self) -> float:
        picks = [int(p) for p in self.picks]
        return sum(roofline.nms_bound_s(b, k, d, r)
                   for (b, k, d), r in zip(self.calls, picks))


def _prefetcher(step, stream, batch: int, t: dict):
    from aerial_image_recognition_tpu_torch.ingest.pipeline import (
        ThreadedPrefetcher, assemble_batches)
    return ThreadedPrefetcher(assemble_batches(
        stream.tiles(batch), batch, t["tile_px"], layout=step.input_layout),
        depth=t["prefetch_depth"])


def run(ctx) -> Result:
    from aerial_image_recognition_tpu_torch.post.georef import (
        detections_to_records)
    t = ctx.traffic
    cfg_model = ctx.config
    devices = ctx.devices
    batch = t["batch_per_card"] * len(devices)
    rng = np.random.default_rng(ctx.seed)
    pool, _ = tiles.render_tiles(rng, t["pool_tiles"], t["tile_px"],
                                 t["px_per_m"], tuple(t["cars_per_tile"]))
    order = rng.permutation(t["pool_tiles"])
    sample = rng.random(MAX_TILES) < t["sample_share"]
    flat, tree = weights.make(cfg_model, ctx.family, ctx.seed, devices[0],
                              ctx.root, pool)
    cfg = program.detector_config(
        cfg_model, confidence_threshold=t["confidence"],
        device_batch=batch, prefetch_batches=t["prefetch_depth"])
    step = program.detect_step(cfg, program.bundle(cfg_model, tree,
                                                   devices[0]),
                               devices, batch, control=ctx.control,
                               calib=pool[:t["calib_tiles"]])
    spans = Spans() if ctx.trace else None
    driven = StepProxy(step, spans) if ctx.trace else step
    class_names = step.bundle.spec.class_names
    span_m = t["tile_px"] / t["px_per_m"]
    m_per_px = span_m / step.model_size
    got = {}
    done_at = []
    seen = np.zeros(MAX_TILES, np.uint8)
    traced = TracedWindow(f"{ctx.tmp}/ring-trace.json") if ctx.trace \
        else None
    spy = NmsSpy() if ctx.trace else None
    trace_at = [None]

    def collect(b, out):
        recs = detections_to_records(out[0], b.bounds,
                                     model_size=step.model_size,
                                     class_names=class_names)
        for r in recs:
            g = int(b.indices[r.pop("tile_index")])
            if g >= 0 and sample[g]:
                got.setdefault(g, []).append(
                    (r["lon"], r["lat"], r["confidence"], r["class"],
                     r["yolo"]["w"] * m_per_px, r["yolo"]["h"] * m_per_px))
        seen[b.indices[:b.n_valid]] += 1
        done_at.append(time.perf_counter())

    def on_result(b, out):
        if traced is not None:
            if trace_at[0] is not None and traced.prof is None \
                    and traced.t0 is None \
                    and time.perf_counter() >= trace_at[0]:
                spy.install()
                traced.start()
            with spans.span("readback"):
                collect(b, out)
        else:
            collect(b, out)

    # set-up: the same pipeline over warm_batches batches
    from aerial_image_recognition_tpu_torch.ingest.pipeline import (
        run_pipeline)
    warm = TileStream(pool, order, span_m)
    warm.count = t["warm_batches"] * batch
    prefetch = _prefetcher(step, warm, batch, t)
    try:
        run_pipeline(prefetch, driven, lambda b, o: detections_to_records(
            o[0], b.bounds, model_size=step.model_size,
            class_names=class_names))
    finally:
        prefetch.close()
    program.synchronize(devices)
    flops_per_tile = ctx.family.flops(cfg_model, flat, 1, step.model_size)
    setup_s = time.perf_counter() - ctx.t_start

    stream = TileStream(pool, order, span_m)
    t0 = time.perf_counter()
    cpu0 = time.process_time()
    stream.stop_at = t0 + ctx.seconds
    trace_at[0] = t0 + max(0.0, ctx.seconds - t["trace_seconds"])
    prefetch = _prefetcher(step, stream, batch, t)
    try:
        stats = run_pipeline(spans.iterate(prefetch, "ingest_wait")
                             if ctx.trace else prefetch, driven, on_result)
    finally:
        prefetch.close()
        if traced is not None and traced.prof is not None:
            traced.stop(devices)
            spy.remove()
    window_s = time.perf_counter() - t0
    cpu_s = time.process_time() - cpu0
    produced = stream.produced
    lost = int((seen[:produced] != 1).sum() + seen[produced:].sum())
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) \
        if devices[0].type == "cuda" else 0
    nms_bound = spy.bound_s() if spy is not None else None
    nms_calls = len(spy.calls) if spy is not None else 0
    summary = traced.reduce() if traced is not None \
        and traced.window_s is not None else None
    del step, driven, spy
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()

    # the reference over the pool, then the sample's tiles
    def reference(weights_f32):
        kept = []
        with torch.no_grad():
            for lo in range(0, len(pool), t["reference_block"]):
                x = ref_post.to_model_input(
                    torch.from_numpy(pool[lo:lo + t["reference_block"]])
                    .to(devices[0]), cfg_model["input_size"])
                kept += ctx.family.answer(
                    cfg_model, weights_f32, x, conf=ctx.check["floor"],
                    iou_thr=cfg.nms_iou_threshold,
                    max_det=ctx.check["reference_max_det"],
                    pre_topk=ctx.check["reference_pre_topk"])
        return kept

    names = cfg_model["class_names"]

    def dets(kept, bounds):
        box, score, cls = kept
        lon, lat = ref_post.lonlat(box[:, :2], bounds,
                                   cfg_model["input_size"])
        return check.Dets(lon, lat, score, [names[c] for c in cls],
                          box[:, 2] * m_per_px, box[:, 3] * m_per_px)

    ref_pool = reference(flat)
    prog, ref = {}, {}
    for g in np.nonzero(sample[:produced])[0].tolist():
        ref[g] = dets(ref_pool[stream.pool_index(g)], stream.bounds(g))
        rows = got.get(g, [])
        prog[g] = check.Dets(*(zip(*rows) if rows else ([],) * 6))
    numbers = check.compare(prog, ref, lost, ctx.check)

    tiles_done = stats["tiles"]
    # tiles a second in each fifth of the window: the rate's drift
    fifths = np.histogram(np.asarray(done_at) - t0, bins=5,
                          range=(0.0, window_s))[0]
    layer = {"rate_by_fifth": (fifths * batch * 5 / window_s).tolist(),
             "window_s": window_s, "tiles": tiles_done,
             "batches": stats["batches"], "stage_s": stats["h2d_s"],
             "chips": len(devices), "cpu_s": cpu_s,
             "flops_per_tile": flops_per_tile, "nms_bound_s": nms_bound,
             "nms_calls": nms_calls}
    return Result(attempted=produced, failed=lost,
                  e2e={"detect_tiles_per_s": tiles_done / window_s,
                       "card_memory_peak_gib": peak / 2 ** 30,
                       "setup_s": setup_s},
                  numbers=numbers, layer=layer, spans=spans, trace=summary,
                  cards=[d.index or 0 for d in devices],
                  memory_peak_bytes=peak)
