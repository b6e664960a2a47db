#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (aerial_image_recognition_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero, and no result line is printed):
  1. the card, from nvidia-smi (name, power limit);
  2. build every CUDA kernel from ``csrc/``, all nvcc processes at once
     (timed);
  3. each kernel against its plain PyTorch version on the card, at the
     paths' shapes, tolerance 0: NMS (``NMS_CASES``: B=64, K=256, D=64,
     class-agnostic and class-aware, score ties, all below the confidence
     threshold, tile-like rows that end early; K=40 < D, K=250, K=1024 with
     D=128, and the city scan's B=64, K=1024, D=256; and two rows outside
     the priority-order contract, which take
     the kernel's general path) with bit-identical picks, timed on the
     sweep, on a tile-like input and on the general path (device time of
     the kernel alone by torch.profiler, and CUDA events through the
     wrapper beside it); the f32
     native-size preprocess and the device lon/lat on the card equal to the
     CPU's (tolerance 0); the CLAHE LUT application (B=64, 640x640, 8x8
     tiles, V=3 and V=1; ragged B=2, 250x237) with raw f32 outputs equal;
     kernel, plain and bound times; and the rest of CLAHE on the card
     against the same functions on the CPU: histograms, LUTs and the gray
     path equal (tolerance 0), the RGB path within the CPU tests' tolerance;
  4. the main path at full width: the YOLOv7-tiny detect step from the
     trained fixture, 640 px, batch 64, bf16, on synthetic 0.5 m/px tiles
     with known car positions; step time and tiles/s; its detections held
     against the port's f32 step on the same card (matched fraction ≥ 0.9 at
     IoU 0.5, detection_sets_agree) and against the rendered cars;
  5. the port's DetectionServer over that step answers JPEG POST /detect
     requests;
 10. the city scan on the card, run right after phase 5: (a)
     ``run_pipeline`` alone over 8 pre-assembled 640-px batches in host
     memory (each pass runs them twice) through the pinned upload ring,
     its staging thread and copy stream, in turns with the step's own
     per-call upload: every batch's detections equal (tolerance 0) the same
     step called per batch on device-resident copies, and the step makes no
     host sync (``torch.cuda.set_sync_debug_mode``); tiles/s beside phase
     4's two step times, the time split (h2d, compute, readback wait) and
     the idle share from one profiler window; (b) a ``CarDetector`` scan of the
     port's FakeWorld (10 000 cars over 0.05°) served by the port's
     FakeTileServer over WMS JPEG, 640 px a 320 m tile, the central 0.04°
     square (about 230 tiles, 4 batches, the last padded), with the step
     ``detect()`` builds on ``cuda``: recall ≥ 0.8 within 3 m, no two
     records within the 2 m dedup radius, GeoJSON, coverage and shapefile
     written, the checkpoint cleared, one NMS launch a batch at B=64,
     K=1024, D=256; tiles/s (host-bound), phase timings, fetch stats, which
     native helpers ran, peak memory;
  6. the TTA step (8 variations, 512 images per forward) at the same width,
     batch and dtype: step time, tiles/s, stage times, peak memory; its
     detections held against the rendered cars (recall ≥ 0.8) and against
     the single-scale bf16 step of phase 4 (matched ≥ 0.9);
  7. the multiscale step ([0.85, 1.0, 1.15], default weights and box
     voting), with the same two checks;
  8. the int8 path at full width: (a) the s8×s8→s32 convolution on the
     card (``torch._int_mm`` over an int8 im2col) equal to the CPU's int32
     ``F.conv2d`` at the trunk's own shapes (``INT8_CASES``, tolerance 0),
     the requantizing epilogue kernel equal to its plain version on the
     card and to the CPU's codes, each timed beside the bf16 cuDNN conv of
     the same shape; (b) the int8 trunk on the card against itself on the
     CPU on 4 tiles and the same qparams (codes at the three taps, boxes,
     scores); (c) turnkey: ``build_detect_step`` with ``quantize="int8"``
     and no calibration file calibrates on its first two batches and must
     reach state ``int8``; step time, tiles/s and peak memory beside the
     bf16 step's; matched ≥ 0.9 against the bf16 step, recall ≥ 0.8; a step
     built from the saved calibration gives the same detections (tolerance
     0); (d) a DetectionServer over a fresh turnkey step answers JPEG
     requests through the swap and reports ``quantize_state`` in /stats;
     (e) the int8 bundle under the TTA ladder against the bf16 TTA step;
  9. the other detector families, seeded or trained weights: (a)
     ``yolov8_tokyo`` (YOLOv8l, nc=2) at full width, 640 px, batch 64,
     bf16: step time (host and device input), tiles/s, peak memory, GFLOP
     per tile and its bound; raw head maps of 2 tiles in f32 on the card
     against the CPU; one step at a confidence threshold low enough to fill
     the 64 slots, whose class-aware NMS candidates (both classes) the
     kernel must pick bit-identically to the plain version, timed there;
     (b) ``yolov8n`` from the trained fixture on 96-px tiles at its
     training scale (0.1 m/px), batch 64: bf16 against f32 on the card,
     car-centred tiles found and empty tiles quiet, a DetectionServer
     answering JPEG requests with class names; (c) ``yolov7_base`` at full
     width, as (a) without the low-threshold run; (d) int8: the integer
     product at the new families' shapes (``INT8_CASES``) equal to the
     CPU's; the int8 trunks of YOLOv8l and yolov7-base on the card against
     the CPU (4 tiles at 320 px, one calibration); turnkey on the trained
     nano must reach ``int8``; int8 YOLOv8l and yolov7-base steps timed in
     turns with their bf16 steps.
Launch counts are zeroed just before each path (4–5, 10a, 10b, 6, 7, 8c–d,
9a, 9b, 9c, 9d) and read just after it; every kernel of a path must have launched
in its window. The steps are profiled after every timed step (YOLOv8l's at
the end of phase 9); the multiscale step is then timed once more, to show
whether a profile earlier in the process moves later timings.

Output: the card line, then a ``{"kernels": [...]}`` JSON line, then the
last line ``{"ok": true, "device": {...}}``. The full record also goes to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX.

``python3 chip_smoke.py --scan-only`` runs phases 1–2, the NMS kernel
against its plain version, the default step's two timings and phase 10
alone (record in ``chiprun_out/chip_smoke_scan.json``).
"""

import io
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "yolov7_tiny_fakeworld.npz")
V8_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "yolov8n_fakeworld.npz")
B, SIZE, K, D = 64, 640, 256, 64
V8N_SIZE = 96                   # the trained nano's tiles: 9.6 m at 0.1 m/px
TRUNK_SIZE = 320                # the int8 trunks' card-vs-CPU check (9d)
GRID, CLIPS = (8, 8), (2.0, 3.0, 4.0)       # the TTA ladder's CLAHE
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 (non-tensor)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12                         # tensor cores, dense
INT8_OPS = 1979e12                          # tensor cores, dense
TRUNK_CONVS = 53                            # int8 convs of YOLOv7-tiny
# the int8 trunk's convolutions: (case, batch, input edge, channels of the
# concatenated parts, output channels, kernel, stride)
INT8_CASES = [
    ("1x1 64->32 @160", B, 160, (64,), 32, 1, 1),
    ("3x3 32->32 @160", B, 160, (32,), 32, 3, 1),
    ("3x3/2 64->128 @160", B, 160, (64,), 128, 3, 2),
    ("1x1 1024->256 @20", B, 20, (1024,), 256, 1, 1),
    ("3x3 256->512 @20", B, 20, (256,), 512, 3, 1),
    ("1x1 concat 4x32->64 @160", B, 160, (32, 32, 32, 32), 64, 1, 1),
    # the other families (9d): yolov8n's 16-channel bottleneck (K = 144,
    # N = 16), a YOLOv8l bottleneck and C2f cv2 over five parts, a P5
    # tower conv at batch 1 (M = 400, the server's shape), yolov7-base's
    # six-tap ELAN-H out and SPPCSPC cv5
    ("v8n 3x3 16->16 @160", B, 160, (16,), 16, 3, 1),
    ("v8l 3x3 64->64 @160", B, 160, (64,), 64, 3, 1),
    ("v8l 1x1 concat 5x64->128 @160", B, 160, (64,) * 5, 128, 1, 1),
    ("v8l tower 3x3 512->64 @20 batch 1", 1, 20, (512,), 64, 3, 1),
    ("v7b 1x1 concat 4x128+2x256->256 @40", B, 40,
     (128, 128, 128, 128, 256, 256), 256, 1, 1),
    ("v7b 1x1 concat 4x512->512 @20", B, 20, (512,) * 4, 512, 1, 1),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean device time of fn() over n runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(torch, fn, n: int, kernel: str):
    """(device ms, event ms) of fn(), which launches the named kernel: the
    mean device time of that kernel alone over n calls, from
    torch.profiler, and the mean time per call by CUDA events over n more
    calls (device time or the host's launch rate, whichever is longer).
    Late in a long process the profiler drops launches near the ends of
    its window (seen on the card: 194–195 of 200, and once 152). A likely
    cause: it keeps only device activity whose time, mapped onto the
    host's clock, lies inside the window, and the clocks drift apart
    over a long process. So the window is
    padded with idle time at both ends, and taken again (at most three
    windows) until it sees at least 90 % of the n launches; the mean is
    over those it saw."""
    from torch.profiler import ProfilerActivity, profile
    events = cuda_ms(fn, n)
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.1)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.1)
        us = count = 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA \
                    and kernel in ev.key:
                us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0))
                count += ev.count
        if 0.9 * n <= count <= n and us > 0:
            return us / 1e3 / count, events
        seen.append(count)
    fail(f"the profiler saw {seen} launches of {kernel} in {n} calls "
         "in each of three windows")


# ---------------------------------------------------------------- inputs

def render_tiles(rng, n: int, size: int, px_per_m: float = 2.0):
    """n synthetic aerial tiles at the trained fixture's scale (0.5 m/px:
    320 m of ground per 640-px tile): the asphalt texture and bright
    4.5×2 m car boxes of its training world. Returns (uint8 [n,size,size,3],
    bounds [n,4] w/s/e/n, the cars of each tile as [(lon, lat), ...])."""
    import numpy as np
    lat0 = 52.2
    m2lon = 1.0 / (111319.9 * math.cos(math.radians(lat0)))
    m2lat = 1.0 / 111319.9
    span = size / px_per_m                               # metres
    tiles, bounds, cars = [], [], []
    for t in range(n):
        west = 21.0 + t * span * m2lon
        south = lat0
        east, north = west + span * m2lon, south + span * m2lat
        xs = np.linspace(west, east, size, endpoint=False)
        ys = np.linspace(north, south, size, endpoint=False)
        lon_g, lat_g = np.meshgrid(xs, ys)
        tex = np.sin(lon_g * 201000.0) * np.cos(lat_g * 173000.0) * 0.5 + 0.5
        img = (90 + 40 * tex).astype(np.uint8)
        img = np.stack([img, img, img + 8], axis=-1).astype(np.uint8)
        truth = []
        for _ in range(int(rng.integers(10, 25))):
            cx = rng.uniform(5.0, span - 5.0)            # metres from west
            cy = rng.uniform(5.0, span - 5.0)            # metres from north
            x1 = int((cx - 2.25) * px_per_m)
            x2 = int((cx + 2.25) * px_per_m)
            y1 = int((cy - 1.0) * px_per_m)
            y2 = int((cy + 1.0) * px_per_m)
            if (img[y1 - 8:y2 + 8, x1 - 8:x2 + 8] > 200).any():
                continue                                 # keep cars apart
            img[y1:y2, x1:x2] = (230, 235, 240)
            truth.append((west + cx * m2lon, north - cy * m2lat))
        tiles.append(img)
        bounds.append((west, south, east, north))
        cars.append(truth)
    return np.stack(tiles), np.asarray(bounds, np.float32), cars


# (case, kind of input, class_aware, batch, candidates K, slots D). The first
# five are the main path's shape; "unsorted" and "below-minus-one" break the
# priority-order contract and take the kernel's general path.
NMS_CASES = [
    ("agnostic", "random", False, B, K, D),
    ("aware", "random", True, B, K, D),
    ("ties-agnostic", "ties", False, B, K, D),
    ("ties-aware", "ties", True, B, K, D),
    ("below-conf", "below-conf", True, B, K, D),
    ("tile-like", "tile-like", False, B, K, D),
    ("k-below-slots", "random", True, B, 40, D),
    ("k-odd", "ties", True, B, 250, D),
    ("unsorted", "unsorted", False, B, K, D),
    ("below-minus-one", "below-minus-one", True, B, K, D),
    ("k-1024", "random", False, 8, 1024, 128),
    # the city scan's shape (phase 10): 320 m tiles scale the slots
    ("wide-k1024-d256", "random", False, B, 1024, 256),
]


def nms_inputs(rng, kind: str, b: int = B, k: int = K):
    """Kernel inputs: boxes_t [b,4,k] cxcywh in a 640-px frame (half of
    them jittered copies of the other half), masked scores [b,k] in
    preselect order (descending, −1 below conf), classes [b,k].

    kind: "random"; "ties" (scores on a grid of 8, exact duplicate boxes);
    "below-conf" (every score −1); "tile-like" (per image 10–24 objects,
    each with 3–12 jittered near-duplicates scoring >= 0.3, every other
    candidate −1); "unsorted" ("random" with each score row shuffled);
    "below-minus-one" ("random" with the last quarter of each row at −2).
    """
    import numpy as np
    cx = rng.uniform(0, SIZE, (b, k))
    cy = rng.uniform(0, SIZE, (b, k))
    wh = rng.uniform(8, 60, (b, 2, k))
    boxes = np.concatenate([cx[:, None], cy[:, None], wh], 1)
    boxes[:, :, k // 2:] = boxes[:, :, :k - k // 2] \
        + rng.normal(0, 3, (b, 4, k - k // 2))
    scores = rng.uniform(0, 1, (b, k))
    if kind == "ties":
        scores = rng.integers(0, 8, (b, k)) / 8.0
        boxes[:, :, 1::5] = boxes[:, :, 0:k - 1:5]
    scores = np.sort(scores, axis=1)[:, ::-1]           # preselect order
    masked = np.where(scores >= 0.3, scores, -1.0)
    if kind == "below-conf":
        masked[:] = -1.0
    elif kind == "tile-like":
        masked[:] = -1.0
        for i in range(b):
            live = []
            for _ in range(int(rng.integers(10, 25))):
                obj = np.concatenate([rng.uniform(20, SIZE - 20, 2),
                                      rng.uniform(8, 20, 2)])
                dups = int(rng.integers(3, 13))
                live.append(obj + rng.normal(0, 1.0, (dups, 4)))
            live = rng.permutation(np.concatenate(live))[:k]
            boxes[i, :, :len(live)] = live.T
            masked[i, :len(live)] = np.sort(
                rng.uniform(0.3, 1.0, len(live)))[::-1]
    elif kind == "unsorted":
        masked = rng.permuted(masked, axis=1)
    elif kind == "below-minus-one":
        masked[:, k - k // 4:] = -2.0
    classes = rng.integers(0, 3, (b, k))
    return (boxes.astype(np.float32), masked.astype(np.float32),
            classes.astype(np.int32))


# ---------------------------------------------------------------- phases

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi reported no card")
    return out[0]


def check_nms_kernel(torch, record):
    """Kernel vs plain on the card; returns the kernel's record entry."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.kernels.build import build_log
    from aerial_image_recognition_tpu_torch.ops.nms import _suppress_plain
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    max_err = 0.0
    timed = {}
    for name, kind, aware, b, k, d in NMS_CASES:
        args = [torch.from_numpy(a).to(dev)
                for a in nms_inputs(rng, kind, b, k)]
        kw = dict(iou_threshold=0.45, max_det=d, class_aware=aware)
        got = nms_suppress(*args, **kw)
        want = _suppress_plain(*args, **kw)
        torch.cuda.synchronize()
        for label, g, w in zip(("idx", "conf", "cls"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                bad = int((g != w).sum())
                fail(f"nms_suppress {name}: {label} differs from the plain "
                     f"version in {bad} of {g.numel()} slots")
        max_err = max(max_err, float((got[1] - want[1]).abs().max()))
        # rounds this input needs: the sweep stops after the last pick with
        # a score above -1; the general path always runs all d rounds
        in_order = bool(((args[1][:, :-1] >= args[1][:, 1:]).all()
                         & (args[1] >= -1.0).all()))
        rounds = int((got[1] > -1.0).sum()) if in_order else b * d
        if name in ("agnostic", "tile-like", "unsorted"):
            timed[name] = (args, kw, rounds)
        record["nms_cases"].append({
            "case": name, "shape": [b, k, d], "bit_identical": True,
            "path": "sweep" if in_order else "general",
            "rounds_needed": rounds,
            "picks_valid": int((got[1] >= 0.3).sum())})
    if [c["path"] for c in record["nms_cases"]
            if c["case"] in ("unsorted", "below-minus-one")] \
            != ["general"] * 2 or timed["agnostic"][2] != B * D:
        fail("nms_suppress: the cases do not cover both paths as intended")

    # same call, same card: general path, sweep, sweep again, general
    # path; each figure is the mean of its two readings. The kernel is
    # shorter than the wrapper takes the host to issue it, so its time is
    # the device time of the kernel alone (torch.profiler); the event-timed
    # figure over the same launches, which is then the host's launch rate,
    # stands beside it.
    order = ["unsorted", "agnostic", "tile-like", "tile-like", "agnostic",
             "unsorted"]
    runs = {name: {"device_ms": [], "events_ms": []} for name in timed}
    for name in order:
        args, kw, _ = timed[name]
        dev_ms, ev_ms = kernel_ms(
            torch, lambda: nms_suppress(*args, **kw), 200,
            "nms_suppress_kernel")
        runs[name]["device_ms"].append(dev_ms)
        runs[name]["events_ms"].append(ev_ms)
    record["nms_ms_runs"] = runs
    ms, tile_ms, general_ms = (sum(runs[n]["device_ms"]) / 2 for n in
                               ("agnostic", "tile-like", "unsorted"))
    ev, tile_ev, general_ev = (sum(runs[n]["events_ms"]) / 2 for n in
                               ("agnostic", "tile-like", "unsorted"))
    args, kw, rounds = timed["agnostic"]
    plain_ms = cuda_ms(lambda: _suppress_plain(*args, **kw), 5, warmup=1)
    nbytes = sum(a.numel() * a.element_size() for a in args) + 3 * B * D * 4
    # per candidate once: half-extents, corners, area (9 flops); per round
    # that this input needs, and candidate: pick + IoU with it + > test (15)
    flops = B * 9 * K + rounds * 15 * K
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS * 1e3
    tile_rounds = timed["tile-like"][2]
    record["nms_ptxas"] = [line for line in
                           build_log("nms_suppress").splitlines()
                           if "registers" in line or "spill" in line]
    entry = {"name": "nms_suppress", "route": "cuda",
             "source": "aerial_image_recognition_tpu_torch/csrc/nms_suppress.cu",
             "replaces": "aerial_image_recognition_tpu/ops/pallas_kernels.py:85",
             "launches": 0, "max_abs_err": max_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None, "rounds_needed": rounds,
             "ms_tile_like": tile_ms, "rounds_needed_tile_like": tile_rounds,
             "bound_ms_tile_like": max(
                 t_bytes, (B * 9 * K + tile_rounds * 15 * K)
                 / F32_FLOPS * 1e3),
             "ms_general_path": general_ms, "timed_by": "torch.profiler",
             "events_ms": ev, "events_ms_tile_like": tile_ev,
             "events_ms_general_path": general_ev}
    return entry


def check_divisions_on_card(torch, images, bounds, n: int = 4):
    """The f32 native-size preprocess and the device lon/lat divide by a
    constant; on the card they must give the CPU's bits (tolerance 0). The
    input is n rendered tiles and one tile that holds every uint8 value."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    from aerial_image_recognition_tpu_torch.post.georef import lonlat
    ramp = (np.arange(SIZE * SIZE * 3) % 256).astype(np.uint8)
    x = torch.from_numpy(np.concatenate(
        [images[:n], ramp.reshape(1, SIZE, SIZE, 3)]))
    cpu = preprocess_batch(x, out_size=SIZE, dtype=torch.float32)
    card = preprocess_batch(x.cuda(), out_size=SIZE,
                            dtype=torch.float32).cpu()
    if card.dtype != cpu.dtype or not torch.equal(card, cpu):
        fail(f"f32 preprocess on the card differs from the CPU's in "
             f"{int((card != cpu).sum())} of {cpu.numel()} values")
    rng = np.random.default_rng(3)
    xy = torch.from_numpy(rng.uniform(0, SIZE, (n, D, 2)).astype(np.float32))
    bnd = torch.from_numpy(bounds[:n])
    for c, g in zip(lonlat(xy, bnd, SIZE), lonlat(xy.cuda(), bnd.cuda(),
                                                  SIZE)):
        if not torch.equal(g.cpu(), c):
            fail(f"lon/lat on the card differs from the CPU's in "
                 f"{int((g.cpu() != c).sum())} of {c.numel()} values")
    return {"preprocess_f32_images": n + 1, "preprocess_f32_equal_cpu": True,
            "lonlat_points": n * D, "lonlat_equal_cpu": True}


def lightness_levels(rng, b: int, h: int, w: int):
    """int32 [b,h,w] lightness planes: smooth structure plus noise and a
    flat patch, so histograms clip and the tiles' LUTs differ."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w]
    img = 110 + 70 * np.sin(yy / 9.0) * np.cos(xx / 13.0) \
        + rng.normal(0, 25, (b, h, w))
    img[:, : h // 3, : w // 4] = 17
    return np.clip(np.round(img), 0, 255).astype(np.int32)


def check_clahe_kernel(torch, record):
    """Kernel vs plain on the card; returns the kernel's record entry."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops.clahe import (
        _apply_luts_plain, _luts_from_hist, _tile_histograms,
        clahe_gray_device_multi)
    from aerial_image_recognition_tpu_torch.ops.clahe_kernel import (
        apply_luts)
    rng = np.random.default_rng(2)
    dev = torch.device("cuda")
    gh, gw = GRID
    cases = [("production", B, SIZE, SIZE, CLIPS),
             ("production-v1", B, SIZE, SIZE, CLIPS[:1]),
             ("ragged", 2, 250, 237, CLIPS),
             ("ragged-v1", 2, 250, 237, CLIPS[:1])]
    max_err = 0.0
    for name, b, h, w, clips in cases:
        l8 = torch.from_numpy(lightness_levels(rng, b, h, w)).to(dev)
        hist, (th, tw), n_px = _tile_histograms(l8, GRID)
        luts = torch.stack([_luts_from_hist(hist, c, n_px) for c in clips],
                           dim=3)
        # the stages before the kernel, card against CPU, tolerance 0
        l8_cpu = l8.cpu()
        hist_cpu, geom_cpu, n_px_cpu = _tile_histograms(l8_cpu, GRID)
        luts_cpu = torch.stack([_luts_from_hist(hist_cpu, c, n_px_cpu)
                                for c in clips], dim=3)
        if (geom_cpu, n_px_cpu) != ((th, tw), n_px) \
                or not torch.equal(hist.cpu(), hist_cpu):
            fail(f"clahe {name}: tile histograms on the card differ from "
                 f"the CPU's in {int((hist.cpu() != hist_cpu).sum())} bins")
        if luts.dtype != luts_cpu.dtype or not torch.equal(luts.cpu(),
                                                           luts_cpu):
            fail(f"clahe {name}: LUTs on the card differ from the CPU's in "
                 f"{int((luts.cpu() != luts_cpu).sum())} of {luts.numel()} "
                 f"entries")
        # the gray path as a whole (histograms, LUTs, kernel, rounding)
        # against the CPU's (plain version); a slice of the big batch
        nb = min(b, 4)
        gray = clahe_gray_device_multi(l8[:nb], clips, GRID)
        gray_cpu = clahe_gray_device_multi(l8_cpu[:nb], clips, GRID)
        if gray.dtype != gray_cpu.dtype or not torch.equal(gray.cpu(),
                                                           gray_cpu):
            fail(f"clahe {name}: clahe_gray_device_multi on the card differs "
                 f"from the CPU's in {int((gray.cpu() != gray_cpu).sum())} "
                 f"of {gray.numel()} pixels")
        got = apply_luts(luts, l8, gh, gw, th, tw)
        torch.cuda.synchronize()
        want = _apply_luts_plain(luts, l8, gh, gw, th, tw)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = int((got != want).sum())
            levels = int((torch.round(got) != torch.round(want)).sum())
            fail(f"clahe_apply {name}: raw f32 differs from the plain "
                 f"version in {bad} of {got.numel()} values (max abs "
                 f"{err}, {levels} rounded levels)")
        if float(want.std()) < 10.0:
            fail(f"clahe_apply {name}: degenerate comparison input")
        record["clahe_cases"].append(
            {"case": name, "shape": [len(clips), b, h, w],
             "raw_f32_equal": True, "hist_equal_cpu": True,
             "luts_equal_cpu": True, "gray_multi_equal_cpu_images": nb})
        if name == "production":
            args = (luts, l8, gh, gw, th, tw)
            hist_ms = cuda_ms(lambda: _tile_histograms(l8, GRID), 20)
            luts_ms = cuda_ms(lambda: [_luts_from_hist(hist, c, n_px)
                                       for c in clips], 20)
    ms = cuda_ms(lambda: apply_luts(*args), 200)
    plain_ms = cuda_ms(lambda: _apply_luts_plain(*args), 5, warmup=1)
    luts, l8 = args[:2]
    v, npx = luts.shape[3], l8.numel()
    # each input read once, each output written once: pixels, LUTs, the two
    # weight vectors and cell boundaries in; V planes out
    nbytes = npx * 4 + luts.numel() * 4 + 2 * (SIZE * 4) \
        + (gh + 1 + gw + 1) * 4 + v * npx * 4
    # per pixel 1−wx (1−wy is per row); per pixel and variant 6 multiplies
    # and 3 adds
    flops = npx * (1 + 9 * v)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS * 1e3
    record["clahe_stage_ms"] = {"histograms_bincount": hist_ms,
                                "luts_from_hist_x3": luts_ms}
    return {"name": "clahe_apply", "route": "cuda",
            "source": "aerial_image_recognition_tpu_torch/csrc/clahe_apply.cu",
            "replaces": "aerial_image_recognition_tpu/ops/clahe_pallas.py:103",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def check_clahe_rgb_on_card(torch, images, n: int = 4):
    """The RGB CLAHE path (LAB forward, levels, gray path, LAB inverse) on
    the card against the same functions on the CPU, on n rendered tiles in
    f32. ``pow(x, 1/3)`` may differ by ULPs between the two, so the
    tolerance is the one the CPU tests hold against the reference:
    lightness levels equal except <= 1 level on < 1e-3 of the pixels, RGB
    within 2/255 max and 1e-4 mean."""
    from aerial_image_recognition_tpu_torch.ops.clahe import (
        _lightness_levels, clahe_rgb_device_multi)
    x_cpu = (torch.from_numpy(images[:n]).float() / 255.0).permute(0, 3, 1, 2)
    x = x_cpu.cuda()
    lev = (_lightness_levels(x)[0].cpu() - _lightness_levels(x_cpu)[0]).abs()
    frac = float((lev > 0).float().mean())
    if int(lev.max()) > 1 or frac >= 1e-3:
        fail(f"clahe rgb: lightness levels on the card differ from the "
             f"CPU's by up to {int(lev.max())} on {frac:.2e} of the pixels")
    err = (clahe_rgb_device_multi(x, CLIPS).cpu()
           - clahe_rgb_device_multi(x_cpu, CLIPS)).abs()
    if float(err.max()) > 2 / 255 or float(err.mean()) > 1e-4:
        fail(f"clahe rgb: output on the card differs from the CPU's by max "
             f"{float(err.max()):.5f}, mean {float(err.mean()):.2e}")
    return {"images": n, "levels_differing_frac": frac,
            "levels_max_diff": int(lev.max()),
            "rgb_max_abs_err": float(err.max()),
            "rgb_mean_abs_err": float(err.mean())}


def timed_steps(torch, step, images, bounds, n: int):
    """One warm-up call, then n timed calls: (last output, ms per step)."""
    out = step(images, bounds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = step(images, bounds)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / n * 1e3


def check_output(torch, label, out):
    """Shapes and finiteness of a step's (Detections, lon, lat)."""
    det, lon, lat = out
    if tuple(det.boxes.shape) != (B, D, 4) or tuple(lon.shape) != (B, D):
        fail(f"{label}: output shapes {tuple(det.boxes.shape)} "
             f"{tuple(lon.shape)}")
    for name, t in (("boxes", det.boxes), ("scores", det.scores),
                    ("lon", lon), ("lat", lat)):
        if not bool(torch.isfinite(t).all()):
            fail(f"{label}: non-finite {name}")
    if int(det.valid.sum()) == 0:
        fail(f"{label}: no detections")


def tta_stage_times(torch, step, dev_images):
    """Device ms of the TTA step's stages, each alone, on the batch that
    is already on the card (CUDA events)."""
    from aerial_image_recognition_tpu_torch.ops.augment import expand_tta
    from aerial_image_recognition_tpu_torch.ops.clahe import (
        _lightness_levels, _tile_histograms, clahe_rgb_device_multi)
    from aerial_image_recognition_tpu_torch.ops.nms import batched_nms
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    with torch.inference_mode():
        x = preprocess_batch(dev_images, out_size=SIZE, dtype=torch.bfloat16)
        l8 = _lightness_levels(x)[0]
        xv, _ = expand_tta(x)
        boxes, scores = step.bundle.forward(xv)
        a = boxes.shape[1]
        boxes = boxes.reshape(8, B, a, 4).transpose(0, 1).reshape(B, -1, 4)
        scores = scores.reshape(8, B, a, -1).transpose(0, 1) \
            .reshape(B, 8 * a, -1)
        return {
            "preprocess": cuda_ms(lambda: preprocess_batch(
                dev_images, out_size=SIZE, dtype=torch.bfloat16), 5),
            "expand_tta": cuda_ms(lambda: expand_tta(x), 5),
            "clahe_rgb_device_multi": cuda_ms(
                lambda: clahe_rgb_device_multi(x, CLIPS), 5),
            "lab_forward_and_levels": cuda_ms(
                lambda: _lightness_levels(x), 5),
            "histograms_bincount": cuda_ms(
                lambda: _tile_histograms(l8, GRID), 5),
            "forward_512_images": cuda_ms(
                lambda: step.bundle.forward(xv), 3, warmup=1),
            "nms_over_8x_anchors": cuda_ms(lambda: batched_nms(
                boxes, scores, num_classes=1, conf_threshold=0.3,
                iou_threshold=0.45, max_det=D, pre_topk=K,
                preselect="approx"), 5),
        }


def multiscale_stage_times(torch, step, dev_images):
    """Device ms of the multiscale step's stages, each alone (CUDA events),
    and of the crop + resize preprocess that no path here runs (1024-px
    mosaics, center crop 864, resize to the model's 640)."""
    from aerial_image_recognition_tpu_torch.ops.nms import batched_nms
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        matmul_resize_float, preprocess_batch)
    with torch.inference_mode():
        x = preprocess_batch(dev_images, out_size=SIZE, dtype=torch.bfloat16)
        times, boxes, scores = {}, [], []
        for size in (544, SIZE, 736):
            xs = x if size == SIZE else matmul_resize_float(x, size)
            if size != SIZE:
                times[f"resize_{size}"] = cuda_ms(
                    lambda: matmul_resize_float(x, size), 5)
            times[f"forward_{size}"] = cuda_ms(
                lambda: step.bundle.forward(xs), 5)
            bb, ss = step.bundle.forward(xs)
            boxes.append(bb * (SIZE / size))
            scores.append(ss if size == SIZE else ss * 0.8)
        boxes, scores = torch.cat(boxes, 1), torch.cat(scores, 1)
        for label, vote in (("nms", None), ("nms_with_voting", 0.5)):
            times[label] = cuda_ms(lambda: batched_nms(
                boxes, scores, num_classes=1, conf_threshold=0.3,
                iou_threshold=0.45, max_det=D, pre_topk=K,
                preselect="approx", vote_iou=vote), 5)
        mosaics = torch.randint(0, 256, (B, 1024, 1024, 3),
                                dtype=torch.uint8, device="cuda")
        times["preprocess_1024_crop_864_resize_640"] = cuda_ms(
            lambda: preprocess_batch(mosaics, out_size=SIZE, crop_size=864,
                                     dtype=torch.bfloat16), 5)
    return times


def int8_case_inputs(rng, batch, size, parts, out_c, kernel):
    """Seeded int8 activations (one array per concatenated part), an int8
    HWIO kernel and epilogue constants that spread the codes over ±127."""
    import numpy as np
    xs = [rng.integers(-127, 128, (batch, size, size, c), dtype=np.int8)
          for c in parts]
    c_in = sum(parts)
    w8 = rng.integers(-127, 128, (kernel, kernel, c_in, out_c),
                      dtype=np.int8)
    k = kernel * kernel * c_in
    m = (rng.uniform(0.5, 1.5, out_c) * 60.0
         / (math.sqrt(k) * 5400.0)).astype(np.float32)
    b = rng.uniform(-20.0, 20.0, out_c).astype(np.float32)
    return xs, w8, m, b


def codes_diff(torch, got, want):
    """(share of differing codes, max |difference|) of two int8 tensors."""
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return float((d > 0).float().mean()), int(d.max())


def check_int8_product(torch, record, card):
    """Phase 8a. Returns the epilogue kernel's record entry."""
    import numpy as np
    import torch.nn.functional as F
    from aerial_image_recognition_tpu_torch.kernels.build import build_log
    from aerial_image_recognition_tpu_torch.models.int8 import (
        _im2col, conv_s32, device_kernel)
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        _requantize_plain, requantize)
    rng = np.random.default_rng(8)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    record["int8_cases"] = []
    max_err = 0
    for name, batch, size, parts, out_c, kernel, stride in INT8_CASES:
        xs, w8, m, b = int8_case_inputs(rng, batch, size, parts, out_c,
                                        kernel)
        v_cpu = torch.cat([torch.from_numpy(x) for x in xs], dim=-1)
        parts_dev = [torch.from_numpy(x).to(dev) for x in xs]
        w_dev, w_cpu = device_kernel(w8, dev), device_kernel(w8, cpu)
        m_dev, b_dev = torch.from_numpy(m).to(dev), torch.from_numpy(b).to(dev)
        v_dev = torch.cat(parts_dev, dim=-1)
        r_dev = conv_s32(v_dev, w_dev, kernel, stride)
        r_cpu = conv_s32(v_cpu, w_cpu, kernel, stride)
        torch.cuda.synchronize()
        if r_dev.dtype != torch.int32 or not torch.equal(r_dev.cpu(), r_cpu):
            bad = int((r_dev.cpu() != r_cpu).sum())
            fail(f"int8 product {name}: the card's s32 sums differ from the "
                 f"CPU's int32 conv2d in {bad} of {r_cpu.numel()} values")
        # the epilogue: kernel against plain on the card (tolerance 0), and
        # the card's codes against the CPU's
        row = {"case": name, "s32_equal_cpu": True,
               "shape": [batch, size, size, sum(parts), out_c, kernel,
                         stride]}
        for act in ("leaky", "relu", "silu"):
            inv = 0.75 if act == "silu" else None
            got = requantize(r_dev, m_dev, b_dev, inv, act)
            plain = _requantize_plain(r_dev, m_dev, b_dev, inv, act)
            on_cpu = _requantize_plain(
                r_cpu, torch.from_numpy(m), torch.from_numpy(b),
                inv, act)
            torch.cuda.synchronize()
            share_p, max_p = codes_diff(torch, got, plain)
            share_c, max_c = codes_diff(torch, got.cpu(), on_cpu)
            limit = 1e-4 if act == "silu" else 0.0    # expf may differ by ULPs
            if max(max_p, max_c) > 1 or max(share_p, share_c) > limit:
                fail(f"int8 epilogue {name} {act}: kernel against plain on "
                     f"the card differs in {share_p:.2e} of the codes (max "
                     f"{max_p}), against the CPU in {share_c:.2e} (max "
                     f"{max_c})")
            max_err = max(max_err, max_p)
            if float(got.float().std()) < 10.0:
                fail(f"int8 epilogue {name} {act}: degenerate codes")
            row[f"codes_{act}"] = {"differ_plain": share_p,
                                   "differ_cpu": share_c,
                                   "max_abs": max(max_p, max_c)}
        # times: the int8 conv as the trunk runs it (concat, im2col,
        # product, epilogue kernel) and its pieces, beside the bf16 cuDNN
        # conv of the same shape (conv alone, channels_last)
        def int8_conv():
            v = parts_dev[0] if len(parts_dev) == 1 \
                else torch.cat(parts_dev, dim=-1)
            return requantize(conv_s32(v, w_dev, kernel, stride), m_dev,
                              b_dev, None, "leaky")
        cols = v_dev if kernel == 1 else _im2col(v_dev, kernel, stride)
        a2 = cols.reshape(-1, cols.shape[-1])
        w_row = w_dev.contiguous()      # the layout device_kernel avoids
        x_bf = torch.randn(batch, sum(parts), size, size, device=dev,
                           dtype=torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        w_bf = torch.randn(out_c, sum(parts), kernel, kernel, device=dev,
                           dtype=torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        row["ms"] = {
            "int8_conv": cuda_ms(int8_conv, 10),
            "im2col": 0.0 if kernel == 1 else cuda_ms(
                lambda: _im2col(v_dev, kernel, stride), 10),
            "int_mm": cuda_ms(lambda: torch._int_mm(a2, w_dev), 10),
            "int_mm_row_major_kernel": cuda_ms(
                lambda: torch._int_mm(a2, w_row), 10),
            "epilogue_kernel": cuda_ms(lambda: requantize(
                r_dev, m_dev, b_dev, None, "leaky"), 10),
            "epilogue_plain": cuda_ms(lambda: _requantize_plain(
                r_dev, m_dev, b_dev, None, "leaky"), 5, warmup=1),
            "bf16_cudnn_conv": cuda_ms(lambda: F.conv2d(
                x_bf, w_bf, None, stride, kernel // 2), 10)}
        record["int8_cases"].append(row)
        print(f"int8 {name}: s32 equal to the CPU's; codes equal (leaky, "
              f"relu; silu differs on {row['codes_silu']['differ_cpu']:.1e});"
              " ms " + ", ".join(f"{k} {v:.4f}" for k, v in row["ms"].items())
              + f" [{card}]", flush=True)
        if name.startswith("1x1 concat"):
            n = r_dev.numel()
            ms = cuda_ms(lambda: requantize(r_dev, m_dev, b_dev, None,
                                            "leaky"), 200)
            plain_ms = cuda_ms(lambda: _requantize_plain(
                r_dev, m_dev, b_dev, None, "leaky"), 5, warmup=1)
            # s32 in, int8 out, m and b once; convert, multiply, add,
            # compare, multiply, round, two clamps per element
            nbytes = n * 5 + 2 * out_c * 4
            t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, n * 8 / F32_FLOPS * 1e3
            entry = {
                "name": "int8_epilogue", "route": "cuda",
                "source": "aerial_image_recognition_tpu_torch/csrc/"
                          "int8_epilogue.cu",
                "replaces": "aerial_image_recognition_tpu/models/int8.py:364"
                            " (jnp chain fused by XLA; no TPU kernel)",
                "launches": 0, "max_abs_err": 0, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "shape": [r_dev.numel() // out_c, out_c]}
    entry["max_abs_err"] = max_err
    record["int8_epilogue_ptxas"] = [
        line for line in build_log("int8_epilogue").splitlines()
        if "registers" in line or "spill" in line]
    return entry


def check_int8_trunk(torch, record, images, card, n: int = 4):
    """Phase 8b: the int8 trunk on the card against itself on the CPU, on n
    rendered tiles and the same qparams (calibrated once, on the CPU, in
    f32). Same P2 codes in: the three taps' codes, boxes and scores. Then
    from the images, stems on each device: the P2 codes that flip, and what
    that does to the taps."""
    from aerial_image_recognition_tpu_torch.models.int8 import (
        calibrate_absmax, quantize_bundle)
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.ops.decode import decode_yolov7
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    kw = dict(params_path=FIXTURE, dtype=torch.float32, fold_bn=True)
    cpu_bundle = create_model(device="cpu", **kw)
    absmax = calibrate_absmax(cpu_bundle, [images[:n]])
    q_cpu = quantize_bundle(cpu_bundle, [], absmax=absmax)
    q_dev = quantize_bundle(create_model(device="cuda", **kw), [],
                            absmax=absmax)
    tiles = torch.from_numpy(images[:n])
    rec = {"tiles": n}
    with torch.inference_mode():
        x = preprocess_batch(tiles, out_size=SIZE, dtype=torch.float32)
        p2_cpu = q_cpu._p2_quantize(q_cpu.module.stems(x))
        taps_cpu = q_cpu.trunk_codes(p2_cpu)
        taps_dev = q_dev.trunk_codes(p2_cpu.cuda())
        for level, (c, d) in enumerate(zip(taps_cpu, taps_dev)):
            share, worst = codes_diff(torch, d.v.cpu(), c.v)
            rec[f"tap{level}_codes_differ"] = share
            rec[f"tap{level}_max_abs"] = worst
            if share > 1e-4 or worst > 1:
                fail(f"int8 trunk: tap {level} codes on the card differ from "
                     f"the CPU's on {share:.2e} of the codes (max {worst})")
        anchors, nc = q_cpu.module.anchors, q_cpu.spec.num_classes
        b_cpu, s_cpu = decode_yolov7(q_cpu._raw_from_p2_i8(p2_cpu), anchors,
                                     nc)
        b_dev, s_dev = decode_yolov7(q_dev._raw_from_p2_i8(p2_cpu.cuda()),
                                     anchors, nc)
        # the codes are equal, so what is left is the f32 heads' summation
        # order: boxes within 1e-2 px + 1e-4 of their size (a box side
        # reaches 4 x 373 px at the coarsest anchor), scores within 1e-3
        b_err = (b_dev.cpu() - b_cpu).abs()
        rec["boxes_max_abs"] = float(b_err.max())
        rec["boxes_max_rel"] = float((b_err / b_cpu.abs().clamp_min(1.0))
                                     .max())
        rec["scores_max_abs"] = float((s_dev.cpu() - s_cpu).abs().max())
        if bool((b_err > 1e-2 + 1e-4 * b_cpu.abs()).any()) \
                or rec["scores_max_abs"] > 1e-3:
            fail(f"int8 trunk: boxes differ by {rec['boxes_max_abs']} px "
                 f"(relative {rec['boxes_max_rel']}), scores by "
                 f"{rec['scores_max_abs']} between card and CPU")
        # from the images: f32 stems on the card (cuDNN, TF32 off) may flip
        # a P2 code at a rounding boundary
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        p2_dev = q_dev._p2_quantize(q_dev.module.stems(x.cuda()))
        torch.backends.cudnn.allow_tf32 = tf32
        rec["p2_codes_differ"], rec["p2_max_abs"] = codes_diff(
            torch, p2_dev.cpu(), p2_cpu)
        if rec["p2_codes_differ"] > 1e-3 or rec["p2_max_abs"] > 1:
            fail(f"int8 trunk: P2 codes from the card's f32 stems differ "
                 f"from the CPU's on {rec['p2_codes_differ']:.2e} (max "
                 f"{rec['p2_max_abs']})")
    record["int8_trunk_card_vs_cpu"] = rec
    print(f"int8 trunk, card against CPU on {n} tiles, same qparams and P2 "
          f"codes: tap codes differ on "
          f"{[rec[f'tap{i}_codes_differ'] for i in range(3)]} (max "
          f"{[rec[f'tap{i}_max_abs'] for i in range(3)]}), boxes max abs "
          f"{rec['boxes_max_abs']:.2e} px (relative "
          f"{rec['boxes_max_rel']:.1e}), scores {rec['scores_max_abs']:.2e};"
          f" P2 codes from each device's own f32 stems differ on "
          f"{rec['p2_codes_differ']:.2e} (max {rec['p2_max_abs']}) [{card}]",
          flush=True)


def same_detections(torch, out_a, out_b) -> bool:
    """Two step outputs equal at tolerance 0 (every field of Detections,
    lon, lat)."""
    det_a, det_b = out_a[0], out_b[0]
    pairs = [(det_a.boxes, det_b.boxes), (det_a.scores, det_b.scores),
             (det_a.classes, det_b.classes), (det_a.valid, det_b.valid),
             (out_a[1], out_b[1]), (out_a[2], out_b[2])]
    return all(torch.equal(a, b) for a, b in pairs)


def recall(out, bounds, cars, radius_m: float = 2.0) -> float:
    """Fraction of rendered cars with a detection centre within radius_m."""
    from aerial_image_recognition_tpu_torch.post.georef import (
        detections_to_records)
    recs = detections_to_records(out[0], bounds, model_size=SIZE)
    m2lon = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
    hit = total = 0
    for t, truth in enumerate(cars):
        dets = [(r["lon"], r["lat"]) for r in recs if r["tile_index"] == t]
        for lon, lat in truth:
            total += 1
            if dets and min(math.hypot((dl - lon) / m2lon,
                                       (dt - lat) * 111319.9)
                            for dl, dt in dets) < radius_m:
                hit += 1
    return hit / max(total, 1)


def profile_step(torch, step, images, bounds, n: int = 3):
    """Device time by kernel over n steps with the batch on the card
    (torch.profiler), and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    step(images, bounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(images, bounds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue                    # host-side ops repeat their kernels
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append({"name": ev.key[:120], "calls_per_step":
                         ev.count / n, "ms_per_step": us / 1e3 / n})
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    if not rows:
        return {"device_time": "not measured (profiler saw no device time)"}
    return {"wall_ms_per_step_profiled": wall_ms,
            "device_busy_ms_per_step": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "kernels": len(rows), "top": rows[:25]}


def step_flops(torch, step, images, bounds) -> float:
    """Multiply-adds ×2 of every conv and head matmul in one step call,
    counted from the shapes the layers see (forward hooks)."""
    total = [0.0]

    def conv(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
        total[0] += 2.0 * k * out.numel()

    def linear(m, inp, out):
        total[0] += 2.0 * m.in_features * out.numel()

    hooks = []
    for m in step.bundle.module.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
    try:
        step(images, bounds)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def post_jpegs(url, images, bounds, n):
    """POST n tiles as JPEG concurrently; returns the parsed replies."""
    from PIL import Image
    replies = [None] * n
    errors = []

    def one(k):
        try:
            buf = io.BytesIO()
            Image.fromarray(images[k]).save(buf, "JPEG", quality=95)
            w, s, e, no = (float(v) for v in bounds[k])
            req = urllib.request.Request(
                f"{url}/detect?west={w!r}&south={s!r}&east={e!r}&north={no!r}",
                data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                replies[k] = (r.status, json.load(r))
        except Exception as e:          # reported below, never swallowed
            errors.append(f"request {k}: {e!r}")

    threads = [threading.Thread(target=one, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    if errors or any(t.is_alive() for t in threads):
        fail(f"/detect requests failed: {errors or 'timed out'}")
    return replies


# ------------------------------------------------ 10. the city scan

SCAN_WORLD = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.05,
                  n_cars=10000, seed=4)        # the training world's density
SCAN_AOI = (20.98, 52.18, 21.02, 52.22)       # the central 0.04° square
SCAN_TILE_M, SCAN_OVERLAP = 320.0, 0.25       # 640 px a tile: 0.5 m/px
SCAN_SLOTS = (1024, 256)                      # _step_config at 320 m tiles
M2LON = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
M2LAT = 1.0 / 111319.9


def readback(out):
    """What a scan's host reads of one batch: every output, to numpy."""
    from aerial_image_recognition_tpu_torch.post.georef import to_numpy
    det, lon, lat = out
    return [to_numpy(t) for t in (det.valid, det.boxes, det.scores,
                                  det.classes, lon, lat)]


def host_syncs_in_one_step(torch, step, dev_images, dev_bounds):
    """The messages ``torch.cuda.set_sync_debug_mode("warn")`` gives for one
    step call on device inputs (none: the step never waits for the card,
    so the ingest pipeline can run ahead of it)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(dev_images, dev_bounds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the mode also warns once that it is a prototype; the ops it catches
    # say "called a synchronizing CUDA operation"
    return [str(w.message)[:160] for w in caught
            if "synchronizing cuda operation" in str(w.message).lower()]


def ingest_ring(torch, record, card, step, images, bounds, step_ms,
                device_ms, open_window, close_window, n_batches: int = 8):
    """10a: ``run_pipeline`` alone over ``n_batches`` pre-assembled 640-px
    batches in host memory (phase 4's tiles rolled along the batch, every
    other batch mirrored, so that no two batches are alike), each pass
    running them twice, through the pinned upload ring (its staging thread
    and copy stream) and, in turns with it, through the step's own per-call
    upload. Every batch's detections must equal (tolerance 0) the same step
    called per batch on device-resident copies: the ring's race check.
    Times: tiles/s, the time split (``h2d_s``, ``compute_s``, the wait on
    readback) and the device's idle share from one torch.profiler
    window."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from aerial_image_recognition_tpu_torch.ingest.pipeline import (
        TileBatch, run_pipeline)
    batches = []
    for k in range(n_batches):
        order = np.roll(np.arange(B), k)
        imgs = images[order][:, :, ::-1] if k % 2 else images[order]
        batches.append(TileBatch(np.arange(k * B, (k + 1) * B),
                                 np.ascontiguousarray(imgs),
                                 bounds[order].copy(), B))
    devs = [(torch.from_numpy(b.images).cuda(),
             torch.from_numpy(b.bounds).cuda()) for b in batches]
    ref = [step(*d) for d in devs]
    torch.cuda.synchronize()

    def run(bs, ring=True):
        outs, wait = [], [0.0]

        def on_result(b, out):
            t0 = time.perf_counter()
            readback(out)
            wait[0] += time.perf_counter() - t0
            outs.append(out)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = run_pipeline(iter(bs), step, on_result, prefetch_device=ring)
        torch.cuda.synchronize()
        return outs, stats, time.perf_counter() - t0, wait[0]

    run(batches[:2])                      # the ring's first allocation
    seq = batches * 2                     # each pass: 2 x n_batches
    open_window()
    outs, stats, wall, wait = run(seq)
    # the same batches through the step's own per-call upload (a pinned
    # copy and an H2D on the compute stream each call), in turns with the
    # ring: ring, per-call, per-call, ring
    per_call = [run(seq, ring=False) for _ in range(2)]
    again = run(seq)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs_p, _, wall_p, _ = run(seq)
    close_window("ingest", ["nms_suppress"])
    for label, got in (("timed", outs), ("profiled", outs_p),
                       ("per-call upload", per_call[0][0]),
                       ("ring again", again[0])):
        if len(got) != len(seq):
            fail(f"run_pipeline ({label}) returned {len(got)} batches")
        for k, g in enumerate(got):
            if not same_detections(torch, g, ref[k % n_batches]):
                fail(f"run_pipeline ({label}): batch {k}'s detections differ "
                     "from the per-batch step on device copies")
    kernel_us = copy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if "memcpy" in ev.key.lower():
            copy_us += us
        else:
            kernel_us += us
    syncs = host_syncs_in_one_step(torch, step, *devs[0])
    del devs
    if syncs:
        fail(f"the step waits for the card {len(syncs)} times on device "
             f"inputs, which serializes the ingest pipeline: {syncs[:3]}")
    n_run = len(seq)
    rec = {"batches": n_batches, "batches_a_pass": n_run, "batch": B,
           "size": SIZE,
           "ring_slots": 2,          # run_pipeline's default depth 1, + 1
           "wall_s": wall,
           "tiles_per_s": n_run * B / wall,
           "ms_per_batch": wall / n_run * 1e3,
           "h2d_s": stats["h2d_s"], "compute_s": stats["compute_s"],
           "readback_wait_s": wait, "stats": stats,
           "identical_to_per_batch_step": True,
           "profiled_wall_ms_per_batch": wall_p / n_run * 1e3,
           "kernel_busy_ms_per_batch": kernel_us / 1e3 / n_run,
           "h2d_copy_ms_per_batch": copy_us / 1e3 / n_run,
           "idle_share": max(0.0, 1.0 - kernel_us / 1e3 / (wall_p * 1e3)),
           "ms_per_batch_ring_again": again[2] / n_run * 1e3,
           "ms_per_batch_per_call_upload": [r[2] / n_run * 1e3
                                            for r in per_call],
           "step_ms_host_input_phase4": step_ms,
           "step_ms_device_input_phase4": device_ms,
           "host_syncs_in_one_step": len(syncs)}
    record["ingest"] = rec
    print(f"ingest ring: run_pipeline over {n_batches} batches of {B} "
          f"({SIZE} px, host memory), each pass {n_run} batches: "
          f"{rec['ms_per_batch']:.2f} ms/batch, "
          f"{rec['tiles_per_s']:.1f} tiles/s (again after the per-call "
          f"runs: {rec['ms_per_batch_ring_again']:.2f}); per-call upload "
          f"instead of the ring, in turns: "
          f"{rec['ms_per_batch_per_call_upload'][0]:.2f} / "
          f"{rec['ms_per_batch_per_call_upload'][1]:.2f} ms/batch; phase "
          f"4's step {step_ms:.2f} ms host input / {device_ms:.2f} ms device "
          f"input; "
          f"h2d_s {stats['h2d_s']:.4f}, compute_s {stats['compute_s']:.4f}, "
          f"readback wait {wait:.4f} s; profiled: kernels "
          f"{rec['kernel_busy_ms_per_batch']:.2f} and H2D copies "
          f"{rec['h2d_copy_ms_per_batch']:.2f} of "
          f"{rec['profiled_wall_ms_per_batch']:.2f} ms/batch, idle share "
          f"{rec['idle_share']:.3f}; every batch identical to the per-batch "
          f"step on device copies; no host sync in the step [{card}]",
          flush=True)
    return rec


def _near_pairs(xy, radius: float):
    """Pairs (i < j) of points [N,2] in metres closer than ``radius``, by a
    hash grid of cell ``radius`` (3×3 neighbourhood)."""
    import numpy as np
    cells = {}
    keys = np.floor(xy / radius).astype(np.int64)
    for i, (cx, cy) in enumerate(keys.tolist()):
        cells.setdefault((cx, cy), []).append(i)
    pairs = []
    for i, (cx, cy) in enumerate(keys.tolist()):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for j in cells.get((cx + dx, cy + dy), ()):
                    if j > i and np.hypot(*(xy[i] - xy[j])) < radius:
                        pairs.append((i, j))
    return pairs


def _nearest_within(points, found, radius: float):
    """For each of ``points`` [N,2] (metres), whether a ``found`` point lies
    within ``radius``."""
    import numpy as np
    cells = {}
    for j, key in enumerate(np.floor(found / radius).astype(np.int64)
                            .tolist()):
        cells.setdefault(tuple(key), []).append(j)
    hit = np.zeros(len(points), bool)
    for i, (cx, cy) in enumerate(np.floor(points / radius).astype(np.int64)
                                 .tolist()):
        near = [j for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for j in cells.get((cx + dx, cy + dy), ())]
        if near:
            hit[i] = np.hypot(*(found[near] - points[i]).T).min() < radius
    return hit


def city_scan(torch, record, card, open_window, close_window):
    """10b: a ``CarDetector`` city scan on the card: the port's FakeWorld
    (``SCAN_WORLD``, the training world's density) served by the port's
    FakeTileServer over WMS JPEG at the fixture's training scale (640 px a
    320 m tile, 0.5 m/px), the central 0.04° square, overlap 0.25; the
    step is the one ``detect()`` builds on ``cuda`` (YOLOv7-tiny, trained
    fixture, batch 64, bf16; 320 m tiles scale its slots to K=1024, D=256).
    Gates: recall ≥ 0.8 within 3 m of the world's cars inside the AOI (5 m
    margin), no two kept records within the 2 m dedup radius, the GeoJSON,
    coverage and shapefile written and the checkpoint cleared after
    periodic checkpoints, and one NMS kernel launch a batch at B=64,
    K=1024, D=256. The figure is host-bound: the fake server renders and
    JPEG-encodes every tile in Python."""
    import shutil
    import numpy as np
    from aerial_image_recognition_tpu_torch.fetch.fake import (
        FakeTileServer, FakeWorld)
    from aerial_image_recognition_tpu_torch.gio.geojson import (
        read_geojson, write_geojson)
    from aerial_image_recognition_tpu_torch.gio.shapefile import (
        read_shapefile)
    from aerial_image_recognition_tpu_torch.ops import nms_kernel
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    from aerial_image_recognition_tpu_torch.utils.native import native_paths
    base = os.path.join(ROOT, "chiprun_out", "scan")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    w, s, e, n = SCAN_AOI
    frame = os.path.join(base, "aoi.geojson")
    write_geojson({"type": "FeatureCollection", "features": [{
        "type": "Feature", "properties": {}, "geometry": {
            "type": "Polygon", "coordinates": [[[w, s], [e, s], [e, n],
                                                [w, n], [w, s]]]}}]}, frame)
    world = FakeWorld(**SCAN_WORLD)
    srv = FakeTileServer(world)
    srv.start()
    kernel = nms_kernel.nms_suppress
    shapes = []

    def spy(boxes_t, scores, classes, **kw):
        shapes.append((tuple(boxes_t.shape), kw["max_det"]))
        return kernel(boxes_t, scores, classes, **kw)

    det = CarDetector(base, {
        "frame_path": frame, "use_xyz": False,
        "wms_url": srv.base_url + "/wms", "wms_layer": "fake",
        "wms_size": (SIZE, SIZE), "tile_size_meters": SCAN_TILE_M,
        "tile_overlap": SCAN_OVERLAP, "confidence_threshold": 0.4,
        "duplicate_distance": 2.0, "checkpoint_interval": 100,
        "params_path": FIXTURE, "dtype": "bfloat16", "device_batch": B,
        "batch_size": B, "num_workers": 16, "submit_spacing": 0.0,
        "event_log": os.path.join(base, "events.jsonl")})
    torch.cuda.reset_peak_memory_stats()
    # the wrapper counts its launches on the module's nms_suppress, the spy
    # while it stands there; they go back on the wrapper's count after
    spy.launches = 0
    open_window()
    nms_kernel.nms_suppress = spy
    try:
        t0 = time.perf_counter()
        out = det.detect(force_restart=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        nms_kernel.nms_suppress = kernel
        kernel.launches += spy.launches
        srv.stop()
    close_window("scan", ["nms_suppress"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out_dir = os.path.join(base, "output")
    doc = read_geojson(os.path.join(out_dir, "detections_results.geojson"))
    meta = doc["metadata"]
    ingest = meta["ingest_stats"]
    step = det.last_step
    if (step.device.type, step.batch, step.input_size, step.model_size) \
            != ("cuda", B, SIZE, SIZE):
        fail(f"scan step {step.device} {step.batch} {step.input_size} "
             f"{step.model_size}")
    if set(shapes) != {((B, 4, SCAN_SLOTS[0]), SCAN_SLOTS[1])} \
            or len(shapes) != ingest["batches"] \
            or kernel.launches != ingest["batches"]:
        fail(f"scan: suppression calls {sorted(set(shapes))} x{len(shapes)},"
             f" {kernel.launches} kernel launches, {ingest['batches']} "
             "batches")
    for name in ("detections_results.geojson", "detections_coverage.geojson",
                 "detections_results.shp", "detections_results.dbf"):
        if not os.path.exists(os.path.join(out_dir, name)):
            fail(f"scan: {name} not written")
    n_shp = len(read_shapefile(os.path.join(out_dir,
                                            "detections_results.shp")))
    cov = read_geojson(os.path.join(out_dir, "detections_coverage.geojson"))
    kinds = [json.loads(line)["kind"]
             for line in open(os.path.join(base, "events.jsonl"))]
    state = os.path.join(out_dir, "checkpoints",
                         "detections_processing_state.json")
    if os.path.exists(state) or kinds.count("checkpoint") < 1:
        fail(f"scan: checkpoint left behind or never written "
             f"({kinds.count('checkpoint')} checkpoints)")
    found = np.array([f["geometry"]["coordinates"] for f in doc["features"]],
                     np.float64)
    if len(found) == 0 or n_shp != len(found) \
            or len(cov["features"]) != out["tiles"]:
        fail(f"scan: {len(found)} records, {n_shp} shapefile records, "
             f"{len(cov['features'])} coverage tiles of {out['tiles']}")
    cars = world.cars[:, :2]
    margin = np.array([5 * M2LON, 5 * M2LAT])
    inside = ((cars > np.array([w, s]) + margin)
              & (cars < np.array([e, n]) - margin)).all(1)
    lon0, lat0 = (w + e) / 2, (s + n) / 2

    def to_m(ll):
        return np.stack([(ll[:, 0] - lon0) / M2LON,
                         (ll[:, 1] - lat0) / M2LAT], axis=1)

    truth, kept = to_m(cars[inside]), to_m(found)
    rec_3m = float(_nearest_within(truth, kept, 3.0).mean())
    prec_3m = float(_nearest_within(kept, truth, 3.0).mean())
    dups = _near_pairs(kept, 2.0)
    if rec_3m < 0.8 or dups:
        fail(f"scan: recall@3m {rec_3m:.3f} of {len(truth)} cars, "
             f"{len(dups)} kept pairs within 2 m")
    from aerial_image_recognition_tpu_torch.utils import native
    rec = {"world": SCAN_WORLD, "aoi": SCAN_AOI, "tile_m": SCAN_TILE_M,
           "overlap": SCAN_OVERLAP, "px": SIZE, "tiles": out["tiles"],
           "wall_s": wall, "tiles_per_s": out["tiles"] / wall,
           "detections": len(found), "cars_inside": int(inside.sum()),
           "recall_3m": rec_3m, "precision_3m": prec_3m,
           "pairs_within_2m": 0, "phase_timings": det.timers.report(),
           "fetch_stats": meta["fetch_stats"], "ingest_stats": ingest,
           "nms_calls": {"count": len(shapes), "boxes_t": [B, 4, SCAN_SLOTS[0]],
                         "max_det": SCAN_SLOTS[1]},
           "checkpoints": kinds.count("checkpoint"),
           "native": native_paths(),
           "native_build_dir": str(native.BUILD_DIR),
           "peak_mem_gb": peak_gb, "bound": "host (fake server renders and "
           "JPEG-encodes each tile in Python)"}
    record["scan"] = rec
    fs = meta["fetch_stats"]
    print(f"scan: CarDetector over {out['tiles']} WMS JPEG tiles of {SIZE} px "
          f"({SCAN_TILE_M:.0f} m, overlap {SCAN_OVERLAP}) in {wall:.2f} s, "
          f"{rec['tiles_per_s']:.1f} tiles/s (host-bound: the fake server "
          f"renders and JPEG-encodes every tile in Python); "
          f"{len(found)} records, recall@3m {rec_3m:.3f} of "
          f"{len(truth)} cars, precision@3m {prec_3m:.3f}, no pair within "
          f"2 m; {ingest['batches']} batches, nms_suppress at B={B}, "
          f"K={SCAN_SLOTS[0]}, D={SCAN_SLOTS[1]} once a batch; "
          f"{rec['checkpoints']} checkpoints, cleared; fetch "
          f"{fs['successes']}/{fs['requests']} requests ok, "
          f"{fs['mb_fetched']} MB; native {rec['native']}; peak memory "
          f"{peak_gb:.2f} GB; phases {rec['phase_timings']} [{card}]",
          flush=True)
    return rec


# ------------------------------------------------ 9. the other families

def render_centred_tiles(rng, n_car: int, n_empty: int,
                         size: int = V8N_SIZE, px_per_m: float = 10.0):
    """Tiles at the trained nano's scale (0.1 m/px: 9.6 m per 96-px tile)
    in the texture of render_tiles: n_car with one 4.5×2 m car near the
    centre (within 0.5 m), then n_empty with none. Returns (uint8
    [n,size,size,3], bounds [n,4], centred flags)."""
    import numpy as np
    lat0 = 52.2
    m2lon = 1.0 / (111319.9 * math.cos(math.radians(lat0)))
    m2lat = 1.0 / 111319.9
    span = size / px_per_m
    tiles, bounds = [], []
    for t in range(n_car + n_empty):
        west, north = 21.0 + t * 3 * span * m2lon, lat0 + span * m2lat
        east, south = west + span * m2lon, lat0
        xs = np.linspace(west, east, size, endpoint=False)
        ys = np.linspace(north, south, size, endpoint=False)
        lon_g, lat_g = np.meshgrid(xs, ys)
        tex = np.sin(lon_g * 201000.0) * np.cos(lat_g * 173000.0) * 0.5 + 0.5
        img = (90 + 40 * tex).astype(np.uint8)
        img = np.stack([img, img, img + 8], axis=-1).astype(np.uint8)
        if t < n_car:
            cx, cy = span / 2 + rng.uniform(-0.5, 0.5, 2)
            img[int((cy - 1.0) * px_per_m):int((cy + 1.0) * px_per_m),
                int((cx - 2.25) * px_per_m):int((cx + 2.25) * px_per_m)] = \
                (230, 235, 240)
        tiles.append(img)
        bounds.append((west, south, east, north))
    return (np.stack(tiles), np.asarray(bounds, np.float32),
            [t < n_car for t in range(n_car + n_empty)])


def unit_variance_tree(torch, name, images, n: int = 2):
    """A seeded registry model's f32 flax-format tree, rescaled on the CPU
    so that it computes something: a seeded 100-layer trunk fades to a
    constant (every anchor the same scores and class, every activation on
    the same rounding tie), so each conv is scaled, in the order they run
    on n tiles, to unit output deviation (layer-sequential unit variance),
    and each yolov8 class logit to mean −5 and unit deviation, so that
    neither class owns the top candidates."""
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.models.weights import (
        params_to_flax)
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    module = create_model(name, device="cpu", dtype=torch.float32).module

    def unit_std(conv, _inp, out):
        s = out.std()
        conv.weight.div_(s)
        if conv.bias is not None:
            conv.bias.div_(s)
        return out / s

    def class_std(head, _inp, out):
        mean, std = out.mean((0, 1, 2)), out.std((0, 1, 2))
        head.weight.div_(std[:, None])
        head.bias.sub_(mean).div_(std).sub_(5.0)
        return (out - mean) / std - 5.0

    hooks = [m.register_forward_hook(unit_std) for m in module.modules()
             if isinstance(m, torch.nn.Conv2d)]
    if hasattr(module, "detect"):
        hooks += [m.register_forward_hook(class_std) for m in (
            getattr(module.detect, f"cls{i}_out") for i in range(3))]
    try:
        with torch.no_grad():
            module(preprocess_batch(torch.from_numpy(images[:n]),
                                    out_size=SIZE, dtype=torch.float32))
    finally:
        for h in hooks:
            h.remove()
    return params_to_flax(module)


def raw_maps_card_vs_cpu(torch, name, tree, images, n: int = 2):
    """The registry model's raw head maps in f32 (the rescaled seeded
    tree, BN folded, cuDNN TF32 off) on n tiles, card against CPU: the
    largest difference as a share of the largest magnitude, per level."""
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    kw = dict(dtype=torch.float32, fold_bn=True, variables=tree)
    x = preprocess_batch(torch.from_numpy(images[:n]), out_size=SIZE,
                         dtype=torch.float32)
    with torch.inference_mode():
        want = create_model(name, device="cpu", **kw).module(x)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        got = [o.cpu() for o in create_model(name, device="cuda",
                                             **kw).module(x.cuda())]
        torch.backends.cudnn.allow_tf32 = tf32
    rel = []
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{name}: raw maps on the card {tuple(g.shape)} / finite "
                 f"{bool(torch.isfinite(g).all())}")
        rel.append(float((g - w).abs().max() / w.abs().max()))
    # f32 convolutions of a 100-layer trunk summed in another order
    if max(rel) > 1e-3:
        fail(f"{name}: raw maps on the card differ from the CPU's by "
             f"{rel} of their largest magnitude")
    return {"tiles": n, "rel_err_by_level": rel}


def family_step(torch, name, images, bounds, record, card, timed: int = 10):
    """A seeded full-width bf16 step of a registry model: timed with host
    and with device input, peak memory, GFLOP per tile by hooks and the
    bound at the bf16 tensor-core peak. Returns (step, device images,
    device bounds)."""
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    step = build_detect_step(DetectorConfig.from_dict(dict(
        model_path=name, device_batch=B, dtype="bfloat16")))
    torch.cuda.reset_peak_memory_stats()
    out, host_ms = timed_steps(torch, step, images, bounds, timed)
    dev_images = torch.from_numpy(images).cuda()
    dev_bounds = torch.from_numpy(bounds).cuda()
    _, dev_ms = timed_steps(torch, step, dev_images, dev_bounds, timed)
    peak = torch.cuda.max_memory_allocated() / 1e9
    det, lon, lat = out
    if tuple(det.boxes.shape) != (B, D, 4) or not all(
            bool(torch.isfinite(t).all()) for t in (det.boxes, lon, lat)):
        fail(f"{name}: step output {tuple(det.boxes.shape)}, not finite")
    flops = step_flops(torch, step, dev_images, dev_bounds)
    rec = {"model": name, "weights": "seeded (seed 0, prior bias)",
           "batch": B, "size": SIZE, "dtype": "bfloat16",
           "timed_steps": timed, "step_ms_host_input": host_ms,
           "tiles_per_s_host_input": B / host_ms * 1e3,
           "step_ms_device_input": dev_ms,
           "tiles_per_s_device_input": B / dev_ms * 1e3,
           "peak_mem_gb": peak, "gflop_per_tile": flops / B / 1e9,
           "bound_ms": flops / BF16_FLOPS * 1e3,
           "bound_share": flops / BF16_FLOPS * 1e3 / dev_ms,
           "detections_at_default_threshold": int(det.valid.sum())}
    record[name] = rec
    print(f"{name}: {host_ms:.2f} ms/batch of {B} (host uint8 input), "
          f"{B / host_ms * 1e3:.1f} tiles/s; {dev_ms:.2f} ms with the batch "
          f"on the card ({B / dev_ms * 1e3:.1f} tiles/s); peak memory "
          f"{peak:.2f} GB; {rec['gflop_per_tile']:.1f} GFLOP a tile, bound "
          f"{rec['bound_ms']:.3f} ms ({rec['bound_share']:.3f} of the step) "
          f"[{card}]", flush=True)
    return step, dev_images, dev_bounds


def class_aware_nms_on_step(torch, name, tree, images, bounds, record,
                            card, close_window):
    """One step of ``name`` at a confidence threshold (0.001) below every
    seeded score, so that every candidate is live and the slots fill as far
    as suppression leaves them: the suppression kernel's own inputs from
    that step (B=64, K=256, D=64, class-aware) are recorded, the path's
    launch window is closed, and the kernel's picks on those inputs must
    equal the plain version's bit for bit, with both classes among the
    picks. The weights are the rescaled seeded tree (``unit_variance_tree``):
    scores, boxes and classes vary with the image. Returns the kernel's
    device ms there."""
    from aerial_image_recognition_tpu_torch.ops import nms_kernel
    from aerial_image_recognition_tpu_torch.ops.nms import _suppress_plain
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    step = build_detect_step(DetectorConfig.from_dict(dict(
        model_path=name, device_batch=B, dtype="bfloat16",
        confidence_threshold=0.001)), bundle=create_model(
            name, variables=tree, dtype=torch.bfloat16, fold_bn=True))
    kernel = nms_kernel.nms_suppress
    seen = []

    def spy(*args, **kw):
        seen.append((args, kw))
        return kernel(*args, **kw)

    # the wrapper counts its launches on the module's nms_suppress, the spy
    # while it stands there; they go back on the wrapper's count after
    spy.launches = 0
    nms_kernel.nms_suppress = spy
    try:
        out = step(images, bounds)
        torch.cuda.synchronize()
    finally:
        nms_kernel.nms_suppress = kernel
        kernel.launches += spy.launches
    close_window()
    if len(seen) != 1:
        fail(f"{name}: {len(seen)} suppression calls in one step")
    args, kw = seen[0]
    if not kw["class_aware"] or tuple(args[0].shape) != (B, 4, K) \
            or kw["max_det"] != D:
        fail(f"{name}: suppression inputs {tuple(args[0].shape)} {kw}")
    got = kernel(*args, **kw)
    want = _suppress_plain(*args, **kw)
    torch.cuda.synchronize()
    for label, g, w in zip(("idx", "conf", "cls"), got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            fail(f"{name}: class-aware nms_suppress {label} differs from the "
                 f"plain version in {int((g != w).sum())} slots")
    valid = got[1] >= 0.001
    classes = sorted(set(got[2][valid].tolist()))
    if classes != [0, 1] or int(out[0].valid.sum()) != int(valid.sum()) \
            or int(valid.sum()) < B:
        fail(f"{name}: picks hold classes {classes}, "
             f"{int(valid.sum())} of {B * D} slots valid, the step's "
             f"output {int(out[0].valid.sum())}")
    dev_ms, ev_ms = kernel_ms(torch, lambda: kernel(*args, **kw), 200,
                              "nms_suppress_kernel")
    rec = {"shape": [B, K, D], "class_aware": True, "bit_identical": True,
           "weights": "seeded, rescaled to unit variance (unit_variance_tree)",
           "classes": classes, "valid_picks": int(valid.sum()),
           "per_class_picks": [int((got[2][valid] == c).sum())
                               for c in classes],
           "kernel_ms": dev_ms, "events_ms": ev_ms}
    record[name]["class_aware_nms"] = rec
    print(f"{name}: class-aware nms_suppress on the step's own candidates "
          f"(B={B}, K={K}, D={D}) bit-identical to plain, classes {classes} "
          f"({rec['per_class_picks']} picks), {dev_ms:.4f} ms device time "
          f"(events {ev_ms:.4f}) [{card}]", flush=True)
    return dev_ms


def trained_nano(torch, record, card):
    """9b: the trained yolov8n at its training scale, batch 64: bf16
    against f32 on the card, the car-centred tiles found and the empty
    tiles quiet (tests/test_v8_detection_quality.py's bar: >= 7 of 8 with
    the box centre within 15 px of mid-tile; none on the empty ones), and
    a DetectionServer answering JPEG requests with class names. Returns
    (bf16 step, tiles, bounds, centred flags)."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step, detection_sets_agree)
    from aerial_image_recognition_tpu_torch.pipeline.serve import (
        DetectionServer)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    rng = np.random.default_rng(9)
    tiles, bounds, centred = render_centred_tiles(rng, B // 2, B // 2)
    kw = dict(batch=B, src_size=V8N_SIZE, model_size=V8N_SIZE)
    base = dict(model_path="yolov8n", params_path=V8_FIXTURE)
    torch.backends.cudnn.allow_tf32 = False
    ref = build_detect_step(DetectorConfig.from_dict(
        dict(base, dtype="float32")), **kw)(tiles, bounds)
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = True
    step = build_detect_step(DetectorConfig.from_dict(
        dict(base, dtype="bfloat16")), **kw)
    out, ms = timed_steps(torch, step, tiles, bounds, 10)
    ok, agree = detection_sets_agree(out, ref)
    if not ok or agree["matched"] < 0.9 * max(agree["total_a"],
                                              agree["total_b"]):
        fail(f"yolov8n: bf16 step disagrees with the f32 step: {agree}")
    det = out[0]
    hit, noisy = 0, []
    for i, is_car in enumerate(centred):
        n = int(det.valid[i].sum())
        if not is_car:
            if n:
                noisy.append(i)
            continue
        if n:
            j = int(torch.argmax(torch.where(det.valid[i], det.scores[i],
                                             -1.0)))
            cx, cy = det.boxes[i, j, :2].tolist()
            hit += abs(cx - V8N_SIZE / 2) < 15 and abs(cy - V8N_SIZE / 2) < 15
    n_car = sum(centred)
    if hit < 7 / 8 * n_car or noisy:
        fail(f"yolov8n: {hit} of {n_car} car-centred tiles found, false "
             f"positives on empty tiles {noisy}")
    srv = DetectionServer(detect_step=step, max_wait_ms=20.0).start()
    try:
        replies = post_jpegs(srv.url, tiles, bounds, min(8, B // 2))
        with urllib.request.urlopen(srv.url + "/stats", timeout=60) as r:
            stats = json.load(r)
    finally:
        srv.stop()
    names = set()
    for k, (status, body) in enumerate(replies):
        if status != 200 or body["count"] != len(body["detections"]) \
                or (centred[k] and not body["detections"]):
            fail(f"yolov8n server request {k}: status {status}, {body}")
        names |= {d["class"] for d in body["detections"]}
    if not names or not names <= {"car", "truck"}:
        fail(f"yolov8n server: class names {names}")
    record["yolov8n"] = {
        "weights": V8_FIXTURE, "batch": B, "size": V8N_SIZE,
        "step_ms_host_input": ms, "tiles_per_s_host_input": B / ms * 1e3,
        "agree_f32": agree, "car_tiles_found": hit, "car_tiles": n_car,
        "empty_tiles_quiet": B - n_car, "server": {
            "requests": len(replies), "class_names": sorted(names),
            "batches": stats["batches"]}}
    print(f"yolov8n (trained, {V8N_SIZE} px at 0.1 m/px): {ms:.2f} ms/batch "
          f"of {B}; bf16 against f32 {agree}; {hit} of {n_car} car-centred "
          f"tiles found, {B - n_car} empty tiles quiet; server answered "
          f"{len(replies)} JPEG requests, classes {sorted(names)} [{card}]",
          flush=True)
    return step, tiles, bounds, centred


def int8_trunk_card_vs_cpu(torch, name, tree, images, record, card,
                           n: int = 4, size: int = TRUNK_SIZE):
    """9d: the int8 trunk of a registry model (a flax-format tree) on the
    card against the CPU, one calibration (on the card, f32, n tiles at
    ``size``). The CPU runs the trunk; every conv and residual add is also
    run on the card on the CPU's own inputs, and its codes must equal the
    CPU's within 1 LSB on <= 1e-4 of them (silu's ``exp`` may round an ULP
    apart; leaky, relu and the adds are exact). From the same P2 codes the
    card's whole chain is then read at the taps (yolov7: three; yolov8: six
    tower outputs): a flipped code travels on and, in a seeded network
    rescaled to unit variance, grows with depth, so those shares are
    recorded, not held to a bound."""
    from aerial_image_recognition_tpu_torch.models.int8 import (
        QT, _Run, calibrate_absmax, quantize_bundle)
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    kw = dict(dtype=torch.float32, fold_bn=True, variables=tree)
    dev_bundle = create_model(name, device="cuda", **kw)
    absmax = calibrate_absmax(dev_bundle, [images[:n]], model_size=size)
    q_dev = quantize_bundle(dev_bundle, [], absmax=absmax)
    q_cpu = quantize_bundle(create_model(name, device="cpu", **kw), [],
                            absmax=absmax)
    act = "leaky" if getattr(q_cpu.module, "variant", "") == "tiny" \
        else "silu"
    ops = []

    def card_run():
        return _Run(q_dev.q["convs"], act=act, scales=q_dev.static_scales)

    def up(x):
        parts = x if isinstance(x, list) else [x]
        dev = [QT(p.v.cuda(), p.s, p.c) for p in parts]
        return dev if len(dev) > 1 else dev[0]

    class Paired(_Run):
        def conv(self, key, x, kernel, stride=1):
            out = super().conv(key, x, kernel, stride)
            ops.append(codes_diff(torch, card_run().conv(
                key, up(x), kernel, stride).v.cpu(), out.v))
            return out

        def add(self, key, y, x):
            out = super().add(key, y, x)
            ops.append(codes_diff(torch, card_run().add(
                key, up(y), up(x)).v.cpu(), out.v))
            return out

    x = preprocess_batch(torch.from_numpy(images[:n]), out_size=size,
                         dtype=torch.float32)
    rec = {"tiles": n, "size": size}
    with torch.inference_mode():
        p2 = q_cpu._p2_quantize(q_cpu.module.stems(x))
        q_cpu.trunk_codes(p2, Paired(q_cpu.q["convs"], act=act,
                                     scales=q_cpu.static_scales))
        rec["ops"] = len(ops)
        rec["op_codes_differ_max"] = max(share for share, _ in ops)
        rec["op_max_abs"] = max(w for _, w in ops)
        rec["ops_differing"] = sum(share > 0 for share, _ in ops)
        if rec["op_codes_differ_max"] > 1e-4 or rec["op_max_abs"] > 1:
            fail(f"{name} int8 trunk: a conv on the card differs from the "
                 f"CPU's on {rec['op_codes_differ_max']:.2e} of its codes "
                 f"(max {rec['op_max_abs']})")
        taps_cpu = q_cpu.trunk_codes(p2)
        taps_dev = q_dev.trunk_codes(p2.cuda())
        shares, worst = [], 0
        for c, d in zip(taps_cpu, taps_dev):
            share, w = codes_diff(torch, d.v.cpu(), c.v)
            shares.append(share)
            worst = max(worst, w)
        rec["tap_codes_differ"] = shares
        rec["tap_max_abs"] = worst
    record.setdefault(name, {})["int8_trunk_card_vs_cpu"] = rec
    print(f"{name} int8 trunk, card against CPU ({n} tiles at {size} px): "
          f"each of {rec['ops']} convs and adds on the CPU's inputs equal "
          f"within 1 LSB, {rec['ops_differing']} of them on up to "
          f"{rec['op_codes_differ_max']:.1e} of their codes; the whole "
          f"chain from the same P2 codes differs at the {len(shares)} taps "
          f"on {[f'{v:.1e}' for v in shares]} (max {worst}) [{card}]",
          flush=True)


def int8_family_steps(torch, name, step, dev_images, dev_bounds, images,
                      record, card, timed: int = 5):
    """9d: the seeded bf16 step's bundle quantized (calibrated on 8 of the
    tiles at 640 px), its int8 step timed with the batch on the card, in
    turns with the bf16 step: int8, bf16, int8."""
    from aerial_image_recognition_tpu_torch.models.int8 import (
        quantize_bundle)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    qb = quantize_bundle(step.bundle, [images[:8]])
    qstep = build_detect_step(DetectorConfig.from_dict(dict(
        model_path=name, device_batch=B, dtype="bfloat16")), bundle=qb)
    torch.cuda.reset_peak_memory_stats()
    q_out, q_ms = timed_steps(torch, qstep, dev_images, dev_bounds, timed)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, bf_ms = timed_steps(torch, step, dev_images, dev_bounds, timed)
    _, q_ms2 = timed_steps(torch, qstep, dev_images, dev_bounds, timed)
    det = q_out[0]
    if tuple(det.boxes.shape) != (B, D, 4) \
            or not bool(torch.isfinite(det.boxes).all()):
        fail(f"{name} int8 step: output {tuple(det.boxes.shape)}")
    record[name]["int8_step"] = {
        "step_ms_device_input": [q_ms, q_ms2],
        "bf16_step_ms_device_input_between": bf_ms,
        "peak_mem_gb": peak, "convs": len(qb.q["convs"])}
    print(f"{name} int8: {q_ms:.2f} / {q_ms2:.2f} ms/batch of {B} with the "
          f"batch on the card, bf16 step between them {bf_ms:.2f} ms; "
          f"{len(qb.q['convs'])} int8 convs, peak memory {peak:.2f} GB "
          f"[{card}]", flush=True)
    return qstep


def turnkey_nano(torch, tiles, bounds, record, card):
    """9d: turnkey int8 on the trained nano (no calibration file): two
    calibration batches, the parity gate, state ``int8``; then matched >=
    0.9 against its bf16 step."""
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        SelfQuantizingStep, build_detect_step, detection_sets_agree)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    cfg = DetectorConfig.from_dict(dict(
        model_path="yolov8n", params_path=V8_FIXTURE, dtype="bfloat16",
        quantize="int8"))
    step = build_detect_step(cfg, batch=B, src_size=V8N_SIZE,
                             model_size=V8N_SIZE)
    if not isinstance(step, SelfQuantizingStep):
        fail(f"yolov8n turnkey built a {type(step).__name__}")
    states = [step.quantize_state]
    for _ in range(2):
        step(tiles, bounds)
        states.append(step.quantize_state)
    if states != ["calibrating", "calibrating", "int8"]:
        fail(f"yolov8n turnkey went through {states}: "
             f"{step.fallback_reason}")
    out, ms = timed_steps(torch, step, tiles, bounds, 5)
    ok, agree = detection_sets_agree(step.base_step(tiles, bounds), out)
    if not ok or agree["matched"] < 0.9 * max(agree["total_a"],
                                              agree["total_b"]):
        fail(f"yolov8n int8 disagrees with its bf16 step: {agree}")
    record["yolov8n"]["turnkey_int8"] = {
        "states": states, "parity": step.parity, "agree_bf16": agree,
        "step_ms_host_input": ms}
    print(f"yolov8n turnkey int8: states {states}, parity {step.parity}; "
          f"{ms:.2f} ms/batch of {B}; agreement with the bf16 step {agree} "
          f"[{card}]", flush=True)


def other_families(torch, record, card, images, bounds, open_window,
                   close_window):
    """Phase 9: seeded YOLOv8l and yolov7-base at full width, the trained
    nano at its training scale, then their int8 paths, each in its launch
    window; YOLOv8l's bf16 and int8 steps profiled last. Returns the
    class-aware NMS kernel's device ms on YOLOv8l's own candidates."""
    trees = {fam: unit_variance_tree(torch, fam, images)
             for fam in ("yolov8_tokyo", "yolov7_base")}
    open_window()
    v8_step, v8_images, v8_bounds = family_step(
        torch, "yolov8_tokyo", images, bounds, record, card)
    aware_ms = class_aware_nms_on_step(
        torch, "yolov8_tokyo", trees["yolov8_tokyo"], images, bounds, record,
        card, lambda: close_window("yolov8_tokyo", ["nms_suppress"]))
    open_window()
    _, nano_tiles, nano_bounds, _ = trained_nano(torch, record, card)
    close_window("yolov8n", ["nms_suppress"])
    open_window()
    v7b_step, v7b_images, v7b_bounds = family_step(
        torch, "yolov7_base", images, bounds, record, card)
    close_window("yolov7_base", ["nms_suppress"])
    for fam in ("yolov8_tokyo", "yolov7_base"):
        record[fam]["raw_card_vs_cpu"] = rel = raw_maps_card_vs_cpu(
            torch, fam, trees[fam], images)
        print(f"{fam}: raw head maps of {rel['tiles']} tiles in f32, card "
              f"against CPU: largest difference "
              f"{[f'{v:.1e}' for v in rel['rel_err_by_level']]} of the "
              f"largest magnitude [{card}]", flush=True)
        int8_trunk_card_vs_cpu(torch, fam, trees[fam], images, record, card)
    from aerial_image_recognition_tpu_torch.models.weights import load_params
    int8_trunk_card_vs_cpu(torch, "yolov8n", load_params(V8_FIXTURE),
                           nano_tiles, record, card, size=V8N_SIZE)
    open_window()
    q_v8_step = int8_family_steps(torch, "yolov8_tokyo", v8_step, v8_images,
                                  v8_bounds, images, record, card)
    int8_family_steps(torch, "yolov7_base", v7b_step, v7b_images,
                      v7b_bounds, images, record, card)
    turnkey_nano(torch, nano_tiles, nano_bounds, record, card)
    close_window("int8 families", ["nms_suppress", "int8_epilogue"])
    for label, fam_step in (("yolov8_tokyo", v8_step),
                            ("yolov8_tokyo int8", q_v8_step)):
        prof = profile_step(torch, fam_step, v8_images, v8_bounds, n=2)
        record["yolov8_tokyo"][
            "profile_int8" if "int8" in label else "profile"] = prof
        if "top" in prof:
            print(f"{label} profile: device busy "
                  f"{prof['device_busy_ms_per_step']:.2f} of "
                  f"{prof['wall_ms_per_step_profiled']:.2f} ms/step, idle "
                  f"share {prof['idle_share']:.3f}, top: " + "; ".join(
                      f"{r['ms_per_step']:.3f} ms {r['name'][:60]}"
                      for r in prof["top"][:8]) + f" [{card}]", flush=True)
    return aware_ms


def scan_only(torch, record, card) -> None:
    """``--scan-only``: the NMS kernel against its plain version
    (``NMS_CASES``, the scan's shape among them), the default step timed as
    in phase 4, then phase 10 — the quick card check of the city scan."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    record["kernels"] = [check_nms_kernel(torch, record)]
    print(f"nms_suppress: bit-identical to plain on "
          f"{len(record['nms_cases'])} cases [{card}]", flush=True)
    images, bounds, _ = render_tiles(np.random.default_rng(1), B, SIZE)
    step = build_detect_step(DetectorConfig.from_dict(dict(
        params_path=FIXTURE, device_batch=B, dtype="bfloat16")))
    _, step_ms = timed_steps(torch, step, images, bounds, 20)
    _, device_ms = timed_steps(torch, step, torch.from_numpy(images).cuda(),
                               torch.from_numpy(bounds).cuda(), 20)
    print(f"step: {step_ms:.2f} ms/batch of {B} (host uint8 input); "
          f"{device_ms:.2f} ms with the batch on the card [{card}]",
          flush=True)
    launches = {}

    def open_window():
        nms_suppress.launches = 0

    def close_window(path, needed):
        launches[path] = {"nms_suppress": nms_suppress.launches}
        if "nms_suppress" in needed and not nms_suppress.launches:
            fail(f"the {path} path never launched nms_suppress")

    ingest_ring(torch, record, card, step, images, bounds, step_ms,
                device_ms, open_window, close_window)
    city_scan(torch, record, card, open_window, close_window)
    record["kernels"][0]["launches"] = sum(
        p["nms_suppress"] for p in launches.values())
    record["kernels"][0]["launches_by_path"] = {
        path: p["nms_suppress"] for path, p in launches.items()}


def main() -> None:
    only_scan = sys.argv[1:] == ["--scan-only"]
    if sys.argv[1:] and not only_scan:
        fail(f"unknown arguments {sys.argv[1:]}: run with none, or with "
             "--scan-only for the city scan's phases alone")
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is missing: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke needs one CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from aerial_image_recognition_tpu_torch.kernels.build import build_all
        from aerial_image_recognition_tpu_torch.models.int8 import (
            save_absmax)
        from aerial_image_recognition_tpu_torch.ops.clahe_kernel import (
            apply_luts)
        from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
            requantize)
        from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
            nms_suppress)
        from aerial_image_recognition_tpu_torch.pipeline.inference import (
            SelfQuantizingStep, build_detect_step, detection_sets_agree)
        from aerial_image_recognition_tpu_torch.pipeline.serve import (
            DetectionServer)
        from aerial_image_recognition_tpu_torch.runtime.config import (
            DetectorConfig)
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    for path in (FIXTURE, V8_FIXTURE):
        if not os.path.exists(path):
            fail(f"trained fixture missing: {path}")
    import numpy as np

    record = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0], "nms_cases": [],
              "clahe_cases": []}

    # 1. the card
    card = card_line()
    print(card, flush=True)
    record["card"] = card
    name = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    build_all(["nms_suppress", "clahe_apply", "int8_epilogue"])
    record["build_s"] = time.perf_counter() - t0
    print(f"build: nms_suppress, clahe_apply, int8_epilogue in "
          f"{record['build_s']:.2f} s", flush=True)
    if only_scan:
        scan_only(torch, record, card)
        finish(torch, record, name, "chip_smoke_scan.json")
        return

    # 3. kernel vs plain
    kernel = check_nms_kernel(torch, record)
    print(f"nms_suppress: bit-identical to plain on "
          f"{len(record['nms_cases'])} cases; {kernel['ms']:.4f} ms "
          f"device time ({kernel['rounds_needed']} rounds; tile-like "
          f"{kernel['ms_tile_like']:.4f} ms, "
          f"{kernel['rounds_needed_tile_like']} rounds; general path "
          f"{kernel['ms_general_path']:.4f} ms; through the wrapper by "
          f"events {kernel['events_ms']:.4f} / "
          f"{kernel['events_ms_tile_like']:.4f} / "
          f"{kernel['events_ms_general_path']:.4f} ms; plain "
          f"{kernel['plain_ms']:.3f} ms, bound {kernel['bound_ms']:.6f} ms); "
          f"ptxas: {' | '.join(record['nms_ptxas'])} [{card}]", flush=True)
    clahe = check_clahe_kernel(torch, record)
    print(f"clahe_apply: raw f32 equal to plain on "
          f"{len(record['clahe_cases'])} cases; {clahe['ms']:.4f} ms "
          f"(plain {clahe['plain_ms']:.3f} ms, bound "
          f"{clahe['bound_ms']:.4f} ms by {clahe['bound_by']}) [{card}]",
          flush=True)

    print(f"clahe stages: histograms, LUTs and the gray path on the card "
          f"equal the CPU's on {len(record['clahe_cases'])} cases "
          f"(tolerance 0) [{card}]", flush=True)

    # 4. the main path at full width, and its f32 reference on this card
    rng = np.random.default_rng(1)
    images, bounds, cars = render_tiles(rng, B, SIZE)
    record["divisions_card_vs_cpu"] = div = check_divisions_on_card(
        torch, images, bounds)
    print(f"f32 native-size preprocess on {div['preprocess_f32_images']} "
          f"tiles and lon/lat of {div['lonlat_points']} points: the card "
          f"equals the CPU (tolerance 0) [{card}]", flush=True)
    record["clahe_rgb_card_vs_cpu"] = rgb = check_clahe_rgb_on_card(
        torch, images)
    print(f"clahe rgb path, card against CPU on {rgb['images']} tiles: "
          f"levels differ on {rgb['levels_differing_frac']:.2e} of the "
          f"pixels (max {rgb['levels_max_diff']}), RGB max abs "
          f"{rgb['rgb_max_abs_err']:.5f}, mean {rgb['rgb_mean_abs_err']:.2e} "
          f"[{card}]", flush=True)
    base = dict(params_path=FIXTURE, device_batch=B)
    torch.backends.cudnn.allow_tf32 = False      # the f32 reference is f32
    ref_step = build_detect_step(
        DetectorConfig.from_dict(dict(base, dtype="float32")))
    ref_out = ref_step(images, bounds)
    torch.cuda.synchronize()
    del ref_step
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default again
    step = build_detect_step(DetectorConfig.from_dict(dict(base,
                                                           dtype="bfloat16")))
    if (step.batch, step.input_size, step.model_size) != (B, SIZE, SIZE):
        fail(f"step shape {(step.batch, step.input_size, step.model_size)}")

    wrappers = {"nms_suppress": nms_suppress, "clahe_apply": apply_luts,
                "int8_epilogue": requantize}
    launches = {}

    def open_window():
        for w in wrappers.values():
            w.launches = 0

    def close_window(path, needed):
        launches[path] = {k: w.launches for k, w in wrappers.items()}
        for k in needed:
            if launches[path][k] == 0:
                fail(f"the {path} path never launched {k}")

    open_window()                                # default path starts here
    n_iter = 20
    out, step_ms = timed_steps(torch, step, images, bounds, n_iter)
    dev_images = torch.from_numpy(images).cuda()
    dev_bounds = torch.from_numpy(bounds).cuda()
    _, device_ms = timed_steps(torch, step, dev_images, dev_bounds, n_iter)

    # 5. the server over the same step
    srv = DetectionServer(detect_step=step, max_wait_ms=20.0).start()
    try:
        n_req = 6
        replies = post_jpegs(srv.url, images, bounds, n_req)
        with urllib.request.urlopen(srv.url + "/stats", timeout=60) as r:
            stats = json.load(r)
    finally:
        srv.stop()
    close_window("default", ["nms_suppress"])    # default path ends here
    default_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # what came out is right
    check_output(torch, "default step", out)
    det = out[0]
    ok, agree = detection_sets_agree(out, ref_out)
    rec_bf16 = recall(out, bounds, cars)
    rec_f32 = recall(ref_out, bounds, cars)
    n_det = int(det.valid.sum())
    if not ok or n_det == 0:
        fail(f"bf16 step disagrees with the f32 step: {agree}")
    if min(rec_bf16, rec_f32) < 0.8:
        fail(f"recall of the rendered cars too low: bf16 {rec_bf16:.3f}, "
             f"f32 {rec_f32:.3f}")
    for k, (status, body) in enumerate(replies):
        if status != 200 or body["count"] != len(body["detections"]):
            fail(f"request {k}: status {status}, {body}")
        if cars[k] and not body["detections"]:
            fail(f"request {k}: no detections on a tile with "
                 f"{len(cars[k])} cars")

    step_rec = {"batch": B, "size": SIZE, "dtype": "bfloat16",
                "step_ms_host_input": step_ms,
                "tiles_per_s_host_input": B / step_ms * 1e3,
                "step_ms_device_input": device_ms,
                "tiles_per_s_device_input": B / device_ms * 1e3,
                "detections": n_det, "agree_f32": agree,
                "recall_bf16": rec_bf16, "recall_f32": rec_f32,
                "cars": sum(len(c) for c in cars),
                "peak_mem_gb": default_peak_gb}
    record.update(step=step_rec, server={
        "requests": n_req, "stats": stats,
        "counts": [body["count"] for _, body in replies]})
    print(f"step: {step_ms:.2f} ms/batch of {B} (host uint8 input), "
          f"{B / step_ms * 1e3:.1f} tiles/s; {device_ms:.2f} ms with the "
          f"batch already on the card; {n_det} detections, f32 agreement "
          f"{agree}, recall bf16 {rec_bf16:.3f} f32 {rec_f32:.3f} [{card}]",
          flush=True)
    print(f"server: {n_req} JPEG /detect requests answered, "
          f"{stats['batches']} batches [{card}]", flush=True)

    # 10. the city scan on the card: the ingest ring alone, then a
    # CarDetector scan of a FakeWorld
    ingest_ring(torch, record, card, step, images, bounds, step_ms,
                device_ms, open_window, close_window)
    city_scan(torch, record, card, open_window, close_window)

    # 6.–7. the accuracy modes at the same width, batch and dtype, held
    # against the rendered cars and the single-scale step's detections
    def mode_path(path, extra, needed, n_timed, per_step):
        mode_step = build_detect_step(DetectorConfig.from_dict(
            dict(base, dtype="bfloat16", **extra)))
        torch.cuda.reset_peak_memory_stats()
        open_window()
        mode_out, ms = timed_steps(torch, mode_step, images, bounds, n_timed)
        close_window(path, needed)
        for k, n_per in per_step.items():
            if launches[path][k] < n_per * (n_timed + 1):
                fail(f"{path}: {launches[path][k]} launches of {k} in "
                     f"{n_timed + 1} steps")
        check_output(torch, f"{path} step", mode_out)
        ok_m, agree_m = detection_sets_agree(mode_out, out)
        rec_m = recall(mode_out, bounds, cars)
        if not ok_m:
            fail(f"{path} step disagrees with the single-scale step: "
                 f"{agree_m}")
        if rec_m < 0.8:
            fail(f"{path}: recall of the rendered cars {rec_m:.3f}")
        rec = {"batch": B, "size": SIZE, "dtype": "bfloat16", "extra": extra,
               "timed_steps": n_timed, "step_ms_host_input": ms,
               "tiles_per_s_host_input": B / ms * 1e3,
               "detections": int(mode_out[0].valid.sum()),
               "agree_single_scale": agree_m, "recall": rec_m,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"{path}: {ms:.2f} ms/batch of {B} (host uint8 input), "
              f"{B / ms * 1e3:.1f} tiles/s; {rec['detections']} detections, "
              f"agreement with the single-scale step {agree_m}, recall "
              f"{rec_m:.3f}, peak memory {rec['peak_mem_gb']:.2f} GB "
              f"[{card}]", flush=True)
        return mode_step, rec

    tta_step, record["tta"] = mode_path(
        "tta", {"tta": True}, ["nms_suppress", "clahe_apply"], 5,
        {"nms_suppress": 1, "clahe_apply": 1})
    record["tta"]["stage_ms"] = tta_stage_times(torch, tta_step, dev_images)
    print("tta stages (ms, each alone): " + ", ".join(
        f"{k} {v:.3f}" for k, v in record["tta"]["stage_ms"].items())
        + f" [{card}]", flush=True)
    ms_step, record["multiscale"] = mode_path(
        "multiscale", {"multiscale": [0.85, 1.0, 1.15]}, ["nms_suppress"], 5,
        {"nms_suppress": 1})
    record["multiscale"]["stage_ms"] = multiscale_stage_times(
        torch, ms_step, dev_images)
    print("multiscale stages (ms, each alone): " + ", ".join(
        f"{k} {v:.3f}" for k, v in record["multiscale"]["stage_ms"].items())
        + f" [{card}]", flush=True)

    # 8. the int8 path at full width
    epilogue = check_int8_product(torch, record, card)
    print(f"int8_epilogue: equal to plain on the card on "
          f"{len(record['int8_cases'])} shapes (leaky, relu; silu within 1 "
          f"LSB on <= 1e-4); {epilogue['ms']:.4f} ms at "
          f"{epilogue['shape']} (plain {epilogue['plain_ms']:.3f} ms, bound "
          f"{epilogue['bound_ms']:.4f} ms by {epilogue['bound_by']}); ptxas: "
          f"{' | '.join(record['int8_epilogue_ptxas'])} [{card}]", flush=True)
    check_int8_trunk(torch, record, images, card)

    # 8c. turnkey: no calibration file; two calibration batches in bf16,
    # then the swap behind the parity gate
    int8_cfg = dict(base, dtype="bfloat16", quantize="int8")
    torch.cuda.reset_peak_memory_stats()
    open_window()                                # int8 path starts here
    qstep = build_detect_step(DetectorConfig.from_dict(int8_cfg))
    if not isinstance(qstep, SelfQuantizingStep):
        fail(f"turnkey int8 built a {type(qstep).__name__}")
    states = []
    for _ in range(2):
        states.append(qstep.quantize_state)
        calib_out = qstep(images, bounds)
    torch.cuda.synchronize()
    states.append(qstep.quantize_state)
    if states != ["calibrating", "calibrating", "int8"]:
        fail(f"turnkey int8 went through {states}; fallback reason: "
             f"{qstep.fallback_reason}")
    if type(qstep.bundle).__name__ != "Int8Bundle" \
            or not qstep.parity or qstep.parity["matched"] < 1:
        fail(f"turnkey int8: bundle {type(qstep.bundle).__name__}, parity "
             f"{qstep.parity}")
    swap_launches = (nms_suppress.launches, requantize.launches)
    # 2 calibration steps + 1 parity replay; one int8 forward so far
    if swap_launches != (3, TRUNK_CONVS):
        fail(f"turnkey int8: {swap_launches} launches of (nms_suppress, "
             f"int8_epilogue) up to the swap, expected (3, {TRUNK_CONVS})")
    n_int8 = 10
    q_out, q_ms = timed_steps(torch, qstep, images, bounds, n_int8)
    _, q_dev_ms = timed_steps(torch, qstep, dev_images, dev_bounds, n_int8)
    int8_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the bf16 step again, in turns with the int8 step, device input
    _, bf16_again_ms = timed_steps(torch, step, dev_images, dev_bounds,
                                   n_int8)
    _, q_dev_ms2 = timed_steps(torch, qstep, dev_images, dev_bounds, n_int8)
    steps_run = 3 + 3 * (n_int8 + 1)
    if (nms_suppress.launches, requantize.launches) != (
            steps_run + n_int8 + 1, TRUNK_CONVS * (steps_run - 2)):
        fail(f"int8 path: {nms_suppress.launches} launches of nms_suppress "
             f"and {requantize.launches} of int8_epilogue after "
             f"{steps_run} steps")
    check_output(torch, "int8 step", q_out)
    ok_q, agree_q = detection_sets_agree(out, q_out)
    rec_q = recall(q_out, bounds, cars)
    if not ok_q:
        fail(f"int8 step disagrees with the bf16 step: {agree_q}")
    if rec_q < 0.8:
        fail(f"int8 step: recall of the rendered cars {rec_q:.3f}")
    # the saved calibration gives the same step
    calib_path = os.path.join(ROOT, "chiprun_out", "int8_absmax.json")
    os.makedirs(os.path.dirname(calib_path), exist_ok=True)
    save_absmax(calib_path, qstep.bundle.absmax)
    file_step = build_detect_step(DetectorConfig.from_dict(
        dict(int8_cfg, quantize_calib=calib_path)))
    if type(file_step.bundle).__name__ != "Int8Bundle":
        fail(f"quantize_calib built a {type(file_step.bundle).__name__}")
    file_out = file_step(images, bounds)
    torch.cuda.synchronize()
    if not same_detections(torch, file_out, q_out):
        fail("the step built from the saved calibration differs from the "
             "turnkey step")
    del file_step
    record["int8"] = {
        "batch": B, "size": SIZE, "stems": "bfloat16", "states": states,
        "parity": qstep.parity, "timed_steps": n_int8,
        "step_ms_host_input": q_ms, "tiles_per_s_host_input": B / q_ms * 1e3,
        "step_ms_device_input": q_dev_ms,
        "tiles_per_s_device_input": B / q_dev_ms * 1e3,
        "step_ms_device_input_second": q_dev_ms2,
        "bf16_step_ms_device_input_between": bf16_again_ms,
        "bf16_step_ms_host_input": step_ms,
        "bf16_step_ms_device_input": device_ms,
        "detections": int(q_out[0].valid.sum()), "agree_bf16": agree_q,
        "recall": rec_q, "peak_mem_gb": int8_peak_gb,
        "calibration_batch_detections": int(calib_out[0].valid.sum()),
        "saved_calibration_same_detections": True}
    print(f"int8 turnkey: states {states}, parity {qstep.parity}; "
          f"{q_ms:.2f} ms/batch of {B} (host uint8 input), "
          f"{B / q_ms * 1e3:.1f} tiles/s; {q_dev_ms:.2f} / {q_dev_ms2:.2f} "
          f"ms with the batch on the card, bf16 step between them "
          f"{bf16_again_ms:.2f} ms (phase 4: {step_ms:.2f} host, "
          f"{device_ms:.2f} device); {record['int8']['detections']} "
          f"detections, agreement with the bf16 step {agree_q}, recall "
          f"{rec_q:.3f}, peak memory {int8_peak_gb:.2f} GB; a step from the "
          f"saved calibration gives the same detections [{card}]",
          flush=True)

    # 8e. int8 under the TTA ladder (512 images a forward: the 3x3 convs
    # run their im2col in batch chunks), against the bf16 TTA step
    tta_out = tta_step(images, bounds)
    torch.cuda.reset_peak_memory_stats()
    q_tta_step = build_detect_step(
        DetectorConfig.from_dict(dict(base, dtype="bfloat16", tta=True)),
        bundle=qstep.bundle)
    q_tta_out, q_tta_ms = timed_steps(torch, q_tta_step, images, bounds, 2)
    check_output(torch, "int8 tta step", q_tta_out)
    ok_t, agree_t = detection_sets_agree(tta_out, q_tta_out)
    rec_t = recall(q_tta_out, bounds, cars)
    if not ok_t or rec_t < 0.8:
        fail(f"int8 tta step: agreement with the bf16 tta step {agree_t}, "
             f"recall {rec_t:.3f}")
    record["int8"]["tta"] = {
        "step_ms_host_input": q_tta_ms, "agree_bf16_tta": agree_t,
        "recall": rec_t, "bf16_tta_step_ms_host_input":
            record["tta"]["step_ms_host_input"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"int8 tta: {q_tta_ms:.2f} ms/batch of {B} (host uint8 input) "
          f"against {record['tta']['step_ms_host_input']:.2f} for the bf16 "
          f"tta step; agreement {agree_t}, recall {rec_t:.3f}, peak memory "
          f"{record['int8']['tta']['peak_mem_gb']:.2f} GB [{card}]",
          flush=True)
    del q_tta_step, tta_out, q_tta_out

    # 8d. the server over a fresh turnkey step, through the swap
    srv_step = build_detect_step(DetectorConfig.from_dict(
        dict(int8_cfg, device_batch=8)))
    srv = DetectionServer(detect_step=srv_step, max_wait_ms=20.0).start()
    try:
        q_replies = []
        for first in (0, 8, 16):
            q_replies += post_jpegs(srv.url, images[first:first + 8],
                                    bounds[first:first + 8], 8)
        with urllib.request.urlopen(srv.url + "/stats", timeout=60) as r:
            q_stats = json.load(r)
    finally:
        srv.stop()
    close_window("int8", ["nms_suppress", "int8_epilogue"])
    for k, (status, body) in enumerate(q_replies):
        if status != 200 or body["count"] != len(body["detections"]):
            fail(f"int8 server request {k}: status {status}, {body}")
        if cars[k] and not body["detections"]:
            fail(f"int8 server request {k}: no detections on a tile with "
                 f"{len(cars[k])} cars")
    if q_stats.get("quantize_state") != "int8" \
            or not q_stats.get("quantize_parity"):
        fail(f"int8 server: /stats says {q_stats}")
    record["int8"]["server"] = {
        "requests": len(q_replies), "stats": q_stats,
        "counts": [body["count"] for _, body in q_replies]}
    print(f"int8 server: {len(q_replies)} JPEG /detect requests answered "
          f"through the swap, {q_stats['batches']} batches, /stats "
          f"quantize_state {q_stats['quantize_state']!r}, parity "
          f"{q_stats['quantize_parity']} [{card}]", flush=True)

    # 9. the other detector families
    kernel["ms_class_aware_v8_step"] = other_families(
        torch, record, card, images, bounds, open_window, close_window)

    # device time by kernel, after every timed run
    profile = profile_step(torch, step, dev_images, dev_bounds)
    flops = step_flops(torch, step, dev_images, dev_bounds)
    # the f32 heads are 0.4 % of these FLOPs; the bound counts all at bf16
    profile.update(step_gflop=flops / 1e9,
                   step_bound_ms=flops / BF16_FLOPS * 1e3)
    record["profile"] = profile
    if "top" in profile:
        print(f"profile: device busy {profile['device_busy_ms_per_step']:.2f}"
              f" of {profile['wall_ms_per_step_profiled']:.2f} ms/step "
              f"({profile['step_gflop']:.1f} GFLOP, bound "
              f"{profile['step_bound_ms']:.3f} ms), "
              "top: " + "; ".join(f"{r['ms_per_step']:.3f} ms {r['name'][:60]}"
                                  for r in profile["top"][:6]) + f" [{card}]",
              flush=True)

    for path, mode_step in (("tta", tta_step), ("multiscale", ms_step),
                            ("int8", qstep.active_step)):
        record[path]["profile"] = prof = profile_step(
            torch, mode_step, dev_images, dev_bounds, n=2)
        if "top" in prof:
            print(f"{path} profile: device busy "
                  f"{prof['device_busy_ms_per_step']:.2f} of "
                  f"{prof['wall_ms_per_step_profiled']:.2f} ms/step, idle "
                  f"share {prof['idle_share']:.3f}, top: " + "; ".join(
                      f"{r['ms_per_step']:.3f} ms {r['name'][:60]}"
                      for r in prof["top"][:8 if path == "int8" else 4])
                  + f" [{card}]", flush=True)
    # the same multiscale step, timed again now that the profiler has run
    _, after_ms = timed_steps(torch, ms_step, images, bounds, 5)
    record["multiscale"]["step_ms_host_input_after_profiler"] = after_ms
    print(f"multiscale after the profiler ran in this process: "
          f"{after_ms:.2f} ms/batch against "
          f"{record['multiscale']['step_ms_host_input']:.2f} before "
          f"[{card}]", flush=True)

    for entry in (kernel, clahe, epilogue):
        entry["launches"] = sum(p[entry["name"]] for p in launches.values())
        entry["launches_by_path"] = {path: p[entry["name"]]
                                     for path, p in launches.items()}
    record["kernels"] = [kernel, clahe, epilogue]
    finish(torch, record, name, "chip_smoke.json")


def finish(torch, record, name, filename) -> None:
    """The record to ``chiprun_out/<filename>``, then the kernel line and
    the result line."""
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", filename), "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps({"kernels": record["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
