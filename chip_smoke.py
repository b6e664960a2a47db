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
     D=128, the city scan's B=64, K=1024, D=256 and predict's B=16, K=512,
     D=128, and evaluate's B=8 and B=3, K=512, D=128; and two rows outside
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
     turns with their bf16 steps;
 11. the front ends, run last: the port's CLI as a user runs it, each verb
     a ``python -m aerial_image_recognition_tpu_torch`` child of this script
     on the card, against one FakeTileServer of phase 10b's world: (a)
     ``doctor`` names the card, the three kernels built and the native
     fastgeo helper; (b) ``detect`` over WMS JPEG (1280-px tiles of 320 m,
     resized to 640 on the card) of a 56-tile AOI: records equal to an
     in-process ``CarDetector`` of the same argv (bit-equal), recall@3m
     ≥ 0.95 of the world's cars, no pair within 2 m, tiles/s (host-bound);
     (c) ``detect --tta`` on 4 tiles launches the CLAHE kernel; (d)
     ``calibrate`` on a GeoTIFF of the world at 0.5 m/px, its absmax equal
     to the CPU's within rtol 1e-4, then ``detect --quantize int8
     --quantize-calib`` over (b)'s AOI matching (b) at ≥ 0.9 within 2 m;
     (e) ``geotiff`` on that raster (window 640, stride 480) at recall@3m
     ≥ 0.9, and at the verb's defaults (seeded yolov8_tokyo, window 1200,
     stride 600, batch 16) on a 5400-px raster (four full batches), timed
     per full window batch and split into extraction, upload, step and the
     rest; (f) ``predict`` on a
     48 m square rendered at four pixel sizes (PNG, JPEG, ragged) with
     ``--imgsz 96 --annotate``; (g) ``serve``: JPEG POSTs answered with
     class names, SIGINT ends it with exit 0; (h) ``sweep`` of two tile
     sizes with no entry in error; (i) ``SimpleDetector.run`` in this
     process over the fake XYZ server with the trained yolov8n (64 m
     windows at zoom 20, resized 699 → 640 on the card) at recall@3m ≥
     0.9. Each child writes its kernels' launch counters when it exits
     (``COUNTED_CHILD``); they go on the kernel line as that verb's path;
 12. segmentation, run after 11: XUnet-256 from the trained fixture
     ``xunet_fakeworld.npz`` at full width, 256 px, bf16 trunk, f32 head,
     batch 16, on held-out tiles of its training world (buildings, seed
     123): (a) f32 logits on the card against the CPU within 1e-3 of their
     largest magnitude, bf16 against f32 masks at IoU ≥ 0.99, ground-truth
     IoU ≥ 0.80; (b) int8: ``quantize_xunet`` on the card, the relu
     epilogue kernel bit-equal to its plain version on the trunk's own s32
     sums at all 21 int8 convs (and timed at the first), 21 launches a
     forward, int8 against f32 masks at IoU ≥ 0.99 and ground truth no
     worse than f32's less 0.005; (c) ``segment_geotiff`` and
     ``automask_geotiff`` (stride 192 < window) built on the card from the
     checkpoint over a 1024-px raster (16 windows), bf16 and int8: every
     building of ≥ 100 px recovered as an instance, instance count within
     0.7–1.5× + 2 of them, mask IoU ≥ 0.7 with the buildings, int8 mask
     IoU ≥ 0.99 with bf16; (d) a DetectionServer with both planes: 16 JPEG
     tiles (one of 320 px) POSTed to /segment at once, every mask equal to
     the server's segment function run in process on the same images,
     /detect answering beside it; (e) ``automask --quantize int8`` and
     ``serve --segment-params`` as counted children: the verb's GeoPackage
     equal to an in-process call's, the served mask equal to (d)'s, exit
     0 after SIGINT; (f) ms per batch of 16 (bf16, int8; host and device
     input), tiles/s, GFLOP a tile and the share of its bf16 bound, peak
     memory, a profile of each.
 13. training, run last (``pipeline/train.py``, f32, cuDNN's TF32 off in
     the trainer): (a) YOLOv7-tiny fine-tuned from the trained fixture at
     640 px, batch 16, frozen BN, ``freeze=[0,1,2]``, lr 1e-4, on 64
     rendered tiles at 0.5 m/px (a ``DetectionLoader`` with mosaic 0), two
     epochs, evaluated after each on 16 held-out tiles in batches of 8,
     the targets in the fixture's own box convention: one step on the
     card against the same step on the CPU (2 tiles; loss within rtol
     1e-4, every gradient leaf within ``TRAIN_GRAD_LIMIT`` of its largest
     magnitude), and the same card step with cuDNN's TF32 on as a control
     that this check must refuse; finite losses, mAP50 no worse than
     before less 0.02,
     frozen leaves bit-identical to the fixture's, one NMS launch an eval
     batch, one epoch to a checkpoint plus a resumed epoch against the two
     uninterrupted epochs (under ``torch.use_deterministic_algorithms``,
     warn only: bit-exactness recorded, held within 2·lr a step and 1 % of
     the elements beyond 1e-6); ms a step, images/s, the share of the f32
     bound (3 × the forward's FLOPs), peak memory; (b) YOLOv8l at the
     ``train`` verb's defaults (768 px, batch 8, batch BN), seeded weights
     rescaled to unit variance: 2 + 10 timed steps, ``recalibrate_bn`` for
     one pass, finite losses and statistics; one batch step of the trained
     yolov8n at 96 px, running statistics card vs CPU within 1e-4 of their
     largest magnitude; one remat step against the plain one (statistics
     equal, params within 2·lr); (c) XUnet from its trained fixture, 256
     px, batch 16, frozen BN, 8 steps with mask targets through
     ``fit(eval_fn=mask IoU)`` on 16 held-out tiles: finite, IoU no worse
     than before less 0.005; (d) the ``train`` verb (2 epochs, 16 of 24
     JPEG tiles of a COCO json) and ``val`` on its checkpoint as counted
     children: exit 0, their JSON, val's mAP50 equal to an in-process
     ``evaluate`` of the checkpoint, one NMS launch an eval batch in each.
 14. multi-GPU, run last (``multi_gpu``; every card's name and power limit
     are printed, and with two cards or more the links between them). Two
     meshes: ``make_mesh()``, every visible card, and two shards of
     cuda:0. On one card ``make_mesh()`` is one shard: (a)–(d) and (g) run
     over both meshes as on several cards, and each case that needs two
     cards or more prints one line saying it could not run, and why. On
     four cards every case runs on distinct cards. (a) the data-parallel
     detect step at phase 4's width over each mesh against the
     single-device step; NMS launches = shards × steps, ms and host syncs
     (none) a step; turnkey int8 under each mesh reaching ``int8``, 55
     epilogue launches a shard a step (53 trunk convs and the quad stem's
     two); with two cards or more the float and int8 steps against one card
     at the same global batch, 64 tiles and 64 a card; (b) the upload ring
     over one device's step and each mesh's (ms a batch), a
     ``CarDetector`` scan with ``data_parallel: true`` of
     10b's world bit-equal to one card's scan over the same shards (on one
     card the single-device scan) and, with several cards, matching the
     single-device scan as the two-shard scan must, tiles/s of each, and
     the two-shard step's raw records of 11b's AOI; (c) ``detect
     --data-parallel`` and ``serve --data-parallel`` (every card) as
     counted children against the same runs in this process; (d)
     ``halo_dedup_host`` over each mesh at ``k_slots`` 4096 on (b)'s raw
     records equal to ``dedup_host``, ms a shard; (e) a world of one on
     NCCL, then a world of every card on NCCL (a process a card; on one
     card two processes share it over gloo instead), 13a's fine-tune as a
     data-parallel train step: bit-equal across processes, within 2·lr a
     step of one process; with two cards or more a stripe scan on NCCL,
     each process scanning its stripe of 10b's AOI through
     ``CarDetector(tile_filter=...)``: tiles adding up to the single
     scan's, raw records bit-equal as a set, the merge equal to the single
     scan's dedup; (f) YOLOv8l's train step (768 px, batch 8, batch BN)
     over two shards of one card and, with two cards or more, over
     ``make_mesh()`` (also timed at 8 rows a card), against one device
     with f64 BN statistics, remat each; (g) spatial inference, the
     trunk's rows over each mesh and over four shards of cuda:0, against
     the unsharded detect function (int8 bit-equal).
     A gate of phase 14 that fails is printed at once; the phase fails at
     its end, so that one run on several cards reads every case.
 15. the quad stem, run after phase 8 (the default step of phases 4, 5, 8,
     10 and 14 is the quad stem already): (a) the default step against the
     same config with ``quad_stem: false`` at phase 4's shape, in turns
     (quad, plain, plain, quad), host input and the batch on the card (the
     quad step also on its packed batch), the device ms of the stem chain
     alone and the rest, detections at phase 4's gates (agreement, recall
     >= 0.8 each), the quad stem's P2 on the card against the CPU's (f32
     with TF32 off within 1e-5 of the largest magnitude, bf16 within one
     bf16 step of it); (b) the epilogue's border mode against its plain
     version at stem0's full shape (s32 [64·160·160, 128] from the trained
     fixture's fully-int8 stem0; leaky tolerance 0, silu within 1 LSB on
     <= 1e-4) and the CPU's, timed against its 0.313 ms bytes bound; the
     turnkey int8 of phase 8c goes through the fully-int8 stems: 55
     epilogue launches a step, one in border mode; (c) the host relayout
     of one 64-tile batch, native packer and numpy copies; (d) no kernel
     leaves the current device changed: with two cards each kernel
     launches on cuda:1 while cuda:0 is current; with one the script says
     the check was not possible.
 16. the last modules of the port, run after 15: (a) ``preprocess_batch``'s
     ``jax.image.resize`` lowering at B=64 on the scan's 1280 → 640 WMS
     tiles, SimpleDetector's 699 → 640 and the XYZ path's 1024-px tiles
     cropped to 864: bilinear, lanczos3 and cubic with ``matmul=False`` in
     f32 and bf16 outputs, and nearest, each on the card against the CPU on
     the batch's first 4 tiles (nearest tolerance 0, f32 within 4e-6 with
     TF32 off, bf16 within 1/128 and a mean below 1e-4) and timed beside the
     matrix path of its geometry; ``assemble_mosaic`` of 256-px tiles on a
     3×3 grid equal to the CPU's; (b) the trained YOLOv7-tiny step with
     ``resize_matmul: false`` on 64 1280-px tiles at 0.25 m/px against the
     same step with the matrix resize (matched ≥ 0.9 at IoU 0.5, recall ≥
     0.8 within 2 m), both timed; (c) multiscale [0.85, 1.0, 1.15] with
     ``resize_matmul: false`` against phase 7's step: every detection
     matched, bit-equality recorded, timed; (d) ``YOLOv7(s2d_stem=True)``
     with the trained stem embedded in its 12-channel kernel at phase 4's
     shape: against the plain-stem step (matched ≥ 0.9, recall ≥ 0.8), f32
     raw maps card vs CPU within 1e-3 of their largest (TF32 off), no quad
     stem, int8 refused with the reference's message and turnkey int8
     staying bf16, timed in turns with the quad and plain steps; (e) the
     packed XUnet-256 (trained fixture, B=16, phase 12's held-out tiles):
     bf16 masks against the standard forward's at IoU ≥ 0.99, f32 logits
     card vs CPU within 1e-3 of their largest (TF32 off), ms a batch of
     each and ``host_s2d``'s.
Launch counts are zeroed just before each path (4–5, 10a, 10b, 6, 7, 8c–d,
15a, 16b–d, 9a, 9b, 9c, 9d, 11i, 12a–e, 13a–c, 14a–b, 14g) and read just after
it, or read from the child that ran the path (11b–h, 12e, 13d, 14c);
every kernel of a path must have launched in its window. The steps are profiled after every timed step (YOLOv8l's at
the end of phase 9); the multiscale step is then timed once more, to show
whether a profile earlier in the process moves later timings.

Output: the card line, then a ``{"kernels": [...]}`` JSON line, then the
last line ``{"ok": true, "device": {...}}``. The full record also goes to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX.

``python3 chip_smoke.py --scan-only`` runs phases 1–2, the NMS kernel
against its plain version, the default step's two timings and phase 10
alone (record in ``chiprun_out/chip_smoke_scan.json``);
``python3 chip_smoke.py --front-ends-only`` runs phases 1–2, the NMS kernel
against its plain version and phase 11 (record in
``chiprun_out/chip_smoke_front_ends.json``);
``python3 chip_smoke.py --segment-only`` runs phases 1–2, the NMS and CLAHE
kernels against their plain versions and phase 12 (record in
``chiprun_out/chip_smoke_segment.json``);
``python3 chip_smoke.py --train-only`` runs phases 1–2, the NMS kernel
against its plain version (evaluate's B=8 and ragged B=3, K=512, D=128
among the cases) and phase 13 (record in
``chiprun_out/chip_smoke_train.json``, the verbs' logs under
``chiprun_out/training/``);
``python3 chip_smoke.py --parallel-only`` runs phases 1–2, the NMS and
int8 epilogue kernels against their plain versions and phase 14 (record in
``chiprun_out/chip_smoke_parallel.json``, scans and child logs under
``chiprun_out/multi_gpu/``);
``python3 chip_smoke.py --quad-only`` runs phases 1–2, the NMS and int8
epilogue kernels against their plain versions and phase 15, with a turnkey
int8 step on packed s2d2 batches for 15b (record in
``chiprun_out/chip_smoke_quad.json``);
``python3 chip_smoke.py --lowerings-only`` runs phases 1–3's kernel checks
(NMS, CLAHE) and phase 16 (record in
``chiprun_out/chip_smoke_lowerings.json``).
"""

import contextlib
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
    # predict's shape (phase 11f): 16 images a chunk, the default
    # pre_topk of 512 candidates, 128 slots, one class
    ("wide-k512-d128", "random", False, 16, 512, 128),
    # the trainer's evaluate (phase 13): eval batches of 8 and a ragged
    # tail, 512 candidates, 128 slots, class-aware
    ("eval-b8-k512-d128", "random", True, 8, 512, 128),
    ("eval-tail-b3-k512-d128", "random", True, 3, 512, 128),
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


def check_output(torch, label, out, b: int = B):
    """Shapes ([b, D]) and finiteness of a step's (Detections, lon, lat)."""
    det, lon, lat = out
    if tuple(det.boxes.shape) != (b, D, 4) or tuple(lon.shape) != (b, D):
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


def detection_deltas(out_a, out_b) -> dict:
    """How far two step outputs are apart, detection by detection: per
    tile, each valid detection of ``out_a`` matched to one of ``out_b``'s
    by greedy same-class IoU ≥ 0.5 in score order (``detection_sets_agree``'s
    matching). Returns the detections left unmatched on either side, the
    largest |Δscore| and the largest |Δ| of a box coordinate (px) over the
    matches."""
    import numpy as np
    det_a, det_b = out_a[0], out_b[0]
    va, vb = det_a.valid.cpu().numpy(), det_b.valid.cpu().numpy()
    ba, bb = det_a.boxes.cpu().numpy(), det_b.boxes.cpu().numpy()
    sa, sb = det_a.scores.cpu().numpy(), det_b.scores.cpu().numpy()
    ca, cb = det_a.classes.cpu().numpy(), det_b.classes.cpu().numpy()
    unmatched, d_score, d_box = 0, 0.0, 0.0
    for i in range(va.shape[0]):
        ia, ib = np.where(va[i])[0], np.where(vb[i])[0]
        used = np.zeros(len(ib), bool)
        for j in ia[np.argsort(-sa[i][ia], kind="stable")]:
            best, k_best = 0.5, -1
            for n, k in enumerate(ib):
                if used[n] or cb[i][k] != ca[i][j]:
                    continue
                iou = box_iou(ba[i][j], bb[i][k])
                if iou >= best:
                    best, k_best = iou, n
            if k_best < 0:
                unmatched += 1
                continue
            used[k_best] = True
            k = ib[k_best]
            d_score = max(d_score, abs(float(sa[i][j]) - float(sb[i][k])))
            d_box = max(d_box, float(np.abs(ba[i][j] - bb[i][k]).max()))
        unmatched += int((~used).sum())
    return {"unmatched": unmatched, "max_score_delta": d_score,
            "max_box_delta_px": d_box}


def box_iou(a, b) -> float:
    """IoU of two cxcywh boxes."""
    ix = max(0.0, min(a[0] + a[2] / 2, b[0] + b[2] / 2)
             - max(a[0] - a[2] / 2, b[0] - b[2] / 2))
    iy = max(0.0, min(a[1] + a[3] / 2, b[1] + b[3] / 2)
             - max(a[1] - a[3] / 2, b[1] - b[3] / 2))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return float(inter / max(union, 1e-9))


def held_to(deltas: dict, score: float, box: float) -> bool:
    """``detection_deltas`` within its limits: every detection matched."""
    return deltas["unmatched"] == 0 and deltas["max_score_delta"] <= score \
        and deltas["max_box_delta_px"] <= box


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
    return profile_calls(torch, lambda: step(images, bounds), n)


def profile_calls(torch, fn, n: int = 3):
    """Device time by kernel over n calls of fn() after one more
    (torch.profiler), and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
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
    """Multiply-adds ×2 of every conv and head matmul in one step call."""
    return forward_flops(torch, step.bundle.module,
                         lambda: step(images, bounds))


def forward_flops(torch, module, fn) -> float:
    """Multiply-adds ×2 of every conv and linear layer of ``module`` in
    fn(), counted from the shapes the layers see (forward hooks)."""
    total = [0.0]

    def conv(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
        total[0] += 2.0 * k * out.numel()

    def linear(m, inp, out):
        total[0] += 2.0 * m.in_features * out.numel()

    hooks = []
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def post_all(posts, what: str):
    """POST every (url, body) of ``posts`` at once; returns the (status,
    parsed JSON) replies in order, and fails if any request failed."""
    replies = [None] * len(posts)
    errors = []

    def one(k):
        try:
            url, body = posts[k]
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                replies[k] = (r.status, json.load(r))
        except Exception as e:          # reported below, never swallowed
            errors.append(f"request {k}: {e!r}")

    threads = [threading.Thread(target=one, args=(k,))
               for k in range(len(posts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    if errors or any(t.is_alive() for t in threads):
        fail(f"{what} requests failed: {errors or 'timed out'}")
    return replies


def post_jpegs(url, images, bounds, n):
    """POST n tiles as JPEG to /detect concurrently; returns the parsed
    replies."""
    from PIL import Image
    posts = []
    for k in range(n):
        buf = io.BytesIO()
        Image.fromarray(images[k]).save(buf, "JPEG", quality=95)
        w, s, e, no = (float(v) for v in bounds[k])
        posts.append((f"{url}/detect?west={w!r}&south={s!r}&east={e!r}"
                      f"&north={no!r}", buf.getvalue()))
    return post_all(posts, "/detect")


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
        # in the step's layout, as the ingest plane assembles them (the
        # quad stem's s2d2 for the default step)
        batches.append(TileBatch(np.arange(k * B, (k + 1) * B),
                                 step.pack_images(np.ascontiguousarray(imgs)),
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
    from aerial_image_recognition_tpu_torch.gio.geojson import read_geojson
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
    frame = aoi_frame(os.path.join(base, "aoi.geojson"), SCAN_AOI)
    world = FakeWorld(**SCAN_WORLD)
    srv = FakeTileServer(world)
    srv.start()
    kernel = nms_kernel.nms_suppress
    shapes = []

    def spy(boxes_t, scores, classes, **kw):
        shapes.append((tuple(boxes_t.shape), kw["max_det"]))
        return kernel(boxes_t, scores, classes, **kw)

    det = CarDetector(base, scan_config(
        srv.base_url, frame, checkpoint_interval=100,
        event_log=os.path.join(base, "events.jsonl")))
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


# ------------------------------------------------ 11. the front ends

FE_AOI = (20.988, 52.19, 21.012, 52.206)        # 56 tiles of 320 m (36 of 400)
FE_TTA_AOI = (20.995, 52.195, 21.0, 52.198)     # 4 tiles
FE_RASTER_PX = 1600                             # the GeoTIFF: 800 m at 0.5 m/px
FE_DEFAULTS_PX = 5400                           # 8 × 8 windows of 1200 px
FE_SIMPLE_ZOOM = 20                             # 64 m in 699 px: 0.092 m/px
FE_SIMPLE_AOI = (20.997, 52.1985, 21.001, 52.2005)
# recall floors of (e) and (i) within 3 m of the world's cars
FE_FLOORS = {"geotiff_recall_3m": 0.9, "simple_recall_3m": 0.9}
PORT = "aerial_image_recognition_tpu_torch"
# a child that runs the port's CLI as ``python -m`` runs it
# (runpy.run_module with alter_sys) and writes the kernels' launch
# counters to $CHIP_SMOKE_LAUNCHES when it exits, however it exits
COUNTED_CHILD = f"""
import atexit, json, os, runpy
from {PORT}.ops.clahe_kernel import apply_luts
from {PORT}.ops.int8_kernel import requantize
from {PORT}.ops.nms_kernel import nms_suppress


def dump():
    with open(os.environ["CHIP_SMOKE_LAUNCHES"], "w") as f:
        json.dump({{"nms_suppress": nms_suppress.launches,
                   "clahe_apply": apply_luts.launches,
                   "int8_epilogue": requantize.launches,
                   "int8_epilogue_border": requantize.border_launches}}, f)


atexit.register(dump)
runpy.run_module("{PORT}", run_name="__main__", alter_sys=True)
"""


def child_cmd(base, name, argv, counted=True):
    """(command, environment, launch-count file) of one CLI run as a
    child: ``python -m aerial_image_recognition_tpu_torch <argv>``, or,
    counted, the same through ``COUNTED_CHILD``."""
    counts = os.path.join(base, f"launches_{name}.json")
    if os.path.exists(counts):
        os.remove(counts)
    cmd = [sys.executable] + (["-c", COUNTED_CHILD] if counted
                              else ["-m", PORT]) + list(argv)
    return cmd, dict(os.environ, CHIP_SMOKE_LAUNCHES=counts), counts


def run_verb(base, name, argv, *, counted=True, ok=True, timeout=600):
    """Run one verb as a child of this script, from the repository root;
    its output goes to ``<base>/<name>.log``. Returns (completed process,
    wall seconds, the child's kernel launches or None). ``ok``: fail unless
    it exits 0."""
    cmd, env, counts = child_cmd(base, name, argv, counted)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    with open(os.path.join(base, f"{name}.log"), "w") as f:
        f.write(f"$ {' '.join(argv)}\n{proc.stdout}\n--- stderr ---\n"
                f"{proc.stderr}")
    if ok and proc.returncode != 0:
        fail(f"front end {name}: exit {proc.returncode}: "
             f"{proc.stderr.strip()[-1500:]}")
    launches = None
    if counted and os.path.exists(counts):
        with open(counts) as f:
            launches = json.load(f)
    return proc, wall, launches


def child_launches(launches, path, counts, needed):
    """Store a child's kernel launches as ``launches[path]``; fail if a
    kernel in ``needed`` never launched there."""
    launches[path] = counts or {}
    for k in needed:
        if not launches[path].get(k):
            fail(f"the child path {path} never launched {k}: {counts}")


def last_json(text: str, opener: str = "{"):
    """The JSON value that ends a verb's standard output (its last line,
    or for an indented list the text from the last line opening it)."""
    lines = text.rstrip().splitlines()
    for k in range(len(lines) - 1, -1, -1):
        if lines[k].startswith(opener):
            return json.loads("\n".join(lines[k:]))
    fail(f"no JSON result in {text[-500:]!r}")


def aoi_frame(path, aoi):
    from aerial_image_recognition_tpu_torch.gio.geojson import write_geojson
    w, s, e, n = aoi
    write_geojson({"type": "FeatureCollection", "features": [{
        "type": "Feature", "properties": {}, "geometry": {
            "type": "Polygon", "coordinates": [[[w, s], [e, s], [e, n],
                                                [w, n], [w, s]]]}}]}, path)
    return path


def scan_records(base, prefix="detections"):
    """(lon, lat, confidence) of a scan's results, sorted."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.gio.geojson import read_geojson
    doc = read_geojson(os.path.join(base, "output",
                                    f"{prefix}_results.geojson"))
    recs = sorted((f["geometry"]["coordinates"][0],
                   f["geometry"]["coordinates"][1],
                   f["properties"]["confidence"]) for f in doc["features"])
    return np.asarray(recs, np.float64).reshape(-1, 3), doc["metadata"]


def truth_recall(world, found, boxes, radius: float = 3.0,
                 margin_m: float = 5.0):
    """(recall of the world's cars inside any of ``boxes`` (w, s, e, n;
    less a margin) within ``radius`` m, precision of ``found`` [N,2]
    lon/lat against all cars, cars counted, pairs of found points within
    2 m)."""
    import numpy as np
    cars = world.cars[:, :2]
    margin = np.array([margin_m * M2LON, margin_m * M2LAT])
    inside = np.zeros(len(cars), bool)
    for w, s, e, n in boxes:
        inside |= ((cars > np.array([w, s]) + margin)
                   & (cars < np.array([e, n]) - margin)).all(1)
    w, s, e, n = boxes[0]
    lon0, lat0 = (w + e) / 2, (s + n) / 2

    def to_m(ll):
        return np.stack([(ll[:, 0] - lon0) / M2LON,
                         (ll[:, 1] - lat0) / M2LAT], axis=1)

    kept = to_m(np.asarray(found, np.float64).reshape(-1, 2))
    truth = to_m(cars[inside])
    rec = float(_nearest_within(truth, kept, radius).mean()) \
        if len(kept) else 0.0
    prec = float(_nearest_within(kept, to_m(cars), radius).mean()) \
        if len(kept) else 0.0
    return rec, prec, int(inside.sum()), len(_near_pairs(kept, 2.0))


def matched_within(a, b, metres: float):
    """Fraction of a's lon/lat points with one of b's within ``metres``."""
    import numpy as np
    if not len(a):
        return 0.0
    am = np.stack([a[:, 0] / M2LON, a[:, 1] / M2LAT], axis=1)
    bm = np.stack([b[:, 0] / M2LON, b[:, 1] / M2LAT], axis=1)
    return float(_nearest_within(am - am.mean(0), bm - am.mean(0),
                                 metres).mean())


def render_raster(world, path, side: int = FE_RASTER_PX, m_px: float = 0.5):
    """A GeoTIFF (EPSG:4326) of the world around its centre at ``m_px``."""
    from aerial_image_recognition_tpu_torch.gio.geotiff import write_geotiff
    half = side * m_px / 2
    c_lon, c_lat = SCAN_WORLD["center_lon"], SCAN_WORLD["center_lat"]
    bbox = (c_lon - half * M2LON, c_lat - half * M2LAT,
            c_lon + half * M2LON, c_lat + half * M2LAT)
    write_geotiff(path, world.render(bbox, side, side),
                  (bbox[0], m_px * M2LON, 0.0, bbox[3], 0.0, -m_px * M2LAT),
                  epsg=4326)
    return bbox


def front_ends(torch, record, card, launches, open_window, close_window):
    """11. The port's CLI as a user runs it, each verb a
    ``python -m aerial_image_recognition_tpu_torch`` child of this script
    (counted through ``COUNTED_CHILD``), on the card, at full width, against
    one FakeTileServer of the 10b world: (a) ``doctor``; (b) ``detect``
    over WMS JPEG (1280 px a 320 m tile, the config's default size: the
    step resizes to 640 on the card) of ``FE_AOI``, against an in-process
    ``CarDetector`` of the same config, the world's cars and the 2 m dedup
    radius; (c) ``detect --tta`` on 4 tiles; (d) ``calibrate`` on a GeoTIFF
    of the world at 0.5 m/px, its absmax against the CPU's on the same
    windows, then ``detect --quantize int8 --quantize-calib`` over (b)'s
    AOI against (b); (e) ``geotiff`` on that raster with the trained
    fixture (window 640, stride 480) against the world's cars, then at the
    verb's defaults (seeded yolov8_tokyo, window 1200, stride 600, batch
    16), timed per window batch in this process; (f) ``predict`` on ragged
    PNG/JPEG crops at the fixture's scale (imgsz 96) with ``--annotate``;
    (g) ``serve``: JPEG POSTs, SIGINT, exit 0; (h) ``sweep`` over two tile sizes; (i)
    ``SimpleDetector.run`` in this process over the fake XYZ server with
    the trained yolov8n (64 m windows at zoom 20 resized to its 0.1 m/px
    at 640 px). Each child's kernel launches go on its own path."""
    import shutil
    import numpy as np
    from aerial_image_recognition_tpu_torch.fetch.fake import (
        FakeTileServer, FakeWorld)
    from aerial_image_recognition_tpu_torch.gio.geojson import read_geojson
    from aerial_image_recognition_tpu_torch.gio.geotiff import read_geotiff
    from aerial_image_recognition_tpu_torch.models.int8 import (
        calibrate_absmax)
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline.cli import (
        _overrides, build_parser)
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    from aerial_image_recognition_tpu_torch.pipeline.rasters import (
        _extract, iter_windows)
    from aerial_image_recognition_tpu_torch.utils.native import native_paths
    base = os.path.join(ROOT, "chiprun_out", "front_ends")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    rec = record["front_ends"] = {"card": card}
    name = torch.cuda.get_device_name(0)

    def child_path(path, counts, needed):
        child_launches(launches, path, counts, needed)

    # (a) doctor, exactly as a user types it
    proc, wall, _ = run_verb(base, "doctor", ["doctor"], counted=False)
    doc = json.loads(proc.stdout)
    if not doc.get("devices") or doc["devices"][0] != name \
            or doc.get("kernels_built") != {k: True for k in (
                "nms_suppress", "clahe_apply", "int8_epilogue")} \
            or doc.get("native_fastgeo") is not True \
            or not doc.get("matmul_smoke_test", {}).get("ok"):
        fail(f"doctor: {doc}")
    rec["doctor"] = {"wall_s": wall, "report": doc}
    print(f"front ends (a) doctor: {doc['devices']}, torch "
          f"{doc['torch_version']}, CUDA {doc['cuda_version']}, "
          f"{doc.get('memory_total_gb')} GB, nvidia-smi "
          f"{doc.get('nvidia_smi')}, kernels built, native {doc['native']}, "
          f"{wall:.1f} s [{card}]", flush=True)

    world = FakeWorld(**SCAN_WORLD)
    srv = FakeTileServer(world)
    srv.start()
    try:
        wms = ["--wms-url", srv.base_url + "/wms", "--wms-layer", "fake"]
        frame = aoi_frame(os.path.join(base, "aoi.geojson"), FE_AOI)
        scan = ["--frame", frame, "--tile-size-meters", "320",
                "--tile-overlap", "0.25", "--params", FIXTURE,
                "--device-batch", str(B), "--batch-size", str(B),
                "--num-workers", "16", "--confidence-threshold", "0.4",
                "--duplicate-distance", "2.0"] + wms

        # (b) detect, and the same scan in this process
        b_dir = os.path.join(base, "detect")
        argv = ["detect", "--base-dir", b_dir, "--force-restart"] + scan
        proc, wall, counts = run_verb(base, "detect", argv)
        child_path("fe_detect", counts, ["nms_suppress"])
        out = last_json(proc.stdout)
        got, meta = scan_records(b_dir)
        for fname in ("detections_results.geojson",
                      "detections_results.shp", "detections_results.dbf",
                      "detections_coverage.geojson"):
            if not os.path.exists(os.path.join(b_dir, "output", fname)):
                fail(f"detect: {fname} not written")
        ns = build_parser().parse_args(argv)
        ref_dir = os.path.join(base, "detect_in_process")
        CarDetector(ref_dir, _overrides(ns)).detect(force_restart=True)
        want, _ = scan_records(ref_dir)
        if got.shape != want.shape or len(got) != out["detections"]:
            fail(f"detect: {got.shape} records against {want.shape} in "
                 f"process, {out['detections']} reported")
        d_geo = float(np.abs(got[:, :2] - want[:, :2]).max())
        d_conf = float(np.abs(got[:, 2] - want[:, 2]).max())
        # same code, argv, server and card in both: bit-equal, no tolerance
        if d_geo or d_conf:
            fail(f"detect vs in process: {d_geo:.2e} deg, {d_conf:.2e}")
        r3, p3, n_cars, dups = truth_recall(world, got[:, :2], [FE_AOI])
        if r3 < 0.95 or dups:
            fail(f"detect: recall@3m {r3:.3f} of {n_cars} cars, {dups} "
                 "pairs within 2 m")
        batches = meta["ingest_stats"]["batches"]
        if counts["nms_suppress"] != batches:
            fail(f"detect: {counts['nms_suppress']} NMS launches in "
                 f"{batches} batches")
        rec["detect"] = {
            "tiles": out["tiles"], "detections": len(got), "wall_s": wall,
            "scan_wall_s": meta["wall_clock_s"],
            "tiles_per_s": out["tiles"] / meta["wall_clock_s"],
            "recall_3m": r3, "precision_3m": p3, "cars_inside": n_cars,
            "max_abs_diff_deg_vs_in_process": d_geo,
            "max_abs_diff_conf_vs_in_process": d_conf,
            "phase_timings": meta["phase_timings"],
            "fetch_stats": meta["fetch_stats"], "native": native_paths(),
            "launches": counts, "bound": "host (the fake server renders "
            "and JPEG-encodes 1280-px tiles in Python)"}
        print(f"front ends (b) detect: {out['tiles']} WMS JPEG tiles of "
              f"1280 px (320 m, resized to 640 on the card) in "
              f"{meta['wall_clock_s']:.2f} s of scan, "
              f"{rec['detect']['tiles_per_s']:.1f} tiles/s (host-bound), "
              f"process {wall:.1f} s; {len(got)} records, bit-equal to the "
              f"in-process CarDetector; recall@3m {r3:.3f} of {n_cars} "
              f"cars, precision@3m {p3:.3f}, no pair within 2 m; launches "
              f"{counts}; native {native_paths()} [{card}]", flush=True)

        # (c) detect --tta on a few tiles
        c_dir = os.path.join(base, "tta")
        tta_frame = aoi_frame(os.path.join(base, "aoi_tta.geojson"),
                              FE_TTA_AOI)
        argv = ["detect", "--base-dir", c_dir, "--force-restart", "--tta"] \
            + scan[2:] + ["--frame", tta_frame]
        proc, wall, counts = run_verb(base, "tta", argv)
        child_path("fe_tta", counts, ["nms_suppress", "clahe_apply"])
        tta_out = last_json(proc.stdout)
        rec["tta"] = {"tiles": tta_out["tiles"],
                      "detections": tta_out["detections"], "wall_s": wall,
                      "launches": counts}
        print(f"front ends (c) detect --tta: {tta_out['tiles']} tiles, "
              f"{tta_out['detections']} records, launches {counts}, "
              f"process {wall:.1f} s [{card}]", flush=True)

        # (d) calibrate on a GeoTIFF of the world, card against CPU, then
        # detect with the calibration
        tif = os.path.join(base, "world.tif")
        raster_bbox = render_raster(world, tif)
        calib = os.path.join(base, "calib.json")
        proc, wall, counts = run_verb(
            base, "calibrate", ["calibrate", tif, "--params", FIXTURE,
                                "--window", "640", "--max-windows", "16",
                                "--out", calib])
        launches["fe_calibrate"] = counts
        with open(calib) as f:
            card_absmax = json.load(f)
        gt = read_geotiff(tif)
        corners = list(iter_windows(FE_RASTER_PX, FE_RASTER_PX, 640,
                                    640))[:16]
        batches = [np.stack([_extract(gt.data, r, c, 640)
                             for r, c in corners[i:i + 8]])
                   for i in range(0, len(corners), 8)]
        cpu_bundle = create_model(params_path=FIXTURE, dtype=torch.float32,
                                  device="cpu", fold_bn=True)
        cpu_absmax = calibrate_absmax(cpu_bundle, batches, model_size=640)
        del cpu_bundle
        if set(cpu_absmax) != set(card_absmax):
            fail("calibrate: the card's and the CPU's layers differ")
        rel = max(abs(card_absmax[k] - v) / max(abs(v), 1e-12)
                  for k, v in cpu_absmax.items())
        if rel > 1e-4:
            fail(f"calibrate: card against CPU rel {rel:.2e} (> 1e-4)")
        d_dir = os.path.join(base, "int8")
        argv = ["detect", "--base-dir", d_dir, "--force-restart",
                "--quantize", "int8", "--quantize-calib", calib] + scan
        proc, wall_q, counts_q = run_verb(base, "int8", argv)
        child_path("fe_int8", counts_q, ["nms_suppress", "int8_epilogue"])
        q_out = last_json(proc.stdout)
        q_recs, q_meta = scan_records(d_dir)
        m_q = matched_within(got[:, :2], q_recs[:, :2], 2.0)
        m_b = matched_within(q_recs[:, :2], got[:, :2], 2.0)
        q_batches = q_meta["ingest_stats"]["batches"]
        # the scan's tiles take the quad stem where they arrive at the
        # model's size: then one border-mode launch a batch, and the
        # fully-int8 stems' two epilogues beside the trunk's
        quad_batches = counts_q.get("int8_epilogue_border", 0)
        if min(m_q, m_b) < 0.9 or quad_batches not in (0, q_batches) \
                or counts_q["int8_epilogue"] != (
                    TRUNK_CONVS + (STEM_CONVS if quad_batches else 0)) \
                * q_batches:
            fail(f"int8 detect: {m_q:.3f} of (b)'s records within 2 m, "
                 f"{m_b:.3f} the other way; launches {counts_q} in "
                 f"{q_batches} batches")
        rec["calibrate"] = {"windows": len(corners), "layers": len(cpu_absmax),
                            "wall_s": wall,
                            "card_vs_cpu_max_rel": rel,
                            "tf32_during_calibration": False}
        rec["int8_detect"] = {
            "tiles": q_out["tiles"],
            "detections": len(q_recs), "scan_wall_s": q_meta["wall_clock_s"],
            "wall_s": wall_q, "matched_b_2m": m_q, "matched_from_b_2m": m_b,
            "launches": counts_q}
        print(f"front ends (d) calibrate: {len(corners)} windows of 640 px, "
              f"{len(cpu_absmax)} layers, card against CPU max rel "
              f"{rel:.2e} (TF32 off), {wall:.1f} s; detect --quantize int8 "
              f"--quantize-calib: {len(q_recs)} records, {m_q:.3f} of (b)'s "
              f"within 2 m ({m_b:.3f} the other way), scan "
              f"{q_meta['wall_clock_s']:.2f} s, launches {counts_q} "
              f"[{card}]", flush=True)

        # (e) geotiff with the trained fixture, then at the verb's defaults
        g_out = os.path.join(base, "geotiff.geojson")
        proc, wall, counts = run_verb(
            base, "geotiff", ["geotiff", tif, "--model", "yolov7_itcvd",
                              "--params", FIXTURE, "--window", "640",
                              "--stride", "480", "--out", g_out])
        child_path("fe_geotiff", counts, ["nms_suppress"])
        g_line = last_json(proc.stdout)
        g_doc = read_geojson(g_out)
        found = np.array([f["geometry"]["coordinates"]
                          for f in g_doc["features"]], np.float64)
        g_r3, g_p3, g_cars, g_dups = truth_recall(world, found,
                                                [raster_bbox])
        if g_line["detections"] != len(found) \
                or g_r3 < FE_FLOORS["geotiff_recall_3m"]:
            fail(f"geotiff: {g_line}, {len(found)} features, recall@3m "
                 f"{g_r3:.3f} of {g_cars} cars")
        rec["geotiff"] = {
            "windows": len(list(iter_windows(FE_RASTER_PX, FE_RASTER_PX,
                                             640, 480))),
            "detections": len(found), "recall_3m": g_r3,
            "precision_3m": g_p3, "cars_inside": g_cars,
            "pairs_within_2m": g_dups, "wall_s": wall, "launches": counts,
            "defaults": fe_geotiff_defaults(torch, world, base, card,
                                            child_path)}
        print(f"front ends (e) geotiff: {FE_RASTER_PX}-px raster at 0.5 "
              f"m/px, window 640 stride 480, {len(found)} records, "
              f"recall@3m {g_r3:.3f} of {g_cars} cars (floor "
              f"{FE_FLOORS['geotiff_recall_3m']}), precision@3m "
              f"{g_p3:.3f}, {g_dups} pairs within 2 m, {wall:.1f} s, "
              f"launches {counts} [{card}]", flush=True)

        # (f) predict on ragged crops at the fixture's scale
        rec["predict"] = fe_predict(world, base, card, child_path)

        # (g) serve
        rec["serve"] = fe_serve(world, base, card, child_path)

        # (h) sweep over two tile sizes of (b)'s AOI
        h_dir = os.path.join(base, "sweep")
        argv = ["sweep", "--base-dir", h_dir, "--tile-sizes", "320,400"] \
            + scan
        proc, wall, counts = run_verb(base, "sweep", argv)
        child_path("fe_sweep", counts, ["nms_suppress"])
        entries = last_json(proc.stdout, "[")
        if [e.get("tile_size_m") for e in entries] != [320.0, 400.0] \
                or any("error" in e for e in entries):
            fail(f"sweep: {entries}")
        rec["sweep"] = {"entries": entries, "wall_s": wall,
                        "launches": counts}
        print("front ends (h) sweep: " + "; ".join(
            f"{e['tile_size_m']:g} m: {e['tiles']} tiles, {e['detections']}"
            f" records, {e['wall_s']} s" for e in entries)
            + f"; no entry has an error; launches {counts} [{card}]",
            flush=True)

        # (i) SimpleDetector in this process, step built on the card
        rec["simple"] = fe_simple(torch, world, srv, base, card, open_window,
                                  close_window)
    finally:
        srv.stop()


def fe_geotiff_defaults(torch, world, base, card, child_path):
    """(e) at the verb's defaults (seeded yolov8_tokyo, window 1200, stride
    600, batch 16, the step resizing 1200 → 640 on the card) on a
    ``FE_DEFAULTS_PX`` raster of the world at 0.5 m/px: 64 windows, four
    full batches. The verb runs as a child; the same call is then timed in
    this process per full window batch and split, inside the timed calls,
    into the step as the call makes it (pinned upload, resize, forward,
    NMS; host wall to a synchronize) and the host's part (window
    extraction, readback, georeference, dedup) by difference. The parts
    are then timed alone on one batch, each to a synchronize: extraction,
    the upload, and the step with the batch already on the card (CUDA
    events)."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.gio.geotiff import read_geotiff
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        _upload, build_detect_step)
    from aerial_image_recognition_tpu_torch.pipeline.rasters import (
        _extract, detect_geotiff, iter_windows)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    window, stride, reps = 1200, 600, 5
    tif = os.path.join(base, "world_defaults.tif")
    render_raster(world, tif, side=FE_DEFAULTS_PX)
    proc, wall, counts = run_verb(
        base, "geotiff_defaults",
        ["geotiff", tif, "--out", os.path.join(base, "g_def.geojson")])
    child_path("fe_geotiff_defaults", counts, ["nms_suppress"])
    n_child = last_json(proc.stdout)["detections"]
    gt = read_geotiff(tif)
    step = build_detect_step(DetectorConfig(
        model_path="yolov8_tokyo", confidence_threshold=0.4),
        batch=16, src_size=window)
    corners = list(iter_windows(FE_DEFAULTS_PX, FE_DEFAULTS_PX, window,
                                stride))
    n_batch = len(corners) // step.batch
    if n_batch * step.batch != len(corners) \
            or counts["nms_suppress"] != n_batch:
        fail(f"geotiff defaults: {len(corners)} windows, {counts} launches "
             f"for batches of {step.batch}")

    def timed(fn, n=reps):
        """One warm-up call, then n calls each to a synchronize: (last
        output, ms a call)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / n * 1e3

    class StepTimer:
        """The step as detect_geotiff calls it, each call timed to a
        synchronize (the call reads the results back right after)."""

        def __init__(self, inner):
            self.inner, self.ms = inner, []

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def __call__(self, images, bounds):
            t0 = time.perf_counter()
            out = self.inner(images, bounds)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

    in_call = StepTimer(step)
    recs, call_ms = timed(lambda: detect_geotiff(
        gt, window=window, stride=stride, detect_step=in_call))
    if len(recs) != n_child:
        fail(f"geotiff defaults: {len(recs)} records in process, {n_child} "
             "from the verb")
    call_ms /= n_batch
    step_ms = sum(in_call.ms[n_batch:]) / (reps * n_batch)   # no warm-up
    host_ms = call_ms - step_ms

    def extract():                   # as detect_geotiff fills its batch
        imgs = np.zeros((step.batch, window, window, 3), np.uint8)
        for k, (r, c) in enumerate(corners[:step.batch]):
            imgs[k] = _extract(gt.data, r, c, window)
        return imgs

    imgs, extract_ms = timed(extract)
    bounds = np.tile(np.asarray([[0, 0, 1, 1]], np.float32), (step.batch, 1))
    _, upload_ms = timed(lambda: _upload(imgs, step.device, torch.uint8))
    dev_imgs = _upload(imgs, step.device, torch.uint8)
    dev_bounds = _upload(bounds, step.device, torch.float32)
    step(dev_imgs, dev_bounds)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        step(dev_imgs, dev_bounds)
    end.record()
    end.synchronize()
    device_ms = start.elapsed_time(end) / reps
    del step, in_call, dev_imgs
    print(f"front ends (e) geotiff at the defaults (yolov8_tokyo seeded, "
          f"window {window}, stride {stride}, batch 16): "
          f"{FE_DEFAULTS_PX}-px raster, {len(corners)} windows in {n_batch} "
          f"full batches, {n_child} records; {call_ms:.2f} ms a full window "
          f"batch = step {step_ms:.2f} as called + host {host_ms:.2f}; "
          f"alone: extraction {extract_ms:.2f}, upload {upload_ms:.2f}, "
          f"step with the batch on the card {device_ms:.2f}; verb "
          f"{wall:.1f} s, launches {counts} [{card}]", flush=True)
    return {"model": "yolov8_tokyo (seeded)", "raster_px": FE_DEFAULTS_PX,
            "window": window, "stride": stride, "batch": 16,
            "windows": len(corners), "full_batches": n_batch,
            "detections": n_child, "ms_per_window_batch": call_ms,
            "step_ms_in_call": step_ms, "host_ms_in_call": host_ms,
            "extract_ms_alone": extract_ms, "upload_ms_alone": upload_ms,
            "step_device_ms_alone": device_ms, "wall_s": wall,
            "launches": counts}


def fe_predict(world, base, card, child_path):
    """(f): one 48 m square of the world around a spot with several cars,
    rendered at 96 px as PNG and as JPEG, at 192 px as PNG and as a ragged
    150×110 JPEG — every one the fixture's 0.5 m/px once ``predict
    --imgsz 96 --annotate`` resizes it to 96 — and each image's boxes
    must land on the world's cars in its own pixels: recall ≥ 0.8 of the
    cars wholly inside within 4 px per 96 px of image edge, and ≥ 0.9 of
    the boxes on a car."""
    import numpy as np
    from PIL import Image
    cars = world.cars[:, :2]
    span = 48.0                                   # metres at 96 px
    for c_lon, c_lat in cars:
        d = np.abs(cars - (c_lon, c_lat)) / (M2LON, M2LAT)
        if int((d.max(1) < span / 2 - 4).sum()) >= 4:
            break
    bbox = (c_lon - span / 2 * M2LON, c_lat - span / 2 * M2LAT,
            c_lon + span / 2 * M2LON, c_lat + span / 2 * M2LAT)
    crops = []
    for fname, (w_px, h_px), fmt in (("a.png", (96, 96), "PNG"),
                                     ("b.jpg", (96, 96), "JPEG"),
                                     ("c.png", (192, 192), "PNG"),
                                     ("d.jpg", (150, 110), "JPEG")):
        path = os.path.join(base, fname)
        Image.fromarray(world.render(bbox, w_px, h_px)).save(
            path, fmt, **({"quality": 95} if fmt == "JPEG" else {}))
        crops.append((path, w_px, h_px))
    ann = os.path.join(base, "annotated")
    proc, wall, counts = run_verb(
        base, "predict", ["predict"] + [c[0] for c in crops]
        + ["--params", FIXTURE, "--imgsz", "96", "--confidence", "0.4",
           "--annotate", ann])
    child_path("fe_predict", counts, ["nms_suppress"])
    images = last_json(proc.stdout)["images"]
    per = []
    west, south, east, north = bbox
    for (path, w_px, h_px), img in zip(crops, images):
        px = (cars[:, 0] - west) / (east - west) * w_px
        py = (north - cars[:, 1]) / (north - south) * h_px
        mx, my = 2.5 / span * w_px, 2.5 / span * h_px   # half a car
        inside = (px > mx) & (px < w_px - mx) & (py > my) & (py < h_px - my)
        gt = np.stack([px, py], 1)
        boxes = np.array([d["box_xyxy"] for d in img["detections"]],
                         np.float64).reshape(-1, 4)
        centres = (boxes[:, :2] + boxes[:, 2:]) / 2
        tol = 4.0 * max(w_px, h_px) / 96
        r = float(_nearest_within(gt[inside], centres, tol).mean()) \
            if inside.any() else 1.0
        p = float(_nearest_within(centres, gt, tol).mean()) \
            if len(centres) else 0.0
        if (img["width"], img["height"]) != (w_px, h_px) or r < 0.8 \
                or p < 0.9 or not os.path.exists(
                    os.path.join(ann, os.path.basename(path))) \
                or {d["label"] for d in img["detections"]} - {"car"}:
            fail(f"predict {os.path.basename(path)}: {img['width']}x"
                 f"{img['height']}, recall {r:.3f} of {int(inside.sum())} "
                 f"cars, precision {p:.3f}, labels "
                 f"{[d['label'] for d in img['detections']][:5]}")
        per.append({"image": os.path.basename(path), "size": [w_px, h_px],
                    "detections": len(boxes), "cars_inside": int(
                        inside.sum()), "recall": r, "precision": p})
    print("front ends (f) predict: " + "; ".join(
        f"{q['image']} {q['size'][0]}x{q['size'][1]}: {q['detections']} "
        f"boxes, recall {q['recall']:.2f} of {q['cars_inside']} cars, "
        f"precision {q['precision']:.2f}" for q in per)
        + f"; annotated copies written; launches {counts}, {wall:.1f} s "
        f"[{card}]", flush=True)
    return {"images": per, "wall_s": wall, "launches": counts,
            "nms_shape": {"K": 512, "D": 128, "class_aware": False}}


def serve_child(base, name, argv, use):
    """Start ``serve`` (``argv``) as a counted child of this script, wait
    for its address line, call ``use(line)``, then end it with SIGINT.
    Returns (address line, use's result, exit code, the child's kernel
    launches); its stderr goes to ``<base>/<name>.log``."""
    import select
    import signal
    cmd, env, counts_file = child_cmd(base, name, argv)
    err = open(os.path.join(base, f"{name}.log"), "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 300)
        if not ready:
            fail(f"{name}: no address line within 300 s")
        line = json.loads(proc.stdout.readline())
        result = use(line)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    with open(counts_file) as f:
        return line, result, rc, json.load(f)


def fe_serve(world, base, card, child_path):
    """(g): ``serve`` as a child: its address line, JPEG tiles POSTed
    (records with class names), SIGINT, exit 0 (``serve --data-parallel``
    is phase 14c)."""
    import numpy as np
    n = 8
    images, bounds = [], []
    for k in range(n):
        c_lon = SCAN_WORLD["center_lon"] + (k - n / 2) * 330 * M2LON
        c_lat = SCAN_WORLD["center_lat"]
        bbox = (c_lon - 160 * M2LON, c_lat - 160 * M2LAT,
                c_lon + 160 * M2LON, c_lat + 160 * M2LAT)
        images.append(world.render(bbox, SIZE, SIZE))
        bounds.append(bbox)

    def use(line):
        t0 = time.perf_counter()
        replies = post_jpegs(line["serving"], images, np.asarray(bounds), n)
        return replies, time.perf_counter() - t0

    line, (replies, post_s), rc, counts = serve_child(
        base, "serve", ["serve", "--port", "0", "--params", FIXTURE,
                        "--batch", "8", "--max-wait-ms", "20"], use)
    child_path("fe_serve", counts, ["nms_suppress"])
    for k, (status, body) in enumerate(replies):
        if status != 200 or body["count"] != len(body["detections"]) \
                or body["count"] == 0 \
                or {d["class"] for d in body["detections"]} != {"car"}:
            fail(f"serve request {k}: {status} {str(body)[:300]}")
    if rc != 0:
        fail(f"serve: exit {rc} after SIGINT")
    counts_seen = [body["count"] for _, body in replies]
    print(f"front ends (g) serve: {line}, {n} JPEG POSTs answered in "
          f"{post_s:.2f} s with {sum(counts_seen)} records (class 'car'), "
          f"SIGINT → exit 0, launches {counts} [{card}]", flush=True)
    return {"address": line, "requests": n, "counts": counts_seen,
            "post_s": post_s, "exit_after_sigint": rc, "launches": counts}


def fe_simple(torch, world, srv, base, card, open_window, close_window):
    """(i): ``SimpleDetector.run`` in this process over the fake XYZ server
    at zoom 20 (a 64 m window is 699 px there), with the trained yolov8n,
    whose 640-px input then sees its training scale (0.1 m/px): the step is
    built by the detector itself, on the card, resizing 699 → 640 there.
    The reference's facade takes no weights file, so they go in through
    its config. Recall within 3 m of the world's cars inside the windows
    it scanned (its coverage layer), at the floor ``FE_FLOORS``."""
    import dataclasses
    import numpy as np
    from aerial_image_recognition_tpu_torch.fetch.xyz import XYZFetcher
    from aerial_image_recognition_tpu_torch.gio.geojson import read_geojson
    from aerial_image_recognition_tpu_torch.pipeline.simple import (
        SimpleDetector)
    out_dir = os.path.join(base, "simple")
    frame = aoi_frame(os.path.join(base, "aoi_simple.geojson"),
                      FE_SIMPLE_AOI)
    det = SimpleDetector(
        "yolov8n", out_dir, xyz_url=srv.xyz_template, zoom=FE_SIMPLE_ZOOM,
        num_workers=16, fetcher=XYZFetcher(srv.xyz_template,
                                           zoom=FE_SIMPLE_ZOOM,
                                           num_workers=16, subdomains=("",)))
    det.config = dataclasses.replace(det.config, params_path=V8_FIXTURE)
    open_window()
    t0 = time.perf_counter()
    try:
        out = det.run(frame, spacing_meters=60.0, batch_size=B,
                      force_restart=True)
        torch.cuda.synchronize()
    finally:
        det.close()
    wall = time.perf_counter() - t0
    close_window("fe_simple", ["nms_suppress"])
    step = det._step
    doc = read_geojson(out["output"])
    found = np.array([f["geometry"]["coordinates"] for f in doc["features"]],
                     np.float64)
    cov = read_geojson(os.path.join(out_dir, "simple_coverage.geojson"))
    windows = []
    for f in cov["features"]:
        ring = np.asarray(f["geometry"]["coordinates"][0])
        windows.append((*ring.min(0), *ring.max(0)))
    r3, p3, n_cars, _ = truth_recall(world, found, windows)
    if step.device.type != "cuda" or step.model_size != 640 \
            or r3 < FE_FLOORS["simple_recall_3m"]:
        fail(f"SimpleDetector: step on {step.device} at "
             f"{step.input_size}→{step.model_size}, recall@3m {r3:.3f} of "
             f"{n_cars} cars, {len(found)} records")
    print(f"front ends (i) SimpleDetector.run: {out['points']} points, "
          f"windows of {step.input_size} px (64 m, zoom {FE_SIMPLE_ZOOM}) "
          f"resized to {step.model_size} on the card, trained yolov8n; "
          f"{out['detections']} records, recall@3m {r3:.3f} of {n_cars} "
          f"cars (floor {FE_FLOORS['simple_recall_3m']}), precision@3m "
          f"{p3:.3f}, {wall:.2f} s [{card}]", flush=True)
    return {"points": out["points"], "window_px": step.input_size,
            "detections": out["detections"], "recall_3m": r3,
            "precision_3m": p3, "cars_inside": n_cars, "wall_s": wall}


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


# ------------------------------------------------ 12. segmentation

XUNET_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "xunet_fakeworld.npz")
# the buildings' training world (examples/train_xunet_fakeworld.py)
SEG_WORLD = dict(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                 n_cars=150, n_buildings=120, seed=4)
SEG_B, SEG_SIZE, SEG_TILE_M = 16, 256, 64.0     # the server's segment batch
SEG_RASTER_PX = 1024                            # 4 × 4 windows at 0.25 m/px
XUNET_INT8_CONVS = 21


def seg_tiles(world, n: int, seed: int, size: int = SEG_SIZE):
    """n tiles of 64 m at random places of the world (the training run's
    generator; seed 123 is held out) and their building masks."""
    import numpy as np
    rng = np.random.default_rng(seed)
    half_lon, half_lat = SEG_TILE_M / 2 * M2LON, SEG_TILE_M / 2 * M2LAT
    span = world.extent_deg / 2
    tiles, masks, boxes = [], [], []
    for _ in range(n):
        clon = world.center_lon + (rng.random() - 0.5) * 2 * (span - half_lon)
        clat = world.center_lat + (rng.random() - 0.5) * 2 * (span - half_lat)
        bbox = (clon - half_lon, clat - half_lat, clon + half_lon,
                clat + half_lat)
        tiles.append(world.render(bbox, size, size))
        masks.append(world.render_mask(bbox, size, size) > 0)
        boxes.append(bbox)
    return np.stack(tiles), np.stack(masks), boxes


def iou(a, b) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


def building_recall(world_mask, instances, shape, min_px: int = 100):
    """(components of the ground truth with >= min_px pixels, the share of
    them that some instance's mask overlaps)."""
    import numpy as np
    from scipy import ndimage as ndi
    ids = np.zeros(shape, bool)
    for inst in instances:
        ids[inst["mask_slice"]] |= inst["mask"]
    labels, n = ndi.label(world_mask)
    comps = [i for i in range(1, n + 1) if (labels == i).sum() >= min_px]
    hit = sum(1 for i in comps if (ids & (labels == i)).any())
    return len(comps), hit / max(len(comps), 1)


def segmentation(torch, record, card, launches, open_window, close_window,
                 images, bounds):
    """12. Segmentation on the card: XUnet-256 from the trained fixture at
    full width, 256 px, bf16 trunk, f32 head, batch 16, on held-out tiles
    of its training world. (a) f32 logits card vs CPU, bf16 vs f32 masks,
    ground-truth IoU; (b) int8: ``quantize_xunet`` on the card, the relu
    epilogue kernel against its plain version on the trunk's own s32 sums,
    int8 vs f32 masks and ground truth; (c) ``segment_geotiff`` and
    ``automask_geotiff`` on a 1024-px raster (4 × 4 windows), bf16 and
    int8, stride < window for automask; (d) the DetectionServer with both
    planes: 16 JPEG tiles (one of 320 px) POSTed to /segment at once, each
    mask equal to the in-process segment function's, /detect answering;
    (e) the ``automask`` verb (int8) and ``serve --segment-params`` as
    counted children; (f) times. Returns the epilogue's relu timing at the
    trunk's first conv."""
    import base64
    import shutil
    import numpy as np
    from PIL import Image
    from aerial_image_recognition_tpu_torch.fetch.fake import FakeWorld
    from aerial_image_recognition_tpu_torch.gio.geopackage import read_gpkg
    from aerial_image_recognition_tpu_torch.gio.geotiff import (
        read_geotiff, write_geotiff)
    from aerial_image_recognition_tpu_torch.models.int8 import (
        QT, _Run, conv_s32, quantize_xunet)
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        _requantize_plain, requantize)
    from aerial_image_recognition_tpu_torch.pipeline.automask import (
        automask_geotiff)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        make_segment_fn)
    from aerial_image_recognition_tpu_torch.pipeline.rasters import (
        segment_geotiff)
    from aerial_image_recognition_tpu_torch.pipeline.serve import (
        DetectionServer)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    if not os.path.exists(XUNET_FIXTURE):
        fail(f"trained fixture missing: {XUNET_FIXTURE}")
    base = os.path.join(ROOT, "chiprun_out", "segmentation")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    rec = record["segmentation"] = {"card": card, "batch": SEG_B,
                                    "size": SEG_SIZE}
    world = FakeWorld(**SEG_WORLD)
    tiles, gt, _ = seg_tiles(world, SEG_B, seed=123)
    cfg = DetectorConfig(model_family="xunet")
    cfg32 = DetectorConfig(model_family="xunet", dtype="float32")

    # (a) f32 on the card against the CPU, bf16 against f32, ground truth
    torch.backends.cudnn.allow_tf32 = False      # the f32 reference is f32
    f32 = create_model("xunet_256", dtype=torch.float32,
                       params_path=XUNET_FIXTURE, fold_bn=True)
    f32_cpu = create_model("xunet_256", dtype=torch.float32,
                           params_path=XUNET_FIXTURE, fold_bn=True,
                           device="cpu")
    x2 = torch.from_numpy(tiles[:2]).permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        l_card = f32.forward(x2.cuda()).cpu().numpy()
        l_cpu = f32_cpu.forward(x2).numpy()
    rel = float(np.abs(l_card - l_cpu).max() / np.abs(l_cpu).max())
    if rel > 1e-3 or l_card.shape != (2, SEG_SIZE, SEG_SIZE, 1):
        fail(f"segmentation f32 logits, card vs CPU: max error {rel:.2e} "
             f"of the largest magnitude, shape {l_card.shape}")
    p32 = make_segment_fn(f32, cfg32)(tiles).cpu().numpy()[..., 0]
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default again
    del f32, f32_cpu
    bundle = create_model("xunet_256", dtype=torch.bfloat16,
                          params_path=XUNET_FIXTURE, fold_bn=True)
    seg = make_segment_fn(bundle, cfg)
    open_window()
    probs = seg(tiles)
    if probs.dtype != torch.float32 or tuple(probs.shape) != (
            SEG_B, SEG_SIZE, SEG_SIZE, 1) or not torch.isfinite(probs).all():
        fail(f"segment fn: {probs.dtype} {tuple(probs.shape)}")
    p16 = probs.cpu().numpy()[..., 0]
    m16, m32 = p16 >= 0.5, p32 >= 0.5
    a = {"logits_card_vs_cpu_rel": rel, "bf16_vs_f32_iou": iou(m16, m32),
         "gt_iou_bf16": iou(m16, gt), "gt_iou_f32": iou(m32, gt),
         "gt_coverage": float(gt.mean())}
    if a["bf16_vs_f32_iou"] < 0.99 or a["gt_iou_bf16"] < 0.80:
        fail(f"segmentation (a): {a}")
    dev_tiles = torch.from_numpy(tiles).cuda()
    torch.cuda.reset_peak_memory_stats()
    t = {"bf16_ms_host_input": cuda_ms(lambda: seg(tiles), 10),
         "bf16_ms_device_input": cuda_ms(lambda: seg(dev_tiles), 20)}
    t["bf16_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    close_window("seg_bf16", [])
    x = dev_tiles.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
    flops = forward_flops(torch, bundle.module, lambda: bundle.forward(x))
    t.update(gflop_per_tile=flops / SEG_B / 1e9,
             bound_ms=flops / BF16_FLOPS * 1e3)
    t["bound_share_bf16"] = t["bound_ms"] / t["bf16_ms_device_input"]
    rec["a"] = a
    print(f"segmentation (a): f32 logits card vs CPU within {rel:.2e} of "
          f"the largest; bf16 vs f32 masks IoU {a['bf16_vs_f32_iou']:.4f}; "
          f"ground truth IoU bf16 {a['gt_iou_bf16']:.4f}, f32 "
          f"{a['gt_iou_f32']:.4f} on {SEG_B} held-out tiles [{card}]",
          flush=True)

    # (b) int8: the relu epilogue on the trunk's own sums first (outside
    # any path window), then the quantized path
    calib = [tiles[i:i + 8] for i in range(0, SEG_B, 8)]
    qb = quantize_xunet(bundle, calib)
    checked = []

    class CheckRun(_Run):
        def conv(self, name, xq, kernel, stride=1):
            parts = xq if isinstance(xq, list) else [xq]
            v = parts[0].v if len(parts) == 1 \
                else torch.cat([p.v for p in parts], dim=-1)
            qp = self.q[name]
            r = conv_s32(v, qp["w"], kernel, stride)
            got = requantize(r, qp["m"], qp["b"], None, "relu")
            plain = _requantize_plain(r, qp["m"], qp["b"], None, "relu")
            if not torch.equal(got, plain):
                fail(f"int8 epilogue (relu) on {name}'s sums: "
                     f"{int((got != plain).sum())} codes differ from plain")
            checked.append((name, tuple(r.shape)))
            return QT(got, self.scales.get(name, 0.0), got.shape[-1])

    xq = dev_tiles[:2].permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
    with torch.inference_mode():
        qb.trunk_codes(qb.entry_codes(xq),
                       g=CheckRun(qb.q["convs"], act="relu",
                                  scales=qb.static_scales))
    if len(checked) != XUNET_INT8_CONVS:
        fail(f"int8 epilogue check ran on {len(checked)} convs")
    # the epilogue alone at the trunk's first conv (enc0/cv2), batch 16
    with torch.inference_mode():
        xi = qb.entry_codes(x)
        qp = qb.q["convs"]["enc0/cv2"]
        r = conv_s32(xi, qp["w"], 3, 1)
    n, cols = r.numel(), r.shape[-1]
    relu = {"shape": [n // cols, cols],
            "ms": cuda_ms(lambda: requantize(r, qp["m"], qp["b"], None,
                                             "relu"), 50),
            "plain_ms": cuda_ms(lambda: _requantize_plain(
                r, qp["m"], qp["b"], None, "relu"), 5, warmup=1)}
    nbytes = n * 5 + 2 * cols * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, n * 6 / F32_FLOPS * 1e3
    relu.update(bound_ms=max(t_bytes, t_ops), max_abs_err=0,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    del r
    qseg = make_segment_fn(qb, cfg)
    torch.cuda.reset_peak_memory_stats()
    open_window()
    qprobs = qseg(tiles).cpu().numpy()[..., 0]
    t["int8_ms_host_input"] = cuda_ms(lambda: qseg(tiles), 5)
    t["int8_ms_device_input"] = cuda_ms(lambda: qseg(dev_tiles), 10)
    t["int8_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t["bf16_ms_device_input_between"] = cuda_ms(lambda: seg(dev_tiles), 10)
    t["int8_ms_device_input_second"] = cuda_ms(lambda: qseg(dev_tiles), 10)
    close_window("seg_int8", ["int8_epilogue"])
    forwards = 1 + 3 + 5 + 3 + 10 + 3 + 10       # warm-ups included
    if launches["seg_int8"]["int8_epilogue"] != XUNET_INT8_CONVS * forwards:
        fail(f"int8 segmentation: {launches['seg_int8']} launches in "
             f"{forwards} forwards")
    mq = qprobs >= 0.5
    b = {"int8_vs_f32_iou": iou(mq, m32), "gt_iou_int8": iou(mq, gt),
         "gt_iou_f32": a["gt_iou_f32"], "epilogue_checked_convs": checked,
         "epilogue_relu": relu}
    if b["int8_vs_f32_iou"] < 0.99 or b["gt_iou_int8"] < a["gt_iou_f32"] \
            - 0.005:
        fail(f"segmentation (b): {b}")
    rec["b"] = b
    print(f"segmentation (b): relu epilogue equal to plain on the trunk's "
          f"own sums at all {len(checked)} int8 convs; {relu['ms']:.4f} ms "
          f"at {relu['shape']} (plain {relu['plain_ms']:.3f}, bound "
          f"{relu['bound_ms']:.4f}); int8 vs f32 masks IoU "
          f"{b['int8_vs_f32_iou']:.4f}, ground truth int8 "
          f"{b['gt_iou_int8']:.4f} against f32 {b['gt_iou_f32']:.4f} "
          f"[{card}]", flush=True)

    # (c) the raster workflows, built on the card from the checkpoint
    half = SEG_RASTER_PX * 0.125
    bbox = (SEG_WORLD["center_lon"] - half * M2LON,
            SEG_WORLD["center_lat"] - half * M2LAT,
            SEG_WORLD["center_lon"] + half * M2LON,
            SEG_WORLD["center_lat"] + half * M2LAT)
    tif = os.path.join(base, "buildings.tif")
    write_geotiff(tif, world.render(bbox, SEG_RASTER_PX, SEG_RASTER_PX),
                  (bbox[0], 0.25 * M2LON, 0.0, bbox[3], 0.0, -0.25 * M2LAT),
                  4326)
    truth = world.render_mask(bbox, SEG_RASTER_PX, SEG_RASTER_PX) > 0
    shape = truth.shape
    c = {}
    open_window()
    t0 = time.perf_counter()
    mask = segment_geotiff(tif, params=XUNET_FIXTURE,
                           output_mask=os.path.join(base, "mask.tif"),
                           output_polygons=os.path.join(base, "mask.geojson"))
    c["segment_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inst = automask_geotiff(tif, params=XUNET_FIXTURE, stride=192,
                            min_area_px=100)
    c["automask_stride192_s"] = time.perf_counter() - t0
    close_window("seg_rasters", [])
    open_window()
    mask_q = segment_geotiff(tif, params=XUNET_FIXTURE, quantize="int8")
    inst_q = automask_geotiff(tif, params=XUNET_FIXTURE, quantize="int8",
                              stride=192, min_area_px=100)
    close_window("seg_rasters_int8", ["int8_epilogue"])
    n_gt, hit = building_recall(truth, inst, shape)
    _, hit_q = building_recall(truth, inst_q, shape)
    c.update(mask_gt_iou=iou(mask > 0, truth),
             mask_int8_vs_bf16_iou=iou(mask_q > 0, mask > 0),
             buildings=n_gt, instances=len(inst), instances_int8=len(inst_q),
             buildings_recovered=hit, buildings_recovered_int8=hit_q,
             mask_file_equal=bool(np.array_equal(
                 read_geotiff(os.path.join(base, "mask.tif")).data
                 .reshape(shape) > 0, mask > 0)))
    if n_gt < 5 or min(hit, hit_q) < 1.0 or c["mask_gt_iou"] < 0.7 \
            or not 0.7 * n_gt <= len(inst) <= 1.5 * n_gt + 2 \
            or c["mask_int8_vs_bf16_iou"] < 0.99 or not c["mask_file_equal"]:
        fail(f"segmentation (c): {c}")
    rec["c"] = c
    print(f"segmentation (c): {SEG_RASTER_PX}-px raster, 16 windows: mask "
          f"IoU {c['mask_gt_iou']:.4f} with the buildings ({c['segment_s']:.2f}"
          f" s, built on the card); automask at stride 192 recovers "
          f"{hit:.0%} of {n_gt} buildings with {len(inst)} instances "
          f"(int8: {hit_q:.0%}, {len(inst_q)}), int8 mask IoU "
          f"{c['mask_int8_vs_bf16_iou']:.4f} with bf16 [{card}]", flush=True)

    # (d) the server with both planes: 16 tiles at once, one of 320 px
    from aerial_image_recognition_tpu_torch.gio.decode import decode_rgb
    bodies = []
    for k in range(SEG_B):
        img = tiles[k] if k else np.asarray(Image.fromarray(tiles[k]).resize(
            (320, 320), Image.BILINEAR))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=95)
        bodies.append(buf.getvalue())
    open_window()
    srv = DetectionServer({"params_path": FIXTURE, "device_batch": 8},
                          segment_params=XUNET_FIXTURE,
                          segment_batch=SEG_B, max_wait_ms=50.0).start()
    try:
        t0 = time.perf_counter()
        replies = post_all([(f"{srv.url}/segment?threshold=0.5&polygons=1",
                             body) for body in bodies], "/segment")
        post_s = time.perf_counter() - t0
        det_replies = post_jpegs(srv.url, images[:4], bounds[:4], 4)
        with urllib.request.urlopen(srv.url + "/stats", timeout=60) as r:
            stats = json.load(r)
        with urllib.request.urlopen(srv.url + "/healthz", timeout=60) as r:
            health = json.load(r)
        # the in-process reference: the server's own segment function on
        # the same decoded, resized images, in one batch of 16
        dec = []
        for body in bodies:
            im = decode_rgb(body)
            if im.shape[:2] != (SEG_SIZE, SEG_SIZE):
                im = np.asarray(Image.fromarray(im).resize(
                    (SEG_SIZE, SEG_SIZE), Image.BILINEAR))
            dec.append(im)
        ref = srv._seg_fn(np.stack(dec)).cpu().numpy()[..., 0]
    finally:
        srv.stop()
    close_window("seg_server", ["nms_suppress"])
    differ = 0
    for k, (status, body) in enumerate(replies):
        if status != 200:
            fail(f"segment request {k}: {status} {str(body)[:300]}")
        got = np.asarray(Image.open(io.BytesIO(
            base64.b64decode(body["mask_png"])))) > 127
        prob = ref[k]
        if k == 0:
            prob = np.asarray(Image.fromarray(prob).resize(
                (320, 320), Image.BILINEAR), np.float32)
        differ += int((got != (prob >= 0.5)).sum())
        if body["shape"] != list(prob.shape) or "polygons" not in body:
            fail(f"segment reply {k}: {str(body)[:300]}")
    if differ or stats["segment_requests"] != SEG_B or not health["segment"]:
        fail(f"segmentation (d): {differ} mask pixels differ from the "
             f"in-process function; stats {stats}")
    for k, (status, body) in enumerate(det_replies):
        if status != 200 or body["count"] != len(body["detections"]):
            fail(f"detect beside segment, request {k}: {status} {body}")
    rec["d"] = {"requests": SEG_B, "post_s": post_s,
                "segment_batches": stats["planes"]["segment"]["batches"],
                "detect_requests": len(det_replies), "stats": stats}
    print(f"segmentation (d): {SEG_B} JPEG /segment requests (one 320 px) "
          f"answered in {post_s:.2f} s, {rec['d']['segment_batches']} "
          f"batches, every mask equal to the in-process function's; /detect "
          f"answered beside it [{card}]", flush=True)

    # (e) the CLI: automask (int8) and serve --segment-params, children
    def child_path(path, counts, needed):
        child_launches(launches, path, counts, needed)

    gpkg = os.path.join(base, "verb.gpkg")
    proc, wall, counts = run_verb(
        base, "automask", ["automask", tif, "--params", XUNET_FIXTURE,
                           "--quantize", "int8", "--stride", "192",
                           "--min-area", "100", "--out-polygons", gpkg,
                           "--out-mask", os.path.join(base, "verb.tif")])
    child_path("fe_automask", counts, ["int8_epilogue"])
    n_verb = last_json(proc.stdout)["instances"]
    lib = os.path.join(base, "lib.gpkg")
    open_window()
    inst_lib = automask_geotiff(tif, params=XUNET_FIXTURE, quantize="int8",
                                stride=192, min_area_px=100,
                                output_polygons=lib)
    close_window("seg_automask_in_process", ["int8_epilogue"])
    same = read_gpkg(gpkg) == read_gpkg(lib)
    if n_verb != len(inst_lib) or not same:
        fail(f"automask verb: {n_verb} instances, in process "
             f"{len(inst_lib)}, GeoPackages equal: {same}")
    e = {"automask_wall_s": wall, "automask_instances": n_verb,
         "automask_gpkg_equal_in_process": same,
         "automask_launches": counts}
    t0 = time.perf_counter()
    _, ((status, body),), rc, serve_counts = serve_child(
        base, "serve_segment",
        ["serve", "--port", "0", "--params", FIXTURE, "--batch", "8",
         "--segment-params", XUNET_FIXTURE, "--segment-batch", "16",
         "--max-wait-ms", "20"],
        lambda line: post_all([(line["serving"] + "/segment", bodies[1])],
                              "serve --segment-params /segment"))
    child_path("fe_serve_segment", serve_counts, ["nms_suppress"])
    got = np.asarray(Image.open(io.BytesIO(
        base64.b64decode(body["mask_png"])))) > 127
    if status != 200 or rc != 0 or not np.array_equal(got, ref[1] >= 0.5):
        fail(f"serve --segment-params: exit {rc}, mask differs from the "
             f"in-process function's on {int((got != (ref[1] >= 0.5)).sum())}"
             " pixels")
    e.update(serve_wall_s=time.perf_counter() - t0, serve_exit=rc,
             serve_launches=serve_counts)
    rec["e"] = e
    print(f"segmentation (e): automask --quantize int8 → {n_verb} "
          f"instances, GeoPackage equal to the in-process call's, "
          f"{wall:.1f} s, launches {counts}; serve --segment-params answered "
          f"/segment with the in-process mask and exited 0 after SIGINT "
          f"[{card}]", flush=True)

    # (f) times, and where the device time goes
    t["tiles_per_s_bf16"] = SEG_B / t["bf16_ms_device_input"] * 1e3
    t["tiles_per_s_int8"] = SEG_B / t["int8_ms_device_input"] * 1e3
    t["profile_bf16"] = profile_step(torch, lambda im, _b: seg(im),
                                     dev_tiles, None, n=5)
    t["profile_int8"] = profile_step(torch, lambda im, _b: qseg(im),
                                     dev_tiles, None, n=3)
    rec["f"] = t
    print(f"segmentation (f): batch of {SEG_B} at {SEG_SIZE} px: bf16 "
          f"{t['bf16_ms_host_input']:.2f} ms host input / "
          f"{t['bf16_ms_device_input']:.2f} ms device input "
          f"({t['tiles_per_s_bf16']:.0f} tiles/s), int8 "
          f"{t['int8_ms_host_input']:.2f} / {t['int8_ms_device_input']:.2f} "
          f"ms ({t['int8_ms_device_input_second']:.2f} again, bf16 between "
          f"{t['bf16_ms_device_input_between']:.2f}); "
          f"{t['gflop_per_tile']:.2f} GFLOP a tile, bound "
          f"{t['bound_ms']:.3f} ms ({t['bound_share_bf16']:.1%} of it); peak "
          f"memory bf16 {t['bf16_peak_mem_gb']:.2f} GB, int8 "
          f"{t['int8_peak_mem_gb']:.2f} GB [{card}]", flush=True)
    for key in ("profile_bf16", "profile_int8"):
        prof = t[key]
        if "top" in prof:
            print(f"segmentation {key}: device busy "
                  f"{prof['device_busy_ms_per_step']:.2f} of "
                  f"{prof['wall_ms_per_step_profiled']:.2f} ms, idle share "
                  f"{prof['idle_share']:.3f}, top: " + "; ".join(
                      f"{r['ms_per_step']:.3f} ms {r['name'][:50]}"
                      for r in prof["top"][:6]) + f" [{card}]", flush=True)
    return relu


# ------------------------------------------------------------- phase 13

TRAIN_B, TRAIN_TILES, TRAIN_EVAL_TILES = 16, 64, 16     # 13a
TRAIN_EVAL_B = 8                                       # the eval batch
V8L_B, V8L_SIZE = 8, 768                               # the train verb's
VERB_TILES, VERB_TRAIN = 24, 16                        # 13d
TRAIN_LR = 1e-4
# 13a's bound on each gradient leaf, card against CPU, relative to the
# leaf's largest magnitude (both steps f32, cuDNN's TF32 off); the same
# step with TF32 on must exceed it. On an H100 (700 W) the two read
# 3.75e-4 and 9.72e-2.
TRAIN_GRAD_LIMIT = 1e-3


def tile_targets(bounds, cars, size: int, px_per_m: float = 2.0):
    """render_tiles' cars as the loader's normalized targets: [N, 5] rows
    (0, cx, cy, w, h), per tile, of each car's 4.5×2 m box centred on its
    exact position: the convention the trained fixture learned
    (``examples/train_fakeworld.py``, ``build_samples``). The rectangle
    render_tiles draws is cut to whole pixels, up to 1 px left and up of
    that box."""
    import numpy as np
    m2lon = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
    m2lat = 1.0 / 111319.9
    out = []
    for (west, _south, _east, north), truth in zip(bounds, cars):
        rows = [(0, (lon - float(west)) / m2lon * px_per_m / size,
                 (float(north) - lat) / m2lat * px_per_m / size,
                 4.5 * px_per_m / size, 2.0 * px_per_m / size)
                for lon, lat in truth]
        out.append(np.asarray(rows, np.float32).reshape(-1, 5))
    return out


@contextlib.contextmanager
def cudnn_tf32_on(torch, T):
    """The trainer with cuDNN's TF32 on: ``pipeline.train._f32_convs``
    replaced by a context that turns it on, for 13a's control step."""
    saved = T._f32_convs

    @contextlib.contextmanager
    def on():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    T._f32_convs = on
    try:
        yield
    finally:
        T._f32_convs = saved


def memory_loader(tiles, targets, batch: int, train: bool, **cfg):
    """A DetectionLoader over tiles held in memory (``decode_fn``)."""
    from aerial_image_recognition_tpu_torch.pipeline.data import (
        DetectionLoader, LoaderConfig, Sample)
    samples = [Sample(f"mem:{i}", t) for i, t in enumerate(targets)]
    return DetectionLoader(
        samples, LoaderConfig(image_size=tiles.shape[1], batch_size=batch,
                              **cfg),
        decode_fn=lambda path: tiles[int(path.split(":")[1])], train=train)


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def leaf_errors(got, want):
    """{leaf: max |got − want| / max |want|} of two flax-format trees."""
    import numpy as np
    g, w = flat_tree(got), flat_tree(want)
    if g.keys() != w.keys():
        fail(f"trees differ in their leaves: {sorted(g.keys() ^ w.keys())[:4]}")
    return {k: float(np.abs(np.asarray(g[k]) - np.asarray(w[k])).max()
                     / max(float(np.abs(np.asarray(w[k])).max()), 1e-30))
            for k in w}


@contextlib.contextmanager
def f64_bn_statistics(torch):
    """14f's witness: ``batch``-mode BatchNorm (where no shard sync is set)
    with its statistics accumulated in f64 over two passes, the mean, then
    the mean of squared deviations from it, and normalizing as the layer
    does. It shares neither the single-device step's flax fast variance
    E[x²] − E[x]² nor the shards' pairwise combination."""
    from aerial_image_recognition_tpu_torch.models import layers
    real = layers.BatchNorm.forward

    def forward(self, x):
        if self.mode != "batch" or self.sync is not None:
            return real(self, x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3), dtype=torch.float64).float()
        dev = xf - mean[:, None, None]
        var = (dev * dev).mean(dim=(0, 2, 3), dtype=torch.float64).float()
        if self.batch_mean is None:
            self.batch_mean, self.batch_var = mean.detach(), var.detach()
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (dev * mul[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)

    layers.BatchNorm.forward = forward
    try:
        yield
    finally:
        layers.BatchNorm.forward = real


def timed_train_steps(torch, step, state, batch, n: int, warmup: int = 2):
    """(state, ms a step by CUDA events over n steps after warmup, the
    losses) of a train step on one batch held on the host."""
    losses = []
    for _ in range(warmup):
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = []
    for _ in range(n):
        state, m = step(state, *batch)
        out.append(m["loss"])
    end.record()
    torch.cuda.synchronize()
    losses += [float(v) for v in out]
    return state, start.elapsed_time(end) / n, losses


def profile_train_steps(torch, step, state, batch, n: int = 2):
    """profile_calls over n train steps on one batch held on the host."""
    held = {"state": state}

    def one():
        held["state"], _ = step(held["state"], *batch)
    return profile_calls(torch, one, n)


def print_profile(label, prof, card, top: int = 6):
    if "top" in prof:
        print(f"{label}: device busy {prof['device_busy_ms_per_step']:.2f} "
              f"of {prof['wall_ms_per_step_profiled']:.2f} ms a step, idle "
              f"share {prof['idle_share']:.3f}, top: " + "; ".join(
                  f"{r['ms_per_step']:.3f} ms {r['name'][:50]}"
                  for r in prof["top"][:top]) + f" [{card}]", flush=True)


def train_forward_flops(torch, step, state, images) -> float:
    """Multiply-adds ×2 of one forward of the trainer's module on images
    (forward hooks, as forward_flops)."""
    from aerial_image_recognition_tpu_torch.models.layers import (
        clear_batch_stats, set_bn_mode)
    from aerial_image_recognition_tpu_torch.pipeline.train import (
        _apply, _images_in)
    set_bn_mode(step.module, step.bn_mode)
    with torch.no_grad():
        flops = forward_flops(torch, step.module, lambda: _apply(
            step.module, state["params"], state["batch_stats"],
            _images_in(images, "cuda")))
    clear_batch_stats(step.module)
    return flops


def train_13a(torch, record, card, launches, open_window, close_window,
              base):
    """13a: YOLOv7-tiny from the trained fixture, fine-tuned at 640 px,
    batch 16, f32, frozen BN, freeze 0,1,2, lr 1e-4, on 64 rendered tiles
    at 0.5 m/px; evaluated on 16 held-out tiles in batches of 8."""
    import shutil
    import tempfile
    import warnings
    import numpy as np
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.models.weights import (
        grads_to_flax, load_params)
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    from aerial_image_recognition_tpu_torch.pipeline import train as T

    rng = np.random.default_rng(13)
    tiles, bounds, cars = render_tiles(rng, TRAIN_TILES + TRAIN_EVAL_TILES,
                                       SIZE)
    targets = tile_targets(bounds, cars, SIZE)
    train_loader = memory_loader(tiles[:TRAIN_TILES], targets[:TRAIN_TILES],
                                 TRAIN_B, True, mosaic=0.0, seed=0)
    eval_loader = memory_loader(tiles[TRAIN_TILES:], targets[TRAIN_TILES:],
                                TRAIN_EVAL_B, False, mosaic=0.0, mixup=0.0,
                                hsv=0.0)
    eval_batches = -(-TRAIN_EVAL_TILES // TRAIN_EVAL_B)
    freeze = [0, 1, 2]
    out = {"tiles": TRAIN_TILES, "eval_tiles": TRAIN_EVAL_TILES,
           "size": SIZE, "batch": TRAIN_B, "lr": TRAIN_LR, "freeze": freeze,
           "bn_mode": "frozen"}

    # 1. one step on the card against the same step on the CPU, 2 tiles;
    # then the card's step with cuDNN's TF32 on, which the check must refuse
    pair = next(iter(memory_loader(tiles[:2], targets[:2], 2, False,
                                   mosaic=0.0, mixup=0.0, hsv=0.0).epoch(0)))
    grads = {}
    for dev, tf32 in (("cpu", False), ("cuda", False), ("cuda", True)):
        b = create_model("yolov7_itcvd", dtype=torch.float32,
                         params_path=FIXTURE, device=dev)
        tx = T.make_optimizer(lr=TRAIN_LR)
        step = T.make_train_step(b, tx, bn_mode="auto", freeze=freeze)
        with (cudnn_tf32_on(torch, T) if tf32 else contextlib.nullcontext()):
            loss, _, g, _ = step.loss_and_grads(T.init_train_state(b, tx),
                                                *pair)
        grads[dev, tf32] = (float(loss), grads_to_flax(g)["params"])
    cpu_loss, cpu_g = grads["cpu", False]

    def against_cpu(key):
        loss, g = grads[key]
        rel = leaf_errors(g, cpu_g)
        row = {"loss_cpu": cpu_loss, "loss_card": loss,
               "loss_rel": abs(loss - cpu_loss) / abs(cpu_loss),
               "grad_max_rel_to_leaf_max": max(rel.values()),
               "grad_worst_leaf": max(rel, key=rel.get), "leaves": len(rel),
               "grad_limit": TRAIN_GRAD_LIMIT}
        row["differs"] = (row["loss_rel"] > 1e-4
                          or row["grad_max_rel_to_leaf_max"]
                          > TRAIN_GRAD_LIMIT)
        return row
    # both f32 (TF32 off), summed in other orders by cuDNN and the CPU
    out["card_vs_cpu"] = against_cpu(("cuda", False))
    out["card_tf32_vs_cpu"] = against_cpu(("cuda", True))
    if out["card_vs_cpu"]["differs"]:
        fail(f"13a: the train step on the card differs from the CPU's: "
             f"{out['card_vs_cpu']}")
    if not out["card_tf32_vs_cpu"]["differs"]:
        fail(f"13a: the card-vs-CPU check does not see cuDNN's TF32: "
             f"{out['card_tf32_vs_cpu']} (TF32 off: "
             f"{out['card_vs_cpu']['grad_max_rel_to_leaf_max']:.3e})")
    del grads

    # the main path: fit (two epochs, eval each epoch) under the counters
    bundle = create_model("yolov7_itcvd", dtype=torch.float32,
                          params_path=FIXTURE, device="cuda")
    before = T.evaluate(
        bundle, T.state_from_flax(bundle.variables, bundle.device),
        eval_loader)
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    logs = []
    ck = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            open_window()
            state = T.fit(bundle, train_loader, epochs=2, lr=TRAIN_LR,
                          eval_loader=eval_loader, freeze=freeze,
                          log_fn=logs.append)
            torch.cuda.synchronize()
            close_window("train_13a", ["nms_suppress"])
            fit_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # resume: one epoch to a checkpoint, then a resumed second
            one = T.fit(bundle, train_loader, epochs=1, lr=TRAIN_LR,
                        freeze=freeze, ckpt_dir=ck, log_fn=logs.append)
            two = T.fit(bundle, train_loader, epochs=2, lr=TRAIN_LR,
                        freeze=freeze, ckpt_dir=ck, log_fn=logs.append)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(ck, ignore_errors=True)
    nondeterministic = sorted({str(w.message)[:120] for w in caught
                               if "deterministic" in str(w.message)})
    hist = state["history"]
    after = hist[-1]
    losses = [r["loss"] for r in hist]
    if not all(math.isfinite(v) for v in losses):
        fail(f"13a: losses {losses}")
    if after["mAP50"] < before["mAP50"] - 0.02:
        fail(f"13a: mAP50 fell from {before['mAP50']:.4f} to "
             f"{after['mAP50']:.4f}")
    fixture = flat_tree(load_params(FIXTURE)["params"])
    trained = flat_tree(state["params"])
    frozen = [k for k in trained if k.split("/")[0] in ("stem0", "stem1")
              or k.startswith("elan1/cv1/")]
    if not frozen or any(not np.array_equal(trained[k], fixture[k])
                         for k in frozen):
        fail("13a: a frozen leaf moved")
    if not any(not np.array_equal(trained[k], fixture[k]) for k in trained
               if k not in frozen):
        fail("13a: no trainable leaf moved")
    n_nms = launches["train_13a"]["nms_suppress"]
    if n_nms != 2 * eval_batches:
        fail(f"13a: {n_nms} NMS launches for 2 evaluations of "
             f"{eval_batches} batches")
    per_epoch = TRAIN_TILES // TRAIN_B
    if not any(f"resumed from epoch 0 (step {per_epoch})" in m
               for m in logs):
        fail(f"13a: the second fit did not resume: {logs[-3:]}")
    # the resumed run against the uninterrupted one
    steps = 2 * per_epoch
    g, w = flat_tree(two["params"]), flat_tree(state["params"])
    diff = np.concatenate([np.abs(g[k] - w[k]).ravel() for k in w])
    resume = {"bit_exact": bool(diff.max() == 0),
              "max_abs_diff": float(diff.max()),
              "share_above_1e-6": float((diff > 1e-6).mean()),
              "loss_epoch1": [two["history"][-1]["loss"], hist[-1]["loss"]],
              "step": [int(two["step"]), int(state["step"])],
              "nondeterministic_ops": nondeterministic}
    # Adam moves a leaf by about lr a step whatever its gradient's size, so
    # a noise-level gradient that flips sign moves it by 2·lr
    if (resume["step"] != [steps, steps]
            or resume["max_abs_diff"] > 2 * TRAIN_LR * steps + 1e-6
            or resume["share_above_1e-6"] > 0.01
            or abs(resume["loss_epoch1"][0] - resume["loss_epoch1"][1])
            > 1e-3 * abs(resume["loss_epoch1"][1])):
        fail(f"13a: the resumed run differs from the uninterrupted one: "
             f"{resume}")

    # time: steps on one batch, outside the deterministic mode
    tx = T.make_optimizer(lr=TRAIN_LR, param_mask=T._freeze_mask(
        bundle.variables["params"], T.resolve_freeze_prefixes(bundle,
                                                              freeze)))
    step = T.make_train_step(bundle, tx, freeze=freeze)
    batch = next(iter(train_loader.epoch(0)))
    s = T.init_train_state(bundle, tx)
    flops = train_forward_flops(torch, step, s, batch[0])
    torch.cuda.reset_peak_memory_stats()
    s, ms, _ = timed_train_steps(torch, step, s, batch, 10)
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out["profile"] = profile_train_steps(torch, step, s, batch)
    bound_ms = 3 * flops / F32_FLOPS * 1e3
    out.update(
        mAP50_before=before["mAP50"], mAP50_95_before=before["mAP50_95"],
        mAP50_after=after["mAP50"], mAP50_95_after=after["mAP50_95"],
        history=hist, fit_s=fit_s, fit_peak_mem_gb=peak_gb,
        frozen_leaves_equal=len(frozen), nms_launches=n_nms,
        eval_batches_per_eval=eval_batches, resume=resume,
        step_ms=ms, images_per_s=TRAIN_B / ms * 1e3,
        forward_gflop=flops / 1e9, bound_ms=bound_ms,
        bound_share=bound_ms / ms, step_peak_mem_gb=step_peak_gb)
    record["training"]["13a"] = out
    print(f"13a yolov7-tiny fine-tune, {SIZE} px, batch {TRAIN_B}, f32, "
          f"frozen BN, freeze 0,1,2: card vs CPU loss rel "
          f"{out['card_vs_cpu']['loss_rel']:.2e}, grads within "
          f"{out['card_vs_cpu']['grad_max_rel_to_leaf_max']:.2e} of their "
          f"leaf's largest (limit {TRAIN_GRAD_LIMIT:.1e}; TF32 on: loss "
          f"{out['card_tf32_vs_cpu']['loss_rel']:.2e}, grads "
          f"{out['card_tf32_vs_cpu']['grad_max_rel_to_leaf_max']:.2e}, "
          f"refused); losses {[round(v, 4) for v in losses]}; mAP50 "
          f"{before['mAP50']:.4f} -> {after['mAP50']:.4f}; {n_nms} NMS "
          f"launches in 2 evals; resume bit-exact {resume['bit_exact']} "
          f"(max diff {resume['max_abs_diff']:.2e}); {ms:.2f} ms/step, "
          f"{TRAIN_B / ms * 1e3:.1f} images/s, {bound_ms / ms:.3f} of the "
          f"{bound_ms:.2f} ms f32 bound ({flops / 1e9:.1f} GFLOP a "
          f"forward), peak {out['step_peak_mem_gb']:.2f} GB [{card}]",
          flush=True)
    print_profile("13a profile", out["profile"], card)


class BatchLoader:
    """A loader of fixed batches: ``epoch(i)`` yields them in order."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, _i):
        yield from self.batches


def train_13b(torch, record, card, open_window, close_window):
    """13b: YOLOv8l at the train verb's defaults (768 px, batch 8, batch
    BN), seeded unit-variance weights: timed steps, recalibration, flax BN
    semantics card vs CPU on the trained nano, remat against plain."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline import train as T

    rng = np.random.default_rng(14)
    tiles, bounds, cars = render_tiles(rng, V8L_B, V8L_SIZE)
    loader = memory_loader(tiles, tile_targets(bounds, cars, V8L_SIZE),
                           V8L_B, False, mosaic=0.0, mixup=0.0, hsv=0.0)
    batch = next(iter(loader.epoch(0)))
    tree = unit_variance_tree(torch, "yolov8_tokyo", tiles[:, :SIZE, :SIZE])
    bundle = create_model("yolov8_tokyo", dtype=torch.float32,
                          variables=tree, device="cuda")
    tx = T.make_optimizer(lr=TRAIN_LR)
    step = T.make_train_step(bundle, tx)
    if step.bn_mode != "batch":
        fail(f"13b: yolov8 resolved to BN mode {step.bn_mode}")
    s0 = T.init_train_state(bundle, tx)
    flops = train_forward_flops(torch, step, s0, batch[0])
    torch.cuda.reset_peak_memory_stats()
    open_window()
    s, ms, losses = timed_train_steps(torch, step, s0, batch, 10)
    s = T.recalibrate_bn(bundle, s, BatchLoader([batch]), passes=1)
    torch.cuda.synchronize()
    close_window("train_13b", [])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats_finite = all(bool(torch.isfinite(v).all())
                       for v in s["batch_stats"].values())
    if not all(math.isfinite(v) for v in losses) or not stats_finite:
        fail(f"13b: losses {losses}, running statistics finite "
             f"{stats_finite}")
    bound_ms = 3 * flops / F32_FLOPS * 1e3
    prof = profile_train_steps(torch, step, s, batch)
    del s

    # remat: one step equal to the plain one, statistics updated once
    plain, _ = step(s0, *batch)
    remat, _ = T.make_train_step(bundle, tx, remat=True)(s0, *batch)
    stats_equal = all(torch.equal(plain["batch_stats"][k],
                                  remat["batch_stats"][k])
                      for k in plain["batch_stats"])
    pdiff = max(float((plain["params"][k] - remat["params"][k]).abs().max())
                for k in plain["params"])
    # the backward's atomics may flip a noise-level gradient's sign
    if not stats_equal or pdiff > 2 * TRAIN_LR + 1e-6:
        fail(f"13b: the remat step differs from the plain one: statistics "
             f"equal {stats_equal}, params by {pdiff}")
    del plain, remat, s0

    # flax's BN on the card: one batch step of the trained nano at 96 px
    nano = {}
    small = render_centred_tiles(rng, 6, 2)[0]
    tg = np.full((8, 4, 5), -1.0, np.float32)
    tg[:6, 0] = (0, V8N_SIZE / 2, V8N_SIZE / 2, 45.0, 20.0)
    for dev in ("cpu", "cuda"):
        b = create_model("yolov8n", dtype=torch.float32,
                         params_path=V8_FIXTURE, device=dev)
        t = T.make_optimizer(lr=TRAIN_LR)
        st, _ = T.make_train_step(b, t)(T.init_train_state(b, t), small, tg)
        nano[dev] = T.state_to_flax(st)["batch_stats"]
    bn_rel = leaf_errors(nano["cuda"], nano["cpu"])
    if max(bn_rel.values()) > 1e-4:
        fail(f"13b: the nano's running statistics on the card differ from "
             f"the CPU's by {max(bn_rel.values())} of a leaf's largest")
    out = {"size": V8L_SIZE, "batch": V8L_B, "bn_mode": "batch",
           "weights": "seeded, unit variance", "timed_steps": 10,
           "losses": losses, "step_ms": ms,
           "images_per_s": V8L_B / ms * 1e3, "forward_gflop": flops / 1e9,
           "bound_ms": bound_ms, "bound_share": bound_ms / ms,
           "peak_mem_gb": peak_gb, "running_stats_finite": stats_finite,
           "remat_stats_equal": stats_equal, "remat_params_max_diff": pdiff,
           "nano_bn_card_vs_cpu_max_rel": max(bn_rel.values()),
           "profile": prof}
    record["training"]["13b"] = out
    print(f"13b yolov8l, {V8L_SIZE} px, batch {V8L_B}, f32, batch BN: "
          f"{ms:.2f} ms/step, {V8L_B / ms * 1e3:.1f} images/s, "
          f"{bound_ms / ms:.3f} of the {bound_ms:.1f} ms f32 bound "
          f"({flops / 1e9:.1f} GFLOP a forward), peak {peak_gb:.2f} GB; "
          f"losses {losses[0]:.3f} -> {losses[-1]:.3f}; recalibrated "
          f"statistics finite; remat = plain (statistics equal, params "
          f"within {pdiff:.1e}); trained nano's BN statistics card vs CPU "
          f"within {max(bn_rel.values()):.1e} [{card}]", flush=True)
    print_profile("13b profile", prof, card)


def train_13c(torch, record, card, open_window, close_window):
    """13c: XUnet from the trained fixture, 256 px, batch 16, frozen BN,
    8 steps on its world's tiles with mask targets, fit(eval_fn=mask IoU)
    on 16 held-out tiles."""
    import dataclasses
    import numpy as np
    from aerial_image_recognition_tpu_torch.fetch.fake import FakeWorld
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    from aerial_image_recognition_tpu_torch.pipeline import train as T

    world = FakeWorld(**SEG_WORLD)
    tiles, masks, _ = seg_tiles(world, 2 * SEG_B, seed=7)
    held, held_masks, _ = seg_tiles(world, SEG_B, seed=123)
    loader = BatchLoader([(tiles[i:i + SEG_B],
                           masks[i:i + SEG_B, ..., None].astype(np.float32))
                          for i in range(0, len(tiles), SEG_B)])
    bundle = create_model("xunet_256", dtype=torch.float32,
                          params_path=XUNET_FIXTURE, device="cuda")

    def mask_iou(b, state):
        module = dataclasses.replace(b, variables={
            "params": state["params"],
            "batch_stats": state["batch_stats"]}).trainable().eval()
        with torch.no_grad():
            x = preprocess_batch(torch.from_numpy(held).cuda(),
                                 out_size=SEG_SIZE, dtype=torch.bfloat16)
            pred = (module(x.float()) > 0)[..., 0].cpu().numpy()
        v = iou(pred, held_masks)
        return {"mask_iou": v, "fitness": v}

    before = mask_iou(bundle, bundle.variables)["mask_iou"]
    open_window()
    state = T.fit(bundle, loader, epochs=4, lr=TRAIN_LR, eval_fn=mask_iou,
                  eval_every=4, log_fn=lambda m: None)
    torch.cuda.synchronize()
    close_window("train_13c", [])
    after = state["history"][-1]["mask_iou"]
    losses = [r["loss"] for r in state["history"]]
    if not all(math.isfinite(v) for v in losses) \
            or after < before - 0.005:
        fail(f"13c: losses {losses}, mask IoU {before:.4f} -> {after:.4f}")
    record["training"]["13c"] = {
        "size": SEG_SIZE, "batch": SEG_B, "steps": int(state["step"]),
        "bn_mode": "frozen", "losses": losses, "mask_iou_before": before,
        "mask_iou_after": after}
    print(f"13c xunet, {SEG_SIZE} px, batch {SEG_B}, frozen BN, "
          f"{state['step']} steps: losses {[round(v, 4) for v in losses]}, "
          f"mask IoU on 16 held-out tiles {before:.4f} -> {after:.4f} "
          f"[{card}]", flush=True)


def train_13d(torch, record, card, launches, base):
    """13d: the train and val verbs as counted children, on a COCO json
    and JPEG tiles rendered from the FakeWorld of 13a's generator."""
    import shutil
    import tempfile
    import numpy as np
    from PIL import Image
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline.data import (
        DetectionLoader, LoaderConfig, coco_to_yolo)
    from aerial_image_recognition_tpu_torch.pipeline.train import (
        evaluate, state_from_flax)

    work = tempfile.mkdtemp(prefix="chip_smoke_verbs_")
    try:
        rng = np.random.default_rng(15)
        tiles, bounds, cars = render_tiles(rng, VERB_TILES, SIZE)
        images, anns = [], []
        imdir = os.path.join(work, "images")
        os.makedirs(imdir)
        # the json beside the tiles, where coco_to_yolo looks for them
        for i, (img, t) in enumerate(zip(tiles, tile_targets(bounds, cars,
                                                             SIZE))):
            Image.fromarray(img).save(os.path.join(imdir, f"t{i}.jpg"),
                                      quality=95)
            images.append({"id": i, "file_name": f"t{i}.jpg", "width": SIZE,
                           "height": SIZE})
            for _, cx, cy, w, h in t * SIZE:
                anns.append({"id": len(anns), "image_id": i,
                             "category_id": 0, "bbox": [
                                 float(cx - w / 2), float(cy - h / 2),
                                 float(w), float(h)]})
        coco = os.path.join(imdir, "coco.json")
        with open(coco, "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": 0, "name": "car"}]}, f)
        out = os.path.join(work, "tuned.npz")
        argv = ["train", "--coco", coco, "--images", imdir, "--model",
                "yolov7_itcvd", "--params", FIXTURE, "--epochs", "2",
                "--imgsz", str(SIZE), "--batch", "8", "--n-train",
                str(VERB_TRAIN), "--freeze", "0,1,2", "--out", out]
        proc, t_wall, t_counts = run_verb(base, "train", argv)
        trained = last_json(proc.stdout)
        vargv = ["val", "--coco", coco, "--images", imdir, "--model",
                 "yolov7_itcvd", "--params", out, "--imgsz", str(SIZE),
                 "--batch", "8"]
        proc, v_wall, v_counts = run_verb(base, "val", vargv)
        val = last_json(proc.stdout)
        # one launch an eval batch: the train verb evaluates its held-out
        # tiles after each of its 2 epochs, val all tiles once
        child_launches(launches, "train_verb", t_counts, ["nms_suppress"])
        child_launches(launches, "val_verb", v_counts, ["nms_suppress"])
        want = (2 * -(-(VERB_TILES - VERB_TRAIN) // 8), -(-VERB_TILES // 8))
        if (t_counts["nms_suppress"], v_counts["nms_suppress"]) != want:
            fail(f"13d: NMS launches train {t_counts}, val {v_counts}, "
                 f"expected {want}")
        samples = coco_to_yolo(coco)
        bundle = create_model("yolov7_itcvd", dtype=torch.float32,
                              params_path=out, device="cuda")
        here = evaluate(
            bundle, state_from_flax(bundle.variables, bundle.device),
            DetectionLoader(samples, LoaderConfig(
                image_size=SIZE, batch_size=8, mosaic=0.0, mixup=0.0,
                hsv=0.0), train=False))
        if val["n_images"] != VERB_TILES or abs(val["mAP50"]
                                                - here["mAP50"]) > 1e-9:
            fail(f"13d: val {val} against in-process {here}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["training"]["13d"] = {
        "train": trained, "train_wall_s": t_wall, "train_launches": t_counts,
        "val": val, "val_wall_s": v_wall, "val_launches": v_counts,
        "in_process_mAP50": here["mAP50"]}
    print(f"13d verbs: train {t_wall:.1f} s (final mAP50 "
          f"{trained['final']['mAP50']:.4f}, best epoch "
          f"{trained.get('best', {}).get('epoch')}), val {v_wall:.1f} s, "
          f"mAP50 {val['mAP50']:.4f} = in process; NMS launches in the "
          f"children {t_counts['nms_suppress']} / {v_counts['nms_suppress']}"
          f" [{card}]", flush=True)


def training(torch, record, card, launches, open_window, close_window):
    """13. The training path on the card (13a–13d)."""
    base = os.path.join(ROOT, "chiprun_out", "training")
    os.makedirs(base, exist_ok=True)
    record["training"] = {}
    train_13a(torch, record, card, launches, open_window, close_window,
              base)
    train_13b(torch, record, card, open_window, close_window)
    train_13c(torch, record, card, open_window, close_window)
    train_13d(torch, record, card, launches, base)


# ------------------------------------------------------------- phase 14

DP_TIMED = 10                    # timed steps of each data-parallel step
DIST_STEPS, DIST_B = 3, 16       # 14e: 13a's fine-tune, global batch
# 14a, 14g: a one-shard step is the single-device step's computation and
# is held to it bit for bit. Over two shards of a card, a shard of 32 rows
# (14a) or of half the rows (14g) takes other cuDNN algorithms than the
# whole batch, so the outputs move by bf16 roundings: they are held
# detection by detection (detection_deltas): every detection matched, each
# score within DP_SCORE_MAX and each box coordinate within DP_BOX_MAX px
# of its match. The largest readings (H100 80GB HBM3, 700 W, two runs
# alike): 14a 1.60e-3 and 0.034 px, 14g 3.6e-7 and 0.011 px, the int8
# steps 0 and 0; the limits are about three times 14a's.
DP_SCORE_MAX, DP_BOX_MAX = 5e-3, 0.1
# 14b: the two-shard scan with its dedup off, deduped on the host after,
# against the single-device scan (another dedup order): 2 of 1838 records
# unmatched within 0.5 m in every run on the H100 80GB HBM3 at 700 W (0.99891)
DP_SCAN_MATCH = 0.998

DP_PER_CARD_B = 64               # 14a: the per-card production batch
DP_TRAIN_PER_CARD = 8            # 14f: the train verb's batch, a card
DIST_CHILD = f"""
import json, os, sys, time
sys.path.insert(0, {ROOT!r})
import numpy as np, torch
import chip_smoke as cs
from {PORT}.parallel import distributed as D
from {PORT}.parallel.mesh import make_mesh
coord, rank, world, backend, out, mode = sys.argv[1:7]
rank, world = int(rank), int(world)
ctx = D.initialize(coord, world, rank, backend=backend)
dev = torch.device("cuda", rank % torch.cuda.device_count())
D.process_allgather(np.zeros(1, np.int32))
mesh = make_mesh()                 # under the group: this process's card
assert list(mesh.devices) == [dev] and mesh.size == world, mesh
assert (ctx.local_devices, ctx.global_devices) == (1, world), ctx
assert torch.cuda.current_device() == dev.index
report = {{"rank": ctx.process_index, "world": ctx.process_count,
           "backend": torch.distributed.get_backend(), "device": str(dev),
           "global_devices": ctx.global_devices}}
if mode == "train":
    params, losses, ms = cs.dist_train(torch, mesh, dev, rank, world)
    sums = D.process_allgather(np.asarray([float(np.abs(v).sum())
                                           for v in params.values()]))
    np.savez(out, **params)
    report.update(losses=losses, step_ms=ms,
                  sums_equal=bool((sums == sums[0]).all()))
else:
    t0 = time.perf_counter()
    tiles, recs, stripe = cs.dist_scan(os.path.dirname(out), sys.argv[7],
                                       sys.argv[8], ctx, dev)
    wall = time.perf_counter() - t0
    counts = D.process_allgather(np.asarray([len(recs)], np.int64))
    with open(out, "w") as f:
        json.dump({{"tiles": tiles, "records": recs, "wall_s": wall,
                   "host_stripe": stripe,
                   "counts_allgather": counts.reshape(-1).tolist()}}, f)
    report.update(tiles=tiles, records=len(recs), wall_s=wall)
print(json.dumps(report), flush=True)
D.shutdown()
"""


def scan_config(server_url, frame, **extra):
    """10b's scan (WMS JPEG, 640 px a 320 m tile, the trained fixture,
    bf16, B=64) over ``frame``, with ``extra`` on top."""
    return dict({
        "frame_path": frame, "use_xyz": False,
        "wms_url": server_url + "/wms", "wms_layer": "fake",
        "wms_size": (SIZE, SIZE), "tile_size_meters": SCAN_TILE_M,
        "tile_overlap": SCAN_OVERLAP, "confidence_threshold": 0.4,
        "duplicate_distance": 2.0, "checkpoint_interval": 10**9,
        "params_path": FIXTURE, "dtype": "bfloat16", "device_batch": B,
        "batch_size": B, "num_workers": 16, "submit_spacing": 0.0}, **extra)


def stripe_tiles(tiles, rank: int, world: int):
    """The tiles of process ``rank``'s stripe of ``SCAN_AOI``: each tile
    goes to the stripe whose UTM x range (``split_aoi_stripes`` without
    its halo) holds the tile's centre, so the stripes split the grid."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.geo.tmerc import tm_forward
    from aerial_image_recognition_tpu_torch.parallel.stripes import (
        assign_to_stripes, split_aoi_stripes)
    _, p, edges = split_aoi_stripes(SCAN_AOI, world, halo_m=0.0)
    x, _ = tm_forward((tiles[:, 0] + tiles[:, 2]) / 2,
                      (tiles[:, 1] + tiles[:, 3]) / 2, p)
    return assign_to_stripes(np.asarray(x), edges, world) == rank


def dist_scan(base, server_url, frame, ctx, dev):
    """14e's stripe scan in one process: a ``CarDetector`` scan with
    ``data_parallel: true`` of this process's stripe of 10b's AOI
    (``stripe_tiles``) on its card ``dev``, the dedup off. Returns (tiles scanned, raw records, ``host_stripe``:
    the halo-widened WGS84 stripe the process fetches from)."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.gio.geojson import (
        feature_collection_to_detections, read_geojson)
    from aerial_image_recognition_tpu_torch.parallel.distributed import (
        host_stripe)
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    rank, world = ctx.process_index, ctx.process_count
    stripe = host_stripe(SCAN_AOI, ctx)

    def keep(tiles):
        # the grid overhangs the AOI: a tile's centre clamped to the AOI
        # lies in the stripe this process fetches from
        mask = stripe_tiles(tiles, rank, world)
        cx = np.clip((tiles[mask, 0] + tiles[mask, 2]) / 2, SCAN_AOI[0],
                     SCAN_AOI[2])
        if not ((cx >= stripe[0]) & (cx <= stripe[2])).all():
            raise AssertionError(f"a tile of stripe {rank} lies outside "
                                 f"its host_stripe {stripe}")
        return mask

    det = CarDetector(os.path.join(base, f"stripe{rank}"),
                      scan_config(server_url, frame, duplicate_distance=0.0,
                                  data_parallel=True), tile_filter=keep)
    out = det.detect(force_restart=True)
    # data_parallel under the group: a mesh of this process's card that
    # spans the processes
    mesh = det.last_step.mesh
    where = next(det.last_step.bundle.module.parameters()).device
    if where != dev or mesh.devices != (dev,) or mesh.size != world:
        raise AssertionError(f"process {rank} scanned on {where} over "
                             f"{mesh}, not on {dev}")
    recs = feature_collection_to_detections(read_geojson(out["output"]))
    return out["tiles"], recs, [float(v) for v in np.asarray(stripe)]


def dist_batches(n: int = DIST_STEPS):
    """13a's fine-tune data, the first ``n`` global batches of 16."""
    import numpy as np
    rng = np.random.default_rng(13)
    tiles, bounds, cars = render_tiles(rng, TRAIN_TILES, SIZE)
    loader = memory_loader(tiles, tile_targets(bounds, cars, SIZE),
                           DIST_B, True, mosaic=0.0, seed=0)
    out = []
    for batch in loader.epoch(0):
        out.append(batch)
        if len(out) == n:
            return out
    fail(f"14e: only {len(out)} batches")


def dist_train(torch, mesh, dev, rank: int, world: int):
    """14e's run: 13a's YOLOv7-tiny fine-tune (frozen BN, freeze 0,1,2,
    lr 1e-4), ``DIST_STEPS`` steps, each process on its rows of every
    global batch. Returns (trained params as numpy, losses, ms a step
    after the first)."""
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline import train as T
    b = create_model("yolov7_itcvd", dtype=torch.float32,
                     params_path=FIXTURE, device=dev)
    mask = T._freeze_mask(b.variables["params"],
                          T.resolve_freeze_prefixes(b, [0, 1, 2]))
    tx = T.make_optimizer(lr=TRAIN_LR, param_mask=mask)
    step = T.make_train_step(b, tx, mesh=mesh, bn_mode="frozen",
                             freeze=[0, 1, 2])
    state = T.init_train_state(b, tx)
    per = DIST_B // world
    losses = []
    for k, (images, targets) in enumerate(dist_batches()):
        if k == 1:                     # time the steps after the first
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        rows = slice(rank * per, (rank + 1) * per)
        state, m = step(state, images[rows], targets[rows])
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (DIST_STEPS - 1) * 1e3
    return ({k: v.cpu().numpy() for k, v in state["params"].items()},
            losses, ms)


def params_within(got, want, steps: int):
    """(max |Δ|, fraction beyond 1e-6) of two params dicts; fails unless
    every element is within 2·lr a step (Adam's sign flips, 13a's rule)."""
    import numpy as np
    worst, far, total = 0.0, 0, 0
    for k, w in want.items():
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(w, np.float64))
        worst = max(worst, float(d.max()))
        far += int((d > 1e-6).sum())
        total += d.size
    if worst > 2 * TRAIN_LR * steps * (1 + 1e-3):
        fail(f"params differ by {worst} (limit 2·lr a step)")
    return worst, far / total


def records_of(base, name):
    """(lon, lat, confidence) rows of a scan's results, sorted."""
    recs, _ = scan_records(os.path.join(base, name))
    return recs


def issue_ms(torch, step, images, bounds, n: int = DP_TIMED) -> float:
    """Mean host time for one call of ``step`` to return, its launches
    issued, each call made with the cards idle: the host's part of a step
    (a step no longer than this is bound by the host)."""
    step(images, bounds)
    total = 0.0
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(images, bounds)
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / n * 1e3


def links(torch, n_cards: int) -> dict:
    """What joins the cards: peer access between each pair, a 256 MiB copy
    cuda:0 → cuda:1 and a pinned host → cuda:1 copy in GB/s (NVLink moves
    hundreds, PCIe tens), and ``nvidia-smi nvlink --status``."""
    nbytes = 1 << 28
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda:0")
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda:1")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    peer_ms = cuda_ms(lambda: dst.copy_(src), 10)
    with torch.cuda.device(1):
        h2d_ms = cuda_ms(lambda: dst.copy_(host, non_blocking=True), 10)
    smi = subprocess.run(["nvidia-smi", "nvlink", "--status"],
                         capture_output=True, text=True, timeout=60)
    return {"peer_access": [[i == j or torch.cuda.can_device_access_peer(
                i, j) for j in range(n_cards)] for i in range(n_cards)],
            "peer_copy_gb_s": nbytes / peer_ms / 1e6,
            "h2d_pinned_gb_s": nbytes / h2d_ms / 1e6,
            "nvlink_status": (smi.stdout or smi.stderr)[-3000:]}


def multi_gpu(torch, record, card, launches, open_window, close_window):
    """14. Multi-GPU on the cards: ``make_mesh()`` (every visible card)
    and ``two_shards_one_card`` (``Mesh([cuda:0, cuda:0])``). On one card
    ``make_mesh()`` is one shard, and each case that needs two cards or
    more prints that it could not run, and why (``not_run`` in the
    record). Every case records its devices. A gate that fails is printed
    at once and the phase fails at its end, after every case has run (an
    error still stops it). (a) the data-parallel detect step (YOLOv7-tiny,
    trained fixture, 640 px, batch 64, bf16) over each mesh: detections
    against the single-device step (one shard: bit-equal; more:
    ``detection_deltas`` within ``DP_SCORE_MAX``, ``DP_BOX_MAX``), NMS
    launches = shards × steps, ms a step and host syncs a step; turnkey
    int8 under each mesh must reach ``int8``, every shard running the
    epilogue kernel, the two-shard int8 step held to the one over
    ``make_mesh()`` as the float steps are; with two cards or more, the
    float and int8 steps over ``make_mesh()`` against one card at the same
    global batch, at ``B`` and at ``DP_PER_CARD_B`` tiles a card; (b) the
    upload ring over one device's step and each mesh's (detections equal,
    tolerance 0, to the step called per batch; ms a batch), and ``CarDetector`` scans of phase 10b's
    FakeWorld: ``data_parallel: true`` bit-equal to one card's scan over
    the same shards (``Mesh([cuda:0] × cards)``, with one card the
    single-device scan) and, with several cards, matching the
    single-device scan as the two-shard scan must; over 11b's AOI, the
    two-shard step injected with the dedup off (its records deduped
    matching the single-device scan's at ``DP_SCAN_MATCH`` within 0.5 m);
    (c) ``detect --data-parallel`` and ``serve --data-parallel`` as
    counted children (every card), equal to the same run in this process
    (the scan bit-equal; the served records within 1e-7° and 1e-3 of
    confidence, as concurrent requests may batch otherwise); (d)
    ``halo_dedup_host`` over each mesh at ``k_slots`` 4096 on (b)'s raw
    records of 11b's AOI, equal to ``dedup_host``, timed; (e)
    torch.distributed, each process's mesh from ``make_mesh()`` (its one
    card): a world of one on NCCL, then, with two cards or more, a world
    of every card on NCCL (one process a card), on one card two
    processes sharing it over gloo, running 13a's fine-tune as a
    data-parallel train step for ``DIST_STEPS`` steps: parameters
    bit-equal between the processes, within 2·lr a step of one process on
    the global batch, losses within rtol 1e-3; with two cards or more, a
    stripe scan: a process a card on NCCL, each scanning its stripe of
    10b's AOI (``stripe_tiles``, inside its ``host_stripe``) with the
    dedup off, this process serving the tiles and merging: the stripes'
    tiles add up to the single scan's, their raw records are the single
    scan's as a set, bit for bit, and ``merge_host_detections`` equals
    ``dedup_records`` of the single scan; (f) the in-process
    data-parallel train step for YOLOv8l at the train verb's defaults
    (768 px, batch 8, ``batch`` BN; seeded unit-variance weights) over
    two shards of one card and, with two cards or more, over
    ``make_mesh()``, against the single-device step with its BN
    statistics in f64 (``f64_bn_statistics``): loss within rtol 1e-4,
    running statistics within ``TRAIN_GRAD_LIMIT``, each gradient leaf no
    further from it than the plain f32 single-device step is plus
    ``TRAIN_GRAD_LIMIT`` of the leaf's largest (the plain step's distance
    recorded); remat over each mesh against the step without it (loss
    and statistics within 1e-6, gradients within ``TRAIN_GRAD_LIMIT``),
    each step timed, over ``make_mesh()`` also at ``DP_TRAIN_PER_CARD``
    rows a card beside one card at that global batch; (g) spatial
    inference (``make_spatial_detect``: the trunk's rows over each mesh
    and over four shards of cuda:0, halos gathered from the neighbouring
    shards; the float bundle and (a)'s int8 one) on phase 4's batch
    against the unsharded detect function (float as in (a), int8
    bit-equal), the gathers counted (only the heads' permutes), timed."""
    import shutil
    import socket
    import tempfile
    import numpy as np
    from aerial_image_recognition_tpu_torch.fetch.fake import (
        FakeTileServer, FakeWorld)
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        requantize)
    from aerial_image_recognition_tpu_torch.parallel.mesh import (
        Mesh, make_mesh)
    from aerial_image_recognition_tpu_torch.parallel.stripes import (
        halo_dedup_host)
    from aerial_image_recognition_tpu_torch.pipeline.cli import (
        _overrides, build_parser)
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step, detection_sets_agree)
    from aerial_image_recognition_tpu_torch.pipeline.serve import (
        DetectionServer)
    from aerial_image_recognition_tpu_torch.post.dedup import dedup_host
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    base = os.path.join(ROOT, "chiprun_out", "multi_gpu")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    n_cards = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    rec = record["multi_gpu"] = {"cards": n_cards, "card": card,
                                 "nvidia_smi": smi, "not_run": {}}
    print(f"14. multi-GPU: {n_cards} card(s) visible: {smi}", flush=True)
    if n_cards >= 2:
        rec["links"] = links(torch, n_cards)
        print(f"14. links: peer access {rec['links']['peer_access']}, "
              f"cuda:0 → cuda:1 {rec['links']['peer_copy_gb_s']:.1f} GB/s, "
              f"pinned host → cuda:1 {rec['links']['h2d_pinned_gb_s']:.1f} "
              f"GB/s; nvidia-smi nvlink: "
              f"{rec['links']['nvlink_status'][:300]!r}", flush=True)
    failures = []

    def gate(ok, msg):
        """A gate of this phase: a failure is printed now and fails the
        phase at its end."""
        if not ok:
            print(f"chip_smoke: FAILED (phase 14 goes on): {msg}",
                  file=sys.stderr, flush=True)
            failures.append(msg)
        return ok

    def not_run(case, why):
        rec["not_run"][case] = why
        print(f"{case}: not run: {why} [{card}]", flush=True)

    def names(mesh):
        return [str(d) for d in mesh.devices]

    one_card = f"needs two cards or more; {n_cards} visible"
    meshes = {"cards": make_mesh(),
              "two_shards_one_card": Mesh(["cuda:0", "cuda:0"])}
    rng = np.random.default_rng(1)
    images, bounds, cars = render_tiles(rng, B, SIZE)
    cfg = dict(params_path=FIXTURE, device_batch=B, dtype="bfloat16")

    # (a) the DP detect step against the single-device step
    single = build_detect_step(DetectorConfig.from_dict(cfg))
    dev_images = torch.from_numpy(images).cuda()
    dev_bounds = torch.from_numpy(bounds).cuda()
    ref, single_ms = timed_steps(torch, single, images, bounds, DP_TIMED)
    _, single_dev_ms = timed_steps(torch, single, dev_images, dev_bounds,
                                   DP_TIMED)
    single_syncs = host_syncs_in_one_step(torch, single, dev_images,
                                          dev_bounds)
    single_issue = issue_ms(torch, single, dev_images, dev_bounds)
    rec["14a"] = {"single": {"devices": names(single.mesh),
                             "step_ms_host_input": single_ms,
                             "step_ms_device_input": single_dev_ms,
                             "issue_ms_device_input": single_issue,
                             "host_syncs": len(single_syncs)}}
    dp_steps = {}
    for label, mesh in meshes.items():
        shards = mesh.local_size
        step = build_detect_step(DetectorConfig.from_dict(cfg), mesh=mesh)
        dp_steps[label] = step
        gate([d for d, _, _ in step.input_shardings] == list(mesh.devices),
             f"14a {label}: shardings {step.input_shardings}")
        parts = step.place(images, bounds)
        path = f"dp_{label}"
        open_window()
        out, ms = timed_steps(torch, step, images, bounds, DP_TIMED)
        _, dev_ms = timed_steps(torch, step, *parts, DP_TIMED)
        close_window(path, ["nms_suppress"])
        steps_run = 2 * (DP_TIMED + 1)
        gate(launches[path]["nms_suppress"] == shards * steps_run,
             f"14a {label}: {launches[path]['nms_suppress']} NMS launches "
             f"in {steps_run} steps of {shards} shards")
        syncs = host_syncs_in_one_step(torch, step, *parts)
        gate(not syncs, f"14a {label}: host syncs in a step {syncs[:2]}")
        issue = issue_ms(torch, step, *parts)
        check_output(torch, f"14a {label}", out)
        _, agree = detection_sets_agree(out, ref)
        deltas = detection_deltas(out, ref)
        equal = same_detections(torch, out, ref)
        gate(equal if shards == 1 else
             held_to(deltas, DP_SCORE_MAX, DP_BOX_MAX),
             f"14a {label}: against the single-device step {deltas}, "
             f"equal {equal}")
        rec["14a"][label] = {
            "devices": names(mesh), "shards": shards,
            "step_ms_host_input": ms, "step_ms_device_input": dev_ms,
            "issue_ms_device_input": issue,
            "tiles_per_s_host_input": B / ms * 1e3,
            "slower_than_single_device_input": dev_ms / single_dev_ms,
            "nms_launches": launches[path]["nms_suppress"],
            "host_syncs": len(syncs), "host_sync_messages": syncs[:4],
            "agree_single": agree, "deltas_single": deltas,
            "equal_single": equal}
        print(f"14a {label} ({shards} shard(s) on {names(mesh)}): "
              f"{ms:.2f} ms a step (host input), {dev_ms:.2f} with the "
              f"shards' rows on their devices, against {single_ms:.2f} / "
              f"{single_dev_ms:.2f} for one device; the host issues a "
              f"step in {issue:.2f} ms (one device {single_issue:.2f}); "
              f"{len(syncs)} host syncs a step (one device: "
              f"{len(single_syncs)}); "
              f"{launches[path]['nms_suppress']} NMS launches in "
              f"{steps_run} steps; against one device {agree}, {deltas}, "
              f"equal {equal} [{card}]", flush=True)

        # turnkey int8 under the mesh
        q = build_detect_step(DetectorConfig.from_dict(
            dict(cfg, quantize="int8")), mesh=mesh)
        qpath = f"dp_int8_{label}"
        open_window()
        states = []
        for _ in range(2):
            states.append(q.quantize_state)
            q(images, bounds)
        states.append(q.quantize_state)
        if states != ["calibrating", "calibrating", "int8"]:
            fail(f"14a int8 {label}: states {states}, "
                 f"{q.fallback_reason}")
        before = requantize.launches
        q_out, q_ms = timed_steps(torch, q, images, bounds, DP_TIMED)
        close_window(qpath, ["nms_suppress", "int8_epilogue"])
        per_step = (requantize.launches - before) / (DP_TIMED + 1)
        gate(per_step == int8_epilogues_a_forward(q) * shards
             and q.input_shardings == step.input_shardings,
             f"14a int8 {label}: {per_step} epilogue launches a step over "
             f"{shards} shards, shardings {q.input_shardings}")
        ok_q, agree_q = detection_sets_agree(ref, q_out)
        gate(ok_q, f"14a int8 {label}: against the bf16 step {agree_q}")
        # the int8 steps of the two meshes calibrated on the same batches:
        # the same qparams, so they are held to each other as the float
        # steps are to the single-device step
        if label == "cards":
            q_ref, q_bundle = q_out, q.bundle
            q_deltas = None
        else:
            q_deltas = detection_deltas(q_out, q_ref)
            gate(held_to(q_deltas, DP_SCORE_MAX, DP_BOX_MAX),
                 f"14a int8 {label}: against the int8 step over "
                 f"make_mesh() {q_deltas}")
        rec["14a"][label]["int8"] = {
            "states": states, "parity": q.parity, "step_ms_host_input": q_ms,
            "epilogue_launches_a_step": per_step,
            "nms_launches": launches[qpath]["nms_suppress"],
            "agree_bf16_single": agree_q, "deltas_int8_cards": q_deltas}
        print(f"14a int8 {label}: states {states}, {q_ms:.2f} ms a step, "
              f"{per_step:.0f} epilogue launches a step "
              f"({int8_epilogues_a_forward(q)} × {shards}), against the "
              f"bf16 step {agree_q}, against the "
              f"int8 step over make_mesh() {q_deltas} [{card}]", flush=True)
        del q
    if n_cards >= 2:
        rec["14a"]["against_one_card"] = {
            str(big): dp_against_one_card(
                torch, cfg, meshes["cards"], images, bounds, q_bundle, big,
                card, launches, open_window, close_window, gate)
            for big in (B, DP_PER_CARD_B * n_cards)}
    else:
        not_run(f"14a, float and int8, against one card at a global batch "
                f"of {B} and at {DP_PER_CARD_B} tiles a card", one_card)

    # (b) the ring over each mesh's step, then scans of 10b's world
    from aerial_image_recognition_tpu_torch.ingest.pipeline import (
        TileBatch, run_pipeline)
    batches = [TileBatch(np.arange(B) + k * B, np.roll(images, k, axis=0),
                         np.roll(bounds, k, axis=0), B) for k in range(4)]
    rings = {}
    for label, step in dict(single=single, **dp_steps).items():
        want = [readback(step(b.images, b.bounds)) for b in batches]
        got = []
        open_window()
        stats = run_pipeline(iter(batches), step,
                             lambda b, o: got.append(readback(o)))
        close_window(f"dp_ring_{label}", ["nms_suppress"])
        same = stats["batches"] == 4 and all(
            all(np.array_equal(x, y) for x, y in zip(g, w))
            for g, w in zip(got, want))
        gate(same, f"14b: the ring's detections over {label} differ from "
                   f"the step's")
        # a second pass, timed: the ring's buffers exist by now
        t0 = time.perf_counter()
        timed = run_pipeline(iter(batches), step, lambda b, o: readback(o))
        ring_ms = (time.perf_counter() - t0) / timed["batches"] * 1e3
        rings[label] = {"devices": names(step.mesh),
                        "batches": stats["batches"], "equal_step": same,
                        "ms_a_batch": ring_ms,
                        "h2d_s": timed["h2d_s"],
                        "compute_s": timed["compute_s"]}
    two = dp_steps["two_shards_one_card"]
    world = FakeWorld(**SCAN_WORLD)
    srv = FakeTileServer(world)
    srv.start()
    frame = aoi_frame(os.path.join(base, "aoi.geojson"), SCAN_AOI)
    scan_cfg = scan_config(srv.base_url, frame)
    fe_frame = aoi_frame(os.path.join(base, "fe_aoi.geojson"), FE_AOI)
    scans = {}
    # the single-device scan of 10b's world: 10b's own, where it ran
    single_dir = os.path.join(ROOT, "chiprun_out", "scan") \
        if "scan" in record else os.path.join(base, "single")
    same_shards = None
    if n_cards >= 2:
        # one card over the shards make_mesh() makes: the same arithmetic
        # as the data-parallel scan, on one card
        probe = CarDetector(os.path.join(base, "probe"), scan_cfg)
        same_shards = build_detect_step(
            probe._step_config(), batch=B, src_size=SIZE,
            mesh=Mesh(["cuda:0"] * n_cards))
    try:
        for name, extra, step in (
                ("single", {}, None),
                ("dp_cards", {"data_parallel": True}, None),
                ("cards_shards_one_card", {}, same_shards),
                ("fe_single", {"frame_path": fe_frame}, None),
                ("fe_two_shards_raw", {"frame_path": fe_frame,
                                       "duplicate_distance": 0.0}, two)):
            if name == "single" and "scan" in record:
                scans[name] = {"tiles": record["scan"]["tiles"],
                               "wall_s": record["scan"]["wall_s"],
                               "records": record["scan"]["detections"],
                               "devices": ["cuda:0"], "from": "10b"}
                continue
            if name == "cards_shards_one_card" and step is None:
                continue
            det = CarDetector(os.path.join(base, name),
                              dict(scan_cfg, **extra), detect_step=step)
            open_window()
            t0 = time.perf_counter()
            out = det.detect(force_restart=True)
            wall = time.perf_counter() - t0
            close_window(f"scan_{name}", ["nms_suppress"])
            scans[name] = {"tiles": out["tiles"], "wall_s": wall,
                           "tiles_per_s": out["tiles"] / wall,
                           "records": out["detections"],
                           "devices": names(det.last_step.mesh),
                           "shardings": None if det.last_step.input_shardings
                           is None else len(det.last_step.input_shardings)}
    finally:
        srv.stop()
    r_single, _ = scan_records(single_dir)
    r_dp = records_of(base, "dp_cards")
    gate(scans["dp_cards"]["shardings"] == n_cards,
         f"14b: the data_parallel scan ran over {scans['dp_cards']}")
    if n_cards == 1:
        r_same = r_single
        dp_vs_single = 1.0 if np.array_equal(r_single, r_dp) else 0.0
    else:
        r_same = records_of(base, "cards_shards_one_card")
        dp_vs_single = matched_within(r_single, r_dp, 0.5)
        gate(dp_vs_single >= DP_SCAN_MATCH and abs(len(r_dp)
             - len(r_single)) <= (1 - DP_SCAN_MATCH) * len(r_single),
             f"14b: the data_parallel scan's {len(r_dp)} records match "
             f"{dp_vs_single:.4f} of the single-device scan's "
             f"{len(r_single)}")
    dp_equal = np.array_equal(r_same, r_dp)
    gate(dp_equal, f"14b: the data_parallel scan over {n_cards} card(s) "
                   f"differs from one card's over the same shards")
    # 11b's AOI: its raw records fit one 4096-slot stripe (10b's AOI
    # gives ~9000, more than the two stripes of two shards hold)
    fe_single = records_of(base, "fe_single")
    raw = records_of(base, "fe_two_shards_raw")
    keep = dedup_host(raw[:, 0], raw[:, 1], raw[:, 2], 2.0)
    deduped = raw[keep]
    matched = matched_within(fe_single, deduped, 0.5)
    gate(matched >= DP_SCAN_MATCH and abs(len(deduped) - len(fe_single))
         <= (1 - DP_SCAN_MATCH) * len(fe_single),
         f"14b: the two-shard scan's {len(deduped)} deduped records "
         f"match {matched:.3f} of the single scan's {len(fe_single)}")
    rec["14b"] = {"rings": rings, "scans": scans,
                  "dp_cards_equal_same_shards_one_card": dp_equal,
                  "dp_cards_matched_single_0_5m": dp_vs_single,
                  "two_shards_matched_single_0_5m": matched}
    print(f"14b: ring over " + ", ".join(
              f"{k} {r['ms_a_batch']:.2f} ms a batch" for k, r in
              rings.items()) + f", every batch equal to the step; scans of {scans['single']['tiles']} tiles: single "
          f"{scans['single']['wall_s']:.2f} s, data_parallel over "
          f"{scans['dp_cards']['devices']} "
          f"{scans['dp_cards']['wall_s']:.2f} s "
          f"({scans['dp_cards']['tiles_per_s']:.1f} tiles/s), "
          f"{len(r_dp)} records, bit-equal to one card's over the same "
          f"shards {dp_equal}, matching {dp_vs_single:.4f} of the single "
          f"scan's {len(r_single)} within 0.5 m; 11b's AOI "
          f"({scans['fe_single']['tiles']} tiles) on two shards of one "
          f"card {scans['fe_two_shards_raw']['wall_s']:.2f} s, {len(raw)} "
          f"raw records, deduped {len(deduped)} matching {matched:.4f} of "
          f"the single scan's {len(fe_single)} within 0.5 m [{card}]",
          flush=True)

    # (d) the halo dedup over the two-shard scan's raw records
    d_rec = {}
    for label, mesh in meshes.items():
        halo_dedup_host(raw[:2, 0], raw[:2, 1], raw[:2, 2], SCAN_AOI, mesh,
                        radius_m=2.0, k_slots=8)            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        klon, klat, kconf = halo_dedup_host(
            raw[:, 0], raw[:, 1], raw[:, 2], SCAN_AOI, mesh, radius_m=2.0,
            k_slots=4096)
        ms = (time.perf_counter() - t0) * 1e3
        gate(len(kconf) == len(deduped) and np.allclose(
            np.sort(kconf), np.sort(deduped[:, 2]), rtol=1e-6, atol=0),
            f"14d {label}: halo dedup kept {len(kconf)}, dedup_host "
            f"{len(deduped)}")
        d_rec[label] = {"devices": names(mesh), "ms": ms,
                        "ms_a_shard": ms / mesh.local_size,
                        "kept": len(kconf), "input": len(raw),
                        "rounds_per_shard": 3 * 4096,
                        "shards": mesh.local_size}
        print(f"14d halo_dedup_host on {label} ({names(mesh)}), k_slots "
              f"4096: {len(raw)} records → {len(kconf)} kept, equal to "
              f"dedup_host, {ms:.1f} ms ({ms / mesh.local_size:.1f} a "
              f"shard) [{card}]", flush=True)
    rec["14d"] = d_rec

    # (c) detect and serve with --data-parallel as children
    srv = FakeTileServer(world)
    srv.start()
    try:
        argv = ["detect", "--base-dir", os.path.join(base, "cli_detect"),
                "--force-restart", "--data-parallel", "--frame", fe_frame,
                "--tile-size-meters", "320", "--tile-overlap", "0.25",
                "--params", FIXTURE, "--device-batch", str(B),
                "--batch-size", str(B), "--num-workers", "16",
                "--confidence-threshold", "0.4", "--duplicate-distance",
                "2.0", "--wms-url", srv.base_url + "/wms", "--wms-layer",
                "fake"]
        proc, wall, counts = run_verb(base, "detect_dp", argv)
        child_launches(launches, "cli_detect_dp", counts, ["nms_suppress"])
        ns = build_parser().parse_args(argv)
        CarDetector(os.path.join(base, "cli_detect_in_process"),
                    _overrides(ns)).detect(force_restart=True)
        got_c = records_of(base, "cli_detect")
        want_c = records_of(base, "cli_detect_in_process")
        gate(len(got_c) > 0 and np.array_equal(got_c, want_c),
             f"14c detect --data-parallel: {got_c.shape} records, "
             f"{want_c.shape} in process, not equal")
    finally:
        srv.stop()
    tiles_s = [world.render((SCAN_WORLD["center_lon"] + (k - 4) * 330 * M2LON
                             - 160 * M2LON, 52.2 - 160 * M2LAT,
                             SCAN_WORLD["center_lon"] + (k - 4) * 330 * M2LON
                             + 160 * M2LON, 52.2 + 160 * M2LAT), SIZE, SIZE)
               for k in range(8)]
    bnds_s = np.asarray([(SCAN_WORLD["center_lon"] + (k - 4) * 330 * M2LON
                          - 160 * M2LON, 52.2 - 160 * M2LAT,
                          SCAN_WORLD["center_lon"] + (k - 4) * 330 * M2LON
                          + 160 * M2LON, 52.2 + 160 * M2LAT)
                         for k in range(8)])

    def use(line):
        return post_jpegs(line["serving"], tiles_s, bnds_s, 8)

    line, replies, rc, s_counts = serve_child(
        base, "serve_dp", ["serve", "--port", "0", "--params", FIXTURE,
                           "--batch", "8", "--max-wait-ms", "20",
                           "--data-parallel"], use)
    child_launches(launches, "cli_serve_dp", s_counts, ["nms_suppress"])
    in_proc = DetectionServer({"params_path": FIXTURE, "device_batch": 8,
                               "confidence_threshold": 0.3,
                               "data_parallel": True},
                              max_wait_ms=20.0).start()
    try:
        want_s = post_jpegs(in_proc.url, tiles_s, bnds_s, 8)
    finally:
        in_proc.stop()
    key = [sorted((d["lon"], d["lat"], d["confidence"])
                  for d in body["detections"]) for _, body in replies]
    key_w = [sorted((d["lon"], d["lat"], d["confidence"])
                    for d in body["detections"]) for _, body in want_s]
    # concurrent requests may batch differently in the two servers: a
    # tile's records are held within 1e-7° and 1e-3 of confidence, and
    # exact equality is recorded
    close = all(len(a) == len(b) and (not a or bool((np.abs(
        np.asarray(a) - np.asarray(b)).max(axis=0)
        <= [1e-7, 1e-7, 1e-3]).all())) for a, b in zip(key, key_w))
    gate(rc == 0 and close and any(key),
         f"14c serve --data-parallel: exit {rc}, replies close to the "
         f"in-process server's {close}")
    rec["14c"] = {"devices": names(meshes["cards"]),
                  "detect_wall_s": wall, "detect_records": len(got_c),
                  "serve_equal_in_process": key == key_w,
                  "detect_launches": counts, "serve_address": line,
                  "serve_counts": [b["count"] for _, b in replies],
                  "serve_launches": s_counts}
    print(f"14c: detect --data-parallel ({wall:.1f} s, {len(got_c)} "
          f"records, launches {counts}) and serve --data-parallel (8 JPEG "
          f"POSTs, exit {rc} after SIGINT, launches {s_counts}) equal to "
          f"the same runs in this process, over {names(meshes['cards'])} "
          f"[{card}]", flush=True)

    # (e) torch.distributed
    def free_port():
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    def processes(label, backend, world_n, mode, *args):
        """``world_n`` DIST_CHILD processes of ``mode`` on one fresh
        address: (their JSON reports, their output files, wall s). Their
        output goes to ``<base>/<label>_<rank>.log`` and ``.err``; when
        one fails the others are ended at once (they would wait for it in
        their next collective), and the phase fails naming it."""
        coord = f"127.0.0.1:{free_port()}"
        ext = "npz" if mode == "train" else "json"
        outs = [os.path.join(tmp, f"{label}_{r}.{ext}")
                for r in range(world_n)]
        logs = [os.path.join(base, f"{label}_{r}") for r in range(world_n)]
        env = dict(os.environ, NCCL_DEBUG="WARN")
        procs = []
        t0 = time.perf_counter()
        try:
            for r in range(world_n):
                with open(logs[r] + ".log", "w") as so, \
                        open(logs[r] + ".err", "w") as se:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", DIST_CHILD, coord, str(r),
                         str(world_n), backend, outs[r], mode, *args],
                        cwd=ROOT, env=env, stdout=so, stderr=se))
            while any(p.poll() is None for p in procs) \
                    and all(p.poll() in (None, 0) for p in procs) \
                    and time.perf_counter() - t0 < 300:
                time.sleep(0.2)
        finally:
            ended = [p.poll() for p in procs]
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        # a process that exited in error first, then one still running
        for r in sorted(range(world_n), key=lambda r: ended[r] is None):
            rc = ended[r]
            if rc != 0:
                with open(logs[r] + ".err") as f:
                    err = f.read()
                fail(f"14e {label}: process {r} "
                     f"{'still running' if rc is None else f'exit {rc}'} "
                     f"after {wall:.0f} s: {err[-1500:]}")
        reports = []
        for r in range(world_n):
            with open(logs[r] + ".log") as f:
                reports.append(last_json(f.read()))
        return reports, outs, wall

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        single_params, single_losses, single_ms = dist_train(
            torch, None, torch.device("cuda", 0), 0, 1)
        e_rec = {"single": {"devices": ["cuda:0"], "losses": single_losses,
                            "step_ms": single_ms}}
        runs = [("nccl_world_of_one", "nccl", 1)]
        if n_cards >= 2:
            runs.append(("nccl_world_of_cards", "nccl", n_cards))
        else:
            runs.append(("gloo_two_processes_one_card", "gloo", 2))
            not_run("14e a world of every card on NCCL", one_card +
                    " (NCCL refuses two ranks on one card)")
        for label, backend, world_n in runs:
            reports, outs, wall = processes(label, backend, world_n, "train")
            params = [dict(np.load(o)) for o in outs]
            differ = [k for other in params[1:]
                      for k, v in params[0].items()
                      if not np.array_equal(v, other[k])]
            gate(not differ, f"14e {label}: processes differ at "
                             f"{differ[:3]}")
            worst, far = params_within(params[0], single_params,
                                       DIST_STEPS)
            losses_ok = np.allclose(reports[0]["losses"], single_losses,
                                    rtol=1e-3, atol=0)
            gate(losses_ok, f"14e {label}: losses {reports[0]['losses']} "
                            f"against {single_losses}")
            gate(all(r["sums_equal"] for r in reports)
                 and {r["backend"] for r in reports} == {backend}
                 and len({r["device"] for r in reports})
                 == (world_n if backend == "nccl" else 1),
                 f"14e {label}: {reports}")
            e_rec[label] = {"reports": reports, "wall_s": wall,
                            "devices": [r["device"] for r in reports],
                            "max_abs_vs_single": worst,
                            "frac_beyond_1e-6": far}
            print(f"14e {label}: {world_n} process(es) on {backend}, "
                  f"devices {[r['device'] for r in reports]}, {DIST_STEPS} "
                  f"steps of 13a's fine-tune (global batch {DIST_B}): "
                  f"params bit-equal across processes {not differ}, within "
                  f"{worst:.2e} of one process ({far:.4f} beyond 1e-6); "
                  f"losses {reports[0]['losses']}, step ms "
                  f"{[round(r['step_ms'], 1) for r in reports]} against "
                  f"{single_ms:.1f} in one process; {wall:.1f} s of wall "
                  f"[{card}]", flush=True)
        if n_cards >= 2:
            e_rec["stripe_scan"] = stripe_scan(processes, base, n_cards,
                                               gate, card)
        else:
            not_run("14e the NCCL stripe scan", one_card +
                    " (NCCL refuses two ranks on one card)")
        rec["14e"] = e_rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (f) the in-process DP train step, YOLOv8l at the verb's defaults
    rec["14f"] = dp_train(torch, meshes, card, gate, not_run, one_card)

    # (g) spatial: one batch's rows over the meshes, at phase 4's width,
    # the float bundle and (a) int8 one; the rows meet only at the heads'
    # NHWC permutes (the float trunk's; the int8 trunk's taps are joined
    # by the spatial module itself): every other gather is a failure
    from aerial_image_recognition_tpu_torch.parallel import spatial as SP
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        make_detect_fn)
    sp_cfg = DetectorConfig.from_dict(cfg)
    # four slabs of 160 rows: on one card too, the float sums of a slab
    # round otherwise than the whole image's
    sp_meshes = dict(meshes, four_shards_one_card=Mesh(["cuda:0"] * 4))
    g_rec = {}
    gathered = []
    real_gathered = SP._gathered

    def counted(func, args, kwargs):
        gathered.append(getattr(func, "__name__", str(func)))
        return real_gathered(func, args, kwargs)

    SP._gathered = counted
    try:
        for kind, sp_bundle in (("float", single.bundle),
                                ("int8", q_bundle)):
            plain = make_detect_fn(sp_bundle, sp_cfg)
            sp_ref, plain_ms = timed_steps(torch, plain, dev_images,
                                           dev_bounds, DP_TIMED)
            g_rec[kind] = {"plain_ms_device_input": plain_ms}
            for label, mesh in sp_meshes.items():
                fn = SP.make_spatial_detect(sp_bundle, sp_cfg, mesh)
                path = f"spatial_{kind}_{label}"
                shards = mesh.local_size
                gathered.clear()
                open_window()
                sp_out, sp_ms = timed_steps(torch, fn, dev_images,
                                            dev_bounds, DP_TIMED)
                close_window(path, ["nms_suppress"] + (
                    ["int8_epilogue"] if kind == "int8" else []))
                epilogues = launches[path]["int8_epilogue"]
                want_epi = TRUNK_CONVS * shards * (DP_TIMED + 1) \
                    if kind == "int8" else 0
                gate(launches[path]["nms_suppress"] == DP_TIMED + 1
                     and epilogues == want_epi,
                     f"14g {kind} {label}: "
                     f"{launches[path]['nms_suppress']} NMS and "
                     f"{epilogues} epilogue launches in {DP_TIMED + 1} "
                     f"steps of {shards} shards")
                gate(not set(gathered) - {"permute"},
                     f"14g {kind} {label}: gathered whole at "
                     f"{sorted(set(gathered))}")
                check_output(torch, f"14g {kind} {label}", sp_out)
                _, agree = detection_sets_agree(sp_out, sp_ref)
                deltas = detection_deltas(sp_out, sp_ref)
                equal = same_detections(torch, sp_out, sp_ref)
                # the int8 trunk is integer from the stems' P2 codes on,
                # and the stems run whole: bit-equal on any mesh
                gate(equal if shards == 1 or kind == "int8" else
                     held_to(deltas, DP_SCORE_MAX, DP_BOX_MAX),
                     f"14g {kind} {label}: against the unsharded "
                     f"function {deltas}, equal {equal}")
                g_rec[kind][label] = {
                    "devices": names(mesh),
                    "shards": shards, "step_ms_device_input": sp_ms,
                    "slower_than_plain": sp_ms / plain_ms,
                    "gathers_a_step": len(gathered) / (DP_TIMED + 1),
                    "epilogue_launches": epilogues,
                    "agree_plain": agree, "deltas_plain": deltas,
                    "equal_plain": equal}
                print(f"14g spatial {kind} {label} ({shards} shard(s) of "
                      f"the rows on {names(mesh)}): {sp_ms:.2f} ms a batch "
                      f"of {B} against {plain_ms:.2f} unsharded; "
                      f"{len(gathered) / (DP_TIMED + 1):.0f} gathers a "
                      f"step, all at the heads' permute; {epilogues} "
                      f"epilogue launches; against it {agree}, {deltas}, "
                      f"equal {equal} [{card}]", flush=True)
    finally:
        SP._gathered = real_gathered
    rec["14g"] = g_rec
    if failures:
        fail(f"phase 14: {len(failures)} gate(s) failed: "
             + "; ".join(failures))


def dp_against_one_card(torch, cfg, mesh, images, bounds, q_bundle, big,
                        card, launches, open_window, close_window, gate):
    """14a at a global batch of ``big`` tiles: the float step and the int8
    step (``q_bundle``, (a)'s qparams) over ``mesh`` against the same step
    on one card at that batch (phase 4's tiles, rolled), timed on host and
    device input, issue ms, host syncs and launches counted, the
    detections held as in (a)."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        requantize)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    reps = big // B
    im = np.concatenate([np.roll(images, k, axis=0) for k in range(reps)])
    bd = np.concatenate([np.roll(bounds, k, axis=0) for k in range(reps)])
    per_card = big // mesh.local_size
    out = {"global_batch": big, "per_card": per_card}
    for kind, extra, bundle in (("float", {}, None),
                                ("int8", {"quantize": "int8"}, q_bundle)):
        c = DetectorConfig.from_dict(dict(cfg, device_batch=big, **extra))
        one = build_detect_step(c, bundle=bundle, device="cuda:0")
        dp = build_detect_step(c, bundle=bundle, mesh=mesh)
        res = {}
        for label, step in (("one_card", one), ("cards", dp)):
            parts = step.place(im, bd)
            path = f"dp_{big}_{kind}_{label}"
            open_window()
            before = requantize.launches
            o, ms = timed_steps(torch, step, im, bd, DP_TIMED)
            _, dev_ms = timed_steps(torch, step, *parts, DP_TIMED)
            close_window(path, ["nms_suppress"] + (
                ["int8_epilogue"] if kind == "int8" else []))
            shards = step.mesh.local_size
            steps_run = 2 * (DP_TIMED + 1)
            nms = launches[path]["nms_suppress"]
            epi = (requantize.launches - before) / steps_run
            # one epilogue a conv a shard; on one card the 256-row batch
            # makes its largest im2cols in chunks, an epilogue a chunk
            want_epi = int8_epilogues_a_forward(step) * shards \
                if kind == "int8" else 0
            gate(nms == shards * steps_run and (
                epi == want_epi if shards > 1 else epi >= want_epi),
                 f"14a {kind} at {big}, {label}: {nms} NMS launches, "
                 f"{epi} epilogue launches a step over {shards} shards")
            syncs = host_syncs_in_one_step(torch, step, *parts)
            gate(kind == "int8" or not syncs,
                 f"14a {kind} at {big}, {label}: host syncs {syncs[:2]}")
            issue = issue_ms(torch, step, *parts)
            check_output(torch, f"14a {kind} at {big}, {label}", o, big)
            res[label] = {"devices": [str(d) for d in step.mesh.devices],
                          "step_ms_host_input": ms,
                          "step_ms_device_input": dev_ms,
                          "issue_ms_device_input": issue,
                          "tiles_per_s_device_input": big / dev_ms * 1e3,
                          "nms_launches": nms,
                          "epilogue_launches_a_step": epi,
                          "host_syncs": len(syncs), "out": o}
        deltas = detection_deltas(res["cards"].pop("out"),
                                  res["one_card"].pop("out"))
        gate(held_to(deltas, DP_SCORE_MAX, DP_BOX_MAX),
             f"14a {kind} at {big}: cards against one card {deltas}")
        res["deltas_one_card"] = deltas
        res["speedup_device_input"] = (res["one_card"]["step_ms_device_input"]
                                       / res["cards"]["step_ms_device_input"])
        out[kind] = res
        print(f"14a {kind} at {big} tiles ({per_card} a card over "
              f"{res['cards']['devices']}): "
              f"{res['cards']['step_ms_host_input']:.2f} ms host input / "
              f"{res['cards']['step_ms_device_input']:.2f} device input "
              f"against one card's {res['one_card']['step_ms_host_input']:.2f}"
              f" / {res['one_card']['step_ms_device_input']:.2f} "
              f"({res['speedup_device_input']:.2f}×); issued in "
              f"{res['cards']['issue_ms_device_input']:.2f} / "
              f"{res['one_card']['issue_ms_device_input']:.2f} ms; host syncs "
              f"{res['cards']['host_syncs']}; launches NMS "
              f"{res['cards']['nms_launches']}, epilogue "
              f"{res['cards']['epilogue_launches_a_step']:.0f} a step; "
              f"against one card {deltas} [{card}]", flush=True)
        del one, dp
        torch.cuda.empty_cache()
    return out


def stripe_scan(processes, base, n_cards, gate, card):
    """14e's stripe scan: ``n_cards`` NCCL processes, a card each, scan
    their stripes of 10b's AOI (``dist_scan``) from a FakeTileServer in
    this process; this process scans the whole AOI on cuda:0 with the
    dedup off and merges the stripes (``merge_host_detections``)."""
    from aerial_image_recognition_tpu_torch.fetch.fake import (
        FakeTileServer, FakeWorld)
    from aerial_image_recognition_tpu_torch.gio.geojson import (
        feature_collection_to_detections, read_geojson)
    from aerial_image_recognition_tpu_torch.parallel.distributed import (
        merge_host_detections)
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    from aerial_image_recognition_tpu_torch.post.dedup import dedup_records
    srv = FakeTileServer(FakeWorld(**SCAN_WORLD))
    srv.start()
    try:
        frame = aoi_frame(os.path.join(base, "stripe_aoi.geojson"),
                          SCAN_AOI)
        reports, outs, wall = processes("nccl_stripe_scan", "nccl",
                                        n_cards, "scan", srv.base_url,
                                        frame)
        det = CarDetector(os.path.join(base, "stripe_single"),
                          scan_config(srv.base_url, frame,
                                      duplicate_distance=0.0))
        t0 = time.perf_counter()
        summary = det.detect(force_restart=True)
        single_wall = time.perf_counter() - t0
    finally:
        srv.stop()
    parts = [json.load(open(o)) for o in outs]
    single_raw = feature_collection_to_detections(
        read_geojson(summary["output"]))
    all_recs = [r for p in parts for r in p["records"]]

    def key(recs):
        return sorted((r["lon"], r["lat"], r["confidence"]) for r in recs)

    tiles = [p["tiles"] for p in parts]
    merged = merge_host_detections(all_recs, radius_m=2.0)
    single = dedup_records(single_raw, radius_m=2.0)
    counts = [len(p["records"]) for p in parts]
    raw_equal = key(all_recs) == key(single_raw)
    merge_equal = key(merged) == key(single)
    gate(sum(tiles) == summary["tiles"] and all(t > 0 for t in tiles),
         f"14e stripe scan: stripes of {tiles} tiles against the single "
         f"scan's {summary['tiles']}")
    gate(all(p["counts_allgather"] == counts for p in parts),
         f"14e stripe scan: allgathered counts {parts[0]['counts_allgather']}"
         f" against {counts}")
    gate(raw_equal, f"14e stripe scan: {len(all_recs)} raw records, the "
                    f"single scan {len(single_raw)}, not equal as sets")
    gate(merge_equal and len(merged) < len(all_recs),
         f"14e stripe scan: merged {len(merged)}, the single scan deduped "
         f"{len(single)}")
    out = {"devices": [r["device"] for r in reports],
           "backend": sorted({r["backend"] for r in reports}),
           "tiles": tiles, "single_tiles": summary["tiles"],
           "records": counts, "single_records": len(single_raw),
           "raw_equal": raw_equal, "merged": len(merged),
           "merge_equal_single_dedup": merge_equal,
           "host_stripes": [p["host_stripe"] for p in parts],
           "process_walls_s": [p["wall_s"] for p in parts],
           "wall_s": wall, "single_wall_s": single_wall}
    print(f"14e stripe scan: {n_cards} processes on NCCL over "
          f"{out['devices']}, stripes of {tiles} tiles (single "
          f"{summary['tiles']}), raw records {counts} equal to the single "
          f"scan's {len(single_raw)} as a set {raw_equal}, merged "
          f"{len(merged)} equal to its dedup {merge_equal}; {wall:.1f} s "
          f"of wall for the processes (each scan "
          f"{[round(w, 2) for w in out['process_walls_s']]} s) against "
          f"{single_wall:.2f} s for one process's scan [{card}]",
          flush=True)
    return out


def dp_train(torch, meshes, card, gate, not_run, one_card):
    """14f: YOLOv8l's data-parallel train step (768 px, batch 8, batch
    BN) over two shards of one card and, with two cards or more, over
    ``make_mesh()``, against the single-device step with its BN
    statistics in f64; remat over each mesh; timed, over the cards also
    at ``DP_TRAIN_PER_CARD`` rows a card beside one card at that global
    batch."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.models.weights import (
        grads_to_flax)
    from aerial_image_recognition_tpu_torch.pipeline import train as T
    rng = np.random.default_rng(14)
    tiles, tb, tc = render_tiles(rng, V8L_B, V8L_SIZE)
    batch = next(iter(memory_loader(
        tiles, tile_targets(tb, tc, V8L_SIZE), V8L_B, False, mosaic=0.0,
        mixup=0.0, hsv=0.0).epoch(0)))
    tree = unit_variance_tree(torch, "yolov8_tokyo", tiles[:, :SIZE, :SIZE])
    bundle = create_model("yolov8_tokyo", dtype=torch.float32,
                          variables=tree, device="cuda:0")
    tx = T.make_optimizer(lr=TRAIN_LR)
    s0 = T.init_train_state(bundle, tx)
    one = T.make_train_step(bundle, tx)
    if one.bn_mode != "batch":
        fail("14f: yolov8 did not resolve to batch BN")
    # the witness: the single-device step with its BN statistics in f64
    # (f64_bn_statistics). Each mesh's step is held to it leaf by leaf as
    # the CPU tests hold theirs to the reference's f64 step: no further
    # from it than the plain f32 single-device step is, plus
    # TRAIN_GRAD_LIMIT of the leaf's largest
    with f64_bn_statistics(torch):
        lw, _, gw, bsw = one.loss_and_grads(s0, *batch)
    gw = grads_to_flax(gw)["params"]
    lp, _, gp, _ = one.loss_and_grads(s0, *batch)
    plain_rel = leaf_errors(grads_to_flax(gp)["params"], gw)
    del gp
    plain_loss_rel = abs(float(lp) - float(lw)) / abs(float(lw))
    _, ms1, _ = timed_train_steps(torch, one, s0, batch, 3, warmup=1)
    out = {"size": V8L_SIZE, "batch": V8L_B,
           "against": "single device, BN statistics in f64",
           "plain_f32_loss_rel": plain_loss_rel,
           "plain_f32_grad_max_rel": max(plain_rel.values()),
           "plain_f32_worst_leaf": max(plain_rel, key=plain_rel.get),
           "plain_f32_leaves_beyond_limit": sum(
               v > TRAIN_GRAD_LIMIT for v in plain_rel.values()),
           "leaves": len(plain_rel), "step_ms_single": ms1}
    labels = ["two_shards_one_card"]
    if meshes["cards"].local_size >= 2:
        labels.append("cards")
    else:
        not_run("14f over make_mesh()", one_card + " (make_mesh() is the "
                "single device, which is the witness's step)")
    for label in labels:
        mesh = meshes[label]
        step = T.make_train_step(bundle, tx, mesh=mesh)
        if step.bn_mode != "batch":
            fail(f"14f {label}: yolov8 did not resolve to batch BN")
        l2, _, g2, bs2 = step.loss_and_grads(s0, *batch)
        g_rel = leaf_errors(grads_to_flax(g2)["params"], gw)
        over = {k: v for k, v in g_rel.items()
                if v > plain_rel[k] + TRAIN_GRAD_LIMIT}
        # remat over the shards: recomputed in lockstep, the statistics
        # of the first forward kept
        lr_, _, gr, bsr = T.make_train_step(
            bundle, tx, mesh=mesh, remat=True).loss_and_grads(s0, *batch)
        remat_rel = max(leaf_errors(grads_to_flax(gr)["params"],
                                    grads_to_flax(g2)["params"]).values())
        remat_stats_equal = all(torch.equal(bsr[k], bs2[k]) for k in bs2)
        remat_stats_rel = max(float((bsr[k] - bs2[k]).abs().max())
                              / max(float(bs2[k].abs().max()), 1e-30)
                              for k in bs2)
        remat_loss_rel = abs(float(lr_) - float(l2)) / abs(float(l2))
        gate(remat_loss_rel <= 1e-6 and remat_stats_rel <= 1e-6
             and remat_rel <= TRAIN_GRAD_LIMIT,
             f"14f {label}: remat: loss {remat_loss_rel:.2e}, statistics "
             f"{remat_stats_rel:.2e}, gradients {remat_rel:.2e}")
        del gr
        bs_rel = max(float((bs2[k] - bsw[k]).abs().max())
                     / max(float(bsw[k].abs().max()), 1e-30) for k in bsw)
        loss_rel = abs(float(l2) - float(lw)) / abs(float(lw))
        worst = max(over, key=lambda k: over[k] - plain_rel[k]) \
            if over else None
        gate(loss_rel <= 1e-4 and not over and bs_rel <= TRAIN_GRAD_LIMIT,
             f"14f {label}: against the f64-statistics step: loss "
             f"{loss_rel:.2e}, {len(over)} gradient leaves further than "
             f"the plain step + {TRAIN_GRAD_LIMIT} (e.g. {worst}: "
             f"{over.get(worst)} against {plain_rel.get(worst)}), "
             f"statistics {bs_rel:.2e}")
        del g2
        _, ms2, losses2 = timed_train_steps(torch, step, s0, batch, 3,
                                            warmup=1)
        gate(all(math.isfinite(v) for v in losses2),
             f"14f {label}: losses {losses2}")
        out[label] = {
            "devices": [str(d) for d in mesh.devices],
            "shards": mesh.local_size, "loss_rel": loss_rel,
            "grad_max_rel_to_leaf_max": max(g_rel.values()),
            "grad_worst_leaf": max(g_rel, key=g_rel.get),
            "grad_leaves_beyond_limit": sum(
                v > TRAIN_GRAD_LIMIT for v in g_rel.values()),
            "stats_max_rel": bs_rel, "remat_grad_max_rel": remat_rel,
            "remat_loss_rel": remat_loss_rel,
            "remat_stats_equal": remat_stats_equal, "step_ms": ms2}
        print(f"14f yolov8l {V8L_SIZE} px, batch {V8L_B}, batch BN, "
              f"{label} ({[str(d) for d in mesh.devices]}) against one "
              f"device with its BN statistics in f64: loss "
              f"{loss_rel:.1e}, gradients within {max(g_rel.values()):.1e} "
              f"of each leaf's largest at {max(g_rel, key=g_rel.get)} "
              f"({out[label]['grad_leaves_beyond_limit']} of {len(g_rel)} "
              f"leaves beyond {TRAIN_GRAD_LIMIT}), statistics "
              f"{bs_rel:.1e}; the plain f32 step against the same: loss "
              f"{plain_loss_rel:.1e}, gradients "
              f"{max(plain_rel.values()):.1e} at "
              f"{max(plain_rel, key=plain_rel.get)} "
              f"({out['plain_f32_leaves_beyond_limit']} leaves beyond); "
              f"remat: loss {remat_loss_rel:.1e}, statistics equal "
              f"{remat_stats_equal}, gradients within {remat_rel:.1e}; "
              f"{ms2:.1f} ms a step against {ms1:.1f} [{card}]",
              flush=True)
        del step
    if "cards" in labels:
        # the per-card batch: DP_TRAIN_PER_CARD rows on each card, beside
        # one card at that global batch (where it fits)
        big = DP_TRAIN_PER_CARD * meshes["cards"].local_size
        tiles, tb, tc = render_tiles(np.random.default_rng(15), big,
                                     V8L_SIZE)
        big_batch = next(iter(memory_loader(
            tiles, tile_targets(tb, tc, V8L_SIZE), big, False, mosaic=0.0,
            mixup=0.0, hsv=0.0).epoch(0)))
        cards_step = T.make_train_step(bundle, tx, mesh=meshes["cards"])
        _, ms_cards, losses_c = timed_train_steps(torch, cards_step, s0,
                                                  big_batch, 3, warmup=1)
        gate(all(math.isfinite(v) for v in losses_c),
             f"14f cards at {big}: losses {losses_c}")
        del cards_step
        torch.cuda.empty_cache()
        try:
            _, ms_one, _ = timed_train_steps(torch, one, s0, big_batch, 3,
                                             warmup=1)
        except torch.cuda.OutOfMemoryError as e:
            ms_one = f"not measured: out of memory on one card ({e})"[:200]
        torch.cuda.empty_cache()
        out["per_card_batch"] = {
            "global_batch": big, "per_card": DP_TRAIN_PER_CARD,
            "step_ms_cards": ms_cards, "step_ms_one_card": ms_one,
            "images_per_s_cards": big / ms_cards * 1e3}
        print(f"14f yolov8l at {big} ({DP_TRAIN_PER_CARD} a card over "
              f"{len(meshes['cards'].devices)} cards): {ms_cards:.1f} ms a "
              f"step ({big / ms_cards * 1e3:.1f} images/s) against one "
              f"card's {ms_one if isinstance(ms_one, str) else f'{ms_one:.1f}'}"
              f" at that batch and {ms1:.1f} at {V8L_B} [{card}]",
              flush=True)
    del bundle, one, s0
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- 15. quad stem

STEM_CONVS = 2                 # the fully-int8 quad stem's convs (stem0 in
                               # the epilogue's border mode)
QUAD_TIMED = 10                # timed steps of each step in 15a


def int8_epilogues_a_forward(step) -> int:
    """Epilogue launches of one int8 forward of ``step``: the trunk's, and
    the fully-int8 stems' where the step takes the quad stem."""
    return TRUNK_CONVS + (STEM_CONVS if step.input_layout == "s2d2" else 0)


class BorderLaunches:
    """The epilogue wrapper's border-mode count (``requantize.
    border_launches``), zeroed and read by ``launch_window`` like a
    wrapper's ``launches``."""

    @property
    def launches(self):
        from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
            requantize)
        return requantize.border_launches

    @launches.setter
    def launches(self, n):
        from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
            requantize)
        requantize.border_launches = n


def stem_int8_inputs(torch, images):
    """The fully-int8 stem0 of the trained fixture at phase 4's shape:
    (its s32 sums on the card [B,160,160,128], the device constants). The
    calibration is the fixture's on 8 of the tiles."""
    from aerial_image_recognition_tpu_torch.models.int8 import (
        _device_stems, _quantize_stems, calibrate_absmax, conv_s32)
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.ops.quadstem import host_s2d2
    bundle = create_model(params_path=FIXTURE, dtype=torch.float32,
                          device="cuda")
    absmax = calibrate_absmax(bundle, [images[:8]])
    sq = _device_stems(_quantize_stems(bundle.variables, absmax),
                       bundle.device)
    del bundle
    xq = torch.from_numpy(host_s2d2(images)).cuda()
    r0 = conv_s32(torch.bitwise_xor(xq, 128).view(torch.int8), sq["w0"], 2)
    torch.cuda.synchronize()
    return r0, sq


def check_border_epilogue(torch, record, card, images):
    """15b: the epilogue's border mode against its plain version on the
    card at stem0's full shape (s32 [64·160·160, 128] → int8; leaky
    tolerance 0, silu within 1 LSB on <= 1e-4 as phase 8a holds it), and
    the CPU's codes; timed against the bytes bound (838.9 MB read, 209.7 MB
    written, 0.313 ms at 3.35 TB/s). Returns the kernel line's entry."""
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        _requantize_plain, requantize)
    r0, sq = stem_int8_inputs(torch, images)
    m, b, corr = sq["m0"], sq["b0"], sq["corr"]
    rows = {}
    max_err = 0
    before = requantize.launches, requantize.border_launches
    for act, inv in (("leaky", None), ("silu", 1.0)):
        got = requantize(r0, m, b, inv, act, corr=corr)
        plain = _requantize_plain(r0, m, b, inv, act, corr)
        lo = slice(0, 2)                  # the CPU on two tiles
        on_cpu = _requantize_plain(r0[lo].cpu(), m.cpu(), b.cpu(), inv, act,
                                   corr.cpu())
        torch.cuda.synchronize()
        share_p, max_p = codes_diff(torch, got, plain)
        share_c, max_c = codes_diff(torch, got[lo].cpu(), on_cpu)
        limit = 1e-4 if act == "silu" else 0.0
        if max(max_p, max_c) > 1 or max(share_p, share_c) > limit:
            fail(f"border epilogue {act}: kernel against plain differs in "
                 f"{share_p:.2e} of the codes (max {max_p}), against the "
                 f"CPU in {share_c:.2e} (max {max_c})")
        if float(got.float().std()) < 5.0:
            fail(f"border epilogue {act}: degenerate codes")
        # without the border term row 0 and column 0 change: the mode is
        # not a no-op
        no_border = requantize(r0, m, b, inv, act)
        if torch.equal(no_border[:, 0], got[:, 0]) \
                or torch.equal(no_border[:, :, 0], got[:, :, 0]):
            fail(f"border epilogue {act}: the border term changes nothing")
        max_err = max(max_err, max_p)
        rows[act] = {"differ_plain": share_p, "differ_cpu": share_c,
                     "max_abs": max(max_p, max_c)}
    if (requantize.launches - before[0],
            requantize.border_launches - before[1]) != (4, 2):
        fail("border epilogue: the wrapper's counts did not move as launched")
    ms = cuda_ms(lambda: requantize(r0, m, b, None, "leaky", corr=corr), 50)
    plain_ms = cuda_ms(lambda: _requantize_plain(r0, m, b, None, "leaky",
                                                 corr), 5, warmup=1)
    n = r0.numel()
    t_bytes = (n * 5 + 6 * r0.shape[-1] * 4) / HBM_BYTES_S * 1e3
    t_ops = n * 13 / F32_FLOPS * 1e3     # 5 for the border term, 8 else
    entry = {
        "name": "int8_epilogue_border", "route": "cuda",
        "source": "aerial_image_recognition_tpu_torch/csrc/int8_epilogue.cu",
        "replaces": "aerial_image_recognition_tpu/models/int8.py:657 "
                    "(_stems_int8's jnp chain fused by XLA; no TPU kernel)",
        "launches": 0, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "shape": [n // r0.shape[-1], r0.shape[-1]],
        "codes": rows}
    record["border_epilogue"] = entry
    print(f"int8_epilogue border mode: equal to plain on the card at "
          f"{entry['shape']} (leaky; silu differs on "
          f"{rows['silu']['differ_plain']:.1e}), and to the CPU on two "
          f"tiles; {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
          f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}) [{card}]",
          flush=True)
    del r0
    return entry


def stem_chain_ms(torch, step, dev_images):
    """(ms by CUDA events, torch.profiler's device time by kernel) of the
    step's stem chain alone, from the uint8 batch on the card to the P2
    feature: the quad stem on the packed batch, or the preprocess (cast,
    /255) and the two plain stems (``space_to_depth2`` before them for
    ``YOLOv7(s2d_stem=True)``)."""
    from aerial_image_recognition_tpu_torch.models.layers import (
        space_to_depth2)
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    bundle = step.bundle
    if step.input_layout == "s2d2":
        xq = step.pack_images(dev_images)
        stem = bundle.quad_stem()

        def chain():
            return stem(xq)
    else:
        module = bundle.module
        dtype = next(p.dtype for p in module.stem0.parameters())

        def chain():
            x = preprocess_batch(dev_images, out_size=SIZE, dtype=dtype)
            if getattr(module, "s2d_stem", False):
                x = space_to_depth2(x)
            return module.stem1(module.stem0(x))
    with torch.inference_mode():
        return cuda_ms(chain, 20), profile_calls(torch, chain, 3)


def check_current_device(torch, record, card):
    """15d: no kernel entry point leaves the calling thread's current
    device changed. With two cards or more each kernel launches on cuda:1
    while cuda:0 is current; with one the check cannot be made, and the
    script says so."""
    n = torch.cuda.device_count()
    if n < 2:
        record["current_device_check"] = (
            f"not possible on this machine: {n} card")
        print(f"current-device check: NOT POSSIBLE on this machine ({n} "
              f"card); it needs two [{card}]", flush=True)
        return
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops.clahe import (
        _luts_from_hist, _tile_histograms)
    from aerial_image_recognition_tpu_torch.ops.clahe_kernel import (
        apply_luts)
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        requantize)
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    torch.cuda.set_device(0)
    d1 = torch.device("cuda", 1)
    rng = np.random.default_rng(15)
    boxes_t, scores, classes = (torch.from_numpy(a).to(d1)
                                for a in nms_inputs(rng, "random", 2, 64))
    l8 = torch.from_numpy(lightness_levels(rng, 2, 64, 64)).to(d1)
    hist, (th, tw), n_px = _tile_histograms(l8, GRID)
    luts = _luts_from_hist(hist, CLIPS[0], n_px)[:, :, :, None]
    r = torch.randint(-1000, 1000, (2, 4, 4, 8), dtype=torch.int32,
                      device=d1)
    ones, zeros = (torch.ones(8, device=d1), torch.zeros(8, device=d1))
    launched = []
    nms_suppress(boxes_t, scores, classes, iou_threshold=0.45, max_det=16,
                 class_aware=False)
    launched.append(("nms_suppress", torch.cuda.current_device()))
    requantize(r, ones, zeros, None, "leaky")
    launched.append(("int8_epilogue", torch.cuda.current_device()))
    requantize(r, ones, zeros, None, "leaky",
               corr=torch.zeros(4, 8, device=d1))
    launched.append(("int8_epilogue_border", torch.cuda.current_device()))
    apply_luts(luts, l8, GRID[0], GRID[1], th, tw)
    launched.append(("clahe_apply", torch.cuda.current_device()))
    torch.cuda.synchronize(d1)
    moved = [k for k, dev in launched if dev != 0]
    if moved:
        fail(f"current-device check: {moved} left the current device "
             f"changed ({launched})")
    record["current_device_check"] = {k: dev for k, dev in launched}
    print(f"current-device check: every kernel launched on cuda:1 left "
          f"cuda:0 current ({launched}) [{card}]", flush=True)


def quad_stem_phase(torch, record, card, images, bounds, cars,
                    open_window, close_window, launches):
    """15a and 15c (15b and 15d run beside it, see ``check_border_
    epilogue`` and ``check_current_device``): the default step (the quad
    stem) against the same config with ``quad_stem: false`` at phase 4's
    shape, each timed with host input and with the batch on the card (the
    quad step also with its packed batch on the card, the ingest ring's
    form), the device ms split into the stem chain and the rest; the
    detections at phase 4's gates; the quad-stem P2 on the card against the
    CPU's; the host relayout of one batch, native and numpy."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops import quadstem as Q
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step, detection_sets_agree)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    from aerial_image_recognition_tpu_torch.utils import native
    rec = record.setdefault("quad_stem", {})
    base = dict(params_path=FIXTURE, device_batch=B, dtype="bfloat16")
    quad = build_detect_step(DetectorConfig.from_dict(base))
    plain = build_detect_step(DetectorConfig.from_dict(
        dict(base, quad_stem=False)))
    if (quad.input_layout, plain.input_layout) != ("s2d2", "hwc"):
        fail(f"15a: layouts {quad.input_layout}, {plain.input_layout}")
    dev_images = torch.from_numpy(images).cuda()
    dev_bounds = torch.from_numpy(bounds).cuda()
    dev_packed = torch.from_numpy(Q.host_s2d2(images)).cuda()
    open_window()
    times = {}
    outs = {}
    # in turns: quad, plain, plain, quad
    for label, step in (("quad", quad), ("plain", plain), ("plain", plain),
                        ("quad", quad)):
        out, host_ms = timed_steps(torch, step, images, bounds, QUAD_TIMED)
        _, dev_ms = timed_steps(torch, step, dev_images, dev_bounds,
                                QUAD_TIMED)
        t = times.setdefault(label, {"host_input": [], "device_input": []})
        t["host_input"].append(host_ms)
        t["device_input"].append(dev_ms)
        if label == "quad":
            _, packed_ms = timed_steps(torch, step, dev_packed, dev_bounds,
                                       QUAD_TIMED)
            t.setdefault("packed_device_input", []).append(packed_ms)
        outs[label] = out
    close_window("quad_stem", ["nms_suppress"])
    # four turns of two timings, the quad turns a third
    n_steps = 10 * (QUAD_TIMED + 1)
    if launches["quad_stem"]["nms_suppress"] != n_steps:
        fail(f"15a: {launches['quad_stem']['nms_suppress']} NMS launches in "
             f"{n_steps} steps")
    for label in outs:
        check_output(torch, f"15a {label} step", outs[label])
    ok, agree = detection_sets_agree(outs["quad"], outs["plain"])
    deltas = detection_deltas(outs["quad"], outs["plain"])
    rec_q, rec_p = (recall(outs[k], bounds, cars) for k in ("quad", "plain"))
    if not ok or min(rec_q, rec_p) < 0.8:
        fail(f"15a: quad against plain {agree}, recall {rec_q:.3f} / "
             f"{rec_p:.3f}")
    # where the device time goes: the stem chain alone, and the rest
    stems, stem_profiles = {}, {}
    for label, step in (("quad", quad), ("plain", plain)):
        stems[label], stem_profiles[label] = stem_chain_ms(torch, step,
                                                           dev_images)
    relay_ms = cuda_ms(lambda: quad.pack_images(dev_images), 20)
    split = {}
    for label in ("quad", "plain"):
        dev_ms = min(times[label]["device_input"])
        if label == "quad":
            dev_ms = min(times[label]["packed_device_input"])
        split[label] = {"step_ms": dev_ms, "stem_chain_ms": stems[label],
                        "rest_ms": dev_ms - stems[label]}
    # the quad stem's P2, card against CPU: f32 (TF32 off) and bf16
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    p2 = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            on_card = create_model(params_path=FIXTURE, dtype=dtype,
                                   device="cuda", fold_bn=True).quad_stem()
            on_cpu = on_card.to("cpu")
            xq = Q.host_s2d2(images[:4])
            got = on_card(torch.from_numpy(xq).cuda()).float().cpu()
            want = on_cpu(torch.from_numpy(xq)).float()
            err = float((got - want).abs().max())
            top = float(want.abs().max())
            p2[str(dtype)] = {"max_abs_err": err, "max_abs": top}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    f32 = p2[str(torch.float32)]
    bf16 = p2[str(torch.bfloat16)]
    # f32: the same products summed in another order; bf16: the card
    # rounds its f32 sums to bf16 once, the CPU too, so one bf16 step of
    # the largest value (2^-7 relative) bounds a flip
    if f32["max_abs_err"] > 1e-5 * f32["max_abs"] \
            or bf16["max_abs_err"] > bf16["max_abs"] * 2.0 ** -7:
        fail(f"15a: the quad stem's P2 on the card against the CPU's {p2}")
    # 15c: the host relayout of one 64-tile batch
    out = np.empty((B, SIZE // 4, SIZE // 4, 48), np.uint8)
    have_native = native.native_paths()["fastpack"]

    def pack_rows():
        for k in range(B):
            Q.host_s2d2_into(images[k], out[k])

    def host_ms(fn, n=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3
    relayout = {"native_loaded": have_native,
                "rows_ms": host_ms(pack_rows),
                "batched_numpy_ms": host_ms(lambda: Q.host_s2d2(images))}
    real_native = native.pack_quad_native
    native.pack_quad_native = lambda px, o: False
    try:
        relayout["rows_numpy_ms"] = host_ms(pack_rows)
    finally:
        native.pack_quad_native = real_native
    if not np.array_equal(out, Q.host_s2d2(images)):
        fail("15c: the relayout rows differ from host_s2d2")
    rec.update(times_ms=times, split_device_ms=split,
               stem_chain_profiles=stem_profiles,
               device_relayout_ms=relay_ms, agree_plain=agree,
               deltas_plain=deltas, recall_quad=rec_q, recall_plain=rec_p,
               p2_card_vs_cpu=p2, host_relayout=relayout)
    print(f"15a quad stem against plain stems, batch {B} at {SIZE} px bf16 "
          f"(turns quad, plain, plain, quad): host input "
          f"{times['quad']['host_input']} / {times['plain']['host_input']} "
          f"ms; device input {times['quad']['device_input']} / "
          f"{times['plain']['device_input']} ms; the quad step on its "
          f"packed batch {times['quad']['packed_device_input']} ms; the "
          f"device relayout of a [B,S,S,3] batch {relay_ms:.3f} ms; stem "
          f"chain quad {stems['quad']:.3f} ms, plain {stems['plain']:.3f} "
          f"ms; agreement {agree}, {deltas}, recall {rec_q:.3f} / "
          f"{rec_p:.3f}; P2 card against CPU {p2} [{card}]", flush=True)
    for label, prof in stem_profiles.items():
        if "top" in prof:
            print(f"15a {label} stem chain by kernel: device busy "
                  f"{prof['device_busy_ms_per_step']:.3f} ms: " + "; ".join(
                      f"{r['ms_per_step']:.3f} ms {r['name'][:50]}"
                      for r in prof["top"][:6]) + f" [{card}]", flush=True)
    print(f"15c host relayout of {B} tiles: rows {relayout['rows_ms']:.2f} "
          f"ms ({'native packer' if have_native else 'numpy copies'}), rows "
          f"by the numpy copies {relayout['rows_numpy_ms']:.2f} ms, batched "
          f"numpy {relayout['batched_numpy_ms']:.2f} ms [{card}]", flush=True)
    del quad, plain


def turnkey_quad_int8(torch, record, card, images, bounds, open_window,
                      close_window):
    """15b for ``--quad-only``: turnkey int8 on s2d² batches (packed on the
    host, as the ingest plane hands them) reaches ``int8`` with the
    fully-int8 stems; epilogue launches a step."""
    from aerial_image_recognition_tpu_torch.ops import quadstem as Q
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        requantize)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step, detection_sets_agree)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    packed = Q.host_s2d2(images)
    float_step = build_detect_step(DetectorConfig.from_dict(dict(
        params_path=FIXTURE, device_batch=B, dtype="bfloat16")))
    ref = float_step(packed, bounds)
    open_window()
    q = build_detect_step(DetectorConfig.from_dict(dict(
        params_path=FIXTURE, device_batch=B, dtype="bfloat16",
        quantize="int8")))
    states = []
    for _ in range(2):
        states.append(q.quantize_state)
        q(packed, bounds)
    states.append(q.quantize_state)
    if states != ["calibrating", "calibrating", "int8"] \
            or q.input_layout != "s2d2" or "stems" not in q.bundle.q:
        fail(f"15b turnkey int8: states {states}, layout {q.input_layout}, "
             f"{q.fallback_reason}")
    before = requantize.launches, requantize.border_launches
    out, ms = timed_steps(torch, q, packed, bounds, 10)
    per_step = ((requantize.launches - before[0]) / 11,
                (requantize.border_launches - before[1]) / 11)
    close_window("quad_int8", ["nms_suppress", "int8_epilogue",
                               "int8_epilogue_border"])
    if per_step != (TRUNK_CONVS + STEM_CONVS, 1):
        fail(f"15b turnkey int8: {per_step} (epilogue, border) launches a "
             f"step")
    ok, agree = detection_sets_agree(ref, out)
    if not ok:
        fail(f"15b turnkey int8 against the bf16 step: {agree}")
    record.setdefault("quad_stem", {})["turnkey_int8"] = {
        "states": states, "parity": q.parity, "step_ms_host_packed": ms,
        "epilogue_launches_a_step": per_step[0],
        "border_launches_a_step": per_step[1], "agree_bf16": agree}
    print(f"15b turnkey int8 on s2d2 batches: states {states}, {ms:.2f} ms "
          f"a step, {per_step[0]:.0f} epilogue launches a step "
          f"({per_step[1]:.0f} in border mode), against the bf16 step "
          f"{agree} [{card}]", flush=True)


# ------------------------------------------------ 16. the resize lowerings,
# assemble_mosaic, the s2d stem and the packed XUnet

LOW_GEOMETRIES = {                  # name → (tile px, centre crop or None)
    "wms_1280": (1280, None),       # the scan's WMS tiles
    "simple_699": (699, None),      # SimpleDetector's windows
    "xyz_1024_crop864": (1024, 864),    # the XYZ path's 1024 → 864 crop
}
LOW_METHODS = ("bilinear", "lanczos3", "cubic")
LOW_CPU_TILES = 4           # rows of each card batch redone on the CPU
LOW_TIMED = 10              # timed calls of each lowering
LOW_F32_BAR = 4e-6          # f32 contractions, card against CPU
MOSAIC_TILE, MOSAIC_GRID = 256, (3, 3)
WMS_PX, WMS_PX_PER_M = 1280, 4.0    # 16b: tiles of 320 m, 0.25 m/px
S2D_TIMED = 10


def embed_stem(variables):
    """Test-side weights for ``YOLOv7(s2d_stem=True)``: the trained tree
    with stem0's [3,3,3,32] stride-2 kernel embedded in the s2d stem's
    [3,3,12,32] stride-1 kernel (ky = 0 → cell row 0, subrow 1; ky = 1 →
    row 1, subrow 0; ky = 2 → row 1, subrow 1; the same for columns; zeros
    elsewhere; input channels in (dy, dx, c) order), so the s2d model
    computes the trained detector's function."""
    import numpy as np
    k = np.asarray(variables["params"]["stem0"]["conv"]["kernel"],
                   np.float32)
    c = k.shape[2]
    cell = {0: (0, 1), 1: (1, 0), 2: (1, 1)}
    out = np.zeros((3, 3, 4 * c, k.shape[3]), np.float32)
    for ky, (u, dy) in cell.items():
        for kx, (v, dx) in cell.items():
            lo = (2 * dy + dx) * c
            out[u, v, lo:lo + c] = k[ky, kx]
    params = dict(variables["params"])
    params["stem0"] = dict(params["stem0"], conv={"kernel": out})
    return dict(variables, params=params)


def s2d_bundle(variables, dtype, device="cuda"):
    """A yolov7_itcvd bundle (BN folded) whose module is
    ``YOLOv7(s2d_stem=True)``, as the reference's tests build one: the
    registry spec with its ``make_module`` swapped."""
    import dataclasses
    from unittest import mock
    from aerial_image_recognition_tpu_torch.models.registry import (
        REGISTRY, create_model)
    from aerial_image_recognition_tpu_torch.models.yolov7 import YOLOv7
    spec = dataclasses.replace(REGISTRY["yolov7_itcvd"],
                               make_module=lambda: YOLOv7(s2d_stem=True))
    with mock.patch.dict(REGISTRY, {"yolov7_itcvd_s2d": spec}):
        return create_model("yolov7_itcvd_s2d", variables=variables,
                            dtype=dtype, device=device, fold_bn=True)


def resize_lowerings(torch, record, card):
    """16a: each ``preprocess_batch`` lowering at B=64 on the card against
    the CPU on the batch's first ``LOW_CPU_TILES`` tiles, timed beside the
    matrix path of its geometry; ``assemble_mosaic`` of 256-px tiles."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        assemble_mosaic, preprocess_batch)
    if torch.get_float32_matmul_precision() != "highest":
        fail("16a: f32 matmuls are not full precision")
    rec = record.setdefault("lowerings", {})["resize"] = {}
    rng = np.random.default_rng(16)
    types = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for geom, (src, crop) in LOW_GEOMETRIES.items():
        imgs = rng.integers(0, 256, (B, src, src, 3), np.uint8)
        dev = torch.from_numpy(imgs).cuda()
        cpu = torch.from_numpy(imgs[:LOW_CPU_TILES])
        kw = dict(out_size=SIZE, crop_size=crop)
        g = rec[geom] = {"src": src, "crop": crop, "batch": B,
                         "matrix_ms": cuda_ms(lambda: preprocess_batch(
                             dev, method="bilinear", **kw), LOW_TIMED)}
        for method, tname in [(m, t) for m in LOW_METHODS + ("nearest",)
                              for t in types]:
            args = dict(kw, method=method, matmul=False, dtype=types[tname])
            got = preprocess_batch(dev, **args)[:LOW_CPU_TILES].cpu().float()
            want = preprocess_batch(cpu, **args).float()
            err = float((got - want).abs().max())
            mean = float((got - want).abs().mean())
            bar = 0.0 if method == "nearest" else (
                LOW_F32_BAR if tname == "float32" else 1 / 128)
            if got.shape != want.shape or err > bar or (
                    tname == "bfloat16" and mean >= 1e-4):
                fail(f"16a {geom} {method} {tname}: card vs CPU max "
                     f"{err:.3e} (bar {bar}), mean {mean:.2e}")
            g[f"{method}_{tname}"] = {
                "max_abs_err": err, "mean_abs_err": mean, "bar": bar,
                "ms": cuda_ms(lambda: preprocess_batch(dev, **args),
                              LOW_TIMED)}
        del dev
        print(f"16a {geom} ({src} px{f', crop {crop}' if crop else ''} → "
              f"{SIZE}, B={B}): matrix path {g['matrix_ms']:.3f} ms; "
              + ", ".join(f"{k} {v['ms']:.3f} ms (err {v['max_abs_err']:.2e})"
                          for k, v in g.items() if isinstance(v, dict))
              + f" [{card}]", flush=True)
    gy, gx = MOSAIC_GRID
    tiles = rng.integers(0, 256, (B, gy * gx, MOSAIC_TILE, MOSAIC_TILE, 3),
                         np.uint8)
    dev = torch.from_numpy(tiles).cuda()
    kw = dict(grid=MOSAIC_GRID, tile_px=MOSAIC_TILE)
    got = assemble_mosaic(dev, **kw).cpu()
    if not torch.equal(got, assemble_mosaic(torch.from_numpy(tiles), **kw)):
        fail("16a: assemble_mosaic on the card differs from the CPU's")
    m_ms = cuda_ms(lambda: assemble_mosaic(dev, **kw), LOW_TIMED)
    rec["mosaic"] = {"batch": B, "grid": list(MOSAIC_GRID),
                     "tile_px": MOSAIC_TILE, "shape": list(got.shape),
                     "equal_to_cpu": True, "ms": m_ms,
                     "bytes": 2 * tiles.nbytes}
    print(f"16a assemble_mosaic: {B} × {gy}×{gx} tiles of {MOSAIC_TILE} px "
          f"→ {tuple(got.shape)}, equal to the CPU's; {m_ms:.3f} ms "
          f"({2 * tiles.nbytes / m_ms / 1e6:.0f} GB/s) [{card}]", flush=True)


def lowerings(torch, record, card, images, bounds, cars, open_window,
              close_window, ms_step=None):
    """16. The last modules of the port at full width: (a) the resize
    lowerings; (b) the single-scale step with ``resize_matmul: false`` on
    1280-px tiles; (c) multiscale with ``resize_matmul: false`` against
    phase 7's step; (d) ``YOLOv7(s2d_stem=True)``; (e) the packed XUnet.
    ``ms_step`` is phase 7's multiscale step (built here when absent)."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.models.int8 import (
        quantize_bundle)
    from aerial_image_recognition_tpu_torch.models.weights import (
        load_params)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step, detection_sets_agree)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    t16 = time.perf_counter()
    rec = record.setdefault("lowerings", {})
    resize_lowerings(torch, record, card)
    base = dict(params_path=FIXTURE, device_batch=B, dtype="bfloat16")

    # 16b: the scan's WMS geometry through jax.image.resize's lowering
    wms, wms_bounds, wms_cars = render_tiles(
        np.random.default_rng(2), B, WMS_PX, px_per_m=WMS_PX_PER_M)
    dev_wms = torch.from_numpy(wms).cuda()
    dev_wms_bounds = torch.from_numpy(wms_bounds).cuda()
    steps = {mm: build_detect_step(DetectorConfig.from_dict(
        dict(base, resize_matmul=mm)), src_size=WMS_PX)
        for mm in (True, False)}
    b = rec["resize_matmul_false_step"] = {"src": WMS_PX, "batch": B,
                                           "px_per_m": WMS_PX_PER_M}
    outs = {}
    for mm, path in ((False, "16b_resize_matmul_false"),
                     (True, "16b_resize_matmul")):
        open_window()
        outs[mm], host_ms = timed_steps(torch, steps[mm], wms, wms_bounds, 5)
        _, dev_ms = timed_steps(torch, steps[mm], dev_wms, dev_wms_bounds,
                                S2D_TIMED)
        close_window(path, ["nms_suppress"])
        b["matrix" if mm else "resize"] = {"step_ms_host_input": host_ms,
                                           "step_ms_device_input": dev_ms}
    check_output(torch, "16b resize_matmul false step", outs[False])
    ok, agree = detection_sets_agree(outs[False], outs[True])
    rec_b = recall(outs[False], wms_bounds, wms_cars)
    if not ok or rec_b < 0.8:
        fail(f"16b: against the matrix step {agree}, recall {rec_b:.3f}")
    b.update(agree_matrix_step=agree, recall=rec_b,
             deltas=detection_deltas(outs[False], outs[True]),
             detections=int(outs[False][0].valid.sum()))
    print(f"16b resize_matmul false on {B} {WMS_PX}-px tiles: "
          f"{b['resize']['step_ms_device_input']:.2f} ms a step on the card "
          f"({b['resize']['step_ms_host_input']:.2f} host input) against "
          f"the matrix step's {b['matrix']['step_ms_device_input']:.2f} "
          f"({b['matrix']['step_ms_host_input']:.2f}); agreement {agree}, "
          f"recall {rec_b:.3f} [{card}]", flush=True)
    del steps, dev_wms, outs

    # 16c: multiscale with resize_matmul false against phase 7's step
    ms_cfg = dict(base, multiscale=[0.85, 1.0, 1.15])
    if ms_step is None:
        ms_step = build_detect_step(DetectorConfig.from_dict(ms_cfg))
    ms_false = build_detect_step(DetectorConfig.from_dict(
        dict(ms_cfg, resize_matmul=False)))
    open_window()
    out_f, ms_f = timed_steps(torch, ms_false, images, bounds, 5)
    close_window("16c_multiscale_resize_false", ["nms_suppress"])
    out_m, ms_m = timed_steps(torch, ms_step, images, bounds, 5)
    check_output(torch, "16c multiscale resize_matmul false", out_f)
    deltas = detection_deltas(out_f, out_m)
    bit_equal = same_detections(torch, out_f, out_m)
    if deltas["unmatched"]:
        fail(f"16c: against phase 7's multiscale step {deltas}")
    rec["multiscale_resize_matmul_false"] = {
        "step_ms_host_input": ms_f, "matrix_step_ms_host_input": ms_m,
        "deltas": deltas, "bit_equal": bit_equal,
        "detections": int(out_f[0].valid.sum())}
    print(f"16c multiscale resize_matmul false: {ms_f:.2f} ms a step against "
          f"{ms_m:.2f} for the matrix resize; every detection matched "
          f"({deltas}); bit-equal: {bit_equal} [{card}]", flush=True)
    del ms_false

    # 16d: YOLOv7(s2d_stem=True), the trained stem embedded
    variables = embed_stem(load_params(FIXTURE))
    s2d = s2d_bundle(variables, torch.bfloat16)
    if s2d.supports_s2d2():
        fail("16d: an s2d-stem bundle claims the quad-stem lowering")
    try:
        quantize_bundle(s2d, [images[:8]])
        fail("16d: int8 quantized an s2d-stem bundle")
    except NotImplementedError as e:
        if "s2d_stem experiment" not in str(e):
            fail(f"16d: int8 refused with {e}")
        int8_message = str(e)
    turnkey = build_detect_step(DetectorConfig.from_dict(dict(
        base, quantize="int8", quantize_calib_batches=1)), bundle=s2d)
    turnkey(images, bounds)
    torch.cuda.synchronize()
    turnkey_state = (turnkey.quantize_state, turnkey.fallback_reason)
    if turnkey_state[0] != "bf16-fallback" \
            or "s2d_stem experiment" not in (turnkey_state[1] or ""):
        fail(f"16d turnkey int8: {turnkey_state}")
    del turnkey
    s2d_step = build_detect_step(DetectorConfig.from_dict(base), bundle=s2d)
    quad = build_detect_step(DetectorConfig.from_dict(base))
    plain = build_detect_step(DetectorConfig.from_dict(
        dict(base, quad_stem=False)))
    if (s2d_step.input_layout, quad.input_layout) != ("hwc", "s2d2"):
        fail(f"16d: layouts {s2d_step.input_layout}, {quad.input_layout}")
    dev_images = torch.from_numpy(images).cuda()
    dev_bounds = torch.from_numpy(bounds).cuda()
    times, outs = {}, {}
    open_window()
    for label, step in (("s2d", s2d_step), ("quad", quad), ("plain", plain),
                        ("s2d", s2d_step)):
        outs[label], ms = timed_steps(torch, step, dev_images, dev_bounds,
                                      S2D_TIMED)
        times.setdefault(label, []).append(ms)
    close_window("16d_s2d_stem", ["nms_suppress"])
    if s2d.quad is not None:
        fail("16d: the s2d-stem step built a quad stem")
    chains = {label: stem_chain_ms(torch, step, dev_images)
              for label, step in (("s2d", s2d_step), ("quad", quad),
                                  ("plain", plain))}
    check_output(torch, "16d s2d-stem step", outs["s2d"])
    ok, agree = detection_sets_agree(outs["s2d"], outs["plain"])
    rec_d = recall(outs["s2d"], bounds, cars)
    if not ok or rec_d < 0.8:
        fail(f"16d: against the plain-stem step {agree}, recall {rec_d:.3f}")
    # f32 raw maps, card against CPU, cuDNN's TF32 off
    x = torch.from_numpy(images[:2]).permute(0, 3, 1, 2).float() / 255.0
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        want = s2d_bundle(variables, torch.float32, "cpu").module(x)
        got = [o.cpu() for o in s2d_bundle(
            variables, torch.float32).module(x.cuda())]
    torch.backends.cudnn.allow_tf32 = tf32
    rel = [float((g - w).abs().max() / w.abs().max())
           for g, w in zip(got, want)]
    if max(rel) > 1e-3:
        fail(f"16d: f32 raw maps card vs CPU {rel} of the largest")
    rec["s2d_stem"] = {
        "step_ms_device_input": times["s2d"], "quad_ms": times["quad"],
        "plain_ms": times["plain"], "agree_plain_stem": agree,
        "recall": rec_d, "deltas": detection_deltas(outs["s2d"],
                                                    outs["plain"]),
        "raw_maps_f32_card_vs_cpu_rel": rel, "supports_s2d2": False,
        "int8_refusal": int8_message, "turnkey_int8": turnkey_state,
        "stem_chain_ms": {k: v[0] for k, v in chains.items()},
        "stem_chain_profile": {k: v[1] for k, v in chains.items()}}
    print(f"16d s2d stem: {min(times['s2d']):.2f} ms a step (device input) "
          f"against quad {times['quad'][0]:.2f}, plain {times['plain'][0]:.2f}"
          f"; against the plain stems {agree}, recall {rec_d:.3f}; f32 raw "
          f"maps card vs CPU {max(rel):.2e} of the largest; no quad stem, "
          f"int8 refused, turnkey stays bf16; stem chain "
          + ", ".join(f"{k} {v[0]:.3f} ms" for k, v in chains.items())
          + "; s2d chain's top kernels: " + "; ".join(
              f"{r['ms_per_step']:.3f} ms {r['name'][:50]}"
              for r in chains["s2d"][1].get("top", [])[:4])
          + f" [{card}]", flush=True)
    del s2d, s2d_step, quad, plain, outs

    # 16e: the packed XUnet against the standard forward
    packed_xunet(torch, record, card)
    rec["phase_s"] = time.perf_counter() - t16
    print(f"16. the lowerings' phase took {rec['phase_s']:.1f} s [{card}]",
          flush=True)


def packed_xunet(torch, record, card):
    """16e: the packed XUnet-256 (trained fixture, 256 px, B=16, phase 12's
    held-out tiles) against the standard forward: bf16 masks IoU ≥ 0.99,
    f32 logits card vs CPU within 1e-3 of their largest magnitude (TF32
    off); ms a batch of each, and ``host_s2d``'s."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.fetch.fake import FakeWorld
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.models.weights import (
        load_params)
    from aerial_image_recognition_tpu_torch.ops.packed_unet import (
        PackedXUnet, host_s2d, s2d_unpack)
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    tiles, _, _ = seg_tiles(FakeWorld(**SEG_WORLD), SEG_B, seed=123)
    variables = load_params(XUNET_FIXTURE)
    t0 = time.perf_counter()
    for _ in range(5):
        packed_host = host_s2d(tiles)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    dev_tiles = torch.from_numpy(tiles).cuda()
    dev_packed = torch.from_numpy(packed_host).cuda()
    std = create_model("xunet_256", dtype=torch.bfloat16,
                       params_path=XUNET_FIXTURE, fold_bn=True)
    packed = PackedXUnet(variables, dtype=torch.bfloat16, device="cuda")
    x = preprocess_batch(dev_tiles, out_size=SEG_SIZE, dtype=torch.bfloat16)
    with torch.inference_mode():
        m_std = (std.forward(x)[..., 0] > 0).cpu().numpy()
        m_packed = (s2d_unpack(packed(dev_packed))[..., 0] > 0).cpu().numpy()
        ms = {"standard": [], "packed": []}
        for _ in range(2):
            ms["standard"].append(cuda_ms(lambda: std.forward(
                preprocess_batch(dev_tiles, out_size=SEG_SIZE,
                                 dtype=torch.bfloat16)), 20))
            ms["packed"].append(cuda_ms(lambda: packed(dev_packed), 20))
    iou_b = iou(m_packed, m_std)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        xs = torch.from_numpy(packed_host[:2])
        want = PackedXUnet(variables, dtype=torch.float32)(xs)
        got = PackedXUnet(variables, dtype=torch.float32,
                          device="cuda")(xs.cuda()).cpu()
    torch.backends.cudnn.allow_tf32 = tf32
    rel = float((got - want).abs().max() / want.abs().max())
    if iou_b < 0.99 or rel > 1e-3 or tuple(got.shape) != (
            2, SEG_SIZE // 2, SEG_SIZE // 2, 4):
        fail(f"16e packed XUnet: bf16 masks IoU {iou_b:.4f} against the "
             f"standard forward, f32 card vs CPU {rel:.2e}, shape "
             f"{tuple(got.shape)}")
    record["lowerings"]["packed_xunet"] = {
        "batch": SEG_B, "size": SEG_SIZE, "mask_iou_standard_bf16": iou_b,
        "logits_f32_card_vs_cpu_rel": rel, "packed_ms": ms["packed"],
        "standard_ms": ms["standard"], "host_s2d_ms": host_ms}
    print(f"16e packed XUnet-256: {min(ms['packed']):.3f} ms a batch of "
          f"{SEG_B} (uint8 s2d on the card) against the standard forward's "
          f"{min(ms['standard']):.3f} (with its /255 preprocess); masks IoU "
          f"{iou_b:.4f}; f32 logits card vs CPU {rel:.2e} of the largest; "
          f"host_s2d {host_ms:.2f} ms a batch [{card}]", flush=True)


def lowerings_only(torch, record, card) -> None:
    """``--lowerings-only``: phase 3's kernel checks (NMS, CLAHE), then
    phase 16. The kernel line holds the NMS and CLAHE kernels."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops.clahe_kernel import (
        apply_luts)
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    nms = check_nms_kernel(torch, record)
    clahe = check_clahe_kernel(torch, record)
    print(f"nms_suppress: bit-identical to plain on "
          f"{len(record['nms_cases'])} cases; clahe_apply: raw f32 equal to "
          f"plain on {len(record['clahe_cases'])} cases [{card}]", flush=True)
    images, bounds, cars = render_tiles(np.random.default_rng(1), B, SIZE)
    launches = {}
    open_window, close_window = launch_window(
        {"nms_suppress": nms_suppress, "clahe_apply": apply_luts}, launches)
    lowerings(torch, record, card, images, bounds, cars, open_window,
              close_window)
    record["launches_by_path"] = launches
    record["kernels"] = [nms, clahe]
    for entry in record["kernels"]:
        entry["launches"] = sum(p.get(entry["name"], 0)
                                for p in launches.values())
        entry["launches_by_path"] = {path: p.get(entry["name"], 0)
                                     for path, p in launches.items()}


def quad_only(torch, record, card) -> None:
    """``--quad-only``: the NMS and int8 epilogue kernels against their
    plain versions, then phase 15 (a–d). The kernel line holds the NMS
    kernel, the epilogue and its border mode."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        requantize)
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    nms = check_nms_kernel(torch, record)
    epilogue = check_int8_product(torch, record, card)
    images, bounds, cars = render_tiles(np.random.default_rng(1), B, SIZE)
    border = check_border_epilogue(torch, record, card, images)
    launches = {}
    open_window, close_window = launch_window(
        {"nms_suppress": nms_suppress, "int8_epilogue": requantize,
         "int8_epilogue_border": BorderLaunches()}, launches)
    quad_stem_phase(torch, record, card, images, bounds, cars, open_window,
                    close_window, launches)
    turnkey_quad_int8(torch, record, card, images, bounds, open_window,
                      close_window)
    check_current_device(torch, record, card)
    record["launches_by_path"] = launches
    for entry in (nms, epilogue, border):
        entry["launches"] = sum(p.get(entry["name"], 0)
                                for p in launches.values())
        entry["launches_by_path"] = {path: p.get(entry["name"], 0)
                                     for path, p in launches.items()}
    record["kernels"] = [nms, epilogue, border]


def parallel_only(torch, record, card) -> None:
    """``--parallel-only``: the NMS and int8 epilogue kernels against
    their plain versions, then phase 14. The kernel line holds both."""
    from aerial_image_recognition_tpu_torch.ops.clahe_kernel import (
        apply_luts)
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        requantize)
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    nms = check_nms_kernel(torch, record)
    epilogue = check_int8_product(torch, record, card)
    print(f"nms_suppress: bit-identical to plain on "
          f"{len(record['nms_cases'])} cases; int8_epilogue equal to plain "
          f"on {len(record['int8_cases'])} shapes [{card}]", flush=True)
    launches = {}
    open_window, close_window = launch_window(
        {"nms_suppress": nms_suppress, "clahe_apply": apply_luts,
         "int8_epilogue": requantize}, launches)
    multi_gpu(torch, record, card, launches, open_window, close_window)
    record["launches_by_path"] = launches
    for entry in (nms, epilogue):
        entry["launches"] = sum(p.get(entry["name"], 0)
                                for p in launches.values())
        entry["launches_by_path"] = {path: p.get(entry["name"], 0)
                                     for path, p in launches.items()}
    record["kernels"] = [nms, epilogue]


def train_only(torch, record, card) -> None:
    """``--train-only``: the NMS kernel against its plain version
    (``NMS_CASES``, evaluate's shapes among them), then phase 13. The
    kernel line holds the NMS kernel."""
    from aerial_image_recognition_tpu_torch.ops.clahe_kernel import (
        apply_luts)
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        requantize)
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    record["kernels"] = [check_nms_kernel(torch, record)]
    print(f"nms_suppress: bit-identical to plain on "
          f"{len(record['nms_cases'])} cases [{card}]", flush=True)
    launches = {}
    open_window, close_window = launch_window(
        {"nms_suppress": nms_suppress, "clahe_apply": apply_luts,
         "int8_epilogue": requantize}, launches)
    training(torch, record, card, launches, open_window, close_window)
    record["launches_by_path"] = launches
    nms = record["kernels"][0]
    nms["launches"] = sum(p.get("nms_suppress", 0)
                          for p in launches.values())
    nms["launches_by_path"] = {path: p.get("nms_suppress", 0)
                               for path, p in launches.items()}


def launch_window(wrappers, launches):
    """(open_window, close_window) over the kernels' launch counters:
    ``open_window()`` sets every wrapper's count to 0 just before a path;
    ``close_window(path, needed)`` stores the counts in ``launches[path]``
    just after it and fails if a kernel in ``needed`` never launched."""
    def open_window():
        for w in wrappers.values():
            w.launches = 0

    def close_window(path, needed):
        launches[path] = {k: w.launches for k, w in wrappers.items()}
        for k in needed:
            if not launches[path].get(k):
                fail(f"the {path} path never launched {k}")

    return open_window, close_window


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
    open_window, close_window = launch_window(
        {"nms_suppress": nms_suppress}, launches)
    ingest_ring(torch, record, card, step, images, bounds, step_ms,
                device_ms, open_window, close_window)
    city_scan(torch, record, card, open_window, close_window)
    record["kernels"][0]["launches"] = sum(
        p["nms_suppress"] for p in launches.values())
    record["kernels"][0]["launches_by_path"] = {
        path: p["nms_suppress"] for path, p in launches.items()}


def front_ends_only(torch, record, card) -> None:
    """``--front-ends-only``: the NMS kernel against its plain version
    (``NMS_CASES``, predict's shape among them), then phase 11 — the quick
    card check of the CLI. The kernel line holds the NMS kernel; every
    kernel's launches by path stand in the record."""
    from aerial_image_recognition_tpu_torch.ops.clahe_kernel import (
        apply_luts)
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        requantize)
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    record["kernels"] = [check_nms_kernel(torch, record)]
    print(f"nms_suppress: bit-identical to plain on "
          f"{len(record['nms_cases'])} cases [{card}]", flush=True)
    launches = {}
    open_window, close_window = launch_window(
        {"nms_suppress": nms_suppress, "clahe_apply": apply_luts,
         "int8_epilogue": requantize}, launches)

    front_ends(torch, record, card, launches, open_window, close_window)
    record["launches_by_path"] = launches
    nms = record["kernels"][0]
    nms["launches"] = sum(p.get("nms_suppress", 0)
                          for p in launches.values())
    nms["launches_by_path"] = {path: p.get("nms_suppress", 0)
                               for path, p in launches.items()}


def segment_only(torch, record, card) -> None:
    """``--segment-only``: phase 3's kernel checks (NMS, CLAHE), then phase
    12. The kernel line holds all three kernels; the epilogue's times are
    phase 12's, relu at the XUnet trunk's first conv."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.ops.clahe_kernel import (
        apply_luts)
    from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
        requantize)
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    nms = check_nms_kernel(torch, record)
    clahe = check_clahe_kernel(torch, record)
    print(f"nms_suppress: bit-identical to plain on "
          f"{len(record['nms_cases'])} cases; clahe_apply: raw f32 equal to "
          f"plain on {len(record['clahe_cases'])} cases [{card}]", flush=True)
    images, bounds, _ = render_tiles(np.random.default_rng(1), 8, SIZE)
    launches = {}
    open_window, close_window = launch_window(
        {"nms_suppress": nms_suppress, "clahe_apply": apply_luts,
         "int8_epilogue": requantize}, launches)
    relu = segmentation(torch, record, card, launches, open_window,
                        close_window, images, bounds)
    epilogue = {
        "name": "int8_epilogue", "route": "cuda",
        "source": "aerial_image_recognition_tpu_torch/csrc/int8_epilogue.cu",
        "replaces": "aerial_image_recognition_tpu/models/int8.py:364 (jnp "
                    "chain fused by XLA; no TPU kernel)",
        "act": "relu", **{k: relu[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "shape")}, "library_ms": None}
    record["kernels"] = [nms, clahe, epilogue]
    record["launches_by_path"] = launches
    for entry in record["kernels"]:
        entry["launches"] = sum(p.get(entry["name"], 0)
                                for p in launches.values())
        entry["launches_by_path"] = {path: p.get(entry["name"], 0)
                                     for path, p in launches.items()}


def main() -> None:
    modes = {"--scan-only": "chip_smoke_scan.json",
             "--front-ends-only": "chip_smoke_front_ends.json",
             "--segment-only": "chip_smoke_segment.json",
             "--train-only": "chip_smoke_train.json",
             "--parallel-only": "chip_smoke_parallel.json",
             "--quad-only": "chip_smoke_quad.json",
             "--lowerings-only": "chip_smoke_lowerings.json",
             "--rtdetr-only": "chip_smoke_rtdetr.json"}
    mode = sys.argv[1] if sys.argv[1:2] and len(sys.argv) == 2 else None
    if sys.argv[1:] and mode not in modes:
        fail(f"unknown arguments {sys.argv[1:]}: run with none, with "
             "--scan-only for the city scan's phases alone, with "
             "--front-ends-only for the CLI's, with --segment-only for "
             "segmentation's, with --train-only for training's, with "
             "--parallel-only for multi-GPU's, with --quad-only for the "
             "quad stem's, with --lowerings-only for phase 16's or with "
             "--rtdetr-only for RT-DETR's kernels")
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
    if mode == "--scan-only":
        scan_only(torch, record, card)
        finish(torch, record, name, modes[mode])
        return
    if mode == "--front-ends-only":
        front_ends_only(torch, record, card)
        finish(torch, record, name, modes[mode])
        return
    if mode == "--segment-only":
        segment_only(torch, record, card)
        finish(torch, record, name, modes[mode])
        return
    if mode == "--train-only":
        train_only(torch, record, card)
        finish(torch, record, name, modes[mode])
        return
    if mode == "--parallel-only":
        parallel_only(torch, record, card)
        finish(torch, record, name, modes[mode])
        return
    if mode == "--quad-only":
        quad_only(torch, record, card)
        finish(torch, record, name, modes[mode])
        return
    if mode == "--lowerings-only":
        lowerings_only(torch, record, card)
        finish(torch, record, name, modes[mode])
        return
    if mode == "--rtdetr-only":
        rtdetr_only(torch, record, card)
        finish(torch, record, name, modes[mode])
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

    launches = {}
    open_window, close_window = launch_window(
        {"nms_suppress": nms_suppress, "clahe_apply": apply_luts,
         "int8_epilogue": requantize,
         "int8_epilogue_border": BorderLaunches()}, launches)
    if step.input_layout != "s2d2":
        fail(f"the default step's layout is {step.input_layout!r}, not the "
             "quad stem's s2d2")

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
                "layout": step.input_layout,
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
    swap_launches = (nms_suppress.launches, requantize.launches,
                     requantize.border_launches)
    # 2 calibration steps + 1 parity replay; one int8 forward so far, its
    # stems fully int8 (the quad stem's uint8 entry)
    per_forward = int8_epilogues_a_forward(qstep)
    if swap_launches != (3, per_forward, 1):
        fail(f"turnkey int8: {swap_launches} launches of (nms_suppress, "
             f"int8_epilogue, its border mode) up to the swap, expected "
             f"(3, {per_forward}, 1)")
    n_int8 = 10
    q_out, q_ms = timed_steps(torch, qstep, images, bounds, n_int8)
    _, q_dev_ms = timed_steps(torch, qstep, dev_images, dev_bounds, n_int8)
    int8_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the bf16 step again, in turns with the int8 step, device input
    _, bf16_again_ms = timed_steps(torch, step, dev_images, dev_bounds,
                                   n_int8)
    _, q_dev_ms2 = timed_steps(torch, qstep, dev_images, dev_bounds, n_int8)
    steps_run = 3 + 3 * (n_int8 + 1)
    if (nms_suppress.launches, requantize.launches,
            requantize.border_launches) != (
            steps_run + n_int8 + 1, per_forward * (steps_run - 2),
            steps_run - 2):
        fail(f"int8 path: {nms_suppress.launches} launches of nms_suppress "
             f"and {requantize.launches} of int8_epilogue "
             f"({requantize.border_launches} in border mode) after "
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
        "batch": B, "size": SIZE, "layout": qstep.input_layout,
        "stems": "int8 (quad stem, border mode)", "states": states,
        "epilogue_launches_a_forward": per_forward,
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
    close_window("int8", ["nms_suppress", "int8_epilogue",
                          "int8_epilogue_border"])
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

    # 15. the quad stem: quad against plain at phase 4's shape, the border
    # mode at stem0's shape, the host relayout, the current-device check
    t15 = time.perf_counter()
    border = check_border_epilogue(torch, record, card, images)
    quad_stem_phase(torch, record, card, images, bounds, cars, open_window,
                    close_window, launches)
    check_current_device(torch, record, card)
    record["quad_stem"]["phase_s"] = time.perf_counter() - t15
    print(f"15. the quad stem's phase took "
          f"{record['quad_stem']['phase_s']:.1f} s [{card}]", flush=True)

    # 16. the resize lowerings, assemble_mosaic, the s2d stem, the packed
    # XUnet
    lowerings(torch, record, card, images, bounds, cars, open_window,
              close_window, ms_step=ms_step)

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

    # 11. the front ends, each verb a child process on this card
    front_ends(torch, record, card, launches, open_window, close_window)

    # 12. segmentation on the card
    epilogue["xunet_relu"] = segmentation(
        torch, record, card, launches, open_window, close_window, images,
        bounds)

    # 13. training on the card
    training(torch, record, card, launches, open_window, close_window)

    # 14. multi-GPU
    multi_gpu(torch, record, card, launches, open_window, close_window)

    for entry in (kernel, clahe, epilogue, border):
        entry["launches"] = sum(p.get(entry["name"], 0)
                                for p in launches.values())
        entry["launches_by_path"] = {path: p.get(entry["name"], 0)
                                     for path, p in launches.items()}
    record["kernels"] = [kernel, clahe, epilogue, border]
    finish(torch, record, name, "chip_smoke.json")


def msda_case(torch, shapes, b, q, heads, d, points, seed: int):
    """value, locations (uniform over [-0.2, 1.2], with exact cell borders
    and the maps' edges) and softmaxed weights of one sampling case."""
    g = torch.Generator().manual_seed(seed)
    value = torch.randn(b, sum(h * w for h, w in shapes), heads, d,
                        generator=g)
    loc = torch.rand(b, q, heads, len(shapes), points, 2, generator=g) \
        * 1.4 - 0.2
    for lvl, (h, w) in enumerate(shapes):
        loc[0, 0, 0, lvl, 0] = torch.tensor([1.0 / w, 2.0 / h])
        loc[0, 0, -1, lvl, -1] = torch.tensor([0.0, 1.0])
        loc[-1, -1, 0, lvl, 0] = torch.tensor([1.0, 0.0])
    wts = torch.softmax(torch.randn(b, q, heads, len(shapes) * points,
                                    generator=g), -1) \
        .view(b, q, heads, len(shapes), points)
    return value, loc, wts


def msda_touched(torch, shapes, loc, heads: int) -> int:
    """(image, token, head) lines of the value map that the samples' inside
    corners read, counted once each."""
    b = loc.shape[0]
    keys, start = [], 0
    for lvl, (h, w) in enumerate(shapes):
        x = torch.floor(loc[:, :, :, lvl, :, 0] * w - 0.5).long()
        y = torch.floor(loc[:, :, :, lvl, :, 1] * h - 0.5).long()
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y + dy, x + dx
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                tok = start + yy * w + xx
                img = torch.arange(b, device=loc.device).view(b, 1, 1, 1) \
                    .expand_as(tok)
                head = torch.arange(heads, device=loc.device) \
                    .view(1, 1, heads, 1).expand_as(tok)
                keys.append(((img * 100000 + tok) * heads + head)[ok])
        start += h * w
    return int(torch.unique(torch.cat(keys)).numel())


def check_residual_relu(torch, card, dev) -> dict:
    """RT-DETR's residual join (``csrc/residual_relu.cu``): bit-equal to
    ``F.relu(y + s)`` on the card and to the plain version on the CPU, in
    bf16 and f32, channels_last and contiguous, with a ragged length; then
    at the first stage's join, [64, 256, 160, 160] bf16 channels_last: its
    device time, its bound by bytes (y and s read once, y written once),
    the plain version's time and ``F.relu(y + s)``'s, both on the card."""
    import torch.nn.functional as F
    from aerial_image_recognition_tpu_torch.kernels.build import build_log
    from aerial_image_recognition_tpu_torch.ops.residual_relu import (
        residual_relu, residual_relu_plain)

    def bits(t):
        return t.contiguous().view(
            torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    cases = []
    for k, (shape, dtype, fmt) in enumerate([
            ((64, 256, 40, 40), torch.bfloat16, torch.channels_last),
            ((64, 256, 40, 40), torch.float32, torch.channels_last),
            ((3, 5, 7, 9), torch.bfloat16, torch.contiguous_format),
            ((3, 5, 7, 9), torch.float32, torch.channels_last),
            ((1, 1, 1, 7), torch.bfloat16, torch.contiguous_format)]):
        g = torch.Generator().manual_seed(230 + k)
        y = (torch.randn(shape, generator=g) * 3).to(dtype) \
            .contiguous(memory_format=fmt)
        s = (torch.randn(shape, generator=g) * 3).to(dtype) \
            .contiguous(memory_format=fmt)
        plain = residual_relu_plain(y.clone(), s)
        yc, sc = y.to(dev), s.to(dev)
        on_card = F.relu(yc + sc)
        got = residual_relu(yc, sc)
        same_card = torch.equal(bits(got), bits(on_card))
        same_plain = torch.equal(bits(got.cpu()), bits(plain))
        cases.append({"shape": list(shape), "dtype": str(dtype),
                      "format": str(fmt), "equal_to_composite_on_card":
                      same_card, "equal_to_plain_on_cpu": same_plain})
        if not (same_card and same_plain):
            fail(f"residual_relu case {k} {shape} {dtype} {fmt}: bits "
                 f"differ (card composite {same_card}, CPU plain "
                 f"{same_plain})")
    shape = (64, 256, 160, 160)
    gen = torch.Generator(device=dev).manual_seed(23)
    y = torch.randn(shape, device=dev, generator=gen, dtype=torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    s = torch.randn(shape, device=dev, generator=gen, dtype=torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    want = F.relu(y + s)
    got = residual_relu(y.clone(), s)
    if not torch.equal(bits(got), bits(want)):
        fail("residual_relu at [64, 256, 160, 160] bf16: bits differ from "
             "F.relu(y + s) on the card")
    del got, want
    ms, events = kernel_ms(torch, lambda: residual_relu(y, s), 50,
                           "residual_relu")
    plain = cuda_ms(lambda: residual_relu_plain(y, s), 10)
    composite = cuda_ms(lambda: F.relu(y + s), 10)
    nbytes = 3 * y.numel() * y.element_size()
    bound = nbytes / HBM_BYTES_S * 1e3
    kern = {"name": "residual_relu", "shape": list(shape),
            "dtype": "bfloat16", "format": "channels_last", "ms": ms,
            "events_ms": events, "plain_ms": plain,
            "library_ms": composite, "bytes": nbytes, "bound_ms": bound,
            "bound_by": "bytes", "roofline_share": bound / ms,
            "cases": cases, "ptxas": [ln.strip() for ln in build_log(
                "residual_relu").splitlines() if "registers" in ln
                or "spill" in ln]}
    print(f"residual_relu: bit-equal to F.relu(y + s) on the card and to "
          f"the plain version on the CPU on {len(cases) + 1} cases; "
          f"{ms:.4f} ms device time at {list(shape)} bf16 (events "
          f"{events:.4f} ms), bound {bound:.4f} ms by bytes "
          f"({nbytes / 1e9:.4f} GB), {100 * bound / ms:.1f} % of it; plain "
          f"{plain:.4f} ms, F.relu(y + s) {composite:.4f} ms; ptxas: "
          f"{' | '.join(kern['ptxas'])} [{card}]", flush=True)
    return kern


def rtdetr_only(torch, record, card) -> None:
    """``--rtdetr-only``: RT-DETR's deformable sampling kernel
    (``csrc/ms_deform_attn.cu``) against its plain version on edge cases
    and on the six launches of one scan batch of the benchmark's seeded
    RT-DETR-R50 (``benchmark/configs/rtdetr-r50vd.json``), its device time,
    bound and plain time there, and the share of the value map its samples
    read; the residual join's kernel (``check_residual_relu``); then the
    bf16 step at the scan's batch, timed and profiled, both kernels'
    launches and the box head's rows counted, its memory peak above what
    it found allocated, the peak of each span of its forward, and its
    outputs against the whole-token select's (``rtdetr_spans``)."""
    import numpy as np
    from aerial_image_recognition_tpu_torch.kernels.build import (
        build_all, build_log)
    from aerial_image_recognition_tpu_torch.models import rtdetr
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn, ms_deform_attn_plain)
    from aerial_image_recognition_tpu_torch.ops.residual_relu import (
        residual_relu)
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.runtime.config import (
        DetectorConfig)
    from benchmark.lib import registry as bench_registry
    from benchmark.lib import tiles as bench_tiles
    from benchmark.lib import weights as bench_weights
    t0 = time.perf_counter()
    build_all(["ms_deform_attn", "residual_relu"])
    record["msda_build_s"] = time.perf_counter() - t0
    record["msda_ptxas"] = [ln.strip() for ln in build_log(
        "ms_deform_attn").splitlines() if "registers" in ln
        or "spill" in ln]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cases = []
    for k, (shapes, b, q, heads, d, points) in enumerate([
            ([(6, 8), (3, 4), (2, 2)], 2, 5, 2, 32, 3),
            ([(80, 80), (40, 40), (20, 20)], 2, 300, 8, 32, 4),
            ([(7, 5)], 3, 9, 3, 40, 2)]):
        value, loc, wts = msda_case(torch, shapes, b, q, heads, d, points, k)
        got = ms_deform_attn(value.to(dev), shapes, loc.to(dev),
                             wts.to(dev)).cpu().double()
        want = ms_deform_attn_plain(value.double(), shapes, loc.double(),
                                    wts.double())
        err = float((got - want).abs().max() / want.abs().max())
        cases.append({"shapes": shapes, "batch": b, "queries": q,
                      "heads": heads, "head_dim": d, "points": points,
                      "rel_err_vs_f64": err})
        if err > 1e-5:
            fail(f"ms_deform_attn case {k}: {err:.3e} of the largest output "
                 "from the f64 plain version")
    record["msda_cases"] = cases

    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                      "rtdetr-r50vd.json")))
    family = bench_registry.family(cfg["reference"])
    rng = np.random.default_rng(22)
    images, _ = bench_tiles.render_tiles(rng, B, SIZE)
    bounds = np.tile(np.asarray([[21.0, 52.2, 21.0047, 52.2029]]), (B, 1))
    _, tree = bench_weights.make(cfg, family, 2200000022, dev, ROOT, images)
    bundle = create_model("rtdetr_r50vd", variables=tree,
                          dtype=torch.bfloat16, device=dev, fold_bn=True)
    step = build_detect_step(DetectorConfig(
        model_path="rtdetr_r50vd", model_family="rtdetr", num_classes=2,
        dtype="bfloat16", max_detections_per_tile=256), bundle=bundle,
        batch=B, device=dev)
    seen = []
    real = rtdetr.ms_deform_attn

    def keep(*args):
        seen.append(args)
        return real(*args)
    rtdetr.ms_deform_attn = keep
    try:
        before = ms_deform_attn.launches
        joins = residual_relu.launches
        out = step(images, bounds)
        torch.cuda.synchronize()
        per_step = ms_deform_attn.launches - before
        joins = residual_relu.launches - joins
    finally:
        rtdetr.ms_deform_attn = real
    if per_step != 6 or len(seen) != 6:
        fail(f"one step launched ms_deform_attn {per_step} times, "
             f"not 6")
    blocks = sum(bundle.module.config["depths"])
    if joins != blocks:
        fail(f"one step launched residual_relu {joins} times, not one a "
             f"bottleneck ({blocks})")
    layers = []
    for i, (value, shapes, loc, wts) in enumerate(seen):
        got = ms_deform_attn(value, shapes, loc, wts)
        want = ms_deform_attn_plain(value.double(), shapes, loc.double(),
                                    wts.double())
        err = float((got.double() - want).abs().max()
                    / want.abs().max())
        heads = value.shape[2]
        touched = msda_touched(torch, shapes, loc, heads)
        layers.append({"layer": i, "rel_err_vs_f64": err,
                       "lines_touched": touched,
                       "lines_share": touched / (value.shape[0]
                                                 * value.shape[1] * heads),
                       "loc_min": float(loc.min()),
                       "loc_max": float(loc.max())})
        if err > 1e-5:
            fail(f"ms_deform_attn on layer {i}'s launch: {err:.3e}")
    value, shapes, loc, wts = seen[-1]
    args = (value, shapes, loc, wts)
    ms, events = kernel_ms(torch, lambda: ms_deform_attn(*args), 50,
                           "ms_deform_attn")
    plain = cuda_ms(lambda: ms_deform_attn_plain(*args), 5, warmup=1)
    b, n_tok, heads, d = value.shape
    q, points = loc.shape[1], loc.shape[4]
    samples = b * q * heads * len(shapes) * points
    side = 4 * (3 * samples + b * q * heads * d)
    whole = side + 4 * b * n_tok * heads * d
    read = side + 4 * d * layers[-1]["lines_touched"]
    flops = samples * (9 * d + 14)
    kern = {"name": "ms_deform_attn", "batch": b, "tokens": n_tok,
            "queries": q, "heads": heads, "head_dim": d, "points": points,
            "levels": [list(s) for s in shapes], "ms": ms,
            "events_ms": events, "plain_ms": plain,
            "bytes_value_map_once": whole, "bytes_lines_touched": read,
            "flops": flops,
            "bound_ms_value_map_once": max(whole / HBM_BYTES_S,
                                           flops / F32_FLOPS) * 1e3,
            "bound_ms_lines_touched": max(read / HBM_BYTES_S,
                                          flops / F32_FLOPS) * 1e3,
            "layers": layers, "ptxas": record["msda_ptxas"]}
    record["kernels"] = [kern, check_residual_relu(torch, card, dev)]
    print(f"ms_deform_attn: equal to the f64 plain version to "
          f"{max(c['rel_err_vs_f64'] for c in cases):.2e} on "
          f"{len(cases)} cases and to "
          f"{max(r['rel_err_vs_f64'] for r in layers):.2e} on one step's 6 "
          f"launches; {ms:.4f} ms device time at B={b}, {n_tok} tokens, "
          f"Q={q} (events {events:.4f} ms; plain {plain:.3f} ms); bound "
          f"{kern['bound_ms_value_map_once']:.4f} ms with the value map "
          f"read once, {kern['bound_ms_lines_touched']:.4f} ms with the "
          f"{layers[-1]['lines_share']:.3f} of its lines the samples read; "
          f"ptxas: {' | '.join(record['msda_ptxas'])} [{card}]", flush=True)

    dev_images = torch.from_numpy(images).to(dev)
    dev_bounds = torch.from_numpy(bounds).to(dev)
    _, step_ms = timed_steps(torch, step, dev_images, dev_bounds, 10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    step(dev_images, dev_bounds)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - held
    prof = profile_calls(torch, lambda: step(dev_images, dev_bounds), 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = rtdetr.Decoder.enc_box_rows
    spans, select = rtdetr_spans(torch, bundle.module,
                                 lambda: step(dev_images, dev_bounds))
    rows = rtdetr.Decoder.enc_box_rows - rows
    det = out[0]
    record["rtdetr_step"] = {
        "batch": B, "size": SIZE, "dtype": "bfloat16", "step_ms": step_ms,
        "tiles_per_s": B / step_ms * 1e3,
        "detections": int(det.valid.sum()),
        "msda_launches_per_step": per_step,
        "residual_relu_launches_per_step": joins,
        "enc_box_rows_per_step": rows,
        "step_peak_bytes_above_held": step_peak, "held_bytes": held,
        "span_peak_bytes": spans, "select_vs_whole_token": select,
        "peak_mem_gb": peak_gb, "profile": prof}
    print(f"rtdetr step: {step_ms:.2f} ms a batch of {B} at {SIZE} px "
          f"(bf16 trunk), {B / step_ms * 1e3:.1f} tiles/s, "
          f"{int(det.valid.sum())} detections, {per_step} ms_deform_attn "
          f"and {joins} residual_relu launches, {rows} enc_box_rows, peak "
          f"{step_peak} B above the {held} B held; top device ops "
          f"{[(r['name'][:40], round(r['ms_per_step'], 3)) for r in prof.get('top', [])[:6]]} "
          f"[{card}]", flush=True)
    print(f"rtdetr spans: peak bytes allocated {spans}; against the "
          f"whole-token select, largest differences {select} [{card}]",
          flush=True)
    if rows != B * bundle.module.decoder.queries:
        fail(f"one step's box head ran on {rows} rows, not B x Q")


def rtdetr_spans(torch, module, run):
    """One call of ``run`` (a step through RT-DETR ``module``): the peak
    bytes allocated on the card within each span of its forward
    (``backbone``, ``encoder``, ``select``, ``decoder``; weights and
    batch included), by hooks that reset the allocator's peak at each
    span's start; and the largest differences of that forward's
    ``enc_scores``, ``topk``, ``logits`` and ``boxes`` from the
    whole-token select's, computed afterwards on the decoder's inputs:
    the encoder's box head over every token, the anchor logits added, the
    top-k rows gathered, then the same decoder layers."""
    from aerial_image_recognition_tpu_torch.models.rtdetr import (
        inverse_sigmoid)
    dec = module.decoder
    peaks, caught = {}, {}

    def start(_m, args):
        torch.cuda.reset_peak_memory_stats()

    def end(name):
        def hook(*_):
            if name not in peaks:
                peaks[name] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        return hook

    def inputs(_m, args):
        caught["feats"] = args[0]

    def outputs(_m, _args, out):
        caught["out"] = out
    hooks = [module.backbone.register_forward_pre_hook(start),
             module.backbone.register_forward_hook(end("backbone")),
             module.encoder.register_forward_pre_hook(start),
             module.encoder.register_forward_hook(end("encoder")),
             dec.register_forward_pre_hook(start),
             dec.register_forward_pre_hook(inputs),
             dec.query_pos.register_forward_pre_hook(end("select")),
             dec.register_forward_hook(end("decoder")),
             dec.register_forward_hook(outputs)]
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    feats, got = caught["feats"], caught["out"]
    with torch.inference_mode():
        shapes = [(int(f.shape[2]), int(f.shape[3])) for f in feats]
        memory = torch.cat([dec._project(i, f)
                            for i, f in enumerate(feats)], 1)
        anc, valid = dec._anchors_for(shapes, memory.device)
        om = dec.enc_norm(dec.enc_output(memory * valid))
        enc_scores = dec.enc_score(om)
        boxes = dec.enc_bbox(om) + anc
        top = torch.topk(enc_scores.max(-1).values, dec.queries,
                         dim=1).indices
        ref = torch.sigmoid(boxes.gather(1, top[..., None].expand(-1, -1,
                                                                  4)))
        h = om.gather(1, top[..., None].expand(-1, -1, om.shape[-1]))
        del om, boxes
        for i in range(dec.layers):
            pos = dec.query_pos(ref)
            h = getattr(dec, f"layer{i}")(h, pos, ref, memory, shapes)
            ref = torch.sigmoid(getattr(dec, f"bbox{i}")(h)
                                + inverse_sigmoid(ref))
        want = {"enc_scores": enc_scores, "topk": top, "boxes": ref,
                "logits": getattr(dec, f"class{dec.layers - 1}")(h)}
        diff = {k: float((got[k].double() - v.double()).abs().max())
                for k, v in want.items()}
    return peaks, diff


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
