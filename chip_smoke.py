#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (aerial_image_recognition_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero, and no result line is printed):
  1. the card, from nvidia-smi (name, power limit);
  2. build every CUDA kernel of the main path from ``csrc/`` (timed);
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (NMS: B=64, K=256, D=64; class-agnostic and class-aware,
     score ties, all below the confidence threshold): bit-identical outputs
     required (tolerance 0); kernel, plain and bound times;
  4. the main path at full width: the YOLOv7-tiny detect step from the
     trained fixture, 640 px, batch 64, bf16, on synthetic 0.5 m/px tiles
     with known car positions; step time and tiles/s; its detections held
     against the port's f32 step on the same card (matched fraction ≥ 0.9 at
     IoU 0.5, detection_sets_agree) and against the rendered cars;
  5. the port's DetectionServer over that step answers JPEG POST /detect
     requests.
Launch counts are zeroed just before phase 4 and read just after phase 5;
every kernel of the path must have launched in that window.

Output: the card line, then a ``{"kernels": [...]}`` JSON line, then the
last line ``{"ok": true, "device": {...}}``. The full record also goes to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX.
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
B, SIZE, K, D = 64, 640, 256, 64
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 (non-tensor)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12                         # tensor cores, dense


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


def nms_inputs(rng, case: str):
    """Kernel inputs at the main path's shapes: boxes_t [B,4,K] cxcywh in a
    640-px frame (half of them jittered copies of the other half), masked
    scores [B,K] (−1 below conf), classes [B,K]."""
    import numpy as np
    cx = rng.uniform(0, SIZE, (B, K))
    cy = rng.uniform(0, SIZE, (B, K))
    wh = rng.uniform(8, 60, (B, 2, K))
    boxes = np.concatenate([cx[:, None], cy[:, None], wh], 1)
    boxes[:, :, K // 2:] = boxes[:, :, :K // 2] \
        + rng.normal(0, 3, (B, 4, K // 2))
    scores = rng.uniform(0, 1, (B, K))
    if case == "ties":
        scores = rng.integers(0, 8, (B, K)) / 8.0
        boxes[:, :, 1::5] = boxes[:, :, 0:K - 1:5]
    scores = np.sort(scores, axis=1)[:, ::-1]           # preselect order
    masked = np.where(scores >= 0.3, scores, -1.0)
    if case == "below-conf":
        masked[:] = -1.0
    classes = rng.integers(0, 3, (B, K))
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
    from aerial_image_recognition_tpu_torch.ops.nms import _suppress_plain
    from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
        nms_suppress)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    cases = [("agnostic", "random", False), ("aware", "random", True),
             ("ties-agnostic", "ties", False), ("ties-aware", "ties", True),
             ("below-conf", "below-conf", True)]
    max_err = 0.0
    timing_args = None
    for name, kind, aware in cases:
        args = [torch.from_numpy(a).to(dev) for a in nms_inputs(rng, kind)]
        kw = dict(iou_threshold=0.45, max_det=D, class_aware=aware)
        got = nms_suppress(*args, **kw)
        want = _suppress_plain(*args, **kw)
        torch.cuda.synchronize()
        for label, g, w in zip(("idx", "conf", "cls"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                bad = int((g != w).sum())
                fail(f"nms_suppress {name}: {label} differs from the plain "
                     f"version in {bad} of {g.numel()} slots")
        max_err = max(max_err, float((got[1] - want[1]).abs().max()))
        if name == "agnostic":
            timing_args, timing_kw = args, kw
        record["nms_cases"].append({"case": name, "bit_identical": True,
                                    "picks_valid": int((got[1] >= 0.3).sum())})
    ms = cuda_ms(lambda: nms_suppress(*timing_args, **timing_kw), 200)
    plain_ms = cuda_ms(lambda: _suppress_plain(*timing_args, **timing_kw), 5,
                       warmup=1)
    nbytes = sum(a.numel() * a.element_size() for a in timing_args) \
        + 3 * B * D * 4
    # per candidate once: half-extents, corners, area (9 flops); per round
    # and candidate: argmax compare + IoU with the pick and the > test (15)
    flops = B * (9 * K + D * 15 * K)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS * 1e3
    return {"name": "nms_suppress", "route": "cuda",
            "source": "aerial_image_recognition_tpu_torch/csrc/nms_suppress.cu",
            "replaces": "aerial_image_recognition_tpu/ops/pallas_kernels.py:85",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is missing: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke needs one CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from aerial_image_recognition_tpu_torch.kernels.build import build_all
        from aerial_image_recognition_tpu_torch.ops.nms_kernel import (
            nms_suppress)
        from aerial_image_recognition_tpu_torch.pipeline.inference import (
            build_detect_step, detection_sets_agree)
        from aerial_image_recognition_tpu_torch.pipeline.serve import (
            DetectionServer)
        from aerial_image_recognition_tpu_torch.runtime.config import (
            DetectorConfig)
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    if not os.path.exists(FIXTURE):
        fail(f"trained fixture missing: {FIXTURE}")
    import numpy as np

    record = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0], "nms_cases": []}

    # 1. the card
    card = card_line()
    print(card, flush=True)
    record["card"] = card
    name = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    build_all(["nms_suppress"])
    record["build_s"] = time.perf_counter() - t0
    print(f"build: nms_suppress in {record['build_s']:.2f} s", flush=True)

    # 3. kernel vs plain
    kernel = check_nms_kernel(torch, record)
    print(f"nms_suppress: bit-identical to plain on "
          f"{len(record['nms_cases'])} cases; {kernel['ms']:.4f} ms "
          f"(plain {kernel['plain_ms']:.3f} ms, bound "
          f"{kernel['bound_ms']:.6f} ms) [{card}]", flush=True)

    # 4. the main path at full width, and its f32 reference on this card
    rng = np.random.default_rng(1)
    images, bounds, cars = render_tiles(rng, B, SIZE)
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

    nms_suppress.launches = 0                    # main path starts here
    out = step(images, bounds)
    torch.cuda.synchronize()
    n_iter = 20
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = step(images, bounds)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_iter * 1e3
    dev_images = torch.from_numpy(images).cuda()
    dev_bounds = torch.from_numpy(bounds).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        step(dev_images, dev_bounds)
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) / n_iter * 1e3

    # 5. the server over the same step
    srv = DetectionServer(detect_step=step, max_wait_ms=20.0).start()
    try:
        n_req = 6
        replies = post_jpegs(srv.url, images, bounds, n_req)
        with urllib.request.urlopen(srv.url + "/stats", timeout=60) as r:
            stats = json.load(r)
    finally:
        srv.stop()
    launches = nms_suppress.launches             # main path ends here
    kernel["launches"] = launches
    if launches == 0:
        fail("the main path never launched nms_suppress")

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

    # what came out is right
    det, lon, lat = out
    if tuple(det.boxes.shape) != (B, D, 4) or tuple(lon.shape) != (B, D):
        fail(f"output shapes {tuple(det.boxes.shape)} {tuple(lon.shape)}")
    for label, t in (("boxes", det.boxes), ("scores", det.scores),
                     ("lon", lon), ("lat", lat)):
        if not bool(torch.isfinite(t).all()):
            fail(f"non-finite {label}")
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
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    record.update(step=step_rec, server={
        "requests": n_req, "stats": stats,
        "counts": [body["count"] for _, body in replies]})
    record["kernels"] = [kernel]
    print(f"step: {step_ms:.2f} ms/batch of {B} (host uint8 input), "
          f"{B / step_ms * 1e3:.1f} tiles/s; {device_ms:.2f} ms with the "
          f"batch already on the card; {n_det} detections, f32 agreement "
          f"{agree}, recall bf16 {rec_bf16:.3f} f32 {rec_f32:.3f} [{card}]",
          flush=True)
    print(f"server: {n_req} JPEG /detect requests answered, "
          f"{stats['batches']} batches [{card}]", flush=True)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
