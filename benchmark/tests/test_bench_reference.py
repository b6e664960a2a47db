"""The plain reference against the program on the CPU, at a small size.

The reference's families (``reference/families/``), YOLOv7-tiny on the
trained fixture and YOLOv8l seeded by the benchmark's own weights maker,
against the port's f32 modules on the same weights, raw head maps and
decoded boxes; its greedy NMS against a brute-force loop; and what the
harness, its traffic and its reference load: no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``aerial_image_recognition_tpu``,
and in the reference nothing of the port either.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.lib import registry, tiles, weights
from benchmark.reference import post

ROOT = registry.ROOT


def _config(name):
    with open(os.path.join(registry.BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


def _port_maps(cfg, tree, x):
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    bundle = create_model(cfg["registry"], variables=tree,
                          dtype=torch.float32, device="cpu")
    with torch.no_grad():
        return bundle.module(x), bundle


@pytest.mark.parametrize("name, size", [("yolov7-tiny-itcvd", 96),
                                        ("yolov8l-tokyo", 64)])
def test_reference_matches_port_f32(name, size):
    cfg = _config(name)
    family = registry.family(cfg["reference"])
    pool, _ = tiles.render_tiles(np.random.default_rng(3), 2, size)
    flat, tree = weights.make(cfg, family, 3, torch.device("cpu"), ROOT,
                              pool)
    x = torch.from_numpy(pool).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        ref = family.forward(cfg, flat, x)
        ref_boxes, ref_scores = family.decode(cfg, ref)
    maps, bundle = _port_maps(cfg, tree, x)
    for a, b in zip(ref, maps):
        scale = float(b.abs().max())
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * scale
    with torch.no_grad():
        boxes, scores = bundle.forward(x)
    assert float((ref_boxes - boxes).abs().max()) <= 1e-3
    assert float((ref_scores - scores).abs().max()) <= 1e-4


def test_reference_detections_match_port_step():
    """The reference's detections and lon/lat against the port's whole f32
    step (decode, NMS, lon/lat) on the fixture, at 96 px."""
    from aerial_image_recognition_tpu_torch.pipeline.inference import (
        build_detect_step)
    from aerial_image_recognition_tpu_torch.post.georef import (
        detections_to_records)
    from benchmark.lib import program
    cfg = _config("yolov7-tiny-itcvd")
    family = registry.family(cfg["reference"])
    pool, bounds = tiles.render_tiles(np.random.default_rng(5), 4, 96)
    flat, tree = weights.make(cfg, family, 5, torch.device("cpu"), ROOT,
                              pool)
    dc = program.detector_config(cfg, dtype="float32",
                                 confidence_threshold=0.3)
    step = build_detect_step(dc, batch=4, bundle=program.bundle(
        dict(cfg, dtype="float32"), tree, torch.device("cpu")),
        model_size=96, device="cpu")
    out = step(pool, bounds.astype(np.float32))
    recs = detections_to_records(out[0], bounds.astype(np.float32), 96)
    x = post.to_model_input(torch.from_numpy(pool), 96)
    with torch.no_grad():
        kept = family.answer(cfg, flat, x, conf=0.3, iou_thr=0.45,
                             max_det=64, pre_topk=256)
    for t, (box, score, _) in enumerate(kept):
        mine = sorted(r["confidence"] for r in recs if r["tile_index"] == t)
        assert len(mine) == len(score)
        assert np.allclose(sorted(score), mine, atol=1e-5)
        lon, lat = post.lonlat(box[:, :2], bounds[t].astype(np.float32), 96)
        got = sorted((r["lon"], r["lat"]) for r in recs
                     if r["tile_index"] == t)
        assert np.allclose(sorted(zip(lon, lat)), got, atol=1e-7)


def _brute_nms(boxes, scores, thr, conf):
    order = sorted(range(len(scores)), key=lambda i: (-scores[i], i))
    kept = []
    for i in order:
        if scores[i] < conf:
            continue
        if all(float(post.iou(boxes[i][None], boxes[j][None])[0, 0]) <= thr
               for j in kept):
            kept.append(i)
    return kept


@pytest.mark.parametrize("seed", range(4))
def test_greedy_nms_matches_brute_force(seed):
    g = torch.Generator().manual_seed(seed)
    n = 60
    xy = torch.rand(1, n, 2, generator=g) * 100
    wh = torch.rand(1, n, 2, generator=g) * 30 + 5
    boxes = torch.cat([xy, wh], -1)
    scores = torch.rand(1, n, 1, generator=g)
    scores[0, ::7] = scores[0, 3]                  # ties go to the lower index
    got = post.greedy_nms(boxes, scores, conf=0.2, iou_thr=0.45, max_det=n,
                          pre_topk=n)[0]
    want = _brute_nms(boxes[0], scores[0, :, 0].tolist(), 0.45, 0.2)
    assert sorted(got[1].tolist()) == sorted(
        float(scores[0, i, 0]) for i in want)


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


FORBIDDEN = {"jax", "jaxlib", "flax", "aerial_image_recognition_tpu"}


def test_reference_loads_nothing_of_either_package():
    found = _loaded("import os\nfrom benchmark.lib import registry\n"
                    "for f in os.listdir('benchmark/reference/families'):\n"
                    "    if f.endswith('.py'):\n"
                    "        registry.family(f[:-3])")
    assert not found & (FORBIDDEN | {"aerial_image_recognition_tpu_torch"})


def test_harness_and_traffic_load_no_jax():
    """A whole run of a cell, at a tiny size on the CPU, in a process of
    its own: nothing it loaded has a forbidden top-level name."""
    found = _loaded(
        "import sys\nsys.path.insert(0, 'benchmark/tests')\n"
        "import tiny\ntiny.run_cell('v7tiny-scan-1280', 3)\n"
        "tiny.run_cell('v7tiny-ring-640', 3)")
    assert "aerial_image_recognition_tpu_torch" in found
    assert not found & FORBIDDEN


def test_no_card_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "v7tiny-ring-640",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
