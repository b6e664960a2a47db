"""The port's training data, metrics, ``evaluate`` and ``fit`` against the
JAX package's, on the CPU.

* ``pipeline/data.py``: COCO conversion with the Tokyo remap, YOLO label
  files, the split, and ``DetectionLoader`` batches for the same seed and
  augmentations (mosaic, mixup, HSV, copy-paste, affine, flips,
  close_mosaic; eval's ragged tail): equal, tolerance 0.
* ``ops/metrics.py``: equal on the same predictions (tolerance 0).
* ``evaluate`` on the trained fixture (96-px FakeWorld tiles at its 0.5
  m/px, exact boxes, a ragged last batch): mAP50, mAP50-95 and AP50 within
  1e-6 of the JAX package's (the NMS picks are the same).
* ``fit`` with a scripted evaluation in both packages (the same mAP
  sequence): history (losses within rtol 1e-4: Adam's noise-level sign
  flips move a leaf by 2·lr a step), fitness, best epoch, early stop,
  ``best`` params within 4·lr·steps.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model)
from aerial_image_recognition_tpu.ops import metrics as JM
from aerial_image_recognition_tpu.pipeline import data as JD
from aerial_image_recognition_tpu.pipeline import train as JT
from aerial_image_recognition_tpu_torch.models.registry import create_model
from aerial_image_recognition_tpu_torch.models.weights import _flatten
from aerial_image_recognition_tpu_torch.ops import metrics as PM
from aerial_image_recognition_tpu_torch.pipeline import data as PD
from aerial_image_recognition_tpu_torch.pipeline import train as PT

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in _flatten(tree)}


def _coco(tmp_path, n_images=6):
    images = [{"id": i, "file_name": f"im{i}.png", "width": 100,
               "height": 80} for i in range(n_images)]
    cats = [{"id": 1, "name": "Car"}, {"id": 2, "name": "Truck"},
            {"id": 3, "name": "Van"}, {"id": 4, "name": "Ignored"}]
    anns = []
    for i in range(n_images):
        anns += [{"id": i * 10, "image_id": i, "category_id": 1,
                  "bbox": [10, 10, 20, 10]},
                 {"id": i * 10 + 1, "image_id": i, "category_id": 2,
                  "bbox": [50, 40, 10, 20]},
                 {"id": i * 10 + 2, "image_id": i, "category_id": 4,
                  "bbox": [0, 0, 5, 5]}]
    p = str(tmp_path / "coco.json")
    with open(p, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    return p


@pytest.mark.parametrize("remap", [True, False], ids=["tokyo", "raw"])
def test_coco_labels_and_split_equal_jax(tmp_path, remap):
    coco = _coco(tmp_path)
    r = (PD.TOKYO_CLASS_REMAP if remap else None,
         JD.TOKYO_CLASS_REMAP if remap else None)
    assert PD.TOKYO_CLASS_REMAP == JD.TOKYO_CLASS_REMAP
    got, want = PD.coco_to_yolo(coco, r[0]), JD.coco_to_yolo(coco, r[1])
    assert [s.image_path for s in got] == [s.image_path for s in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.boxes, b.boxes)
    PD.write_yolo_labels(got, str(tmp_path / "p"))
    JD.write_yolo_labels(want, str(tmp_path / "j"))
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "p" / name).read_text() \
            == (tmp_path / "j" / name).read_text()
    for seed in (0, 3):
        pa, pb = PD.train_val_split(got, 4, seed=seed)
        ja, jb = JD.train_val_split(want, 4, seed=seed)
        assert [s.image_path for s in pa + pb] \
            == [s.image_path for s in ja + jb]


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """10 PNG tiles of varied sizes with two boxes each."""
    base = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(3)
    paths, boxes = [], []
    for i in range(10):
        side = int(rng.integers(40, 80))
        p = str(base / f"t{i}.png")
        Image.fromarray(rng.integers(0, 255, (side, side, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(p)
        boxes.append(np.asarray([[0, *rng.uniform(0.2, 0.8, 2),
                                  *rng.uniform(0.1, 0.3, 2)],
                                 [1, *rng.uniform(0.2, 0.8, 2),
                                  *rng.uniform(0.1, 0.3, 2)]], np.float32))
    return paths, boxes


@pytest.mark.parametrize("cfg,train", [
    (dict(), True),
    (dict(copy_paste=0.7, fliplr=0.5, flipud=0.5, scale=0.5,
          translate=0.1), True),
    (dict(mosaic=0.0, mixup=0.0, hsv=0.0), False),
    (dict(close_mosaic=1, copy_paste=0.5, fliplr=0.5), True),
], ids=["mosaic-mixup-hsv", "paste-affine-flips", "eval-ragged",
        "close-mosaic"])
def test_loader_batches_equal_jax(tiles, cfg, train):
    paths, boxes = tiles
    kw = dict(image_size=48, batch_size=4, max_targets=16, seed=5, **cfg)
    ploader = PD.DetectionLoader([PD.Sample(p, b) for p, b in
                                  zip(paths, boxes)], PD.LoaderConfig(**kw),
                                 train=train)
    jloader = JD.DetectionLoader([JD.Sample(p, b) for p, b in
                                  zip(paths, boxes)], JD.LoaderConfig(**kw),
                                 train=train)
    if cfg.get("close_mosaic"):
        ploader.total_epochs = jloader.total_epochs = 2
    n = 0
    for epoch in (0, 1):
        got = list(ploader.epoch(epoch))
        want = list(jloader.epoch(epoch))
        assert len(got) == len(want) == (3 if not train else 2)
        for (gi, gt), (wi, wt) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gt, wt)
            n += (gt[:, :, 0] >= 0).sum()
    assert n > 0


def test_metrics_equal_jax():
    rng = np.random.default_rng(4)
    preds, gts = [], []
    for _ in range(6):
        g = rng.uniform(5, 60, (int(rng.integers(0, 6)), 4))
        gts.append({"boxes": g, "classes": rng.integers(0, 2, len(g))})
        p = np.concatenate([g + rng.normal(0, 2, g.shape),
                            rng.uniform(5, 60, (3, 4))]) if len(g) else \
            rng.uniform(5, 60, (2, 4))
        preds.append({"boxes": p, "classes": rng.integers(0, 2, len(p)),
                      "scores": rng.uniform(0, 1, len(p))})
    got = PM.evaluate_detections(preds, gts, 2)
    want = JM.evaluate_detections(preds, gts, 2)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    a, b = rng.uniform(5, 50, (7, 4)), rng.uniform(5, 50, (5, 4))
    np.testing.assert_array_equal(PM.iou_xywh(a, b), JM.iou_xywh(a, b))
    r, pr = np.sort(rng.uniform(size=9)), rng.uniform(size=9)
    assert PM.average_precision(r, pr) == JM.average_precision(r, pr)


@pytest.fixture(scope="module")
def world_set(tmp_path_factory):
    """10 FakeWorld tiles of 96 px at the trained fixture's 0.5 m/px with
    exact car boxes, as samples of both packages."""
    from test_predict_val import WORLD, _bbox, _gt_boxes_xyxy
    base = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(12)
    samples = []
    for i in range(10):
        lon, lat, _ = WORLD.cars[int(rng.integers(0, 400))]
        bbox = _bbox(float(lon), float(lat))
        p = str(base / f"w{i}.png")
        Image.fromarray(WORLD.render(bbox, 96, 96)).save(p)
        xyxy = _gt_boxes_xyxy(bbox, 96).reshape(-1, 4)
        b = np.zeros((len(xyxy), 5), np.float32)
        b[:, 1] = (xyxy[:, 0] + xyxy[:, 2]) / 2 / 96
        b[:, 2] = (xyxy[:, 1] + xyxy[:, 3]) / 2 / 96
        b[:, 3] = (xyxy[:, 2] - xyxy[:, 0]) / 96
        b[:, 4] = (xyxy[:, 3] - xyxy[:, 1]) / 96
        samples.append((p, b))
    assert sum(len(b) for _, b in samples) >= 10
    return samples


def test_evaluate_equals_jax_on_the_trained_fixture(world_set):
    cfg = dict(image_size=96, batch_size=4, mosaic=0.0, mixup=0.0, hsv=0.0)
    jb = jax_create_model("yolov7_itcvd", dtype=jnp.float32,
                          params_path=FIXTURE)
    pb = create_model("yolov7_itcvd", dtype=torch.float32,
                      params_path=FIXTURE, device="cpu")
    jl = JD.DetectionLoader([JD.Sample(*s) for s in world_set],
                            JD.LoaderConfig(**cfg), train=False)
    pl = PD.DetectionLoader([PD.Sample(*s) for s in world_set],
                            PD.LoaderConfig(**cfg), train=False)
    assert [len(i) for i, _ in pl.epoch(0)] == [4, 4, 2]
    want = JT.evaluate(jb, jb.params, jl, conf_threshold=0.25)
    got = PT.evaluate(pb, PT.state_from_flax(pb.variables), pl,
                      conf_threshold=0.25)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["mAP50"] >= 0.7
    # the trainer's own state gives the same numbers
    state = PT.init_train_state(pb, PT.make_optimizer())
    assert PT.evaluate(pb, state, pl) == got


def test_fit_history_best_and_patience_equal_jax(world_set, monkeypatch):
    """Both packages' ``fit`` with the same scripted mAP sequence in place
    of their evaluation: best at epoch 1, early stop at epoch 3
    (patience 2), the same history."""
    maps = [(0.5, 0.4), (0.9, 0.8), (0.3, 0.2), (0.3, 0.2)]

    def scripted():
        it = iter(maps)

        def fake_evaluate(bundle, state, loader, conf_threshold=0.25):
            m50, m5095 = next(it)
            return {"mAP50": m50, "mAP50_95": m5095}
        return fake_evaluate

    cfg = dict(image_size=96, batch_size=4, seed=1)
    lr = 1e-3
    out = {}
    for mod, data, bundle in (
            (JT, JD, jax_create_model("yolov7_itcvd", dtype=jnp.float32,
                                      params_path=FIXTURE)),
            (PT, PD, create_model("yolov7_itcvd", dtype=torch.float32,
                                  params_path=FIXTURE, device="cpu"))):
        monkeypatch.setattr(mod, "evaluate", scripted())
        loader = data.DetectionLoader([data.Sample(*s) for s in world_set],
                                      data.LoaderConfig(**cfg))
        logs = []
        out[mod] = (mod.fit(bundle, loader, epochs=10, lr=lr,
                            eval_loader=loader, eval_every=1, patience=2,
                            freeze=[0, 1, 2], log_fn=logs.append), logs)
    (j, jlogs), (p, plogs) = out[JT], out[PT]
    assert len(p["history"]) == len(j["history"]) == 4
    for pr, jr in zip(p["history"], j["history"]):
        assert pr.keys() == jr.keys()
        np.testing.assert_allclose(pr["loss"], jr["loss"], rtol=1e-4)
        for k in pr:
            if k != "loss":
                assert pr[k] == jr[k], k
    assert [m for m in plogs if "early stop" in m] \
        == [m for m in jlogs if "early stop" in m] != []
    assert p["best"]["epoch"] == j["best"]["epoch"] == 1
    assert p["best"]["fitness"] == j["best"]["fitness"]
    steps = 2 * 2
    jbest = _flat(jax.tree_util.tree_map(np.asarray, j["best"]["params"]))
    pbest = _flat(p["best"]["params"])
    assert pbest.keys() == jbest.keys()
    for k in jbest:
        np.testing.assert_allclose(pbest[k], jbest[k], rtol=0,
                                   atol=4 * lr * steps + 1e-6, err_msg=k)
    assert p["step"] == int(j["step"]) == 8
