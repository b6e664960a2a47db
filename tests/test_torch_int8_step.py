"""Turnkey int8 through the port's entry points: ``build_detect_step`` with
``extra.quantize = "int8"`` (``SelfQuantizingStep``, ``quantize_calib``, a
pre-built ``Int8Bundle``), its composition with the accuracy modes, and the
server's ``/stats`` fields.

CPU, f32, trained fixture, 96-px tiles (the fixture's training scale). The
state-machine tests are the counterparts of
tests/test_int8.py::test_int8_self_calibration_* and use their limits. The
port's int8 step is held against the JAX int8 step (``quad_stem: false``,
the same calibration file) by ``detection_sets_agree`` with every detection
matched.
"""

import io
import json
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu_torch.models.int8 import (
    Int8Bundle, load_absmax, save_absmax)
from aerial_image_recognition_tpu_torch.pipeline import inference
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    DetectStep, SelfQuantizingStep, build_detect_step, detection_sets_agree)
from aerial_image_recognition_tpu_torch.pipeline.serve import DetectionServer
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from test_torch_int8 import FIXTURE, SIZE, scene_tiles

CFG = dict(dtype="float32", params_path=FIXTURE, confidence_threshold=0.4,
           nms_preselect="exact", quad_stem=False)
BOUNDS = np.tile(np.asarray([[20.999, 52.199, 21.001, 52.201]], np.float32),
                 (12, 1))

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiles():
    return scene_tiles()


def _turnkey(batch=4, **extra):
    cfg = DetectorConfig.from_dict(dict(CFG, quantize="int8", **extra))
    return build_detect_step(cfg, batch=batch, model_size=SIZE, device="cpu")


@pytest.fixture(scope="module")
def swapped(tiles):
    """A turnkey step driven through its swap, with what it returned on the
    way."""
    step = _turnkey()
    states = [step.quantize_state]
    outs = []
    for k in (0, 4):
        outs.append(step(tiles[k:k + 4], BOUNDS[:4]))
        states.append(step.quantize_state)
    return step, states, outs


def test_turnkey_swaps_after_two_batches(swapped, tiles):
    step, states, outs = swapped
    assert isinstance(step, SelfQuantizingStep)
    assert states == ["calibrating", "calibrating", "int8"], \
        step.fallback_reason
    # the gate was not vacuous
    assert step.parity["total_a"] >= 4 and step.parity["matched"] >= 4
    assert step.fallback_reason is None
    assert isinstance(step.bundle, Int8Bundle)
    assert step.active_step is not step.base_step
    assert not isinstance(step.base_step.bundle, Int8Bundle)
    # the calibration batches' own (float) results were already final
    assert int(outs[0][0].valid.sum()) >= 4
    ref0 = step.base_step(tiles[0:4], BOUNDS[:4])
    assert torch.equal(outs[0][0].boxes, ref0[0].boxes)
    # post-swap batches run the int8 trunk and still match the float step
    out2 = step(tiles[8:12], BOUNDS[:4])
    ref2 = step.base_step(tiles[8:12], BOUNDS[:4])
    ok, stats = detection_sets_agree(ref2, out2)
    assert ok and stats["matched"] >= 4, stats
    assert not torch.equal(out2[0].scores, ref2[0].scores)   # it is int8


def test_step_surface(swapped):
    step, _, _ = swapped
    fresh = _turnkey(batch=6)
    for s, batch in ((step, 4), (fresh, 6)):
        assert (s.batch, s.input_size, s.model_size, s.input_layout,
                s.input_shardings, s.device) == \
            (batch, SIZE, SIZE, "hwc", None, torch.device("cpu"))
        assert s.bundle.spec.class_names == ("car",)
        x = np.zeros((1, 2, 2, 3), np.uint8)
        assert s.pack_images(x) is x
    assert fresh.quantize_state == "calibrating" and fresh.parity is None
    assert fresh.active_step is fresh.base_step


def test_waits_for_a_detection_bearing_batch(tiles):
    """Detection-free first batches must not flip the swap on a vacuous
    0-vs-0 parity pass; images are collected for the first
    ``quantize_calib_batches`` batches and the reference batch only."""
    step = _turnkey()
    copies = []
    real = SelfQuantizingStep._host_copy
    step._host_copy = lambda images: copies.append(1) or real(images)
    empty = np.zeros((4, SIZE, SIZE, 3), np.uint8)
    for _ in range(3):          # > quantize_calib_batches empty batches
        out = step(empty, BOUNDS[:4])
        assert int(out[0].valid.sum()) == 0
        assert step.quantize_state == "calibrating" and step.parity is None
    assert len(copies) == 2
    step(tiles[0:4], BOUNDS[:4])    # first detection-bearing batch
    assert step.quantize_state == "int8", step.fallback_reason
    assert step.parity["total_a"] >= 1 and step.parity["matched"] >= 1
    assert len(copies) == 3
    step(tiles[4:8], BOUNDS[:4])
    assert len(copies) == 3         # no host copies after the swap


def test_bounded_wait_settles_on_fallback(tiles):
    step = _turnkey(quantize_calib_batches=1, quantize_calib_wait_batches=2)
    empty = np.zeros((4, SIZE, SIZE, 3), np.uint8)
    step(empty, BOUNDS[:4])
    assert step.quantize_state == "calibrating"
    step(empty, BOUNDS[:4])                  # hits the wait bound
    assert step.quantize_state == "bf16-fallback"
    assert "no detections" in step.fallback_reason
    assert step.parity is None
    assert not isinstance(step.bundle, Int8Bundle)
    # detections later in the scan are not dropped: the float step runs
    out = step(tiles[0:4], BOUNDS[:4])
    assert int(out[0].valid.sum()) >= 4
    assert step.quantize_state == "bf16-fallback"


def test_forced_parity_miss_falls_back(tiles, monkeypatch, capsys):
    step = _turnkey(quantize_calib_batches=1)
    monkeypatch.setattr(inference, "detection_sets_agree",
                        lambda a, b, **kw: (False, {"forced": True}))
    step(tiles[0:4], BOUNDS[:4])
    assert step.quantize_state == "bf16-fallback"
    assert "parity" in step.fallback_reason
    assert step.parity == {"forced": True}
    assert "continuing in bf16" in capsys.readouterr().out
    out = step(tiles[4:8], BOUNDS[:4])
    assert not isinstance(step.bundle, Int8Bundle)
    assert int(out[0].valid.sum()) >= 4


def test_quantization_error_falls_back(tiles):
    step = _turnkey(quantize_calib_batches=1)
    step.base_step.bundle.variables = None       # nothing to quantize from
    out = step(tiles[0:4], BOUNDS[:4])
    assert step.quantize_state == "bf16-fallback"
    assert "ValueError" in step.fallback_reason
    assert int(out[0].valid.sum()) >= 4


@pytest.mark.parametrize("where", ["requantize", "conv_s32"])
def test_int8_step_error_escapes_the_swap(tiles, monkeypatch, where):
    """Only a checkpoint that cannot be quantized and a parity miss fall
    back. An error of the int8 step itself (a kernel that does not build or
    launch, a refused integer product) reaches the caller: the scan never
    carries on in the float step over it."""
    from aerial_image_recognition_tpu_torch.models import int8

    def broken(*a, **kw):
        raise RuntimeError(f"{where}: the launch failed")

    step = _turnkey(quantize_calib_batches=1)
    monkeypatch.setattr(int8, where, broken)
    with pytest.raises(RuntimeError, match="the launch failed"):
        step(tiles[0:4], BOUNDS[:4])
    assert step.quantize_state != "bf16-fallback"
    assert step.fallback_reason is None
    assert not isinstance(step.bundle, Int8Bundle)


def test_calibration_runs_in_8_row_chunks(tiles, monkeypatch):
    from aerial_image_recognition_tpu_torch.models import int8
    seen = []
    real = int8.quantize_bundle

    def spy(bundle, calib, **kw):
        seen.append([c.shape[0] for c in calib])
        return real(bundle, calib, **kw)

    monkeypatch.setattr(int8, "quantize_bundle", spy)
    step = _turnkey(batch=12, quantize_calib_batches=1)
    step(torch.from_numpy(tiles), torch.from_numpy(BOUNDS))  # tensors in
    assert step.quantize_state == "int8", step.fallback_reason
    assert seen == [[8, 4]]


def _same(out_a, out_b):
    pairs = list(zip(out_a[0], out_b[0])) + [(out_a[1], out_b[1]),
                                             (out_a[2], out_b[2])]
    return all(torch.equal(a, b) for a, b in pairs)


def test_quantize_calib_file_round_trip(swapped, tiles, tmp_path):
    """The table a turnkey step calibrated, saved and loaded, builds the
    same step: equal outputs at tolerance 0."""
    step, _, _ = swapped
    path = str(tmp_path / "absmax.json")
    save_absmax(path, step.bundle.absmax)
    assert load_absmax(path) == step.bundle.absmax
    cfg = DetectorConfig.from_dict(dict(CFG, quantize="int8",
                                        quantize_calib=path))
    file_step = build_detect_step(cfg, batch=4, model_size=SIZE,
                                  device="cpu")
    assert isinstance(file_step, DetectStep)
    assert isinstance(file_step.bundle, Int8Bundle)
    assert _same(file_step(tiles[8:12], BOUNDS[:4]),
                 step(tiles[8:12], BOUNDS[:4]))
    # a pre-built Int8Bundle passes straight through, quantize set or not
    for extra in ({}, {"quantize": "int8"}):
        pre = build_detect_step(DetectorConfig.from_dict(dict(CFG, **extra)),
                                batch=4, model_size=SIZE, device="cpu",
                                bundle=step.bundle)
        assert isinstance(pre, DetectStep) and pre.bundle is step.bundle
        assert _same(pre(tiles[8:12], BOUNDS[:4]),
                     step(tiles[8:12], BOUNDS[:4]))


def test_int8_step_matches_jax_int8_step(swapped, tiles, tmp_path):
    """Both packages' int8 steps from one calibration file: every
    detection matched (IoU >= 0.5, same class), mean |Δscore| <= 0.05."""
    step, _, _ = swapped
    path = str(tmp_path / "absmax.json")
    save_absmax(path, step.bundle.absmax)
    extra = dict(CFG, quantize="int8", quantize_calib=path)
    jax_step = jax_build_detect_step(JaxDetectorConfig.from_dict(extra),
                                     batch=12, model_size=SIZE)
    assert type(jax_step.bundle).__name__ == "Int8Bundle"
    assert jax_step.input_layout == "hwc"
    port_step = build_detect_step(DetectorConfig.from_dict(extra), batch=12,
                                  model_size=SIZE, device="cpu")
    jout = jax_step(tiles, BOUNDS)
    pout = port_step(tiles, BOUNDS)
    n = int(np.asarray(jout[0].valid).sum())
    assert n >= 12
    ok, stats = detection_sets_agree(pout, jout, min_match_frac=1.0)
    assert ok and stats["total_a"] == stats["total_b"] == stats["matched"] \
        == n, stats
    np.testing.assert_array_equal(pout[0].valid.numpy(),
                                  np.asarray(jout[0].valid))
    np.testing.assert_allclose(pout[0].scores.numpy(),
                               np.asarray(jout[0].scores), atol=0.02, rtol=0)


@pytest.fixture(scope="module")
def float_and_int8(swapped):
    step, _, _ = swapped

    def build(bundle, src=None, **extra):
        cfg = DetectorConfig.from_dict(dict(CFG, **extra))
        return build_detect_step(cfg, batch=12, model_size=SIZE, src_size=src,
                                 device="cpu", bundle=bundle)
    return lambda **kw: (build(step.base_step.bundle, **kw),
                         build(step.bundle, **kw))


def test_int8_composes_with_tta(float_and_int8, tiles):
    """Limits of tests/test_int8.py::test_int8_composes_with_tta: counts
    within ±1; strong float detections (score >= 0.6) found within 2 px
    and 0.05 in score."""
    step_f, step_q = float_and_int8(tta=True)
    det_f, det_q = step_f(tiles, BOUNDS)[0], step_q(tiles, BOUNDS)[0]
    n_f, n_q = det_f.valid.sum(1).numpy(), det_q.valid.sum(1).numpy()
    assert n_f.sum() >= 12
    assert int(np.abs(n_f - n_q).max()) <= 1
    for b in range(len(tiles)):
        v = det_f.valid[b]
        strong = det_f.scores[b][v] >= 0.6
        fb = det_f.boxes[b][v][strong].numpy()
        fs = det_f.scores[b][v][strong].numpy()
        gb = det_q.boxes[b][det_q.valid[b]].numpy()
        gs = det_q.scores[b][det_q.valid[b]].numpy()
        assert len(gb) or not len(fb)
        for r, s in zip(fb, fs):
            j = int(np.abs(gb[:, :2] - r[:2]).sum(axis=1).argmin())
            assert np.all(np.abs(gb[j, :2] - r[:2]) < 2.0), (b, r, gb[j])
            assert abs(gs[j] - s) < 0.05, (b, s, gs[j])


def test_int8_composes_with_multiscale(float_and_int8, tiles):
    """Per-tile counts equal (tests/test_int8.py:530)."""
    step_f, step_q = float_and_int8(multiscale=[0.85, 1.0, 1.15])
    det_f, det_q = step_f(tiles, BOUNDS)[0], step_q(tiles, BOUNDS)[0]
    assert int(det_f.valid.sum()) >= 12
    np.testing.assert_array_equal(det_q.valid.sum(1).numpy(),
                                  det_f.valid.sum(1).numpy())


def test_int8_composes_with_src_resize(float_and_int8):
    """130-px source windows resized into the 96-px model on the device;
    per-tile counts within ±1 (tests/test_int8.py:556)."""
    src = scene_tiles(130)
    step_f, step_q = float_and_int8(src=130)
    assert step_q.input_size == 130 and step_q.model_size == SIZE
    n_f = step_f(src, BOUNDS)[0].valid.sum(1).numpy()
    n_q = step_q(src, BOUNDS)[0].valid.sum(1).numpy()
    assert n_f.sum() >= 12
    assert int(np.abs(n_f - n_q).max()) <= 1


def test_server_stats_show_the_quantize_state(tiles):
    step = _turnkey(quantize_calib_batches=1)
    srv = DetectionServer(detect_step=step, max_wait_ms=5.0).start(
        warmup=False)
    try:
        def stats():
            with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
                return json.load(r)
        first = stats()
        assert first["quantize_state"] == "calibrating"
        assert first["quantize_parity"] is None
        assert "quantize_fallback_reason" not in first
        for k in range(2):
            buf = io.BytesIO()
            Image.fromarray(tiles[k]).save(buf, "PNG")
            w, s, e, n = (float(v) for v in BOUNDS[k])
            req = urllib.request.Request(
                f"{srv.url}/detect?west={w!r}&south={s!r}&east={e!r}"
                f"&north={n!r}", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                body = json.load(r)
            assert r.status == 200 and body["count"] >= 1
        after = stats()
        assert after["quantize_state"] == "int8", after
        assert after["quantize_parity"]["matched"] >= 1
    finally:
        srv.stop()
    # a float step's /stats has no such fields; a fallback has its reason
    plain = DetectionServer(detect_step=step.base_step).start(warmup=False)
    try:
        with urllib.request.urlopen(plain.url + "/stats", timeout=30) as r:
            assert "quantize_state" not in json.load(r)
    finally:
        plain.stop()
    fallen = _turnkey(quantize_calib_batches=1, quantize_calib_wait_batches=1)
    fallen(np.zeros((4, SIZE, SIZE, 3), np.uint8), BOUNDS[:4])
    srv = DetectionServer(detect_step=fallen).start(warmup=False)
    try:
        with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
            body = json.load(r)
        assert body["quantize_state"] == "bf16-fallback"
        assert "no detections" in body["quantize_fallback_reason"]
    finally:
        srv.stop()
