"""The port's int8 trunks of yolov7-base and YOLOv8 against the JAX
package's (models/int8.py), and turnkey int8 on the trained yolov8n.

f32 on the CPU, 96-px tiles. yolov8n runs the trained fixture on FakeWorld
tiles at its training scale (0.1 m/px); yolov7-base runs random upstream-
named weights (seed 13) imported by the port's importer. Inputs from seeds
with numpy. Tolerances, each stated where it is used:

* calibration: the same keys as the JAX package's (every ConvBN and every
  yolov8 Bottleneck output), values within rtol 1e-5 (BN folded here);
* the same ``absmax`` table → ``_Prepare`` qparams and static scales equal
  bit for bit;
* the trunk on the same P2 codes against the JAX trunk run eagerly (as
  ``_Run`` executes it op by op): tap codes equal, boxes within 1e-2 px +
  1e-4 of their size and scores within 1e-4 (f32 heads and decode in
  another summation order);
* the bundle's forward from the images against the JAX forward under
  ``jax.jit``: P2 codes flip on <= 1e-3 of them (BN folded into the f32
  stems here, not there) and XLA's fused epilogue rounds some silu codes
  one step away from the eager chain's, which later convs carry on; every
  score within 0.02, boxes of the detections within 0.25 px + 5e-3 of
  their size;
* the quad-stem entry: yolov8n has it, with the fully-int8 stems the JAX
  bundle has (their codes are held in tests/test_torch_quadstem.py), and
  yolov7-base's four-conv stem refuses it as the JAX package's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.models import int8 as J
from aerial_image_recognition_tpu.models.registry import (
    REGISTRY as JAX_REGISTRY, ModelBundle as JaxBundle,
    load_params as jax_load_params, save_params as jax_save_params)
from aerial_image_recognition_tpu.models.upstream_spec import (
    YOLOV7_BASE_SPEC, make_state_dict)
from aerial_image_recognition_tpu_torch.models import int8 as P
from aerial_image_recognition_tpu_torch.models.import_torch import (
    variables_from_torch_state)
from aerial_image_recognition_tpu_torch.models.registry import create_model
from aerial_image_recognition_tpu_torch.models.yolov8 import SCALES
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    SelfQuantizingStep, build_detect_step, detection_sets_agree)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from test_torch_families import V8_FIXTURE, v8_tiles

SIZE = 96
CPU = torch.device("cpu")
FAMILIES = ("yolov8n", "yolov7_base")

torch.set_num_threads(2)


class _Names:
    """A trunk-graph interpreter that only records the scopes it reads."""

    def __init__(self):
        self.names = []

    def conv(self, name, x, kernel, stride=1):
        self.names.append(name)
        return P.QT(None, 1.0, 0)

    def add(self, key, y, x):
        self.names.append(key)
        return y

    def split2(self, x):
        return x, x

    pool2 = pool_same = up2 = lambda self, x, *a: x


def _trunk_names(family):
    g = _Names()
    if family == "yolov8n":
        P._v8_trunk(g, P.QT(None, 1.0, 32), SCALES["n"][0])
    else:
        P._v7base_trunk(g, P.QT(None, 1.0, 128))
    return g.names


NAMES = {f: _trunk_names(f) for f in FAMILIES}
CONVS = [(f, n) for f in FAMILIES for n in NAMES[f]
         if not (f == "yolov8n" and "/m" in n and n.count("/") == 1)]


def _jax_absmax(jb, x):
    """``J.calibrate_absmax`` on one float batch at the model size, with
    its forward jitted: absmax of every captured module output."""
    inter = jax.jit(lambda p, x: jb.module.apply(
        p, x, train=False, capture_intermediates=True,
        mutable=["intermediates"])[1])(jb.params, jnp.asarray(x))
    return {k: float(jnp.max(jnp.abs(v.astype(jnp.float32)))) for k, v in
            J.flatten_intermediates(inter["intermediates"]).items()}


def _build(family, tmp_path_factory):
    if family == "yolov8n":
        path = V8_FIXTURE
        tiles = v8_tiles(n_car=8, n_empty=0)[0]
    else:
        tree = variables_from_torch_state(
            make_state_dict(YOLOV7_BASE_SPEC, nc=1, seed=13), "yolov7_base")
        path = str(tmp_path_factory.mktemp("v7b") / "yolov7_base.npz")
        jax_save_params(tree, path)
        tiles = np.random.default_rng(13).integers(
            0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    spec = JAX_REGISTRY[family]
    jb = JaxBundle(spec=spec, module=spec.make_module(dtype=jnp.float32),
                   params=jax.tree_util.tree_map(
                       lambda a: jnp.asarray(a, jnp.float32),
                       jax_load_params(path)))
    pb = create_model(family, params_path=path, dtype=torch.float32,
                      device="cpu", fold_bn=True)
    x = tiles.astype(np.float32) / np.float32(255.0)
    absmax = _jax_absmax(jb, x)
    return dict(jb=jb, pb=pb, tiles=tiles, x=x, absmax=absmax,
                jq=J.quantize_bundle(jb, [], absmax=absmax),
                pq=P.quantize_bundle(pb, [], absmax=absmax), path=path)


@pytest.fixture(scope="module")
def fams(tmp_path_factory):
    return {f: _build(f, tmp_path_factory) for f in FAMILIES}


# ------------------------------------------------------------ 1. qparams

def test_transcriptions_read_every_conv():
    assert len(NAMES["yolov8n"]) == len(set(NAMES["yolov8n"])) == 55 + 6
    assert len(NAMES["yolov7_base"]) == len(set(NAMES["yolov7_base"])) == 85


def test_calibration_keys_and_values_match_jax(fams):
    """The hook keys equal the JAX package's scope keys (nested yolov8
    scopes included): every key a trunk reads is recorded on both sides,
    values within rtol 1e-5."""
    for family, f in fams.items():
        got = P.calibrate_absmax(f["pb"], [f["tiles"]], model_size=SIZE)
        stems = {"yolov8n": {"stem", "down2"},
                 "yolov7_base": {f"stem{i}" for i in range(4)}}[family]
        assert set(NAMES[family]) | stems <= set(got) <= set(f["absmax"])
        for k, v in got.items():
            np.testing.assert_allclose(v, f["absmax"][k], rtol=1e-5,
                                       err_msg=f"{family} {k}")


@pytest.mark.parametrize("family,name", CONVS,
                         ids=[f"{f}-{n}" for f, n in CONVS])
def test_prepare_qparams_bit_equal(fams, family, name):
    jqp = fams[family]["jq"].params["q"]["convs"][name]
    pqp = fams[family]["pq"].params["q"]["convs"][name]
    assert set(pqp) == set(jqp) == {"w8", "m", "b", "inv"}
    for key in ("w8", "m", "b", "inv"):
        want = np.asarray(jqp[key])
        got = np.asarray(pqp[key])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_prepare_scales_and_ends(fams, family):
    f = fams[family]
    jq, pq = f["jq"], f["pq"]
    assert set(pq.params["q"]["convs"]) == set(jq.params["q"]["convs"])
    assert pq.params["q"]["p2_scale"] == np.float32(jq.params["q"]["p2_scale"])
    assert pq.static_scales == jq.static_scales
    assert [np.float32(s) for s in jq.params["q"].get("out_scales", [])] \
        == pq.params["q"].get("out_scales", [])
    # only the stems and the f32 heads stay floating point
    names = {n.rsplit(".", 1)[0] for n, _ in pq.module.named_parameters()}
    if family == "yolov8n":
        assert names == {"stem.conv", "down2.conv"} | {
            f"detect.{k}{i}_out" for i in range(3) for k in ("box", "cls")}
        assert set(pq.params["orig"]["params"]["detect"]) == {
            f"{k}{i}_out" for i in range(3) for k in ("box", "cls")}
    else:
        assert names == {f"stem{i}.conv" for i in range(4)} | {
            "detect0", "detect1", "detect2"}
        assert pq.module.anchors == f["pb"].module.anchors
    has_quad = family == "yolov8n"
    assert pq.supports_s2d2() == has_quad
    assert ("stems" in pq.q) == ("stems" in jq.params["q"]) == has_quad
    zeros = torch.zeros(1, 24, 24, 48, dtype=torch.uint8)
    if has_quad:
        boxes, scores = pq.forward_s2d2(zeros)
        # 96-px tiles: 12² + 6² + 3² anchors, two classes
        assert boxes.shape == (1, 189, 4) and scores.shape == (1, 189, 2)
        assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
    else:
        with pytest.raises(NotImplementedError, match="quad"):
            pq.forward_s2d2(zeros)
    # the bridge: the reference's q tree → the same bundle
    q = P.qparams_from_jax(jax.device_get(jq.params["q"]), jq.static_scales)
    rebuilt = P.Int8Bundle.from_q(f["pb"].spec, f["pb"].variables, q,
                                  dtype=torch.float32, device=CPU)
    assert rebuilt.static_scales == pq.static_scales
    assert type(rebuilt.module) is type(pq.module) \
        and getattr(rebuilt.module, "scale", None) == getattr(
            pq.module, "scale", None)


# --------------------------------------------------- 2. the trunk's codes

def _jax_taps(f, family, p2):
    jq = f["jq"]
    scales = jq.static_scales
    q = jq.params["q"]

    if family == "yolov8n":
        g = J._Run(q["convs"], act="silu", scales=scales)
        pairs = J._v8_trunk(g, J.QT(p2, scales["__p2__"], p2.shape[-1]),
                            SCALES["n"][0])
        return [np.asarray(t.v) for pair in pairs for t in pair]
    g = J._Run(q["convs"], act="silu")
    return [np.asarray(t.v) for t in J._v7base_trunk(
        g, J.QT(p2, 0.0, p2.shape[-1]))]


def _jax_p2(f, family):
    jq = f["jq"]
    meta = J._family_meta(jq.spec, jq.module)
    p2 = jq._p2_quantize(J._stems_bf16(
        jq.params["orig"], jnp.asarray(f["x"]), dtype=jnp.float32,
        bn_eps=meta["bn_eps"], stem_names=meta["stems"], act=meta["act"],
        strides=meta["strides"]))
    return p2


def _codes_diff(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return float((d > 0).mean()), int(d.max())


@pytest.mark.parametrize("family", FAMILIES)
def test_trunk_on_same_p2_codes_matches_jax(fams, family):
    """The JAX stems' P2 codes into both trunks: the taps (yolov7's three,
    yolov8's six tower outputs) equal to the eager JAX chain's; decoded
    boxes within 1e-2 px + 1e-4 of their size, scores within 1e-4."""
    f = fams[family]
    jq, pq = f["jq"], f["pq"]
    p2 = _jax_p2(f, family)
    want = _jax_taps(f, family, p2)
    p2_t = torch.from_numpy(np.array(p2))
    with torch.inference_mode():
        taps = pq.trunk_codes(p2_t)
        boxes, scores = pq.decode(pq._raw_from_p2_i8(p2_t))
    assert len(taps) == len(want) == (6 if family == "yolov8n" else 3)
    for t, w in zip(taps, want):
        assert t.v.dtype == torch.int8 and tuple(t.v.shape) == w.shape
        np.testing.assert_array_equal(t.v.numpy(), w)
        assert w.std() > 5                 # the codes are spread
    jboxes, jscores = (np.asarray(a) for a in jq._decode(
        jq._raw_from_p2_i8(jq.params, p2)))
    np.testing.assert_allclose(boxes.numpy(), jboxes, atol=1e-2, rtol=1e-4)
    np.testing.assert_allclose(scores.numpy(), jscores, atol=1e-4, rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_bundle_forward_matches_jax_forward(fams, family):
    """From the images, against the jitted JAX forward: P2 codes flip on
    <= 1e-3 of them; every score within 0.02, boxes of the detections
    (score >= 0.3) within 0.25 px + 5e-3 of their size."""
    f = fams[family]
    jq, pq = f["jq"], f["pq"]
    jboxes, jscores = (np.asarray(a) for a in jax.jit(jq.forward)(
        jq.params, jnp.asarray(f["x"])))
    xt = torch.from_numpy(f["x"]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        boxes, scores = pq.forward(xt)
        p2 = pq._p2_quantize(pq.module.stems(xt))
    share, worst = _codes_diff(p2.numpy(), np.asarray(_jax_p2(f, family)))
    assert worst <= 1 and share <= 1e-3, (share, worst)
    assert boxes.shape == jboxes.shape and scores.shape == jscores.shape
    np.testing.assert_allclose(scores.numpy(), jscores, atol=0.02, rtol=0)
    hot = jscores.max(-1) >= 0.3
    assert hot.sum() >= 4
    np.testing.assert_allclose(boxes.numpy()[hot], jboxes[hot], atol=0.25,
                               rtol=5e-3)


@pytest.mark.parametrize("k", [5, 9, 13])
def test_pool_same_borders_match_jax(k):
    """The parallel SPPCSPC pools at k = 9 and 13 (and SPPF's 5) on codes
    that reach −127 at the border: the −128 padding never wins."""
    rng = np.random.default_rng(k)
    a = rng.integers(-127, 128, (2, 7, 11, 8), dtype=np.int8)
    a[:, 0] = -127
    a[:, :, -1] = -127
    want = J._Run({}).pool_same(J.QT(jnp.asarray(a), 0.5, 8), k)
    got = P._Run({}).pool_same(P.QT(torch.from_numpy(a), 0.5, 8), k)
    assert got.v.dtype == torch.int8
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    assert int(got.v.min()) >= -127


# ---------------------------------------------------------- 3. turnkey

def test_turnkey_yolov8n_reaches_int8():
    """``quantize="int8"`` with no calibration file on the trained nano:
    two batches of car-centred tiles calibrate it, the parity gate passes
    on detections, and later batches run int8 and agree with the float
    step (matched >= 0.9)."""
    tiles, bounds, _ = v8_tiles(n_car=12, n_empty=0)
    cfg = DetectorConfig.from_dict(dict(
        dtype="float32", model_path="yolov8n", params_path=V8_FIXTURE,
        confidence_threshold=0.3, nms_preselect="exact", quantize="int8"))
    step = build_detect_step(cfg, batch=4, model_size=SIZE, src_size=SIZE,
                             device="cpu")
    assert isinstance(step, SelfQuantizingStep)
    states = [step.quantize_state]
    for k in (0, 4):
        step(tiles[k:k + 4], bounds[k:k + 4])
        states.append(step.quantize_state)
    assert states == ["calibrating", "calibrating", "int8"], \
        step.fallback_reason
    assert step.parity["total_a"] >= 4 and step.parity["matched"] >= 4
    assert isinstance(step.bundle, P.Int8Bundle) \
        and step.bundle.spec.class_names == ("car", "truck")
    out = step(tiles[8:12], bounds[8:12])
    ref = step.base_step(tiles[8:12], bounds[8:12])
    ok, stats = detection_sets_agree(ref, out)
    assert ok and stats["matched"] >= 4, stats
    assert set(out[0].classes[out[0].valid].tolist()) == {0}


def test_seeded_v8_falls_back_with_a_reason():
    """Seeded weights (class prior −5: every score ≈ 0.0067) give no
    detection to validate against, so the turnkey step settles on the
    float step and says why."""
    cfg = DetectorConfig.from_dict(dict(
        dtype="float32", model_path="yolov8n", quantize="int8",
        quantize_calib_wait_batches=2))
    step = build_detect_step(cfg, batch=2, model_size=64, device="cpu")
    tiles = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                              dtype=np.uint8)
    bounds = np.tile(np.asarray([[21.0, 52.2, 21.001, 52.201]], np.float32),
                     (2, 1))
    for _ in range(2):
        step(tiles, bounds)
    assert step.quantize_state == "bf16-fallback"
    assert "no detections" in step.fallback_reason


def test_seeded_yolov8l_quantizes():
    """A seeded YOLOv8l bundle (the Tokyo model's scale) quantizes from a
    calibration on seeded tiles: the l-scale transcription fits its tree."""
    pb = create_model("yolov8_tokyo", dtype=torch.float32, device="cpu",
                      fold_bn=True)
    tiles = np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3),
                                              dtype=np.uint8)
    qb = P.quantize_bundle(pb, [tiles], model_size=64)
    assert qb.module.scale == "l" and len(qb.params["q"]["convs"]) == len(
        [n for n in qb.static_scales if n != "__p2__"
         and not (n.count("/") == 1 and "/m" in n)])
    with torch.inference_mode():
        boxes, scores = qb.forward(torch.rand(1, 3, 64, 64))
    assert tuple(boxes.shape) == (1, 84, 4) and tuple(scores.shape) == \
        (1, 84, 2) and bool(torch.isfinite(scores).all())
    other = dataclasses.replace(pb, variables=None)
    with pytest.raises(ValueError, match="variables"):
        P.quantize_bundle(other, [], absmax={})
