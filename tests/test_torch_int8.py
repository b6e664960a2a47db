"""The port's int8 trunk (models/int8.py) against the JAX package's.

f32 on the CPU, trained fixture, 96-px tiles (the fixture's training scale,
built as tests/test_int8.py builds them); inputs from seeds with numpy.
Tolerances, each stated where it is used:

* same ``absmax`` table → ``_Prepare`` qparams equal bit for bit;
* the integer convolution: s32 sums exact; epilogue codes equal for leaky
  and relu, within 1 LSB on <= 1e-4 of the codes for silu (``exp``);
* calibration tables within rtol 1e-5 (BN folded here, not there);
* trunk on the same P2 codes: tap codes equal, boxes within 1e-2 px + 1e-4
  of their size, scores within 1e-3. From the images the two f32 stems
  (BN folded here, not there) flip a P2 code on <= 1e-4 of them, which the
  trunk's rounding spreads: detections (score >= 0.05) within 0.25 px and
  0.02 in score;
* the golden fixture ``int8_tiny_trained.npz`` within atol 5e-3, rtol 1e-4,
  as tests/test_golden_regression.py holds the JAX package to it.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from aerial_image_recognition_tpu.models import int8 as J
from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model, load_params as jax_load_params)
from aerial_image_recognition_tpu.ops.preprocess import (
    preprocess_batch as jax_preprocess_batch)
from aerial_image_recognition_tpu_torch.models import int8 as P
from aerial_image_recognition_tpu_torch.models.registry import create_model
from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
    _requantize_plain, requantize)
from aerial_image_recognition_tpu_torch.ops.nms import batched_nms

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE = os.path.join(FIXTURES, "yolov7_tiny_fakeworld.npz")
SIZE = 96   # the fixture's training scale: 96 px / 48 m = 0.5 m/px
CPU = torch.device("cpu")

torch.set_num_threads(2)


class _Names:
    """A trunk-graph interpreter that only records the conv names."""

    def __init__(self):
        self.names = []

    def conv(self, name, x, kernel, stride=1):
        self.names.append(name)
        return P.QT(None, 1.0, 0)

    def pool2(self, x):
        return x

    pool_same = up2 = lambda self, x, *a: x


def _trunk_conv_names():
    g = _Names()
    P._tiny_trunk(g, P.QT(None, 1.0, 64))
    return g.names


TRUNK_CONVS = _trunk_conv_names()


def scene_tiles(size=SIZE, n=12):
    from aerial_image_recognition_tpu.fetch.fake import FakeWorld
    world = FakeWorld(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                      n_cars=400, seed=4)
    m2lon = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
    m2lat = 1.0 / 111319.9
    half = 24.0  # meters (48 m tiles)
    tiles = []
    for lon, lat, _ in world.cars[:n]:
        bb = (lon - half * m2lon, lat - half * m2lat,
              lon + half * m2lon, lat + half * m2lat)
        tiles.append(world.render(bb, size, size))
    return np.stack(tiles)


@pytest.fixture(scope="module")
def both():
    """JAX f32 bundle, the port's f32 bundle, the tiles, JAX's calibration
    table of the first 8 tiles, and both quantized with that one table."""
    jb = jax_create_model("yolov7_itcvd", dtype=jnp.float32)
    jb.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), jax_load_params(FIXTURE))
    pb = create_model(params_path=FIXTURE, dtype=torch.float32, device="cpu",
                      fold_bn=True)
    tiles = scene_tiles()
    absmax = J.calibrate_absmax(jb, [tiles[:8]], model_size=SIZE)
    jq = J.quantize_bundle(jb, [], absmax=absmax)
    pq = P.quantize_bundle(pb, [], absmax=absmax)
    return dict(jb=jb, pb=pb, tiles=tiles, absmax=absmax, jq=jq, pq=pq)


def _codes_diff(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return float((d > 0).mean()), int(d.max())


# ------------------------------------------------------------ 1. qparams

def test_trunk_transcription_has_every_conv():
    assert len(TRUNK_CONVS) == len(set(TRUNK_CONVS)) == 53


@pytest.mark.parametrize("name", TRUNK_CONVS)
def test_prepare_qparams_bit_equal(both, name):
    jqp = both["jq"].params["q"]["convs"][name]
    pqp = both["pq"].params["q"]["convs"][name]
    assert set(pqp) == set(jqp) == {"w8", "m", "b"}
    for key in ("w8", "m", "b"):
        want = np.asarray(jqp[key])
        assert pqp[key].dtype == want.dtype and pqp[key].shape == want.shape
        np.testing.assert_array_equal(pqp[key], want)


def test_prepare_scales_bit_equal(both):
    jq, pq = both["jq"], both["pq"]
    assert set(pq.params["q"]["convs"]) == set(jq.params["q"]["convs"]) \
        == set(TRUNK_CONVS)
    assert pq.params["q"]["p2_scale"] == np.float32(jq.params["q"]["p2_scale"])
    assert [np.float32(s) for s in jq.params["q"]["out_scales"]] \
        == pq.params["q"]["out_scales"]
    assert pq.static_scales == jq.static_scales
    assert pq.absmax == both["absmax"]
    # the device kernels are the same integers in another layout
    for name in ("elan1/cv3", "sppcspc/cv3", "down4_cv"):
        w8 = pq.params["q"]["convs"][name]["w8"]
        np.testing.assert_array_equal(
            pq.q["convs"][name]["w"].numpy(), w8.transpose(3, 2, 0, 1))
        mat = P.device_kernel(w8, torch.device("meta"))
        assert tuple(mat.shape) == (w8[..., 0].size, w8.shape[3]) \
            and mat.dtype == torch.int8 and mat.t().is_contiguous()


def test_qparams_bridge_round_trip(both):
    """``qparams_from_jax`` turns the reference's q tree into the port's."""
    jq, pq = both["jq"], both["pq"]
    q = P.qparams_from_jax(jax.device_get(jq.params["q"]), jq.static_scales)
    assert q["scales"] == pq.static_scales
    assert q["p2_scale"] == pq.params["q"]["p2_scale"]
    assert q["out_scales"] == pq.params["q"]["out_scales"]
    for name in TRUNK_CONVS:
        for key in ("w8", "m", "b"):
            np.testing.assert_array_equal(
                q["convs"][name][key], pq.params["q"]["convs"][name][key])


def test_int8_bundle_holds_no_float_trunk(both):
    pq = both["pq"]
    names = {n.split(".")[0] for n, _ in pq.module.named_parameters()}
    assert names == {"stem0", "stem1", "detect0", "detect1", "detect2"}
    assert set(pq.params["orig"]["params"]) == names
    assert set(pq.params["orig"]["batch_stats"]) == {"stem0", "stem1"}
    assert pq.supports_s2d2() and pq.device == CPU
    # the fully-int8 quad stem's constants ride in q, not in the module
    assert set(pq.params["q"]["stems"]) == {"w0", "m0", "b0", "corr", "w1",
                                            "m1", "b1"}


def test_transcription_guard(both):
    """A corrupted tree must raise, not silently mis-slice (the counterpart
    of tests/test_int8.py::test_int8_transcription_guard)."""
    pb = both["pb"]
    bad = {"params": dict(pb.variables["params"]),
           "batch_stats": pb.variables["batch_stats"]}
    elan1 = {k: dict(v) for k, v in bad["params"]["elan1"].items()}
    elan1["cv3"]["conv"] = {
        "kernel": elan1["cv3"]["conv"]["kernel"][:, :, :16, :]}
    bad["params"]["elan1"] = elan1
    import dataclasses
    with pytest.raises(ValueError, match="elan1/cv3"):
        P.quantize_bundle(dataclasses.replace(pb, variables=bad), [],
                          absmax=both["absmax"])
    with pytest.raises(KeyError, match="no calibration record"):
        P.quantize_bundle(pb, [], absmax={"stem1": 1.0})


def test_rejects_unsupported_families(both):
    """The counterpart of test_int8_rejects_unsupported_family: the
    s2d_stem experiment keeps its message; an xunet bundle is dispatched
    to ``quantize_xunet`` as in the JAX package (the same class from the
    same call; tests/test_torch_segment.py holds its qparams). yolov7-base
    and yolov8 quantize (tests/test_torch_families_int8.py)."""
    import dataclasses
    from aerial_image_recognition_tpu_torch.models.yolov7 import YOLOv7
    pb = both["pb"]
    s2d = YOLOv7(num_classes=1, variant="tiny", s2d_stem=True)
    assert s2d.stem0.conv.in_channels == 12
    with pytest.raises(NotImplementedError, match="s2d_stem experiment"):
        P.quantize_bundle(dataclasses.replace(pb, module=s2d), [])
    from aerial_image_recognition_tpu.models.registry import (
        REGISTRY as JAX_REGISTRY, ModelBundle as JaxModelBundle)
    xb = create_model("xunet_256", dtype=torch.float32, device="cpu",
                      fold_bn=True)
    absmax = P.calibrate_absmax(xb, [np.zeros((1, 64, 64, 3), np.uint8)],
                                model_size=64)
    jx = J.quantize_bundle(JaxModelBundle(spec=JAX_REGISTRY["xunet_256"],
                                          module=None,
                                          params=xb.variables), [],
                           absmax=absmax)
    px = P.quantize_bundle(xb, [], absmax=absmax)
    assert type(px).__name__ == type(jx).__name__ == "Int8XUnetBundle"
    for family, arch in (("yolov7", "base"), ("yolov8", "l")):
        assert P._family_meta(dataclasses.replace(pb.spec, family=family),
                              arch)["act"] == "silu"


def test_absmax_file_round_trip(tmp_path, both):
    path = str(tmp_path / "absmax.json")
    P.save_absmax(path, both["absmax"])
    assert P.load_absmax(path) == both["absmax"] == J.load_absmax(path)


def test_random_weights_bundle_keeps_its_variables():
    """Without a checkpoint the f32 tree is exported before the BN fold,
    so a random model quantizes from the same weights it runs."""
    from aerial_image_recognition_tpu_torch.models.weights import (
        params_from_flax)
    raw = create_model(dtype=torch.float32, device="cpu", seed=3)
    sd = raw.module.state_dict()
    back = params_from_flax(raw.variables)
    assert set(back) == {k for k in sd if "num_batches" not in k}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    folded = create_model(dtype=torch.bfloat16, device="cpu", seed=3,
                          fold_bn=True)
    for k, v in params_from_flax(folded.variables).items():
        assert torch.equal(v, sd[k]), k          # f32, before fold and cast
    imgs = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3),
                                             dtype=np.uint8)
    qb = P.quantize_bundle(folded, [imgs], model_size=64)
    boxes, scores = qb.forward(torch.rand(2, 3, 64, 64))
    assert boxes.shape == (2, 252, 4) and bool(torch.isfinite(scores).all())


# ------------------------------------------------ 2. _Run against JAX _Run

# (case, channels of the parts, output channels, kernel, stride)
CONV_CASES = [
    ("1x1", (16,), 24, 1, 1),
    ("3x3", (16,), 8, 3, 1),
    ("3x3-stride2", (8,), 16, 3, 2),
    ("1x1-concat4", (8, 8, 8, 8), 16, 1, 1),
    ("3x3-stride2-odd", (12,), 8, 3, 2),
]


def _synthetic_conv(rng, parts, out_c, kernel, h=9, w=10, batch=2):
    xs = [rng.integers(-127, 128, (batch, h, w, c), dtype=np.int8)
          for c in parts]
    c_in = sum(parts)
    w8 = rng.integers(-127, 128, (kernel, kernel, c_in, out_c), dtype=np.int8)
    k = kernel * kernel * c_in
    m = (rng.uniform(0.5, 1.5, out_c) * 60.0
         / (math.sqrt(k) * 5400.0)).astype(np.float32)
    b = rng.uniform(-20.0, 20.0, out_c).astype(np.float32)
    return xs, w8, m, b


@pytest.mark.parametrize("act", ["leaky", "relu", "silu"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_run_conv_matches_jax(case, act):
    _, parts, out_c, kernel, stride = case
    rng = np.random.default_rng(len(parts) * 100 + out_c + kernel + stride)
    h, w = (9, 10) if "odd" not in case[0] else (7, 11)
    xs, w8, m, b = _synthetic_conv(rng, parts, out_c, kernel, h, w)
    inv = np.float32(0.75)
    jqp = {"w8": jnp.asarray(w8), "m": jnp.asarray(m), "b": jnp.asarray(b),
           "inv": jnp.float32(inv)}
    jx = [J.QT(jnp.asarray(x), 0.5, x.shape[-1]) for x in xs]
    want = J._Run({"c": jqp}, act=act, scales={"c": 0.25}).conv(
        "c", jx if len(jx) > 1 else jx[0], kernel, stride)
    pqp = {"w": P.device_kernel(w8, CPU), "m": torch.from_numpy(m),
           "b": torch.from_numpy(b), "inv": float(inv)}
    px = [P.QT(torch.from_numpy(x), 0.5, x.shape[-1]) for x in xs]
    got = P._Run({"c": pqp}, act=act, scales={"c": 0.25}).conv(
        "c", px if len(px) > 1 else px[0], kernel, stride)
    assert (got.s, got.c) == (want.s, want.c) == (0.25, out_c)
    assert got.v.dtype == torch.int8 and got.v.is_contiguous()
    # the integer sums are exact
    v = np.concatenate(xs, axis=-1)
    pad = kernel // 2
    s32 = lax.conv_general_dilated(
        jnp.asarray(v), jnp.asarray(w8), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=J._DN,
        preferred_element_type=jnp.int32)
    mine = P.conv_s32(torch.from_numpy(v), pqp["w"], kernel, stride)
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), np.asarray(s32))
    # the codes
    share, worst = _codes_diff(got.v.numpy(), want.v)
    assert np.asarray(want.v).std() > 10          # the codes are spread
    if act == "silu":
        assert worst <= 1 and share <= 1e-4, (share, worst)
    else:
        assert (share, worst) == (0.0, 0)


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_card_product_arithmetic_equals_plain(case):
    """What the card runs — im2col on widened views, then ``_int_mm`` on the
    column-major kernel matrix — on CPU tensors, against the plain int32
    ``F.conv2d`` (``_int_mm`` exists on the CPU too)."""
    _, parts, out_c, kernel, stride = case
    rng = np.random.default_rng(7)
    xs, w8, _, _ = _synthetic_conv(rng, parts, out_c, kernel, 12, 9, 3)
    v = torch.from_numpy(np.concatenate(xs, axis=-1))
    want = P._conv_s32_plain(v, P.device_kernel(w8, CPU), kernel, stride)
    mat = torch.from_numpy(np.ascontiguousarray(
        w8.reshape(-1, out_c).T)).t()
    got = P._conv_s32_card(v, mat, kernel, stride)
    assert got.dtype == torch.int32 and torch.equal(got, want.contiguous())
    # a batch chunk (a view at an offset) widens too
    got2 = P._conv_s32_card(v[1:], mat, kernel, stride)
    assert torch.equal(got2, want[1:].contiguous())


def test_large_im2col_runs_in_batch_chunks(monkeypatch):
    """Above ``IM2COL_MAX_BYTES`` a 3×3 conv runs in batch chunks, with the
    same codes."""
    rng = np.random.default_rng(5)
    xs, w8, m, b = _synthetic_conv(rng, (8,), 16, 3, 6, 6, 5)
    qp = {"c": {"w": P.device_kernel(w8, CPU), "m": torch.from_numpy(m),
                "b": torch.from_numpy(b)}}
    x = P.QT(torch.from_numpy(xs[0]), 0.5, 8)
    whole = P._Run(qp).conv("c", x, 3, 2).v
    calls = []
    real = P.conv_s32
    monkeypatch.setattr(P, "conv_s32", lambda v, *a: calls.append(
        v.shape[0]) or real(v, *a))
    monkeypatch.setattr(P, "IM2COL_MAX_BYTES", 2 * 6 * 6 * 8 * 9 // 4)
    chunked = P._Run(qp).conv("c", x, 3, 2).v
    assert calls == [2, 2, 1] and torch.equal(chunked, whole)
    calls.clear()
    P._Run(qp).conv("c", x, 3, 1)
    assert calls == [1] * 5          # never less than one image


def test_im2col_order_and_widening():
    rng = np.random.default_rng(3)
    for c, wide in ((16, torch.int64), (32, torch.int64), (12, torch.int8),
                    (7, torch.int8)):
        v = torch.from_numpy(rng.integers(-127, 128, (2, 5, 6, c),
                                          dtype=np.int8))
        assert P._wide(v).dtype == wide
        cols = P._im2col(v, 3, 1)
        assert cols.dtype == torch.int8 and cols.shape == (2, 5, 6, 9 * c)
        vp = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1))
        for dy in range(3):
            for dx in range(3):
                k = (dy * 3 + dx) * c
                assert torch.equal(cols[..., k:k + c],
                                   vp[:, dy:dy + 5, dx:dx + 6])


def test_run_add_and_split2_match_jax():
    rng = np.random.default_rng(11)
    a = rng.integers(-127, 128, (2, 7, 6, 16), dtype=np.int8)
    b = rng.integers(-127, 128, (2, 7, 6, 16), dtype=np.int8)
    scales = {"m0": 0.0413}
    want = J._Run({}, scales=scales).add(
        "m0", J.QT(jnp.asarray(a), 0.031, 16), J.QT(jnp.asarray(b), 0.017, 16))
    got = P._Run({}, scales=scales).add(
        "m0", P.QT(torch.from_numpy(a), 0.031, 16),
        P.QT(torch.from_numpy(b), 0.017, 16))
    assert (got.s, got.c) == (want.s, want.c)
    # y·s_y + x·s_x may contract to an FMA under XLA: <= 1 LSB on <= 1e-3
    share, worst = _codes_diff(got.v.numpy(), want.v)
    assert worst <= 1 and share <= 1e-3, (share, worst)
    ja, jb = J._Run({}).split2(J.QT(jnp.asarray(a), 0.5, 16))
    pa, pb = P._Run({}).split2(P.QT(torch.from_numpy(a), 0.5, 16))
    for g, w in ((pa, ja), (pb, jb)):
        assert (g.s, g.c) == (w.s, w.c) == (0.5, 8)
        np.testing.assert_array_equal(g.v.numpy(), np.asarray(w.v))


@pytest.mark.parametrize("op", ["pool2", "pool2-odd", "pool_same5",
                                "pool_same9", "up2"])
def test_run_pools_and_upsample_match_jax(op):
    rng = np.random.default_rng(13)
    shape = (2, 7, 9, 8) if op == "pool2-odd" else (2, 8, 6, 8)
    a = rng.integers(-127, 128, shape, dtype=np.int8)
    jx, px = J.QT(jnp.asarray(a), 0.5, 8), P.QT(torch.from_numpy(a), 0.5, 8)
    jr, pr = J._Run({}), P._Run({})
    if op.startswith("pool2"):
        want, got = jr.pool2(jx), pr.pool2(px)
    elif op.startswith("pool_same"):
        k = int(op[len("pool_same"):])
        want, got = jr.pool_same(jx, k), pr.pool_same(px, k)
    else:
        want, got = jr.up2(jx), pr.up2(px)
    assert got.v.dtype == torch.int8 and (got.s, got.c) == (0.5, 8)
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


@pytest.mark.parametrize("act", ["leaky", "relu", "silu"])
def test_requantize_wrapper_on_cpu_is_the_plain_version(act):
    rng = np.random.default_rng(17)
    r = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (3, 5, 4, 12))
                         .astype(np.int32))
    m = torch.from_numpy(rng.uniform(1e-5, 2e-4, 12).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-9, 9, 12).astype(np.float32))
    inv = 0.6
    before = requantize.launches
    got = requantize(r, m, b, inv, act)
    assert torch.equal(got, _requantize_plain(r, m, b, inv, act))
    assert got.dtype == torch.int8 and requantize.launches == before
    # rounding is half to even, and the clip is symmetric
    r2 = torch.tensor([[1, 3, 5, -1, -3, 4000, -4000, 0]], dtype=torch.int32)
    half = requantize(r2, torch.full((8,), 0.5), torch.zeros(8), None,
                      "relu")
    assert half.tolist() == [[0, 2, 2, 0, 0, 127, 0, 0]]
    with pytest.raises(ValueError, match="unknown activation"):
        requantize(r, m, b, None, "gelu")
    with pytest.raises(ValueError, match="inv"):
        requantize(r, m, b, None, "silu")


# --------------------------------------------------------- 3. calibration

def test_calibrate_absmax_matches_jax(both):
    """Same tiles, uint8 in: every ConvBN output's absmax within rtol 1e-5
    of the JAX package's (this module folds BN, that one does not)."""
    got = P.calibrate_absmax(both["pb"], [both["tiles"][:8]],
                             model_size=SIZE)
    want = both["absmax"]
    assert set(got) == set(TRUNK_CONVS) | {"stem0", "stem1"} <= set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, err_msg=k)
    # a running maximum over batches, whatever their split
    parts = P.calibrate_absmax(
        both["pb"], [both["tiles"][:3], both["tiles"][3:8]], model_size=SIZE)
    assert parts == got


def test_calibrate_absmax_float_batches_are_resized(both):
    """Float [0,1] batches of another size are resized to the model size
    (bilinear, the JAX package's weights); rtol 1e-4: two f32 resizes that
    sum in another order."""
    tiles = scene_tiles(130, 4).astype(np.float32) / 255.0
    got = P.calibrate_absmax(both["pb"], [tiles], model_size=SIZE)
    want = J.calibrate_absmax(both["jb"], [tiles], model_size=SIZE)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, err_msg=k)
    same = P.calibrate_absmax(
        both["pb"], [torch.from_numpy(both["tiles"][:4]).float() / 255.0],
        model_size=SIZE)
    ref = P.calibrate_absmax(both["pb"], [both["tiles"][:4]],
                             model_size=SIZE)
    for k, v in same.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-6, err_msg=k)


# ------------------------------------------------- 4. the bundle's forward

def test_trunk_on_same_p2_codes_equals_jax(both):
    """Bridged qparams, the JAX stems' P2 codes into both trunks: the three
    taps' codes are equal; boxes within 1e-2 px + 1e-4 of their size and
    scores within 1e-3 (f32 heads and decode in another summation order)."""
    jq, tiles = both["jq"], both["tiles"]
    q = P.qparams_from_jax(jax.device_get(jq.params["q"]), jq.static_scales)
    pq = P.Int8Bundle.from_q(both["pb"].spec, both["pb"].variables, q,
                             dtype=torch.float32, device=CPU)
    x = jax_preprocess_batch(jnp.asarray(tiles), out_size=SIZE,
                             dtype=jnp.float32)
    p2 = jq._p2_quantize(J._stems_bf16(jq.params["orig"], x,
                                       dtype=jnp.float32))
    g = J._Run(jq.params["q"]["convs"], act="leaky")
    want = J._tiny_trunk(g, J.QT(p2, 0.0, p2.shape[-1]))
    p2_t = torch.from_numpy(np.array(p2))
    with torch.inference_mode():
        got = pq.trunk_codes(p2_t)
        from aerial_image_recognition_tpu_torch.ops.decode import (
            decode_yolov7)
        boxes, scores = decode_yolov7(pq._raw_from_p2_i8(p2_t),
                                      pq.module.anchors, 1)
    for g_, w_ in zip(got, want):
        assert g_.v.shape == w_.v.shape
        np.testing.assert_array_equal(g_.v.numpy(), np.asarray(w_.v))
    jboxes, jscores = jq._decode(jq._raw_from_p2_i8(jq.params, p2))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes),
                               atol=1e-2, rtol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-3, rtol=0)


def test_bundle_forward_matches_jax_forward(both):
    """From the images. The port folds BN into its f32 stems and the
    reference does not, so a P2 code flips at a rounding boundary on
    <= 1e-4 of them; the trunk's own rounding spreads a flip over ~1 % of
    the tap codes (<= 2 LSB). Detections (score >= 0.05): boxes within
    0.25 px, scores within 0.02; every score within 0.02."""
    jq, pq, tiles = both["jq"], both["pq"], both["tiles"]
    x = jax_preprocess_batch(jnp.asarray(tiles), out_size=SIZE,
                             dtype=jnp.float32)
    jboxes, jscores = (np.asarray(a) for a in jq.forward(jq.params, x))
    xt = torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        boxes, scores = pq.forward(xt)
        p2 = pq._p2_quantize(pq.module.stems(xt))
    jp2 = jq._p2_quantize(J._stems_bf16(jq.params["orig"], x,
                                        dtype=jnp.float32))
    share, worst = _codes_diff(p2.numpy(), jp2)
    assert worst <= 1 and share <= 1e-4, (share, worst)
    assert boxes.shape == jboxes.shape and scores.shape == jscores.shape
    np.testing.assert_allclose(scores.numpy(), jscores, atol=0.02, rtol=0)
    hot = jscores[..., 0] >= 0.05
    assert hot.sum() >= 12
    np.testing.assert_allclose(boxes.numpy()[hot], jboxes[hot], atol=0.25,
                               rtol=0)


# ---------------------------------------------------------- 5. the golden

def _synthetic_image(size=96):
    gy, gx = np.mgrid[0:size, 0:size]
    img = (127 + 60 * np.sin(gx / 7.0) * np.cos(gy / 5.0)).astype(np.uint8)
    img = np.stack([img, np.roll(img, 3, 0), np.roll(img, 7, 1)], -1)
    img[30:40, 20:44] = 240      # a bright "car"
    img[60:68, 50:66] = 235
    return img[None]


def test_int8_tiny_golden(both):
    """The recorded int8 outputs of the JAX package
    (tests/test_golden_regression.py::test_int8_tiny_golden), through the
    port: calibrated on the synthetic image, atol 5e-3, rtol 1e-4."""
    img = _synthetic_image()
    qb = P.quantize_bundle(both["pb"], [img], model_size=96)
    x = torch.from_numpy(img).float().permute(0, 3, 1, 2) \
        / torch.full((), 255.0)
    with torch.inference_mode():
        boxes, scores = qb.forward(x)
    with np.load(os.path.join(FIXTURES, "int8_tiny_trained.npz")) as ref:
        np.testing.assert_allclose(boxes.numpy()[0, :64], ref["boxes_head"],
                                   atol=5e-3, rtol=1e-4)
        np.testing.assert_allclose(scores.numpy()[0, :64],
                                   ref["scores_head"], atol=5e-3, rtol=1e-4)


# --------------------------------------- 6. int8 against the float bundle

def _detect(bundle, x):
    with torch.inference_mode():
        boxes, scores = bundle.forward(x)
        return batched_nms(boxes, scores, num_classes=1, conf_threshold=0.4,
                           iou_threshold=0.45, max_det=32, pre_topk=256)


def test_int8_detections_match_f32(both):
    """Per-tile detection parity on trained-scene tiles, with the limits of
    tests/test_int8.py::test_int8_detections_match_bf16: same counts,
    centers within 1.5 px, sizes within 15 %, sorted scores within 0.06."""
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    tiles = both["tiles"]
    qb = P.quantize_bundle(both["pb"], [tiles[:8]], model_size=SIZE)
    x = preprocess_batch(torch.from_numpy(tiles), out_size=SIZE,
                         dtype=torch.float32)
    ref, got = _detect(both["pb"], x), _detect(qb, x)
    n_ref = ref.valid.sum(1).numpy()
    assert n_ref.sum() >= 12, "trained model should find the centered cars"
    np.testing.assert_array_equal(got.valid.sum(1).numpy(), n_ref)
    for b in range(len(tiles)):
        rb = ref.boxes[b][ref.valid[b]].numpy()
        gb = got.boxes[b][got.valid[b]].numpy()
        for r in rb:
            j = int(np.abs(gb[:, :2] - r[:2]).sum(axis=1).argmin())
            assert np.all(np.abs(gb[j, :2] - r[:2]) < 1.5), (b, r, gb[j])
            assert np.all(np.abs(gb[j, 2:] - r[2:])
                          < 0.15 * np.maximum(r[2:], 4)), (b, r, gb[j])
        rs = np.sort(ref.scores[b][ref.valid[b]].numpy())
        gs = np.sort(got.scores[b][got.valid[b]].numpy())
        np.testing.assert_allclose(gs, rs, atol=0.06)
