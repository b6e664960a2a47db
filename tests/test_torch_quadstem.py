"""The port's quad stem (``ops/quadstem.py`` and the paths that take it:
``forward_s2d2``, the default detect step, the fully-int8 stems, the ingest
packing) against the JAX package's.

f32 on the CPU unless a case says otherwise, 64–96-px tiles, batch 2–8; the
trained fixtures ``yolov7_tiny_fakeworld.npz`` (leaky stems) and
``yolov8n_fakeworld.npz`` (silu stems); inputs from seeds with numpy; the
JAX side as ``tests/test_quadstem.py`` and ``tests/test_int8.py`` run it.
Tolerances, each stated where it is used:

* the host relayouts, the native packer, the device relayout and both
  kernel transforms: bit-equal to JAX's and to the element-by-element
  definition;
* ``fold_convbn``: within 2 f32 ulps of JAX's (XLA's rsqrt and
  ``torch.rsqrt`` differ in the last bit), and given JAX's folds the int8
  stem constants are bit-equal;
* the float quad stem and ``forward_s2d2``: the P2 feature within 2e-5 of
  its largest magnitude; over every anchor, boxes within 1e-3 px + 1e-5
  of their size, scores within 1e-5 (f32 convolutions summed in another
  order);
* the default (quad) step against the JAX default step: valid slots and
  classes equal, boxes within 1e-3 px, scores within 1e-5, lon/lat within
  1e-6° — the bars of the plain-stem steps, tighter than the 0.05 px /
  1e-4 the port's plain stems needed against the JAX quad stem;
* the fully-int8 stems: codes equal to JAX's ``_stems_int8`` run op by op
  and to the jitted chain on both fixtures (0 codes of 147 456 / 73 728
  differ on this machine); zeroing the border term moves row 0 and column
  0 by more than 10 steps;
* the scan: records within 1e-6° and 1e-5 in confidence of the JAX scan's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.ingest import pipeline as JP
from aerial_image_recognition_tpu.models import int8 as J
from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model, load_params as jax_load_params)
from aerial_image_recognition_tpu.ops import quadstem as JQ
from aerial_image_recognition_tpu.pipeline.inference import (
    build_detect_step as jax_build_detect_step,
    use_quad_stem as jax_use_quad_stem)
from aerial_image_recognition_tpu.runtime.config import (
    DetectorConfig as JaxDetectorConfig)
from aerial_image_recognition_tpu.utils.native import (
    pack_quad_native as jax_pack_quad_native)
from aerial_image_recognition_tpu_torch.fetch.xyz import TileImage
from aerial_image_recognition_tpu_torch.ingest import pipeline as PP
from aerial_image_recognition_tpu_torch.models import int8 as P
from aerial_image_recognition_tpu_torch.models.registry import create_model
from aerial_image_recognition_tpu_torch.ops import quadstem as PQ
from aerial_image_recognition_tpu_torch.ops.int8_kernel import (
    border_term, requantize)
from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    SelfQuantizingStep, build_detect_step, use_quad_stem)
from aerial_image_recognition_tpu_torch.pipeline.serve import DetectionServer
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from aerial_image_recognition_tpu_torch.utils import native
from test_quadstem import _quad_layout_reference
from test_torch_families import V8_FIXTURE, v8_tiles
from test_torch_int8 import FIXTURE, SIZE, scene_tiles

CPU = torch.device("cpu")
FAMILIES = {
    # name: (fixture, act, bn_eps, stems)
    "yolov7_itcvd": (FIXTURE, "leaky", 1e-5, ("stem0", "stem1")),
    "yolov8n": (V8_FIXTURE, "silu", 1e-3, ("stem", "down2")),
}

torch.set_num_threads(2)


def _variables(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax_load_params(FAMILIES[name][0]))


def _tiles(name, n=4):
    if name == "yolov7_itcvd":
        return scene_tiles(n=n)
    return v8_tiles(n_car=n, n_empty=0)[0]


def _bounds(n):
    return np.asarray([(21.0 + 1e-3 * k, 52.2, 21.0005 + 1e-3 * k, 52.2003)
                       for k in range(n)], np.float32)


# ------------------------------------------------------------ 1. layouts

@pytest.mark.parametrize("shape", [(24, 32, 3), (3, 64, 64, 3),
                                   (2, 96, 96, 3)])
def test_host_relayouts_equal_jax_and_definition(shape):
    px = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    got = PQ.host_s2d2(px)
    np.testing.assert_array_equal(got, JQ.host_s2d2(px))
    for img, packed in zip(px.reshape((-1,) + shape[-3:]),
                           got.reshape((-1,) + got.shape[-3:])):
        np.testing.assert_array_equal(packed, _quad_layout_reference(img))
    back = PQ.host_s2d2_inverse(got)
    np.testing.assert_array_equal(back, px)
    np.testing.assert_array_equal(back, JQ.host_s2d2_inverse(got))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_host_s2d2_into_equals_jax(path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(native, "pack_quad_native", lambda px, out: False)
    px = np.random.default_rng(1).integers(0, 256, (3, 64, 96, 3)) \
        .astype(np.uint8)
    want = JQ.host_s2d2(px)
    for k in range(3):
        out = np.zeros((16, 24, 48), np.uint8)
        PQ.host_s2d2_into(px[k], out)
        np.testing.assert_array_equal(out, want[k])


def test_native_packer_builds_and_refuses_what_it_cannot_pack():
    """The packer builds from its own source, without libjpeg, and is
    reported; its output equals the reference's native packer's."""
    assert native.native_paths()["fastpack"] is True
    assert any(p.name.startswith("libfastpack-")
               for p in native.BUILD_DIR.glob("lib*.so"))
    px = np.random.default_rng(2).integers(0, 256, (32, 48, 3)) \
        .astype(np.uint8)
    got, want = np.zeros((8, 12, 48), np.uint8), np.zeros((8, 12, 48),
                                                           np.uint8)
    assert native.pack_quad_native(px, got)
    assert jax_pack_quad_native(px, want)
    np.testing.assert_array_equal(got, want)
    for bad_px, bad_out in ((px[:30], np.zeros((7, 12, 48), np.uint8)),
                            (px[:, ::2], np.zeros((8, 6, 48), np.uint8)),
                            (px.astype(np.int16), got),
                            (px, np.zeros((8, 11, 48), np.uint8))):
        assert not native.pack_quad_native(bad_px, bad_out)


def test_pack_images_relays_tensors_where_they_lie():
    """A quad step's ``pack_images``: a host batch through ``host_s2d2``, a
    tensor by the same index map on its device (still a tensor), packed
    batches as they are; an hwc step leaves every batch alone."""
    step = build_detect_step(DetectorConfig(params_path=FIXTURE,
                                            dtype="float32"),
                             batch=2, model_size=64, device="cpu")
    plain = build_detect_step(DetectorConfig(params_path=FIXTURE,
                                             dtype="float32",
                                             extra={"quad_stem": False}),
                              batch=2, model_size=64, device="cpu")
    assert (step.input_layout, plain.input_layout) == ("s2d2", "hwc")
    px = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    want = JQ.host_s2d2(px)
    np.testing.assert_array_equal(step.pack_images(px), want)
    t = step.pack_images(torch.from_numpy(px))
    assert isinstance(t, torch.Tensor) and t.device == CPU
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(PQ.device_s2d2(torch.from_numpy(px))
                                  .numpy(), want)
    assert step.pack_images(want) is want
    assert plain.pack_images(px) is px
    # the step itself uploads a host [B,S,S,3] batch and relays it there
    placed, _ = step.place(px, np.zeros((2, 4), np.float32))
    np.testing.assert_array_equal(placed[0].numpy(), want)


# ------------------------------------------------ 2. transforms and fold

@pytest.mark.parametrize("cin,cout", [(3, 32), (32, 64), (3, 16), (16, 32)])
def test_kernel_transforms_bit_equal_jax(cin, cout):
    w = np.random.default_rng(cin * cout).standard_normal(
        (3, 3, cin, cout)).astype(np.float32)
    for port, ref in ((PQ.quad_kernel_transform, JQ.quad_kernel_transform),
                      (PQ.s2d_kernel_transform, JQ.s2d_kernel_transform)):
        got, want = port(w), np.asarray(ref(w))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_fold_convbn_within_two_ulps_of_jax(name):
    v = _variables(name)
    _, _, eps, stems = FAMILIES[name]
    for n in stems:
        got = PQ.fold_convbn(v["params"][n], v["batch_stats"][n], eps=eps)
        want = JQ.fold_convbn(v["params"][n], v["batch_stats"][n], eps=eps)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_max_ulp(g, np.asarray(w), maxulp=2)


# ------------------------------------------------------ 3. float stems

@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_quad_stem_forward_equals_jax(name):
    _, act, eps, stems = FAMILIES[name]
    v = _variables(name)
    xq = PQ.host_s2d2(_tiles(name))
    got = PQ.quad_stem_forward(v, torch.from_numpy(xq), act=act,
                               dtype=torch.float32, stem_names=stems,
                               bn_eps=eps)
    want = np.asarray(JQ.quad_stem_forward(
        v, jnp.asarray(xq), act=act, dtype=jnp.float32, stem_names=stems,
        bn_eps=eps))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_forward_s2d2_equals_jax_bundle(name):
    jb, pb = _bundles(name)
    assert pb.supports_s2d2() and jb.supports_s2d2()
    xq = PQ.host_s2d2(_tiles(name, n=2))
    jboxes, jscores = jax.jit(jb.forward_s2d2)(jb.params, jnp.asarray(xq))
    boxes, scores = pb.forward_s2d2(torch.from_numpy(xq))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0,
                               atol=1e-5)
    # built once, on the bundle's device, and carried by a replica
    assert pb.quad is pb.quad_stem() and pb.quad.device == CPU
    replica = pb.to("cpu")
    assert replica.quad is not pb.quad
    assert torch.equal(replica.quad.w0q, pb.quad.w0q)


# ---------------------------------------------------- 4. the default step

def _step_cfg(name, **extra):
    return dict(dtype="float32", model_path=name,
                params_path=FAMILIES[name][0],
                confidence_threshold=0.3, nms_preselect="exact", **extra)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_default_step_is_quad_and_matches_jax_default(name):
    tiles = _tiles(name, n=6)
    bounds = _bounds(len(tiles))
    size = tiles.shape[1]
    kw = dict(batch=len(tiles), model_size=size)
    cfg = _step_cfg(name)
    jstep = jax_build_detect_step(JaxDetectorConfig.from_dict(cfg),
                                  src_size=size, **kw)
    pstep = build_detect_step(DetectorConfig.from_dict(cfg), device="cpu",
                              **kw)
    assert pstep.input_layout == jstep.input_layout == "s2d2"
    off = build_detect_step(DetectorConfig.from_dict(_step_cfg(
        name, quad_stem=False)), device="cpu", **kw)
    assert off.input_layout == "hwc"
    jdet, jlon, jlat = jstep(tiles, bounds)
    pdet, plon, plat = pstep(tiles, bounds)
    valid = np.asarray(jdet.valid)
    assert valid.sum() >= len(tiles)
    np.testing.assert_array_equal(pdet.valid.numpy(), valid)
    np.testing.assert_array_equal(pdet.classes.numpy(),
                                  np.asarray(jdet.classes))
    np.testing.assert_allclose(pdet.boxes.numpy(), np.asarray(jdet.boxes),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(pdet.scores.numpy(), np.asarray(jdet.scores),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(plon.numpy()[valid], np.asarray(jlon)[valid],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(plat.numpy()[valid], np.asarray(jlat)[valid],
                               atol=1e-6, rtol=0)


GATES = {
    "default": ({}, {}),
    "opt-out": ({"quad_stem": False}, {}),
    "tta": ({"tta": True}, {}),
    "multiscale": ({"multiscale": [0.5, 1.0]}, {}),
    "enhance-shadows": ({"enhance_shadows": True}, {}),
    "crop": ({}, {"crop_size": 64}),
    "resize": ({}, {"src_size": 96}),
    "native-src": ({}, {"src_size": 64}),
    "size-not-4": ({}, {"model_size": 66}),
}


@functools.lru_cache(maxsize=None)
def _bundles(name):
    """The JAX and the port's f32 bundles of a family's fixture."""
    fixture = FAMILIES[name][0]
    return (jax_create_model(name, dtype=jnp.float32, params_path=fixture),
            create_model(name, dtype=torch.float32, params_path=fixture,
                         device="cpu", fold_bn=True))


@pytest.mark.parametrize("gate", sorted(GATES))
def test_use_quad_stem_gates_equal_jax(gate):
    extra, kw = GATES[gate]
    kw = dict({"model_size": 64}, **kw)
    jb, pb = _bundles("yolov7_itcvd")
    want = jax_use_quad_stem(jb, JaxDetectorConfig(extra=dict(extra)), **kw)
    assert use_quad_stem(pb, DetectorConfig(extra=dict(extra)), **kw) == want
    assert want == (gate in ("default", "native-src"))


# -------------------------------------------------------------- 5. int8

@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stem_constants_equal_jax(name):
    """``_stem_consts`` on JAX's folded stems gives JAX's constants bit for
    bit; the port's own folds give the same int8 kernels."""
    _, act, eps, stems = FAMILIES[name]
    v = _variables(name)
    absmax = {stems[0]: 3.7, stems[1]: 5.1}
    want = J._quantize_stems(v, absmax, bn_eps=eps, stem_names=stems,
                             act=act)
    folds = [JQ.fold_convbn(v["params"][n], v["batch_stats"][n], eps=eps)
             for n in stems]
    got = P._stem_consts(*(np.asarray(a) for f in folds for a in f),
                         absmax[stems[0]] / 127.0, absmax[stems[1]] / 127.0,
                         act)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert np.asarray(got[k]).dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w)
    own = P._quantize_stems(v, absmax, bn_eps=eps, stem_names=stems, act=act)
    for k in ("w0", "w1"):
        np.testing.assert_array_equal(own[k], np.asarray(want[k]))


@functools.lru_cache(maxsize=None)
def _calibration(name):
    """A calibration table of a family on ``_tiles(name)`` (the port's,
    which tests/test_torch_int8.py holds to JAX's; both packages quantize
    with this one table)."""
    tiles = _tiles(name)
    return P.calibrate_absmax(_bundles(name)[1], [tiles],
                              model_size=tiles.shape[1])


def _jax_stems(name):
    _, act, eps, stems = FAMILIES[name]
    v = _variables(name)
    absmax = _calibration(name)
    return v, absmax, J._quantize_stems(v, absmax, bn_eps=eps,
                                        stem_names=stems, act=act)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stems_int8_codes_equal_jax(name):
    """The fully-int8 stems on JAX's constants: codes equal to JAX's
    ``_stems_int8`` op by op, and to its jitted chain (no code differs on
    these inputs)."""
    act = FAMILIES[name][1]
    tiles = _tiles(name)
    _, _, jq = _jax_stems(name)
    xq = PQ.host_s2d2(tiles)
    eager = np.asarray(J._stems_int8({"stems": jq}, jnp.asarray(xq),
                                     act=act))
    jitted = np.asarray(jax.jit(lambda q, x: J._stems_int8(
        {"stems": q}, x, act=act))(jq, jnp.asarray(xq)))
    sq = P._device_stems({k: np.asarray(a) for k, a in jq.items()}, CPU)
    got = P._stems_int8(sq, torch.from_numpy(xq), act).numpy()
    assert got.dtype == np.int8 and got.shape == eager.shape
    np.testing.assert_array_equal(got, eager)
    assert float((got != jitted).mean()) == 0.0


def test_zeroed_border_term_breaks_row_and_column_0():
    """The border term carries the shifted zero padding: the int8 P2 is
    within 4 steps of the f32 quad stem's everywhere, and without the term
    row 0 and column 0 move by more than 10 (tests/test_int8.py's
    check)."""
    tiles = _tiles("yolov7_itcvd")[:2]
    v, absmax, jq = _jax_stems("yolov7_itcvd")
    xq = torch.from_numpy(PQ.host_s2d2(tiles))
    p2s = max(absmax["stem1"], 1e-12) / 127.0
    p2_f = PQ.quad_stem_forward(v, xq, dtype=torch.float32) \
        .permute(0, 2, 3, 1).numpy()
    sq = P._device_stems({k: np.asarray(a) for k, a in jq.items()}, CPU)
    err = np.abs(P._stems_int8(sq, xq).numpy() * p2s - p2_f)
    assert err.max() < 4 * p2s
    sq["corr"] = torch.zeros_like(sq["corr"])
    err_b = np.abs(P._stems_int8(sq, xq).numpy() * p2s - p2_f)
    assert err_b[:, 0].max() > 10 * p2s and err_b[:, :, 0].max() > 10 * p2s


@pytest.mark.parametrize("act", ["leaky", "silu"])
def test_border_mode_epilogue_equals_jax_chain(act):
    """The epilogue's border mode (the plain version here; the kernel on the
    card is held to it) against JAX's expression of ``_stems_int8``."""
    rng = np.random.default_rng(7)
    r = rng.integers(-40000, 40000, (2, 5, 7, 8)).astype(np.int32)
    m = rng.uniform(1e-3, 2e-3, 8).astype(np.float32)
    b = rng.uniform(-5, 5, 8).astype(np.float32)
    corr = rng.uniform(-30, 30, (4, 8)).astype(np.float32)
    inv = np.float32(1.7)
    y0 = (jnp.arange(5) == 0).astype(jnp.float32)[:, None, None]
    x0 = (jnp.arange(7) == 0).astype(jnp.float32)[None, :, None]
    S, Su0, Sv0, Suv = (jnp.asarray(corr[i]) for i in range(4))
    c = S - y0 * Su0 - x0 * Sv0 + (y0 * x0) * Suv
    t = jnp.asarray(r).astype(jnp.float32) * m + c + b
    y = jax.nn.leaky_relu(t, 0.1) if act == "leaky" \
        else jax.nn.silu(t) * inv
    want = np.asarray(jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8))
    np.testing.assert_array_equal(
        border_term(torch.from_numpy(corr), 5, 7).numpy(), np.asarray(c))
    got = requantize(torch.from_numpy(r), torch.from_numpy(m),
                     torch.from_numpy(b), float(inv), act,
                     corr=torch.from_numpy(corr))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="border"):
        requantize(torch.from_numpy(r).reshape(-1, 8), torch.from_numpy(m),
                   torch.from_numpy(b), None, "leaky",
                   corr=torch.from_numpy(corr))


@pytest.fixture(scope="module")
def int8_pair():
    """JAX's and the port's int8 yolov7-tiny on one calibration table, and
    8 tiles."""
    jb, pb = _bundles("yolov7_itcvd")
    tiles = scene_tiles(n=8)
    absmax = _calibration("yolov7_itcvd")
    return dict(jq=J.quantize_bundle(jb, [], absmax=absmax),
                pq=P.quantize_bundle(pb, [], absmax=absmax), tiles=tiles)


def test_int8_forward_s2d2_matches_hwc_path_and_jax(int8_pair):
    """The quad-stem entry against the hwc int8 path (every hwc detection
    has one within 1.5 px, tests/test_int8.py's bar), and the bridge
    carries the JAX bundle's stems: the port on the JAX qparams gives the
    JAX entry's scores within 1e-4 and boxes within 1e-2 px + 1e-4 of their
    size (f32 heads and decode summed in another order), as
    tests/test_torch_int8.py holds the trunk."""
    from aerial_image_recognition_tpu_torch.ops.nms import batched_nms
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch)
    pq, jq, tiles = int8_pair["pq"], int8_pair["jq"], int8_pair["tiles"][:4]
    assert pq.supports_s2d2() and "stems" in pq.q
    kw = dict(num_classes=1, conf_threshold=0.4, iou_threshold=0.45,
              max_det=32, pre_topk=256)
    x = preprocess_batch(torch.from_numpy(tiles), out_size=SIZE,
                         dtype=torch.float32)
    ref = batched_nms(*pq.forward(x), **kw)
    xq = torch.from_numpy(PQ.host_s2d2(tiles))
    got = batched_nms(*pq.forward_s2d2(xq), **kw)
    np.testing.assert_array_equal(got.valid.sum(1).numpy(),
                                  ref.valid.sum(1).numpy())
    for k in range(len(tiles)):
        gb = got.boxes[k][got.valid[k]].numpy()
        for rb in ref.boxes[k][ref.valid[k]].numpy():
            j = int(np.abs(gb[:, :2] - rb[:2]).sum(1).argmin())
            assert np.all(np.abs(gb[j, :2] - rb[:2]) < 1.5)
    q = P.qparams_from_jax(jax.device_get(jq.params["q"]), jq.static_scales)
    bridged = P.Int8Bundle.from_q(pq.spec, create_model(
        params_path=FIXTURE, dtype=torch.float32, device="cpu").variables, q,
        dtype=torch.float32, device=CPU)
    jboxes, jscores = jax.jit(jq.forward_s2d2)(jq.params,
                                               jnp.asarray(xq.numpy()))
    boxes, scores = bridged.forward_s2d2(xq)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-4,
                               atol=1e-2)
    # a float batch takes the float quad stem, then the P2 quantization:
    # the stems' weights are then not quantized, so the P2 codes differ
    # from the fully-int8 stems' by a step here and there
    assert pq.quad is None
    _, fs = pq.forward_s2d2(xq.to(torch.float32))
    _, us = pq.forward_s2d2(xq)
    assert pq.quad is not None
    np.testing.assert_allclose(fs.numpy(), us.numpy(), rtol=0, atol=0.05)


def test_turnkey_int8_on_s2d2_batches_reaches_int8(int8_pair):
    """Turnkey int8 fed s2d² batches (as the ingest plane packs them):
    calibration reads the plain images back, the rebuild keeps the layout
    and the int8 step runs the fully-int8 stems."""
    tiles = int8_pair["tiles"][:8]
    step = build_detect_step(DetectorConfig.from_dict(dict(
        params_path=FIXTURE, dtype="float32", quantize="int8")),
        batch=4, model_size=SIZE, device="cpu")
    assert isinstance(step, SelfQuantizingStep)
    assert step.input_layout == "s2d2"
    packed = PQ.host_s2d2(tiles)
    for k in range(2):
        step(packed[4 * k:4 * k + 4], _bounds(4))
    assert step.quantize_state == "int8", step.fallback_reason
    assert step.input_layout == "s2d2" and "stems" in step.bundle.q
    det, _, _ = step(packed[:4], _bounds(4))
    assert int(det.valid.sum()) >= 4


# ------------------------------------------------------ 6. entry points

def _tile_stream(images, fail_every=0, ragged_at=None, cls=TileImage):
    for i, img in enumerate(images):
        if fail_every and i % fail_every == fail_every - 1:
            yield i, None
            continue
        px = img if i != ragged_at else img[:50, :60]
        yield i, cls(pixels=np.ascontiguousarray(px),
                     bounds=(21.0, 52.2, 21.001 + i, 52.201))


@pytest.mark.parametrize("n,batch,fail_every,ragged_at",
                         [(9, 4, 0, None), (10, 4, 3, 5)])
def test_assemble_batches_s2d2_equals_jax(n, batch, fail_every, ragged_at):
    from aerial_image_recognition_tpu.fetch.xyz import TileImage as JaxTile
    images = np.random.default_rng(n).integers(0, 256, (n, 64, 64, 3)) \
        .astype(np.uint8)
    got = list(PP.assemble_batches(_tile_stream(images, fail_every,
                                                ragged_at),
                                   batch_size=batch, src_size=64,
                                   layout="s2d2"))
    want = list(JP.assemble_batches(_tile_stream(images, fail_every,
                                                 ragged_at, cls=JaxTile),
                                    batch_size=batch, src_size=64,
                                    layout="s2d2"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.images.shape == (batch, 16, 16, 48)
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.bounds, w.bounds)
        assert (g.n_valid, g.failed_indices) == (w.n_valid, w.failed_indices)


def test_city_scan_with_default_step_equals_jax(tmp_path, monkeypatch):
    """A ``CarDetector`` scan with each package's default (quad) step over
    its own fake server: the ingest plane packs s2d² batches in both."""
    from aerial_image_recognition_tpu.fetch.fake import FakeTileServer
    from aerial_image_recognition_tpu.pipeline.detector import CarDetector
    from aerial_image_recognition_tpu_torch.fetch.fake import (
        FakeTileServer as PortFakeTileServer)
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector as PortCarDetector)
    from test_torch_step import BATCH, PORT_WORLD, SIZE as S, WORLD, _scan
    cfg = dict(dtype="float32", params_path=FIXTURE, confidence_threshold=0.3,
               nms_preselect="exact")
    jstep = jax_build_detect_step(JaxDetectorConfig.from_dict(cfg),
                                  batch=BATCH, src_size=S, model_size=S)
    pstep = build_detect_step(DetectorConfig.from_dict(cfg), batch=BATCH,
                              model_size=S, device="cpu")
    assert jstep.input_layout == pstep.input_layout == "s2d2"
    layouts = []
    real = PP.assemble_batches
    monkeypatch.setattr(
        "aerial_image_recognition_tpu_torch.pipeline.detector."
        "assemble_batches",
        lambda *a, **k: layouts.append(k.get("layout")) or real(*a, **k))
    srv, psrv = FakeTileServer(WORLD), PortFakeTileServer(PORT_WORLD)
    srv.start()
    psrv.start()
    try:
        out_j, recs_j = _scan(tmp_path / "jax", srv, jstep, monkeypatch)
        out_p, recs_p = _scan(tmp_path / "port", psrv, pstep, monkeypatch,
                              detector=PortCarDetector)
    finally:
        srv.stop()
        psrv.stop()
    assert layouts and set(layouts) == {"s2d2"}
    assert out_p["tiles"] == out_j["tiles"] > 20
    assert len(recs_p) == len(recs_j) > 0
    recs_p, recs_j = np.asarray(recs_p), np.asarray(recs_j)
    np.testing.assert_allclose(recs_p[:, :2], recs_j[:, :2], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(recs_p[:, 2], recs_j[:, 2], atol=1e-5, rtol=0)


def test_server_answers_a_padded_s2d2_int8_batch(tmp_path, int8_pair):
    """The int8 deployment config behind the server
    (tests/test_serve.py::test_serve_int8_quantized_step): an s2d² step
    over an ``Int8Bundle`` packs each padded batch of requests; replies
    equal the step's detections for the same tiles."""
    import io
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image
    calib = str(tmp_path / "absmax.json")
    P.save_absmax(calib, int8_pair["pq"].absmax)
    step = build_detect_step(DetectorConfig.from_dict(dict(
        params_path=FIXTURE, dtype="float32", confidence_threshold=0.4,
        quantize="int8", quantize_calib=calib)), batch=8, model_size=SIZE,
        device="cpu")
    assert type(step.bundle).__name__ == "Int8Bundle"
    assert step.input_layout == "s2d2"
    tiles = int8_pair["tiles"][:5]
    bounds = _bounds(5)
    direct = step(np.concatenate([tiles, np.zeros((3,) + tiles.shape[1:],
                                                  np.uint8)]),
                  np.concatenate([bounds, np.tile(bounds[:1], (3, 1))]))[0]
    srv = DetectionServer(detect_step=step, max_wait_ms=200.0).start()

    def one(k):
        buf = io.BytesIO()
        Image.fromarray(tiles[k]).save(buf, "PNG")
        w, s, e, n = (float(v) for v in bounds[k])
        req = urllib.request.Request(
            f"{srv.url}/detect?west={w!r}&south={s!r}&east={e!r}"
            f"&north={n!r}", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.load(r)
    try:
        with ThreadPoolExecutor(5) as pool:      # a padded 5-of-8 batch
            bodies = list(pool.map(one, range(5)))
    finally:
        srv.stop()
    for k, body in enumerate(bodies):
        want = sorted(direct.scores[k][direct.valid[k]].tolist())
        assert body["count"] == len(want) > 0
        np.testing.assert_allclose(
            sorted(d["confidence"] for d in body["detections"]), want,
            atol=1e-6, rtol=0)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_two_shard_mesh_on_s2d2_batches_equals_one_shard(quantize, int8_pair):
    """Each shard's rows of an s2d² batch go through the mesh as they are;
    float and int8 (the replica carries the fully-int8 stems)."""
    extra = {} if quantize is None else {"quantize": "int8",
                                         "quantize_calib": None}
    cfg = DetectorConfig.from_dict(dict(params_path=FIXTURE,
                                        dtype="float32", **extra))
    bundle = None
    if quantize:
        bundle = int8_pair["pq"]
    one = build_detect_step(cfg, batch=4, model_size=SIZE, device="cpu",
                            bundle=bundle)
    two = build_detect_step(cfg, batch=4, model_size=SIZE,
                            mesh=Mesh(["cpu", "cpu"]), bundle=bundle)
    assert one.input_layout == two.input_layout == "s2d2"
    packed = PQ.host_s2d2(int8_pair["tiles"][:4])
    parts = [torch.from_numpy(packed[lo:hi]) for _, lo, hi in
             two.mesh.rows(4)]
    want = one(packed, _bounds(4))
    got = two(parts, [torch.from_numpy(_bounds(4)[lo:hi])
                      for _, lo, hi in two.mesh.rows(4)])
    for a, b in zip(want[0], got[0]):
        assert torch.equal(a, b)
    assert torch.equal(want[1], got[1]) and int(want[0].valid.sum()) >= 4
