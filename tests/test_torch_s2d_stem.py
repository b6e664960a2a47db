"""``YOLOv7(s2d_stem=True)`` and ``layers.space_to_depth2`` against the JAX
package's, on the CPU in f32.

The s2d-stem model is built the way the reference's tests build it: a
registry bundle with its module swapped (here ``s2d_bundle``, which gives
the bundle a spec whose ``make_module`` is the s2d model, so that
``trainable()`` builds it too). Its weights are the trained fixture's with
stem0's 3×3/2 kernel embedded in the s2d stem's 3×3 kernel (``embed_stem``:
tap ky = 0 → cell row 0, subrow 1; ky = 1 → row 1, subrow 0; ky = 2 → row
1, subrow 1; the same for columns; zeros elsewhere), so the s2d model
computes the trained detector's function; or flax's seeded init of the JAX
s2d module.

Tolerances: raw head maps atol/rtol 1e-4 (the f32 convolutions sum in
another order, as in ``test_torch_models.py``); ``space_to_depth2``
bit-equal; the train step as ``test_torch_train.py`` holds ``frozen`` BN
(loss rtol 1e-5, every gradient leaf within 2e-5 of its largest
magnitude); the spatial step over CPU shards within the bars of
``test_torch_parallel.py::test_spatial_detect_equals_single_device_and_jax``
(valid equal, boxes rtol 2e-4 atol 2e-3, lon within 1e-6).
"""

import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.models.layers import (
    space_to_depth2 as jax_space_to_depth2)
from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model)
from aerial_image_recognition_tpu.models.yolov7 import YOLOv7 as JaxYOLOv7
from aerial_image_recognition_tpu_torch.models.layers import space_to_depth2
from aerial_image_recognition_tpu_torch.models.registry import (
    REGISTRY, create_model)
from aerial_image_recognition_tpu_torch.models.weights import (
    _flatten, grads_to_flax, load_params, params_to_flax)
from aerial_image_recognition_tpu_torch.models.yolov7 import YOLOv7
from aerial_image_recognition_tpu_torch.pipeline.inference import (
    build_detect_step, make_detect_fn)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")
S = 64
CFG = dict(dtype="float32", params_path=FIXTURE, confidence_threshold=0.3,
           nms_preselect="exact")


def embed_stem(variables):
    """The fixture's variables with stem0's [3,3,3,32] stride-2 kernel
    embedded in the s2d stem's [3,3,12,32] stride-1 kernel (input channels
    in the (dy, dx, c) order of ``space_to_depth2``)."""
    k = np.asarray(variables["params"]["stem0"]["conv"]["kernel"],
                   np.float32)
    c = k.shape[2]
    cell = {0: (0, 1), 1: (1, 0), 2: (1, 1)}        # tap → (cell, subpixel)
    out = np.zeros((3, 3, 4 * c, k.shape[3]), np.float32)
    for ky, (u, dy) in cell.items():
        for kx, (v, dx) in cell.items():
            lo = (2 * dy + dx) * c
            out[u, v, lo:lo + c] = k[ky, kx]
    params = dict(variables["params"])
    params["stem0"] = dict(params["stem0"], conv={"kernel": out})
    return dict(variables, params=params)


def s2d_bundle(variables, dtype=torch.float32, fold_bn=True):
    """A yolov7_itcvd bundle whose module is ``YOLOv7(s2d_stem=True)``."""
    spec = dataclasses.replace(REGISTRY["yolov7_itcvd"],
                               make_module=lambda: YOLOv7(s2d_stem=True))
    with mock.patch.dict(REGISTRY, {"yolov7_itcvd_s2d": spec}):
        return create_model("yolov7_itcvd_s2d", variables=variables,
                            dtype=dtype, device="cpu", fold_bn=fold_bn)


@pytest.fixture(scope="module")
def trained():
    return load_params(FIXTURE)


@pytest.fixture(scope="module")
def tiles():
    from test_torch_step import _tiles
    return _tiles(2, S)


def test_space_to_depth2_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 6, 8, 3)) \
        .astype(np.float32)
    want = np.asarray(jax_space_to_depth2(jnp.asarray(x)))       # NHWC
    got = space_to_depth2(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (2, 12, 3, 4)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # pixel_unshuffle orders the channels (c, dy, dx): not this layout
    pu = torch.nn.functional.pixel_unshuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert not torch.equal(pu, got)


def test_s2d_stem_shapes():
    """``tests/test_models.py::test_yolov7_s2d_stem_shapes``'s contract."""
    module = YOLOv7(num_classes=1, variant="tiny", s2d_stem=True).eval()
    with torch.no_grad():
        outs = module(torch.zeros(1, 3, S, S))
    assert [tuple(o.shape) for o in outs] == [
        (1, S // 8, S // 8, 18), (1, S // 16, S // 16, 18),
        (1, S // 32, S // 32, 18)]
    tree = params_to_flax(module)
    assert tree["params"]["stem0"]["conv"]["kernel"].shape == (3, 3, 12, 32)
    assert YOLOv7(variant="base", s2d_stem=True).stem0.conv.in_channels == 3


@pytest.mark.parametrize("source", ["trained-embedded", "seed0"])
def test_raw_maps_match_jax(source, trained, tiles):
    jm = JaxYOLOv7(num_classes=1, variant="tiny", dtype=jnp.float32,
                   s2d_stem=True)
    if source == "seed0":
        variables = jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=False))
    else:
        variables = embed_stem(trained)
    x = tiles[0].astype(np.float32) / 255.0
    want = jm.apply(variables, jnp.asarray(x), train=False)
    for fold in (False, True):
        b = s2d_bundle(variables, fold_bn=fold)
        with torch.no_grad():
            got = b.module(torch.from_numpy(x).permute(0, 3, 1, 2))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)


def test_embedded_stem_equals_the_plain_stem(trained, tiles):
    x = torch.from_numpy(tiles[0].astype(np.float32) / 255.0) \
        .permute(0, 3, 1, 2)
    plain = create_model(variables=trained, dtype=torch.float32,
                         device="cpu", fold_bn=True)
    s2d = s2d_bundle(embed_stem(trained))
    with torch.no_grad():
        for g, w in zip(s2d.module(x), plain.module(x)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4,
                                       rtol=1e-4)


def test_no_quad_stem_and_no_int8(trained, tiles):
    """The quad stem's lowering needs two stride-2 3×3 stems (JAX
    ``_s2d2_meta``): an s2d-stem bundle's default step keeps the hwc layout
    and builds no quad stem; its int8 quantization raises the reference's
    message."""
    from aerial_image_recognition_tpu.models.int8 import (
        quantize_bundle as jax_quantize_bundle)
    from aerial_image_recognition_tpu_torch.models.int8 import (
        quantize_bundle)
    b = s2d_bundle(embed_stem(trained))
    assert not b.supports_s2d2()
    jb = jax_create_model("yolov7_itcvd", dtype=jnp.float32)
    jb = dataclasses.replace(jb, module=JaxYOLOv7(
        num_classes=1, variant="tiny", dtype=jnp.float32, s2d_stem=True))
    assert not jb.supports_s2d2()
    cfg = DetectorConfig.from_dict(CFG)
    step = build_detect_step(cfg, bundle=b, batch=2, model_size=S,
                             device="cpu")
    assert step.input_layout == "hwc"
    images, bounds = tiles
    det, lon, lat = step(images, bounds)
    assert b.quad is None and int(det.valid.sum()) >= 2
    plain = build_detect_step(DetectorConfig.from_dict(dict(
        CFG, quad_stem=False)), batch=2, model_size=S, device="cpu")
    pdet, _, _ = plain(images, bounds)
    np.testing.assert_array_equal(det.valid.numpy(), pdet.valid.numpy())
    np.testing.assert_allclose(det.boxes.numpy(), pdet.boxes.numpy(),
                               atol=1e-3, rtol=0)
    with pytest.raises(ValueError, match="no quad-stem lowering"):
        b.quad_stem()
    batch = [np.zeros((1, S, S, 3), np.uint8)]
    with pytest.raises(NotImplementedError) as want:
        jax_quantize_bundle(jb, batch)
    with pytest.raises(NotImplementedError) as got:
        quantize_bundle(b, batch, model_size=S)
    assert str(got.value) == str(want.value)
    assert "s2d_stem experiment" in str(got.value)


def test_train_step_matches_jax(trained):
    """One ``frozen``-BN train step of the s2d model (embedded trained
    weights), the reference's own ``make_train_step`` on the JAX s2d module
    against the port's, on the batch of ``test_torch_train.py``."""
    from aerial_image_recognition_tpu.pipeline import train as JT
    from aerial_image_recognition_tpu_torch.pipeline import train as PT
    from test_torch_train import _GRAB
    images = np.random.default_rng(0).integers(0, 255, (2, S, S, 3),
                                               dtype=np.uint8)
    targets = np.full((2, 8, 5), -1.0, np.float32)
    targets[0, :2] = [(0, 32, 32, 12, 10), (0, 10, 50, 9, 6)]
    targets[1, :3] = [(0, 20, 40, 8, 8), (0, 50, 10, 20, 14),
                      (0, 52, 12, 11, 13)]
    variables = embed_stem(trained)
    jb = jax_create_model("yolov7_itcvd", dtype=jnp.float32)
    jb = dataclasses.replace(
        jb, module=JaxYOLOv7(num_classes=1, variant="tiny",
                             dtype=jnp.float32, s2d_stem=True),
        params=jax.tree_util.tree_map(jnp.asarray, variables))
    out, m = JT.make_train_step(jb, _GRAB, bn_mode="frozen")(
        JT.init_train_state(jb, _GRAB), images, targets)
    want = {"/".join(k): np.asarray(v)
            for k, v in _flatten(jax.tree_util.tree_map(
                np.asarray, out["opt_state"]))}
    pb = s2d_bundle(variables, fold_bn=False)
    tx = PT.make_optimizer(lr=1e-3)
    loss, _, grads, _ = PT.make_train_step(pb, tx, bn_mode="frozen") \
        .loss_and_grads(PT.init_train_state(pb, tx), images, targets)
    np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-5)
    got = {"/".join(k): np.asarray(v)
           for k, v in _flatten(grads_to_flax(grads)["params"])}
    assert got.keys() == want.keys()
    assert got["stem0/conv/kernel"].shape == (3, 3, 12, 32)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("shards", [2, 3])
def test_spatial_detect_equals_one_device(shards, trained):
    """``make_spatial_detect`` over CPU shards: ``space_to_depth2`` on
    row-sharded input takes its row rule (3 shards of 256 rows split at
    odd rows), nothing before the heads is gathered, and the detections
    equal the unsharded step's."""
    from aerial_image_recognition_tpu_torch.parallel import spatial as SP
    from aerial_image_recognition_tpu_torch.parallel.mesh import Mesh
    from test_torch_parallel import _spatial_tiles
    size = 256
    cfg = DetectorConfig.from_dict(CFG)
    b = s2d_bundle(embed_stem(trained))
    imgs, bnds = _spatial_tiles(size=size)
    det_r, lon_r, _ = make_detect_fn(b, cfg, model_size=size)(
        torch.from_numpy(imgs), torch.from_numpy(bnds))
    gathered = []
    real = SP._gathered
    with mock.patch.object(SP, "_gathered", lambda f, a, k: (
            gathered.append(f.__name__), real(f, a, k))[1]):
        det_s, lon_s, _ = SP.make_spatial_detect(
            b, cfg, Mesh(["cpu"] * shards), model_size=size)(imgs, bnds)
    assert gathered == ["permute"] * 3
    v = det_r.valid.numpy()
    assert v.sum() >= 1
    np.testing.assert_array_equal(det_s.valid.numpy(), v)
    np.testing.assert_allclose(det_s.boxes.numpy()[v], det_r.boxes.numpy()[v],
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(lon_s.numpy()[v], lon_r.numpy()[v], rtol=0,
                               atol=1e-6)
    x = torch.arange(2 * 3 * 10 * 4, dtype=torch.float32).reshape(2, 3, 10, 4)
    r = SP.RowShards.split(x, [torch.device("cpu")] * 4)     # rows 2,3,2,3
    assert torch.equal(space_to_depth2(r).whole(), space_to_depth2(x))


def test_turnkey_int8_falls_back_as_jax(trained, tiles):
    """Turnkey int8 on an s2d-stem bundle: the reference's
    ``SelfQuantizingStep`` catches the refusal and stays float, with the
    message as its reason; the port's does the same (it catches
    ``quantize_bundle``'s NotImplementedError beside KeyError/ValueError)."""
    from aerial_image_recognition_tpu.pipeline.inference import (
        build_detect_step as jax_build_detect_step)
    from aerial_image_recognition_tpu.runtime.config import (
        DetectorConfig as JaxDetectorConfig)
    variables = embed_stem(trained)
    extra = dict(CFG, quantize="int8", quantize_calib_batches=1)
    images, bounds = tiles
    jb = jax_create_model("yolov7_itcvd", dtype=jnp.float32)
    jb = dataclasses.replace(
        jb, module=JaxYOLOv7(num_classes=1, variant="tiny",
                             dtype=jnp.float32, s2d_stem=True),
        params=jax.tree_util.tree_map(jnp.asarray, variables))
    jstep = jax_build_detect_step(JaxDetectorConfig.from_dict(extra),
                                  bundle=jb, batch=2, model_size=S)
    jstep(images, bounds)
    step = build_detect_step(DetectorConfig.from_dict(extra),
                             bundle=s2d_bundle(variables), batch=2,
                             model_size=S, device="cpu")
    det = step(images, bounds)[0]
    assert step.quantize_state == jstep.quantize_state == "bf16-fallback"
    for reason in (step.fallback_reason, jstep.fallback_reason):
        assert "s2d_stem experiment" in reason
    assert int(det.valid.sum()) >= 2
