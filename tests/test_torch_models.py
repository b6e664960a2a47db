"""The port's weight bridge, YOLOv7-tiny and decode against the JAX package.

Same numpy inputs through flax ``raw_apply`` and the torch module (f32, CPU,
64 px, batch 2). Tolerances: head logits atol/rtol 1e-4 (f32 convolutions
summed in another order); decoded boxes atol 1e-3 px, scores atol 1e-5.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.fetch.fake import FakeWorld
from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model, load_params as jax_load_params,
    save_params as jax_save_params)
from aerial_image_recognition_tpu.ops.decode import (
    decode_yolov7 as jax_decode_yolov7)
from aerial_image_recognition_tpu_torch.models.layers import fold_batchnorm
from aerial_image_recognition_tpu_torch.models.registry import create_model
from aerial_image_recognition_tpu_torch.models.weights import (
    load_flax_into, load_params, params_from_flax)
from aerial_image_recognition_tpu_torch.models.yolov7 import (
    ANCHORS_TINY, YOLOv7)
from aerial_image_recognition_tpu_torch.ops.decode import decode_yolov7

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "yolov7_tiny_fakeworld.npz")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_bundle():
    return jax_create_model("yolov7_itcvd", dtype=jnp.float32, seed=0)


@pytest.fixture(scope="module")
def images():
    """Two 64-px FakeWorld tiles at the fixture's training scale (0.5 m/px)
    around cars, /255."""
    world = FakeWorld(center_lon=21.0, center_lat=52.2, extent_deg=0.01,
                      n_cars=300, seed=5)
    m2lon = 1.0 / (111319.9 * math.cos(math.radians(52.2)))
    m2lat = 1.0 / 111319.9
    tiles = []
    for k in (3, 17):
        lon, lat, _ = world.cars[k]
        tiles.append(world.render((lon - 15.0 * m2lon, lat - 17.0 * m2lat,
                                   lon + 17.0 * m2lon, lat + 15.0 * m2lat),
                                  64, 64))
    return np.stack(tiles).astype(np.float32) / 255.0


def _variables(source, jax_bundle):
    if source == "trained":
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                      jax_load_params(FIXTURE))
    return jax_bundle.params


def test_load_params_matches_reference_reader(tmp_path):
    ref = jax_load_params(FIXTURE)
    got = load_params(FIXTURE)
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_ref.keys() == flat_got.keys()
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(v), flat_got[k])
    # bf16 leaves: stored as uint16 under ':bf16', widened exactly to f32
    rng = np.random.default_rng(1)
    tree = {"params": {"a": {"kernel": jnp.asarray(
        rng.normal(size=(3, 5)), jnp.bfloat16)}}}
    path = str(tmp_path / "bf16.npz")
    jax_save_params(tree, path)
    np.testing.assert_array_equal(
        load_params(path)["params"]["a"]["kernel"],
        np.asarray(tree["params"]["a"]["kernel"], np.float32))


def test_weight_bridge_covers_every_leaf():
    module = YOLOv7()
    tree = load_params(FIXTURE)
    sd = params_from_flax(tree)
    want = {k for k in module.state_dict()
            if not k.endswith("num_batches_tracked")}
    assert set(sd) == want
    # layouts: HWIO → OIHW for convs, 1×1 HWIO → [O, I] for the heads
    k = tree["params"]["stem0"]["conv"]["kernel"]
    np.testing.assert_array_equal(sd["stem0.conv.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    k = tree["params"]["detect1"]["kernel"]
    np.testing.assert_array_equal(sd["detect1.weight"].numpy(), k[0, 0].T)
    with pytest.raises(KeyError, match="no torch counterpart"):
        params_from_flax({"params": {"x": {"gamma": np.zeros(3)}}})


@pytest.mark.parametrize("source", ["trained", "seed0"])
@pytest.mark.parametrize("form", ["plain", "folded"])
def test_heads_match_flax(jax_bundle, images, source, form):
    variables = _variables(source, jax_bundle)
    want = jax_bundle.raw_apply(variables, jnp.asarray(images))
    module = YOLOv7().eval()
    load_flax_into(module, variables)
    if form == "folded":
        fold_batchnorm(module)
    with torch.no_grad():
        got = module(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_decode_matches_flax(jax_bundle, images):
    outs = [np.array(o) for o in jax_bundle.raw_apply(
        _variables("trained", jax_bundle), jnp.asarray(images))]
    wb, ws = jax_decode_yolov7([jnp.asarray(o) for o in outs],
                               ANCHORS_TINY, 1)
    gb, gs = decode_yolov7([torch.from_numpy(o) for o in outs],
                           ANCHORS_TINY, 1)
    assert tuple(gb.shape) == wb.shape and tuple(gs.shape) == ws.shape
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5,
                               rtol=0)
    # nc > 1: score = objectness · class probability
    rng = np.random.default_rng(2)
    outs3 = [rng.normal(size=(2, s, s, 24)).astype(np.float32)
             for s in (8, 4, 2)]
    wb, ws = jax_decode_yolov7([jnp.asarray(o) for o in outs3],
                               ANCHORS_TINY, 3)
    gb, gs = decode_yolov7([torch.from_numpy(o) for o in outs3],
                           ANCHORS_TINY, 3)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5,
                               rtol=0)


def test_create_model_bundle_forward(images):
    bundle = create_model(params_path=FIXTURE, dtype=torch.float32,
                          device="cpu", fold_bn=True)
    assert bundle.spec.class_names == ("car",)
    boxes, scores = bundle.forward(
        torch.from_numpy(images).permute(0, 3, 1, 2))
    n = 3 * (8 * 8 + 4 * 4 + 2 * 2)
    assert tuple(boxes.shape) == (2, n, 4) and tuple(scores.shape) == (2, n, 1)
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
    # random weights come from the seed, with the detection-prior bias
    a = create_model(seed=3, dtype=torch.float32, device="cpu").module
    b = create_model(seed=3, dtype=torch.float32, device="cpu").module
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert float(a.detect0.bias[4]) == -5.0
    with pytest.raises(FileNotFoundError):
        create_model(params_path="/nonexistent.npz", device="cpu")
    with pytest.raises(ValueError, match="variant"):
        YOLOv7(variant="huge")
