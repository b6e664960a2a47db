"""The port's packed XUnet lowering (``ops/packed_unet.py``) against the
JAX package's, on the CPU.

Same numpy inputs through both. Tolerances: the relayouts, the cell-kernel
transform and the subpixel max pool bit-equal; the cell conv against the
reference's within 1e-5 (f32 sums in another order; the JAX test's bar
against the full-resolution conv); the BN folds within 2 f32 ulps
(``torch.rsqrt`` against XLA's rsqrt, as ``ops/quadstem.fold_convbn``);
the f32 packed forward within the JAX package's own bars of its packed
against its standard forward (rtol 1e-4, atol 2e-4), on the trained
``xunet_fakeworld.npz`` and a seeded model; bf16 logits compared by their
masks: IoU ≥ 0.99 and signs equal on ≥ 0.999 of the pixels (a bf16
conv's sums round another way in the two frameworks). The port's packed
forward against the port's standard XUnet forward at the JAX test's bars.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.models.registry import (
    create_model as jax_create_model)
from aerial_image_recognition_tpu.ops import packed_unet as J
from aerial_image_recognition_tpu_torch.models.registry import create_model
from aerial_image_recognition_tpu_torch.models.weights import load_params
from aerial_image_recognition_tpu_torch.ops import packed_unet as P

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "xunet_fakeworld.npz")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def trained():
    return load_params(FIXTURE)


@pytest.fixture(scope="module")
def seeded():
    return _np(jax_create_model("xunet_256", dtype=jnp.float32,
                                seed=3).params)


def test_relayouts_match_jax():
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)
    got = P.host_s2d(px)
    np.testing.assert_array_equal(got, J.host_s2d(px))
    assert got.shape == (2, 4, 6, 12)
    np.testing.assert_array_equal(P.host_s2d(px[0]), J.host_s2d(px[0]))
    x = rng.normal(size=(2, 4, 6, 20)).astype(np.float32)
    np.testing.assert_array_equal(P.s2d_unpack(torch.from_numpy(x)).numpy(),
                                  np.asarray(J.s2d_unpack(jnp.asarray(x))))
    np.testing.assert_array_equal(
        P.s2d_unpack(torch.from_numpy(got)).numpy(), px)
    np.testing.assert_array_equal(
        P._s2d_pool_to_standard(torch.from_numpy(x)).numpy(),
        np.asarray(J._s2d_pool_to_standard(jnp.asarray(x))))


@pytest.mark.parametrize("cin,cout", [(3, 8), (32, 32)])
def test_cell_kernels_and_conv_match_jax(cin, cout):
    rng = np.random.default_rng(cin)
    x = rng.normal(size=(2, 16, 16, cin)).astype(np.float32)
    w = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    jk = {(a, b): J.s2d_conv3x3_kernel(w, a, b)
          for a in (0, 1) for b in (0, 1)}
    pk = {(a, b): P.s2d_conv3x3_kernel(w, a, b)
          for a in (0, 1) for b in (0, 1)}
    for ab in jk:
        assert pk[ab].dtype == np.float32
        np.testing.assert_array_equal(pk[ab], np.asarray(jk[ab]))
    xs = P.host_s2d(x)
    want = np.asarray(J.s2d_conv3x3(jnp.asarray(xs), jk, jnp.asarray(bias),
                                    jax.nn.relu))
    got = P.s2d_conv3x3(torch.from_numpy(xs), pk, bias, torch.relu)
    assert tuple(got.shape) == want.shape == (2, 8, 8, 4 * cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and the full-resolution conv it stands for
    full = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(bias),
        padding=1).relu().permute(0, 2, 3, 1)
    np.testing.assert_allclose(P.s2d_unpack(got).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    # the standard conv helper
    w1 = rng.normal(size=(1, 1, cin, cout)).astype(np.float32)
    np.testing.assert_allclose(
        P._conv(torch.from_numpy(x), w1, bias, torch.relu).numpy(),
        np.asarray(J._conv(jnp.asarray(x), w1, bias, jax.nn.relu)),
        rtol=1e-5, atol=1e-5)


def test_fold_xunet_within_two_ulps(trained):
    want = J.fold_xunet(trained)
    got = P.fold_xunet(trained)
    assert got.keys() == want.keys() and len(got) == 23
    for k in want:
        for g, w in zip(got[k], want[k]):
            w = np.asarray(w)
            assert g.dtype == np.float32 and g.shape == w.shape
            assert (np.abs(g - w) <= 2 * np.spacing(np.abs(w))).all(), k


@pytest.mark.parametrize("source", ["trained", "seeded"])
def test_packed_forward_matches_jax(source, trained, seeded):
    variables = trained if source == "trained" else seeded
    rng = np.random.default_rng(1)
    xu8 = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    xs = P.host_s2d(xu8)
    want = np.asarray(J.xunet_forward_packed(variables, jnp.asarray(xs),
                                             dtype=jnp.float32))
    got = P.xunet_forward_packed(variables, torch.from_numpy(xs),
                                 dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape \
        == (2, 32, 32, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-4)
    want16 = np.asarray(J.xunet_forward_packed(variables, jnp.asarray(xs),
                                               dtype=jnp.bfloat16))
    got16 = P.xunet_forward_packed(variables, torch.from_numpy(xs),
                                   dtype=torch.bfloat16).numpy()
    a, b = got16 > 0, want16 > 0
    assert (a == b).mean() >= 0.999
    if b.any():
        assert (a & b).sum() / (a | b).sum() >= 0.99
    # the weights built once give the same function
    packed = P.PackedXUnet(variables, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(packed(torch.from_numpy(xs)).numpy(),
                                  got.numpy())


def test_packed_forward_matches_the_standard_forward():
    """``tests/test_packed_unet.py::test_packed_xunet_matches_standard_
    forward`` on the port: the seeded XUnet-256 at 256 px, f32, the packed
    forward on host-s2d uint8 against the standard forward on x/255."""
    bundle = create_model("xunet_256", dtype=torch.float32, seed=3,
                          device="cpu")
    xu8 = np.random.default_rng(2).integers(0, 255, (2, 256, 256, 3),
                                            dtype=np.uint8)
    with torch.no_grad():
        ref = bundle.forward(torch.from_numpy(xu8).permute(0, 3, 1, 2)
                             .float() / 255.0)
        got = P.s2d_unpack(P.xunet_forward_packed(
            bundle.variables, torch.from_numpy(P.host_s2d(xu8)),
            dtype=torch.float32))
    assert got.shape == ref.shape == (2, 256, 256, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=2e-4)
