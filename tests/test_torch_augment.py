"""The port's TTA variation stack against the JAX package.

The same numpy images go through both; the port takes NCHW, the JAX
package NHWC. Tolerances: f32 within 1e-5 for everything but the CLAHE
variations, whose LAB round trip has no bit-exact cbrt in torch: RGB within
2/255 max and 1e-4 mean (see tests/test_torch_clahe.py). bf16 within 1/128
(one bf16 step near 1.0 is 1/256; the two frameworks round at different
places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.ops import augment as J
from aerial_image_recognition_tpu_torch.ops import augment as P
from aerial_image_recognition_tpu_torch.ops.clahe_kernel import apply_luts

torch.set_num_threads(2)        # xdist workers share the cores

B, S = 2, 64


def _images(seed=0, size=S):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = 0.42 + 0.3 * np.sin(yy / 7.0) * np.cos(xx / 5.0)
    x = base[None, :, :, None] + rng.uniform(-0.2, 0.2, (B, size, size, 3))
    x[0, :9, :9] = 0.0                          # gamma's clip floor
    return np.clip(x, 0, 1).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _assert_close(name, got, want, bf16=False):
    err = np.abs(got - want)
    if bf16:
        tol = 1 / 128 + (2 / 255 if name.startswith("clahe") else 0)
        assert err.max() <= tol, (name, err.max())
    elif name.startswith("clahe"):
        assert err.max() <= 2 / 255 and err.mean() <= 1e-4, \
            (name, err.max(), err.mean())
    else:
        assert err.max() <= 1e-5, (name, err.max())


def test_default_variations_are_the_reference_table():
    assert P.DEFAULT_VARIATIONS == J.DEFAULT_VARIATIONS


@pytest.mark.parametrize("name", [n for n, _ in J.DEFAULT_VARIATIONS])
def test_variation_matches_jax(name):
    x = _images()
    want = np.asarray(J.apply_variation(jnp.asarray(x), name))
    got = P.apply_variation(_nchw(x), name)
    assert tuple(got.shape) == (B, 3, S, S) and got.dtype == torch.float32
    _assert_close(name, _nhwc(got), want)
    if name != "original":
        assert np.abs(want - x).max() > 0.01


@pytest.mark.parametrize("name", ["solarize_2.0", "shadow", "clahe",
                                  "localcontrast_2.0"])
def test_unknown_variation_raises(name):
    """Names outside the detect ladder raise, in a ladder too (the
    reference's 'shadow' and 'localcontrast' variations are not ported)."""
    with pytest.raises(KeyError, match="unknown TTA variation"):
        P.apply_variation(_nchw(_images()), name)
    with pytest.raises(KeyError, match="unknown TTA variation"):
        P.expand_tta(_nchw(_images()), (("original", 1.0), (name, 0.5)))


def test_enhance_shadows_mean_is_per_image():
    """The contrast stretch pivots on each image's own mean over (C,H,W):
    an image's result does not depend on its batch neighbours."""
    x = _images(1)
    x[1] *= 0.3
    both = P.enhance_shadows(_nchw(x))
    alone = P.enhance_shadows(_nchw(x[1:]))
    assert torch.equal(both[1:], alone)
    np.testing.assert_allclose(
        _nhwc(both), np.asarray(J.enhance_shadows(jnp.asarray(x))),
        atol=1e-5, rtol=0)


def test_expand_tta_order_weights_and_fold():
    x = _images(3)
    jxv, jw = J.expand_tta(jnp.asarray(x))
    xv, w = P.expand_tta(_nchw(x))
    v = len(P.DEFAULT_VARIATIONS)
    assert tuple(xv.shape) == (B * v, 3, S, S)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    want = np.asarray(jxv)
    for i, (name, _) in enumerate(P.DEFAULT_VARIATIONS):
        # variation-major: x_v = out[v·B:(v+1)·B]
        got_i = xv[i * B:(i + 1) * B]
        _assert_close(name, _nhwc(got_i), want[i * B:(i + 1) * B])
        # the folded multi-clip pass equals the per-variation ladder
        assert torch.equal(got_i, P.apply_variation(_nchw(x), name)), name


def test_expand_tta_custom_ladder_and_subsample():
    x = _images(4, size=128)[:1].repeat(2, 0)
    ladder = (("clahe_3.0", 0.7), ("original", 1.0), ("gamma_2.2", 0.5))
    for sub in (1, 2):
        jxv, jw = J.expand_tta(jnp.asarray(x), ladder,
                               clahe_hist_subsample=sub)
        xv, w = P.expand_tta(_nchw(x), ladder, clahe_hist_subsample=sub)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        want = np.asarray(jxv)
        for i, (name, _) in enumerate(ladder):
            _assert_close(name, _nhwc(xv[i * 2:(i + 1) * 2]),
                          want[i * 2:(i + 1) * 2])


def test_expand_tta_bf16():
    """The production dtype: brightness and gamma run in bf16, CLAHE in f32
    and back."""
    x = _images(5)
    jxv, jw = J.expand_tta(jnp.asarray(x, jnp.bfloat16))
    xv, w = P.expand_tta(_nchw(x).to(torch.bfloat16))
    assert xv.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    want = np.asarray(jxv.astype(jnp.float32))
    for i, (name, _) in enumerate(P.DEFAULT_VARIATIONS):
        _assert_close(name, _nhwc(xv[i * B:(i + 1) * B]),
                      want[i * B:(i + 1) * B], bf16=True)


def test_expand_tta_on_cpu_launches_no_kernel():
    before = apply_luts.launches
    P.expand_tta(_nchw(_images(6)))
    assert apply_luts.launches == before

