"""The port's device preprocessing (crop, resize, /255) against the JAX
package.

Resize matrices: the port recomputes ``jax.image.resize``'s 1-D weights in
numpy. Upscales and dyadic-friendly downscales come out bit-equal; for
864→640 and 640→544 a handful of entries differ by one f32 ULP (XLA sums the
normalization in another order), and lanczos3 by the ULPs of two ``sin``
implementations: all within 2.5e-7.

Images: bf16 results within 1/128 (one bf16 step below 1.0 is 1/256, and the
two frameworks sum in different orders before rounding); f32 results of
``matmul_resize_float`` within 4e-5, the bound of the JAX package's own
test of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.ops import preprocess as J
from aerial_image_recognition_tpu_torch.ops import preprocess as P

torch.set_num_threads(2)        # xdist workers share the cores

PAIRS = [(864, 640), (640, 544), (640, 736), (64, 32), (64, 96)]


@pytest.mark.parametrize("method", ["bilinear", "lanczos3"])
@pytest.mark.parametrize("src,dst", PAIRS)
def test_resize_matrix_matches_jax(src, dst, method):
    want = J._resize_matrix(src, dst, method)
    got = P._resize_matrix(src, dst, method)
    assert got.shape == (dst, src) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2.5e-7, rtol=0)
    np.testing.assert_array_equal(got == 0, want == 0)     # same support
    if method == "bilinear":
        assert (got != want).sum() <= 32                   # one-ULP strays
        if dst > src or src % dst == 0:
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)


def test_resize_matrix_rejects_nearest():
    with pytest.raises(ValueError, match="nearest"):
        P._resize_matrix(64, 32, "nearest")


def _tiles(seed, b, size):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = 120 + 90 * np.sin(yy / 11.0) * np.cos(xx / 6.0)
    img = base[None, :, :, None] + rng.normal(0, 20, (b, size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", ["native", "crop-only", "crop-resize",
                                  "864-640", "upscale-lanczos3"])
def test_preprocess_batch_matches_jax(case, dtype):
    src, crop, out, method, b = {
        "native": (64, None, 64, "bilinear", 2),
        "crop-only": (96, 64, 64, "bilinear", 2),
        "crop-resize": (128, 108, 80, "bilinear", 2),
        "864-640": (864, None, 640, "bilinear", 1),
        "upscale-lanczos3": (48, None, 64, "lanczos3", 2),
    }[case]
    img = _tiles(1, b, src)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(J.preprocess_batch(
        jnp.asarray(img), out_size=out, crop_size=crop, method=method,
        dtype=jd).astype(jnp.float32))
    got = P.preprocess_batch(torch.from_numpy(img), out_size=out,
                             crop_size=crop, method=method, dtype=td)
    assert tuple(got.shape) == (b, 3, out, out) and got.dtype == td
    # both contract in bf16 with f32 sums whatever the output dtype
    np.testing.assert_allclose(_nhwc(got), want, atol=1 / 128, rtol=0)
    assert np.abs(_nhwc(got) - want).mean() < 1e-4
    if case in ("native", "crop-only"):
        # no resize: bf16 bit-equal; f32 within an ULP (the jitted
        # reference multiplies by 1/255 where torch divides)
        np.testing.assert_allclose(
            _nhwc(got), want, rtol=0,
            atol=0 if dtype == "bfloat16" else 1.2e-7)
        assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("size", [32, 96, 64])
def test_matmul_resize_float_matches_jax(size):
    x = _tiles(2, 2, 64).astype(np.float32) / 255.0
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = np.asarray(J.matmul_resize_float(jnp.asarray(x), size))
    got = P.matmul_resize_float(xt, size)
    assert got.dtype == torch.float32 \
        and tuple(got.shape) == (2, 3, size, size)
    np.testing.assert_allclose(_nhwc(got), want, atol=4e-5, rtol=0)
    want16 = np.asarray(J.matmul_resize_float(
        jnp.asarray(x, jnp.bfloat16), size).astype(jnp.float32))
    got16 = P.matmul_resize_float(xt.to(torch.bfloat16), size)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got16), want16, atol=1 / 128, rtol=0)


def test_unported_resize_paths_raise():
    img = torch.zeros((1, 48, 48, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="nearest"):
        P.preprocess_batch(img, out_size=32, method="nearest")
    with pytest.raises(NotImplementedError, match="matmul=False"):
        P.preprocess_batch(img, out_size=32, matmul=False)
    # at the native size neither is needed
    assert tuple(P.preprocess_batch(img, out_size=48, method="nearest",
                                    matmul=False).shape) == (1, 3, 48, 48)
