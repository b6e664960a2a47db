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

The ``jax.image.resize`` lowering (every method name, ``matmul=False``):
nearest bit-equal in bf16 and within 1.2e-7 in f32 (the jitted reference
multiplies by 1/255 where torch divides); the linear methods on x/255 in
f32 within 1e-6 (the readings are ≤ 9.6e-7: the weights' ULPs and XLA's f32
contraction), in bf16 within 1/128 with a mean below 1e-4. ``resize`` on
float tiles: bf16 bit-equal to the reference for bilinear (multiscale's)
and nearest, the others at the bf16 bars above; f32 within 4e-6 of it and
within 5e-7 of the f64 product of the same weights (3.5e-7 read for
lanczos3, whose negative lobes sum above 1; the reference's own
f32 contraction reads up to 1.7e-6 from that product, the port's 1e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.ops import preprocess as J
from aerial_image_recognition_tpu_torch.ops import preprocess as P

torch.set_num_threads(2)        # xdist workers share the cores

PAIRS = [(864, 640), (640, 544), (640, 736), (64, 32), (64, 96)]


@pytest.mark.parametrize("method", ["bilinear", "lanczos3", "cubic",
                                    "lanczos5", "tricubic", "triangle"])
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
    """The resize lowerings once refused (nearest, ``matmul=False``) run now
    and equal the reference's; what still raises is what the reference
    refuses: a method name ``jax.image.resize`` does not know (ValueError,
    as there), wherever a resize is needed."""
    img = torch.from_numpy(_tiles(3, 1, 48))
    for kw in (dict(method="nearest"), dict(matmul=False),
               dict(method="nearest", matmul=False)):
        want = np.asarray(J.preprocess_batch(
            jnp.asarray(img.numpy()), out_size=32, dtype=jnp.float32, **kw))
        got = P.preprocess_batch(img, out_size=32, dtype=torch.float32, **kw)
        np.testing.assert_allclose(_nhwc(got), want, atol=1e-6, rtol=0)
    for kw in (dict(method="area"), dict(method="Bilinear", matmul=False)):
        with pytest.raises(ValueError, match="Unknown resize method"):
            J.preprocess_batch(jnp.asarray(img.numpy()), out_size=32, **kw)
        with pytest.raises(ValueError, match="Unknown resize method"):
            P.preprocess_batch(img, out_size=32, **kw)
    # at the native size no resize is needed, so no name is checked
    assert tuple(P.preprocess_batch(img, out_size=48, method="area",
                                    matmul=False).shape) == (1, 3, 48, 48)


METHOD_NAMES = ["nearest", "linear", "bilinear", "trilinear", "triangle",
                "lanczos3", "lanczos5", "cubic", "bicubic", "tricubic"]
GEOMETRIES = {"down": (96, None, 64), "up": (48, None, 64),
              "crop": (128, 108, 80)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("matmul", [True, False])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("method", METHOD_NAMES)
def test_preprocess_every_method_matches_jax(method, geometry, matmul, dtype):
    src, crop, out = GEOMETRIES[geometry]
    img = _tiles(4, 2, src)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(J.preprocess_batch(
        jnp.asarray(img), out_size=out, crop_size=crop, method=method,
        dtype=jd, matmul=matmul).astype(jnp.float32))
    got = P.preprocess_batch(torch.from_numpy(img), out_size=out,
                             crop_size=crop, method=method, dtype=td,
                             matmul=matmul)
    assert tuple(got.shape) == (2, 3, out, out) and got.dtype == td
    got = _nhwc(got)
    if method == "nearest":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=0 if dtype == "bfloat16" else 1.2e-7)
    elif dtype == "float32" and not (matmul and method in ("bilinear",
                                                           "lanczos3")):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        # bf16 outputs, and the matrix path's bf16 contractions
        np.testing.assert_allclose(got, want, atol=1 / 128, rtol=0)
        assert np.abs(got - want).mean() < 1e-4


def test_nearest_index_is_the_compiled_reference():
    """XLA folds the reference's ``(i + 0.5)·m / n`` into
    ``(i + 0.5)·(m·(1/n))``; the port's host index vector is that, on every
    size from 2 to 80 px onto 31 px (where the plain quotient reads one
    pixel further at 34, 42, 50, 58, 68 and 74 px) and 33 px, and on the
    production geometries. One resize of a 2-D array (value 2048·row +
    column, exact in f32) checks two geometries at once."""
    import jax
    geoms = [(m, n) for m in range(2, 81) for n in (31, 33)] + [
        (640, 544), (640, 736), (699, 640), (864, 640), (1280, 640),
        (1024, 640), (96, 64), (48, 64)]
    for (m0, n0), (m1, n1) in zip(geoms[::2], geoms[1::2]):
        x = np.arange(m0, dtype=np.float32)[:, None] * np.float32(2048) \
            + np.arange(m1, dtype=np.float32)[None, :]
        got = np.asarray(jax.image.resize(jnp.asarray(x), (n0, n1),
                                          "nearest")).astype(np.int64)
        np.testing.assert_array_equal(P._nearest_index(m0, n0),
                                      got[:, 0] // 2048)
        np.testing.assert_array_equal(P._nearest_index(m1, n1),
                                      got[0] % 2048)
    assert P._nearest_index(34, 31)[15] == 16


@pytest.mark.parametrize("method", ["bilinear", "cubic", "lanczos3",
                                    "nearest"])
@pytest.mark.parametrize("src,dst", [(64, 32), (64, 96), (640, 544),
                                     (640, 736), (64, 64)])
def test_resize_matches_jax_image_resize(src, dst, method):
    import jax
    x = np.random.default_rng(5).random((2, src, src, 3), np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def ref(v):
        return np.asarray(jax.jit(lambda a: jax.image.resize(
            a, (2, dst, dst, 3), method))(v).astype(jnp.float32))
    got16 = P.resize(xt.to(torch.bfloat16), dst, method)
    assert got16.dtype == torch.bfloat16
    want16 = ref(jnp.asarray(x, jnp.bfloat16))
    if method in ("bilinear", "nearest"):       # multiscale's resize
        np.testing.assert_array_equal(_nhwc(got16), want16)
    else:   # a weight one f32 ULP apart may round to another bf16
        np.testing.assert_allclose(_nhwc(got16), want16, atol=1 / 128,
                                   rtol=0)
        assert np.abs(_nhwc(got16) - want16).mean() < 1e-4
    got = P.resize(xt, dst, method)
    assert got.dtype == torch.float32 \
        and tuple(got.shape) == (2, 3, dst, dst)
    np.testing.assert_allclose(_nhwc(got), ref(jnp.asarray(x)), atol=4e-6,
                               rtol=0)
    if method != "nearest":
        r = P._resize_matrix(src, dst, method).astype(np.float64) \
            if src != dst else np.eye(src)
        exact = np.einsum("ih,bhwc,jw->bijc", r, x.astype(np.float64), r,
                           optimize=True)
        np.testing.assert_allclose(_nhwc(got), exact, atol=5e-7, rtol=0)


def test_matmul_false_is_not_the_matrix_path():
    """The preprocess's matrix path (``_matmul_resize``) rounds the pixels
    and weights to bf16, ``matmul=False`` contracts x/255 in f32: on the
    1280 → 640 geometry they differ by more than 1e-3 (the reference's own
    two lowerings differ by up to 3.2e-3 there), so the one is no stand-in
    for the other."""
    img = _tiles(6, 1, 1280)
    a = P.preprocess_batch(torch.from_numpy(img), out_size=640,
                           dtype=torch.float32, matmul=False)
    b = P.preprocess_batch(torch.from_numpy(img), out_size=640,
                           dtype=torch.float32, matmul=True)
    assert 1e-3 < float((a - b).abs().max()) < 1e-2


def test_assemble_mosaic_matches_jax():
    tiles = np.zeros((1, 4, 4, 4, 3), np.uint8)
    for i in range(4):
        tiles[0, i] = (i + 1) * 50
    got = P.assemble_mosaic(torch.from_numpy(tiles), grid=(2, 2), tile_px=4)
    assert tuple(got.shape) == (1, 8, 8, 3) and got.dtype == torch.uint8
    assert (got[0, :4, :4] == 50).all() and (got[0, :4, 4:] == 100).all()
    assert (got[0, 4:, :4] == 150).all() and (got[0, 4:, 4:] == 200).all()
    rng = np.random.default_rng(7)
    for b, (gy, gx), t in ((2, (2, 3), 4), (1, (3, 3), 16)):
        tiles = rng.integers(0, 256, (b, gy * gx, t, t, 3), np.uint8)
        want = np.asarray(J.assemble_mosaic(jnp.asarray(tiles),
                                            grid=(gy, gx), tile_px=t))
        got = P.assemble_mosaic(torch.from_numpy(tiles), grid=(gy, gx),
                                tile_px=t)
        np.testing.assert_array_equal(got.numpy(), want)
    from aerial_image_recognition_tpu_torch.ops import assemble_mosaic
    assert assemble_mosaic is P.assemble_mosaic
