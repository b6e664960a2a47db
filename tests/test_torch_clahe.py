"""The port's CLAHE against the JAX package, stage by stage.

The same numpy inputs go through both. On the CPU the port applies the LUTs
with its plain version (``_apply_luts_plain``), the contract the CUDA
kernel is held to on the card.

Tolerances:
  * gray path (int in, int out) — histograms, LUTs, the apply stage (raw
    f32, against the reference's gather formulation) and the rounded
    levels: bit-exact, at 128 px (dyadic blend weights), 384 px
    (non-dyadic) and 50×46 (ragged tiles), 1 and 3 clip limits, histogram
    subsampling 1 and 2;
  * against the Pallas kernel in interpret mode, and against
    ``clahe_gray_device_multi`` where the reference takes its blocked XLA
    lowering: raw bits at 128 px; at 384 px the reference's own lowerings
    differ from each other by an f32 ULP before rounding (XLA may fuse
    multiply-adds), so the bound there is the reference tests' own: ≤ 1
    level on < 5e-4 of the pixels;
  * RGB path: torch has no cbrt, so L may differ by an ULP before it is
    rounded to 256 levels: ``l8`` equal except ≤ 1 level on < 1e-3 of the
    pixels, RGB output within 2/255 max and 1e-4 mean.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_image_recognition_tpu.ops import clahe as J
from aerial_image_recognition_tpu.ops.clahe_pallas import (
    apply_luts_pallas, supports_geometry)
from aerial_image_recognition_tpu_torch.ops import clahe as P
from aerial_image_recognition_tpu_torch.ops.clahe_kernel import apply_luts

torch.set_num_threads(2)        # xdist workers share the cores

GRID = (8, 8)
SHAPES = {"128-dyadic": (128, 128), "384-nondyadic": (384, 384),
          "50x46-ragged": (50, 46)}
CLIPS = {"v1": [2.0], "v3": [2.0, 3.0, 4.0]}


def _levels(name, batch=2):
    """Smooth structure plus noise, so that histograms clip and LUTs
    differ between tiles."""
    h, w = SHAPES[name]
    rng = np.random.default_rng(sorted(SHAPES).index(name))
    yy, xx = np.mgrid[0:h, 0:w]
    base = 110 + 70 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
    img = base[None] + rng.normal(0, 25, (batch, h, w))
    img[:, : h // 3, : w // 4] = 17              # a flat, fully clipped tile
    return np.clip(np.round(img), 0, 255).astype(np.int32)


def _both_luts(l8, clips, sub):
    jh, (th, tw), n_px = J._tile_histograms(jnp.asarray(l8), GRID, sub)
    ph, (pth, ptw), pn = P._tile_histograms(torch.from_numpy(l8), GRID, sub)
    assert (th, tw, n_px) == (pth, ptw, pn)
    jl = jnp.stack([J._luts_from_hist(jh, c, n_px) for c in clips], axis=3)
    pl = torch.stack([P._luts_from_hist(ph, c, pn) for c in clips], dim=3)
    return (jh, jl), (ph, pl), (th, tw)


@pytest.mark.parametrize("sub", [1, 2])
@pytest.mark.parametrize("clips", sorted(CLIPS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_histograms_and_luts_bit_exact(shape, clips, sub):
    l8 = _levels(shape)
    (jh, jl), (ph, pl), _ = _both_luts(l8, CLIPS[clips], sub)
    assert ph.dtype == torch.int32 and pl.dtype == torch.float32
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    assert float(pl.min()) >= 0 and float(pl.max()) <= 255
    assert len(np.unique(pl.numpy())) > 32         # real LUTs, not a ramp


@pytest.mark.parametrize("clips", sorted(CLIPS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_apply_stage_bit_exact(shape, clips):
    l8 = _levels(shape)
    (_, jl), (_, pl), (th, tw) = _both_luts(l8, CLIPS[clips], 1)
    got = P._apply_luts_plain(pl, torch.from_numpy(l8), 8, 8, th, tw)
    assert got.dtype == torch.float32 \
        and tuple(got.shape) == (len(CLIPS[clips]),) + l8.shape
    want = np.stack([np.asarray(J._apply_luts_gather(
        jl[:, :, :, v], jnp.asarray(l8), 8, 8, th, tw))
        for v in range(len(CLIPS[clips]))])
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors, and only then
    assert torch.equal(apply_luts(pl, torch.from_numpy(l8), 8, 8, th, tw),
                       got)
    np.testing.assert_array_equal(
        P._interp_weights_1d(l8.shape[1], th, 8).numpy(),
        np.asarray(J._interp_weights_1d(l8.shape[1], th, 8)))


def _assert_levels_close(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    lev = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert lev.max() <= 1
    assert (lev > 0).mean() < 5e-4


@pytest.mark.parametrize("clips", sorted(CLIPS))
@pytest.mark.parametrize("shape", ["128-dyadic", "384-nondyadic"])
def test_apply_stage_matches_pallas_kernel_in_interpret_mode(shape, clips):
    l8 = _levels(shape)
    assert supports_geometry(*SHAPES[shape], 8, 8)
    (_, jl), (_, pl), (th, tw) = _both_luts(l8, CLIPS[clips], 1)
    want = np.asarray(apply_luts_pallas(jl, jnp.asarray(l8), 8, 8, th, tw,
                                        interpret=True))
    got = P._apply_luts_plain(pl, torch.from_numpy(l8), 8, 8, th, tw).numpy()
    if shape == "128-dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() < 1e-4     # a few ULPs at 255-scale
    _assert_levels_close(np.clip(np.round(got), 0, 255),
                         np.clip(np.round(want), 0, 255),
                         exact=shape == "128-dyadic")


@pytest.mark.parametrize("sub", [1, 2])
@pytest.mark.parametrize("clips", sorted(CLIPS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gray_device_multi_matches_jax(shape, clips, sub):
    l8 = _levels(shape)
    got = P.clahe_gray_device_multi(torch.from_numpy(l8), CLIPS[clips],
                                    hist_subsample=sub)
    assert got.dtype == torch.int32
    want = np.asarray(J.clahe_gray_device_multi(
        jnp.asarray(l8), CLIPS[clips], hist_subsample=sub))
    # 384 px goes through the reference's blocked XLA lowering (see the
    # module docstring); the other two are bit-exact
    _assert_levels_close(got.numpy(), want, exact=shape != "384-nondyadic")
    # V-fold equals V single calls
    for v, c in enumerate(CLIPS[clips]):
        single = P.clahe_gray_device(torch.from_numpy(l8), c,
                                     hist_subsample=sub)
        assert torch.equal(single, got[v])
    assert (got.numpy() != l8[None]).mean() > 0.5   # it did equalize


def test_foreign_device_raises():
    l8 = torch.zeros((1, 16, 16), dtype=torch.int32)
    luts = torch.zeros((1, 8, 8, 1, 256))
    with pytest.raises(ValueError, match="no kernel for meta"):
        apply_luts(luts.to("meta"), l8.to("meta"), 8, 8, 2, 2)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_numpy_copies_equal_the_originals(shape):
    h, w = SHAPES[shape]
    gray = _levels(shape, batch=1)[0].astype(np.uint8)
    rng = np.random.default_rng(5)
    rgb = np.clip(gray[..., None] + rng.integers(-20, 20, (h, w, 3)),
                  0, 255).astype(np.uint8)
    for clip in (2.0, 4.0):
        np.testing.assert_array_equal(P.clahe_gray(gray, clip),
                                      J.clahe_gray(gray, clip))
        np.testing.assert_array_equal(P.clahe_rgb(rgb, clip),
                                      J.clahe_rgb(rgb, clip))
    np.testing.assert_array_equal(P.rgb_to_lab(rgb), J.rgb_to_lab(rgb))
    np.testing.assert_array_equal(P.lab_to_rgb(J.rgb_to_lab(rgb)),
                                  J.lab_to_rgb(J.rgb_to_lab(rgb)))


def test_gray_device_matches_numpy_clahe_gray():
    """The device path against the numpy algorithm (f64 blend weights
    there, f32 here): equal levels but for a rare .5 boundary."""
    l8 = _levels("128-dyadic")
    got = P.clahe_gray_device(torch.from_numpy(l8), 3.0).numpy()
    for k in range(l8.shape[0]):
        want = P.clahe_gray(l8[k].astype(np.uint8), 3.0)
        _assert_levels_close(got[k], want.astype(np.int32), exact=False)


def _rgb_batch(h, w, seed, batch=2):
    rng = np.random.default_rng(seed)
    gray = _levels("128-dyadic", batch)[:, :h, :w, None] / 255.0
    x = np.clip(gray + rng.uniform(-0.15, 0.15, (batch, h, w, 3)), 0, 1)
    return x.astype(np.float32)


@pytest.mark.parametrize("clips", sorted(CLIPS))
def test_rgb_path_within_tolerance(clips):
    x = _rgb_batch(128, 128, 1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)         # NCHW view
    jl8 = np.asarray(jnp.clip(jnp.round(
        J._lab_forward_device(jnp.asarray(x))[0] * 255.0 / 100.0), 0, 255))
    pl8 = P._lightness_levels(xt)[0].numpy()
    lev = np.abs(pl8 - jl8)
    assert lev.max() <= 1 and (lev > 0).mean() < 1e-3
    want = np.asarray(J.clahe_rgb_device_multi(jnp.asarray(x), CLIPS[clips]))
    got = P.clahe_rgb_device_multi(xt, CLIPS[clips])
    assert tuple(got.shape) == (len(CLIPS[clips]), 2, 3, 128, 128)
    got = got.permute(0, 1, 3, 4, 2).numpy()
    err = np.abs(got - want)
    assert err.max() <= 2 / 255 and err.mean() <= 1e-4
    single = P.clahe_rgb_device(xt, CLIPS[clips][-1])
    assert torch.equal(single.permute(0, 2, 3, 1),
                       torch.from_numpy(got[-1]))
    # bf16 in, bf16 out: computed in f32 and cast back
    got16 = P.clahe_rgb_device(xt.to(torch.bfloat16), CLIPS[clips][0])
    want16 = np.asarray(J.clahe_rgb_device(
        jnp.asarray(x, jnp.bfloat16), CLIPS[clips][0]).astype(jnp.float32))
    assert got16.dtype == torch.bfloat16
    err16 = np.abs(got16.float().permute(0, 2, 3, 1).numpy() - want16)
    assert err16.max() <= 2 / 255 + 1 / 128 and err16.mean() <= 1e-3
