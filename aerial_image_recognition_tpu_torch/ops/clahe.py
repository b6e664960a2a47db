"""Exact CLAHE (contrast-limited adaptive histogram equalization).

Counterpart of ``aerial_image_recognition_tpu/ops/clahe.py``: the numpy
half (``clahe_gray``, ``rgb_to_lab``, ``lab_to_rgb``, ``clahe_rgb``) is a
copy; the device half is rewritten in torch for the GPU.

Algorithm: per-tile 256-bin histogram → clip at clip_limit × mean bin
height, redistribute the excess uniformly → CDF lookup table per tile →
bilinear interpolation of the four surrounding tiles' LUTs per pixel.

Device half, in the GPU's idiom:
  * histograms: one ``bincount`` over ``tile_id·256 + value`` (integer
    sums, order-free, exact);
  * LUT application, one function with two forms and one contract:
    ``_apply_luts_plain`` — the per-pixel gather in plain torch ops, for
    CPU tensors and as the reference the tests and the card's smoke hold
    the kernel against — and ``ops/clahe_kernel.apply_luts``, the
    hand-written CUDA kernel (``csrc/clahe_apply.cu``) that every CUDA
    tensor goes through, whatever the geometry.

Layout: device RGB images are NCHW, ``[B, 3, H, W]`` (the port's layout;
usually a channels_last view of an NHWC buffer); lightness planes are
``[B, H, W]`` int32.

The gray path (int in, int out) is bit-exact against the JAX package on
the CPU. The RGB path is not: torch has no ``cbrt`` (``pow(x, 1/3)``
differs by ULPs), and the rounding of L to 256 levels turns an ULP into a
whole level on the rare pixel at a .5 boundary.
"""

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch


def clahe_gray(img: np.ndarray, clip_limit: float = 2.0,
               grid: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """uint8 [H, W] → uint8 [H, W]."""
    h, w = img.shape
    gh, gw = grid
    th, tw = -(-h // gh), -(-w // gw)       # ceil tiles
    # pad to an exact tile multiple (edge-replicate, like cv2)
    pad_h, pad_w = th * gh - h, tw * gw - w
    padded = np.pad(img, ((0, pad_h), (0, pad_w)), mode="edge")

    # per-tile LUTs
    tiles = padded.reshape(gh, th, gw, tw).transpose(0, 2, 1, 3)
    luts = np.empty((gh, gw, 256), np.uint8)
    n_px = th * tw
    clip = max(1, int(clip_limit * n_px / 256.0))
    for i in range(gh):
        for j in range(gw):
            hist = np.bincount(tiles[i, j].ravel(), minlength=256)
            excess = np.maximum(hist - clip, 0).sum()
            hist = np.minimum(hist, clip) + excess // 256
            # residual excess spreads one per bin from the start (cv2-like)
            rem = int(excess % 256)
            if rem:
                hist[:rem] += 1
            cdf = np.cumsum(hist)
            cdf_min = cdf[np.nonzero(cdf)[0][0]] if cdf[-1] else 0
            denom = max(cdf[-1] - cdf_min, 1)
            luts[i, j] = np.clip(np.round(
                (cdf - cdf_min) * 255.0 / denom), 0, 255).astype(np.uint8)

    # bilinear interpolation between tile LUTs
    ys, xs = np.mgrid[0:h, 0:w]
    fy = (ys + 0.5) / th - 0.5
    fx = (xs + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, gh - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, gw - 1)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    wy = np.clip(fy - y0, 0.0, 1.0)
    wx = np.clip(fx - x0, 0.0, 1.0)

    v = img
    p00 = luts[y0, x0, v].astype(np.float32)
    p01 = luts[y0, x1, v].astype(np.float32)
    p10 = luts[y1, x0, v].astype(np.float32)
    p11 = luts[y1, x1, v].astype(np.float32)
    out = ((1 - wy) * ((1 - wx) * p00 + wx * p01)
           + wy * ((1 - wx) * p10 + wx * p11))
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------- LAB plumbing

_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float32)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)
_WHITE = np.array([0.950456, 1.0, 1.088754], np.float32)


def _f(t):
    d = 6.0 / 29.0
    return np.where(t > d**3, np.cbrt(t), t / (3 * d * d) + 4.0 / 29.0)


def _finv(t):
    d = 6.0 / 29.0
    return np.where(t > d, t**3, 3 * d * d * (t - 4.0 / 29.0))


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H,W,3] → float32 LAB (L in 0..100)."""
    x = (rgb.astype(np.float32) / 255.0) @ _RGB2XYZ.T / _WHITE
    fx = _f(x)
    L = 116.0 * fx[..., 1] - 16.0
    a = 500.0 * (fx[..., 0] - fx[..., 1])
    b = 200.0 * (fx[..., 1] - fx[..., 2])
    return np.stack([L, a, b], -1)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = fy + lab[..., 1] / 500.0
    fz = fy - lab[..., 2] / 200.0
    xyz = np.stack([_finv(fx), _finv(fy), _finv(fz)], -1) * _WHITE
    rgb = xyz @ _XYZ2RGB.T
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def clahe_rgb(img: np.ndarray, clip_limit: float = 2.0,
              grid: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """CLAHE on the LAB lightness channel of an RGB uint8 image [H,W,3] —
    the original project's TTA transform."""
    lab = rgb_to_lab(img)
    l8 = np.clip(np.round(lab[..., 0] * 255.0 / 100.0), 0, 255).astype(np.uint8)
    l8 = clahe_gray(l8, clip_limit, grid)
    lab[..., 0] = l8.astype(np.float32) * 100.0 / 255.0
    return lab_to_rgb(lab)


# ---------------------------------------------------------- device (torch)

def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """0-dim tensor beside ``x``. Dividing by it is a true IEEE division on
    every device, where dividing a CUDA tensor by a Python number becomes a
    multiplication by the reciprocal (an ULP apart from the CPU result)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _edge_pad(l8: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Edge-replicate [B,H,W] at the bottom and right (any dtype)."""
    if pad_h:
        l8 = torch.cat([l8, l8[:, -1:, :].expand(-1, pad_h, -1)], 1)
    if pad_w:
        l8 = torch.cat([l8, l8[:, :, -1:].expand(-1, -1, pad_w)], 2)
    return l8


def _tile_histograms(l8: torch.Tensor, grid, subsample: int = 1):
    """int32 [B,H,W] → (hist [B,gh,gw,256] int32, (th, tw), n_px).

    The image is edge-padded to a whole number of tiles, and every counted
    pixel adds one to bin ``tile_id·256 + value`` of a single ``bincount``.

    subsample > 1 estimates each tile's histogram from a stride-s pixel
    lattice (the clip limit scales with the counted pixel count, so the
    clip/redistribute semantics are unchanged); the LUTs then approximate
    the exact CLAHE. subsample=1 is bit-exact. The stride self-clamps so
    every tile keeps >= 1024 sampled pixels: below that the integer clip
    ``int(clip_limit·n/256)`` quantizes too coarsely and the uniform
    redistribute flattens the LUT toward a ramp.
    """
    b, h, w = l8.shape
    gh, gw = grid
    th, tw = -(-h // gh), -(-w // gw)
    while subsample > 1 and \
            (-(-th // subsample)) * (-(-tw // subsample)) < 1024:
        subsample -= 1
    padded = _edge_pad(l8, th * gh - h, tw * gw - w)
    tiles = padded.reshape(b, gh, th, gw, tw)
    if subsample > 1:
        tiles = tiles[:, :, ::subsample, :, ::subsample]
    sh, sw = tiles.shape[2], tiles.shape[4]
    tile_id = torch.arange(b * gh * gw, dtype=torch.int32,
                           device=l8.device).reshape(b, gh, gw)
    key = tile_id[:, :, None, :, None] * 256 + tiles.to(torch.int32)
    hist = torch.bincount(key.reshape(-1), minlength=b * gh * gw * 256)
    return (hist.to(torch.int32).reshape(b, gh, gw, 256), (th, tw), sh * sw)


def _luts_from_hist(hist: torch.Tensor, clip_limit: float, n_px: int):
    """[B,gh,gw,256] int32 histograms → f32 [B,gh,gw,256] LUTs (cv2's
    clip/uniform-redistribute/CDF-normalize semantics, as clahe_gray).
    The normalization multiplies by 255 and then divides, in f32, and
    rounds half to even, as the reference does."""
    clip = max(1, int(clip_limit * n_px / 256.0))
    excess = torch.clamp_min(hist - clip, 0).sum(-1, keepdim=True)
    hist = torch.clamp_max(hist, clip) + excess // 256
    rem = excess % 256
    hist = hist + (torch.arange(256, device=hist.device) < rem)
    cdf = torch.cumsum(hist, -1)
    cdf_min = torch.where(cdf > 0, cdf, 2 ** 30).amin(-1, keepdim=True)
    cdf_min = torch.where(cdf[..., -1:] > 0, cdf_min, 0)
    denom = torch.clamp_min(cdf[..., -1:] - cdf_min, 1)
    return torch.clamp(torch.round(
        (cdf - cdf_min).to(torch.float32) * 255.0
        / denom.to(torch.float32)), 0, 255)


@lru_cache(maxsize=64)
def _interp_geometry_cpu(n_img: int, tile: int, g: int):
    """Per pixel along one axis, on the CPU: the lower tile index i0
    (int64), the fractional bilinear weight toward the next tile (f32), and
    starts (int32 [g+1]): pixels starts[k]..starts[k+1] have i0 == k.

    Computed in f32 with a true division, once per geometry and always on
    the CPU, so that the card and the CPU see the same bits.
    """
    f = (torch.arange(n_img, dtype=torch.float32) + 0.5) / tile - 0.5
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, g - 1)
    wt = torch.clamp(f - i0.to(torch.float32), 0.0, 1.0)
    starts = torch.searchsorted(i0, torch.arange(g + 1, dtype=torch.int64))
    return i0, wt, starts.to(torch.int32)


_geometry_on_device = {}


def _interp_geometry(n_img: int, tile: int, g: int, device: torch.device):
    """``_interp_geometry_cpu`` uploaded to ``device`` (cached)."""
    device = torch.device(device)
    if device.type == "cpu":
        return _interp_geometry_cpu(n_img, tile, g)
    key = (n_img, tile, g, device)
    if key not in _geometry_on_device:
        _geometry_on_device[key] = tuple(
            t.to(device) for t in _interp_geometry_cpu(n_img, tile, g))
    return _geometry_on_device[key]


def _interp_weights_1d(n_img: int, tile: int, g: int,
                       device="cpu") -> torch.Tensor:
    """Fractional bilinear weight toward the i1 (next) tile per pixel."""
    return _interp_geometry(n_img, tile, g, device)[1]


def _apply_luts_plain(luts: torch.Tensor, l8: torch.Tensor, gh: int, gw: int,
                      th: int, tw: int) -> torch.Tensor:
    """LUT application in plain torch ops — the plain version of the CUDA
    kernel: [B,gh,gw,V,256] f32 LUTs × [B,H,W] int32 → [V,B,H,W] f32
    (before rounding), any geometry.

    Per pixel, gather the LUT entry of its value in the four surrounding
    tiles and blend as (1−wy)·((1−wx)·p00 + wx·p01) + wy·((1−wx)·p10 +
    wx·p11), one rounding per operation, in exactly that nesting.
    """
    b, h, w = l8.shape
    dev = l8.device
    y0, wy, _ = _interp_geometry(h, th, gh, dev)
    x0, wx, _ = _interp_geometry(w, tw, gw, dev)
    y1 = torch.clamp_max(y0 + 1, gh - 1)
    x1 = torch.clamp_max(x0 + 1, gw - 1)
    wy, wx = wy[:, None], wx[None, :]
    bi = torch.arange(b, device=dev)[:, None, None]
    v = l8.long()
    y0, y1 = y0[None, :, None], y1[None, :, None]
    x0, x1 = x0[None, None, :], x1[None, None, :]
    outs = []
    for vv in range(luts.shape[3]):
        lv = luts[:, :, :, vv]
        p00, p01 = lv[bi, y0, x0, v], lv[bi, y0, x1, v]
        p10, p11 = lv[bi, y1, x0, v], lv[bi, y1, x1, v]
        outs.append((1 - wy) * ((1 - wx) * p00 + wx * p01)
                    + wy * ((1 - wx) * p10 + wx * p11))
    return torch.stack(outs)


def clahe_gray_device(l8: torch.Tensor, clip_limit: float = 2.0,
                      grid: Tuple[int, int] = (8, 8),
                      hist_subsample: int = 1):
    """int32 [B, H, W] values 0..255 → int32 [B, H, W], batched CLAHE.

    Bit-faithful to clahe_gray (same padding, clip/redistribution, CDF
    normalization and LUT interpolation) at the default hist_subsample=1;
    >1 estimates the per-tile histograms from a stride-s lattice (see
    _tile_histograms)."""
    return clahe_gray_device_multi(l8, [clip_limit], grid,
                                   hist_subsample=hist_subsample)[0]


def clahe_gray_device_multi(l8: torch.Tensor, clip_limits: Sequence[float],
                            grid=(8, 8), *,
                            hist_subsample: int = 1) -> torch.Tensor:
    """int32 [B,H,W] × V clip limits → int32 [V,B,H,W] in one pass.

    Only the clip/redistribute step depends on the clip value, so the
    histograms are shared across V and one LUT application serves all V
    (one kernel launch on the card). Bit-identical to V separate
    clahe_gray_device calls. The LUT application is the CUDA kernel for
    CUDA tensors and the plain version for CPU tensors.
    """
    from aerial_image_recognition_tpu_torch.ops.clahe_kernel import (
        apply_luts)
    gh, gw = grid
    hist, (th, tw), n_px = _tile_histograms(l8, grid, hist_subsample)
    luts = torch.stack([_luts_from_hist(hist, c, n_px)
                        for c in clip_limits], dim=3)    # [B,gh,gw,V,256]
    out = apply_luts(luts, l8, gh, gw, th, tw)
    return torch.clamp(torch.round(out), 0, 255).to(torch.int32)


def _lab_forward_device(rgb: torch.Tensor):
    """f32 [B,3,H,W] RGB 0..1 → (L, a, b) planes [B,H,W] (mirrors
    rgb_to_lab). The 3×3 colour matrix is written out as multiply-adds: a
    library GEMM could run it in reduced precision on the card, or sum in
    another order, and L is rounded to 256 levels right after."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    d = 6.0 / 29.0
    fxyz = []
    for row, white in zip(_RGB2XYZ.tolist(), _WHITE.tolist()):
        t = (r * row[0] + g * row[1] + b * row[2]) / _const(r, white)
        fxyz.append(torch.where(
            t > d**3, t.pow(1.0 / 3.0),
            t / _const(r, 3 * d * d) + 4.0 / 29.0))
    L = 116.0 * fxyz[1] - 16.0
    a = 500.0 * (fxyz[0] - fxyz[1])
    bb = 200.0 * (fxyz[1] - fxyz[2])
    return L, a, bb


def _lab_inverse_device(L2: torch.Tensor, a: torch.Tensor, bb: torch.Tensor):
    """(L, a, b) planes [..., H, W] → f32 [..., 3, H, W] RGB 0..1 (mirrors
    lab_to_rgb), the channel axis third from last. Written as NHWC in
    memory, so the result is a channels_last view like the step's input."""
    d = 6.0 / 29.0
    fy = (L2 + 16.0) / _const(L2, 116.0)
    fx2 = fy + a / _const(L2, 500.0)
    fz = fy - bb / _const(L2, 200.0)
    xyz2 = [torch.where(f > d, f * f * f, 3 * d * d * (f - 4.0 / 29.0)) * wh
            for f, wh in zip((fx2, fy, fz), _WHITE.tolist())]
    out = torch.stack(
        [xyz2[0] * row[0] + xyz2[1] * row[1] + xyz2[2] * row[2]
         for row in _XYZ2RGB.tolist()], dim=-1)
    return torch.clamp(out, 0.0, 1.0).movedim(-1, -3)


def _lightness_levels(x: torch.Tensor):
    """[B,3,H,W] float → (l8 int32 [B,H,W], a, b): LAB with L on 256
    levels."""
    L, a, bb = _lab_forward_device(x.to(torch.float32))
    l8 = torch.clamp(torch.round(L * 255.0 / _const(L, 100.0)), 0, 255)
    return l8.to(torch.int32), a, bb


def clahe_rgb_device(x: torch.Tensor, clip_limit: float = 2.0,
                     grid: Tuple[int, int] = (8, 8),
                     hist_subsample: int = 1):
    """float [B,3,H,W] in 0..1 → float [B,3,H,W]: exact CLAHE on the LAB
    lightness channel (device mirror of clahe_rgb, for the TTA stack).
    Computed in f32 and cast back to ``x.dtype``."""
    return clahe_rgb_device_multi(x, [clip_limit], grid,
                                  hist_subsample=hist_subsample)[0]


def clahe_rgb_device_multi(x: torch.Tensor, clip_limits: Sequence[float],
                           grid=(8, 8), *,
                           hist_subsample: int = 1) -> torch.Tensor:
    """float [B,3,H,W] × V clip limits → float [V,B,3,H,W] in one pass.

    Shares the LAB forward transform, the per-tile histograms and the LUT
    application (one kernel launch) across the V clip parameterizations
    (the TTA ladder's 3 clahe_* variations); per-image results are
    bit-identical to V separate clahe_rgb_device calls."""
    l8, a, bb = _lightness_levels(x)
    l8v = clahe_gray_device_multi(
        l8, clip_limits, grid, hist_subsample=hist_subsample)  # [V,B,H,W]
    L2 = l8v.to(torch.float32) * 100.0 / _const(a, 255.0)
    return _lab_inverse_device(L2, a[None], bb[None]).to(x.dtype)
