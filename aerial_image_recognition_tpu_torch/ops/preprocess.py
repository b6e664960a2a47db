"""On-device preprocessing of uint8 tile batches: crop → resize → normalize.

Counterpart of ``aerial_image_recognition_tpu/ops/preprocess.py``
(``_resize_matrix``, ``_separable_resize_core``, ``_matmul_resize``,
``matmul_resize_float``, ``preprocess_batch``, ``assemble_mosaic``) and of
the ``jax.image.resize`` it calls (``resize``): uint8 crosses the bus (a
quarter of f32's bytes) and the crop, the resize and the /255 run on the
device. Inputs are NHWC uint8 ``[B,H,W,3]``; everything float is NCHW
``[B,3,H,W]``.

The linear methods are separable, so a resize is two matrix products with
the exact 1-D weight matrices of ``jax.image.resize`` (recomputed here in
numpy); nearest is a gather at the reference's indices (also computed on
the host). Both are plain tensor operations outside any hand-written
kernel: the reference computes them outside any Pallas kernel too.
"""

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def _triangle_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _lanczos_kernel(radius: float):
    def kernel(x: np.ndarray) -> np.ndarray:
        r = np.float32(radius)
        pi = np.float32(np.pi)
        y = r * np.sin(pi * x) * np.sin(pi * x / r)
        denom = np.where(x != 0, np.float32(np.pi ** 2) * x * x,
                         np.float32(1))
        out = np.where(x > np.float32(1e-3), y / denom, np.float32(1))
        return np.where(x > r, np.float32(0), out).astype(np.float32)
    return kernel


def _keys_cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = −0.5."""
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1)
    out = np.where(x >= f(1), ((f(-0.5) * x + f(2.5)) * x - f(4)) * x + f(2),
                   out)
    return np.where(x >= f(2), f(0), out).astype(np.float32)


# jax.image.ResizeMethod.from_string's names → the method they denote
_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
            "trilinear": "linear", "triangle": "linear",
            "lanczos3": "lanczos3", "lanczos5": "lanczos5",
            "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic"}
_KERNELS = {"linear": _triangle_kernel, "lanczos3": _lanczos_kernel(3.0),
            "lanczos5": _lanczos_kernel(5.0), "cubic": _keys_cubic_kernel}
# the methods the matrix path takes (the reference's strings, exactly)
_MATMUL_METHODS = ("bilinear", "lanczos3")


def _method(name: str) -> str:
    """A method name as ``jax.image.ResizeMethod.from_string`` reads it;
    ValueError for any other name, as there."""
    if name not in _METHODS:
        raise ValueError(f'Unknown resize method "{name}"')
    return _METHODS[name]


@lru_cache(maxsize=32)
def _resize_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """1-D interpolation matrix [dst, src] f32 of ``jax.image.resize``.

    What resizing the identity along one axis gives there: sample positions
    ``(i + 0.5)/scale − 0.5``, the triangle (linear), Keys cubic or lanczos
    3/5 kernel widened by ``max(1/scale, 1)`` (antialiasing on downscale
    only), each output's weights normalized to sum 1, and zero for samples
    outside ``[−0.5, src − 0.5]``. Computed in numpy f32 in the same
    operation order; the two-matrix product Ry · X · Rxᵀ is then that
    resize. Nearest has no such matrix (ValueError).
    """
    kind = _method(method)
    if kind not in _KERNELS:
        raise ValueError(f"no resize matrix for method {method!r} "
                         f"(expected one of {sorted(_METHODS)} but nearest)")
    inv_scale = 1.0 / (dst / src)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(dst, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(src, dtype=np.float32)[:, None]) / kernel_scale
    weights = _KERNELS[kind](x)                              # [src, dst]
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > np.float32(1000.0 * _F32_EPS),
                       weights / np.where(total != 0, total, np.float32(1)),
                       np.float32(0))
    inside = (sample_f >= np.float32(-0.5)) \
        & (sample_f <= np.float32(src - 0.5))
    m = np.where(inside[None, :], weights, np.float32(0)).T
    return np.ascontiguousarray(m, dtype=np.float32)


_on_device = {}


def _device_matrix(src: int, dst: int, method: str, scale: Optional[float],
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``_resize_matrix`` (times ``scale``, in f32) as a ``dtype`` tensor on
    ``device``, uploaded once."""
    key = (src, dst, method, scale, dtype, device)
    if key not in _on_device:
        m = _resize_matrix(src, dst, method)
        if scale is not None:
            m = m * np.float32(scale)
        _on_device[key] = torch.from_numpy(m).to(device, dtype)
    return _on_device[key]


def _refuse_tf32(x: torch.Tensor) -> None:
    """An f32 resize on the card runs only at full f32 precision."""
    if x.device.type == "cuda" \
            and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the f32 resize needs torch.set_float32_matmul_precision("
            "'highest'): TF32 would round the operands to 10 bits")


def _separable_resize_core(x: torch.Tensor, out_size: int, method: str,
                           out_dtype: torch.dtype, *,
                           scale: Optional[float],
                           compute_dtype: torch.dtype) -> torch.Tensor:
    """[B,C,H,W] → [B,C,out,out]: height then width contraction.

    Rounding points are the reference's: the input and both matrices are
    cast to ``compute_dtype``, each product accumulates in f32, the
    intermediate is rounded to ``compute_dtype`` and the result to
    ``out_dtype``. ``scale`` (if given) is folded into the height matrix in
    f32 before the cast — the weights of a row sum to 1, so e.g. the /255
    normalization costs nothing.
    """
    h, w = x.shape[-2:]
    ry = _device_matrix(h, out_size, method, scale, compute_dtype, x.device)
    rx = _device_matrix(w, out_size, method, None, compute_dtype, x.device)
    if compute_dtype == torch.float32:
        _refuse_tf32(x)
    y = torch.matmul(ry, x.to(compute_dtype))               # [B,C,out,W]
    if out_dtype != compute_dtype:
        # the last product keeps its f32 sums: low-precision operands are
        # exact in f32, so this is the same contraction, rounded once
        y, rx = y.to(torch.float32), rx.to(torch.float32)
    return torch.matmul(y, rx.T).to(out_dtype)               # [B,C,out,out]


def _matmul_resize(x_u8: torch.Tensor, out_size: int, method: str,
                   dtype: torch.dtype) -> torch.Tensor:
    """uint8 [B,H,W,C] → normalized [B,C,out,out] via two bf16 matrix
    products: pixels stay exact in bf16 (integers ≤ 255 fit its 8-bit
    mantissa), both contractions accumulate in f32, and /255 is folded into
    the height matrix."""
    return _separable_resize_core(x_u8.permute(0, 3, 1, 2), out_size, method,
                                  dtype, scale=1.0 / 255.0,
                                  compute_dtype=torch.bfloat16)


def matmul_resize_float(x: torch.Tensor, out_size: int,
                        method: str = "bilinear") -> torch.Tensor:
    """float [B,C,H,W] → [B,C,out,out] via two separable matrix products.

    The already-normalized-input sibling of ``_matmul_resize`` (no /255
    fold), result in ``x.dtype``; the multiscale mode rescales the
    preprocessed tiles with it. bf16 inputs contract in bf16; f32 inputs
    keep their full precision and contract in f32.
    """
    compute = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    return _separable_resize_core(x, out_size, method, x.dtype, scale=None,
                                  compute_dtype=compute)


@lru_cache(maxsize=32)
def _nearest_index(src: int, dst: int) -> np.ndarray:
    """The source index of each of ``dst`` outputs in ``jax.image.resize``'s
    nearest method: ``floor((i + 0.5)·src/dst)`` in f32, evaluated as XLA
    compiles it, ``(i + 0.5) · (src · (1/dst))`` — it folds the constants
    (``(a·src)/dst`` → ``a·(src·(1/dst))``), which moves an index on exact
    quotients (34 → 31 px: output 15 reads 16, not 17)."""
    f = np.float32
    ratio = f(src) * (f(1) / f(dst))
    a = np.arange(dst, dtype=np.float32) + f(0.5)
    return np.floor(a * ratio).astype(np.int64)


def _index_on(src: int, dst: int, device: torch.device) -> torch.Tensor:
    key = ("nearest", src, dst, device)
    if key not in _on_device:
        _on_device[key] = torch.from_numpy(
            _nearest_index(src, dst)).to(device)
    return _on_device[key]


def _resize_nearest(x: torch.Tensor, out_size: int, dims=(2, 3)):
    """Gather ``x`` at the nearest indices along ``dims`` (the two spatial
    axes), those already at ``out_size`` left as they are."""
    for d in dims:
        if x.shape[d] != out_size:
            x = x.index_select(d, _index_on(x.shape[d], out_size, x.device))
    return x


def resize(x: torch.Tensor, out_size: int, method: str) -> torch.Tensor:
    """float [B,C,H,W] → [B,C,out,out] in ``x.dtype``: the counterpart of
    ``jax.image.resize(x_nhwc, (B, out, out, C), method)`` (antialiased,
    half-pixel centres).

    ``method`` takes ``jax.image.ResizeMethod.from_string``'s names
    (ValueError for others). Nearest gathers at the reference's indices.
    The linear methods contract height, then width, as the reference's
    einsum does: its weights cast to ``x.dtype``, each product summed in
    f32 and rounded to ``x.dtype`` (full f32 for f32, the reference's
    ``Precision.HIGHEST``: on the card it refuses unless
    ``torch.get_float32_matmul_precision()`` is "highest"). An axis already
    at ``out_size`` is left as it is, as there. This is not the matrix path
    (``matmul_resize_float``): same weights, but no bf16 contraction of an
    f32 input.
    """
    kind = _method(method)
    if kind == "nearest":
        return _resize_nearest(x, out_size)
    if x.dtype == torch.float32:
        _refuse_tf32(x)
    h, w = x.shape[-2:]
    if h != out_size:
        x = torch.matmul(_device_matrix(h, out_size, method, None, x.dtype,
                                        x.device), x)            # [B,C,out,W]
    if w != out_size:
        x = torch.matmul(x, _device_matrix(w, out_size, method, None,
                                           x.dtype, x.device).T)
    return x


def preprocess_batch(images: torch.Tensor, *, out_size: int = 640,
                     crop_size: Optional[int] = None,
                     method: str = "bilinear",
                     dtype: torch.dtype = torch.bfloat16,
                     matmul: bool = True) -> torch.Tensor:
    """uint8 [B,H,W,3] (NHWC) → normalized [B,3,out_size,out_size] in
    ``dtype``.

    crop_size: optional center-crop (in source pixels) before the resize —
    the XYZ path's 1024→864 center crop. method: any name of
    ``jax.image.resize`` ('bilinear', 'nearest', 'lanczos3', 'cubic', …;
    ValueError for others, where a resize is needed).

    At the native size the result is the NHWC buffer seen as NCHW, i.e.
    channels_last memory — the layout cuDNN's fast convolutions want — with
    no copy for the relayout itself. Other sizes dispatch as the reference
    does: ``matmul`` with 'bilinear' or 'lanczos3' resizes by two bf16
    matrix products (``_matmul_resize``); everything else is the
    reference's ``jax.image.resize`` lowering (``resize``) in f32 on x/255
    — except nearest, which gathers the uint8 pixels first (the same
    values, a quarter of the bytes) and normalizes after.
    """
    x = images
    b, h, w, c = x.shape
    if crop_size is not None and (crop_size != h or crop_size != w):
        oy = (h - crop_size) // 2
        ox = (w - crop_size) // 2
        x = x[:, oy:oy + crop_size, ox:ox + crop_size, :]
        b, h, w, c = x.shape
    if (h, w) == (out_size, out_size):
        return _normalize(x.permute(0, 3, 1, 2), dtype)
    if matmul and method in _MATMUL_METHODS:
        return _matmul_resize(x, out_size, method, dtype)
    if _method(method) == "nearest":
        return _normalize(_resize_nearest(x, out_size, dims=(1, 2))
                          .permute(0, 3, 1, 2), dtype)
    x = _normalize(x.permute(0, 3, 1, 2), torch.float32)
    return resize(x, out_size, method).to(dtype)


def _normalize(x_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 → x/255 in f32, then ``dtype``. A 0-dim divisor keeps this a
    true division on the card, where a Python number would turn it into a
    multiplication by 1/255."""
    x = x_u8.to(torch.float32)
    return (x / torch.full((), 255.0, device=x.device)).to(dtype)


def assemble_mosaic(tiles: torch.Tensor, *, grid: Tuple[int, int],
                    tile_px: int = 256) -> torch.Tensor:
    """uint8 [B, gy·gx, t, t, 3] → [B, gy·t, gx·t, 3] mosaics where the
    tiles lie (the input layout of ``preprocess_batch``): a reshape and a
    transpose, one copy."""
    gy, gx = grid
    b, n, t, _, c = tiles.shape
    assert n == gy * gx and t == tile_px
    x = tiles.reshape(b, gy, gx, t, t, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gy * t, gx * t, c)
