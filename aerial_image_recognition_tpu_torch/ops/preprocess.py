"""On-device preprocessing of uint8 tile batches: crop → resize → normalize.

Counterpart of ``aerial_image_recognition_tpu/ops/preprocess.py``
(``_resize_matrix``, ``_separable_resize_core``, ``_matmul_resize``,
``matmul_resize_float``, ``preprocess_batch``): uint8 crosses the bus (a
quarter of f32's bytes) and the crop, the resize and the /255 run on the
device. Inputs are NHWC uint8 ``[B,H,W,3]``; everything float is NCHW
``[B,3,H,W]``.

The resize is separable and linear, so it is two matrix products with the
exact 1-D weight matrices of ``jax.image.resize`` (recomputed here in
numpy). They are plain matrix products outside any hand-written kernel and
go to ``torch.matmul``.
"""

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def _triangle_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _lanczos3_kernel(x: np.ndarray) -> np.ndarray:
    radius = np.float32(3.0)
    pi = np.float32(np.pi)
    y = radius * np.sin(pi * x) * np.sin(pi * x / radius)
    denom = np.where(x != 0, np.float32(np.pi ** 2) * x * x, np.float32(1))
    out = np.where(x > np.float32(1e-3), y / denom, np.float32(1))
    return np.where(x > radius, np.float32(0), out).astype(np.float32)


_KERNELS = {"bilinear": _triangle_kernel, "lanczos3": _lanczos3_kernel}


@lru_cache(maxsize=32)
def _resize_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """1-D interpolation matrix [dst, src] f32 of ``jax.image.resize``.

    What resizing the identity along one axis gives there: sample positions
    ``(i + 0.5)/scale − 0.5``, the triangle (bilinear) or lanczos3 kernel
    widened by ``max(1/scale, 1)`` (antialiasing on downscale only), each
    output's weights normalized to sum 1, and zero for samples outside
    ``[−0.5, src − 0.5]``. Computed in numpy f32 in the same operation
    order; the two-matrix product Ry · X · Rxᵀ is then that resize.
    """
    if method not in _KERNELS:
        raise ValueError(f"no resize matrix for method {method!r} "
                         f"(expected one of {sorted(_KERNELS)})")
    inv_scale = 1.0 / (dst / src)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(dst, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(src, dtype=np.float32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x)                            # [src, dst]
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > np.float32(1000.0 * _F32_EPS),
                       weights / np.where(total != 0, total, np.float32(1)),
                       np.float32(0))
    inside = (sample_f >= np.float32(-0.5)) \
        & (sample_f <= np.float32(src - 0.5))
    m = np.where(inside[None, :], weights, np.float32(0)).T
    return np.ascontiguousarray(m, dtype=np.float32)


_matrices_on_device = {}


def _device_matrix(src: int, dst: int, method: str, scale: Optional[float],
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``_resize_matrix`` (times ``scale``, in f32) as a ``dtype`` tensor on
    ``device``, uploaded once."""
    key = (src, dst, method, scale, dtype, device)
    if key not in _matrices_on_device:
        m = _resize_matrix(src, dst, method)
        if scale is not None:
            m = m * np.float32(scale)
        _matrices_on_device[key] = torch.from_numpy(m).to(device, dtype)
    return _matrices_on_device[key]


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
    if compute_dtype == torch.float32 and x.device.type == "cuda" \
            and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the f32 resize needs torch.set_float32_matmul_precision("
            "'highest'): TF32 would round the operands to 10 bits")
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


def preprocess_batch(images: torch.Tensor, *, out_size: int = 640,
                     crop_size: Optional[int] = None,
                     method: str = "bilinear",
                     dtype: torch.dtype = torch.bfloat16,
                     matmul: bool = True) -> torch.Tensor:
    """uint8 [B,H,W,3] (NHWC) → normalized [B,3,out_size,out_size] in
    ``dtype``.

    crop_size: optional center-crop (in source pixels) before the resize —
    the XYZ path's 1024→864 center crop. method: 'bilinear' | 'lanczos3'.

    At the native size the result is the NHWC buffer seen as NCHW, i.e.
    channels_last memory — the layout cuDNN's fast convolutions want — with
    no copy for the relayout itself. Other sizes resize by two matrix
    products (``_matmul_resize``). ``method='nearest'`` and the
    non-matrix lowering (``matmul=False``) are not ported and raise.
    """
    x = images
    b, h, w, c = x.shape
    if crop_size is not None and (crop_size != h or crop_size != w):
        oy = (h - crop_size) // 2
        ox = (w - crop_size) // 2
        x = x[:, oy:oy + crop_size, ox:ox + crop_size, :]
        b, h, w, c = x.shape
    if (h, w) == (out_size, out_size):
        # a 0-dim divisor keeps this a true division on the card, where a
        # Python number would turn it into a multiplication by 1/255
        x = x.permute(0, 3, 1, 2).to(torch.float32)
        return (x / torch.full((), 255.0, device=x.device)).to(dtype)
    if not matmul or method not in _KERNELS:
        raise NotImplementedError(
            f"resize with method={method!r}, matmul={matmul} is not ported: "
            "the port resizes by matrix products, bilinear or lanczos3")
    return _matmul_resize(x, out_size, method, dtype)
