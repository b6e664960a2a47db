"""Wrapper of the CUDA CLAHE LUT-apply kernel (``csrc/clahe_apply.cu``).

Replaces the Pallas TPU kernel
``aerial_image_recognition_tpu/ops/clahe_pallas.py:apply_luts_pallas``.
On a CUDA tensor ``apply_luts`` launches the kernel on the current stream
or raises, for every geometry (ragged tiles included: there is no geometry
guard and no fallback from the card to the plain version); on a CPU tensor
it runs the plain version, ``ops/clahe._apply_luts_plain``, which gives the
same f32 values bit for bit.

``apply_luts.launches`` counts kernel launches (not plain-version calls),
so a run can show that its path went through the kernel.
"""

import ctypes

import torch

from aerial_image_recognition_tpu_torch.kernels.args import (
    check_tensor, device_index)

MAX_V = 56          # V·256 float4 of shared memory; a block has 227 KB


def _lib():
    from aerial_image_recognition_tpu_torch.kernels.build import load
    fn = load("clahe_apply").clahe_apply_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def apply_luts(luts: torch.Tensor, l8: torch.Tensor, gh: int, gw: int,
               th: int, tw: int) -> torch.Tensor:
    """LUTs [B,gh,gw,V,256] f32 (integers 0..255) × pixels [B,H,W] int32
    (0..255) → [V,B,H,W] f32, the bilinear blend of the four surrounding
    tiles' LUT entries per pixel, before rounding. th, tw: tile height and
    width in pixels (``ceil(H/gh)``, ``ceil(W/gw)``)."""
    from aerial_image_recognition_tpu_torch.ops.clahe import (
        _apply_luts_plain, _interp_geometry)
    if l8.device.type == "cpu":
        return _apply_luts_plain(luts, l8, gh, gw, th, tw)
    if l8.device.type != "cuda":
        raise ValueError(f"apply_luts: no kernel for {l8.device}")
    if l8.dim() != 3 or luts.dim() != 5:
        raise ValueError(f"apply_luts: l8 must be [B,H,W] and luts "
                         f"[B,gh,gw,V,256], got {tuple(l8.shape)} and "
                         f"{tuple(luts.shape)}")
    b, h, w = l8.shape
    nv = luts.shape[3]
    if not 1 <= nv <= MAX_V:
        raise ValueError(f"apply_luts: V={nv} clip variants; the kernel "
                         f"takes 1..{MAX_V} (shared memory)")
    if th < 1 or tw < 1 or gh * th < h or gw * tw < w:
        raise ValueError(f"apply_luts: {gh}x{gw} tiles of {th}x{tw} px do "
                         f"not cover a {h}x{w} image")
    dev = l8.device
    check_tensor("apply_luts", "luts", luts, torch.float32,
                 (b, gh, gw, nv, 256), dev)
    check_tensor("apply_luts", "l8", l8, torch.int32, (b, h, w), dev)
    _, wy, ystart = _interp_geometry(h, th, gh, dev)
    _, wx, xstart = _interp_geometry(w, tw, gw, dev)
    out = torch.empty((nv, b, h, w), dtype=torch.float32, device=dev)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(luts.data_ptr(), l8.data_ptr(), wy.data_ptr(), wx.data_ptr(),
             ystart.data_ptr(), xstart.data_ptr(), b, h, w, gh, gw, nv,
             out.data_ptr(), device_index(dev), stream)
    if err != 0:
        raise RuntimeError(f"clahe_apply kernel launch failed: CUDA error "
                           f"{err}")
    apply_luts.launches += 1
    return out


apply_luts.launches = 0
