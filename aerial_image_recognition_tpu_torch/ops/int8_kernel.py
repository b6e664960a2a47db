"""Wrapper of the CUDA requantizing epilogue (``csrc/int8_epilogue.cu``).

A port-only kernel: the reference writes the chain as jnp operations after
its integer convolution
(``aerial_image_recognition_tpu/models/int8.py``, ``_Run.conv``) and XLA
fuses them; no Pallas kernel exists for it. On a CUDA tensor ``requantize``
launches the kernel on the current stream or raises; on a CPU tensor it
runs the plain version, ``_requantize_plain``, the same chain as in-place
elementwise passes.

``requantize.launches`` counts kernel launches (not plain-version calls),
so a run can show that its path went through the kernel.
"""

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from aerial_image_recognition_tpu_torch.kernels.args import (
    check_tensor, device_index)

ACTS = {"leaky": 0, "relu": 1, "silu": 2}


def _requantize_plain(r: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
                      inv: Optional[float], act: str) -> torch.Tensor:
    """s32 sums [..., C] → int8 codes: ``t = r·m + b`` as a multiplication
    and then an addition, each rounded to f32 (two passes, so nothing
    contracts them to an FMA); the activation (``leaky``/``relu`` carry the
    requantization in ``m``, ``b``; ``silu`` multiplies by ``inv`` after);
    rounding half to even, as ``jnp.round``; clip to ±127."""
    t = r.to(torch.float32)
    t.mul_(m)
    t.add_(b)
    if act == "leaky":
        t = F.leaky_relu_(t, 0.1)
    elif act == "relu":
        t = t.relu_()
    else:
        t = (t * torch.sigmoid(t)).mul_(inv)
    return t.round_().clamp_(-127, 127).to(torch.int8).contiguous()


def _lib():
    from aerial_image_recognition_tpu_torch.kernels.build import load
    fn = load("int8_epilogue").int8_epilogue_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, ctypes.c_float, i, ctypes.c_longlong, i, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def requantize(r: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
               inv: Optional[float] = None,
               act: str = "leaky") -> torch.Tensor:
    """Conv epilogue: s32 sums ``r`` [..., C] with per-channel f32 ``m``,
    ``b`` [C] (and, for ``silu``, the number ``inv``, kept on the host so
    that a launch reads nothing back from the card) → int8 codes of ``r``'s
    shape. The kernel takes channel counts that are multiples of 4."""
    if act not in ACTS:
        raise ValueError(f"requantize: unknown activation {act!r}")
    if act == "silu" and inv is None:
        raise ValueError("requantize: silu needs inv")
    if r.device.type == "cpu":
        return _requantize_plain(r, m, b, inv, act)
    if r.device.type != "cuda":
        raise ValueError(f"requantize: no kernel for {r.device}")
    dev, cols = r.device, r.shape[-1]
    if cols % 4:
        raise ValueError(f"requantize: the kernel takes channel counts that "
                         f"are multiples of 4, got {cols}")
    check_tensor("requantize", "r", r, torch.int32, tuple(r.shape), dev)
    check_tensor("requantize", "m", m, torch.float32, (cols,), dev)
    check_tensor("requantize", "b", b, torch.float32, (cols,), dev)
    out = torch.empty(r.shape, dtype=torch.int8, device=dev)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(r.data_ptr(), m.data_ptr(), b.data_ptr(),
             float(inv) if act == "silu" else 1.0, ACTS[act],
             r.numel() // cols, cols, out.data_ptr(), device_index(dev),
             stream)
    if err != 0:
        raise RuntimeError(f"int8_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    requantize.launches += 1
    return out


requantize.launches = 0
