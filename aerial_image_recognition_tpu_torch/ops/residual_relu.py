"""The residual join of RT-DETR's ResNet-vd bottleneck, ``relu(y + s)``,
in place into ``y``: the wrapper of the CUDA kernel
(``csrc/residual_relu.cu``) and its plain version.

``y`` is the block's last convolution's output and ``s`` its shortcut, of
one shape and dtype (f32 or bf16) and dense in one memory format
(channels_last, as the backbone's convolutions give, or contiguous). Both
versions write ``max(y + s, 0)`` into ``y`` and return it: the sum in f32
rounded once to ``y``'s dtype, then clamped, bit-equal to
``F.relu(y + s)``. Writing into ``y`` keeps the join from allocating the
sum and the ReLU's output, two maps of the block's full width.

On a CUDA tensor ``residual_relu`` launches the kernel on the current
stream or raises; on a CPU tensor it runs ``residual_relu_plain``. There
is no fallback from the card to the plain version.
``residual_relu.launches`` counts kernel launches (not plain-version
calls).
"""

import ctypes
import functools

import torch

from aerial_image_recognition_tpu_torch.kernels.args import device_index

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def residual_relu_plain(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """y ← max(y + s, 0) in two in-place passes; returns y."""
    return torch.add(y, s, out=y).clamp_(min=0)


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry point, built and loaded at the first launch."""
    from aerial_image_recognition_tpu_torch.kernels.build import load
    fn = load("residual_relu").residual_relu_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, ctypes.c_longlong, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _memory_format(t: torch.Tensor):
    """The format ``t`` is dense in, contiguous first; None if neither."""
    if t.is_contiguous():
        return torch.contiguous_format
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return None


def residual_relu(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """y ← max(y + s, 0) in place; returns y."""
    if y.device.type == "cpu":
        return residual_relu_plain(y, s)
    if y.device.type != "cuda":
        raise ValueError(f"residual_relu: no kernel for {y.device}")
    if s.device != y.device or s.dtype != y.dtype or s.shape != y.shape:
        raise ValueError(f"residual_relu: s must be {y.dtype} "
                         f"{tuple(y.shape)} on {y.device} like y, got "
                         f"{s.dtype} {tuple(s.shape)} on {s.device}")
    if y.dtype not in _DTYPES:
        raise ValueError(f"residual_relu: {y.dtype} is not one of the "
                         f"kernel's dtypes {list(_DTYPES)}")
    fmt = _memory_format(y)
    if fmt is None or not s.is_contiguous(memory_format=fmt):
        raise ValueError("residual_relu: y and s must be dense in the same "
                         "memory format (contiguous or channels_last), got "
                         f"strides {y.stride()} and {s.stride()}")
    if y.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("residual_relu: y and s must start on 16-byte "
                         "boundaries (the kernel's vector loads)")
    dev = y.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(y.data_ptr(), s.data_ptr(), y.numel(), _DTYPES[y.dtype],
                 device_index(dev), stream)
    if err != 0:
        raise RuntimeError(f"residual_relu kernel launch failed: CUDA "
                           f"error {err}")
    residual_relu.launches += 1
    return y


residual_relu.launches = 0
