"""Argument checks shared by the CUDA kernels' wrappers.

A kernel reads raw pointers, so its wrapper refuses anything but the exact
dtype, shape, device and contiguous layout the kernel was written for.
"""

import torch


def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{kernel}: {name} must be {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def device_index(device: torch.device) -> int:
    """The CUDA device ordinal of ``device`` (``cuda`` alone means the
    current one)."""
    return device.index if device.index is not None \
        else torch.cuda.current_device()
