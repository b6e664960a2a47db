"""Device choice for the port's entry points.

Every entry point runs on CUDA unless its caller names another device. A
machine without CUDA raises instead of falling back to the CPU: a scan that
silently ran on the host would look correct and be a hundred times slower.
"""

from contextlib import nullcontext
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None → the caller's current card (raises without CUDA); anything
    else as given. A card is returned with its index (``canonical``): the
    current card belongs to the thread, and a new thread starts on card 0,
    so a bare ``cuda`` would name card 0 in the server's batch thread or
    the device monitor's thread of a process driving card k."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available and no device was given; pass "
                "device='cpu' to run on the CPU explicitly")
        return canonical("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return canonical(device)


def canonical(device) -> torch.device:
    """``cuda`` alone → the current card's index, so that devices compare
    equal when they name the same card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(device: torch.device):
    """The context that makes ``device`` the current card (a no-op for
    the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()
