"""Device choice for the port's entry points.

Every entry point runs on CUDA unless its caller names another device. A
machine without CUDA raises instead of falling back to the CPU: a scan that
silently ran on the host would look correct and be a hundred times slower.
"""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None → ``cuda`` (raises without CUDA); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available and no device was given; pass "
                "device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
