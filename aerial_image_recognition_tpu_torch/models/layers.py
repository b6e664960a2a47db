"""Shared building blocks (PyTorch, NCHW tensors, channels_last on the card).

Counterpart of ``aerial_image_recognition_tpu/models/layers.py``: the same
ConvBN block (SiLU, LeakyReLU(0.1), ReLU or none; with or without BN; the
family's BN epsilon), pools and upsample, with parameter names that the
weight bridge (``models/weights.py``) maps one to one from the flax tree.
"""

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]

ACTIVATIONS = {
    "silu": F.silu,
    "leaky": lambda x: F.leaky_relu(x, 0.1),
    "relu": F.relu,
    "none": lambda x: x,
}


def concat(xs: Tensors) -> torch.Tensor:
    """Channel concat of a deferred list (a lone tensor passes through)."""
    if isinstance(xs, torch.Tensor):
        return xs
    return torch.cat(list(xs), dim=1)


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + activation — the YOLO 'Conv' block. The
    defaults are ultralytics v8's (SiLU, BN epsilon 1e-3); the yolov7
    family passes its own (LeakyReLU for tiny, SiLU for base, epsilon
    1e-5). ``use_bn=False`` is a conv with bias and no BN (yolov7-base's
    RepConv deploy convs).

    Padding is an explicit ``k // 2`` on every side (torch's "autopad"). For
    stride 1 that equals SAME; for stride 2 on an even input it does not
    (SAME would pad (0, 1)), and the reference uses the explicit form too.

    A 1×1 ConvBN may be called with a LIST of tensors: the list is
    concatenated in order before the conv, so the kernel's input channels
    are sliced in that order.

    ``fuse()`` turns the block into its deploy form: BN folded into the conv
    (weight·γ/√(σ²+ε), bias β − μ·γ/√(σ²+ε)), so the graph is conv + bias +
    activation only.
    """

    def __init__(self, c_in: int, c_out: int, kernel: int = 1,
                 stride: int = 1, act: str = "silu", use_bn: bool = True,
                 bn_eps: float = 1e-3):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, kernel // 2,
                              bias=not use_bn)
        self.bn = nn.BatchNorm2d(c_out, eps=bn_eps) if use_bn \
            else nn.Identity()

    def forward(self, x: Tensors) -> torch.Tensor:
        return ACTIVATIONS[self.act](self.bn(self.conv(concat(x))))

    @torch.no_grad()
    def fuse(self) -> None:
        """Fold BN into the conv in f32 (inference-only deploy form); a
        BN-less conv stays as it is."""
        if isinstance(self.bn, nn.Identity):
            return
        bn = self.bn
        g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        w = self.conv.weight.float() * g[:, None, None, None]
        b = bn.bias.float() - bn.running_mean.float() * g
        conv = nn.Conv2d(self.conv.in_channels, self.conv.out_channels,
                         self.conv.kernel_size, self.conv.stride,
                         self.conv.padding, bias=True,
                         device=w.device, dtype=self.conv.weight.dtype)
        conv.weight.copy_(w)
        conv.bias.copy_(b)
        self.conv = conv
        self.bn = nn.Identity()


def fold_batchnorm(module: nn.Module) -> nn.Module:
    """Fuse every ConvBN of ``module`` in place; returns ``module``."""
    for m in module.modules():
        if isinstance(m, ConvBN):
            m.fuse()
    return module


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k stride-1 max pool padded to keep the size (the SPP 'SP' block)."""
    return F.max_pool2d(x, k, 1, k // 2)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 VALID max pool (the 'MP' downsample of yolov7)."""
    return F.max_pool2d(x, 2, 2)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """2× nearest-neighbour upsample (FPN path)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
