"""Shared building blocks (PyTorch, NCHW tensors, channels_last on the card).

Counterpart of ``aerial_image_recognition_tpu/models/layers.py``: the same
ConvBN block (SiLU, LeakyReLU(0.1), ReLU or none; with or without BN; the
family's BN epsilon), pools and upsample, with parameter names that the
weight bridge (``models/weights.py``) maps one to one from the flax tree.

``BatchNorm`` is ``nn.BatchNorm2d`` for inference and flax's
``nn.BatchNorm(momentum=0.97)`` for training (``set_bn_mode``): the trainer
(``pipeline/train.py``) runs it in the reference's ``frozen`` or ``batch``
mode.
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


# flax's BatchNorm momentum: the weight of the OLD running average
BN_MOMENTUM = 0.97


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with flax's training semantics, named like torch's.

    ``mode`` None (the default) is ``nn.BatchNorm2d`` itself, in whatever
    train/eval state the module is: the inference paths, unchanged. The
    trainer sets one of flax's two modes on every BN (``set_bn_mode``):

    * ``"frozen"`` — flax's ``use_running_average=True``: the running
      statistics as a fixed affine, with trainable scale and bias;
    * ``"batch"`` — flax's ``train=True``: the batch's own statistics,
      computed in f32 over (N, H, W) with flax's fast variance
      ``max(0, E[x²] − E[x]²)`` (biased).

    Both normalize as flax does, ``(x − mean) · (rsqrt(var + eps) · scale)
    + bias``. In ``batch`` mode the forward does NOT touch the running
    buffers: it keeps the batch's statistics (detached) in ``batch_mean``
    and ``batch_var``, once per forward — a recomputation under activation
    checkpointing finds them set and leaves them — and the caller folds
    them in, flax's way: ``ra = 0.97·ra + (1 − 0.97)·batch`` (the old
    average weighted by the momentum, the biased variance). Clear them
    with ``clear_batch_stats`` before each forward.

    ``sync`` (None, or set by the data-parallel train step on each shard's
    copy): a callable ``(sums [2,C], count) → (global sums, global
    count)`` that adds per-channel sums over every shard,
    differentiably, so that ``batch`` mode takes its statistics over the
    global batch, as the reference's single program over a mesh does. The
    shards send n·mean and M2 + n·mean² (M2 their sums of squared
    deviations), met in f64: the same statistics, without the fast
    variance's cancellation over the shards' f32 sums.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)
        self.mode = None
        self.sync = None
        self.batch_mean = None
        self.batch_var = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode is None:
            return super().forward(x)
        xf = x.float()
        if self.mode == "batch":
            if self.sync is None:
                mean = xf.mean(dim=(0, 2, 3))
                sq = (xf * xf).mean(dim=(0, 2, 3))
            else:
                # each shard's mean and sum of squared deviations (f32, no
                # cancellation), met in f64 as n·m and M2 + n·m² (Chan's
                # pairwise combination): the fast variance over shards'
                # f32 sums would add their rounding to E[x²] − E[x]²
                n = xf.shape[0] * xf.shape[2] * xf.shape[3]
                m = xf.mean(dim=(0, 2, 3))
                d = xf - m[:, None, None]
                m2 = (d * d).sum(dim=(0, 2, 3))
                md = m.double()
                sums, count = self.sync(torch.stack(
                    [md * n, m2.double() + n * md * md]), n)
                mean, sq = sums[0] / count, sums[1] / count
            # jnp.maximum: a tie's gradient is split, as flax's
            var = torch.maximum(sq - mean * mean,
                                torch.zeros((), dtype=sq.dtype,
                                            device=xf.device))
            mean, var = mean.float(), var.float()
            if self.batch_mean is None:
                self.batch_mean = mean.detach()
                self.batch_var = var.detach()
        elif self.mode == "frozen":
            mean, var = self.running_mean, self.running_var
        else:
            raise ValueError(f"unknown BN mode {self.mode!r}")
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def set_bn_mode(module: nn.Module, mode) -> nn.Module:
    """Set ``mode`` (None, "frozen" or "batch") on every ``BatchNorm`` of
    ``module``; returns ``module``."""
    if mode not in (None, "frozen", "batch"):
        raise ValueError(f"unknown BN mode {mode!r}")
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mode = mode
    return module


def clear_batch_stats(module: nn.Module) -> None:
    """Forget the batch statistics the last forward kept."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.batch_mean = m.batch_var = None


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
        self.bn = BatchNorm(c_out, eps=bn_eps) if use_bn else nn.Identity()

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
    """Fuse every ConvBN of ``module`` in place, then merge the parallel
    branches of every block that has a ``reparameterize`` (RT-DETR's
    RepVGG units); returns ``module``."""
    for m in module.modules():
        if isinstance(m, ConvBN):
            m.fuse()
    for m in list(module.modules()):
        if hasattr(m, "reparameterize"):
            m.reparameterize()
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


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] → [B,4C,H/2,W/2] (the 'Focus' rearrangement), channel
    order (dy, dx, c) as the reference's NHWC reshape gives it —
    ``F.pixel_unshuffle`` orders them (c, dy, dx), which would scramble the
    12-channel stem kernel of ``YOLOv7(s2d_stem=True)``. Row-sharded
    activations (``parallel/spatial.RowShards``) take it through their own
    rule."""
    if torch.overrides.has_torch_function_unary(x):
        return torch.overrides.handle_torch_function(space_to_depth2, (x,),
                                                     x)
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)
