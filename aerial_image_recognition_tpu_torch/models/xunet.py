"""XUnet-256 — the building-footprint segmentation model.

Counterpart of ``aerial_image_recognition_tpu/models/xunet.py``: a U-Net
with base width 32 (four encoder DoubleConvs, a bottleneck, four decoder
stages with nearest upsampling, a 1×1 ReLU ConvBN and a channel concat of
the skip), ending in an f32 1×1 conv with bias that gives one mask logit
per pixel; the caller applies the sigmoid. Submodule names equal the flax
scope names (``enc0.cv1``, ``up2``, ``dec3.cv2``, ``mask_out``), so the
weight bridge (``models/weights.py``) loads a reference checkpoint as it is.

``mask_out`` is an ``nn.Linear`` on the channel-last f32 feature, as the
detect heads are: a 1×1 conv is that matrix product. On the card it
refuses to run unless f32 matmuls are full precision (TF32 would round its
operands to 10 bits).
"""

import torch
from torch import nn

from aerial_image_recognition_tpu_torch.models.layers import (
    ConvBN, concat, maxpool2, upsample2)


def _relu(c_in: int, c_out: int, k: int) -> ConvBN:
    return ConvBN(c_in, c_out, k, act="relu")


class DoubleConv(nn.Module):
    """Two 3×3 ReLU ConvBNs (``cv1``, ``cv2``)."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.cv1 = _relu(c_in, features, 3)
        self.cv2 = _relu(features, features, 3)

    def forward(self, x) -> torch.Tensor:
        return self.cv2(self.cv1(x))


class XUnet(nn.Module):
    """U-Net-256: [B,3,256,256] → [B,256,256,out_channels] f32 mask logits
    (channel-last, as the reference returns them)."""

    def __init__(self, out_channels: int = 1, base: int = 32):
        super().__init__()
        c = base
        c_in = 3
        for i, mult in enumerate((1, 2, 4, 8)):
            setattr(self, f"enc{i}", DoubleConv(c_in, c * mult))
            c_in = c * mult
        self.bottleneck = DoubleConv(c_in, c * 16)
        c_in = c * 16
        for i, mult in enumerate((8, 4, 2, 1)):
            setattr(self, f"up{i}", _relu(c_in, c * mult, 1))
            # the concat [up, skip] has twice the stage's channels
            setattr(self, f"dec{i}", DoubleConv(2 * c * mult, c * mult))
            c_in = c * mult
        self.mask_out = nn.Linear(c, out_channels)

    def set_dtype(self, dtype: torch.dtype) -> "XUnet":
        """Cast the trunk to ``dtype``; ``mask_out`` stays f32."""
        self.to(dtype)
        self.mask_out.float()
        return self

    def trunk_dtype(self) -> torch.dtype:
        return self.enc0.cv1.conv.weight.dtype

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,3,S,S] → the dec3 feature [B,base,S,S] (trunk dtype)."""
        skips = []
        for i in range(4):
            x = getattr(self, f"enc{i}")(x)
            skips.append(x)
            x = maxpool2(x)
        x = self.bottleneck(x)
        for i in range(4):
            x = getattr(self, f"up{i}")(upsample2(x))
            x = getattr(self, f"dec{i}")(concat([x, skips[3 - i]]))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,3,S,S] (already /255; cast to the trunk dtype here) →
        [B,S,S,out_channels] f32 logits."""
        if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(
                "the f32 mask head needs full-precision f32 matmuls; "
                "torch.get_float32_matmul_precision() is "
                f"{torch.get_float32_matmul_precision()!r} (TF32) — set it "
                "back to 'highest'")
        f = self.trunk(x.to(self.trunk_dtype()))
        return self.mask_out(f.float().permute(0, 2, 3, 1))
