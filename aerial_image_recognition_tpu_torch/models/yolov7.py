"""The YOLOv7 family — tiny (the ITCVD car detector) and base — as a torch
``nn.Module``.

Counterpart of ``aerial_image_recognition_tpu/models/yolov7.py`` (``YOLOv7``
with its ``s2d_stem`` option, ``_tiny``, ``_base``, ``ELANTiny``, ``SPPCSPCTiny``, ``ELAN``, ``MPConv``,
``SPPCSPC``). Submodule names equal the flax scope names (``elan1.cv1``,
``sppcspc.out``, ``mp3.down_cv``, ``rep3``, ``detect0`` …), so the weight
bridge maps the flax tree leaf for leaf.

Every concat keeps the reference's order channel for channel
(``[cv4, cv3, cv2, cv1]``, ``[p13, p9, p5, cv2]``, ``[r4, x]``, MPConv's
``[conv branch, pool branch]``, the PAN's ``[b, a, f4]`` …): the 1×1
kernels that follow are sliced in that order.

The detect heads run in f32 whatever the trunk's dtype, and return NHWC maps
``[B, H/s, W/s, 3·(5+nc)]`` like the reference. They are 1×1 convolutions
computed as matmuls over the channel axis, so their precision is PyTorch's
f32 matmul precision. On the card that must be full f32 ("highest", the
default): TF32 keeps ~3 decimal digits, which at 640-px coordinates is the
same class of error the reference hit with bf16 box arithmetic, so
``forward`` refuses to run the heads under anything else.
"""

from typing import Dict, List, Optional

import torch
from torch import nn

from aerial_image_recognition_tpu_torch.models.layers import (
    ConvBN, concat, max_pool_same, maxpool2, space_to_depth2, upsample2)

# Upstream anchor priors (pixels at 640 input).
ANCHORS_TINY = (
    ((10, 13), (16, 30), (33, 23)),      # P3/8
    ((30, 61), (62, 45), (59, 119)),     # P4/16
    ((116, 90), (156, 198), (373, 326)), # P5/32
)
ANCHORS_BASE = (
    ((12, 16), (19, 36), (40, 28)),
    ((36, 75), (76, 55), (72, 146)),
    ((142, 110), (192, 243), (459, 401)),
)
STRIDES = (8, 16, 32)
# upstream yolov7 uses nn.BatchNorm2d's default eps (1e-5)
BN_EPS = 1e-5


def _conv(c_in, c_out, k=1, s=1, act="leaky", use_bn=True):
    return ConvBN(c_in, c_out, k, s, act=act, use_bn=use_bn, bn_eps=BN_EPS)


def _silu(c_in, c_out, k=1, s=1, use_bn=True):
    return _conv(c_in, c_out, k, s, act="silu", use_bn=use_bn)


class ELANTiny(nn.Module):
    """yolov7-tiny ELAN: two 1×1 stems, two chained 3×3, concat all four."""

    def __init__(self, c_in: int, c_mid: int, c_out: int):
        super().__init__()
        self.cv1 = _conv(c_in, c_mid)
        self.cv2 = _conv(c_in, c_mid)
        self.cv3 = _conv(c_mid, c_mid, 3)
        self.cv4 = _conv(c_mid, c_mid, 3)
        self.out = _conv(4 * c_mid, c_out)

    def forward(self, x):
        x = concat(x)
        cv1 = self.cv1(x)
        cv2 = self.cv2(x)
        cv3 = self.cv3(cv2)
        cv4 = self.cv4(cv3)
        return self.out([cv4, cv3, cv2, cv1])


class SPPCSPCTiny(nn.Module):
    """yolov7-tiny SPP-CSP-lite. Three chained 5×5 stride-1 pools equal the
    parallel 5/9/13 pools of the upstream graph (max5∘max5 = max9)."""

    def __init__(self, c_in: int, c: int):
        super().__init__()
        self.cv1 = _conv(c_in, c)
        self.cv2 = _conv(c_in, c)
        self.cv3 = _conv(4 * c, c)
        self.out = _conv(2 * c, c)

    def forward(self, x):
        cv1 = self.cv1(x)
        cv2 = self.cv2(x)
        p5 = max_pool_same(cv2, 5)
        p9 = max_pool_same(p5, 5)       # = max9 of cv2
        p13 = max_pool_same(p9, 5)      # = max13 of cv2
        y = self.cv3([p13, p9, p5, cv2])
        return self.out([y, cv1])


class ELAN(nn.Module):
    """yolov7 (base) ELAN: two 1×1 stems, four chained 3×3 off cv2.
    Backbone taps [m4, m2, cv2, cv1]; the head form ('ELAN-H', half-width
    inner convs) taps all six, [m4, m3, m2, m1, cv2, cv1]."""

    def __init__(self, c_in: int, c_mid: int, c_out: int,
                 head: bool = False):
        super().__init__()
        self.head = head
        c_inner = c_mid // 2 if head else c_mid
        self.cv1 = _silu(c_in, c_mid)
        self.cv2 = _silu(c_in, c_mid)
        self.m1 = _silu(c_mid, c_inner, 3)
        self.m2 = _silu(c_inner, c_inner, 3)
        self.m3 = _silu(c_inner, c_inner, 3)
        self.m4 = _silu(c_inner, c_inner, 3)
        taps = 4 * c_inner + 2 * c_mid if head else 2 * c_inner + 2 * c_mid
        self.out = _silu(taps, c_out)

    def forward(self, x):
        x = concat(x)
        cv1 = self.cv1(x)
        cv2 = self.cv2(x)
        m1 = self.m1(cv2)
        m2 = self.m2(m1)
        m3 = self.m3(m2)
        m4 = self.m4(m3)
        if self.head:
            return self.out([m4, m3, m2, m1, cv2, cv1])
        return self.out([m4, m2, cv2, cv1])


class MPConv(nn.Module):
    """yolov7 downsample transition: a max-pool branch and a strided-conv
    branch, returned as the deferred concat [conv branch, pool branch]."""

    def __init__(self, c_in: int, c: int):
        super().__init__()
        self.pool_cv = _silu(c_in, c)
        self.pre_cv = _silu(c_in, c)
        self.down_cv = _silu(c, c, 3, 2)

    def forward(self, x):
        a = self.pool_cv(maxpool2(x))
        b = self.down_cv(self.pre_cv(x))
        return [b, a]


class SPPCSPC(nn.Module):
    """yolov7 base SPP-CSP block: 5/9/13 pools in parallel on cv4."""

    def __init__(self, c_in: int, c: int):
        super().__init__()
        self.cv1 = _silu(c_in, c)
        self.cv3 = _silu(c, c, 3)
        self.cv4 = _silu(c, c)
        self.cv5 = _silu(4 * c, c)
        self.cv6 = _silu(c, c, 3)
        self.cv2 = _silu(c_in, c)
        self.cv7 = _silu(2 * c, c)

    def forward(self, x):
        cv4 = self.cv4(self.cv3(self.cv1(x)))
        pools = [cv4] + [max_pool_same(cv4, k) for k in (5, 9, 13)]
        y1 = self.cv6(self.cv5(pools))
        return self.cv7([y1, self.cv2(x)])


class YOLOv7(nn.Module):
    """Full detector, variant 'tiny' or 'base'; ``forward`` returns the
    three raw head maps, NHWC f32.

    s2d_stem (tiny only, as in the reference): the strided 3-channel stem0
    becomes ``space_to_depth2`` and a 12→32 3×3 stride-1 ConvBN (same output
    shape; a stem kernel of another shape, so upstream weights need a kernel
    transform). The quad stem and int8 do not take such a model."""

    def __init__(self, num_classes: int = 1, variant: str = "tiny",
                 s2d_stem: bool = False):
        super().__init__()
        if variant not in ("tiny", "base"):
            raise ValueError(f"unknown yolov7 variant {variant!r}")
        self.num_classes = num_classes
        self.variant = variant
        self.s2d_stem = s2d_stem
        no = 3 * (5 + num_classes)
        if variant == "base":
            self._build_base(no)
            return
        if s2d_stem:
            self.stem0 = _conv(12, 32, 3, 1)                  # P1/2, s2d
        else:
            self.stem0 = _conv(3, 32, 3, 2)                   # P1/2
        self.stem1 = _conv(32, 64, 3, 2)                      # P2/4
        self.elan1 = ELANTiny(64, 32, 64)
        self.elan2 = ELANTiny(64, 64, 128)                    # P3/8
        self.elan3 = ELANTiny(128, 128, 256)                  # P4/16
        self.elan4 = ELANTiny(256, 256, 512)                  # P5/32
        self.sppcspc = SPPCSPCTiny(512, 256)
        self.up4_cv = _conv(256, 128)
        self.route4 = _conv(256, 128)
        self.head_elan4 = ELANTiny(256, 64, 128)
        self.up3_cv = _conv(128, 64)
        self.route3 = _conv(128, 64)
        self.head_elan3 = ELANTiny(128, 32, 64)
        self.down4_cv = _conv(64, 128, 3, 2)
        self.pan_elan4 = ELANTiny(256, 64, 128)
        self.down5_cv = _conv(128, 256, 3, 2)
        self.pan_elan5 = ELANTiny(512, 128, 256)
        self.out3 = _conv(64, 128, 3)
        self.out4 = _conv(128, 256, 3)
        self.out5 = _conv(256, 512, 3)
        self.detect0 = nn.Linear(128, no)
        self.detect1 = nn.Linear(256, no)
        self.detect2 = nn.Linear(512, no)

    def _build_base(self, no: int) -> None:
        self.stem0 = _silu(3, 32, 3)
        self.stem1 = _silu(32, 64, 3, 2)                      # P1/2
        self.stem2 = _silu(64, 64, 3)
        self.stem3 = _silu(64, 128, 3, 2)                     # P2/4
        self.elan1 = ELAN(128, 64, 256)
        self.mp3 = MPConv(256, 128)                           # P3/8
        self.elan2 = ELAN(256, 128, 512)
        self.mp4 = MPConv(512, 256)                           # P4/16
        self.elan3 = ELAN(512, 256, 1024)
        self.mp5 = MPConv(1024, 512)                          # P5/32
        self.elan4 = ELAN(1024, 256, 1024)
        self.sppcspc = SPPCSPC(1024, 512)
        self.up4_cv = _silu(512, 256)
        self.route4 = _silu(1024, 256)
        self.head_elan4 = ELAN(512, 256, 256, head=True)
        self.up3_cv = _silu(256, 128)
        self.route3 = _silu(512, 128)
        self.head_elan3 = ELAN(256, 128, 128, head=True)
        self.pan4_pool_cv = _silu(128, 128)
        self.pan4_pre_cv = _silu(128, 128)
        self.pan4_down_cv = _silu(128, 128, 3, 2)
        self.pan_elan4 = ELAN(512, 256, 256, head=True)
        self.pan5_pool_cv = _silu(256, 256)
        self.pan5_pre_cv = _silu(256, 256)
        self.pan5_down_cv = _silu(256, 256, 3, 2)
        self.pan_elan5 = ELAN(1024, 512, 512, head=True)
        # RepConv deploy form: one fused 3×3 conv with bias, no BN
        self.rep3 = _silu(128, 256, 3, use_bn=False)
        self.rep4 = _silu(256, 512, 3, use_bn=False)
        self.rep5 = _silu(512, 1024, 3, use_bn=False)
        self.detect0 = nn.Linear(256, no)
        self.detect1 = nn.Linear(512, no)
        self.detect2 = nn.Linear(1024, no)

    # each variant's stem ConvBNs up to the P2/4 feature, in order: scopes,
    # activation, BN epsilon and strides (the quad stem and int8 read them)
    STEM_TABLES = {
        "tiny": {"stems": ("stem0", "stem1"), "act": "leaky",
                 "bn_eps": BN_EPS, "strides": (2, 2)},
        "base": {"stems": ("stem0", "stem1", "stem2", "stem3"),
                 "act": "silu", "bn_eps": BN_EPS, "strides": (1, 2, 1, 2)},
    }

    @property
    def anchors(self):
        return ANCHORS_TINY if self.variant == "tiny" else ANCHORS_BASE

    @property
    def stem_table(self) -> Dict:
        """This variant's entry of ``STEM_TABLES``; with ``s2d_stem``,
        stem0 runs at stride 1 on the space-to-depth input."""
        table = self.STEM_TABLES[self.variant]
        return dict(table, strides=(1, 2)) if self.s2d_stem else table

    def heads(self) -> List[nn.Linear]:
        return [self.detect0, self.detect1, self.detect2]

    @torch.no_grad()
    def init_detect_prior(self) -> None:
        """Detection-prior bias init (the upstream yolo trick) for fresh
        random weights: objectness and class logits start at σ(−5) ≈
        0.7 %."""
        no = 5 + self.num_classes
        for head in self.heads():
            for a in range(3):
                head.bias[a * no + 4:(a + 1) * no] = -5.0

    def decode(self, outs: List[torch.Tensor], size: Optional[int] = None):
        """The three raw maps → (boxes [B,A,4] cxcywh pixels f32, scores
        [B,A,nc] f32). The maps carry the input edge, so ``size`` is not
        read."""
        from aerial_image_recognition_tpu_torch.ops.decode import (
            decode_yolov7)
        return decode_yolov7(outs, self.anchors, self.num_classes)

    def set_dtype(self, dtype: torch.dtype) -> "YOLOv7":
        """Cast the trunk to ``dtype``; the detect heads stay f32."""
        self.to(dtype)
        for h in self.heads():
            h.float()
        return self

    def trunk(self, x: torch.Tensor,
              from_p2: bool = False) -> List[torch.Tensor]:
        """x → the three head taps. ``from_p2``: x is already the P2/4 stem
        feature [B,64,S/4,S/4] (the quad stem computed it,
        ``ops/quadstem.py``) and the two stems are skipped; tiny only,
        inference only."""
        if self.variant == "base":
            if from_p2:
                raise ValueError("from_p2 is the quad-stem lowering of "
                                 "yolov7-tiny; yolov7-base has none")
            return self._base_trunk(x)
        if not from_p2:
            if self.s2d_stem:
                x = space_to_depth2(x)
            x = self.stem1(self.stem0(x))
        x = self.elan1(x)
        p3 = self.elan2(maxpool2(x))
        p4 = self.elan3(maxpool2(p3))
        p5 = self.elan4(maxpool2(p4))
        spp = self.sppcspc(p5)
        x = upsample2(self.up4_cv(spp))
        f4 = self.head_elan4([self.route4(p4), x])
        x = upsample2(self.up3_cv(f4))
        f3 = self.head_elan3([self.route3(p3), x])
        f4b = self.pan_elan4([self.down4_cv(f3), f4])
        f5b = self.pan_elan5([self.down5_cv(f4b), spp])
        return [self.out3(f3), self.out4(f4b), self.out5(f5b)]

    def _base_trunk(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem3(self.stem2(self.stem1(self.stem0(x))))
        x = self.elan1(x)
        p3 = self.elan2(self.mp3(x))
        p4 = self.elan3(self.mp4(p3))
        p5 = self.elan4(self.mp5(p4))
        spp = self.sppcspc(p5)
        x = upsample2(self.up4_cv(spp))
        f4 = self.head_elan4([self.route4(p4), x])
        x = upsample2(self.up3_cv(f4))
        f3 = self.head_elan3([self.route3(p3), x])
        # PAN transitions concat [conv branch, pool branch, skip]
        a = self.pan4_pool_cv(maxpool2(f3))
        b = self.pan4_down_cv(self.pan4_pre_cv(f3))
        f4b = self.pan_elan4([b, a, f4])
        a = self.pan5_pool_cv(maxpool2(f4b))
        b = self.pan5_down_cv(self.pan5_pre_cv(f4b))
        f5b = self.pan_elan5([b, a, spp])
        return [self.rep3(f3), self.rep4(f4b), self.rep5(f5b)]

    def forward(self, x: torch.Tensor,
                from_p2: bool = False) -> List[torch.Tensor]:
        """x [B,3,S,S] (already /255, trunk dtype), or with ``from_p2`` the
        P2 feature (see ``trunk``) → three NHWC f32 maps."""
        if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(
                "the f32 detect heads need full-precision f32 matmuls; "
                "torch.get_float32_matmul_precision() is "
                f"{torch.get_float32_matmul_precision()!r} (TF32) — set it "
                "back to 'highest'")
        return [head(f.float().permute(0, 2, 3, 1))
                for f, head in zip(self.trunk(x, from_p2), self.heads())]
