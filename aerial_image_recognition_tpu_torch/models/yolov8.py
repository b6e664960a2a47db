"""The YOLOv8 family (n/s/m/l/x) — the Tokyo 2-class (Car/Truck) detector
is the l scale — as a torch ``nn.Module``.

Counterpart of ``aerial_image_recognition_tpu/models/yolov8.py`` (``SCALES``,
``_r``, ``_n``, ``Bottleneck``, ``C2f``, ``SPPF``, ``DetectHead``,
``YOLOv8``). Submodule names equal the flax scope names (``c2f1.m0.cv1``,
``sppf.cv2``, ``detect.box0_cv1``, ``detect.cls2_out`` …), so the weight
bridge maps the flax tree leaf for leaf.

Anchor-free decoupled head: each level emits 4·REG_MAX box-distribution
logits and nc class logits (``ops/decode.decode_yolov8`` takes the DFL
expectation). The box and class towers run in the trunk's dtype; the six
output convs are f32 1×1 convolutions computed as ``nn.Linear`` over the
channel axis of NHWC maps, like the yolov7 heads, and for the same reason
``forward`` refuses to run them on the card under TF32.
"""

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from aerial_image_recognition_tpu_torch.models.layers import (
    ConvBN, max_pool_same, upsample2)

# depth_multiple, width_multiple, ratio (ultralytics yolov8.yaml scales)
SCALES = {
    "n": (1 / 3, 0.25, 2.0),
    "s": (1 / 3, 0.50, 2.0),
    "m": (2 / 3, 0.75, 1.5),
    "l": (1.0, 1.00, 1.0),
    "x": (1.0, 1.25, 1.0),
}
STRIDES = (8, 16, 32)
REG_MAX = 16


def _r(c, w):
    return max(16, int(round(c * w / 8)) * 8) if c * w > 16 else int(c * w)


def _n(n, d):
    return max(1, round(n * d))


def widths(scale: str):
    """(c1, c2, c3, c4, c5): the stem, P2, P3, P4 and P5 widths."""
    _, w, r = SCALES[scale]
    return (_r(64, w), _r(128, w), _r(256, w), _r(512, w), _r(512 * r, w))


class Bottleneck(nn.Module):
    """Two 3×3 ConvBNs, the input added back when the widths match."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c_out * e)
        self.add = shortcut and c_in == c_out
        self.cv1 = ConvBN(c_in, c_, 3)
        self.cv2 = ConvBN(c_, c_out, 3)

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return y + x if self.add else y


class C2f(nn.Module):
    """Cross-stage partial with 2 convs: cv1's output split in two halves,
    n chained e=1.0 bottlenecks on the running tail, every tap concatenated
    in order into cv2."""

    def __init__(self, c_in: int, c_out: int, n: int = 1,
                 shortcut: bool = False):
        super().__init__()
        c_ = c_out // 2
        self.n = n
        self.cv1 = ConvBN(c_in, 2 * c_)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(c_, c_, shortcut, e=1.0))
        self.cv2 = ConvBN((2 + n) * c_, c_out)

    def forward(self, x):
        ys = list(torch.chunk(self.cv1(x), 2, dim=1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(ys)


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained 5×5 stride-1 pools."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = ConvBN(c_in, c_)
        self.cv2 = ConvBN(4 * c_, c_out)

    def forward(self, x):
        y = self.cv1(x)
        p1 = max_pool_same(y, 5)
        p2 = max_pool_same(p1, 5)
        p3 = max_pool_same(p2, 5)
        return self.cv2([y, p1, p2, p3])


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per level a box tower (4·REG_MAX logits)
    and a class tower (nc logits); returns NHWC f32 maps [box, cls]."""

    def __init__(self, num_classes: int, ch: Sequence[int]):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(num_classes, 100))
        for i, c in enumerate(ch):
            setattr(self, f"box{i}_cv1", ConvBN(c, c2, 3))
            setattr(self, f"box{i}_cv2", ConvBN(c2, c2, 3))
            setattr(self, f"box{i}_out", nn.Linear(c2, 4 * REG_MAX))
            setattr(self, f"cls{i}_cv1", ConvBN(c, c3, 3))
            setattr(self, f"cls{i}_cv2", ConvBN(c3, c3, 3))
            setattr(self, f"cls{i}_out", nn.Linear(c3, num_classes))
        self.levels = len(ch)

    def outputs(self) -> List[nn.Linear]:
        """The six f32 output convs, (box, cls) per level."""
        return [getattr(self, f"{kind}{i}_out") for i in range(self.levels)
                for kind in ("box", "cls")]

    def forward(self, feats):
        outs = []
        for i, f in enumerate(feats):
            b = getattr(self, f"box{i}_cv2")(getattr(self, f"box{i}_cv1")(f))
            c = getattr(self, f"cls{i}_cv2")(getattr(self, f"cls{i}_cv1")(f))
            b = getattr(self, f"box{i}_out")(b.float().permute(0, 2, 3, 1))
            c = getattr(self, f"cls{i}_out")(c.float().permute(0, 2, 3, 1))
            outs.append(torch.cat([b, c], dim=-1))
        return outs


class YOLOv8(nn.Module):
    """Full detector at ``scale``; ``forward`` returns the raw per-level
    maps [B, H/s, W/s, 4·REG_MAX + nc], s ∈ 8/16/32, NHWC f32."""

    def __init__(self, num_classes: int = 2, scale: str = "l"):
        super().__init__()
        d = SCALES[scale][0]
        c1, c2, c3, c4, c5 = widths(scale)
        n3, n6 = _n(3, d), _n(6, d)
        self.num_classes = num_classes
        self.scale = scale
        self.stem = ConvBN(3, c1, 3, 2)                       # P1/2
        self.down2 = ConvBN(c1, c2, 3, 2)                     # P2/4
        self.c2f1 = C2f(c2, c2, n3, True)
        self.down3 = ConvBN(c2, c3, 3, 2)                     # P3/8
        self.c2f2 = C2f(c3, c3, n6, True)
        self.down4 = ConvBN(c3, c4, 3, 2)                     # P4/16
        self.c2f3 = C2f(c4, c4, n6, True)
        self.down5 = ConvBN(c4, c5, 3, 2)                     # P5/32
        self.c2f4 = C2f(c5, c5, n3, True)
        self.sppf = SPPF(c5, c5)
        self.fpn4 = C2f(c5 + c4, c4, n3, False)
        self.fpn3 = C2f(c4 + c3, c3, n3, False)
        self.pan_down4 = ConvBN(c3, c3, 3, 2)
        self.pan4 = C2f(c3 + c4, c4, n3, False)
        self.pan_down5 = ConvBN(c4, c4, 3, 2)
        self.pan5 = C2f(c4 + c5, c5, n3, False)
        self.detect = DetectHead(num_classes, (c3, c4, c5))

    # every scale's stem ConvBNs up to the P2/4 feature, in order: scopes,
    # activation, BN epsilon and strides (the quad stem and int8 read them)
    STEM_TABLES = dict.fromkeys(SCALES, {
        "stems": ("stem", "down2"), "act": "silu", "bn_eps": 1e-3,
        "strides": (2, 2)})

    @property
    def stem_table(self) -> Dict:
        return self.STEM_TABLES[self.scale]

    def heads(self) -> List[nn.Linear]:
        return self.detect.outputs()

    @torch.no_grad()
    def init_detect_prior(self) -> None:
        """Detection-prior bias init (the upstream yolo trick) for fresh
        random weights: the class logits start at σ(−5) ≈ 0.7 %."""
        for i in range(3):
            getattr(self.detect, f"cls{i}_out").bias[:] = -5.0

    def decode(self, outs: List[torch.Tensor], size: Optional[int] = None):
        """The three raw maps → (boxes [B,A,4] cxcywh pixels f32, scores
        [B,A,nc] f32), the DFL expectation. The maps carry the input edge,
        so ``size`` is not read."""
        from aerial_image_recognition_tpu_torch.ops.decode import (
            decode_yolov8)
        return decode_yolov8(outs, self.num_classes)

    def set_dtype(self, dtype: torch.dtype) -> "YOLOv8":
        """Cast the trunk and the towers to ``dtype``; the six output convs
        stay f32."""
        self.to(dtype)
        for h in self.heads():
            h.float()
        return self

    def trunk(self, x: torch.Tensor,
              from_p2: bool = False) -> List[torch.Tensor]:
        """x → the three neck features (f3, f4b, f5b) the head reads.
        ``from_p2``: x is already the P2/4 feature [B,c2,S/4,S/4] (the quad
        stem computed stem and down2, ``ops/quadstem.py``); inference
        only."""
        if not from_p2:
            x = self.down2(self.stem(x))
        x = self.c2f1(x)
        p3 = self.c2f2(self.down3(x))
        p4 = self.c2f3(self.down4(p3))
        p5 = self.sppf(self.c2f4(self.down5(p4)))
        f4 = self.fpn4([upsample2(p5), p4])
        f3 = self.fpn3([upsample2(f4), p3])
        f4b = self.pan4([self.pan_down4(f3), f4])
        f5b = self.pan5([self.pan_down5(f4b), p5])
        return [f3, f4b, f5b]

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
        return self.detect(self.trunk(x, from_p2))
