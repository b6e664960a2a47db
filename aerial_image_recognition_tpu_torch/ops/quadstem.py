"""The quad stem: the two stride-2 3×3 stems as 2×2 convolutions over a
space_to_depth² batch that the host assembles.

Counterpart of ``aerial_image_recognition_tpu/ops/quadstem.py``, the JAX
package's default lowering of native-size YOLOv7-tiny and YOLOv8 tiles. The
host packs each [S,S,3] tile as [S/4,S/4,48] (``host_s2d2``: the same bytes
cross to the device, in another order); the first stem then computes a 2×2
quad of its output pixels jointly as one 2×2 convolution (contraction 192,
output 4·c0 channels, whose order is the space_to_depth layout of its
output), and the second stem is the 2×2 form of the second stride-2 conv
over that layout. The /255 of the preprocess becomes a multiplication after
the first convolution. Both kernel transforms are exact (zero taps where a
3×3 tap falls outside); BN is folded into the kernels first.

The index maps (``s2d_kernel_transform``, ``quad_kernel_transform``, the
host relayouts) are numpy copies of the reference's. ``QuadStem`` holds the
transformed kernels on one device, built once from the flax-format f32
variables; ``quad_stem_forward`` is the reference's function over them. The
2×2 convolutions are ``F.conv2d`` (cuDNN on the card), as the reference
computes them with a plain XLA convolution.

The cell padding ``((1,0),(1,0))`` (the torch ``k//2`` padding of the
underlying stride-2 conv) is done as ``padding=1`` with the last output row
and column dropped: those two only ever read the high-side padding, and the
slice is a free view that the next elementwise pass reads. An explicit
``F.pad`` copies the input first (stem1's is 419 MB in bf16 at B=64,
640 px); padding stem0's uint8 input instead was measured on the card and
made the chain no faster (``PERF.md``).

The ×1/255 multiplies by a 0-dim CPU tensor of the trunk's dtype: the
elementwise kernel then takes it as a scalar (a 0-dim tensor on the card
is broadcast, a slower kernel), and its value is the reference's
``dtype(1/255)``; the product of two numbers of the dtype is exact in f32,
so the one rounding to the dtype is the reference's.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def s2d_kernel_transform(w) -> np.ndarray:
    """[3,3,Cin,Cout] stride-2 torch-padded (k//2 = (1,1)) conv kernel →
    [2,2,4·Cin,Cout]: the equivalent stride-1 2×2 conv over the
    space_to_depth2 grid, cell padding ((1,0),(1,0)).

    Tap (u, v, dy, dx) over cells (y−1+u, x−1+v) maps to the original tap
    (2u+dy−1, 2v+dx−1), zero where that falls outside the 3×3 support. The
    input-channel axis is in s2d order (dy, dx, c)."""
    w = np.asarray(w, np.float32)
    k, _, cin, cout = w.shape
    assert k == 3
    w4 = np.zeros((2, 2, 2, 2, cin, cout), np.float32)   # [u,v,dy,dx,c,o]
    for u in range(2):
        for dy in range(2):
            ky = 2 * u + dy - 1
            if not 0 <= ky <= 2:
                continue
            for v in range(2):
                for dx in range(2):
                    kx = 2 * v + dx - 1
                    if 0 <= kx <= 2:
                        w4[u, v, dy, dx] = w[ky, kx]
    return w4.reshape(2, 2, 4 * cin, cout)


def quad_kernel_transform(w) -> np.ndarray:
    """[3,3,Cin,Cout] stride-2 torch-padded conv kernel → [2,2,16·Cin,
    4·Cout]: a stride-1 2×2 conv over quad cells (4×4 original pixels a
    cell) computing a 2×2 output quad jointly, cell padding ((1,0),(1,0)).

    Output pixel (a, b) of cell (R, C) is conv output (2R+a, 2C+b); it reads
    original row 4R + 2a + ky − 1, i.e. cell row R+p with
    p = (2a+ky−1)//4 and in-cell offset (e, dy) = divmod((2a+ky−1) mod 4,
    2); the tap index is u = p+1. Input channels are in the host pack order
    (e, dy, f, dx, c) of ``host_s2d2``; output channels are (a, b, Cout),
    the s2d layout of the produced feature map."""
    w = np.asarray(w, np.float32)
    k, _, cin, cout = w.shape
    assert k == 3
    wq = np.zeros((2, 2, 2, 2, 2, 2, cin, 2, 2, cout), np.float32)
    # [u, v, e, dy, f, dx, c, a, b, o]
    for a in range(2):
        for ky in range(3):
            p, r = divmod(2 * a + ky - 1, 4)
            e, dy = divmod(r, 2)
            for b in range(2):
                for kx in range(3):
                    q, s = divmod(2 * b + kx - 1, 4)
                    f, dx = divmod(s, 2)
                    wq[p + 1, q + 1, e, dy, f, dx, :, a, b, :] = w[ky, kx]
    return wq.reshape(2, 2, 16 * cin, 4 * cout)


def host_s2d2(px: np.ndarray) -> np.ndarray:
    """Quad-layout host relayout: [H,W,C] → [H/4,W/4,16C] (or batched
    [B,H,W,C] → [B,H/4,W/4,16C]).

    Channel order (e, dy, f, dx, c) holds original pixel
    (4R + 2e + dy, 4C + 2f + dx): row parities first, so that each input
    row lands as contiguous 4C-byte runs and the relayout is four bulk
    strided copies (one per (e, dy))."""
    batched = px.ndim == 4
    if not batched:
        px = px[None]
    b, h, w, c = px.shape
    out = np.empty((b, h // 4, w // 4, 16 * c), px.dtype)
    view = out.reshape(b, h // 4, w // 4, 2, 2, 2, 2, c)
    for e in range(2):
        for dy in range(2):
            view[:, :, :, e, dy] = px[:, 2 * e + dy::4].reshape(
                b, h // 4, w // 4, 2, 2, c)
    return out if batched else out[0]


def host_s2d2_inverse(xq: np.ndarray) -> np.ndarray:
    """Inverse of ``host_s2d2``: [B,H/4,W/4,16C] (or unbatched) →
    [B,H,W,C]. The int8 self-calibration reads plain images back from
    batches an ingest plane assembled in the quad layout."""
    batched = xq.ndim == 4
    if not batched:
        xq = xq[None]
    b, hq, wq, cc = xq.shape
    c = cc // 16
    view = xq.reshape(b, hq, wq, 2, 2, 2, 2, c)
    px = np.empty((b, hq * 4, wq * 4, c), xq.dtype)
    for e in range(2):
        for dy in range(2):
            px[:, 2 * e + dy::4] = view[:, :, :, e, dy].reshape(
                b, hq, wq * 4, c)
    return px if batched else px[0]


def host_s2d2_into(px: np.ndarray, out: np.ndarray) -> None:
    """In-place ``host_s2d2``: the relayout of [H,W,C] ``px`` written into
    the preallocated [H/4,W/4,16C] ``out`` (a batch buffer's row). The
    native copier when it loads (``utils/native.pack_quad_native``; it
    releases the interpreter lock, so ingest threads pack in parallel),
    else four bulk numpy strided copies."""
    from aerial_image_recognition_tpu_torch.utils.native import (
        pack_quad_native)
    if pack_quad_native(px, out):
        return
    h, w, c = px.shape
    view = out.reshape(h // 4, w // 4, 2, 2, 2, 2, c)
    for e in range(2):
        for dy in range(2):
            view[:, :, e, dy] = px[2 * e + dy::4].reshape(
                h // 4, w // 4, 2, 2, c)


def device_s2d2(x: torch.Tensor) -> torch.Tensor:
    """``host_s2d2``'s index map on a tensor where it lies: [B,H,W,C] →
    [B,H/4,W/4,16C], one copy on the tensor's device."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, h // 4, w // 4, 16 * c)


def fold_convbn(p, s, eps: float = 1e-3) -> Tuple[np.ndarray, np.ndarray]:
    """One ConvBN scope ({conv, bn} params and bn stats, flax format) →
    (w [3,3,Cin,Cout], b [Cout]) f32 deploy form: ``g = γ·rsqrt(σ² + ε)``,
    ``w = k·g``, ``b = β − μ·g``, in f32 on the host. ``torch.rsqrt`` and
    XLA's rsqrt differ in the last bit on some inputs, so these weights are
    within 2 f32 ulps of the reference's on the trained fixtures, not equal
    to them."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32))
    g = f32(p["bn"]["scale"]) * torch.rsqrt(f32(s["bn"]["var"]) + eps)
    w = f32(p["conv"]["kernel"]) * g
    b = f32(p["bn"]["bias"]) - f32(s["bn"]["mean"]) * g
    return w.numpy(), b.numpy()


class QuadStem:
    """The two stems of one model as the quad stem, on one device: the
    transformed kernels (OIHW) and the biases in the trunk's dtype, and the
    dtype's constants (1/255, the leaky slope). ``__call__`` takes the s2d²
    batch and returns the P2 feature map."""

    def __init__(self, w0: np.ndarray, b0: np.ndarray, w1: np.ndarray,
                 b1: np.ndarray, *, act: str, dtype: torch.dtype,
                 device: torch.device):
        if act not in ("leaky", "silu"):
            raise ValueError(f"unsupported stem activation {act!r}")
        self.act, self.dtype = act, dtype
        self.device = torch.device(device)
        self._host = (w0, b0, w1, b1)

        def kernel(w):              # HWIO → OIHW
            return torch.from_numpy(np.ascontiguousarray(
                w.transpose(3, 2, 0, 1))).to(self.device, dtype)

        self.w0q = kernel(quad_kernel_transform(w0))      # [4c0, 48, 2, 2]
        self.w1q = kernel(s2d_kernel_transform(w1))       # [c1, 4c0, 2, 2]
        self.b0q = torch.from_numpy(np.tile(np.asarray(b0, np.float32), 4)) \
            .to(self.device, dtype)[:, None, None]
        self.b1 = torch.from_numpy(np.asarray(b1, np.float32)) \
            .to(self.device, dtype)[:, None, None]
        self.scale = torch.tensor(1.0 / 255.0, dtype=dtype)
        # the slope as the dtype rounds it: leaky_relu multiplies in f32 by
        # this number, which equals the reference's dtype(0.1) exactly, and
        # the product of two dtype numbers is exact in f32, so the one
        # rounding to the dtype is the reference's
        self.slope = float(torch.tensor(0.1, dtype=dtype))

    @classmethod
    def from_variables(cls, variables, *, stem_names: Sequence[str],
                       act: str, bn_eps: float, dtype: torch.dtype,
                       device) -> "QuadStem":
        """Fold and transform the two stem ConvBNs of a flax-format f32
        tree."""
        p, s = variables["params"], variables["batch_stats"]
        n0, n1 = stem_names
        w0, b0 = fold_convbn(p[n0], s[n0], eps=bn_eps)
        w1, b1 = fold_convbn(p[n1], s[n1], eps=bn_eps)
        return cls(w0, b0, w1, b1, act=act, dtype=dtype, device=device)

    def to(self, device) -> "QuadStem":
        """The same stem on ``device``."""
        w0, b0, w1, b1 = self._host
        return QuadStem(w0, b0, w1, b1, act=self.act, dtype=self.dtype,
                        device=device)

    def _act(self, v: torch.Tensor) -> torch.Tensor:
        if self.act == "leaky":
            return F.leaky_relu_(v, self.slope)
        return F.silu(v, inplace=True)

    @staticmethod
    def _conv2(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """2×2 stride-1 conv with cell padding ((1,0),(1,0))."""
        h, wd = v.shape[2], v.shape[3]
        return F.conv2d(v, w, None, 1, 1)[:, :, :h, :wd]

    def __call__(self, xq: torch.Tensor,
                 in_scale: Optional[float] = 1.0 / 255.0) -> torch.Tensor:
        """xq [B,S/4,S/4,48] (uint8 or float, NHWC as the host packs it) →
        the P2 feature [B,c1,S/4,S/4] in the trunk's dtype: the standard
        stems applied to x·in_scale, in the reference's order and roundings
        (cast, conv, ·dtype(in_scale) — a multiplication, never a division
        —, + b0, act; conv, + b1, act)."""
        x = xq.permute(0, 3, 1, 2).to(self.dtype)
        scale = self.scale if in_scale == 1.0 / 255.0 else torch.tensor(
            1.0 if in_scale is None else in_scale, dtype=self.dtype)
        # out of place where the input is the cropped view: the result is
        # a dense (channels_last) map again
        h = self._act((self._conv2(x, self.w0q) * scale).add_(self.b0q))
        return self._act(self._conv2(h, self.w1q) + self.b1)


def quad_stem_forward(variables, xq: torch.Tensor, *, act: str = "leaky",
                      in_scale: Optional[float] = 1.0 / 255.0,
                      dtype: torch.dtype = torch.bfloat16,
                      stem_names: Sequence[str] = ("stem0", "stem1"),
                      bn_eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``quad_stem_forward`` over a flax-format tree:
    s2d² input [B,H/4,W/4,48] → the stem features, here NCHW
    [B,c1,H/4,W/4] like the port's trunks take them. ``bn_eps`` follows the
    family (yolov7 1e-5, yolov8 1e-3). Builds the kernels on ``xq``'s
    device for this call; a bundle keeps a ``QuadStem`` instead."""
    stem = QuadStem.from_variables(variables, stem_names=stem_names, act=act,
                                   bn_eps=bn_eps, dtype=dtype,
                                   device=xq.device)
    return stem(xq, in_scale)


def stem_meta(family: str, variant: str = "",
              s2d_stem: bool = False) -> Optional[Dict]:
    """(stem scope names, activation, bn_eps) of the quad-stem lowering for
    a model, or None where it does not apply: any model whose entry is two
    stride-2 3×3 ConvBNs qualifies (yolov7-tiny, every yolov8 scale), not
    yolov7-tiny with its ``s2d_stem`` (a 12-channel stride-1 stem0)."""
    if family == "yolov7" and variant == "tiny" and not s2d_stem:
        return {"stems": ("stem0", "stem1"), "act": "leaky", "bn_eps": 1e-5}
    if family == "yolov8":
        return {"stems": ("stem", "down2"), "act": "silu", "bn_eps": 1e-3}
    return None
