"""Post-training int8 quantization of the detector trunks.

Counterpart of ``aerial_image_recognition_tpu/models/int8.py``: the
detector families yolov7-tiny (``yolov7_itcvd``, leaky), yolov7-base and
YOLOv8 n–x (silu) → ``Int8Bundle``, and the XUnet-256 segmentation model
(relu) → ``Int8XUnetBundle``. YOLOv7-tiny and YOLOv8 also get the
fully-int8 quad-stem entry (``_quantize_stems``, ``_stems_int8``,
``Int8Bundle.forward_s2d2``), which the default step takes on native-size
tiles.

Scheme (standard PTQ, arranged so the int8 graph needs NO runtime rescales):
  * weights: per-output-channel symmetric int8, BatchNorm folded first;
  * activations: per-tensor symmetric int8, scales from a calibration pass
    (absmax of every ConvBN output and every yolov8 Bottleneck output,
    captured by forward hooks);
  * each producer's output scale is folded into every consumer's kernel
    slice for that producer's channels — so concatenations of differently
    scaled int8 tensors are PLAIN int8 concats, and max-pools / nearest
    upsamples / channel splits pass int8 through untouched (value-
    preserving ⇒ scale-preserving);
  * leaky-relu is positively homogeneous (leaky(a·x) = a·leaky(x), a>0),
    so the requantize division folds into the conv epilogue constants:
      y_i8 = clip(round(leaky(conv_s32 · (s_w/s_out) + b/s_out)))
    silu is not, so its epilogue multiplies by ``inv`` = 1/s_out after the
    activation — one elementwise chain per conv either way, int8 in / int8
    out (``ops/int8_kernel.requantize``: a CUDA kernel on the card);
  * the yolov8 Bottleneck's residual add dequantizes both operands, adds
    in f32 and requantizes at the Bottleneck's calibrated scale.

On the plain entry (``forward``) the stems stay in the bundle's dtype (bf16
in production); the quad-stem entry on uint8 s2d² batches runs them int8
too: the input shifts to int8 exactly (x − 128 is x XOR 128 seen as
int8), both 2×2 convs are the integer product, and the first one's
epilogue adds a per-position border term (the epilogue kernel's border
mode) for the zero padding, which stands for pixel 128 after the shift.
The yolov7 detect heads and the yolov8 output convs stay f32 (the yolov8
box and class towers are int8 trunk convs). XUnet keeps its 3-channel
entry conv (enc0/cv1) in the bundle's dtype and its 1×1 mask head in f32,
with the dec3 coding scale folded into the head's kernel. Each trunk graph mirrors its module's
``trunk`` from the P2 feature on; a prepare/run interpreter pair shares the
single transcription.

Two halves. The **numpy half** (``_pcq``, ``_Prepare``, the transcriptions,
``save_absmax``/``load_absmax``) is a copy of the reference's and works on
the flax-format f32 tree (HWIO kernels), so the same ``absmax`` table gives
the same ``w8``, ``m``, ``b`` and scales bit for bit. The **torch half**
(``_Run``, ``Int8Bundle``, ``calibrate_absmax``) runs the graph on int8
tensors kept NHWC ``[B,H,W,C]``, the reference's layout.

The integer convolution must be an exact s8×s8→s32 product. On the CPU it
is ``F.conv2d`` on int32 tensors (the plain version). On the card it is
``torch._int_mm`` (cuBLASLt, s32 accumulation): a 1×1 convolution is that
product on the free view ``[B·H·W, C_in]``, a 3×3 one on an int8 im2col of
the nine shifted slices of the zero-padded input (zero padding is
activation 0.0, exact under symmetric quantization). The reference computes
this product outside any hand-written kernel too (``lax.conv_general_
dilated`` with an s32 result). There is no fallback: a CUDA tensor never
reaches the int32 ``F.conv2d`` and never widens to float, and an
``_int_mm`` error (it takes M > 16 rows and K, N multiples of 8)
propagates.
"""

import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aerial_image_recognition_tpu_torch.ops.int8_kernel import requantize

# ---------------------------------------------------------------------------
# numpy half: weight quantization and the shared trunk graph


def _pcq(wf: np.ndarray):
    """Per-output-channel symmetric int8 weight quantization."""
    o = wf.shape[-1]
    sw = np.maximum(np.abs(wf).reshape(-1, o).max(axis=0), 1e-12) / 127.0
    return np.clip(np.round(wf / sw), -127, 127).astype(np.int8), sw


@dataclass
class QT:
    """A quantized tensor flowing through the trunk graph.

    run mode: v is the int8 tensor [B,H,W,C] (s/c are bookkeeping).
    prepare mode: v is None; s is the static coding scale, c the channels.
    """
    v: Any
    s: float
    c: int


def _elan(g, prefix: str, x):
    """ELANTiny (models/yolov7.py): concat order [cv4,cv3,cv2,cv1]."""
    cv1 = g.conv(f"{prefix}/cv1", x, 1)
    cv2 = g.conv(f"{prefix}/cv2", x, 1)
    cv3 = g.conv(f"{prefix}/cv3", cv2, 3)
    cv4 = g.conv(f"{prefix}/cv4", cv3, 3)
    return g.conv(f"{prefix}/out", [cv4, cv3, cv2, cv1], 1)


def _sppcspc_tiny(g, prefix: str, x):
    """SPPCSPCTiny (models/yolov7.py, SPPF-equivalent chain)."""
    cv1 = g.conv(f"{prefix}/cv1", x, 1)
    cv2 = g.conv(f"{prefix}/cv2", x, 1)
    p5 = g.pool_same(cv2, 5)
    p9 = g.pool_same(p5, 5)
    p13 = g.pool_same(p9, 5)
    y = g.conv(f"{prefix}/cv3", [p13, p9, p5, cv2], 1)
    return g.conv(f"{prefix}/out", [y, cv1], 1)


def _tiny_trunk(g, x):
    """Mirror of ``YOLOv7.trunk`` from the P2 feature to the three head
    taps. Returns (o3, o4, o5) QTs."""
    x = _elan(g, "elan1", x)
    x = g.pool2(x)                                   # P3/8
    p3 = _elan(g, "elan2", x)
    x = g.pool2(p3)                                  # P4/16
    p4 = _elan(g, "elan3", x)
    x = g.pool2(p4)                                  # P5/32
    p5 = _elan(g, "elan4", x)

    spp = _sppcspc_tiny(g, "sppcspc", p5)
    x = g.conv("up4_cv", spp, 1)
    x = g.up2(x)
    r4 = g.conv("route4", p4, 1)
    f4 = _elan(g, "head_elan4", [r4, x])
    x = g.conv("up3_cv", f4, 1)
    x = g.up2(x)
    r3 = g.conv("route3", p3, 1)
    f3 = _elan(g, "head_elan3", [r3, x])
    x = g.conv("down4_cv", f3, 3, stride=2)
    f4b = _elan(g, "pan_elan4", [x, f4])
    x = g.conv("down5_cv", f4b, 3, stride=2)
    f5b = _elan(g, "pan_elan5", [x, spp])
    o3 = g.conv("out3", f3, 3)
    o4 = g.conv("out4", f4b, 3)
    o5 = g.conv("out5", f5b, 3)
    return o3, o4, o5


def _elan_base(g, prefix: str, x, head: bool = False):
    """yolov7-base ELAN (models/yolov7.py): 4 chained 3×3 off cv2;
    backbone taps [m4,m2,cv2,cv1], head ('ELAN-H') taps all six."""
    cv1 = g.conv(f"{prefix}/cv1", x, 1)
    cv2 = g.conv(f"{prefix}/cv2", x, 1)
    m = cv2
    ms = []
    for i in range(4):
        m = g.conv(f"{prefix}/m{i + 1}", m, 3)
        ms.append(m)
    taps = ([ms[3], ms[2], ms[1], ms[0], cv2, cv1] if head
            else [ms[3], ms[1], cv2, cv1])
    return g.conv(f"{prefix}/out", taps, 1)


def _mpconv(g, prefix: str, x):
    """yolov7-base MP downsample: maxpool and strided-conv branches,
    deferred concat [conv, pool]."""
    a = g.conv(f"{prefix}/pool_cv", g.pool2(x), 1)
    b = g.conv(f"{prefix}/pre_cv", x, 1)
    b = g.conv(f"{prefix}/down_cv", b, 3, stride=2)
    return [b, a]


def _sppcspc_base(g, prefix: str, x):
    """yolov7-base SPPCSPC: parallel 5/9/13 pools."""
    cv1 = g.conv(f"{prefix}/cv1", x, 1)
    cv3 = g.conv(f"{prefix}/cv3", cv1, 3)
    cv4 = g.conv(f"{prefix}/cv4", cv3, 1)
    pools = [cv4, g.pool_same(cv4, 5), g.pool_same(cv4, 9),
             g.pool_same(cv4, 13)]
    y1 = g.conv(f"{prefix}/cv5", pools, 1)
    y1 = g.conv(f"{prefix}/cv6", y1, 3)
    y2 = g.conv(f"{prefix}/cv2", x, 1)
    return g.conv(f"{prefix}/cv7", [y1, y2], 1)


def _v7base_trunk(g, x):
    """Mirror of ``YOLOv7._base_trunk`` from the P2 feature (stem3 output)
    through the RepConv deploy convs. Returns (o3, o4, o5) QTs."""
    x = _elan_base(g, "elan1", x)
    x = _mpconv(g, "mp3", x)                         # P3/8
    p3 = _elan_base(g, "elan2", x)
    x = _mpconv(g, "mp4", p3)                        # P4/16
    p4 = _elan_base(g, "elan3", x)
    x = _mpconv(g, "mp5", p4)                        # P5/32
    p5 = _elan_base(g, "elan4", x)

    spp = _sppcspc_base(g, "sppcspc", p5)
    x = g.conv("up4_cv", spp, 1)
    x = g.up2(x)
    r4 = g.conv("route4", p4, 1)
    f4 = _elan_base(g, "head_elan4", [r4, x], head=True)
    x = g.conv("up3_cv", f4, 1)
    x = g.up2(x)
    r3 = g.conv("route3", p3, 1)
    f3 = _elan_base(g, "head_elan3", [r3, x], head=True)
    a = g.conv("pan4_pool_cv", g.pool2(f3), 1)
    b = g.conv("pan4_pre_cv", f3, 1)
    b = g.conv("pan4_down_cv", b, 3, stride=2)
    f4b = _elan_base(g, "pan_elan4", [b, a, f4], head=True)
    a = g.conv("pan5_pool_cv", g.pool2(f4b), 1)
    b = g.conv("pan5_pre_cv", f4b, 1)
    b = g.conv("pan5_down_cv", b, 3, stride=2)
    f5b = _elan_base(g, "pan_elan5", [b, a, spp], head=True)
    o3 = g.conv("rep3", f3, 3)       # RepConv deploy: conv+bias, no BN
    o4 = g.conv("rep4", f4b, 3)
    o5 = g.conv("rep5", f5b, 3)
    return o3, o4, o5


def _c2f(g, prefix: str, x, n: int, shortcut: bool):
    """C2f (models/yolov8.py): split cv1 in two, n chained e=1.0
    bottlenecks tapping the running tail, concat all, cv2."""
    y = g.conv(f"{prefix}/cv1", x, 1)
    y1, y2 = g.split2(y)
    ys = [y1, y2]
    for i in range(n):
        m = g.conv(f"{prefix}/m{i}/cv1", ys[-1], 3)
        m = g.conv(f"{prefix}/m{i}/cv2", m, 3)
        if shortcut:                      # e=1.0 ⇒ channels always match
            m = g.add(f"{prefix}/m{i}", m, ys[-1])
        ys.append(m)
    return g.conv(f"{prefix}/cv2", ys, 1)


def _sppf(g, prefix: str, x):
    y = g.conv(f"{prefix}/cv1", x, 1)
    p1 = g.pool_same(y, 5)
    p2 = g.pool_same(p1, 5)
    p3 = g.pool_same(p2, 5)
    return g.conv(f"{prefix}/cv2", [y, p1, p2, p3], 1)


def _v8_trunk(g, x, depth: float):
    """Mirror of ``YOLOv8.trunk`` from the P2 feature, through the head's
    ConvBN towers. Returns per level (box_feat, cls_feat) QTs, ready for
    the f32 output convs."""
    from aerial_image_recognition_tpu_torch.models.yolov8 import _n
    x = _c2f(g, "c2f1", x, _n(3, depth), True)
    x = g.conv("down3", x, 3, stride=2)                       # P3/8
    p3 = _c2f(g, "c2f2", x, _n(6, depth), True)
    x = g.conv("down4", p3, 3, stride=2)                      # P4/16
    p4 = _c2f(g, "c2f3", x, _n(6, depth), True)
    x = g.conv("down5", p4, 3, stride=2)                      # P5/32
    x = _c2f(g, "c2f4", x, _n(3, depth), True)
    p5 = _sppf(g, "sppf", x)

    f4 = _c2f(g, "fpn4", [g.up2(p5), p4], _n(3, depth), False)
    f3 = _c2f(g, "fpn3", [g.up2(f4), p3], _n(3, depth), False)
    x = g.conv("pan_down4", f3, 3, stride=2)
    f4b = _c2f(g, "pan4", [x, f4], _n(3, depth), False)
    x = g.conv("pan_down5", f4b, 3, stride=2)
    f5b = _c2f(g, "pan5", [x, p5], _n(3, depth), False)

    outs = []
    for i, f in enumerate((f3, f4b, f5b)):
        b = g.conv(f"detect/box{i}_cv1", f, 3)
        b = g.conv(f"detect/box{i}_cv2", b, 3)
        c = g.conv(f"detect/cls{i}_cv1", f, 3)
        c = g.conv(f"detect/cls{i}_cv2", c, 3)
        outs.append((b, c))
    return outs


def _xunet_trunk(g, x):
    """Mirror of ``XUnet.trunk`` from the enc0/cv1 feature to the dec3
    output (relu everywhere, so every conv folds its requantization into
    the epilogue constants; pools and upsamples pass int8 through; the
    skip concats ride the producer-scale folding like every other concat).
    mask_out stays f32 in the bundle."""
    skips = []
    x = g.conv("enc0/cv2", x, 3)
    skips.append(x)
    x = g.pool2(x)
    for i in (1, 2, 3):
        x = g.conv(f"enc{i}/cv1", x, 3)
        x = g.conv(f"enc{i}/cv2", x, 3)
        skips.append(x)
        x = g.pool2(x)
    x = g.conv("bottleneck/cv1", x, 3)
    x = g.conv("bottleneck/cv2", x, 3)
    for i in range(4):
        x = g.up2(x)
        x = g.conv(f"up{i}", x, 1)
        x = g.conv(f"dec{i}/cv1", [x, skips[3 - i]], 3)
        x = g.conv(f"dec{i}/cv2", x, 3)
    return x


class _Prepare:
    """Walks the trunk graph building qparams (numpy) from the f32 flax-
    format variables + calibration scales. Raises on any channel-count
    mismatch between the transcription and the checkpoint."""

    def __init__(self, variables, absmax: Dict[str, float],
                 bn_eps: float = 1e-5, act: str = "leaky"):
        self.p = variables["params"]
        self.stats = variables["batch_stats"]
        self.absmax = absmax
        self.bn_eps = bn_eps
        self.act = act
        self.qparams: Dict[str, Any] = {}
        # static per-tensor coding scales, keyed like qparams — _Run needs
        # them as python constants (residual adds, head dequant)
        self.scales: Dict[str, float] = {}

    def _node(self, tree, name):
        for part in name.split("/"):
            tree = tree[part]
        return tree

    def _s_out(self, name):
        if name not in self.absmax:
            raise KeyError(f"no calibration record for {name}")
        return max(self.absmax[name], 1e-12) / 127.0

    def conv(self, name, x, kernel, stride=1):
        parts = x if isinstance(x, list) else [x]
        node = self._node(self.p, name)
        k = np.asarray(node["conv"]["kernel"], np.float32)   # HWIO
        if "bn" in node:
            stats = self._node(self.stats, name)["bn"]
            gamma = np.asarray(node["bn"]["scale"], np.float32)
            beta = np.asarray(node["bn"]["bias"], np.float32)
            mean = np.asarray(stats["mean"], np.float32)
            var = np.asarray(stats["var"], np.float32)
            g = gamma / np.sqrt(var + self.bn_eps)
            wf = k * g                                        # O is last
            bf = beta - mean * g
        else:
            # BN-less ConvBN (e.g. yolov7-base RepConv deploy form): plain
            # conv + bias, same epilogue otherwise. copy(): the scale fold
            # below mutates wf in place
            wf = k.copy()
            bf = np.asarray(node["conv"].get(
                "bias", np.zeros(k.shape[-1])), np.float32)
        if k.shape[0] != kernel or sum(p.c for p in parts) != k.shape[2]:
            raise ValueError(
                f"{name}: transcription/checkpoint mismatch — kernel "
                f"{k.shape} vs k={kernel}, in_c={sum(p.c for p in parts)}")
        # fold each producer's coding scale into its kernel slice: the int8
        # concat then needs no runtime rescale
        off = 0
        for p in parts:
            wf[:, :, off:off + p.c, :] *= p.s
            off += p.c
        o = k.shape[3]
        w8, sw = _pcq(wf)
        s_out = self._s_out(name)
        if self.act in ("leaky", "relu"):
            # leaky/relu(a·t) = a·leaky/relu(t), a>0 ⇒ fold 1/s_out into m, b
            qp = {"w8": w8,
                  "m": (sw / s_out).astype(np.float32),
                  "b": (bf / s_out).astype(np.float32)}
        else:
            # silu is not homogeneous: requant divide stays a separate
            # multiply after the activation
            qp = {"w8": w8,
                  "m": sw.astype(np.float32),
                  "b": bf.astype(np.float32),
                  "inv": np.float32(1.0 / s_out)}
        self.qparams[name] = qp
        self.scales[name] = s_out
        return QT(None, s_out, o)

    def add(self, key, y, x):
        """Residual add (v8 Bottleneck): output coded at the calibrated
        scale of the enclosing module's output."""
        assert y.c == x.c, (key, y.c, x.c)
        s = self._s_out(key)
        self.scales[key] = s
        return QT(None, s, y.c)

    def split2(self, x):
        assert x.c % 2 == 0
        return QT(None, x.s, x.c // 2), QT(None, x.s, x.c // 2)

    def pool2(self, x):
        return x          # value-preserving ⇒ scale/channels unchanged

    def pool_same(self, x, k):
        return x

    def up2(self, x):
        return x


def _prune_orig(variables, keep):
    """Drop the trunk weights from the flax-format tree a quantized bundle
    carries — the int8 graph reads only the stems and the f32 heads:
    yolov7's ``detect0``–``detect2``, of yolov8's ``detect`` subtree
    the six ``*_out`` convs (its towers run int8), and XUnet's ``enc0``. Without this the unused
    float trunk would ride along with the int8 kernels."""
    params = {k: v for k, v in variables["params"].items() if k in keep}
    if "detect" in params:
        params["detect"] = {k: v for k, v in params["detect"].items()
                            if k.endswith("_out")}
    return {
        "params": params,
        "batch_stats": {k: v for k, v in
                        variables.get("batch_stats", {}).items()
                        if k in keep and k != "detect"},
    }


def _family_meta(spec, arch: str):
    """Stem scopes / strides / activation / BN eps per family; ``arch`` is
    the yolov7 variant ('tiny', 'base') or the yolov8 scale."""
    if spec.family == "yolov8":
        return {"stems": ("stem", "down2"), "act": "silu", "bn_eps": 1e-3,
                "strides": (2, 2)}
    if spec.family != "yolov7":
        raise NotImplementedError(
            f"no int8 detector lowering for the {spec.family} family")
    if arch == "base":
        return {"stems": ("stem0", "stem1", "stem2", "stem3"),
                "act": "silu", "bn_eps": 1e-5, "strides": (1, 2, 1, 2)}
    return {"stems": ("stem0", "stem1"), "act": "leaky", "bn_eps": 1e-5,
            "strides": (2, 2)}


def _arch_of(spec, params) -> str:
    """The yolov7 variant or the yolov8 scale of a flax-format tree: base
    has four stems; each yolov8 scale has its own stem width."""
    if spec.family == "yolov8":
        from aerial_image_recognition_tpu_torch.models.yolov8 import (
            SCALES, widths)
        c1 = np.shape(params["stem"]["conv"]["kernel"])[-1]
        return next(sc for sc in SCALES if widths(sc)[0] == c1)
    return "base" if "stem3" in params else "tiny"


def save_absmax(path: str, absmax: Dict[str, float]) -> None:
    """Persist a calibration (plain JSON): calibrate once on representative
    imagery, reuse for every later run via cfg.extra['quantize_calib']."""
    with open(path, "w") as f:
        json.dump(absmax, f, indent=1, sort_keys=True)


def load_absmax(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}


def qparams_from_jax(q, static_scales) -> Dict[str, Any]:
    """The reference's ``Int8Bundle.params["q"]`` (or
    ``Int8XUnetBundle.params["q"]``) and ``static_scales`` → the numpy
    ``q`` dictionary ``Int8Bundle.from_q`` (``Int8XUnetBundle.from_q``)
    takes, so that both trunks can run on identical qparams. Leaves may be
    numpy or anything ``np.asarray`` takes; the quad-stem entry
    (``q["stems"]``) comes across too."""
    scales = {k: float(v) for k, v in static_scales.items()}
    if "mask_kernel" in q:
        return {"convs": _convs_from_jax(q["convs"]),
                "mask_kernel": np.asarray(q["mask_kernel"], np.float32),
                "mask_bias": np.asarray(q["mask_bias"], np.float32),
                "scales": scales}
    out = {"p2_scale": np.float32(q["p2_scale"]),
           "convs": _convs_from_jax(q["convs"]),
           "out_scales": [np.float32(s) for s in q.get("out_scales", [])],
           "scales": scales}
    if "stems" in q:
        out["stems"] = {k: np.asarray(v, np.int8 if k in ("w0", "w1")
                                      else np.float32)
                        for k, v in q["stems"].items()}
    return out


def _convs_from_jax(jconvs) -> Dict[str, Any]:
    convs = {}
    for name, qp in jconvs.items():
        convs[name] = {"w8": np.asarray(qp["w8"], np.int8),
                       "m": np.asarray(qp["m"], np.float32),
                       "b": np.asarray(qp["b"], np.float32)}
        if "inv" in qp:
            convs[name]["inv"] = np.float32(qp["inv"])
    return convs


# ---------------------------------------------------------------------------
# torch half: the exact integer convolution

# an im2col larger than this is made and consumed in batch chunks
IM2COL_MAX_BYTES = 1 << 30


def _pads(kernel: int):
    """(low, high) zero padding of a convolution: ``k//2`` on both sides for
    the odd kernels, ((1,0),(1,0)) for the quad stem's 2×2 ones."""
    return kernel // 2, (kernel - 1) // 2


def _out_size(n: int, kernel: int, stride: int) -> int:
    lo, hi = _pads(kernel)
    return (n + lo + hi - kernel) // stride + 1


def _conv_s32_plain(v: torch.Tensor, w: torch.Tensor, kernel: int,
                    stride: int) -> torch.Tensor:
    """int8 [B,H,W,C] × int32 OIHW kernel → int32 [B,Ho,Wo,O], padded as
    ``_pads`` says: ``F.conv2d`` on int32 tensors (exact integer
    arithmetic), padded ``k//2`` on both sides, of which a 2×2 kernel's
    last row and column (the high side's) are dropped."""
    _, h, wd, _ = v.shape
    r = F.conv2d(v.permute(0, 3, 1, 2).to(torch.int32), w, None, stride,
                 kernel // 2)
    return r[:, :, :_out_size(h, kernel, stride),
             :_out_size(wd, kernel, stride)].permute(0, 2, 3, 1)


def _wide(v: torch.Tensor) -> torch.Tensor:
    """int8 [..., C] seen as [..., C/8] int64 where the channel count and
    the strides allow it (every trunk shape does), else as it is: a copy of
    such a view moves 8 bytes per element instead of 1, and a strided int8
    copy on the card is bound by its element count, not its bytes."""
    if v.shape[-1] % 8 == 0 and v.stride(-1) == 1 \
            and v.storage_offset() % 8 == 0 \
            and all(st % 8 == 0 for st in v.stride()[:-1]):
        return v.view(torch.int64)
    return v


def _im2col(v: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """int8 [B,H,W,C] → [B,Ho,Wo,k·k·C]: the k·k shifted, strided slices
    of the zero-padded input (``_pads``) side by side, in (dy, dx, c)
    order — the row order of an HWIO kernel reshaped to [k·k·C, O]. Pure
    data movement, so it is done on ``_wide`` views."""
    v = _wide(v)
    b, h, w, c = v.shape
    lo, hi = _pads(kernel)
    ho, wo = _out_size(h, kernel, stride), _out_size(w, kernel, stride)
    vp = v.new_zeros((b, h + lo + hi, w + lo + hi, c))
    vp[:, lo:lo + h, lo:lo + w] = v
    return torch.cat(
        [vp[:, dy:dy + stride * (ho - 1) + 1:stride,
            dx:dx + stride * (wo - 1) + 1:stride]
         for dy in range(kernel) for dx in range(kernel)],
        dim=-1).view(torch.int8)


def _conv_s32_card(v: torch.Tensor, w: torch.Tensor, kernel: int,
                   stride: int) -> torch.Tensor:
    """int8 [B,H,W,C] × int8 [k·k·C, O] kernel matrix → int32 [B,Ho,Wo,O]
    by ``torch._int_mm`` (s8×s8→s32 on the tensor cores)."""
    cols = v if kernel == 1 and stride == 1 else _im2col(v, kernel, stride)
    b, ho, wo, k = cols.shape
    return torch._int_mm(cols.reshape(b * ho * wo, k), w) \
        .reshape(b, ho, wo, w.shape[1])


def conv_s32(v: torch.Tensor, w: torch.Tensor, kernel: int,
             stride: int = 1) -> torch.Tensor:
    """The exact s8×s8→s32 convolution, padded ``k//2`` (odd kernels) or
    ((1,0),(1,0)) (the quad stem's 2×2 kernels). ``w`` is the kernel
    as ``device_kernel`` made it for ``v``'s device. A CPU tensor takes the
    plain version; a CUDA tensor takes ``torch._int_mm`` or raises."""
    if v.dtype != torch.int8 or v.dim() != 4:
        raise ValueError(f"conv_s32: int8 [B,H,W,C] expected, got "
                         f"{v.dtype} {tuple(v.shape)}")
    if v.device.type == "cpu":
        return _conv_s32_plain(v, w, kernel, stride)
    if v.device.type != "cuda":
        raise ValueError(f"conv_s32: no integer product for {v.device}")
    return _conv_s32_card(v, w, kernel, stride)


def device_kernel(w8: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int8 HWIO kernel (after ``_pcq``) in the layout ``conv_s32``
    wants on ``device``: int32 OIHW on the CPU; on the card the int8 matrix
    [k·k·I, O] with rows in (dy, dx, c) order, stored column-major (the
    transposed view of a contiguous [O, k·k·I]), as cuBLASLt takes it."""
    w8 = np.asarray(w8, np.int8)
    if device.type == "cpu":
        return torch.from_numpy(
            np.ascontiguousarray(w8.transpose(3, 2, 0, 1)).astype(np.int32))
    o = w8.shape[3]
    return torch.from_numpy(np.ascontiguousarray(
        w8.reshape(-1, o).T)).to(device).t()


def _f32_on(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _device_convs(convs, device: torch.device) -> Dict[str, Any]:
    """``_Prepare``'s numpy qparams → what ``_Run`` reads on ``device``:
    the kernel as ``device_kernel`` makes it, ``m`` and ``b`` as f32
    tensors, ``inv`` (silu) as a host number, which the epilogue takes as
    an argument."""
    out = {}
    for name, qp in convs.items():
        out[name] = {"w": device_kernel(qp["w8"], device),
                     "m": _f32_on(qp["m"], device),
                     "b": _f32_on(qp["b"], device)}
        if "inv" in qp:
            out[name]["inv"] = float(np.float32(qp["inv"]))
    return out


def _device_stems(stems, device: torch.device) -> Dict[str, Any]:
    """``_quantize_stems``' numpy constants → what ``_stems_int8`` reads on
    ``device``: both kernels as ``device_kernel`` makes them, ``m``, ``b``
    and ``corr`` as f32 tensors, ``inv0``/``inv1`` (silu) as host
    numbers."""
    out = {k: device_kernel(stems[k], device) for k in ("w0", "w1")}
    for k in ("m0", "b0", "corr", "m1", "b1"):
        out[k] = _f32_on(stems[k], device)
    for k in ("inv0", "inv1"):
        if k in stems:
            out[k] = float(np.float32(stems[k]))
    return out


class _Run:
    """Executes the trunk graph on int8 NHWC tensors with prepared qparams
    (``w`` as ``device_kernel`` made it, ``m``, ``b`` as tensors on the
    same device, ``inv`` a python float). QT.s stays populated: scales are static per bundle."""

    def __init__(self, qparams, act: str = "leaky",
                 scales: Optional[Dict[str, float]] = None):
        self.q = qparams
        self.act = act
        self.scales = scales or {}

    def conv(self, name, x, kernel, stride=1):
        parts = x if isinstance(x, list) else [x]
        v = (parts[0].v if len(parts) == 1
             else torch.cat([p.v for p in parts], dim=-1))
        qp = self.q[name]
        b, h, w, c = v.shape
        # a large im2col (the TTA ladder's 512 images) is made and consumed
        # in batch chunks; every image's result is its own either way
        rows = b
        if kernel > 1:
            per_image = max(1, h * w * c * kernel * kernel // stride ** 2)
            rows = max(1, min(b, IM2COL_MAX_BYTES // per_image))
        outs = [requantize(conv_s32(v[i:i + rows], qp["w"], kernel, stride),
                           qp["m"], qp["b"], qp.get("inv"), self.act)
                for i in range(0, b, rows)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        return QT(out, self.scales.get(name, 0.0), out.shape[-1])

    def add(self, key, y, x):
        s_m = self.scales[key]
        t = y.v.to(torch.float32) * y.s + x.v.to(torch.float32) * x.s
        # a 0-dim divisor keeps this a true division on the card
        t = t / torch.full((), s_m, dtype=torch.float32, device=t.device)
        out = t.round_().clamp_(-127, 127).to(torch.int8)
        return QT(out, s_m, y.c)

    def split2(self, x):
        a, b = torch.chunk(x.v, 2, dim=-1)
        return QT(a, x.s, a.shape[-1]), QT(b, x.s, b.shape[-1])

    def pool2(self, x):
        """2×2 stride-2 VALID max pool: the maximum of the four strided
        slices (elementwise, so int8 stays int8 on any device)."""
        v = x.v
        h2, w2 = v.shape[1] // 2 * 2, v.shape[2] // 2 * 2
        out = torch.maximum(
            torch.maximum(v[:, 0:h2:2, 0:w2:2], v[:, 0:h2:2, 1:w2:2]),
            torch.maximum(v[:, 1:h2:2, 0:w2:2], v[:, 1:h2:2, 1:w2:2]))
        return replace(x, v=out)

    def pool_same(self, x, k):
        """k×k stride-1 SAME max pool, separable: running maxima of k
        shifted slices along H, then along W. The border pads with −128,
        below every code (codes are clipped to ±127)."""
        v = x.v
        _, h, w, _ = v.shape
        p = k // 2
        vp = F.pad(v, (0, 0, 0, 0, p, p), value=-128)
        rows = vp[:, 0:h]
        for d in range(1, k):
            rows = torch.maximum(rows, vp[:, d:d + h])
        vp = F.pad(rows, (0, 0, p, p), value=-128)
        out = vp[:, :, 0:w]
        for d in range(1, k):
            out = torch.maximum(out, vp[:, :, d:d + w])
        return replace(x, v=out)

    def up2(self, x):
        """2× nearest-neighbour upsample."""
        b, h, w, c = x.v.shape
        out = x.v[:, :, None, :, None, :].expand(b, h, 2, w, 2, c) \
            .reshape(b, 2 * h, 2 * w, c)
        return replace(x, v=out)


# ---------------------------------------------------------------------------
# the fully-int8 quad stem


def _stem_consts(w0, b0, w1, b1, s0: float, p2s: float,
                 act: str) -> Dict[str, Any]:
    """The fully-int8 quad stem's constants from the folded f32 stems
    (``ops/quadstem.fold_convbn``) and the coding scales of stem0's output
    (``s0``) and of P2 (``p2s``), numpy as the reference makes them.

    The uint8 s2d² input shifts to int8 exactly, so stem0's only
    quantization loss is its weights. The shift makes the zero padding
    stand for pixel 128 instead of the black pixels the float path pads
    with; a per-channel border term from partial sums of the float kernel
    repairs it. With low-side-only cell padding there are four cases
    (interior, top row, left column, corner):
        corr(y,x) = S − [y=0]·Su0 − [x=0]·Sv0 + [y=0,x=0]·Suv
    entering between ``t·m0`` and ``b0``, already scaled by 128/(255·s0)
    (leaky) or 128/255 (silu). Stem1 pads int8 zeros, which are activation
    0.0: exact under symmetric quantization, like every trunk conv."""
    from aerial_image_recognition_tpu_torch.ops.quadstem import (
        quad_kernel_transform, s2d_kernel_transform)
    w0q = np.asarray(quad_kernel_transform(w0), np.float32)  # [2,2,48,4c0]
    w1q = np.asarray(s2d_kernel_transform(w1), np.float32)   # [2,2,4c0,c1]
    b0q = np.tile(np.asarray(b0, np.float32), 4)
    w08, sw0 = _pcq(w0q)
    w18, sw1 = _pcq(w1q)
    # partial sums of the float kernel over (u,v) tap subsets, channels in
    k_sum = w0q.sum(axis=2)                       # [2,2,O]
    sums = np.stack([k_sum.sum(axis=(0, 1)), k_sum[0].sum(axis=0),
                     k_sum[:, 0].sum(axis=0), k_sum[0, 0]])
    if act == "leaky":
        # homogeneity folds the requantize divisions into every constant
        return {"w0": w08, "m0": sw0 / (255.0 * s0), "b0": b0q / s0,
                "corr": sums * (128.0 / (255.0 * s0)),
                "w1": w18, "m1": sw1 * s0 / p2s,
                "b1": np.asarray(b1, np.float32) / p2s}
    # silu: the constants stay in activation units; the requantize
    # divisions are multiplications after the activation
    return {"w0": w08, "m0": sw0 / 255.0, "b0": b0q,
            "corr": sums * (128.0 / 255.0), "inv0": np.float32(1.0 / s0),
            "w1": w18, "m1": sw1 * s0, "b1": np.asarray(b1, np.float32),
            "inv1": np.float32(1.0 / p2s)}


def _quantize_stems(variables, absmax: Dict[str, float], bn_eps=1e-5,
                    stem_names=("stem0", "stem1"),
                    act="leaky") -> Dict[str, Any]:
    """The fully-int8 quad stem of a flax-format f32 tree and a calibration
    (``_stem_consts``); the folds are ``ops/quadstem.fold_convbn``'s."""
    from aerial_image_recognition_tpu_torch.ops.quadstem import fold_convbn
    p, st = variables["params"], variables["batch_stats"]
    n0, n1 = stem_names
    w0, b0 = fold_convbn(p[n0], st[n0], eps=bn_eps)
    w1, b1 = fold_convbn(p[n1], st[n1], eps=bn_eps)
    if n0 not in absmax or n1 not in absmax:
        raise KeyError(f"no calibration record for {n0} or {n1}")
    return _stem_consts(w0, b0, w1, b1, max(absmax[n0], 1e-12) / 127.0,
                        max(absmax[n1], 1e-12) / 127.0, act)


def _stems_int8(sq, xq: torch.Tensor, act: str = "leaky") -> torch.Tensor:
    """uint8 s2d² batch [B,H/4,W/4,48] → the P2 feature's int8 codes
    [B,H/4,W/4,c1] (the trunk's coding), from ``_device_stems``' ``sq``:
    two integer products and two epilogue launches, the first in border
    mode."""
    x8 = torch.bitwise_xor(xq, 128).view(torch.int8)
    h1 = requantize(conv_s32(x8, sq["w0"], 2), sq["m0"], sq["b0"],
                    sq.get("inv0"), act, corr=sq["corr"])
    return requantize(conv_s32(h1, sq["w1"], 2), sq["m1"], sq["b1"],
                      sq.get("inv1"), act)


# ---------------------------------------------------------------------------
# stems (bundle dtype) + heads (f32) around the int8 trunk


class _Ends(nn.Module):
    """What a quantized detector keeps in floating point: its stem ConvBNs
    (tiny: stem0–1; base: stem0–3, strides 1, 2, 1, 2; yolov8: stem and
    down2) and its f32 heads (yolov7: detect0–2; yolov8:
    ``detect.{box,cls}{i}_out``). Built from the shapes of the pruned flax
    tree, with the submodule names of the full model, so the weight bridge
    loads that tree."""

    def __init__(self, family: str, arch: str, tree, meta):
        super().__init__()
        from aerial_image_recognition_tpu_torch.models.layers import ConvBN
        self.family = family
        self.stem_names = meta["stems"]
        if family == "yolov8":
            self.scale = arch
        else:
            self.variant = arch
        p = tree["params"]
        for name, stride in zip(meta["stems"], meta["strides"]):
            kh, _, c_in, c_out = np.shape(p[name]["conv"]["kernel"])
            setattr(self, name, ConvBN(c_in, c_out, kh, stride,
                                       act=meta["act"],
                                       bn_eps=meta["bn_eps"]))

        def linear(node):
            _, _, c_in, c_out = np.shape(node["kernel"])
            return nn.Linear(c_in, c_out)

        if family == "yolov8":
            self.detect = nn.Module()
            self._heads = [f"{kind}{i}_out" for i in range(3)
                           for kind in ("box", "cls")]
            for name in self._heads:
                setattr(self.detect, name, linear(p["detect"][name]))
        else:
            for i in range(3):
                setattr(self, f"detect{i}", linear(p[f"detect{i}"]))

    @property
    def anchors(self):
        from aerial_image_recognition_tpu_torch.models.yolov7 import (
            ANCHORS_BASE, ANCHORS_TINY)
        return ANCHORS_BASE if self.variant == "base" else ANCHORS_TINY

    def heads(self) -> List[nn.Linear]:
        """yolov7: the three detect heads; yolov8: the six output convs,
        (box, cls) per level."""
        if self.family == "yolov8":
            return [getattr(self.detect, n) for n in self._heads]
        return [self.detect0, self.detect1, self.detect2]

    def stems(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,3,S,S] → the P2 feature [B,C,S/4,S/4]."""
        for name in self.stem_names:
            x = getattr(self, name)(x)
        return x


def _module_dtype(module: nn.Module) -> torch.dtype:
    """The dtype of a module's first convolution (its stem)."""
    return next(m.weight.dtype for m in module.modules()
                if isinstance(m, nn.Conv2d))


@dataclass
class Int8Bundle:
    """Drop-in for ``models.registry.ModelBundle`` (same ``forward``
    contract) with the detector trunk quantized (yolov7-tiny, yolov7-base
    or yolov8 n–x).

    ``module`` holds the stems and the f32 heads only (no float trunk on
    the device); ``q`` the int8 kernels and epilogue constants as
    tensors on ``device``; ``params`` the host-side numpy mirror
    ``{"orig": pruned flax-format tree, "q": …}`` the device tensors were
    made from; ``static_scales`` the per-tensor coding scales (python
    floats, keyed like the convs, plus ``__p2__``); ``absmax`` the
    calibration table it was quantized with, where known (``save_absmax``
    persists it: a self-calibrated step can be rebuilt from the file).
    ``q["stems"]`` holds the fully-int8 quad stem's constants where the
    family has the lowering; ``quad`` is the float quad stem
    (``ops/quadstem.QuadStem``), built at its first use."""
    spec: Any
    module: nn.Module
    device: torch.device
    q: Dict[str, Any]
    params: Dict[str, Any]
    static_scales: Dict[str, float]
    absmax: Optional[Dict[str, float]] = None
    quad: Any = field(default=None, repr=False)

    @classmethod
    def from_q(cls, spec, variables, q, *, dtype: torch.dtype,
               device: torch.device,
               absmax: Optional[Dict[str, float]] = None) -> "Int8Bundle":
        """Build from flax-format f32 ``variables`` (only the stems and the
        heads are read; the variant or scale is read off their shapes) and
        a numpy ``q`` dictionary (``_Prepare``'s ``convs``, ``p2_scale``,
        ``out_scales`` for yolov7, ``scales``, and ``_quantize_stems``'
        ``stems`` where the family has the quad stem)."""
        from aerial_image_recognition_tpu_torch.models.layers import (
            fold_batchnorm)
        from aerial_image_recognition_tpu_torch.models.weights import (
            load_flax_into)
        device = torch.device(device)
        arch = _arch_of(spec, variables["params"])
        meta = _family_meta(spec, arch)
        keep = set(meta["stems"]) | {"detect", "detect0", "detect1",
                                     "detect2"}
        orig = _prune_orig(variables, keep)
        module = _Ends(spec.family, arch, orig, meta)
        load_flax_into(module, orig)
        module.eval()
        fold_batchnorm(module)
        module.requires_grad_(False)
        for name in meta["stems"]:
            getattr(module, name).to(dtype)
        module.to(device=device, memory_format=torch.channels_last)

        dq = {"convs": _device_convs(q["convs"], device),
              "p2_scale": _f32_on(q["p2_scale"], device),
              "out_scales": [float(np.float32(s))
                             for s in q.get("out_scales", [])]}
        if "stems" in q:
            dq["stems"] = _device_stems(q["stems"], device)
        scales = dict(q["scales"])
        host_q = {k: v for k, v in q.items() if k != "scales"}
        return cls(spec=spec, module=module, device=device, q=dq,
                   params={"orig": orig, "q": host_q}, static_scales=scales,
                   absmax=None if absmax is None else dict(absmax))

    def _s2d2_meta(self) -> Optional[Dict]:
        from aerial_image_recognition_tpu_torch.ops.quadstem import stem_meta
        return stem_meta(self.spec.family,
                         getattr(self.module, "variant", ""))

    def supports_s2d2(self) -> bool:
        """The standard stems of yolov7-tiny and yolov8 by construction;
        yolov7-base's four-conv stem (strides 1, 2, 1, 2) has no quad-stem
        lowering."""
        return self._s2d2_meta() is not None

    def to(self, device) -> "Int8Bundle":
        """A replica on ``device`` (a data-parallel shard's) carrying only
        what the int8 graph reads: a copy of the stems and heads, and the
        qparams made there from the host mirror, as ``from_q`` makes them;
        the host mirror is shared."""
        import copy
        device = torch.device(device)
        hq = self.params["q"]
        dq = {"convs": _device_convs(hq["convs"], device),
              "p2_scale": _f32_on(hq["p2_scale"], device),
              "out_scales": list(self.q["out_scales"])}
        if "stems" in hq:
            dq["stems"] = _device_stems(hq["stems"], device)
        return replace(self, module=copy.deepcopy(self.module).to(device),
                       device=device, q=dq,
                       quad=self.quad and self.quad.to(device))

    def _p2_quantize(self, p2: torch.Tensor) -> torch.Tensor:
        """P2 [B,C,H,W] float → int8 codes [B,H,W,C]; a true division by
        the 0-dim scale tensor (never a reciprocal multiplication)."""
        t = p2.permute(0, 2, 3, 1).to(torch.float32) / self.q["p2_scale"]
        return t.round_().clamp_(-127, 127).to(torch.int8).contiguous()

    def trunk_codes(self, p2_i8: torch.Tensor, g: Optional[_Run] = None):
        """int8 P2 codes → the int8 head taps (QTs): yolov7's three
        (o3, o4, o5); yolov8's six tower outputs, box then cls per level.
        ``g`` runs the graph (default: a ``_Run`` over this bundle's
        qparams, with the family's activation)."""
        x = QT(p2_i8, self.static_scales["__p2__"], p2_i8.shape[-1])
        g = g or _Run(self.q["convs"], act=self.act,
                      scales=self.static_scales)
        if self.spec.family == "yolov8":
            from aerial_image_recognition_tpu_torch.models.yolov8 import (
                SCALES)
            pairs = _v8_trunk(g, x, SCALES[self.module.scale][0])
            return tuple(t for pair in pairs for t in pair)
        if self.module.variant == "base":
            return _v7base_trunk(g, x)
        return _tiny_trunk(g, x)

    @property
    def act(self) -> str:
        """The trunk's activation: leaky for yolov7-tiny, else silu."""
        return "leaky" if getattr(self.module, "variant", "") == "tiny" \
            else "silu"

    def _raw_from_p2_i8(self, p2_i8: torch.Tensor) -> List[torch.Tensor]:
        """int8 trunk + f32 heads → the three raw NHWC maps."""
        return self.raw_from_taps(self.trunk_codes(p2_i8))

    def raw_from_taps(self, taps) -> List[torch.Tensor]:
        """The f32 heads over the trunk's int8 head taps (QTs) → the three
        raw NHWC maps. A tap's codes are dequantized by its static scale:
        yolov7's by ``out_scales``, yolov8's by the coding scale of the
        tower's last conv."""
        if taps[0].v.is_cuda \
                and torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(
                "the f32 detect heads need full-precision f32 matmuls; "
                "torch.get_float32_matmul_precision() is "
                f"{torch.get_float32_matmul_precision()!r} (TF32) — set it "
                "back to 'highest'")
        heads = self.module.heads()
        if self.spec.family == "yolov8":
            return [torch.cat([heads[i](taps[i].v.to(torch.float32)
                                        * taps[i].s),
                               heads[i + 1](taps[i + 1].v.to(torch.float32)
                                            * taps[i + 1].s)], dim=-1)
                    for i in range(0, 6, 2)]
        return [head(o.v.to(torch.float32) * sc)
                for o, sc, head in zip(taps, self.q["out_scales"], heads)]

    def decode(self, outs: List[torch.Tensor]):
        """The three raw maps → (boxes, scores), by family."""
        from aerial_image_recognition_tpu_torch.ops.decode import (
            decode_yolov7, decode_yolov8)
        if self.spec.family == "yolov8":
            return decode_yolov8(outs, self.spec.num_classes)
        return decode_yolov7(outs, self.module.anchors,
                             self.spec.num_classes)

    def forward(self, images: torch.Tensor):
        """images [B,3,S,S] (/255, any float dtype) → (boxes [B,A,4] cxcywh
        pixels f32, scores [B,A,nc] f32)."""
        p2 = self.module.stems(images.to(_module_dtype(self.module)))
        return self.decode(self._raw_from_p2_i8(self._p2_quantize(p2)))

    def quad_stem(self):
        """The float quad stem over the pruned tree's stems, in the stems'
        dtype on this bundle's device, built once."""
        if self.quad is None:
            from aerial_image_recognition_tpu_torch.ops.quadstem import (
                QuadStem)
            meta = self._s2d2_meta()
            self.quad = QuadStem.from_variables(
                self.params["orig"], stem_names=meta["stems"],
                act=meta["act"], bn_eps=meta["bn_eps"],
                dtype=_module_dtype(self.module), device=self.device)
        return self.quad

    def forward_s2d2(self, xq: torch.Tensor, in_scale=1.0 / 255.0):
        """The quad-stem entry: xq [B,S/4,S/4,48] s2d² (``ops/quadstem``)
        → (boxes, scores) as ``forward``. A uint8 batch at ``in_scale``
        1/255 takes the fully-int8 stems (``_stems_int8``); anything else
        the float quad stem, whose P2 is then quantized."""
        if not self.supports_s2d2():
            raise NotImplementedError(
                "no quad-stem lowering for this stem geometry")
        if (xq.dtype == torch.uint8 and "stems" in self.q
                and in_scale in (None, 1.0 / 255.0)):
            p2_i8 = _stems_int8(self.q["stems"], xq, act=self.act)
        else:
            p2_i8 = self._p2_quantize(self.quad_stem()(xq, in_scale))
        return self.decode(self._raw_from_p2_i8(p2_i8))


class _XUnetEnds(nn.Module):
    """What a quantized XUnet keeps in floating point: the entry conv
    enc0/cv1 (3×3 on the 3-channel image, stride 1) with its BN unfolded
    — the kernel, the BN mean, ``g`` = γ/√(σ²+ε) computed in f32 and the
    BN bias, all in the bundle's dtype — and the f32 ``mask_out`` head,
    whose kernel carries dec3's coding scale."""

    def __init__(self, tree, mask_kernel: np.ndarray, mask_bias: np.ndarray,
                 dtype: torch.dtype, bn_eps: float = 1e-3):
        super().__init__()
        p = tree["params"]["enc0"]["cv1"]
        st = tree["batch_stats"]["enc0"]["cv1"]["bn"]
        k = np.asarray(p["conv"]["kernel"], np.float32)          # HWIO
        gamma = torch.from_numpy(np.array(p["bn"]["scale"], np.float32))
        var = torch.from_numpy(np.array(st["var"], np.float32))
        g = gamma * torch.rsqrt(var + bn_eps)
        self.register_buffer("entry_w", torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(dtype))
        self.register_buffer("entry_mean", torch.from_numpy(
            np.array(st["mean"], np.float32)).to(dtype))
        self.register_buffer("entry_g", g.to(dtype))
        self.register_buffer("entry_bias", torch.from_numpy(
            np.array(p["bn"]["bias"], np.float32)).to(dtype))
        _, _, c_in, c_out = mask_kernel.shape
        self.mask_out = nn.Linear(c_in, c_out)
        with torch.no_grad():
            self.mask_out.weight.copy_(torch.from_numpy(
                np.array(mask_kernel[0, 0].T, np.float32)))
            self.mask_out.bias.copy_(torch.from_numpy(
                np.array(mask_bias, np.float32)))

    def entry(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,3,S,S] → relu((conv(x) − mean)·g + bias) [B,C,S,S] in the
        bundle's dtype, the reference's operation order."""
        t = F.conv2d(x.to(self.entry_w.dtype), self.entry_w, None, 1, 1)
        return torch.relu((t - self.entry_mean[:, None, None])
                          * self.entry_g[:, None, None]
                          + self.entry_bias[:, None, None])


@dataclass
class Int8XUnetBundle:
    """Drop-in for the xunet ``ModelBundle`` (same ``forward`` contract:
    float images in, f32 mask logits out), with every conv between the
    entry and the head int8: enc0/cv1 stays in the bundle's dtype, its
    output is quantized at the calibrated entry scale, the trunk runs on
    int8 codes with the relu epilogue, and the f32 ``mask_out`` reads the
    dec3 codes with their scale folded into its kernel.

    ``module`` holds the entry conv and the head only; ``q`` the int8
    kernels and epilogue constants on ``device``; ``params`` the host
    mirror ``{"orig": the pruned flax-format tree (enc0), "q": …}``;
    ``static_scales`` the coding scales (plus ``__entry__``); ``absmax``
    the calibration it was quantized with, where known."""
    spec: Any
    module: nn.Module
    device: torch.device
    q: Dict[str, Any]
    params: Dict[str, Any]
    static_scales: Dict[str, float]
    absmax: Optional[Dict[str, float]] = None

    @classmethod
    def from_q(cls, spec, variables, q, *, dtype: torch.dtype,
               device: torch.device,
               absmax: Optional[Dict[str, float]] = None
               ) -> "Int8XUnetBundle":
        """Build from flax-format f32 ``variables`` (only enc0/cv1 is
        read) and a numpy ``q`` dictionary (``convs``, ``mask_kernel``
        [1,1,C,1] with dec3's scale folded in, ``mask_bias``, ``scales``)."""
        device = torch.device(device)
        orig = _prune_orig(variables, {"enc0"})
        module = _XUnetEnds(orig, np.asarray(q["mask_kernel"], np.float32),
                            np.asarray(q["mask_bias"], np.float32), dtype)
        module.requires_grad_(False)
        module.to(device)
        host_q = {k: v for k, v in q.items() if k != "scales"}
        return cls(spec=spec, module=module, device=device,
                   q={"convs": _device_convs(q["convs"], device)},
                   params={"orig": orig, "q": host_q},
                   static_scales=dict(q["scales"]),
                   absmax=None if absmax is None else dict(absmax))

    def entry_codes(self, images: torch.Tensor) -> torch.Tensor:
        """images [B,3,S,S] → the entry feature's int8 codes [B,S,S,C]; a
        true division by the 0-dim scale tensor."""
        t = self.module.entry(images).permute(0, 2, 3, 1).to(torch.float32)
        s = torch.full((), self.static_scales["__entry__"],
                       dtype=torch.float32, device=t.device)
        return (t / s).round_().clamp_(-127, 127).to(torch.int8) \
            .contiguous()

    def trunk_codes(self, xi: torch.Tensor, g: Optional[_Run] = None) -> QT:
        """Entry codes → the dec3 output (a QT of int8 codes). ``g`` runs
        the graph (default: a relu ``_Run`` over this bundle's qparams)."""
        g = g or _Run(self.q["convs"], act="relu", scales=self.static_scales)
        return _xunet_trunk(g, QT(xi, self.static_scales["__entry__"],
                                  xi.shape[-1]))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B,3,S,S] (/255, any float dtype) → [B,S,S,1] f32 mask
        logits."""
        if images.is_cuda \
                and torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(
                "the f32 mask head needs full-precision f32 matmuls; "
                "torch.get_float32_matmul_precision() is "
                f"{torch.get_float32_matmul_precision()!r} (TF32) — set it "
                "back to 'highest'")
        out = self.trunk_codes(self.entry_codes(images))
        return self.module.mask_out(out.v.to(torch.float32))


# ---------------------------------------------------------------------------
# calibration and the public entry


def calibrate_absmax(bundle, batches: Sequence[Any],
                     model_size: Optional[int] = None) -> Dict[str, float]:
    """Run the bundle's standard forward over calibration batches, recording
    the absmax of every ConvBN output and every yolov8 Bottleneck output
    (the residual add's scale), keyed by scope ('elan1/cv1', 'c2f1/m0',
    'detect/box0_cv1'). batches: uint8
    [B,S,S,3] arrays (preprocessed here) or float [B,S,S,3] arrays already
    in [0,1] (resized to the model size: activation absmax depends on the
    resolution). Only a running maximum per layer is kept. TF32 is off
    for cuDNN during the calibration forward, so f32 means f32 on the
    card too."""
    from aerial_image_recognition_tpu_torch.models.layers import ConvBN
    from aerial_image_recognition_tpu_torch.models.yolov8 import Bottleneck
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        preprocess_batch, resize)
    size = model_size or bundle.spec.input_size
    module = bundle.module
    running: Dict[str, torch.Tensor] = {}

    def record(key):
        def hook(_m, _inp, out):
            m = out.detach().abs().amax().to(torch.float32)
            running[key] = torch.maximum(running[key], m) \
                if key in running else m
        return hook

    hooks = [m.register_forward_hook(record(name.replace(".", "/")))
             for name, m in module.named_modules()
             if isinstance(m, (ConvBN, Bottleneck))]
    # cuDNN runs f32 convolutions in TF32 by default (operands rounded to
    # 10 mantissa bits); an f32 calibration on the card is taken in f32
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            for imgs in batches:
                x = imgs if isinstance(imgs, torch.Tensor) \
                    else torch.from_numpy(np.ascontiguousarray(imgs))
                x = x.to(bundle.device)
                if x.dtype == torch.uint8:
                    x = preprocess_batch(x, out_size=size,
                                         dtype=torch.float32)
                else:
                    x = x.to(torch.float32).permute(0, 3, 1, 2)
                    if x.shape[2] != size or x.shape[3] != size:
                        x = resize(x, size, "bilinear")
                module(x.to(_module_dtype(module)))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        for h in hooks:
            h.remove()
    return {k: float(v) for k, v in running.items()}


def quantize_xunet(bundle, calib_batches: Sequence[Any],
                   model_size: Optional[int] = None,
                   absmax: Optional[Dict[str, float]] = None
                   ) -> Int8XUnetBundle:
    """Calibrate + quantize an XUnet ``ModelBundle`` → ``Int8XUnetBundle``
    on the same device, the entry conv in the bundle's dtype. Weights are
    read from ``bundle.variables``."""
    if bundle.spec.family != "xunet":
        raise NotImplementedError("quantize_xunet: xunet bundles only")
    if bundle.variables is None:
        raise ValueError("quantize_xunet needs the f32 variables the "
                         "bundle was built from (bundle.variables)")
    if absmax is None:
        absmax = calibrate_absmax(bundle, calib_batches, model_size)
    variables = bundle.variables
    prep = _Prepare(variables, absmax, bn_eps=1e-3, act="relu")
    base = np.shape(
        variables["params"]["enc0"]["cv1"]["conv"]["kernel"])[-1]
    s_entry = max(absmax["enc0/cv1"], 1e-12) / 127.0
    out = _xunet_trunk(prep, QT(None, s_entry, base))
    p = variables["params"]["mask_out"]
    scales = dict(prep.scales)
    scales["__entry__"] = s_entry
    q = {"convs": prep.qparams,
         # dequant fold: conv(x_i8·s, K) == conv(x_i8, K·s) for the 1×1 head
         "mask_kernel": np.asarray(p["kernel"], np.float32) * out.s,
         "mask_bias": np.asarray(p["bias"], np.float32),
         "scales": scales}
    return Int8XUnetBundle.from_q(bundle.spec, variables, q,
                                  dtype=_module_dtype(bundle.module),
                                  device=bundle.device, absmax=absmax)


def quantize_bundle(bundle, calib_batches: Sequence[Any],
                    model_size: Optional[int] = None,
                    absmax: Optional[Dict[str, float]] = None):
    """Calibrate + quantize a ``ModelBundle``: the detector families
    (yolov7-tiny with the standard stems, yolov7-base, any yolov8 scale)
    → ``Int8Bundle`` on the same device, stems in the bundle's dtype;
    xunet → ``Int8XUnetBundle`` (``quantize_xunet``).

    calib_batches: a few representative uint8 [B,S,S,3] batches (or floats
    in [0,1]). Pass absmax= to reuse a saved calibration instead. The
    weights are read from ``bundle.variables`` (the f32 flax-format tree
    the bundle was built from), not from its fused module.
    """
    if bundle.spec.family == "xunet":
        return quantize_xunet(bundle, calib_batches, model_size,
                              absmax=absmax)
    module = bundle.module
    variant = getattr(module, "variant", "")
    if bundle.spec.family == "yolov7" and variant == "tiny" \
            and getattr(module, "s2d_stem", False):
        raise NotImplementedError(
            "int8 PTQ covers yolov7 tiny/base with the standard stems, "
            "yolov8 n–x, and xunet; the s2d_stem experiment keeps bf16")
    is_v8 = bundle.spec.family == "yolov8"
    arch = module.scale if is_v8 else variant
    meta = _family_meta(bundle.spec, arch)       # raises for other families
    if bundle.variables is None:
        raise ValueError("quantize_bundle needs the f32 variables the "
                         "bundle was built from (bundle.variables)")
    if absmax is None:
        absmax = calibrate_absmax(bundle, calib_batches, model_size)
    prep = _Prepare(bundle.variables, absmax, bn_eps=meta["bn_eps"],
                    act=meta["act"])
    p2_key = meta["stems"][-1]        # the last stem conv emits P2
    p2_c = np.asarray(
        bundle.variables["params"][p2_key]["conv"]["kernel"]).shape[-1]
    p2 = QT(None, max(absmax[p2_key], 1e-12) / 127.0, p2_c)
    q = {"p2_scale": np.float32(p2.s), "convs": prep.qparams}
    if is_v8:
        from aerial_image_recognition_tpu_torch.models.yolov8 import SCALES
        _v8_trunk(prep, p2, SCALES[arch][0])
    else:
        trunk = _v7base_trunk if arch == "base" else _tiny_trunk
        q["out_scales"] = [np.float32(o.s) for o in trunk(prep, p2)]
    if arch != "base":      # base's four-conv stem has no quad stem
        q["stems"] = _quantize_stems(
            bundle.variables, absmax, bn_eps=meta["bn_eps"],
            stem_names=meta["stems"], act=meta["act"])
    scales = dict(prep.scales)
    scales["__p2__"] = p2.s
    q["scales"] = scales
    return Int8Bundle.from_q(bundle.spec, bundle.variables, q,
                             dtype=_module_dtype(module),
                             device=bundle.device, absmax=absmax)
