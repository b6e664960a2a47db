"""Packed (space-to-depth layout) lowering of XUnet's full-resolution stages.

Counterpart of ``aerial_image_recognition_tpu/ops/packed_unet.py``
(``host_s2d``, ``s2d_unpack``, ``s2d_conv3x3_kernel``, ``s2d_conv3x3``,
``_s2d_pool_to_standard``, ``_conv``, ``fold_xunet``,
``xunet_forward_packed``): an experiment of the reference, held here to its
function and a default of no path. The 256² maps of enc0 and dec3 stay in
``space_to_depth2`` layout [B,H/2,W/2,4C] (channel order (dy, dx, c)) and
each full-resolution 3×3 conv runs as four 2×2-cell convs, one per output
subpixel (a, b), each with its own one-sided cell padding:

    out(2Y+a, 2X+b) = Σ_{ky,kx} w[ky,kx] · in(2Y+a+ky−1, 2X+b+kx−1)
    row term: t = a+ky−1 = 2p + dy  ⇒  cell Y+p, subrow dy
    a = 0 ⇒ p ∈ {−1,0} (pad lo), a = 1 ⇒ p ∈ {0,1} (pad hi)

Tensors are NHWC at this module's surface, as the reference's are (the
host packs NHWC, and the logits come back NHWC like the port's XUnet
gives them); each convolution runs on the NCHW view of the same memory
(``F.conv2d`` on channels_last, cuDNN on the card), as the reference's run
``lax.conv_general_dilated``. The cell padding is one ``F.pad`` of the
input by a cell on every side and, per subpixel, an unpadded conv over the
(H/2+1)-row window that starts at row a and column b.

The reference's rounding points are kept: BN folded in f32
(``ops/quadstem.fold_convbn``: ``torch.rsqrt`` is within 2 ulps of XLA's
rsqrt, so the folds are too), kernels and biases cast to the trunk dtype,
the bias added as its own operation after the conv, relu, and ``mask_out``
in f32 — a matrix product that, on the card, refuses to run unless
``torch.get_float32_matmul_precision()`` is "highest".

``PackedXUnet`` folds and transforms the weights once, on one device;
``xunet_forward_packed`` is the reference's function over a flax-format
tree (it builds the weights for that call).
"""

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from aerial_image_recognition_tpu_torch.ops.quadstem import fold_convbn


def host_s2d(px: np.ndarray) -> np.ndarray:
    """numpy space_to_depth2: [B,H,W,C] (or [H,W,C]) → [B,H/2,W/2,4C],
    channel order (dy, dx, c) — the layout the packed forward consumes."""
    batched = px.ndim == 4
    if not batched:
        px = px[None]
    b, h, w, c = px.shape
    x = px.reshape(b, h // 2, 2, w // 2, 2, c)
    x = np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4, 5))
    out = x.reshape(b, h // 2, w // 2, 4 * c)
    return out if batched else out[0]


def s2d_unpack(x: torch.Tensor) -> torch.Tensor:
    """[B,H/2,W/2,4C] s2d layout → [B,H,W,C] (depth-to-space)."""
    b, h2, w2, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h2 * 2, w2 * 2, c)


def s2d_conv3x3_kernel(w, a: int, b: int) -> np.ndarray:
    """[3,3,Cin,Cout] full-res stride-1 (pad 1) conv kernel → the
    [2,2,4Cin,Cout] f32 cell kernel computing output subpixel (a, b).
    Input channel axis is s2d order (dy, dx, c)."""
    w = np.asarray(w, np.float32)
    k, _, cin, cout = w.shape
    assert k == 3
    kk = np.zeros((2, 2, 2, 2, cin, cout), np.float32)    # [u,v,dy,dx,c,o]
    for ky in range(3):
        p, dy = divmod(a + ky - 1, 2)          # python divmod: p ∈ {-1,0,1}
        u = p + 1 if a == 0 else p
        for kx in range(3):
            q, dx = divmod(b + kx - 1, 2)
            v = q + 1 if b == 0 else q
            kk[u, v, dy, dx] = w[ky, kx]
    return kk.reshape(2, 2, 4 * cin, cout)


def _oihw(w, dtype: torch.dtype, device) -> torch.Tensor:
    """An HWIO kernel (numpy or tensor) as an OIHW tensor of ``dtype``."""
    w = torch.from_numpy(np.array(w, np.float32)) \
        if not isinstance(w, torch.Tensor) else w.float()
    return w.permute(3, 2, 0, 1).contiguous().to(device, dtype)


def _bias(b, dtype: torch.dtype, device) -> torch.Tensor:
    """A [C] bias as a [C,1,1] tensor of ``dtype``, to add to NCHW maps."""
    return torch.from_numpy(np.array(b, np.float32)).to(
        device, dtype)[:, None, None]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _bias_act(o: torch.Tensor, bias: Optional[torch.Tensor], act):
    if bias is not None:
        o = o + bias
    return act(o) if act is not None else o


def _s2d_conv3x3_oihw(x: torch.Tensor, kernels, bias, act) -> torch.Tensor:
    """``s2d_conv3x3`` over kernels already OIHW in ``x``'s dtype and a
    bias already in it."""
    h2, w2 = x.shape[1], x.shape[2]
    xp = F.pad(_nchw(x), (1, 1, 1, 1))
    outs = []
    for a in (0, 1):
        for b in (0, 1):
            o = F.conv2d(xp[:, :, a:a + h2 + 1, b:b + w2 + 1],
                         kernels[(a, b)])
            outs.append(_nhwc(_bias_act(o, bias, act)))
    return torch.cat(outs, dim=-1)


def s2d_conv3x3(x: torch.Tensor, kernels, bias=None, act=None):
    """Full-res 3×3 conv on an s2d-layout tensor.

    x: [B,H2,W2,4Cin]; kernels: {(a,b): [2,2,4Cin,Cout]} from
    s2d_conv3x3_kernel. Returns [B,H2,W2,4Cout] in s2d order."""
    k = {ab: _oihw(w, x.dtype, x.device) for ab, w in kernels.items()}
    if bias is not None:
        bias = _bias(bias, x.dtype, x.device)
    return _s2d_conv3x3_oihw(x, k, bias, act)


def _s2d_pool_to_standard(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 maxpool of the underlying full-res map = max over the
    four s2d subpixels → STANDARD layout [B,H2,W2,C]."""
    b, h2, w2, c4 = x.shape
    return x.reshape(b, h2, w2, 4, c4 // 4).amax(dim=3)


def _conv_oihw(x: torch.Tensor, w: torch.Tensor, bias, act,
               stride: int = 1) -> torch.Tensor:
    """``_conv`` over a kernel already OIHW in ``x``'s dtype and a bias
    already in it."""
    o = F.conv2d(_nchw(x), w, None, stride, w.shape[-1] // 2)
    return _nhwc(_bias_act(o, bias, act))


def _conv(x: torch.Tensor, w, bias, act, stride: int = 1) -> torch.Tensor:
    """NHWC conv with symmetric k//2 padding, + bias, act (the reference's
    ``_conv``); ``w`` HWIO."""
    return _conv_oihw(x, _oihw(w, x.dtype, x.device),
                      _bias(bias, x.dtype, x.device), act, stride)


def fold_xunet(variables: Dict, eps: float = 1e-3) -> Dict:
    """XUnet variables → flat {scope: (w, b)} deploy weights (f32 numpy;
    w HWIO)."""
    params, stats = variables["params"], variables["batch_stats"]
    out = {}

    def walk(p, s, prefix):
        for k, v in p.items():
            if isinstance(v, dict) and "conv" in v:
                out[f"{prefix}{k}"] = fold_convbn(v, s[k], eps=eps)
            elif isinstance(v, dict) and "kernel" in v:      # plain conv
                out[f"{prefix}{k}"] = (np.array(v["kernel"], np.float32),
                                       np.array(v["bias"], np.float32))
            elif isinstance(v, dict):
                walk(v, s.get(k, {}), f"{prefix}{k}/")

    walk(params, stats, "")
    return out


class PackedXUnet:
    """``xunet_forward_packed`` with its weights folded, transformed and
    cast once, on one device: the 16 cell kernels of enc0 and dec3 and the
    standard convs (OIHW, trunk dtype), their biases, and ``mask_out`` in
    f32. ``__call__`` takes the host-s2d batch."""

    def __init__(self, variables: Dict, *, dtype: torch.dtype = torch.bfloat16,
                 device="cpu"):
        f = fold_xunet(variables)
        self.dtype, self.device = dtype, torch.device(device)
        scale = np.float32(1.0 / 255.0)

        def packed(scope, cin_scale=None):
            convs = []
            for name in ("cv1", "cv2"):
                w, b = f[f"{scope}/{name}"]
                if cin_scale is not None and name == "cv1":
                    w = w * cin_scale       # the /255 rides enc0's first conv
                convs.append(({(a, c): _oihw(s2d_conv3x3_kernel(w, a, c),
                                             dtype, self.device)
                               for a in (0, 1) for c in (0, 1)},
                              _bias(b, dtype, self.device)))
            return convs

        self.enc0 = packed("enc0", scale)
        self.dec3 = packed("dec3")
        self.std = {k: (_oihw(w, dtype, self.device),
                        _bias(b, dtype, self.device))
                    for k, (w, b) in f.items()
                    if k.split("/")[0] not in ("enc0", "dec3", "mask_out")}
        wm, bm = f["mask_out"]
        self.wm = torch.from_numpy(wm.reshape(wm.shape[-2], -1)).to(
            self.device)
        self.bm = torch.from_numpy(bm).to(self.device)

    def _conv(self, x, name, act=torch.relu):
        return _conv_oihw(x, *self.std[name], act)

    def _block(self, x, scope):
        return self._conv(self._conv(x, f"{scope}/cv1"), f"{scope}/cv2")

    def _packed_block(self, v, convs):
        for kernels, b in convs:
            v = _s2d_conv3x3_oihw(v, kernels, b, torch.relu)
        return v

    def __call__(self, x_s2d: torch.Tensor) -> torch.Tensor:
        """x_s2d [B,H/2,W/2,12] host-s2d uint8/float tiles (RAW pixels;
        the /255 folds into enc0's first conv) → mask logits in s2d
        layout [B,H/2,W/2,4·out] f32 (``s2d_unpack`` for [B,H,W,out])."""
        if x_s2d.is_cuda and torch.get_float32_matmul_precision() \
                != "highest":
            raise RuntimeError(
                "the f32 mask head needs full-precision f32 matmuls; "
                "torch.get_float32_matmul_precision() is "
                f"{torch.get_float32_matmul_precision()!r} (TF32) — set it "
                "back to 'highest'")
        x = x_s2d.to(self.dtype)
        enc0 = self._packed_block(x, self.enc0)             # [B,h,w,4·c]
        v = _s2d_pool_to_standard(enc0)                     # [B,h,w,c]
        skips = []
        for scope in ("enc1", "enc2", "enc3"):
            v = self._block(v, scope)
            skips.append(v)
            v = _nhwc(F.max_pool2d(_nchw(v), 2, 2))
        v = self._block(v, "bottleneck")
        for i, scope in enumerate(("dec0", "dec1", "dec2")):
            v = _nhwc(F.interpolate(_nchw(v), scale_factor=2,
                                    mode="nearest"))
            v = self._conv(v, f"up{i}")
            v = torch.cat([v, skips[-(i + 1)]], dim=-1)
            v = self._block(v, scope)
        # dec3 packed: the 2× upsample is a channel tile in s2d layout, so
        # up3's 1×1 conv runs once per source pixel
        u3 = self._conv(v, "up3", act=None).relu()          # [B,h,w,c]
        e = enc0.reshape(*enc0.shape[:3], 4, -1)
        u = u3[:, :, :, None, :].expand(e.shape)
        v = torch.cat([u, e], dim=-1).reshape(*enc0.shape[:3], -1)
        v = self._packed_block(v, self.dec3)                # [B,h,w,4·c]
        # mask_out 1×1 per subpixel group, f32 logits
        v32 = v.float().reshape(*v.shape[:3], 4, -1)
        logits = torch.matmul(v32, self.wm) + self.bm
        return logits.reshape(*v.shape[:3], -1)


def xunet_forward_packed(variables: Dict, x_s2d: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inference XUnet-256 with enc0 and dec3 (the 256² stages) in packed
    s2d layout, over a flax-format f32 tree. x_s2d: [B,128,128,12]
    host-s2d uint8/float tiles (RAW pixels; /255 is folded into enc0's first
    conv). Returns mask logits in s2d layout [B,128,128,4·out] f32 —
    ``s2d_unpack`` for [B,256,256,out]. Builds the weights on ``x_s2d``'s
    device for this call; ``PackedXUnet`` keeps them."""
    return PackedXUnet(variables, dtype=dtype, device=x_s2d.device)(x_s2d)
