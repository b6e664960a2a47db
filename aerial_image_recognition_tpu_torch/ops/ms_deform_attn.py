"""Multi-scale deformable attention sampling (Deformable DETR, Zhu et al.,
ICLR 2021; RT-DETR's decoder cross-attention): the wrapper of the CUDA
kernel (``csrc/ms_deform_attn.cu``) and its plain version.

For each image b, query q and head h, the output is the attention-weighted
sum over levels l and points p of the value map of level l sampled
bilinearly at the point's location:

    out[b, q, h*D + c] = sum_{l,p} w[b,q,h,l,p] * bilinear(value_l[b, :, h, c],
                                                        loc[b,q,h,l,p])

``value`` is [B, sum(H_l*W_l), heads, D], the levels' maps flattened row
by row and concatenated in level order; ``loc`` [B, Q, heads, levels,
points, 2] holds (x, y) in [0, 1] of the level's width and height, as
``grid_sample`` reads them with ``align_corners=False``: the sample sits at
pixel ``x * W - 0.5``, and corners outside the map read zero.

On a CUDA tensor ``ms_deform_attn`` launches the kernel on the current
stream or raises; on a CPU tensor it runs ``ms_deform_attn_plain``. There
is no fallback from the card to the plain version.
``ms_deform_attn.launches`` counts kernel launches (not plain-version
calls) and ``ms_deform_attn.last_shape`` holds the shapes of the last one
(batch, value tokens, heads, head width, queries, the levels' (H, W),
points), from which its bytes and operations follow.
"""

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from aerial_image_recognition_tpu_torch.kernels.args import (
    check_tensor, device_index)

MAX_LEVELS = 4


def ms_deform_attn_plain(value: torch.Tensor,
                         shapes: Sequence[Tuple[int, int]],
                         loc: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """value [B,L,heads,D], shapes ((H_l, W_l), ...), loc
    [B,Q,heads,levels,points,2], weights [B,Q,heads,levels,points] →
    [B,Q,heads*D], in value's dtype: per level the four corners of each
    sample gathered and blended."""
    b, n_tok, heads, d = value.shape
    _, q, _, levels, points, _ = loc.shape
    if levels != len(shapes) or n_tok != sum(h * w for h, w in shapes):
        raise ValueError(f"ms_deform_attn: value has {n_tok} tokens, the "
                         f"levels {list(shapes)} hold "
                         f"{sum(h * w for h, w in shapes)}")
    out = value.new_zeros(b, q, heads, d)
    start = 0
    rows = torch.arange(b, device=value.device)[:, None, None, None]
    cols = torch.arange(heads, device=value.device)[None, None, :, None]
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w]                   # [B,HW,heads,D]
        start += h * w
        x = loc[:, :, :, lvl, :, 0] * w - 0.5               # [B,Q,heads,P]
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0, y0 = x0.long(), y0.long()
        acc = 0.0
        for dy, dx, cw in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            tok = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
            got = v[rows, tok, cols]                        # [B,Q,heads,P,D]
            acc = acc + got * torch.where(inside, cw, 0.0)[..., None]
        out += (acc * weights[:, :, :, lvl, :, None]).sum(3)
    return out.reshape(b, q, heads * d)


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry point, built and loaded at the first launch."""
    from aerial_image_recognition_tpu_torch.kernels.build import load
    fn = load("ms_deform_attn").ms_deform_attn_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def ms_deform_attn(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                   loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """value [B,L,heads,D] f32, shapes ((H_l, W_l), ...), loc
    [B,Q,heads,levels,points,2] f32, weights [B,Q,heads,levels,points] f32
    → out [B,Q,heads*D] f32."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, shapes, loc, weights)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn: no kernel for {value.device}")
    b, n_tok, heads, d = value.shape
    q, levels, points = loc.shape[1], loc.shape[3], loc.shape[4]
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    if not 1 <= levels <= MAX_LEVELS or len(shapes) != levels \
            or levels * points > 32:
        raise ValueError(f"ms_deform_attn: {levels} levels of {points} "
                         f"points and shapes {shapes}; the kernel takes "
                         f"1..{MAX_LEVELS} levels and at most 32 samples "
                         f"(one a lane)")
    if n_tok != sum(h * w for h, w in shapes):
        raise ValueError(f"ms_deform_attn: value has {n_tok} tokens, the "
                         f"levels {shapes} hold "
                         f"{sum(h * w for h, w in shapes)}")
    dev = value.device
    for name, t, shape in (
            ("value", value, (b, n_tok, heads, d)),
            ("loc", loc, (b, q, heads, levels, points, 2)),
            ("weights", weights, (b, q, heads, levels, points))):
        check_tensor("ms_deform_attn", name, t, torch.float32, shape, dev)
    hw = (ctypes.c_int * (2 * MAX_LEVELS))(
        *[v for s in shapes for v in s], *([0] * 2 * (MAX_LEVELS - levels)))
    out = torch.empty((b, q, heads * d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(value.data_ptr(), loc.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), b, n_tok, heads, d, q, levels, points,
                 ctypes.cast(hw, ctypes.c_void_p), device_index(dev), stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn kernel launch failed: CUDA "
                           f"error {err}")
    ms_deform_attn.launches += 1
    ms_deform_attn.last_shape = {"batch": b, "tokens": n_tok,
                                 "heads": heads, "head_dim": d,
                                 "queries": q, "levels": [list(s) for s in
                                                          shapes],
                                 "points": points}
    return out


ms_deform_attn.launches = 0
ms_deform_attn.last_shape = None
