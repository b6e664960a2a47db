"""Test-time augmentation (TTA) — lighting/occlusion variation stack.

Counterpart of ``aerial_image_recognition_tpu/ops/augment.py``: the
original project's TTA ladder (brightness 1.4/1.6/1.8, gamma 1.5, three
CLAHE parameterizations, per-variation confidence weights), generated on
the device and stacked into the batch dimension (B·V images through one
forward), then merged by weighted NMS. ``local_contrast`` is the
reference's differentiable CLAHE approximant (``localcontrast_<clip>``,
for training-time augmentation), ``shadow`` its shadow enhancement, and
``merge_tta_scores`` its per-variation weighted max-merge of scores.

Layout: images are NCHW, ``[B, 3, H, W]`` floats in 0..1 (the port's
layout, usually a channels_last view of an NHWC buffer) — axis 1 is the
colour channel, axes 2 and 3 are height and width — where the JAX package
has ``[B, H, W, 3]``. The per-image mean of ``enhance_shadows`` runs over
the last three axes in both, which are (C, H, W) here.

The ``clahe_*`` variations run the exact tile-histogram algorithm
(``ops/clahe.clahe_rgb_device_multi``); ``expand_tta`` always folds them
into one multi-clip pass, which is bit-identical to the per-variation
ladder and shares the LAB transform, the histograms and one launch of the
LUT-apply kernel. Variations keep the dtype of ``x``: brightness and gamma
run in it, CLAHE computes in f32 and casts back.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# (name, weight): confidence weights per variation, mirroring the
# original project's table.
DEFAULT_VARIATIONS: Tuple[Tuple[str, float], ...] = (
    ("original", 1.00),
    ("brightness_1.4", 0.95),
    ("brightness_1.6", 0.90),
    ("brightness_1.8", 0.85),
    ("gamma_1.5", 0.95),
    ("clahe_2.0", 0.90),
    ("clahe_3.0", 0.85),
    ("clahe_4.0", 0.80),
)


def brightness(x: torch.Tensor, factor: float) -> torch.Tensor:
    return torch.clamp(x * factor, 0.0, 1.0)


def gamma(x: torch.Tensor, g: float) -> torch.Tensor:
    return torch.clamp(x, 1e-6, 1.0) ** (1.0 / g)


def local_contrast(x: torch.Tensor, clip: float = 2.0,
                   grid: int = 8) -> torch.Tensor:
    """CLAHE approximant: per-tile standardization of the luminance with
    smooth statistics (tile means and deviations, resized bilinearly to
    the image by ``jax.image.resize``'s weights: two f32 matrix products
    with ``ops/preprocess._resize_matrix``), gain limited by ``clip``,
    chroma ratios reapplied. x [B,3,H,W] float in 0..1."""
    from aerial_image_recognition_tpu_torch.ops.preprocess import (
        _resize_matrix)
    h, w = x.shape[-2:]
    lum = x.mean(dim=1, keepdim=True)                       # [B,1,H,W]
    th, tw = h // grid, w // grid
    cnt = float(th * tw)
    mean = F.avg_pool2d(lum, (th, tw), (th, tw), divisor_override=1) / cnt
    sq = F.avg_pool2d(lum * lum, (th, tw), (th, tw), divisor_override=1) \
        / cnt
    var = torch.clamp_min(sq - mean ** 2, 1e-6)

    def resize(t):
        ry = torch.from_numpy(_resize_matrix(t.shape[-2], h, "bilinear"))
        rx = torch.from_numpy(_resize_matrix(t.shape[-1], w, "bilinear"))
        ry, rx = ry.to(t.device), rx.to(t.device)
        return torch.matmul(torch.matmul(ry, t.float()), rx.T).to(t.dtype)

    if x.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("local_contrast's resize needs f32 matrix "
                           "products at 'highest' precision (not TF32)")
    mean_f = resize(mean)
    std_f = resize(torch.sqrt(var))
    gain = torch.clamp(0.2 / (std_f + 1e-4), 1.0 / clip, clip)
    out = (lum - mean_f) * gain + mean_f
    ratio = x / torch.clamp_min(lum, 1e-4)
    return torch.clamp(out * ratio, 0.0, 1.0)


def enhance_shadows(x: torch.Tensor) -> torch.Tensor:
    """Shadow enhancement: brightness 1.8 then contrast 1.2 around the
    per-image mean (over C, H and W)."""
    y = torch.clamp(x * 1.8, 0.0, 1.0)
    mean = y.mean(dim=(-3, -2, -1), keepdim=True)
    return torch.clamp((y - mean) * 1.2 + mean, 0.0, 1.0)


def _split(name: str) -> Tuple[str, float]:
    kind, _, val = name.partition("_")
    if kind not in ("brightness", "gamma", "clahe", "localcontrast") \
            or not val:
        raise KeyError(f"unknown TTA variation {name!r}")
    return kind, float(val)


def apply_variation(x: torch.Tensor, name: str, *,
                    clahe_hist_subsample: int = 1) -> torch.Tensor:
    """One variation of the ladder: 'original', 'shadow',
    'brightness_<f>', 'gamma_<g>', 'clahe_<clip>' or
    'localcontrast_<clip>'."""
    if name == "original":
        return x
    if name == "shadow":
        return enhance_shadows(x)
    kind, v = _split(name)
    if kind == "brightness":
        return brightness(x, v)
    if kind == "gamma":
        return gamma(x, v)
    if kind == "localcontrast":
        return local_contrast(x, clip=v)
    # exact tile-histogram CLAHE on the LAB lightness channel;
    # clahe_hist_subsample > 1 estimates the per-tile histograms from a
    # stride-s lattice (1 = bit-exact)
    from aerial_image_recognition_tpu_torch.ops.clahe import clahe_rgb_device
    return clahe_rgb_device(x, clip_limit=v,
                            hist_subsample=clahe_hist_subsample)


def expand_tta(x: torch.Tensor,
               variations: Sequence[Tuple[str, float]] = DEFAULT_VARIATIONS,
               *, clahe_hist_subsample: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,3,H,W] float → ([B·V,3,H,W], weights [V]); variation-major order
    (x_v = out[v·B:(v+1)·B]).

    All ``clahe_*`` variations come from one multi-clip pass (see the
    module docstring); the others from ``apply_variation``."""
    from aerial_image_recognition_tpu_torch.ops.clahe import (
        clahe_rgb_device_multi)

    outs = [None] * len(variations)
    clahe = [(i, _split(name)[1]) for i, (name, _) in enumerate(variations)
             if name.partition("_")[0] == "clahe"]
    if clahe:
        multi = clahe_rgb_device_multi(
            x, [c for _, c in clahe], hist_subsample=clahe_hist_subsample)
        for v, (i, _) in enumerate(clahe):
            outs[i] = multi[v]
    for i, (name, _) in enumerate(variations):
        if outs[i] is None:
            outs[i] = apply_variation(x, name)
    w = torch.tensor([wt for _, wt in variations], dtype=x.dtype,
                     device=x.device)
    return torch.cat(outs, dim=0), w


def merge_tta_scores(scores: torch.Tensor, weights: torch.Tensor,
                     batch: int) -> torch.Tensor:
    """[B·V, A, nc] → [B, A, nc]: per-variation confidence weighting, then
    the max across variations (variation-major order, as ``expand_tta``)."""
    v = weights.shape[0]
    s = scores.reshape(v, batch, *scores.shape[1:])
    return torch.amax(s * weights[:, None, None, None], dim=0)
