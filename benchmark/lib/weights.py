"""The weights each configuration names, made or loaded by the benchmark
and handed alike to the program and to the reference.

* ``file``: a flat npz of flax-format paths (the repository's trained
  fixture), its sha256 pinned in the configuration file; set-up fails if
  the file changed.
* ``seeded_unit_variance``: drawn from ``--seed`` on the card by a
  ``torch.Generator`` in one call, then rescaled on a few rendered tiles,
  conv by conv in the order they run, to a fixed output deviation, and
  each class logit to unit deviation with a fixed share of each level's
  anchors above the threshold (after
  ``chip_smoke.unit_variance_tree``, chip_smoke.py:2392, on the card and on
  the reference's graph): a seeded deep trunk otherwise fades to a
  constant, every anchor scoring alike. The deviation is the
  configuration's ``conv_output_std``: at 1, as chip_smoke has it, the
  SiLU trunk is chaotic, and bf16 rounding moves the logits that clear the
  threshold by half a unit against f32.

Both give a flat dict of f32 tensors on the device (the reference's
input) and a nested numpy tree (what the program's ``create_model`` takes
as ``variables``).
"""

import hashlib
import math
import os

import numpy as np
import torch

from benchmark.reference import models as ref_models


def nested(flat: dict) -> dict:
    """{'params/a/b': array} -> {'params': {'a': {'b': array}}}."""
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _from_file(cfg: dict, root: str, device) -> dict:
    spec = cfg["weights"]
    path = os.path.join(root, spec["path"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != spec["sha256"]:
        raise RuntimeError(f"{spec['path']} has sha256 {digest}, the "
                           f"configuration pins {spec['sha256']}")
    with np.load(path) as z:
        if any(k.endswith(":bf16") for k in z.keys()):
            raise RuntimeError(f"{spec['path']}: bf16 leaves are not read")
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
                for k in z.keys()}


class _Rescale(ref_models.Graph):
    """The reference graph, rescaling as it runs each conv to output
    deviation ``conv_std``, each class head to unit deviation with the
    share ``cls_share`` of its logits above the ``threshold``'s,
    and each box head to deviation ``box_std`` about a prior that puts
    ``box_logit`` on bin ``box_bin`` of every side's distance distribution
    (boxes about 2 * box_bin strides across, stable under rounding, where
    unit-deviation box logits give boxes half a tile across that overlap
    one another)."""

    def __init__(self, weights, act, bn_eps, spec):
        super().__init__(weights, act, bn_eps)
        self.conv_std = spec["conv_output_std"]
        self.cls_share = spec["class_share_above"]
        self.threshold = spec["threshold"]
        self.box_std = spec["box_logit_std"]
        self.box_bin = spec["box_prior_bin"]
        self.box_logit = spec["box_prior_logit"]

    def conv(self, name, x, stride=1):
        key = f"params/{name}/conv/kernel"
        k = self.w[key].permute(3, 2, 0, 1)
        s = torch.nn.functional.conv2d(x, k, stride=stride,
                                       padding=k.shape[-1] // 2).std()
        self.w[key] *= self.conv_std / s
        return super().conv(name, x, stride)

    def head(self, name, feat):
        out = super().head(name, feat)
        kernel = self.w[f"params/{name}/kernel"]
        bias = self.w[f"params/{name}/bias"]
        if "/cls" in name:
            # unit deviation, then the share cls_share of this level's
            # logits above the threshold's logit
            mean, std = out.mean((0, 1, 2)), out.std((0, 1, 2))
            z = ((out - mean) / std).reshape(-1, out.shape[-1])
            top = torch.quantile(z, 1.0 - self.cls_share, dim=0)
            kernel /= std
            bias.sub_(mean).div_(std).add_(
                math.log(self.threshold / (1 - self.threshold)) - top)
        else:
            kernel *= self.box_std / out.std()
            bias.zero_()
            bias.view(4, -1)[:, self.box_bin] = self.box_logit
        return super().head(name, feat)


def _seeded(cfg: dict, seed: int, device, calib_tiles: np.ndarray) -> dict:
    spec = cfg["weights"]
    shapes = ref_models.yolov8_shapes(cfg["nc"], tuple(cfg["widths"]),
                                      tuple(cfg["depths"]))
    kernels = [k for k in shapes if k.endswith("kernel")]
    sizes = [int(np.prod(shapes[k])) for k in kernels]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    w = {}
    for k, part in zip(kernels, flat.split(sizes)):
        fan_in = int(np.prod(shapes[k][:-1]))
        w[k] = part.view(shapes[k]) / fan_in ** 0.5
    for k, shape in shapes.items():
        if k in w:
            continue
        ones = k.endswith("/scale") or k.endswith("/var")
        w[k] = (torch.ones if ones else torch.zeros)(shape, device=device)
    x = torch.from_numpy(calib_tiles[:spec["calib_tiles"]]).to(device)
    with torch.no_grad():
        ref_models.yolov8(_Rescale(w, "silu", 1e-3, spec),
                          x.permute(0, 3, 1, 2).float() / 255.0,
                          tuple(cfg["depths"]))
    return w


def make(cfg: dict, seed: int, device, root: str, calib_tiles: np.ndarray):
    """(flat f32 tensors on ``device``, nested numpy tree) of ``cfg``."""
    kind = cfg["weights"]["kind"]
    if kind == "file":
        flat = _from_file(cfg, root, device)
    elif kind == "seeded_unit_variance":
        flat = _seeded(cfg, seed, device, calib_tiles)
    else:
        raise ValueError(f"unknown weights kind {kind!r}")
    return flat, nested({k: v.cpu().numpy() for k, v in flat.items()})
