"""The weights each configuration names, made or loaded by the benchmark
and handed alike to the program and to the reference.

* ``file``: a flat npz of flax-format paths (the repository's trained
  fixture), its sha256 pinned in the configuration file; set-up fails if
  the file changed.
* ``seeded_unit_variance``: the configuration's family
  (``reference/families/<reference>.py``) gives the leaf shapes
  (``shapes(cfg)``); every kernel is drawn from ``--seed`` on the card by a
  ``torch.Generator`` in one call and scaled by its fan-in, scales and
  variances are 1 and the rest 0; then the family's ``calibrate(cfg, w,
  x)`` runs its forward over a few rendered tiles on a ``ConvRescale``
  graph, which rescales each conv, in the order they run, to the
  configuration's output deviation ``conv_output_std``, and sets the heads
  as the family's docstring says: a seeded deep trunk otherwise fades to a
  constant, every anchor scoring alike. At a deviation of 1 a SiLU trunk is
  chaotic, and bf16 rounding moves the logits that clear the threshold by
  half a unit against f32.

Both give a flat dict of f32 tensors on the device (the reference's
input) and a nested numpy tree (what the program's ``create_model`` takes
as ``variables``).
"""

import hashlib
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


class ConvRescale(ref_models.Graph):
    """The reference graph, rescaling each conv's kernel as it runs to
    output deviation ``spec["conv_output_std"]``; a family's calibration
    subclasses it for its heads, reading their settings from ``spec``
    (the configuration's ``weights``)."""

    def __init__(self, weights, act, bn_eps, spec):
        super().__init__(weights, act, bn_eps)
        self.spec = spec
        self.conv_std = spec["conv_output_std"]

    def conv(self, name, x, stride=1):
        key = f"params/{name}/conv/kernel"
        k = self.w[key].permute(3, 2, 0, 1)
        s = torch.nn.functional.conv2d(x, k, stride=stride,
                                       padding=k.shape[-1] // 2).std()
        self.w[key] *= self.conv_std / s
        return super().conv(name, x, stride)


def _seeded(cfg: dict, family, seed: int, device,
            calib_tiles: np.ndarray) -> dict:
    spec = cfg["weights"]
    shapes = family.shapes(cfg)
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
        family.calibrate(cfg, w, x.permute(0, 3, 1, 2).float() / 255.0)
    return w


def make(cfg: dict, family, seed: int, device, root: str,
         calib_tiles: np.ndarray):
    """(flat f32 tensors on ``device``, nested numpy tree) of ``cfg``,
    whose reference is the module ``family``."""
    kind = cfg["weights"]["kind"]
    if kind == "file":
        flat = _from_file(cfg, root, device)
    elif kind == "seeded_unit_variance":
        flat = _seeded(cfg, family, seed, device, calib_tiles)
    else:
        raise ValueError(f"unknown weights kind {kind!r}")
    return flat, nested({k: v.cpu().numpy() for k, v in flat.items()})
