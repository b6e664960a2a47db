"""Checkpoint reader and the flax → torch weight bridge.

``load_params`` reads the reference's flat-npz checkpoints (written by
``aerial_image_recognition_tpu/models/registry.py:save_params``) with numpy
alone: keys are ``/``-joined tree paths, and bf16 leaves are stored bit-exact
as uint16 under a ``:bf16`` suffix.

``params_from_flax`` turns such a tree (``{"params": …, "batch_stats": …}``)
into a ``state_dict`` for the port's modules (``models/yolov7.YOLOv7``,
``models/yolov8.YOLOv8``), whose submodule names equal the flax scope
names at any depth (``c2f1.m0.cv1``, ``detect.box0_out``). Only the leaf
names and layouts differ; the table ``LEAF_MAP`` below is the whole
mapping.
"""

from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


def _bf16_to_f32(u16: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) → the f32 values they denote (exact)."""
    return (u16.astype(np.uint32) << 16).view(np.float32)


def load_params(path: str) -> Dict[str, Any]:
    """Flat npz → nested dict of numpy arrays (bf16 leaves widened to f32)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key, value in data.items():
            if key.endswith(":bf16"):
                key, value = key[:-5], _bf16_to_f32(value)
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(value)
    return tree


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _hwio_1x1_to_linear(a: np.ndarray) -> np.ndarray:
    return a[0, 0].T                                   # [O, I]


# (collection, flax leaf path suffix) → (torch name suffix, layout transform)
LEAF_MAP: Dict[Tuple[str, Tuple[str, ...]],
               Tuple[str, Optional[Callable[[np.ndarray], np.ndarray]]]] = {
    ("params", ("conv", "kernel")): ("conv.weight", _hwio_to_oihw),
    # a BN-less ConvBN (yolov7-base's RepConv deploy convs) has a conv bias
    ("params", ("conv", "bias")): ("conv.bias", None),
    ("params", ("bn", "scale")): ("bn.weight", None),
    ("params", ("bn", "bias")): ("bn.bias", None),
    ("batch_stats", ("bn", "mean")): ("bn.running_mean", None),
    ("batch_stats", ("bn", "var")): ("bn.running_var", None),
    # detect heads and the yolov8 output convs: a bare 1×1 conv with bias,
    # computed as a matmul
    ("params", ("kernel",)): ("weight", _hwio_1x1_to_linear),
    ("params", ("bias",)): ("bias", None),
}


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables → torch state_dict (f32 tensors on the CPU).

    Leaves of the flax tree may be numpy or anything ``np.asarray`` takes.
    Raises on any leaf the table does not map.
    """
    sd: Dict[str, torch.Tensor] = {}
    for collection, sub in tree.items():
        for path, leaf in _flatten(sub):
            for n in (2, 1):
                rule = LEAF_MAP.get((collection, path[-n:]))
                if rule is not None and len(path) > n:
                    break
            else:
                raise KeyError(f"no torch counterpart for flax leaf "
                               f"{collection}/{'/'.join(path)}")
            suffix, transform = rule
            arr = np.array(leaf, dtype=np.float32)         # own copy
            if transform is not None:
                arr = transform(arr)
            name = ".".join(path[:-n]) + "." + suffix
            sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def params_to_flax(module: torch.nn.Module) -> Dict[str, Any]:
    """The inverse bridge: an unfused module's parameters and BN statistics
    → flax-format variables (f32 numpy copies, HWIO kernels). For models
    built from random weights, whose only copy is the module."""
    inverse = {suffix: (collection, path) for (collection, path),
               (suffix, _) in LEAF_MAP.items()}
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, t in module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        parts = name.split(".")
        n = 2 if ".".join(parts[-2:]) in inverse else 1
        suffix = ".".join(parts[-n:])
        if suffix not in inverse or len(parts) <= n:
            raise KeyError(f"no flax counterpart for {name}")
        collection, path = inverse[suffix]
        arr = t.detach().to("cpu", torch.float32).numpy().copy()
        if path == ("conv", "kernel"):
            arr = arr.transpose(2, 3, 1, 0)                   # OIHW → HWIO
        elif path == ("kernel",):
            arr = arr.T[None, None]                           # [O,I] → 1×1 HWIO
        node = tree[collection]
        for p in tuple(parts[:-n]) + path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def load_flax_into(module: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Load a flax tree into ``module``; every parameter and BN statistic
    must be covered (BN's ``num_batches_tracked`` counter excepted)."""
    missing, unexpected = module.load_state_dict(params_from_flax(tree),
                                                 strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"flax tree does not match the module: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")
