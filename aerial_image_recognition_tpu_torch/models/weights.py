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
mapping. ``state_dict_to_flax`` and ``params_to_flax`` go the other way,
and ``grads_to_flax`` carries gradients across the same way, so that they
can be compared with the reference's by flax path.

``state_from_flax`` and ``state_to_flax`` carry a whole train state across:
the trainer (``pipeline/train.py``) keeps flat dicts of torch-named tensors
on its device; checkpoints, ``fit``'s result and a JAX train state are
flax-format numpy trees.
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
    # layer norms (RT-DETR's ``models/rtdetr.LayerNorm``), flax's names
    ("params", ("scale",)): ("scale", None),
}


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_leaf_name(collection: str, path: Tuple[str, ...]
                    ) -> Tuple[str, Optional[Callable]]:
    """(torch state_dict name, flax → torch layout transform) of the flax
    leaf ``collection/path``; raises on a leaf the table does not map."""
    for n in (2, 1):
        rule = LEAF_MAP.get((collection, tuple(path[-n:])))
        if rule is not None and len(path) > n:
            suffix, transform = rule
            return ".".join(path[:-n]) + "." + suffix, transform
    raise KeyError(f"no torch counterpart for flax leaf "
                   f"{collection}/{'/'.join(path)}")


_INVERSE = {suffix: (collection, path) for (collection, path),
            (suffix, _) in LEAF_MAP.items()}


def flax_leaf_path(name: str) -> Tuple[str, Tuple[str, ...]]:
    """(collection, flax path) of the torch state_dict entry ``name``."""
    parts = name.split(".")
    n = 2 if ".".join(parts[-2:]) in _INVERSE else 1
    suffix = ".".join(parts[-n:])
    if suffix not in _INVERSE or len(parts) <= n:
        raise KeyError(f"no flax counterpart for {name}")
    collection, path = _INVERSE[suffix]
    return collection, tuple(parts[:-n]) + path


def _to_flax_layout(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    if path[-2:] == ("conv", "kernel"):
        return arr.transpose(2, 3, 1, 0)                      # OIHW → HWIO
    if path[-1] == "kernel":
        return arr.T[None, None]                              # [O,I] → 1×1 HWIO
    return arr


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables → torch state_dict (f32 tensors on the CPU).

    Leaves of the flax tree may be numpy, torch tensors or anything
    ``np.asarray`` takes. Raises on any leaf the table does not map.
    """
    sd: Dict[str, torch.Tensor] = {}
    for collection, sub in tree.items():
        for path, leaf in _flatten(sub):
            name, transform = torch_leaf_name(collection, path)
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().to("cpu", torch.float32).numpy()
            arr = np.array(leaf, dtype=np.float32)         # own copy
            if transform is not None:
                arr = transform(arr)
            sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse bridge: torch-named tensors (a module's parameters and
    BN statistics, or any subset of them, e.g. their gradients) →
    flax-format variables (f32 numpy copies, HWIO kernels). BN's
    ``num_batches_tracked`` counters are skipped."""
    tree: Dict[str, Any] = {}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        collection, path = flax_leaf_path(name)
        arr = t.detach().to("cpu", torch.float32).numpy().copy()
        node = tree.setdefault(collection, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(_to_flax_layout(path, arr))
    return tree


def params_to_flax(module: torch.nn.Module) -> Dict[str, Any]:
    """An unfused module's parameters and BN statistics → flax-format
    variables (f32 numpy copies, HWIO kernels). For models built from
    random weights, whose only copy is the module."""
    return {"params": {}, "batch_stats": {},
            **state_dict_to_flax(module.state_dict())}


def grads_to_flax(grads) -> Dict[str, Any]:
    """The grad bridge: gradients → a flax-format ``{"params": …}`` tree,
    leaf for leaf comparable with ``jax.grad`` of the reference's loss.

    ``grads`` is a module (its parameters' ``.grad``; parameters without
    one are left out) or a mapping of torch parameter names to gradient
    tensors (what ``pipeline.train`` computes). The layouts go through the
    same transforms as the weights (OIHW → HWIO, Linear → 1×1 HWIO)."""
    if isinstance(grads, torch.nn.Module):
        grads = {n: p.grad for n, p in grads.named_parameters()
                 if p.grad is not None}
    return {"params": {}, **state_dict_to_flax(grads)}


def load_flax_into(module: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Load a flax tree into ``module``; every parameter and BN statistic
    must be covered (BN's ``num_batches_tracked`` counter excepted)."""
    missing, unexpected = module.load_state_dict(params_from_flax(tree),
                                                 strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"flax tree does not match the module: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")


# ---------------------------------------------------------- train states

def _place(t: torch.Tensor, device) -> torch.Tensor:
    """f32 on ``device``; 4-d weights channels_last, as the trainer's
    convolutions take them."""
    t = t.to(device=device, dtype=torch.float32)
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def _tree_to_torch(tree: Mapping, collection: str, device) -> Dict:
    if not tree:
        return {}
    return {n: _place(t, device)
            for n, t in params_from_flax({collection: tree}).items()}


def _tree_to_flax(flat: Mapping, collection: str) -> Dict:
    return state_dict_to_flax(flat).get(collection, {}) if flat else {}


def state_to_flax(state: Dict) -> Dict:
    """A trainer state → the reference's layout: flax-format numpy trees
    (f32, HWIO kernels) for params, batch_stats, the adam moments and
    ema_params; count and step as ints. Other keys (history, best) pass
    through."""
    out = dict(state)
    for key, collection in (("params", "params"),
                            ("batch_stats", "batch_stats"),
                            ("ema_params", "params")):
        if key in state:
            out[key] = _tree_to_flax(state[key], collection)
    if "opt_state" in state:
        opt = state["opt_state"]
        out["opt_state"] = {"count": int(opt["count"]),
                            "mu": _tree_to_flax(opt["mu"], "params"),
                            "nu": _tree_to_flax(opt["nu"], "params")}
    if "step" in state:
        out["step"] = int(state["step"])
    return out


def state_from_flax(state: Dict, device=None) -> Dict:
    """The inverse of ``state_to_flax``: flax-format trees (numpy, or a
    JAX train state carried across as numpy — params, batch_stats, adam
    ``count``/``mu``/``nu`` over the trainable leaves, step, ema_params;
    or a bundle's ``variables``) → the trainer's flat torch-named tensors
    on ``device`` (default: the CPU)."""
    device = torch.device(device or "cpu")
    out = dict(state)
    for key, collection in (("params", "params"),
                            ("batch_stats", "batch_stats"),
                            ("ema_params", "params")):
        if key in state:
            out[key] = _tree_to_torch(state[key], collection, device)
    if "opt_state" in state:
        opt = state["opt_state"]
        out["opt_state"] = {
            "count": int(opt["count"]),
            "mu": _tree_to_torch(opt["mu"], "params", device),
            "nu": _tree_to_torch(opt["nu"], "params", device)}
    if "step" in state:
        out["step"] = int(state["step"])
    return out
