"""Load ultralytics ``.pt`` checkpoints without the ultralytics package.

Copy of ``aerial_image_recognition_tpu/models/torch_pt.py``.

The reference ships its trained Tokyo model as ``yolov8_tokyo_checkpoint.pt``
(produced by x_arch/01_train_tokyo.ipynb cell 14; listed in
.MISSING_LARGE_BLOBS) alongside the .onnx export. An ultralytics checkpoint
pickles the ENTIRE ``DetectionModel`` object — ``torch.load`` therefore
needs the ultralytics package to resolve its classes, which the port does
not depend on. This loader substitutes an inert stub class for any
class the unpickler cannot import and then reconstructs the flat
``{upstream_name: float32 array}`` state dict by walking the stubbed
module tree's ``_parameters`` / ``_buffers`` / ``_modules`` attributes —
exactly what ``nn.Module`` pickles through its plain ``__dict__``.

The result feeds ``import_torch.variables_from_torch_state`` (the same
chain the .onnx drop uses), so either artifact class the reference
distributes reaches the port's modules.
"""

import pickle
import types
from collections import OrderedDict
from typing import Any, Dict

import numpy as np

__all__ = ["load_checkpoint_state"]


def _make_stub(module: str, name: str) -> type:
    """An attribute-bag class standing in for a disallowed one.

    pickle rebuilds plain objects via ``cls.__new__(cls)`` +
    ``__dict__.update(state)`` — no constructor call — so an empty class
    faithfully captures whatever attribute tree the original carried.
    ``__new__``/``__init__`` swallow constructor args so REDUCE/NEWOBJ
    opcodes targeting a stubbed callable become inert no-ops instead of
    executing anything.
    """
    return type(name, (), {
        "__module__": module,
        "_aerial_stub_origin": f"{module}.{name}",
        "__new__": lambda cls, *a, **k: object.__new__(cls),
        "__init__": lambda self, *a, **k: None,
    })


_NUMPY_MODULES = {"numpy", "numpy.core.multiarray", "numpy._core.multiarray"}
_NUMPY_NAMES = {"ndarray", "dtype", "_reconstruct", "scalar", "bool_"}


class _StubUnpickler(pickle.Unpickler):
    """Allowlist unpickler: only the primitives needed to rebuild tensors
    resolve to real callables; EVERY other global — importable or not —
    becomes an inert stub. A crafted .pt whose stream references e.g.
    ``os.system`` therefore gets a do-nothing class, not code execution,
    while the module-tree walker below still sees the full attribute tree.
    """

    def find_class(self, module, name):
        if self._allowed(module, name):
            return super().find_class(module, name)
        return _make_stub(module, name)

    @staticmethod
    def _allowed(module: str, name: str) -> bool:
        if module == "collections" and name in ("OrderedDict", "defaultdict",
                                                "deque"):
            return True
        # torch's tensor/parameter reconstruction helpers (pure rebuilds,
        # the same set torch's own weights_only unpickler trusts)
        if module == "torch._utils" and name.startswith("_rebuild_"):
            return True
        if module == "torch" and name in ("Size", "device"):
            return True
        # legacy typed-storage globals referenced by persistent-id tuples
        if module == "torch" and name.endswith("Storage"):
            return True
        if module == "torch.storage" and name in (
                "TypedStorage", "UntypedStorage",
                "_TypedStorage", "_UntypedStorage"):
            return True
        if module == "torch":
            import torch
            obj = getattr(torch, name, None)
            return isinstance(obj, torch.dtype)   # torch.float16 etc.
        if module == "torch.serialization" and name == "_get_layout":
            return True
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return True
        return False


def _stub_pickle_module() -> types.ModuleType:
    """A pickle-compatible module object torch.load accepts as
    ``pickle_module`` (it only uses ``.Unpickler`` and ``.load``)."""
    mod = types.ModuleType("aerial_stub_pickle")
    mod.Unpickler = _StubUnpickler
    mod.load = lambda f, **kw: _StubUnpickler(f, **kw).load()
    mod.UnpicklingError = pickle.UnpicklingError
    return mod


def _to_array(v) -> np.ndarray:
    import torch

    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype in (torch.float16, torch.bfloat16, torch.float64):
            t = t.float()          # ultralytics saves half; the bridge is f32
        return t.numpy()
    return np.asarray(v)


def _walk_module(obj, prefix: str, out: Dict[str, np.ndarray]) -> None:
    d = getattr(obj, "__dict__", None)
    if d is None:
        return
    for bag in ("_parameters", "_buffers"):
        for k, v in (d.get(bag) or {}).items():
            if v is not None:
                out[prefix + k] = _to_array(v)
    for k, child in (d.get("_modules") or {}).items():
        if child is not None:
            _walk_module(child, f"{prefix}{k}.", out)


def load_checkpoint_state(path: str) -> Dict[str, np.ndarray]:
    """``.pt`` checkpoint → flat upstream-named float32 state dict.

    Accepts the ultralytics layout ({'model': DetectionModel, 'ema': ...,
    'epoch': ...} — EMA weights preferred, matching ultralytics' own
    deploy choice), a bare pickled module, or a plain
    ``torch.save(model.state_dict())`` dict of tensors.
    """
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_stub_pickle_module())
    obj: Any = ckpt
    if isinstance(ckpt, dict) and ("model" in ckpt or "ema" in ckpt):
        obj = ckpt.get("ema") or ckpt["model"]
    if isinstance(obj, (dict, OrderedDict)):
        return {k: _to_array(v) for k, v in obj.items()
                if isinstance(v, torch.Tensor) or isinstance(v, np.ndarray)}
    out: Dict[str, np.ndarray] = {}
    _walk_module(obj, "", out)
    if not out:
        raise ValueError(f"{path!r}: no parameters found — not an "
                         "ultralytics-style checkpoint or a state dict")
    return out
