"""Training-state checkpoints: params, BN statistics, optimizer, step.

Counterpart of ``aerial_image_recognition_tpu/runtime/train_ckpt.py``, with
its signatures. The reference writes each ``epoch_N`` directory with orbax;
the port may not depend on orbax, so it writes one flat npz there,
``train_state.npz``, keyed by flax paths in the reference's layout
(``models/weights.state_to_flax``): ``params/…``, ``batch_stats/…``,
``opt_state/mu/…``, ``opt_state/nu/…``, ``opt_state/count``, ``step`` and
``ema_params/…``. A round trip is exact, and ``pipeline.train.fit``
resumes from it.
"""

import os
from typing import Dict

import numpy as np

from aerial_image_recognition_tpu_torch.models.weights import (
    state_from_flax, state_to_flax)

FILENAME = "train_state.npz"
_SKIP = ("history", "best")


def _flat(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v)


def save_train_state(state: Dict, path: str) -> None:
    """Write the trainer's ``state`` into the directory ``path``,
    replacing what was there."""
    flat: Dict[str, np.ndarray] = {}
    _flat({k: v for k, v in state_to_flax(state).items()
           if k not in _SKIP}, "", flat)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILENAME + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, os.path.join(path, FILENAME))


def load_train_state(path: str, template: Dict) -> Dict:
    """template: a trainer state with the right structure (e.g. a fresh
    ``init_train_state``); the restored state comes back in the trainer's
    format, on the template's device. Raises ``KeyError`` when the
    checkpoint lacks a part of the template (e.g. ``ema_params``)."""
    tree: Dict = {}
    with np.load(os.path.join(os.path.abspath(path), FILENAME)) as data:
        for key, value in data.items():
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.array(value)
    missing = [k for k in template if k not in _SKIP and k not in tree]
    if missing:
        raise KeyError(f"train checkpoint {path!r} has no {missing}")
    out = {k: tree[k] for k in template if k not in _SKIP}
    device = next(iter(template["params"].values())).device
    return state_from_flax(out, device)
