"""Device mesh helpers: data parallelism over tiles.

Counterpart of ``aerial_image_recognition_tpu/parallel/mesh.py``. The
reference's parallelism is a 1-D ``data`` mesh: batches split on dim 0,
parameters replicated. PyTorch has no mesh object that eager code needs,
so the port's ``Mesh`` is an ordered list of ``torch.device``s with an axis
name, plus the process group when the mesh spans processes
(``parallel/distributed.py``). A shard's global index is its position,
process-major: process p's local shard k is shard ``p·len(devices) + k``.

A mesh may repeat a device where its caller lists the devices itself:
``Mesh([torch.device("cpu")] * 8)`` is the counterpart of XLA's eight
virtual host devices (the CPU tests, ``--data-parallel N --device cpu``),
and ``Mesh(["cuda:0", "cuda:0"])`` runs two shards on one card. Shards on
one device share its replica of the weights and run one after another on
its stream. ``make_mesh`` and ``mesh_from_flag`` list each card once.

The reference's ``batch_sharding`` and ``replicated`` (NamedShardings) are
subsumed by ``Mesh.rows`` and ``replicate``.
"""

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """An ordered list of this process's devices on one axis; ``group`` is
    the ``torch.distributed`` process group when the mesh spans processes
    (each holding ``len(devices)`` shards), else None."""

    def __init__(self, devices: Sequence[DeviceLike], axis_name: str = "data",
                 group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name
        self.group = group

    @property
    def process_count(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def process_index(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.local_size * self.process_count

    @property
    def shape(self) -> dict:
        """{axis name: shard count}, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: self.size}

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The devices in first-appearance order, each once."""
        return tuple(dict.fromkeys(self.devices))

    def rows(self, batch: int) -> Tuple[Tuple[torch.device, int, int], ...]:
        """(device, first row, end row) of each local shard for a local
        batch of ``batch`` rows; raises ValueError naming the mesh when the
        rows do not divide evenly."""
        n = self.local_size
        if batch % n:
            raise ValueError(
                f"batch {batch} must divide evenly over the {n}-device "
                f"'{self.axis_name}' mesh axis (a multiple of {n})")
        m = batch // n
        return tuple((d, k * m, (k + 1) * m)
                     for k, d in enumerate(self.devices))

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_name={self.axis_name!r}, "
                f"processes={self.process_count})")


def _default_group():
    import torch.distributed as dist
    return dist.group.WORLD if dist.is_available() \
        and dist.is_initialized() else None


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> Mesh:
    """The first ``n_devices`` visible CUDA cards (all without a count),
    each once. Like the reference's ``devs[:n]`` it truncates silently: a
    count above the number of cards gives every card and no error. Raises
    when there is no card. Under a ``torch.distributed`` process group
    (``parallel/distributed.py``) a process drives one card: the mesh is
    its current card alone (any count truncates to it) and spans the
    processes."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible; list the "
                           "devices yourself (Mesh([...])) for the CPU")
    group = _default_group()
    if group is not None:
        devs = [torch.device("cuda", torch.cuda.current_device())]
    else:
        devs = [torch.device("cuda", i) for i in range(count)]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, axis_name, group=group)


def mesh_from_flag(dp, device: Optional[DeviceLike] = None) -> Optional[Mesh]:
    """Config-level data-parallel knob → mesh (None when off).

    ``True`` means every visible card and an int that many (``make_mesh``,
    truncating as it does). With ``device`` on the CPU the mesh is that
    many shards of the CPU (``True``: one), as XLA's virtual host devices
    are; CarDetector, DetectionServer and the CLI share this, so
    ``data_parallel: true`` means the same everywhere. Under a process
    group each process has one device, as ``make_mesh``'s."""
    if not dp:
        return None
    n = None if isinstance(dp, bool) else int(dp)
    if device is not None and torch.device(device).type == "cpu":
        group = _default_group()
        return Mesh([torch.device("cpu")] * (1 if group is not None
                                             else n or 1), group=group)
    return make_mesh(n)


def shard_batch(mesh: Mesh, *arrays):
    """Host arrays (or tensors) → per-shard tensors on the mesh's devices,
    split on dim 0 (``Mesh.rows``): a list of tensors for each array."""
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(a))
        out.append([t[lo:hi].to(d)
                    for d, lo, hi in mesh.rows(t.shape[0])])
    return out[0] if len(out) == 1 else tuple(out)


def replicate(mesh: Mesh, tree):
    """A copy of ``tree`` (tensors in dicts, lists and tuples) on each
    distinct device of the mesh: {device: tree}. A device the tree already
    lives on gets the tree itself."""
    def to(t, d):
        if isinstance(t, torch.Tensor):
            return t if t.device == d else t.to(d)
        if isinstance(t, dict):
            return {k: to(v, d) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(to(v, d) for v in t)
        return t
    return {d: to(tree, d) for d in mesh.distinct_devices}


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> Tuple[np.ndarray, int]:
    """Pad axis to a multiple (static shapes for pjit); returns (arr, n_pad)."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, 0
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill), pad
