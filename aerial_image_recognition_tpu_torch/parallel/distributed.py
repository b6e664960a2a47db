"""Multi-process scaling on ``torch.distributed``.

Counterpart of ``aerial_image_recognition_tpu/parallel/distributed.py``.
Every process joins one process group, fetches ONLY its own AOI stripe's
tiles (``host_stripe``), runs the detect step on its device, and the
records are merged by the exact host dedup (``merge_host_detections``). The
data-parallel train step (``pipeline/train.py``) all-reduces over the same
group.

Under a process group each process drives ONE device: ``initialize`` makes
card ``rank % count`` its current device, ``make_mesh``/``mesh_from_flag``
give it a mesh of that device alone (the process group spans the rest), and
``context`` counts one local device. (The reference runs one process per
host over all its chips; NCCL wants a process per card.)

``initialize`` reads the reference's own variables
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
so a launcher written for it needs no change, and calls
``torch.distributed.init_process_group`` on a TCP store at that address.
The backend is an explicit argument: ``nccl`` where each process drives its
own card, ``gloo`` on the CPU (and for processes that share one card: NCCL
refuses two ranks on one GPU; gloo reduces and broadcasts CUDA tensors).
It never switches backend on its own.
"""

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class DistributedContext:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: str = "nccl",
               timeout_s: float = 300.0) -> DistributedContext:
    """Join (or skip, without a coordinator address) the process group.

    Arguments default from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID. ``coordinator_address`` is ``host:port`` (or
    ``tcp://host:port``); process 0 hosts the store there. ``backend`` is
    given to ``init_process_group`` as it is. Where a card is visible each
    process takes the card of its rank modulo the visible count as its
    current device (a card per process; processes share cards round-robin
    when there are more of them, which only gloo allows). Without an
    address this is a world of one with no group, as the reference's
    single-host default."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address and not dist.is_initialized():
        n = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        pid = process_id if process_id is not None else int(
            os.environ.get("JAX_PROCESS_ID", "0"))
        addr = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        if torch.cuda.is_available():
            torch.cuda.set_device(pid % torch.cuda.device_count())
        from datetime import timedelta
        dist.init_process_group(backend, init_method=addr, world_size=n,
                                rank=pid,
                                timeout=timedelta(seconds=timeout_s))
    return context()


def context() -> DistributedContext:
    """The rank, world size and device counts of this process: every
    visible card outside a process group, one device per process in
    one."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        local = torch.cuda.device_count() if torch.cuda.is_available() \
            else 1
        return DistributedContext(0, 1, local, local)
    world = dist.get_world_size()
    return DistributedContext(
        process_index=dist.get_rank(), process_count=world,
        local_devices=1, global_devices=world)


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where a collective's buffer must live: the current card for NCCL,
    the CPU for gloo."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(x) -> np.ndarray:
    """``multihost_utils.process_allgather`` of a numpy array (or
    anything ``np.asarray`` takes) of the same shape and dtype on every
    process → stacked [process_count, *shape] on the host, process-major.
    Built on ``all_reduce`` (each process writes its row of a zero buffer),
    so it runs on every backend, gloo with CUDA tensors included. Outside a
    process group it returns ``x[None]``."""
    import torch.distributed as dist
    a = np.ascontiguousarray(np.asarray(x))
    if not (dist.is_available() and dist.is_initialized()):
        return a[None].copy()
    n, r = dist.get_world_size(), dist.get_rank()
    dtype = a.dtype
    wide = a.astype(np.float64) if dtype.kind == "f" else a.astype(np.int64)
    buf = torch.zeros((n,) + a.shape, dtype=torch.from_numpy(wide).dtype,
                      device=_comm_device())
    buf[r] = torch.from_numpy(wide).to(buf.device)
    dist.all_reduce(buf)
    return buf.cpu().numpy().astype(dtype)


def host_stripe(bounds, ctx: DistributedContext,
                halo_m: float = 64.0) -> Tuple[float, float, float, float]:
    """The WGS84 sub-AOI this host should fetch and scan: one stripe per
    process, halo-widened so cross-host dedup only needs the boundary
    band."""
    from aerial_image_recognition_tpu_torch.parallel.stripes import (
        split_aoi_stripes)
    stripes, _, _ = split_aoi_stripes(bounds, max(ctx.process_count, 1),
                                      halo_m=halo_m)
    return tuple(stripes[ctx.process_index])


def merge_host_detections(records, radius_m: float):
    """After per-host scans write per-stripe GeoJSONs, any host (or a
    coordinating process) concatenates and runs the global dedup — the
    exact grid-bucketed one, so the merged output equals a single-host
    scan."""
    from aerial_image_recognition_tpu_torch.post.dedup import dedup_records
    return dedup_records(list(records), radius_m)
