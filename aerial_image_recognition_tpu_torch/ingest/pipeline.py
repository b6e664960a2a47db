"""Host-side ingest plane: fetch → batch → prefetch → device.

Counterpart of ``aerial_image_recognition_tpu/ingest/pipeline.py``. The
reference couples fetching and inference serially per batch
(_script/detector.py:117-155: fetch_batch blocks, then process_batch
blocks). Here the stages are pipelined: fetcher threads produce TileImages,
an assembler packs fixed-shape uint8 batches (padding the tail, so every
step sees one shape), a bounded queue decouples stages, and the executor
uploads batch N+1 while batch N computes — so fetch, H2D copies and the
card's compute overlap. The pipeline tolerates fetch:infer throughput
ratios far below 1 by simply backpressuring on the queue
(SURVEY.md §7 hard part #3).

The upload to a CUDA step is a ring of pinned host buffers and device
buffers, allocated once per scan, with its own copy stream
(``_UploadRing``); ``assemble_batches``, ``TileBatch`` and
``ThreadedPrefetcher`` are copies of the JAX package's.
"""

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from aerial_image_recognition_tpu_torch.fetch.xyz import TileImage


@dataclass
class TileBatch:
    indices: np.ndarray      # [B] int64 global tile indices (−1 = padding)
    images: np.ndarray       # [B, S, S, 3] uint8
    bounds: np.ndarray       # [B, 4] float32 (west, south, east, north)
    n_valid: int
    failed_indices: List[int] = field(default_factory=list)


def assemble_batches(tiles: Iterable[Tuple[int, Optional[TileImage]]],
                     batch_size: int, src_size: int,
                     layout: str = "hwc") -> Iterator[TileBatch]:
    """Pack (index, TileImage) streams into fixed-shape batches.

    Failed tiles (None) are recorded, not batched. The final partial batch
    is zero-padded with index −1 so every device step sees identical shapes
    (one compiled program for the whole scan).

    layout "hwc" is the only one the port's steps take; the reference's
    "s2d2" (the quad stem's space_to_depth^2 packing) raises
    NotImplementedError until the quad stem is ported.
    """
    if layout == "s2d2":
        raise NotImplementedError(
            "the s2d2 batch layout belongs to the quad stem, which is not "
            "ported; the port's steps take [B,S,S,3] batches")
    if layout != "hwc":
        raise ValueError(f"unknown batch layout {layout!r}")
    imgs = np.zeros((batch_size, src_size, src_size, 3), dtype=np.uint8)
    bnds = np.zeros((batch_size, 4), dtype=np.float32)
    idxs = np.full((batch_size,), -1, dtype=np.int64)
    fill = 0
    failed: List[int] = []
    for index, tile in tiles:
        if tile is None:
            failed.append(index)
            continue
        px = tile.pixels
        if px.shape[0] != src_size or px.shape[1] != src_size:
            # tolerate ragged tiles the way the reference did — resize to
            # the expected window (gpu_handler.py:74-76 resized whatever
            # arrived). Misconfigured fetchers emitting a consistent wrong
            # size still surface immediately in coverage/throughput, but a
            # stray odd-sized edge tile no longer kills a city scan.
            from PIL import Image
            px = np.asarray(Image.fromarray(px).resize(
                (src_size, src_size), Image.BILINEAR))
        imgs[fill] = px
        bnds[fill] = tile.bounds
        idxs[fill] = index
        fill += 1
        if fill == batch_size:
            yield TileBatch(idxs.copy(), imgs.copy(), bnds.copy(),
                            fill, failed)
            fill, failed = 0, []
            idxs[:] = -1
    if fill or failed:
        imgs[fill:] = 0
        bnds[fill:] = (0, 0, 1e-6, 1e-6)   # degenerate but finite bounds
        yield TileBatch(idxs.copy(), imgs.copy(), bnds.copy(), fill, failed)


class ThreadedPrefetcher:
    """Runs a batch generator on a daemon thread into a bounded queue.

    ``close()`` ends the thread (within about half a second) even when the
    queue is full: the JAX package's copy blocks there for good on the
    end-of-stream marker."""

    _SENTINEL = object()

    def __init__(self, gen: Iterator[TileBatch], depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def run():
            try:
                for item in gen:
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:     # surfaced on the consumer side
                self._err = e
            finally:
                # after close() nobody may drain a full queue: give up on
                # the sentinel then, so the thread ends instead of blocking
                while True:
                    try:
                        self._q.put(self._SENTINEL, timeout=0.5)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            break

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="ingest-prefetch")
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self, join_timeout: float = 5.0):
        """Stop the producer thread. Call BEFORE tearing down the fetcher
        underneath the generator, or the thread keeps fetching into a dead
        pool (noisy shutdown, wasted requests at city scale). Best-effort
        join: the thread is a daemon, so a fetch blocked in the network
        can't wedge interpreter exit."""
        self._stop.set()
        if join_timeout:
            self._thread.join(timeout=join_timeout)


class _UploadRing:
    """Pinned host buffers and device buffers for a CUDA step, ``slots`` of
    each, allocated at the first batch's shape and reused for the scan,
    with a dedicated copy stream and one staging thread.

    ``upload`` hands batch N+1 to the staging thread, which copies it into
    its slot's pinned buffer (torch's copy releases the interpreter lock,
    so this runs beside the main thread's dispatch of step N) and issues
    the H2D copy on the copy stream. Ordering, per slot: the host buffer is
    rewritten only once the event of its previous H2D copy has completed
    (the staging thread waits); the device buffer is overwritten only once
    the step that read it has finished (the copy stream waits on the event
    ``release`` was given, recorded on the compute stream after that
    step); the step runs only after its own copy's event (``run`` waits for
    the staging of its slot, then the compute stream waits on the event).
    No host sync is added to the step's path. ``stage_s`` is the staging
    thread's busy time.
    """

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = slots
        self.copy_stream = torch.cuda.Stream(device)
        self.stage_s = 0.0
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="upload-ring")
        self._bufs = None
        self._shapes = None
        self._next = 0
        self._staged: List[Optional[Future]] = [None] * slots
        self._copied: List[Optional[torch.cuda.Event]] = [None] * slots
        self._released: List[Optional[torch.cuda.Event]] = [None] * slots

    def _allocate(self, images: np.ndarray, bounds: np.ndarray):
        self._shapes = (images.shape, bounds.shape)
        self._bufs = []
        for _ in range(self.slots):
            self._bufs.append((
                torch.empty(images.shape, dtype=torch.uint8,
                            pin_memory=True),
                torch.empty(bounds.shape, dtype=torch.float32,
                            pin_memory=True),
                torch.empty(images.shape, dtype=torch.uint8,
                            device=self.device),
                torch.empty(bounds.shape, dtype=torch.float32,
                            device=self.device)))

    def upload(self, b: TileBatch) -> int:
        """Start staging batch ``b`` into the next slot; returns the slot.
        A slot is handed out again only after ``run`` took it, so its
        previous staging has finished."""
        images = np.asarray(b.images)
        bounds = np.asarray(b.bounds, dtype=np.float32)
        if images.dtype != np.uint8:
            raise ValueError(f"batch images are {images.dtype}, not uint8")
        if self._bufs is None:
            self._allocate(images, bounds)
        if (images.shape, bounds.shape) != self._shapes:
            raise ValueError(
                f"batch shapes {images.shape}, {bounds.shape} differ from "
                f"the ring's {self._shapes} (batches have one shape a scan)")
        k = self._next
        self._next = (k + 1) % self.slots
        self._staged[k] = self._pool.submit(self._stage, k, images, bounds)
        return k

    def _stage(self, k: int, images: np.ndarray, bounds: np.ndarray):
        t0 = time.perf_counter()
        host_img, host_bnd, dev_img, dev_bnd = self._bufs[k]
        if self._copied[k] is not None:
            self._copied[k].synchronize()      # its last H2D has read it
        # torch's CPU copy runs on the intra-op threads; np.copyto would
        # take one core for a 79 MB batch
        host_img.copy_(torch.from_numpy(np.ascontiguousarray(images))
                       if images.flags.writeable
                       else torch.tensor(images))
        host_bnd.copy_(torch.from_numpy(bounds.copy()))
        with torch.cuda.stream(self.copy_stream):
            if self._released[k] is not None:
                self.copy_stream.wait_event(self._released[k])
            dev_img.copy_(host_img, non_blocking=True)
            dev_bnd.copy_(host_bnd, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self._copied[k] = done
        self.stage_s += time.perf_counter() - t0

    def run(self, k: int, step):
        """Run ``step`` on slot ``k``'s device buffers, on the current
        (compute) stream, after that slot's copy."""
        self._staged[k].result()               # raises what staging raised
        self._staged[k] = None
        torch.cuda.current_stream(self.device).wait_event(self._copied[k])
        _, _, dev_img, dev_bnd = self._bufs[k]
        return step(dev_img, dev_bnd)

    def release(self, k: int, done: "torch.cuda.Event"):
        """``done`` is recorded on the compute stream after the step that
        read slot ``k``: the slot's next H2D copy waits for it."""
        self._released[k] = done

    def close(self):
        """Finish the staging thread and wait for every issued copy
        (buffers may be freed after)."""
        self._pool.shutdown(wait=True)
        self.copy_stream.synchronize()


def run_pipeline(batches: Iterable[TileBatch],
                 step: Callable,
                 on_result: Callable[[TileBatch, tuple], None],
                 prefetch_device: bool = True,
                 depth: int = 1) -> dict:
    """Drive batches through a device step with H2D/compute overlap.

    ``step(images_u8, bounds)`` must return as soon as its work is queued
    (a port ``DetectStep``); ``on_result`` receives (batch, device_outputs)
    and is where host readback (and therefore synchronization) happens —
    by the time result N is being read back, batch N+1's upload and compute
    are already queued.

    The upload target is ``step.device`` (a plain callable without one
    gets CPU tensors). For a CUDA step the upload is a ring of ``depth+1``
    pinned host / device buffer pairs on a dedicated copy stream
    (``_UploadRing``): batch N+1 is copied into its pinned slot on the
    ring's staging thread and issued as an H2D copy while batch N is
    dispatched and computes, and the step receives device tensors. ``prefetch_device=False`` hands the host arrays to the step
    as they are (its own per-call upload then runs). For a CUDA step,
    ``on_result`` runs with a readback stream as the current stream, which
    first waits for an event recorded after that batch's step: its copies
    to the host then wait for that step alone, not for the later batches
    queued behind it on the compute stream (``.cpu()`` on the compute
    stream would), and the stream is synchronized before the outputs can
    be freed.

    depth: how many dispatched-but-unread batches to keep in flight. 1 is
    the classic double-buffer; raise it when per-call latency dominates,
    at the cost of depth× batch device memory.

    Returns stats with the JAX package's keys: batches, tiles, failed,
    h2d_s (host time the uploads took, the pinned copy included; with the
    ring, on its staging thread), compute_s (host time dispatching steps
    and draining results).
    """
    stats = {"batches": 0, "tiles": 0, "failed": 0,
             "h2d_s": 0.0, "compute_s": 0.0}
    it = iter(batches)
    pending: List[Tuple[TileBatch, tuple, Optional[torch.cuda.Event]]] = []
    device = getattr(step, "device", None)
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    cuda = device.type == "cuda"
    ring = _UploadRing(device, depth + 1) if prefetch_device and cuda \
        else None
    readback = torch.cuda.Stream(device) if cuda else None

    def upload(b: TileBatch):
        t0 = time.perf_counter()
        if ring is not None:
            return ring.upload(b)              # timed on the ring's thread
        if prefetch_device:
            d = (torch.from_numpy(np.ascontiguousarray(b.images))
                 .to(device),
                 torch.from_numpy(np.asarray(b.bounds, np.float32))
                 .to(device))
        else:
            d = (b.images, b.bounds)
        stats["h2d_s"] += time.perf_counter() - t0
        return d

    def dispatch(d):
        out = ring.run(d, step) if ring is not None else step(*d)
        if not cuda:
            return out, None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        if ring is not None:
            ring.release(d, done)
        return out, done

    def drain(b: TileBatch, o: tuple, done):
        if done is None:
            on_result(b, o)                # host readback syncs here
        else:
            with torch.cuda.stream(readback):
                readback.wait_event(done)
                on_result(b, o)
                readback.synchronize()
        stats["batches"] += 1
        stats["tiles"] += b.n_valid
        stats["failed"] += len(b.failed_indices)

    try:
        nxt = next(it, None)
        d_nxt = upload(nxt) if nxt is not None else None
        while nxt is not None:
            cur, d_cur = nxt, d_nxt
            nxt = next(it, None)
            d_nxt = upload(nxt) if nxt is not None else None
            t0 = time.perf_counter()
            pending.append((cur, *dispatch(d_cur)))  # queued, not done
            # Drain only batches OLDER than the newest `depth` in flight
            # (draining the just-dispatched batch too would kill the
            # overlap every other iteration).
            while len(pending) > depth:
                drain(*pending.pop(0))
            stats["compute_s"] += time.perf_counter() - t0
        for b, o, done in pending:
            drain(b, o, done)
        pending.clear()
    finally:
        if ring is not None:
            ring.close()
            stats["h2d_s"] = ring.stage_s
    return stats
