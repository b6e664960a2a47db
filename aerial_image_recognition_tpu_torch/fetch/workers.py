"""Worker processes for ``WMSFetcher.fetch_batch``: each tile's request and
decode run outside the scan process, its pixels come back through shared
memory.

In one process the fetch threads queue for the interpreter lock behind the
scan's own Python threads (the step's dispatch, the batch packer): every
``recv`` of a body and every chunk of PIL's decoder gives the lock up and
waits up to the switch interval to get it back, which stretched a request
of the 1280-px scan four-fold and the step's dispatch twenty-fold. Here
those waits happen in other interpreters.

``FetchPool`` starts ``P = min(requests, usable cores, MAX_PROCESSES)``
processes from the ``forkserver`` context, with this module preloaded
there (the package imports torch only on first use, so the server and its
children hold the fetch's modules alone; the scan process has CUDA and
torch threads, so it is never forked). Each child runs
``ceil(requests / P)`` threads, each with a ``TileHTTP`` of its own
(retries, backoff, Retry-After, a ``requests`` session) and the same decode
as in-process (``TileHTTP.get_rgb`` → ``gio.decode.decode_rgb``), so the
pixels are the same bits. The threads keep the configured number of
requests in flight, which a remote server's latency needs. Two processes,
not one a core: a child's interpreter paces its own threads' new
connections, and more children open them in bursts that a server with a
small listen backlog (the benchmark's has socketserver's 5) drops, each
dropped SYN costing the 1 s retransmit. On an H100 host of 8 cores, 2
processes fetched 133-143 tiles/s of 1280 px; 4 and 8 fetched 40-42, a
tenth of their requests stalled for 1 s or 3 s.

The parent hands out at most ``requests`` tasks at a time, each with a slot
of a ring of ``requests`` slots of one tile's bytes each: a file mapped by
every process, on ``/dev/shm`` (tmpfs, as ``shm_open`` makes) where that
can hold it, else under ``tempfile.gettempdir()``, and unlinked once every
child has mapped it. A child writes the RGB array into its task's slot and
sends back through its own pipe only a small message: the slot's shape, the
tile's ``FetchStats`` counters and failure records. One collector thread in
the parent copies each slot into an ordinary array, frees the slot, merges
the counters into the fetcher's ``TileHTTP`` (so ``request_s`` and
``decode_s`` stay thread-seconds summed over every worker thread) and
resolves the tile's future. Pixels never travel through a pipe, whose
reads would take the parent's lock once per 64 KB; only an array larger
than a slot (a server that ignores WIDTH/HEIGHT) does.
"""

import concurrent.futures as cf
import io
import itertools
import math
import mmap
import multiprocessing
import os
import sys
import tempfile
import threading
import time
import traceback
from collections import deque
from multiprocessing import (connection, context, forkserver,
                             popen_forkserver, spawn, util)
from typing import Dict, Optional, Tuple

import numpy as np

from aerial_image_recognition_tpu_torch.fetch.http import (
    FailureLog, FetchStats, TileHTTP)
from aerial_image_recognition_tpu_torch.utils import native

SHM_DIR = "/dev/shm"
START_TIMEOUT_S = 60.0
MAX_PROCESSES = 2


def _ring_file(nbytes: int) -> Tuple[int, str]:
    """An open file of ``nbytes`` with its blocks reserved (so a full
    tmpfs refuses it now instead of a write faulting later): on
    ``SHM_DIR`` where that holds it, else under ``tempfile.gettempdir()``."""
    for folder in (SHM_DIR, tempfile.gettempdir()):
        if not os.path.isdir(folder):
            continue
        fd, path = tempfile.mkstemp(prefix="wms-ring-", dir=folder)
        try:
            os.posix_fallocate(fd, 0, nbytes)
            return fd, path
        except OSError:
            os.close(fd)
            os.unlink(path)
    raise OSError(f"no room for a {nbytes}-byte tile ring on {SHM_DIR} or "
                  f"under {tempfile.gettempdir()}")


def _serve(recv, send, view: np.ndarray, slot_bytes: int, http: TileHTTP):
    """One worker thread of a child: fetch, decode, fill the task's slot."""
    while True:
        tid, slot, url, params = recv()
        http.stats, http.failures = FetchStats(), FailureLog()
        shape = pixels = error = None
        try:
            arr = http.get_rgb(url, params)
            if arr is not None and arr.nbytes <= slot_bytes:
                off = slot * slot_bytes
                view[off:off + arr.nbytes] = arr.reshape(-1)
                shape = arr.shape
            else:
                pixels = arr
        except Exception:                # reported on the tile's future
            error = traceback.format_exc()
        send((tid, shape, pixels, http.stats.counters(),
              http.failures.records(), error))


def _child_main(tasks, conn, ring_path: str, slot_bytes: int, threads: int,
                http_args: Dict, decode_native: bool):
    """A child's body: map the ring, say it is up (and whether CUDA is
    initialised here, which it must not be), then serve the tasks of its
    own pipe ``tasks`` on ``threads`` threads until the parent terminates
    it. The pipes are the child's alone, so a thread that waits here for
    its own interpreter lock holds up only its siblings."""
    if not decode_native:                # the parent's g++ build failed
        native.assume_missing("fastdecode")
    with open(ring_path, "r+b") as f:
        ring = mmap.mmap(f.fileno(), 0)
    view = np.frombuffer(ring, np.uint8)
    torch = sys.modules.get("torch")
    conn.send(("ready", torch is not None and torch.cuda.is_initialized()))
    reading, sending = threading.Lock(), threading.Lock()

    def recv():
        with reading:
            return tasks.recv()

    def send(msg):
        with sending:
            conn.send(msg)

    workers = [threading.Thread(
        target=_serve, args=(recv, send, view, slot_bytes,
                             TileHTTP(**http_args)),
        name=f"wms-{k}", daemon=True) for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()


class _Popen(popen_forkserver.Popen):
    """``popen_forkserver.Popen._launch`` of Python 3.12, but the child is
    not told to run the caller's main module first: its code is this
    module's alone, and a main module that imports torch at its top would
    otherwise cost every pool's start that import in every child."""

    def _launch(self, process_obj):
        prep = {k: v for k, v in
                spawn.get_preparation_data(process_obj._name).items()
                if k not in ("init_main_from_name", "init_main_from_path")}
        buf = io.BytesIO()
        context.set_spawning_popen(self)
        try:
            context.reduction.dump(prep, buf)
            context.reduction.dump(process_obj, buf)
        finally:
            context.set_spawning_popen(None)
        self.sentinel, w = forkserver.connect_to_new_process(self._fds)
        parent_w = os.dup(w)             # the child's sentinel of its parent
        self.finalizer = util.Finalize(self, util.close_fds,
                                       (parent_w, self.sentinel))
        with open(w, "wb", closefd=True) as f:
            f.write(buf.getbuffer())
        self.pid = forkserver.read_signed(self.sentinel)


class _Process(context.ForkServerProcess):
    @staticmethod
    def _Popen(process_obj):
        return _Popen(process_obj)


class FetchPool:
    """``requests`` tile fetches in flight in worker processes (module
    docstring). ``submit(url, params)`` returns a future of the decoded
    uint8 [H, W, 3] array, or of None where the request or the decode
    failed; the counters and failure records of every tile land in
    ``http.stats`` and ``http.failures``. ``tiles`` counts the arrays
    returned, ``processes`` the children, ``ring_path`` where the ring
    was made (unlinked once mapped). ``close()`` terminates the children
    (abandoning requests in flight) and cancels every future not yet
    resolved."""

    def __init__(self, http: TileHTTP, requests: int, slot_bytes: int):
        if requests < 1:
            raise ValueError(f"requests must be at least 1, got {requests}")
        self.http = http
        self.slot_bytes = slot_bytes
        self.tiles = 0
        self.processes = min(requests, len(os.sched_getaffinity(0)),
                             MAX_PROCESSES)
        threads = -(-requests // self.processes)
        self._lock = threading.Lock()
        self._closed = False
        self._broken: Optional[str] = None
        self._free = list(range(requests))
        self._pending: deque = deque()
        self._inflight: Dict[int, Tuple[cf.Future, int, int]] = {}
        self._ids = itertools.count()
        self._procs, self._readers, self._writers = [], [], []
        self._load = [0] * self.processes      # tasks in flight a child
        self._collector: Optional[threading.Thread] = None
        self._ring: Optional[mmap.mmap] = None

        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        http_args = dict(timeout=http.timeout, retries=http.retries,
                         backoff=http.backoff,
                         user_agent=http.session.headers["User-Agent"])
        # built (or found not to build) once here, not in every child
        decode_native = native.load_decode() is not None
        fd, path = _ring_file(requests * slot_bytes)
        self.ring_path = path
        try:
            try:
                self._ring = mmap.mmap(fd, requests * slot_bytes)
            finally:
                os.close(fd)
            for k in range(self.processes):
                tasks_r, tasks_w = ctx.Pipe(duplex=False)
                reader, writer = ctx.Pipe(duplex=False)
                proc = _Process(
                    target=_child_main, name=f"wms-fetch-{k}", daemon=True,
                    args=(tasks_r, writer, path, slot_bytes, threads,
                          http_args, decode_native))
                proc.start()
                tasks_r.close()
                writer.close()           # EOF on ``reader`` if it dies
                self._procs.append(proc)
                self._readers.append(reader)
                self._writers.append(tasks_w)
            self._await_ready()
        except BaseException:
            self.close()
            raise
        finally:
            os.unlink(path)              # mapped by every child, or closed
        self._collector = threading.Thread(target=self._collect,
                                           name="wms-collect", daemon=True)
        self._collector.start()

    def _await_ready(self):
        deadline = time.monotonic() + START_TIMEOUT_S
        for reader, proc in zip(self._readers, self._procs):
            if not reader.poll(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(f"fetch worker {proc.name} did not start "
                                   f"within {START_TIMEOUT_S} s")
            try:
                _, cuda = reader.recv()
            except EOFError:
                raise RuntimeError(f"fetch worker {proc.name} exited while "
                                   "starting") from None
            if cuda:
                raise RuntimeError(f"fetch worker {proc.name} started with "
                                   "CUDA initialised")

    def submit(self, url: str, params: Optional[Dict] = None) -> cf.Future:
        fut: cf.Future = cf.Future()
        with self._lock:
            if self._closed or self._broken:
                raise RuntimeError(self._broken or "the fetch pool is closed")
            self._pending.append((fut, url, params))
            self._dispatch()
        return fut

    def _dispatch(self):
        """Hand pending tiles to the least busy children while slots are
        free (under ``_lock``)."""
        while self._pending and self._free:
            fut, url, params = self._pending.popleft()
            slot = self._free.pop()
            tid = next(self._ids)
            child = self._load.index(min(self._load))
            self._load[child] += 1
            self._inflight[tid] = (fut, slot, child)
            self._writers[child].send((tid, slot, url, params))

    def _collect(self):
        while True:
            for reader in connection.wait(self._readers):
                try:
                    msg = reader.recv()
                except (EOFError, OSError):
                    if not self._closed:
                        self._fail("a fetch worker process exited")
                    return
                self._deliver(msg)

    def _deliver(self, msg):
        tid, shape, pixels, counters, failures, error = msg
        with self._lock:
            fut, slot, child = self._inflight.pop(tid, (None, None, None))
        if fut is None:                  # cancelled by close()
            return
        if shape is not None:
            pixels = np.frombuffer(
                self._ring, np.uint8, math.prod(shape),
                slot * self.slot_bytes).reshape(shape).copy()
        self.http.stats.merge(counters)
        self.http.failures.extend(failures)
        with self._lock:
            self._free.append(slot)
            self._load[child] -= 1
            self._dispatch()
        if error is not None:
            fut.set_exception(RuntimeError(f"tile fetch failed:\n{error}"))
            return
        if pixels is not None:
            self.tiles += 1
        fut.set_result(pixels)

    def _take_all(self):
        """Every unresolved future, forgotten (under ``_lock``)."""
        futs = [f for f, _, _ in self._inflight.values()]
        futs += [f for f, _, _ in self._pending]
        self._inflight.clear()
        self._pending.clear()
        return futs

    def _fail(self, why: str):
        with self._lock:
            self._broken = why
            futs = self._take_all()
        for fut in futs:
            fut.set_exception(RuntimeError(why))

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            futs = self._take_all()
        for proc in self._procs:
            proc.terminate()
        for proc in self._procs:
            proc.join(1.0)
            if proc.exitcode is None:
                proc.kill()
                proc.join()
        if self._collector is not None:
            self._collector.join(1.0)
        for fut in futs:                 # wakes ``as_completed`` too
            fut.cancel()
            fut.set_running_or_notify_cancel()
        for conn in self._readers + self._writers:
            conn.close()
        if self._ring is not None:
            self._ring.close()
