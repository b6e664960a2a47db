"""Detection serving: an HTTP endpoint with dynamic batching.

Counterpart of the detect plane of
``aerial_image_recognition_tpu/pipeline/serve.py`` (``_Pending``,
``_Plane``, ``DetectionServer``); the segmentation plane arrives with the
segmentation slice. Concurrent requests are coalesced into fixed-shape
padded batches, run through the detect step on the card, and split back per
request. A batch thread queues batch N+1 on the device while a readback
thread copies batch N's results to the host.

API:
  POST /detect?west=&south=&east=&north=   body = JPEG/PNG bytes
      → {"detections": [{"lon","lat","confidence","class","yolo"}],
         "count": N}. Images of another size are resized (PIL bilinear) to
      the step's input size first.
  GET  /healthz → {"ok": true, "model": ..., "batch": ..., "input_size": ...}
  GET  /stats   → request/batch counters and timings (``planes.detect``
                  holds the plane's own batches / batch_fill_sum / compute_s);
                  over a turnkey-int8 step also ``quantize_state``,
                  ``quantize_parity`` and, after a fallback,
                  ``quantize_fallback_reason``
"""

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from aerial_image_recognition_tpu_torch.gio.decode import decode_rgb
from aerial_image_recognition_tpu_torch.post.georef import (
    detections_to_records)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig


@dataclass
class _Pending:
    image: np.ndarray
    meta: dict                            # per-plane request context
    # perf_counter after which the waiter has given up (0: never)
    deadline: float = 0.0
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[object] = None
    error: Optional[str] = None


class _Plane:
    """One model's dynamic-batching plane.

    A request queue, a batch thread that assembles fixed-shape padded
    batches and dispatches them (the step returns once its work is queued
    on the card), and a readback thread that materializes results one batch
    behind dispatch. ``dispatch(group)`` returns an opaque payload of device
    tensors; ``finish(payload, group)`` materializes it and sets
    ``p.result`` for every request in the group.
    """

    def __init__(self, server: "DetectionServer", name: str, batch: int,
                 input_size: int,
                 dispatch: Callable[[List[_Pending]], object],
                 finish: Callable[[object, List[_Pending]], None]):
        self.server = server
        self.name = name
        self.batch = batch
        self.input_size = input_size
        self.dispatch = dispatch
        self.finish = finish
        self.counters = {"batches": 0, "batch_fill_sum": 0, "compute_s": 0.0}
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        # dispatched-but-unread batches: depth 2 bounds in-flight device
        # memory while letting the next batch assemble and dispatch
        self.inflight: "queue.Queue" = queue.Queue(maxsize=2)
        self.batch_thread = threading.Thread(
            target=self._batch_loop, daemon=True,
            name=f"serve-batch-{name}")
        self.readback_thread = threading.Thread(
            target=self._readback_loop, daemon=True,
            name=f"serve-readback-{name}")

    def start(self):
        self.batch_thread.start()
        self.readback_thread.start()

    def join(self, timeout: float):
        if self.batch_thread.is_alive():
            self.batch_thread.join(timeout=timeout)
        if self.readback_thread.is_alive():
            self.readback_thread.join(timeout=timeout)

    def drain(self, error: str):
        """Release queued waiters immediately (stop() path)."""
        try:
            while True:
                p = self.q.get_nowait()
                p.error = error
                p.event.set()
        except queue.Empty:
            pass

    def _broadcast_error(self, group: List[_Pending], err: str):
        with self.server._stats_lock:
            self.server.stats["errors"] += len(group)
        for p in group:
            p.error = err
            p.event.set()

    def _batch_loop(self):
        server = self.server
        while not server._stop.is_set():
            try:
                first = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            group = [first]
            deadline = time.perf_counter() + server.max_wait_s
            while len(group) < self.batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    group.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            # don't burn device time on waiters that already gave up
            group = [p for p in group
                     if p.deadline == 0.0
                     or time.perf_counter() < p.deadline]
            if not group:
                continue
            t0 = time.perf_counter()
            try:
                payload = self.dispatch(group)
            except Exception as e:                  # surface to all waiters
                self._broadcast_error(group, repr(e))
                continue
            self.inflight.put((group, payload, t0))

    def _readback_loop(self):
        """Device→host readback + per-request reply, one batch behind
        dispatch. A device error surfacing at readback is broadcast to the
        batch's waiters."""
        server = self.server
        while True:
            try:
                item = self.inflight.get(timeout=0.2)
            except queue.Empty:
                # exit only once no more batches can arrive: stop requested
                # AND the dispatching thread is gone AND the queue stayed
                # empty — every dispatched batch is read back, never dropped
                if server._stop.is_set() and not self.batch_thread.is_alive():
                    try:
                        item = self.inflight.get_nowait()
                    except queue.Empty:
                        return
                else:
                    continue
            group, payload, t0 = item
            try:
                self.finish(payload, group)
                dt = time.perf_counter() - t0
            except Exception as e:
                self._broadcast_error(group, repr(e))
                continue
            for p in group:
                p.event.set()
            with server._stats_lock:
                server.stats["batches"] += 1
                server.stats["batch_fill_sum"] += len(group)
                server.stats["compute_s"] += dt
                self.counters["batches"] += 1
                self.counters["batch_fill_sum"] += len(group)
                self.counters["compute_s"] += dt


class DetectionServer:
    """HTTP detection service over the port's detect step.

    detect_step: a built step (any object with the DetectStep surface);
    without one, ``build_detect_step`` builds it from ``config`` on
    ``device`` (default ``cuda``; raises without CUDA).
    """

    def __init__(self, config: Optional[Dict] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_wait_ms: float = 10.0, detect_step=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = DetectorConfig().merged(config or {})
        if detect_step is None:
            from aerial_image_recognition_tpu_torch.pipeline.inference import (
                build_detect_step)
            detect_step = build_detect_step(
                self.config, batch=self.config.device_batch, device=device)
        self.step = detect_step
        self.max_wait_s = max_wait_ms / 1000.0
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "detections": 0,
                      "errors": 0, "timeouts": 0, "batch_fill_sum": 0,
                      "resized": 0, "compute_s": 0.0}
        self._stats_lock = threading.Lock()

        self._planes: Dict[str, _Plane] = {
            "detect": _Plane(self, "detect", detect_step.batch,
                             detect_step.input_size,
                             self._detect_dispatch, self._detect_finish)}

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, payload: Dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._reply(200, {
                        "ok": True, "model": server.step.bundle.spec.name,
                        "batch": server.step.batch,
                        "input_size": server.step.input_size})
                elif path == "/stats":
                    with server._stats_lock:
                        out = dict(server.stats)
                        out["planes"] = {n: dict(pl.counters)
                                         for n, pl in server._planes.items()}
                    # turnkey int8 (a SelfQuantizingStep): state and parity
                    # are the operator's only window into whether the
                    # hot-swap happened and what validated it
                    qs = getattr(server.step, "quantize_state", None)
                    if qs is not None:
                        out["quantize_state"] = qs
                        out["quantize_parity"] = server.step.parity
                        if server.step.fallback_reason:
                            out["quantize_fallback_reason"] = \
                                server.step.fallback_reason
                    self._reply(200, out)
                else:
                    self._reply(404, {"error": "unknown path"})

            def _read_image(self, plane: _Plane):
                """Read + decode the request body, resize to the plane's
                input size. Returns the image, or None after replying."""
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                img = decode_rgb(body)
                if img is None:
                    with server._stats_lock:
                        server.stats["errors"] += 1
                    self._reply(400, {"error": "undecodable image"})
                    return None
                s = plane.input_size
                if img.shape[0] != s or img.shape[1] != s:
                    from PIL import Image
                    img = np.asarray(Image.fromarray(img).resize(
                        (s, s), Image.BILINEAR))
                    with server._stats_lock:
                        server.stats["resized"] += 1
                return img

            def _enqueue_and_wait(self, plane: _Plane,
                                  p: _Pending) -> bool:
                """Queue p on the plane and block for its answer. Returns
                True if p.result is valid; replies 503 itself otherwise."""
                plane.q.put(p)
                # stop() may have drained the queue between the handler's
                # check and this put: answer now instead of waiting out a
                # queue no loop services
                if server._stop.is_set() and not p.event.is_set():
                    p.error = p.error or "server stopping"
                    p.event.set()
                p.event.wait(timeout=60.0)
                if p.result is None:
                    with server._stats_lock:
                        server.stats["errors"] += 1
                        server.stats["timeouts"] += p.error is None
                    self._reply(503, {"error": p.error or "timed out"})
                    return False
                return True

            def do_POST(self):
                path = urlparse(self.path).path
                if path != "/detect":
                    self._reply(404, {"error": "unknown path"})
                    return
                if server._stop.is_set():
                    self._reply(503, {"error": "server stopping"})
                    return
                q = parse_qs(urlparse(self.path).query)
                try:
                    bounds = np.asarray(
                        [float(q[k][0]) for k in
                         ("west", "south", "east", "north")], np.float32)
                except (KeyError, ValueError):
                    self._reply(400, {"error": "west/south/east/north "
                                      "query params required"})
                    return
                plane = server._planes["detect"]
                img = self._read_image(plane)
                if img is None:
                    return
                p = _Pending(image=img, meta={"bounds": bounds},
                             deadline=time.perf_counter() + 60.0)
                if not self._enqueue_and_wait(plane, p):
                    return
                with server._stats_lock:
                    server.stats["requests"] += 1
                    server.stats["detections"] += len(p.result)
                self._reply(200, {"detections": p.result,
                                  "count": len(p.result)})

        class _Server(ThreadingHTTPServer):
            # the default listen backlog of 5 drops connections under a
            # burst of concurrent clients
            request_queue_size = 128

        self._httpd = _Server((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="serve-http")

    # ----------------------------------------------------- plane callbacks

    def _detect_dispatch(self, group: List[_Pending]):
        step = self.step
        b, s = step.batch, step.input_size
        imgs = np.zeros((b, s, s, 3), np.uint8)
        bnds = np.full((b, 4), (0, 0, 1e-6, 1e-6), np.float32)
        for i, p in enumerate(group):
            imgs[i] = p.image
            bnds[i] = p.meta["bounds"]
        det, _lon, _lat = step(imgs, bnds)
        return det, bnds

    def _detect_finish(self, payload, group: List[_Pending]):
        det, bnds = payload
        step = self.step
        recs = detections_to_records(
            det, bnds, model_size=step.model_size,
            class_names=step.bundle.spec.class_names)
        by_tile: Dict[int, List[dict]] = {}
        for r in recs:
            by_tile.setdefault(r.pop("tile_index"), []).append(r)
        for i, p in enumerate(group):
            p.result = by_tile.get(i, [])

    # ------------------------------------------------------------ lifecycle

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self, warmup: bool = True):
        if warmup:
            # one batch before accepting traffic: the first call builds the
            # CUDA kernel and lets cuDNN pick its convolution algorithms
            b, sz = self.step.batch, self.step.input_size
            imgs = np.zeros((b, sz, sz, 3), np.uint8)
            bnds = np.full((b, 4), (0, 0, 1e-6, 1e-6), np.float32)
            _det, lon, _lat = self.step(imgs, bnds)
            float(lon.sum())
        self._serve_thread.start()
        for plane in self._planes.values():
            plane.start()
        return self

    def stop(self):
        self._stop.set()
        # release queued waiters now instead of letting their 60 s waits
        # expire; in-flight batches still complete (each readback loop
        # drains until its batch thread is dead and its queue empty)
        for plane in self._planes.values():
            plane.drain("server stopping")
        for plane in self._planes.values():
            plane.join(timeout=90.0)
        self._httpd.shutdown()
        self._httpd.server_close()
