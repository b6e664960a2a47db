"""Observability: phase timers, JSONL event log, device monitor.

Counterpart of ``aerial_image_recognition_tpu/runtime/observability.py``.
Replaces the reference's ad-hoc timing dicts and GPUMonitor daemon
(SURVEY.md §5: simple_detector.py:750-757 phase breakdown;
_script/monitors.py:9-81 GPUtil/psutil thread with in-place console line)
with structured equivalents: a PhaseTimer producing the same phase-breakdown
report, a JSONL event stream, a Tracer over ``torch.profiler``, and a
DeviceMonitor sampling the CUDA card's memory (``torch.cuda``) plus process
RSS. ``PhaseTimer``, ``EventLog``, ``ProgressBar`` and ``_FetchProgress``
are copies; the monitor keeps the field names ``hbm_used_mb`` and
``hbm_limit_mb`` that event-log readers parse.
"""

import json
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional


class PhaseTimer:
    """Accumulating named-phase wall-clock timers (thread-safe: the
    prefetch thread times tile_fetching and batch_packing while the main
    thread times processing, ingest_wait, batch_dispatch and result_drain).

    ``phase`` also opens the annotation ``Tracer.annotate(name)``, so every
    phase shows in a ``torch.profiler`` trace on the clock of the CUDA
    kernels and copies. ``add`` is for totals with no single start and
    end (the fetch workers' request and decode seconds)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        with Tracer.annotate(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def report(self) -> Dict[str, float]:
        with self._lock:                   # snapshot: add() runs on
            totals = dict(self.totals)     # fetch threads concurrently
        return {k: round(v, 3) for k, v in totals.items()}

    def format_report(self) -> str:
        # same shape as the reference's exit printout
        # (simple_detector.py:921-929)
        with self._lock:
            totals = dict(self.totals)
        total = sum(totals.values()) or 1.0
        lines = ["Phase breakdown:"]
        for k, v in sorted(totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<22s} {v:8.2f}s ({100 * v / total:5.1f}%)")
        return "\n".join(lines)


class EventLog:
    """Append-only JSONL event stream (thread-safe)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def emit(self, kind: str, **fields):
        if not self.path:
            return
        rec = {"ts": time.time(), "kind": kind, **fields}
        line = json.dumps(rec, default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


_UNTRACED = nullcontext()


class Tracer:
    """torch.profiler integration — the structured replacement for the
    reference's disabled ORT profiling (_script/gpu_handler.py:57).

    Usage: ``with Tracer("trace_dir"): run_batches()`` writes a Chrome
    trace (``trace.json``, host and, where there is one, CUDA activity)
    into the directory; annotate regions with ``Tracer.annotate(name)``
    (``torch.profiler.record_function``). ``log_dir=None`` traces nothing.
    The profiler records every thread's annotations (the fetch workers'
    and the prefetch thread's too), not only those of the thread that
    entered it.
    """

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        if self.log_dir:
            import torch
            from torch.profiler import (
                ProfilerActivity, _ExperimentalConfig, profile)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True)))
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.log_dir, "trace.json"))
            self._prof = None
        return False

    @staticmethod
    def annotate(name: str):
        """``torch.profiler.record_function(name)`` while a profiler
        records, in any thread; otherwise a null context, which costs a
        flag read where record_function costs microseconds. The flag is
        torch's own, read without loading torch."""
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is None or not prof._is_profiler_enabled:
            return _UNTRACED
        import torch
        return torch.profiler.record_function(name)


class DeviceMonitor:
    """Daemon thread: the step's CUDA card memory + host RSS every
    ``interval`` seconds.

    Parity slot for the reference GPUMonitor (_script/monitors.py): same
    start()/stop() lifecycle, console line + log file, sourcing device
    stats from ``torch.cuda``. ``device`` is the step's device (None: the
    current CUDA device when there is one); a CPU device reports no device
    fields, only ``device_error``, as the JAX monitor does when its device
    stats are unavailable.
    """

    def __init__(self, interval: float = 30.0,
                 log_path: Optional[str] = None,
                 event_log: Optional[EventLog] = None,
                 print_line: bool = True, device=None):
        self.interval = interval
        self.log_path = log_path
        self.event_log = event_log
        self.print_line = print_line
        self.device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> Dict:
        import torch
        out: Dict = {"ts": time.time()}
        dev = torch.device(self.device if self.device is not None
                           else "cuda")
        if dev.type != "cuda":
            out["device_error"] = f"no device memory stats on {dev}"
        elif not torch.cuda.is_available():
            out["device_error"] = "CUDA is not available"
        else:
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            free, total = torch.cuda.mem_get_info(dev)
            out["device"] = f"{dev} {torch.cuda.get_device_name(dev)}"
            out["hbm_used_mb"] = round(
                torch.cuda.memory_allocated(dev) / 1e6, 1)
            out["hbm_limit_mb"] = round(total / 1e6, 1)
            out["hbm_free_mb"] = round(free / 1e6, 1)
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        out["host_rss_mb"] = round(
                            int(line.split()[1]) / 1024.0, 1)
                        break
        except OSError:
            pass
        return out

    def _run(self):
        while not self._stop.wait(self.interval):
            s = self.sample()
            if self.print_line:
                line = (f"[monitor] hbm {s.get('hbm_used_mb', '?')}/"
                        f"{s.get('hbm_limit_mb', '?')} MB | "
                        f"rss {s.get('host_rss_mb', '?')} MB")
                print("\r" + line, end="", flush=True)
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(s) + "\n")
            if self.event_log:
                self.event_log.emit("monitor", **s)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-monitor")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)


class ProgressBar:
    """Minimal tqdm-style progress line — the reference's primary user
    feedback (tqdm at batch and tile level, _script/detector.py:128-133 and
    :188-193), first-party since tqdm isn't a dependency here.

    Renders `desc:  42%|████      | 420/1000 [rate/s, ETA 0:42, k=v]` to
    ``stream`` (stderr), redrawing in place at most every ``min_interval``
    seconds. ``enabled=None`` auto-detects a tty; pass True/False to force
    (CarDetector wires config.extra['progress']). ``set_postfix`` adds
    live counters (detections, fetched tiles). Thread-safe for the
    single-writer-per-counter use the pipeline makes of it.
    """

    def __init__(self, total: int, desc: str = "", unit: str = "tile",
                 initial: int = 0, stream=None, enabled: bool = None,
                 min_interval: float = 0.1, width: int = 24):
        import sys
        self.total = max(int(total), 1)
        self.n = int(initial)
        self.desc = desc
        self.unit = unit
        self.stream = stream if stream is not None else sys.stderr
        if enabled is None:
            enabled = bool(getattr(self.stream, "isatty", lambda: False)())
        self.enabled = enabled
        self.min_interval = min_interval
        self.width = width
        self._postfix = {}
        self._t0 = time.time()
        self._last_draw = 0.0
        self._start_n = int(initial)
        if self.enabled:
            self._draw(force=True)

    def update(self, n: int = 1):
        self.n += n
        self._draw()

    def set_postfix(self, **kw):
        self._postfix.update(kw)
        self._draw()

    def _render(self) -> str:
        frac = min(self.n / self.total, 1.0)
        filled = int(frac * self.width)
        bar = "█" * filled + " " * (self.width - filled)
        dt = max(time.time() - self._t0, 1e-9)
        rate = (self.n - self._start_n) / dt
        if rate > 0 and self.n < self.total:
            eta_s = int((self.total - self.n) / rate)
            eta = f"{eta_s // 60}:{eta_s % 60:02d}"
        else:
            eta = "-"
        post = "".join(f", {k}={v}" for k, v in self._postfix.items())
        head = f"{self.desc}: " if self.desc else ""
        return (f"{head}{frac * 100:3.0f}%|{bar}| {self.n}/{self.total} "
                f"[{rate:.1f} {self.unit}/s, ETA {eta}{post}]")

    def _draw(self, force: bool = False):
        if not self.enabled:
            return
        now = time.time()
        if not force and now - self._last_draw < self.min_interval \
                and self.n < self.total:
            return
        self._last_draw = now
        try:
            self.stream.write("\r" + self._render())
            self.stream.flush()
        except Exception:
            self.enabled = False        # broken pipe etc. — go quiet

    def close(self):
        if self.enabled:
            self._draw(force=True)
            try:
                self.stream.write("\n")
                self.stream.flush()
            except Exception:
                pass
            self.enabled = False


class _FetchProgress:
    """Adapter given to fetchers' ``progress=`` hook: counts fetched tiles
    into a ProgressBar postfix (the reference's inner tqdm at
    _script/detector.py:128-133 tracked fetches the same way)."""

    def __init__(self, bar: ProgressBar):
        self.bar = bar
        self.count = 0

    def update(self, n: int = 1):
        self.count += n
        self.bar.set_postfix(fetched=self.count)
