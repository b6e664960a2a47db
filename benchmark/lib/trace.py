"""The traced window: ``torch.profiler`` over the last seconds of a run's
window, reduced to device busy time per card, device time by operation,
the longest idle gaps tagged with the benchmark span the host was in, and
a kernel's device time by name.

The reduction of device time by kernel and of busy time against the
window is that of ``chip_smoke.profile_calls`` (chip_smoke.py:1162); busy
time here is the union of each card's kernel, copy and memset intervals,
so that the copy stream's work overlapping a kernel counts once.
"""

import json
import os
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class TracedWindow:
    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.window_s = None
        self.t0 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, devices):
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def reduce(self) -> "TraceSummary":
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        return TraceSummary(events, self.window_s)


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceSummary:
    """What the readers take from a trace (times in seconds)."""

    def __init__(self, events, window_s: float):
        self.window_s = window_s
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        self.device_events = dev
        per_card = {}
        for e in dev:
            card = e.get("args", {}).get("device", 0)
            per_card.setdefault(card, []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
        self.busy = {card: _union(iv) for card, iv in per_card.items()}
        self.annotations = sorted(
            (e["ts"], e["ts"] + e.get("dur", 0), e["name"][len("bench:"):])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("bench:"))

    def busy_s(self, card) -> float:
        return sum(e - s for s, e in self.busy.get(card, ())) / 1e6

    def idle_share(self, card) -> float:
        return 1.0 - self.busy_s(card) / self.window_s

    def kernel_s(self, fragment: str) -> float:
        return sum(e.get("dur", 0) for e in self.device_events
                   if e["cat"] == "kernel" and fragment in e["name"]) / 1e6

    def kernel_count(self, fragment: str) -> int:
        return sum(1 for e in self.device_events
                   if e["cat"] == "kernel" and fragment in e["name"])

    def top_ops(self, n: int = 10):
        by = {}
        for e in self.device_events:
            by[e["name"]] = by.get(e["name"], 0.0) + e.get("dur", 0) / 1e6
        return sorted(([k[:100], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def _tag(self, t: float) -> str:
        """The latest-opened benchmark span open at trace time ``t``."""
        best = None
        for s, e, name in self.annotations:
            if s > t:
                break
            if e >= t:
                best = name
        return best or "other host work"

    def idle_gaps(self, card, n: int = 10):
        """The ``n`` longest idle gaps between device intervals of
        ``card``, each as [span the host was in at the gap's middle,
        seconds]."""
        iv = self.busy.get(card, [])
        gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                       for a, b in zip(iv, iv[1:])), reverse=True)[:n]
        return [[self._tag(mid), g / 1e6] for g, mid in gaps]
