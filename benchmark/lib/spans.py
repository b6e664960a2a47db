"""The benchmark's spans around its calls into the program's layers.

With tracing off nothing is wrapped. With it on, each span adds its
seconds and count under its name and, while the profiler runs, shows in
its trace as the user annotation ``bench:<name>`` (the idle-gap tags of
the breakdown).
"""

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Spans:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        with torch.profiler.record_function("bench:" + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds[name] += dt
                    self.counts[name] += 1

    def iterate(self, iterable, name: str):
        """Yield from ``iterable``, each ``next()`` inside a span."""
        it = iter(iterable)
        while True:
            with self.span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def ms_per(self, name: str, count: int):
        """Milliseconds of span ``name`` per ``count`` (None if never
        seen)."""
        if not self.counts.get(name) or not count:
            return None
        return self.seconds[name] / count * 1e3


class StepProxy:
    """A detect step's surface, each call inside the span ``issue`` (the
    call returns once its work is queued)."""

    def __init__(self, step, spans: Spans):
        self.__dict__["_step"] = step
        self.__dict__["_spans"] = spans

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self, *args, **kwargs):
        with self._spans.span("issue"):
            return self._step(*args, **kwargs)
