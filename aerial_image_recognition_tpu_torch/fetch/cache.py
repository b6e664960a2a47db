"""Thread-safe LRU tile cache.

A copy of ``aerial_image_recognition_tpu/fetch/cache.py``.

The reference uses a 10 000-entry OrderedDict mutated from async tasks with
a comment claiming thread safety it doesn't have (simple_detector.py:51-52,
117-134, 235-239 — SURVEY.md §5 race-detection notes). Here: one lock, LRU
by move-to-end, hit/miss counters.
"""

import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional, Tuple


class TileCache:
    def __init__(self, capacity: int = 10000):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            v = self._d.get(key)
            if v is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key: Hashable, value: Any) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self):
        with self._lock:
            return len(self._d)

    def stats(self) -> Tuple[int, int]:
        with self._lock:
            return self.hits, self.misses
