"""Resilient HTTP layer for tile acquisition.

A copy of ``aerial_image_recognition_tpu/fetch/http.py``, on ``requests``
and ``urllib3`` as there, so its retries, Retry-After handling and failure
statistics are the reference's own.

Carries over the reference's full failure-handling taxonomy (SURVEY.md §5):
  * connection-pool + urllib3 Retry on 429/5xx/52x (wms_handler.py:48-81)
  * per-request exponential backoff with jitter (wms_handler.py:106-150)
  * Retry-After-respecting 429 handling (simple_detector.py:166-172)
  * structured failure log + post-hoc error-pattern analysis
    (wms_handler.py:29-32,152-194)
  * running stats: requests, successes, timeouts, bytes, img/s
    (wms_handler.py:35-43,92-104)
"""

import random
import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import requests
from requests.adapters import HTTPAdapter

from aerial_image_recognition_tpu_torch.runtime.observability import Tracer


def _retry_after_seconds(value, default: float) -> float:
    """Retry-After per RFC 7231: delta-seconds OR an HTTP-date. Returns
    `default` when absent/unparseable (a crashing float() here used to
    kill the fetch worker on date-form headers)."""
    if not value:
        return default
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        from email.utils import parsedate_to_datetime
        import datetime

        dt = parsedate_to_datetime(value)
        now = datetime.datetime.now(datetime.timezone.utc)
        return max(0.0, (dt - now).total_seconds())
    except Exception:
        return default
from urllib3.util.retry import Retry


_COUNTERS = ("requests", "successes", "failures", "timeouts", "rate_limited",
             "bytes_fetched", "request_s", "decode_s")


@dataclass
class FetchStats:
    """Thread-safe running counters (single lock; mutated by worker threads).

    ``request_s`` and ``decode_s`` are the seconds of every request attempt
    and every tile decode on the monotonic clock, summed over the worker
    threads (those of ``fetch/workers.py``'s processes too, merged in by
    ``merge``): thread-seconds, not wall time."""
    requests: int = 0
    successes: int = 0
    failures: int = 0
    timeouts: int = 0
    rate_limited: int = 0
    bytes_fetched: int = 0
    request_s: float = 0.0
    decode_s: float = 0.0
    started: Optional[float] = None      # first-request wall clock
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, ok: bool, dt: float, nbytes: int = 0,
               timeout: bool = False, ratelimited: bool = False):
        with self._lock:
            self.requests += 1
            self.request_s += dt
            if self.started is None:
                self.started = time.time()
            if ok:
                self.successes += 1
                self.bytes_fetched += nbytes
            else:
                self.failures += 1
                self.timeouts += timeout
                self.rate_limited += ratelimited

    def decoded(self, dt: float):
        with self._lock:
            self.decode_s += dt

    def counters(self) -> Dict:
        """The counters and ``started``, as a picklable dict for ``merge``."""
        with self._lock:
            out = {k: getattr(self, k) for k in _COUNTERS}
            out["started"] = self.started
            return out

    def merge(self, counters: Dict):
        """Add another instance's ``counters()`` (a worker process's for
        one tile); ``started`` becomes the earlier of the two."""
        with self._lock:
            for k in _COUNTERS:
                setattr(self, k, getattr(self, k) + counters[k])
            if counters["started"] is not None and (
                    self.started is None or counters["started"] < self.started):
                self.started = counters["started"]

    def summary(self) -> Dict:
        with self._lock:
            # wall-clock rate: per-request durations summed across N
            # worker threads would understate throughput ~N-fold
            wall = (time.time() - self.started) if self.started else 0.0
            rate = self.successes / wall if wall > 0 else 0.0
            return {
                "requests": self.requests, "successes": self.successes,
                "failures": self.failures, "timeouts": self.timeouts,
                "rate_limited": self.rate_limited,
                "mb_fetched": round(self.bytes_fetched / 1e6, 2),
                "img_per_s": round(rate, 2),
                "success_rate": round(self.successes / self.requests, 4)
                                if self.requests else 1.0,
            }


@dataclass
class FailureRecord:
    url: str
    error: str
    when: float
    attempt: int


class FailureLog:
    """Bounded structured failure log with pattern analysis."""

    def __init__(self, maxlen: int = 10000):
        self._records: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def add(self, url: str, error: str, attempt: int):
        with self._lock:
            self._records.append(FailureRecord(url, error, time.time(), attempt))

    def records(self) -> List[FailureRecord]:
        with self._lock:
            return list(self._records)

    def extend(self, records: List[FailureRecord]):
        """Append records made elsewhere (a worker process's), their
        times kept."""
        with self._lock:
            self._records.extend(records)

    def analyze(self) -> Dict:
        """Error-type histogram + burst detection (equivalent in spirit to
        the reference's failure-pattern analyzer, wms_handler.py:152-194)."""
        with self._lock:
            records = list(self._records)
        by_type = Counter(r.error.split(":")[0] for r in records)
        times = sorted(r.when for r in records)
        bursts = 0
        for a, b in zip(times, times[5:]):
            if b - a < 1.0:   # ≥6 failures within a second = burst
                bursts += 1
        return {"total": len(records), "by_type": dict(by_type),
                "bursts": bursts}

    def __len__(self):
        with self._lock:
            return len(self._records)


class TileHTTP:
    """Session with layered retries + stats; one instance per fetcher."""

    def __init__(self, timeout: float = 10.0, retries: int = 5,
                 backoff: float = 0.5, pool_size: int = 100,
                 user_agent: str = "aerial-tpu/0.1"):
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.stats = FetchStats()
        self.failures = FailureLog()
        self.session = requests.Session()
        # Transport-level retry for connection resets; status-based retry is
        # handled by our own loop so 429 Retry-After can be honored and
        # counted.
        adapter = HTTPAdapter(
            pool_connections=pool_size, pool_maxsize=pool_size,
            max_retries=Retry(total=2, backoff_factor=0.1,
                              status_forcelist=()))
        self.session.mount("http://", adapter)
        self.session.mount("https://", adapter)
        self.session.headers["User-Agent"] = user_agent

    def get(self, url: str, params: Optional[Dict] = None) -> Optional[bytes]:
        """GET with exponential backoff; returns body bytes or None."""
        delay = self.backoff
        for attempt in range(self.retries):
            last = attempt == self.retries - 1   # no pointless final sleep
            t0 = time.perf_counter()
            try:
                with Tracer.annotate("tile_request"):
                    r = self.session.get(url, params=params,
                                         timeout=self.timeout)
                if r.status_code == 200:
                    body = r.content
                    self.stats.record(True, time.perf_counter() - t0,
                                      len(body))
                    return body
                if r.status_code == 429:
                    self.stats.record(False, time.perf_counter() - t0,
                                      ratelimited=True)
                    self.failures.add(url, f"HTTP429", attempt)
                    if not last:
                        time.sleep(min(_retry_after_seconds(
                            r.headers.get("Retry-After"), delay), 30.0))
                else:
                    self.stats.record(False, time.perf_counter() - t0)
                    self.failures.add(url, f"HTTP{r.status_code}", attempt)
                    if not last:
                        time.sleep(delay)
            except requests.Timeout:
                self.stats.record(False, time.perf_counter() - t0,
                                  timeout=True)
                self.failures.add(url, "Timeout", attempt)
                if not last:
                    time.sleep(delay)
            except requests.RequestException as e:
                self.stats.record(False, time.perf_counter() - t0)
                self.failures.add(url, type(e).__name__ + ":" + str(e)[:80],
                                  attempt)
                if not last:
                    time.sleep(delay)
            delay = min(delay * 2, 8.0) * (1.0 + random.random() * 0.1)
        return None

    def decode(self, body: bytes):
        """``gio.decode.decode_rgb(body)`` (native libjpeg, PIL fallback),
        its seconds added to ``stats.decode_s``: None when undecodable."""
        from aerial_image_recognition_tpu_torch.gio.decode import decode_rgb
        t0 = time.perf_counter()
        with Tracer.annotate("tile_decode"):
            arr = decode_rgb(body)
        self.stats.decoded(time.perf_counter() - t0)
        return arr

    def get_rgb(self, url: str, params: Optional[Dict] = None):
        """``get`` then ``decode``: uint8 [H, W, 3] RGB, or None when the
        request fails or the body does not decode (logged as
        ``DecodeError``)."""
        body = self.get(url, params=params)
        if body is None:
            return None
        arr = self.decode(body)
        if arr is None:
            self.failures.add(url, "DecodeError", 0)
        return arr

    def close(self):
        self.session.close()
