"""Process-global metrics registry: counters, gauges, histograms.

Everything here is host-side Python — metrics are recorded from
orchestration code only (schedulers, the serving engine), never from
device code, so instrumentation can stay always-on without synchronising
the device.

Design:

- **Counter** — monotone float/int total (``inc``).
- **Gauge** — last-write-wins scalar (``set``).
- **Histogram** — fixed cumulative buckets (Prometheus exposition) *plus* a
  bounded ring of raw samples for exact quantiles: ``percentile(p)`` is
  numpy-exact over the retained window (the newest ``window`` observations;
  all of them while ``count <= window``). Fixed buckets alone would round
  p99 to a bucket edge; raw-sample quantiles alone would not export — the
  pair gives both at O(1) memory.
- **MetricsRegistry** — name -> metric, created on first touch. One
  process-global instance behind ``registry()``; ``reset()`` drops all
  metrics (tests), ``set_enabled(False)`` turns every record call into a
  cheap no-op (the serving load bench's uninstrumented baseline).

Thread-safety: the serving load bench records from N streams concurrently.
Metric creation takes the registry lock; each histogram serialises its
``observe`` on its own lock (counters/gauges ride the GIL for their single
attribute update, with the lock only on read-modify-write paths that need
exactness across threads — ``inc``).
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# log-spaced latency buckets (milliseconds): 50µs .. 10s. Span-fed
# histograms record ms; count-valued histograms (batch sizes, occupancy)
# pass their own buckets.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 10000.0, float("inf"))

# power-of-two-ish buckets for count-valued histograms (group-commit batch
# sizes, decode batch occupancy, rows per maintenance action)
COUNT_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, float("inf"))

DEFAULT_WINDOW = 4096


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        self.value = float(v)


class Histogram:
    """Fixed cumulative buckets + exact quantiles over a sample window."""

    __slots__ = ("name", "bounds", "bucket_counts", "count", "total",
                 "vmax", "_window", "_wpos", "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window: int = DEFAULT_WINDOW):
        bounds = tuple(float(b) for b in buckets)
        if bounds != tuple(sorted(bounds)) or bounds[-1] != float("inf"):
            raise ValueError("histogram buckets must ascend and end at +inf")
        self.name = name
        self.bounds = bounds
        self.bucket_counts = [0] * len(bounds)
        self.count = 0
        self.total = 0.0
        self.vmax = float("-inf")
        self._window: List[float] = []
        self._wpos = 0                   # ring write index once saturated
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        v = float(v)
        with self._lock:
            self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
            self.count += 1
            self.total += v
            if v > self.vmax:
                self.vmax = v
            if len(self._window) < DEFAULT_WINDOW:
                self._window.append(v)
            else:
                self._window[self._wpos] = v
                self._wpos = (self._wpos + 1) % DEFAULT_WINDOW

    # ----------------------------------------------------------------- readout
    def samples(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._window, dtype=np.float64)

    def percentile(self, p: float) -> float:
        """Exact (numpy linear-interpolation) quantile over the retained
        window — all observations while ``count <= window``, else the
        newest ``window`` of them. NaN with no samples."""
        s = self.samples()
        if s.size == 0:
            return float("nan")
        return float(np.percentile(s, p))

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """Prometheus-style ``[(le, cumulative_count)]`` (last le = +inf)."""
        with self._lock:
            counts = list(self.bucket_counts)
        out, running = [], 0
        for le, c in zip(self.bounds, counts):
            running += c
            out.append((le, running))
        return out

    def summary(self) -> Dict[str, float]:
        # one lock acquisition for a coherent snapshot; percentiles are
        # computed outside it (a nested samples() would deadlock on the
        # non-reentrant Lock, and np.percentile needn't stall writers)
        with self._lock:
            count = self.count
            total = self.total
            vmax = self.vmax
            window = np.asarray(self._window, dtype=np.float64)
        pct = (lambda p: float(np.percentile(window, p))) \
            if window.size else (lambda p: float("nan"))
        return {
            "count": count,
            "sum": total,
            "max": vmax if count else float("nan"),
            "p50": pct(50),
            "p90": pct(90),
            "p99": pct(99),
        }


class MetricsRegistry:
    """name -> metric. Metrics are created on first touch and live for the
    process (or until ``reset``); touching an existing name returns the
    same object, so call sites never need to pre-register."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    name, buckets or DEFAULT_BUCKETS)
            return h

    # ------------------------------------------------------------------ export
    def counters(self) -> Dict[str, Counter]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, Gauge]:
        with self._lock:
            return dict(self._gauges)

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return dict(self._histograms)

    def to_dict(self) -> Dict[str, Dict[str, object]]:
        """JSON-able snapshot: counter/gauge values, histogram summaries
        (count, sum, max, exact p50/p90/p99)."""
        return {
            "counters": {n: c.value for n, c in self.counters().items()},
            "gauges": {n: g.value for n, g in self.gauges().items()},
            "histograms": {n: h.summary()
                           for n, h in self.histograms().items()},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# ---------------------------------------------------------------------------
# process-global instance + enable switch
# ---------------------------------------------------------------------------

_ENABLED = True
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def set_enabled(on: bool) -> None:
    """Global kill switch: with ``on=False`` every ``inc``/``set``/
    ``observe`` returns after one boolean check — the serving load bench's
    uninstrumented baseline mode."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED
