"""Metrics registry of the port: counters, gauges and a latency histogram.

A minimal copy of ``flink_jpmml_tpu/utils/metrics.py``: what the block
pipeline books (``records_in``/``records_out``/``batches``, the dispatch
window's ``h2d_stall_s``/``dispatches``/``inflight_depth``, the wire's
``encode_s``/``h2d_bytes`` and the ``batch_latency_s`` histogram). The
histogram keeps the JAX package's fixed log-spaced buckets, so p50/p99
read the same estimator in both packages. The fleet merge, sketches,
reservoirs and the structured snapshot are not ported.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple


@dataclass
class Counter:
    value: float = 0.0
    _lock: threading.Lock = dc_field(default_factory=threading.Lock, repr=False)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def get(self) -> float:
        with self._lock:
            return self.value


@dataclass
class Gauge:
    """Last-set value + high-water mark (e.g. in-flight dispatch depth)."""

    value: float = 0.0
    max: float = 0.0
    _lock: threading.Lock = dc_field(default_factory=threading.Lock, repr=False)

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v
            if v > self.max:
                self.max = v

    def get(self) -> float:
        with self._lock:
            return self.value


def _nearest_rank(q: float, n: int) -> int:
    """0-based nearest-rank index: the smallest k with (k+1)/n >= q.

    ``int(q*n)`` over-indexes small samples (the p50 of 2 observations
    is their MAX under it); ceil(q·n)-1 is the standard nearest-rank."""
    return min(max(math.ceil(q * n) - 1, 0), n - 1)


# shared edge tables per layout — every histogram of one layout must use
# the IDENTICAL edges or merges would be silently wrong
_EDGE_CACHE: Dict[Tuple[float, float, int], List[float]] = {}


def _edges(lo: float, hi: float, buckets_per_decade: int) -> List[float]:
    key = (lo, hi, buckets_per_decade)
    edges = _EDGE_CACHE.get(key)
    if edges is None:
        n = int(math.ceil(
            round(math.log10(hi / lo) * buckets_per_decade, 9)
        ))
        edges = [lo * 10.0 ** (i / buckets_per_decade) for i in range(n + 1)]
        _EDGE_CACHE[key] = edges
    return edges


class Histogram:
    """Fixed-bucket histogram over log-spaced edges.

    Bucket i counts observations v <= edges[i] (bucket 0 also absorbs
    anything below ``lo``); one extra overflow bucket holds v > ``hi``.
    ``quantile`` returns the nearest-rank bucket's upper edge clamped to
    the true observed max — an upper bound with relative error set by
    the bucket ratio.
    """

    DEFAULT_LO = 1e-6  # 1 µs
    DEFAULT_HI = 1e3  # ~17 min; slower than that is an outage, not a tail
    DEFAULT_BPD = 4

    def __init__(
        self,
        lo: float = DEFAULT_LO,
        hi: float = DEFAULT_HI,
        buckets_per_decade: int = DEFAULT_BPD,
    ):
        if not (0 < lo < hi) or buckets_per_decade < 1:
            raise ValueError(
                f"bad histogram layout lo={lo} hi={hi} "
                f"buckets_per_decade={buckets_per_decade}"
            )
        self._layout = (float(lo), float(hi), int(buckets_per_decade))
        self._edges = _edges(*self._layout)
        self._counts = [0] * (len(self._edges) + 1)  # +1 = overflow
        self._sum = 0.0
        self._n = 0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self._edges, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._n += 1
            if v > self._max:
                self._max = v

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if self._n == 0:
                return None
            rank = _nearest_rank(q, self._n)
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc > rank:
                    edge = (
                        self._edges[i] if i < len(self._edges) else self._max
                    )
                    return min(edge, self._max)
            return self._max  # unreachable: counts sum to _n


class MetricsRegistry:
    """Named counters, gauges and histograms with a flat snapshot."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, **layout) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(**layout)
            return h

    def snapshot(self) -> Dict[str, float]:
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        out: Dict[str, float] = {"uptime_s": elapsed}
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        for name, c in counters.items():
            v = c.get()
            out[name] = v
            out[name + "_per_s"] = v / elapsed
        for name, g in gauges.items():
            out[name] = g.get()
            out[name + "_max"] = g.max
        for name, h in histograms.items():
            for q, tag in ((0.5, "p50"), (0.99, "p99"), (0.999, "p999")):
                v = h.quantile(q)
                if v is not None:
                    out[f"{name}_{tag}"] = v
        return out
