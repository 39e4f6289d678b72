"""Metrics registry of the port: counters, gauges and latency histograms.

A partial copy of ``flink_jpmml_tpu/utils/metrics.py``: what the block
pipeline, the Kafka source, the prefetch sidecar and the obs planes
(``obs/attr``, ``obs/freshness``, ``obs/pressure``, ``obs/slo``) book.
The histogram is the JAX package's, with its fixed log-spaced buckets
(so p50/p99 read the same estimator in both packages), its exemplars
and its ``state`` form; the registry keeps its scrape hooks and its
structured snapshot (``struct_snapshot``: counters, gauges with their
high-water ``max``, histogram states). Not ported: the fleet merge
(``Histogram.merge``, ``merge_structs``), the series governor
(``govern_*``), the drift plane's sketches and the reservoirs; no port
module calls them.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
import weakref
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
    the bucket ratio (default 4 buckets/decade ⇒ ≤ 78%... in the worst
    case within a bucket, typically far less). ``state`` /
    ``from_state`` carry it through :meth:`MetricsRegistry.struct_snapshot`;
    the fleet merge is not ported.
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
        # bucket idx -> (trace_id, value, unix_ts): the exemplar link
        # from a scrape's tail bucket back to the flight-recorder event
        # / span file that explains it (obs/attr.py decides WHICH
        # observations deserve one — the per-observe cost with none
        # attached is a single None check)
        self._exemplars: Dict[int, Tuple[str, float, float]] = {}
        self._lock = threading.Lock()

    @property
    def edges(self) -> List[float]:
        return list(self._edges)

    @property
    def layout(self) -> Tuple[float, float, int]:
        return self._layout

    def bucket_index(self, v: float) -> int:
        """The bucket an observation of ``v`` lands in (edges are
        immutable, so no lock; the overflow bucket is len(edges))."""
        return bisect.bisect_left(self._edges, v)

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        idx = bisect.bisect_left(self._edges, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._n += 1
            if v > self._max:
                self._max = v
            if exemplar is not None:
                # worst-per-bucket, matching merge(): a later smaller
                # same-bucket capture must not displace the worst
                # offender's trace link (>= so an equal fresher one wins)
                have = self._exemplars.get(idx)
                if have is None or v >= have[1]:
                    self._exemplars[idx] = (exemplar, v, time.time())

    def exemplars(self) -> Dict[int, Tuple[str, float, float]]:
        with self._lock:
            return dict(self._exemplars)

    def count(self) -> int:
        with self._lock:
            return self._n

    def sum(self) -> float:
        with self._lock:
            return self._sum

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

    # -- wire format (struct_snapshot) ------

    def state(self) -> dict:
        """Compact JSON-shaped state: sparse non-zero buckets only."""
        with self._lock:
            out = {
                "layout": list(self._layout),
                "counts": {
                    str(i): c for i, c in enumerate(self._counts) if c
                },
                "sum": self._sum,
                "n": self._n,
                "max": self._max,
            }
            if self._exemplars:
                out["exemplars"] = {
                    str(i): list(ex) for i, ex in self._exemplars.items()
                }
            return out

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        lo, hi, bpd = state["layout"]
        h = cls(float(lo), float(hi), int(bpd))
        for i, c in state.get("counts", {}).items():
            h._counts[int(i)] += int(c)
        h._sum = float(state.get("sum", 0.0))
        h._n = int(state.get("n", 0))
        h._max = float(state.get("max", 0.0))
        for i, ex in (state.get("exemplars") or {}).items():
            try:
                h._exemplars[int(i)] = (
                    str(ex[0]), float(ex[1]), float(ex[2])
                )
            except (IndexError, TypeError, ValueError):
                continue  # a malformed exemplar never poisons the state
        return h


class MetricsRegistry:
    """Named counters, gauges and histograms with one-call snapshots —
    flat (``snapshot``) for humans and the chip smoke lines, structured
    (``struct_snapshot``) for the obs planes' readers."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._scrape_hooks: List[weakref.WeakMethod] = []

    def add_scrape_hook(self, method) -> None:
        """Register a bound method to run just before every
        :meth:`struct_snapshot` (held weakly — a dead owner
        unregisters itself). The freshness plane registers its aging
        sweeps here so observation-age gauges keep counting up from
        the OBSERVER side: a wedged consumer (full ring, blocked
        ingest thread) must not freeze its own staleness detectors."""
        with self._lock:
            self._scrape_hooks.append(weakref.WeakMethod(method))

    def _run_scrape_hooks(self) -> None:
        with self._lock:
            hooks = list(self._scrape_hooks)
        dead = False
        for ref in hooks:
            fn = ref()
            if fn is None:
                dead = True
                continue
            try:
                fn()
            except Exception:
                pass  # an aging hook must never kill a scrape
        if dead:
            with self._lock:
                self._scrape_hooks = [
                    h for h in self._scrape_hooks if h() is not None
                ]

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

    def _views(self):
        with self._lock:
            return (
                dict(self._counters),
                dict(self._gauges),
                dict(self._histograms),
            )

    def snapshot(self) -> Dict[str, float]:
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        out: Dict[str, float] = {"uptime_s": elapsed}
        counters, gauges, histograms = self._views()
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

    def struct_snapshot(self, run_hooks: bool = True) -> dict:
        """Typed, JSON-shaped snapshot: ``counters``, ``gauges`` (each
        ``{"value", "max"}``), ``histograms`` (each its ``state``), the
        uptime and the capture wall-clock ``ts``. ``run_hooks=False``
        is for collectors that are themselves scrape hooks."""
        if run_hooks:
            self._run_scrape_hooks()
        counters, gauges, histograms = self._views()
        return {
            "uptime_s": max(time.monotonic() - self._t0, 1e-9),
            "ts": time.time(),
            "counters": {n: c.get() for n, c in counters.items()},
            "gauges": {
                n: {"value": g.get(), "max": g.max}
                for n, g in gauges.items()
            },
            "histograms": {n: h.state() for n, h in histograms.items()},
        }
