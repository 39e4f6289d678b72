"""Metrics registry of the port: counters, gauges and latency histograms.

A partial copy of ``flink_jpmml_tpu/utils/metrics.py``: what the block
pipeline, the Kafka source, the prefetch sidecar and the obs planes
(``obs/attr``, ``obs/freshness``, ``obs/pressure``, ``obs/slo``) book.
The histogram is the JAX package's, with its fixed log-spaced buckets
(so p50/p99 read the same estimator in both packages), its exemplars
and its ``state`` form; the registry keeps its scrape hooks and its
structured snapshot (``struct_snapshot``: counters, gauges with their
high-water ``max``, histogram states), the fleet merge
(``Histogram.merge``, ``merge_structs``) and the series governor
(``govern_struct`` / ``govern_limit``), which ``parallel/health.py``
applies to the heartbeat's piggybacked snapshots. Not ported: the drift
plane's sketches (``QuantileSketch``) and the reservoirs, so
``merge_structs`` and ``govern_struct`` carry no ``sketches`` section;
no port struct has one.
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading
import time
import weakref
from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterable, List, Optional, Tuple


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
    ``merge`` adds another's buckets (the fleet merge).
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

    def merge(self, other: "Histogram") -> "Histogram":
        """Add ``other``'s buckets into self (in place; → self)."""
        if other._layout != self._layout:
            raise ValueError(
                f"histogram layouts differ: {self._layout} vs {other._layout}"
            )
        with other._lock:
            counts = list(other._counts)
            s, n, mx = other._sum, other._n, other._max
            exemplars = dict(other._exemplars)
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += s
            self._n += n
            if mx > self._max:
                self._max = mx
            # per bucket keep the worse (larger-value) exemplar: the
            # fleet view should link to the worst offender it knows of
            for i, ex in exemplars.items():
                have = self._exemplars.get(i)
                if have is None or ex[1] > have[1]:
                    self._exemplars[i] = ex
        return self

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


_GAUGE_MERGE_MAX_PREFIXES = (
    "device_mfu", "device_membw_util", "device_ns_per_record",
    "flops_per_record", "kernel_pred_error", "slo_burn_rate",
    "watermark_lag_s", "kafka_lag_age_s", "lag_drain_eta_s",
    "lag_trend", "lag_diverging", "pressure", "ring_occupancy",
    "shed_level", "reconnect_backoff_s", "slo_deadline_ms",
    "drift_score", "prediction_drift", "feature_missing_rate",
    "unseen_category_rate", "drift_alarmed", "rollout_prediction_psi",
    "rollout_stage", "kafka_lag",
    # pipelined ingest (runtime/prefetch.py): handoff-queue fill is a
    # saturation fraction — the fleet view wants the worst worker
    "prefetch_occupancy",
    # delivery-correctness plane (runtime/dlq.py): 1 while a worker is
    # bisecting poison — one suspect worker flags the fleet. (Parens in
    # these comments are fine now: metrics_lint parses the real AST,
    # not a to-the-closing-paren regex.)
    "poison_suspect_mode",
    # device-fault resilience (serving/failover.py, runtime/devfault.py):
    # circuit state 0 closed / 1 half-open / 2 open — the fleet view is
    # the sickest worker; same worst-of logic for a suspended
    # checkpoint plane and for lost mesh chips
    "failover_state", "checkpoint_suspended", "mesh_lost_devices",
    # multichip serving (obs/mesh.py): per-chip health state follows
    # the failover_state convention (0 healthy / 2 lost) — the fleet
    # view is the sickest worker's view of the chip
    "mesh_chip_state",
    # multi-tenant zoo (serving/zoo.py): padded-waste fraction of the
    # packed input buffers — the fleet view wants the worst buffer
    "pack_pad_waste",
    # multi-tenant zoo (serving/zoo.py): registered-tenant count —
    # workers serve the same zoo, so summing double-counts tenants;
    # the fleet value is the fullest worker's registry
    "zoo_tenants",
    # keyed session state (runtime/state.py): occupancy is a capacity
    # fraction — the fleet view wants the fullest table (the one next
    # to evict), so MAX; resident_keys stays a sum (tables are
    # worker-local, key spaces disjoint by lane routing)
    "state_occupancy_frac",
)
_GAUGE_MERGE_MIN_PREFIXES = (
    "slo_ok", "watermark_ts", "watermark_stage_ts", "adaptive_batch",
    # multi-tenant zoo (serving/zoo.py): pack slot occupancy is a
    # utilization fraction — the fleet view is the emptiest pack (the
    # one wasting dispatches), so MIN, not a meaningless sum
    "pack_occupancy",
    # multichip serving (obs/mesh.py): surviving data-axis width — the
    # fleet value is the most-degraded worker's mesh, never a sum
    "mesh_data_width",
    # capacity-headroom telemetry (obs/history.py): remaining capacity
    # fraction — the fleet is as constrained as its tightest worker, so
    # MIN; averaging (or summing) headroom hides the saturated worker
    "headroom_frac",
    # keyed session state (runtime/state.py): hit ratio is a quality
    # fraction — the fleet view is the coldest table (the one churning
    # keys); a sum of ratios means nothing
    "state_hit_ratio",
)


def _gauge_merge_mode(name: str) -> str:
    if name.startswith(_GAUGE_MERGE_MIN_PREFIXES):
        return "min"
    if name.startswith(_GAUGE_MERGE_MAX_PREFIXES):
        return "max"
    return "sum"


def merge_structs(structs: Iterable[dict]) -> dict:
    """Merge :meth:`MetricsRegistry.struct_snapshot` dicts into one fleet
    view: counters add, gauge values add (fleet totals: in-flight depth
    across workers is a sum — except the ratio/boolean families in
    ``_GAUGE_MERGE_MAX_PREFIXES``/``_GAUGE_MERGE_MIN``, which take the
    worst value) with the max-of-maxes high-water, histogram buckets
    add — the merge whose quantiles are exact.

    Entries that don't merge are SKIPPED, never raised: the inputs are
    heartbeat-piggybacked snapshots from remote workers (the coordinator
    accepts any dict — garbage frames must not kill the feed, and by the
    same logic one worker with version skew — a changed histogram layout,
    a custom ``snapshot_fn`` shape — must not turn every supervisor
    ``/metrics`` scrape into an HTTP 500)."""
    out: dict = {
        "uptime_s": 0.0, "counters": {}, "gauges": {}, "histograms": {}
    }
    hists: Dict[str, Histogram] = {}
    for s in structs:
        if not isinstance(s, dict):
            continue
        try:
            out["uptime_s"] = max(
                out["uptime_s"], float(s.get("uptime_s", 0.0))
            )
        except (TypeError, ValueError):
            pass
        try:
            ts = float(s["ts"])
        except (KeyError, TypeError, ValueError):
            pass
        else:
            # the fleet view is only as fresh as its stalest member —
            # min, for the same reason watermark_ts is
            out["ts"] = min(out.get("ts", ts), ts)
        for n, v in _items(s.get("counters")):
            try:
                out["counters"][n] = out["counters"].get(n, 0.0) + float(v)
            except (TypeError, ValueError):
                pass
        for n, g in _items(s.get("gauges")):
            try:
                value = float(g.get("value", 0.0))
                mx = float(g.get("max", 0.0))
            except (AttributeError, TypeError, ValueError):
                continue
            mode = _gauge_merge_mode(n)
            agg = out["gauges"].get(n)
            if agg is None:
                # min/max modes must seed from the first REAL value —
                # a 0.0 identity would pin min() at zero forever
                out["gauges"][n] = {"value": value, "max": mx}
            else:
                if mode == "sum":
                    agg["value"] += value
                elif mode == "max":
                    agg["value"] = max(agg["value"], value)
                else:
                    agg["value"] = min(agg["value"], value)
                agg["max"] = max(agg["max"], mx)
        for n, hstate in _items(s.get("histograms")):
            try:
                h = Histogram.from_state(hstate)
                if n in hists:
                    hists[n].merge(h)  # ValueError on layout skew
                else:
                    hists[n] = h
            except (KeyError, IndexError, TypeError, ValueError):
                continue
    out["histograms"] = {n: h.state() for n, h in hists.items()}
    return out


def _items(d):
    return d.items() if isinstance(d, dict) else ()


# ---------------------------------------------------------------------------
# Cardinality governor: top-K series per labelled family + exact-sum
# "_other" rollup. At zoo scale (1,000 registered tenants) the
# per-tenant families — tenant_records / tenant_shed_records /
# tenant_latency_s{model=…} — put one series per tenant on every
# /metrics page, every heartbeat frame, and every history frame. The
# governor bounds each labelled family to the K highest-ranked series
# and folds the remainder into one `{…="_other"}` series using the SAME
# merge rules as the fleet (counters add, histogram buckets add, gauges
# by their declared mode), so family TOTALS are unchanged by the rollup
# and fleet merges of governed structs still reconcile exactly.

#: Labelled family used to rank series that share its label key: tenants
#: are kept by traffic volume, so tenant_latency_s keeps the SAME top-K
#: tenants as tenant_records and cross-family tables stay joinable.
_RANK_FAMILY_DEFAULT = "tenant_records"

_SERIES_RE = re.compile(
    r'^([A-Za-z_:][A-Za-z0-9_:]*)\{([A-Za-z_][A-Za-z0-9_]*)="(.*)"\}$'
)


def govern_limit() -> int:
    """Series bound per labelled family from ``FJT_METRICS_MAX_SERIES``
    (0 / unset / garbage → governor off)."""
    try:
        return int(os.environ.get("FJT_METRICS_MAX_SERIES", "0"))
    except ValueError:
        return 0


def _series_split(name: str):
    m = _SERIES_RE.match(name)
    if m is None:
        return None
    return m.group(1), m.group(2), m.group(3)


def _state_weight(st) -> float:
    try:
        return float(st.get("n", 0.0))
    except (AttributeError, TypeError, ValueError):
        return 0.0


def govern_struct(
    struct: dict,
    max_series: Optional[int] = None,
    rank_family: Optional[str] = None,
) -> dict:
    """Return ``struct`` with every labelled family bounded to
    ``max_series`` series (default: :func:`govern_limit`); the input is
    never mutated and is returned untouched when the governor is off or
    nothing exceeds the bound.

    Ranking: series whose label key matches the rank family's
    (``FJT_METRICS_RANK_FAMILY``, default ``tenant_records``) rank by
    that family's counter value — heaviest-traffic tenants survive in
    every family; other label keys rank by the series' own magnitude.
    The fold into ``_other`` reuses the fleet merge ops (counter add via
    ``math.fsum``, histogram bucket-merge, gauge min/max/sum by
    :func:`_gauge_merge_mode`), so the governed family total equals the
    ungoverned one."""
    k = govern_limit() if max_series is None else int(max_series)
    if k <= 0 or not isinstance(struct, dict):
        return struct
    if rank_family is None:
        rank_family = os.environ.get(
            "FJT_METRICS_RANK_FAMILY", _RANK_FAMILY_DEFAULT
        )

    # rank scores: (label_key, label_value) -> rank-family counter value
    scores: Dict[Tuple[str, str], float] = {}
    for n, v in _items(struct.get("counters")):
        parts = _series_split(n)
        if parts is not None and parts[0] == rank_family:
            try:
                scores[(parts[1], parts[2])] = float(v)
            except (TypeError, ValueError):
                pass

    def _govern_section(section: dict, weight, fold) -> Optional[dict]:
        families: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        for n in section:
            parts = _series_split(n)
            if parts is not None:
                families.setdefault(
                    (parts[0], parts[1]), []
                ).append((parts[2], n))
        over = {
            fam: members
            for fam, members in families.items()
            if len(members) > k
        }
        if not over:
            return None
        def _safe_weight(v) -> float:
            try:
                return weight(v)
            except (AttributeError, TypeError, ValueError):
                return 0.0

        out = dict(section)
        for (base, key), members in over.items():
            ranked = sorted(
                members,
                key=lambda lv: (
                    -scores.get((key, lv[0]), 0.0),
                    -_safe_weight(section[lv[1]]),
                    lv[0],
                ),
            )
            # "_other" always folds itself (re-governing is idempotent)
            keep = [
                lv for lv in ranked if lv[0] != "_other"
            ][: max(k - 1, 0)]
            kept = {lv[1] for lv in keep}
            folded = [section[n] for _, n in members if n not in kept]
            for _, n in members:
                if n not in kept:
                    del out[n]
            other = fold(base, folded)
            if other is not None:
                out[f'{base}{{{key}="_other"}}'] = other
        return out

    def _fold_counters(base, vals):
        total, any_ok = [], False
        for v in vals:
            try:
                total.append(float(v))
                any_ok = True
            except (TypeError, ValueError):
                continue
        return math.fsum(total) if any_ok else None

    def _fold_gauges(base, vals):
        mode = _gauge_merge_mode(base)
        out = None
        for g in vals:
            try:
                value = float(g.get("value", 0.0))
                mx = float(g.get("max", 0.0))
            except (AttributeError, TypeError, ValueError):
                continue
            if out is None:
                out = {"value": value, "max": mx}
            else:
                if mode == "sum":
                    out["value"] += value
                elif mode == "max":
                    out["value"] = max(out["value"], value)
                else:
                    out["value"] = min(out["value"], value)
                out["max"] = max(out["max"], mx)
        return out

    def _fold_states(cls):
        def _fold(base, states):
            merged = None
            for st in states:
                try:
                    obj = cls.from_state(st)
                    if merged is None:
                        merged = obj
                    else:
                        merged.merge(obj)
                except (KeyError, IndexError, TypeError, ValueError):
                    continue
            return merged.state() if merged is not None else None
        return _fold

    out = None
    for section, weight, fold in (
        ("counters", lambda v: float(v or 0.0), _fold_counters),
        ("gauges",
         lambda g: float((g or {}).get("value", 0.0)), _fold_gauges),
        ("histograms", _state_weight, _fold_states(Histogram)),
    ):
        sec = struct.get(section)
        if not isinstance(sec, dict):
            continue
        governed = _govern_section(sec, weight, fold)
        if governed is not None:
            if out is None:
                out = dict(struct)
            out[section] = governed
    return struct if out is None else out
