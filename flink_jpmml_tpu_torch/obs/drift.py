"""Data-plane observability: streaming feature/prediction drift.

The port's copy of ``flink_jpmml_tpu/obs/drift.py`` (numpy only, on the
host), with the import lines renamed. The sketches stay float64 on the
host: a bucket index computed another way (in float32, on the card)
would put edge values into other buckets and the fleet merge would no
longer be exact. Baselines live in the port's cache directory, beside
its autotune cache (``~/.cache/flink_jpmml_tpu_torch/drift_baselines/``,
or beside ``$FJT_AUTOTUNE_CACHE``), never in the JAX package's.
``FJT_DRIFT_SAMPLE``, ``FJT_DRIFT_ROWS``, ``FJT_DRIFT_BUDGET`` and the
monitor's knobs mean what they mean there. In the port the features are
profiled in ``runtime/pipeline.dispatch_quantized`` on the caller's raw
batch, before either encode placement stages it, and predictions at the
block pipeline's sink and in ``DynamicScorer.finish``. The ``fjt-top
--drift`` and ``fjt-drift`` surfaces (``cli.py``), the bench drill and
the ``/healthz`` composition through ``ObsServer`` are not ported;
:meth:`DriftMonitor.health_fn` is.

Every observability plane so far watches the SYSTEM — latency
attribution (obs/attr.py), freshness (obs/freshness.py), pressure
(obs/pressure.py), overload (serving/overload.py). Nothing watches the
DATA: a feature pipeline can silently skew, missing-value rates can
explode, or a model's score distribution can drift for days while p99
and MFU look perfect. This module is the fourth and final sensor plane,
and the first that sees the payload:

- **Profiles** (:class:`DriftPlane`): sampled per-feature profiles —
  count / missing rate / out-of-domain rate for the threshold-rank wire
  (a value beyond the outermost split threshold, where the model is
  constant and extrapolating; for codec-coded categoricals that is an
  unseen/new category) / mean+variance via Welford — plus a mergeable
  :class:`~flink_jpmml_tpu_torch.utils.metrics.QuantileSketch` per feature
  and per prediction stream. Recorded on the already-decoded wire
  batches in ``runtime.pipeline.dispatch_quantized`` and on predictions
  at the sinks, gated by the ``FJT_DRIFT_SAMPLE`` budget: with the env
  unset the plane records NOTHING (one env lookup per dispatch), and
  when set, a rate limiter plus an accumulated-overhead budget keep the
  hot-path cost ≤``FJT_DRIFT_BUDGET`` (default 2%) of wall clock by
  construction. Sketch state rides ``MetricsRegistry.struct_snapshot``
  under ``"sketches"`` and fleet-merges by bucket addition (DrJAX's
  merge-exactly discipline): fleet drift = merge of worker sketches,
  scraped over the same heartbeat/varz channel as every other metric.

- **Baselines** (:class:`BaselineStore`): a reference profile per
  (model, feature), captured by ``fjt-drift snapshot`` (or
  programmatically) into content-addressed JSON beside the autotune
  cache (``drift_baselines/baseline_<model_hash>.json``, payload hash
  embedded). A corrupt/garbage file reads as absent — the silent
  re-snapshot contract, exactly like the autotune cache.

- **Monitor** (:class:`DriftMonitor`): windowed PSI / JS-divergence of
  live-vs-baseline per feature and per score distribution, ticked from
  the batch loops (the RolloutController piggyback pattern, via the
  plane's record calls) AND from the registry scrape hook — so a wedged
  consumer that stops completing batches cannot freeze its own drift
  detector; the /metrics scrape and heartbeat piggyback survive the
  stall. Emits ``drift_score{model,feature}`` / ``prediction_drift`` /
  ``feature_missing_rate`` / ``unseen_category_rate`` gauges (fleet
  merge worst-of), ``drift_alarm``/``drift_clear`` flight events with
  alarm/clear hysteresis (on/off thresholds + dwell), and an optional
  ``/healthz`` composition (:meth:`DriftMonitor.health_fn`).

Surfaces: ``fjt-top --drift`` (cli.py) renders :func:`summary`;
``bench.py --drift-drill`` perturbs one feature's generator mid-run and
asserts the alarm lands on the right feature while a control feature
stays quiet; the rollout controller evaluates candidate-vs-incumbent
prediction PSI through :func:`psi`/:func:`sketch_window`.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import pathlib
import re
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.utils.metrics import (
    MetricsRegistry,
    QuantileSketch,
)

_SAMPLE_ENV = "FJT_DRIFT_SAMPLE"    # seconds between sampled batches
_ROWS_ENV = "FJT_DRIFT_ROWS"        # max rows profiled per sampled batch
_BUDGET_ENV = "FJT_DRIFT_BUDGET"    # overhead fraction cap (default 2%)
_PSI_ENV = "FJT_DRIFT_PSI"          # alarm threshold (default 0.25)
_CLEAR_ENV = "FJT_DRIFT_CLEAR"      # clear threshold (default psi/2)
_WINDOW_ENV = "FJT_DRIFT_WINDOW_S"  # evaluation window (default 60s)
_MIN_N_ENV = "FJT_DRIFT_MIN_N"      # window sample floor (default 200)
_DWELL_ENV = "FJT_DRIFT_DWELL_S"    # hysteresis dwell (default 5s)

_DEFAULT_ROWS = 512
_DEFAULT_BUDGET = 0.02
# how often a monitor re-probes the store for a baseline it has not
# found yet: an operator snapshotting over HTTP (fjt-drift against a
# live /varz) is picked up within this bound; the in-process
# snapshot_registry path arms the monitor immediately instead
_BASELINE_REPROBE_S = 10.0
_DEFAULT_PSI = 0.25  # the classic PSI rule of thumb: > 0.25 = major shift
_DEFAULT_WINDOW_S = 60.0
_DEFAULT_MIN_N = 200
_DEFAULT_DWELL_S = 5.0

_PRED_KEY = "__predictions__"  # the per-model score-distribution series


def _env_float(name: str, default: float) -> float:
    # NOT utils.retry.env_float: that helper rejects non-positive
    # values, and ``FJT_DRIFT_SAMPLE=0`` ("profile every batch") is a
    # legal — and drill-critical — setting here
    try:
        raw = os.environ.get(name)
        return float(raw) if raw not in (None, "") else default
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# Registry-name conventions (literal f-strings at every registration
# site keep tools/metrics_lint.py able to see them)
# ---------------------------------------------------------------------------

_FEAT_SKETCH = re.compile(
    r'^feature_values\{model="([^"]*)",feature="([^"]*)"\}$'
)
_PRED_SKETCH = re.compile(r'^prediction_values\{model="([^"]*)"\}$')
_DRIFT_SCORE = re.compile(
    r'^drift_score\{model="([^"]*)",feature="([^"]*)"\}$'
)


def feature_sketch_name(model: str, feature: str) -> str:
    return f'feature_values{{model="{model}",feature="{feature}"}}'


def prediction_sketch_name(model: str) -> str:
    return f'prediction_values{{model="{model}"}}'


def model_label(obj) -> Optional[str]:
    """The drift plane's model key: the content hash of the compiled
    model (``QuantizedScorer.model_hash``), so baselines are
    content-addressed — the same document always resolves to the same
    baseline file, any recompile included. Accepts a scorer, a
    ``BoundScorer``-like wrapper, or a ``CompiledModel``."""
    for o in (obj, getattr(obj, "q", None)):
        h = getattr(o, "model_hash", None)
        if h:
            return str(h)
    probe = getattr(obj, "quantized_scorer", None)
    if callable(probe):
        try:
            q = probe()
        except Exception:
            return None
        h = getattr(q, "model_hash", None) if q is not None else None
        if h:
            return str(h)
    return None


# ---------------------------------------------------------------------------
# PSI / JS divergence between two sketches
# ---------------------------------------------------------------------------


def _bin_masses(sketch: QuantileSketch, edges: List[float]) -> List[int]:
    return sketch.bin_counts(edges)


def _binned(
    baseline: QuantileSketch,
    live: QuantileSketch,
    bins: int,
    alpha: float,
) -> Optional[Tuple[List[float], List[float]]]:
    """→ (p, q) smoothed bin probabilities (baseline, live) over the
    baseline's quantile-edge grid, or None when either side is empty.
    Edges are UNCLAMPED bucket edges, bitwise-identical across two
    same-layout sketches, so bin membership is exact on both sides."""
    nb, nl = baseline.count(), live.count()
    if nb == 0 or nl == 0:
        return None
    edges = sorted({
        e for e in (
            baseline.quantile_edge(k / bins) for k in range(1, bins)
        ) if e is not None
    })
    bm = _bin_masses(baseline, edges)
    lm = _bin_masses(live, edges)
    k = len(edges) + 1
    p = [(c + alpha) / (nb + alpha * k) for c in bm]
    q = [(c + alpha) / (nl + alpha * k) for c in lm]
    return p, q


def psi(
    baseline: QuantileSketch,
    live: QuantileSketch,
    bins: int = 10,
    alpha: float = 0.5,
) -> Optional[float]:
    """Population Stability Index of ``live`` against ``baseline``,
    binned on the baseline's quantile grid with Laplace smoothing
    (``alpha`` pseudo-counts per bin keep an empty bin from yielding
    infinity). Symmetric in the usual PSI sense:
    ``Σ (p−q)·ln(p/q) ≥ 0``, 0 iff the binned distributions match.
    Rule of thumb: < 0.1 stable, 0.1–0.25 moderate, > 0.25 major."""
    pq = _binned(baseline, live, bins, alpha)
    if pq is None:
        return None
    return sum((a - b) * math.log(a / b) for a, b in zip(*pq))


def js_divergence(
    baseline: QuantileSketch,
    live: QuantileSketch,
    bins: int = 10,
    alpha: float = 0.5,
) -> Optional[float]:
    """Jensen–Shannon divergence (natural log, so bounded by ln 2) on
    the same binning as :func:`psi` — the bounded alternative for
    dashboards that dislike PSI's open scale."""
    pq = _binned(baseline, live, bins, alpha)
    if pq is None:
        return None
    out = 0.0
    for a, b in zip(*pq):
        m = 0.5 * (a + b)
        out += 0.5 * a * math.log(a / m) + 0.5 * b * math.log(b / m)
    return out


def sketch_window(
    new_state: Optional[dict], old_state: Optional[dict]
) -> Optional[QuantileSketch]:
    """The observation window's sketch: newest state minus a baseline
    frame's bucket counts (buckets ADD, so they subtract too — the
    ``_hist_window`` twin for sketches). None when the window holds no
    observations; a count going backwards (worker restart) falls back
    to the cumulative sketch. The window's moments are bucket-derived
    only (``m2`` is unknowable from two cumulative states): windows
    are for DISTRIBUTION comparison (psi/js), not variance readouts."""
    if not isinstance(new_state, dict):
        return None
    if (
        not isinstance(old_state, dict)
        or old_state.get("layout") != new_state.get("layout")
    ):
        try:
            s = QuantileSketch.from_state(new_state)
        except (KeyError, TypeError, ValueError):
            return None
        return s if s.count() else None
    try:
        out = {
            "layout": new_state["layout"],
            "zero": int(new_state.get("zero", 0))
            - int(old_state.get("zero", 0)),
            "sum": float(new_state.get("sum", 0.0))
            - float(old_state.get("sum", 0.0)),
            "m2": 0.0,
            # window extrema are unknowable; the cumulative ones are a
            # safe clamp for quantiles (same convention as _hist_window)
            "min": new_state.get("min", -math.inf),
            "max": new_state.get("max", math.inf),
        }
        # counts going backwards = a restarted worker: cumulative
        # fallback (checked BEFORE the n delta, like _hist_window — a
        # restart usually shows both, and fallback beats a None window)
        if out["zero"] < 0:
            raise ValueError("zero bucket went backwards")
        for side in ("pos", "neg"):
            counts = {
                k: int(v) for k, v in (new_state.get(side) or {}).items()
            }
            for k, v in (old_state.get(side) or {}).items():
                counts[k] = counts.get(k, 0) - int(v)
            if any(v < 0 for v in counts.values()):
                raise ValueError(f"{side} bucket went backwards")
            out[side] = {k: v for k, v in counts.items() if v}
        dn = int(new_state.get("n", 0)) - int(old_state.get("n", 0))
        if dn <= 0:
            return None  # an empty window is no window, not a restart
        out["n"] = dn
        out["mean"] = out["sum"] / dn
        return QuantileSketch.from_state(out)
    except (KeyError, TypeError, ValueError):
        try:
            s = QuantileSketch.from_state(new_state)
        except (KeyError, TypeError, ValueError):
            return None
        return s if s.count() else None


# ---------------------------------------------------------------------------
# Baseline registry (content-addressed JSON beside the autotune cache)
# ---------------------------------------------------------------------------

_SAFE_MODEL = re.compile(r"[^a-zA-Z0-9_.-]")


def _content_hash(payload: dict) -> str:
    blob = json.dumps(
        {k: v for k, v in payload.items() if k != "content_hash"},
        sort_keys=True,
    ).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class BaselineStore:
    """Reference drift profiles per model, on disk beside the autotune
    cache (``<cache dir>/drift_baselines/baseline_<model>.json``; the
    model key is the compiled model's content hash, so the file is
    content-addressed). Load problems — missing, unreadable, corrupt
    JSON, a payload whose embedded ``content_hash`` no longer matches —
    all read as *absent*: the monitor simply has no baseline and the
    operator re-snapshots, the same silent contract the autotune cache
    keeps (a broken file must never crash a serving path)."""

    def __init__(self, root: Optional[os.PathLike] = None):
        if root is None:
            from flink_jpmml_tpu_torch.compile import autotune

            root = autotune.cache_path().parent / "drift_baselines"
        self.root = pathlib.Path(root)

    def path(self, model: str) -> pathlib.Path:
        return self.root / f"baseline_{_SAFE_MODEL.sub('_', model)}.json"

    def save(self, model: str, payload: dict) -> pathlib.Path:
        """Persist a baseline (tmp file + atomic replace). UNLIKE load,
        a save failure RAISES: snapshotting is an operator action, and
        silently reporting an unwritable baseline as captured would
        leave the drift plane dark while the operator believes it is
        armed."""
        payload = dict(payload)
        payload.setdefault("version", 1)
        payload["model"] = model
        payload["content_hash"] = _content_hash(payload)
        path = self.path(model)
        tmp = path.with_suffix(f".tmp-{os.getpid()}")
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def load(self, model: str) -> Optional[dict]:
        try:
            with open(self.path(model)) as f:
                payload = json.load(f)
            if not isinstance(payload, dict):
                return None
            if payload.get("content_hash") != _content_hash(payload):
                return None  # truncated/edited file: treat as absent
            if not isinstance(payload.get("features"), dict):
                return None
            return payload
        except (OSError, ValueError):
            return None

    def models(self) -> List[str]:
        try:
            out = []
            for p in sorted(self.root.glob("baseline_*.json")):
                payload = self.load(p.stem[len("baseline_"):])
                if payload is not None:
                    out.append(str(payload.get("model")))
            return out
        except OSError:
            return []


def snapshot_from_struct(struct: dict) -> Dict[str, dict]:
    """Build baseline payloads from a metrics struct (a ``/varz``
    scrape, a heartbeat merge, a BENCH artifact's embedded varz):
    → ``{model label: payload}`` with per-feature sketch states, the
    missing/out-of-domain totals, and the prediction sketch when one
    was recorded. The payload is exactly what ``DriftMonitor`` diffs
    live windows against."""
    sketches = (struct or {}).get("sketches") or {}
    counters = (struct or {}).get("counters") or {}
    out: Dict[str, dict] = {}
    for name, state in sketches.items():
        m = _FEAT_SKETCH.match(name)
        if m:
            label, feat = m.group(1), m.group(2)
            entry = out.setdefault(
                label, {"features": {}, "stats": {}, "predictions": None}
            )
            entry["features"][feat] = state
            stats = {}
            for kind in ("records", "missing", "unseen"):
                v = counters.get(
                    f'drift_feature_{kind}'
                    f'{{model="{label}",feature="{feat}"}}'
                )
                if v is not None:
                    stats[kind] = float(v)
            if stats:
                entry["stats"][feat] = stats
            continue
        m = _PRED_SKETCH.match(name)
        if m:
            entry = out.setdefault(
                m.group(1),
                {"features": {}, "stats": {}, "predictions": None},
            )
            entry["predictions"] = state
    # a model with only a prediction sketch still gets a payload; one
    # with neither never appears
    return out


def snapshot_registry(
    metrics: MetricsRegistry,
    store: Optional[BaselineStore] = None,
    model: Optional[str] = None,
) -> Dict[str, dict]:
    """Capture the registry's CURRENT cumulative profiles as baselines
    and persist them; → the saved payloads per model label."""
    store = store or BaselineStore()
    payloads = snapshot_from_struct(metrics.struct_snapshot())
    saved = {}
    mon = _MONITORS.get(metrics)
    for label, payload in payloads.items():
        if model is not None and label != model:
            continue
        store.save(label, payload)
        saved[label] = payload
        if mon is not None:
            # arm the live monitor NOW — the 10s missing-baseline
            # re-probe must not delay a snapshot the operator just took
            mon.set_baseline(label, payload)
    return saved


# ---------------------------------------------------------------------------
# The sampled recorder (hot-path side)
# ---------------------------------------------------------------------------


class _ModelHandles:
    """Per-model cached registry handles + wire domain tables: the
    sampled path must not pay F f-string formats + registry locks per
    recorded batch."""

    __slots__ = ("fields", "lo", "hi", "records", "missing", "unseen",
                 "sketches")

    def __init__(self, reg: MetricsRegistry, label: str, wire):
        self.fields = tuple(wire.fields)
        lo = np.full((len(self.fields),), np.nan, np.float32)
        hi = np.full((len(self.fields),), np.nan, np.float32)
        for j, cuts in enumerate(wire.cuts):
            if len(cuts):
                lo[j], hi[j] = cuts[0], cuts[-1]
        self.lo, self.hi = lo, hi
        self.records, self.missing, self.unseen, self.sketches = (
            [], [], [], []
        )
        for name in self.fields:
            self.records.append(reg.counter(
                f'drift_feature_records{{model="{label}",feature="{name}"}}'
            ))
            self.missing.append(reg.counter(
                f'drift_feature_missing{{model="{label}",feature="{name}"}}'
            ))
            self.unseen.append(reg.counter(
                f'drift_feature_unseen{{model="{label}",feature="{name}"}}'
            ))
            self.sketches.append(reg.sketch(
                f'feature_values{{model="{label}",feature="{name}"}}'
            ))


class DriftPlane:
    """The hot-path recorder: sampled per-feature profiles at dispatch
    (``record_features``) and score distributions at the sinks
    (``record_predictions``), with the monitor ticked from both (the
    batch-loop leg of its double ticking).

    Cost model: an UNSAMPLED call is one clock read + a lock'd
    rate-limit check; a SAMPLED call pays a handful of vectorized numpy
    passes over ≤``max_rows`` rows, and its measured cost feeds an
    accumulated-overhead budget — once profiling has spent more than
    ``budget_frac`` (default 2%) of wall clock since the plane was
    created, sampling skips until the fraction decays. The hot path
    therefore stays under the budget BY CONSTRUCTION, whatever interval
    the operator picks."""

    def __init__(
        self,
        metrics: MetricsRegistry,
        interval_s: Optional[float] = None,
        max_rows: Optional[int] = None,
        budget_frac: Optional[float] = None,
        store: Optional[BaselineStore] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._metrics_ref = weakref.ref(metrics)
        if interval_s is None:
            interval_s = _env_float(_SAMPLE_ENV, 1.0)
        self.interval_s = max(0.0, float(interval_s))
        if max_rows is None:
            max_rows = int(_env_float(_ROWS_ENV, _DEFAULT_ROWS))
        self.max_rows = max(1, int(max_rows))
        if budget_frac is None:
            budget_frac = _env_float(_BUDGET_ENV, _DEFAULT_BUDGET)
        # <= 0 disables the budget gate (drills want determinism)
        self.budget_frac = (
            float(budget_frac) if budget_frac and budget_frac > 0 else None
        )
        self._clock = clock
        self._mu = threading.Lock()
        self._t0 = clock()
        self._last: Dict[str, float] = {}
        self._spent = 0.0
        self._sampled = 0
        self._skipped = 0
        self._handles: Dict[str, _ModelHandles] = {}
        self._pred_sketches: Dict[str, QuantileSketch] = {}
        self.monitor = monitor_for(metrics, store=store)

    # -- gating ------------------------------------------------------------

    def _claim(self, kind: str, now: float) -> bool:
        with self._mu:
            if now - self._last.get(kind, -math.inf) < self.interval_s:
                return False
            if (
                self.budget_frac is not None
                and self._spent
                > self.budget_frac * max(now - self._t0, 1e-9)
            ):
                self._skipped += 1
                return False
            self._last[kind] = now
            return True

    def _charge(self, cost: float) -> None:
        with self._mu:
            self._spent += cost
            self._sampled += 1

    def overhead_fraction(self) -> float:
        """Profiling seconds spent over wall seconds since creation —
        the quantity the budget bounds (perf_smoke pins it ≤ 2%)."""
        with self._mu:
            return self._spent / max(self._clock() - self._t0, 1e-9)

    def stats(self) -> dict:
        with self._mu:
            return {
                "sampled": self._sampled,
                "skipped": self._skipped,
                "spent_s": self._spent,
            }

    # -- recording ---------------------------------------------------------

    def record_features(self, q, X, M=None) -> bool:
        """Profile one raw f32 batch headed into ``q``'s dispatch
        (called from ``dispatch_quantized`` BEFORE encoding): per-
        feature missing/out-of-domain counts against the threshold-rank
        wire's cut tables, Welford moments, and the value sketches.
        → True when this batch was sampled."""
        wire = getattr(q, "wire", None)
        label = model_label(q)
        if wire is None or label is None:
            return False
        now = self._clock()
        if not self._claim("features", now):
            if self.monitor is not None:
                self.monitor.maybe_tick()
            return False
        t_start = time.perf_counter()
        try:
            reg = self._metrics_ref()
            if reg is None:
                return False
            h = self._handles.get(label)
            if h is None:
                h = self._handles[label] = _ModelHandles(reg, label, wire)
            X = np.asarray(X, np.float32)
            if X.ndim != 2 or X.shape[1] != len(h.fields):
                return False
            # ceil stride: the sample spans the WHOLE batch (floor
            # would truncate to the leading rows — drift clustering in
            # a drain's tail would be systematically under-counted)
            step = -(-X.shape[0] // self.max_rows)
            Xs = X[::step][: self.max_rows]
            miss = np.isnan(Xs)
            if M is not None:
                Ms = np.asarray(M, bool)[::step][: self.max_rows]
                miss = miss | Ms
            # out-of-domain: beyond the outermost split threshold —
            # the region where a threshold-rank model extrapolates (a
            # categorical codec value outside the cut span is an
            # unseen/new category); NaN lo/hi (cut-less features)
            # compare False, so they never count
            with np.errstate(invalid="ignore"):
                ood = (~miss) & ((Xs < h.lo[None, :]) | (Xs > h.hi[None, :]))
            n_rows = Xs.shape[0]
            miss_counts = miss.sum(axis=0)
            ood_counts = ood.sum(axis=0)
            vals = np.where(miss, np.nan, Xs.astype(np.float64))
            for j in range(len(h.fields)):
                h.records[j].inc(n_rows)
                if miss_counts[j]:
                    h.missing[j].inc(int(miss_counts[j]))
                if ood_counts[j]:
                    h.unseen[j].inc(int(ood_counts[j]))
                h.sketches[j].observe_many(vals[:, j])
            return True
        finally:
            self._charge(time.perf_counter() - t_start)
            if self.monitor is not None:
                self.monitor.maybe_tick()

    def record_predictions(self, model, out, n: Optional[int] = None) -> bool:
        """Record a sink-side score distribution sample for ``model``
        (a label string or any object :func:`model_label` resolves).
        ``out`` is whatever the dispatch produced — a score array, a
        ``(value, probs, labels)`` classification tuple (the VALUE
        plane is sketched), or a list of ``Prediction``s."""
        label = model if isinstance(model, str) else model_label(model)
        if not label:
            return False
        now = self._clock()
        if not self._claim("predictions", now):
            if self.monitor is not None:
                self.monitor.maybe_tick()
            return False
        t_start = time.perf_counter()
        try:
            reg = self._metrics_ref()
            if reg is None:
                return False
            vals = _prediction_values(out, n)
            if vals is None or vals.size == 0:
                return False
            sk = self._pred_sketches.get(label)
            if sk is None:
                sk = self._pred_sketches[label] = reg.sketch(
                    f'prediction_values{{model="{label}"}}'
                )
            if vals.size > self.max_rows:
                step = -(-vals.size // self.max_rows)  # ceil: span all
                vals = vals[::step][: self.max_rows]
            sk.observe_many(vals)
            return True
        finally:
            self._charge(time.perf_counter() - t_start)
            if self.monitor is not None:
                self.monitor.maybe_tick()


def _prediction_values(out, n: Optional[int]) -> Optional[np.ndarray]:
    """Best-effort score-value extraction from a dispatch result; None
    when the shape is unrecognizable (the plane records nothing rather
    than poisoning a sketch)."""
    try:
        if isinstance(out, (tuple,)) and out:
            out = out[0]  # classification: (value, probs, labels)
        if isinstance(out, list):
            vals = [
                float(p.score.value)
                for p in out
                if getattr(p, "is_empty", True) is False
                and p.score is not None
            ]
            return np.asarray(vals, np.float64)
        arr = np.asarray(out, np.float64).ravel()
        if n is not None:
            arr = arr[: int(n)]
        return arr
    except Exception:
        return None


# ---------------------------------------------------------------------------
# The monitor (observer side)
# ---------------------------------------------------------------------------


def _counter_delta(
    new: Dict[str, float], old: Optional[Dict[str, float]], key: str
) -> float:
    try:
        nv = float((new or {}).get(key, 0.0))
        ov = float((old or {}).get(key, 0.0)) if old else 0.0
    except (TypeError, ValueError):
        return 0.0
    d = nv - ov
    # a restarted worker resets its counters: fall back to cumulative
    return d if d >= 0 else nv


class DriftMonitor:
    """Windowed live-vs-baseline divergence with alarm hysteresis.

    Two wiring modes, one evaluation:

    - **registry mode** (``metrics=``): reads the registry's sketches
      and counters DIRECTLY (never through ``struct_snapshot`` — the
      monitor registers itself as a scrape hook, and a hook that
      re-entered ``struct_snapshot`` would recurse), ticks from the
      plane's record calls (batch loops) and from every scrape.
    - **struct mode** (``struct_fn=``): windows over any struct
      producer — a supervisor's ``fleet_metrics`` or a drill's
      ``merge_structs`` closure — and is ticked by its owner; gauges
      land in ``gauge_metrics`` (default: nowhere) so a fleet monitor
      can publish into the supervisor's registry.

    Per tick, for every model with a baseline: the trailing-window
    sketch (cumulative-minus-baseline-frame; cumulative on cold start)
    of each feature and of the prediction stream is PSI'd against the
    stored baseline once it holds ``min_n`` observations. Alarm
    hysteresis: a score at/above ``psi_alarm`` sustained ``dwell_s``
    raises ``drift_alarm`` (flight event + ``drift_alarms`` counter +
    ``drift_alarmed`` gauge); clearing requires sustained
    ``< psi_clear`` (default half the alarm threshold) — a score
    wobbling inside the band neither alarms nor clears."""

    def __init__(
        self,
        metrics: Optional[MetricsRegistry] = None,
        struct_fn: Optional[Callable[[], dict]] = None,
        store: Optional[BaselineStore] = None,
        baselines: Optional[Dict[str, dict]] = None,
        psi_alarm: Optional[float] = None,
        psi_clear: Optional[float] = None,
        min_n: Optional[int] = None,
        window_s: Optional[float] = None,
        dwell_s: Optional[float] = None,
        bins: int = 10,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        gauge_metrics: Optional[MetricsRegistry] = None,
    ):
        if (metrics is None) == (struct_fn is None):
            raise ValueError("pass exactly one of metrics= / struct_fn=")
        self._metrics_ref = (
            weakref.ref(metrics) if metrics is not None else None
        )
        self._struct_fn = struct_fn
        self._gauges_ref = weakref.ref(
            gauge_metrics if gauge_metrics is not None else metrics
        ) if (gauge_metrics is not None or metrics is not None) else None
        self._store = store if store is not None else BaselineStore()
        self._baselines: Dict[str, Optional[dict]] = dict(baselines or {})
        self._baseline_checked: Dict[str, float] = {}
        self.psi_alarm = (
            psi_alarm if psi_alarm is not None
            else _env_float(_PSI_ENV, _DEFAULT_PSI)
        )
        self.psi_clear = (
            psi_clear if psi_clear is not None
            else _env_float(_CLEAR_ENV, self.psi_alarm / 2.0)
        )
        self.min_n = (
            int(min_n) if min_n is not None
            else int(_env_float(_MIN_N_ENV, _DEFAULT_MIN_N))
        )
        self.window_s = (
            float(window_s) if window_s is not None
            else _env_float(_WINDOW_ENV, _DEFAULT_WINDOW_S)
        )
        self.dwell_s = (
            float(dwell_s) if dwell_s is not None
            else _env_float(_DWELL_ENV, _DEFAULT_DWELL_S)
        )
        self.bins = int(bins)
        self._interval = interval_s
        self._clock = clock
        self._mu = threading.Lock()
        self._frames: List[Tuple[float, dict]] = []
        self._last_tick = 0.0
        # (model, feature-or-_PRED_KEY) -> hysteresis state
        self._series: Dict[Tuple[str, str], dict] = {}
        if metrics is not None:
            # observer-driven ticking: a wedged consumer stops calling
            # record_*, but /metrics scrapes and heartbeat piggybacks
            # still run struct_snapshot — the detector must not freeze
            # in exactly the scenario it exists to expose
            metrics.add_scrape_hook(self.maybe_tick)

    # -- baselines ---------------------------------------------------------

    def set_baseline(self, model: str, payload: Optional[dict]) -> None:
        with self._mu:
            self._baselines[model] = payload

    def _baseline(self, model: str, now: float) -> Optional[dict]:
        with self._mu:
            cur = self._baselines.get(model)
            # the store is re-probed periodically whether a baseline is
            # held or not: the operator may snapshot (or RE-snapshot —
            # the accept-the-new-regime remedy the runbook teaches)
            # over HTTP while the pipeline runs, and that flow cannot
            # reach this process's monitor directly
            last = self._baseline_checked.get(model, -math.inf)
            if now - last < _BASELINE_REPROBE_S:
                return cur
            self._baseline_checked[model] = now
        payload = self._store.load(model)
        with self._mu:
            if payload is not None:
                held = self._baselines.get(model)
                if (
                    held is None
                    or held.get("content_hash")
                    != payload.get("content_hash")
                ):
                    self._baselines[model] = payload
                cur = self._baselines[model]
            # a store miss keeps whatever is held: a deleted baseline
            # file (or a programmatic set_baseline with an empty store)
            # must not disarm a live monitor mid-flight
            return cur

    # -- collection --------------------------------------------------------

    def _collect(self) -> dict:
        if self._struct_fn is not None:
            s = self._struct_fn() or {}
            return {
                "sketches": dict(s.get("sketches") or {}),
                "counters": dict(s.get("counters") or {}),
            }
        reg = self._metrics_ref() if self._metrics_ref else None
        if reg is None:
            return {"sketches": {}, "counters": {}}
        counters = reg._views()[0]  # locked copy of the counter map
        return {
            "sketches": {
                n: s.state() for n, s in reg.sketches().items()
            },
            "counters": {n: c.get() for n, c in counters.items()},
        }

    # -- ticking -----------------------------------------------------------

    def maybe_tick(self) -> Optional[List[dict]]:
        now = self._clock()
        with self._mu:
            if now - self._last_tick < self._interval:
                return None
            self._last_tick = now
        return self.tick(now)

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Evaluate every baselined series once; → alarm/clear
        transitions taken this tick."""
        now = self._clock() if now is None else now
        frame = self._collect()
        with self._mu:
            self._last_tick = now
            self._frames.append((now, frame))
            while (
                len(self._frames) >= 2
                and self._frames[1][0] <= now - self.window_s
            ):
                self._frames.pop(0)
            old = self._frames[0][1] if len(self._frames) >= 2 else None
        labels = set()
        for name in frame["sketches"]:
            m = _FEAT_SKETCH.match(name)
            if m:
                labels.add(m.group(1))
                continue
            m = _PRED_SKETCH.match(name)
            if m:
                labels.add(m.group(1))
        transitions: List[dict] = []
        for label in sorted(labels):
            baseline = self._baseline(label, now)
            if baseline is None:
                continue
            transitions.extend(
                self._evaluate_model(label, baseline, frame, old, now)
            )
        return transitions

    def _evaluate_model(
        self, label: str, baseline: dict, new: dict,
        old: Optional[dict], now: float,
    ) -> List[dict]:
        reg = self._gauges_ref() if self._gauges_ref else None
        out: List[dict] = []
        new_sk = new.get("sketches") or {}
        old_sk = (old or {}).get("sketches") or {}
        new_c = new.get("counters") or {}
        old_c = (old or {}).get("counters") or {}
        for feat, bstate in sorted(
            (baseline.get("features") or {}).items()
        ):
            key = feature_sketch_name(label, feat)
            window = sketch_window(new_sk.get(key), old_sk.get(key))
            score = None
            if window is not None and window.count() >= self.min_n:
                try:
                    score = psi(
                        QuantileSketch.from_state(bstate), window,
                        bins=self.bins,
                    )
                except (KeyError, TypeError, ValueError):
                    score = None
            if score is not None and reg is not None:
                reg.gauge(
                    f'drift_score{{model="{label}",feature="{feat}"}}'
                ).set(round(score, 4))
            rec = _counter_delta(
                new_c, old_c,
                f'drift_feature_records{{model="{label}",feature="{feat}"}}',
            )
            if rec > 0 and reg is not None:
                mis = _counter_delta(
                    new_c, old_c,
                    f'drift_feature_missing'
                    f'{{model="{label}",feature="{feat}"}}',
                )
                uns = _counter_delta(
                    new_c, old_c,
                    f'drift_feature_unseen'
                    f'{{model="{label}",feature="{feat}"}}',
                )
                reg.gauge(
                    f'feature_missing_rate{{model="{label}",feature="{feat}"}}'  # noqa: E501
                ).set(round(mis / rec, 4))
                present = max(rec - mis, 1.0)
                reg.gauge(
                    f'unseen_category_rate{{model="{label}",feature="{feat}"}}'  # noqa: E501
                ).set(round(uns / present, 4))
            tr = self._hysteresis(label, feat, score, now, reg)
            if tr is not None:
                out.append(tr)
        bpred = baseline.get("predictions")
        if isinstance(bpred, dict):
            key = prediction_sketch_name(label)
            window = sketch_window(new_sk.get(key), old_sk.get(key))
            score = None
            if window is not None and window.count() >= self.min_n:
                try:
                    score = psi(
                        QuantileSketch.from_state(bpred), window,
                        bins=self.bins,
                    )
                except (KeyError, TypeError, ValueError):
                    score = None
            if score is not None and reg is not None:
                reg.gauge(f'prediction_drift{{model="{label}"}}').set(
                    round(score, 4)
                )
            tr = self._hysteresis(label, _PRED_KEY, score, now, reg)
            if tr is not None:
                out.append(tr)
        return out

    def _hysteresis(
        self, label: str, feat: str, score: Optional[float],
        now: float, reg,
    ) -> Optional[dict]:
        with self._mu:
            st = self._series.get((label, feat))
            if st is None:
                if score is None:
                    # a series that has never produced a verdict has no
                    # state worth tracking (keeps scores() honest)
                    return None
                st = self._series[(label, feat)] = {
                    "alarmed": False, "above": None, "below": None,
                    "score": None,
                }
            if score is None:
                # no evaluable window: progress toward EITHER transition
                # resets, the current state holds
                st["above"] = st["below"] = None
                return None
            st["score"] = score
            transition = None
            if score >= self.psi_alarm:
                st["below"] = None
                if not st["alarmed"]:
                    if st["above"] is None:
                        st["above"] = now
                    if now - st["above"] >= self.dwell_s:
                        st["alarmed"] = True
                        st["above"] = None
                        transition = "alarm"
            elif score < self.psi_clear:
                st["above"] = None
                if st["alarmed"]:
                    if st["below"] is None:
                        st["below"] = now
                    if now - st["below"] >= self.dwell_s:
                        st["alarmed"] = False
                        st["below"] = None
                        transition = "clear"
            else:
                # inside the hysteresis band: neither direction accrues
                st["above"] = st["below"] = None
        if transition is None:
            return None
        feat_out = None if feat == _PRED_KEY else feat
        if reg is not None:
            # the gauge keeps the raw series key (the prediction series
            # rides as feature="__predictions__"); only the flight
            # event maps it to feature=null
            reg.gauge(
                f'drift_alarmed{{model="{label}",feature="{feat}"}}'
            ).set(1.0 if transition == "alarm" else 0.0)
        if transition == "alarm":
            if reg is not None:
                reg.counter("drift_alarms").inc()
                # journey tail-sampling hook (obs/trace.py): keep the
                # next few finishing record journeys so the timeline
                # AROUND the drift alarm survives — "drift-alarmed"
                # is one of the interesting-journey classes
                from flink_jpmml_tpu_torch.obs import trace as trace_mod

                jstore = trace_mod.store_for(reg)
                if jstore is not None:
                    jstore.note_alarm("drift")
            flight.record(
                "drift_alarm", model=label, feature=feat_out,
                psi=round(score, 4), threshold=self.psi_alarm,
            )
        else:
            flight.record(
                "drift_clear", model=label, feature=feat_out,
                psi=round(score, 4), threshold=self.psi_clear,
            )
        return {
            "model": label, "feature": feat_out,
            "transition": transition, "psi": score,
        }

    # -- surfaces ----------------------------------------------------------

    def alarms(self) -> List[dict]:
        with self._mu:
            return [
                {
                    "model": label,
                    "feature": None if feat == _PRED_KEY else feat,
                    "psi": st.get("score"),
                }
                for (label, feat), st in sorted(self._series.items())
                if st["alarmed"]
            ]

    def scores(self) -> Dict[Tuple[str, str], Optional[float]]:
        with self._mu:
            return {
                k: st.get("score") for k, st in self._series.items()
            }

    def health(self) -> dict:
        alarms = self.alarms()
        return {
            "drift": {
                "ok": not alarms,
                "alarms": [
                    {
                        "model": a["model"],
                        "feature": a["feature"],
                        "psi": (
                            round(a["psi"], 4)
                            if a["psi"] is not None else None
                        ),
                    }
                    for a in alarms
                ],
            },
        }

    def health_fn(
        self, base: Optional[Callable[[], dict]] = None
    ) -> Callable[[], dict]:
        """Compose a ``/healthz`` callback (the SLOTracker shape):
        liveness stays the server's call, the drift verdict rides."""

        def _health() -> dict:
            out = dict(base()) if base is not None else {"ok": True}
            out.update(self.health())
            return out

        return _health


# ---------------------------------------------------------------------------
# Per-registry singletons
# ---------------------------------------------------------------------------

_PLANES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_MONITORS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# reentrant: DriftPlane.__init__ resolves its monitor through
# monitor_for while install() already holds the guard
_SINGLETON_MU = threading.RLock()


def monitor_for(
    metrics: Optional[MetricsRegistry],
    store: Optional[BaselineStore] = None,
    **kw,
) -> Optional[DriftMonitor]:
    """The registry's DriftMonitor (one per registry, weakly held);
    created on first use, scrape-hooked onto the registry."""
    if metrics is None:
        return None
    mon = _MONITORS.get(metrics)
    if mon is None:
        with _SINGLETON_MU:
            mon = _MONITORS.get(metrics)
            if mon is None:
                mon = _MONITORS[metrics] = DriftMonitor(
                    metrics=metrics, store=store, **kw
                )
    return mon


def install(
    metrics: MetricsRegistry,
    interval_s: Optional[float] = None,
    max_rows: Optional[int] = None,
    budget_frac: Optional[float] = None,
    store: Optional[BaselineStore] = None,
) -> DriftPlane:
    """Force-arm the drift plane on a registry regardless of
    ``FJT_DRIFT_SAMPLE`` (bench modes arm it when a stored baseline
    exists for the served model; drills arm it with interval 0)."""
    plane = _PLANES.get(metrics)
    if plane is None:
        with _SINGLETON_MU:
            plane = _PLANES.get(metrics)
            if plane is None:
                plane = _PLANES[metrics] = DriftPlane(
                    metrics,
                    interval_s=interval_s,
                    max_rows=max_rows,
                    budget_frac=budget_frac,
                    store=store,
                )
    return plane


def plane_for(metrics: Optional[MetricsRegistry]) -> Optional[DriftPlane]:
    """The hot-path gate: the registry's plane if one is armed, else —
    with ``FJT_DRIFT_SAMPLE`` set — arm one now. With the env unset and
    nothing installed this is a dict miss + one env lookup, and the
    drift plane records NOTHING (the pinned zero-records contract)."""
    if metrics is None:
        return None
    plane = _PLANES.get(metrics)
    if plane is not None:
        return plane
    if os.environ.get(_SAMPLE_ENV) in (None, ""):
        return None
    return install(metrics)


# ---------------------------------------------------------------------------
# Summaries (fjt-top --drift / bench artifacts)
# ---------------------------------------------------------------------------

_G_SCORE = re.compile(
    r'^(drift_score|feature_missing_rate|unseen_category_rate|'
    r'drift_alarmed)\{model="([^"]*)",feature="([^"]*)"\}$'
)
_G_PRED = re.compile(r'^prediction_drift\{model="([^"]*)"\}$')


def summary(struct_or_registry) -> Optional[dict]:
    """Per-model drift summary from a metrics struct (or registry):
    ``{model: {"features": {name: {psi, missing_rate, unseen_rate, n,
    alarmed}}, "prediction_psi", "prediction_alarmed"}}`` — what
    ``fjt-top --drift`` ranks and bench artifacts embed. None when the
    struct carries no drift telemetry."""
    if isinstance(struct_or_registry, MetricsRegistry):
        struct = struct_or_registry.struct_snapshot()
    else:
        struct = struct_or_registry or {}
    gauges = struct.get("gauges") or {}
    sketches = struct.get("sketches") or {}
    out: Dict[str, dict] = {}

    def model(label: str) -> dict:
        return out.setdefault(
            label,
            {"features": {}, "prediction_psi": None,
             "prediction_alarmed": False},
        )

    def feat(label: str, name: str) -> dict:
        return model(label)["features"].setdefault(
            name,
            {"psi": None, "missing_rate": None, "unseen_rate": None,
             "n": None, "alarmed": False},
        )

    for raw, g in gauges.items():
        v = g.get("value") if isinstance(g, dict) else None
        if v is None:
            continue
        m = _G_SCORE.match(raw)
        if m:
            kind, label, name = m.groups()
            if kind == "drift_alarmed" and name == _PRED_KEY:
                model(label)["prediction_alarmed"] = bool(v)
                continue
            row = feat(label, name)
            if kind == "drift_score":
                row["psi"] = v
            elif kind == "feature_missing_rate":
                row["missing_rate"] = v
            elif kind == "unseen_category_rate":
                row["unseen_rate"] = v
            else:
                row["alarmed"] = bool(v)
            continue
        m = _G_PRED.match(raw)
        if m:
            model(m.group(1))["prediction_psi"] = v
    for raw, state in sketches.items():
        m = _FEAT_SKETCH.match(raw)
        if m and isinstance(state, dict):
            feat(m.group(1), m.group(2))["n"] = state.get("n")
    return out or None


def artifact_fields(metrics_or_struct) -> Optional[dict]:
    """The compact per-mode artifact embedding (bench lines): the
    worst-feature psi per model plus the alarm count — the data-health
    headline next to the perf headline."""
    s = summary(metrics_or_struct)
    if not s:
        return None
    out: Dict[str, dict] = {}
    for label, m in s.items():
        scored = {
            name: row["psi"] for name, row in m["features"].items()
            if row["psi"] is not None
        }
        worst = max(scored.items(), key=lambda kv: kv[1]) if scored else None
        out[label] = {
            "worst_feature": worst[0] if worst else None,
            "worst_psi": round(worst[1], 4) if worst else None,
            "prediction_psi": (
                round(m["prediction_psi"], 4)
                if m["prediction_psi"] is not None else None
            ),
            "alarmed_features": sorted(
                name for name, row in m["features"].items()
                if row["alarmed"]
            ),
        }
    return out
