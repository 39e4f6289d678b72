"""Continuous device profiling: sampled dispatch timing → live roofline.

The port of ``flink_jpmml_tpu/obs/profiler.py``. A rate-limited sampler
measures the device time of one dispatch now and then, and from the
sample stream derives per-registry gauges under the JAX package's names:

- ``device_mfu``          — achieved operations/s over the card's peak
                            rate for them,
- ``device_membw_util``   — achieved bytes/s over the card's memory rate,
- ``flops_per_record``    — the scorer's operations per record,
- ``device_ns_per_record``— smoothed measured device time per record,

plus a ``stage_seconds{stage="device"}`` entry a sample (the attribution
ledger's sampled device column), the ``device_samples`` counter, and a
row a sample in the **kernel cost ledger** (the training data of
``compile/costmodel.py``).

What the counts are on this card. For a ``cuda`` scorer (the walk kernel
``qtrees_leaf_rows``) the operations are what PERF.md's bound counts: the
walk's integer steps per record, the sum of the trees' depths
(``QuantizedScorer._meta["path_steps"]``), held to the H100's INT32 issue
rate; the bytes are what the kernel moves per record, its F codes in and
its f32[C] row out (``obs/attr.py dispatch_profile``). The JAX package's
dense path-matrix count (2·T·S·L + 2·T·L) is kept for the torch twin,
whose einsums do execute it (held to the same row, so its ``device_mfu``
reads against the INT32 rate, a quarter of the card's FP32 rate).

How a sample is taken (``runtime/pipeline.py``). The dispatcher asks
:meth:`DeviceProfiler.should_sample` at a launch; on yes, the dispatch
runs inside :func:`open_sample`, and the scorer marks the two ends of the
work the kernel search times for the variant it serves
(:func:`mark_start` / :func:`mark_stop`): on the ``cuda`` backends its
function on codes already on the card (the walk kernel and its epilogue,
after the H2D copy and the encode stage, before the D2H copy); on the
torch twin the staged payload's copy, its unpack and the torch stages.
On the card the marks are timing CUDA events on the dispatch's stream,
read when the batch completes, after the wait the window makes anyway:
no synchronize and no drain is added to the hot path, and the 1%
overhead budget of the JAX sampler (whose bracket drains the window) is
never spent. On the CPU, where the work is synchronous, the marks read
the host clock. A region the sweep does not time (the torch twin behind
a fused encode) still feeds the gauges and the ``device`` stage but
trains no cost-model row and arms no drift band, so a sample and a sweep
row for the same features always time the same work.
``FJT_PROF_SAMPLE`` sets the interval (default 1.0 s; ``0`` / ``off``
disables).

Peaks (:func:`chip_peaks`): one row, the H100 (SXM, data sheet): INT32
issue 1.67e13 operations/s (132 SMs × 64 INT32 lanes × 1.98 GHz boost)
and HBM3 3.35e12 bytes/s. The JAX package's TPU rows are not carried:
no device this package runs on has those names. An unknown device (the
CPU, another card) takes a nominal 1e12 / 100e9 so the gauges stay live
as trends (``FJT_PROF_PEAKS=ops,bytes`` overrides), or None under
``strict``.

The ledger persists beside the autotune cache as
``kernel_costs-<device>.json`` (``utils/cache.device_tag``), never in the
JAX package's cache; its rows carry the platform they were measured on.
The path is resolved at each write, and the writes run on a background
thread (and at a dispatcher's close), never on the thread that scores.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

_SAMPLE_ENV = "FJT_PROF_SAMPLE"
_PEAKS_ENV = "FJT_PROF_PEAKS"
_DEFAULT_INTERVAL_S = 1.0
_OVERHEAD_BUDGET = 0.01  # ≤1% of wall clock spent inside samples
_EWMA_ALPHA = 0.3  # smoothing for the per-record device time
# prediction drift band: observed device cost outside [pred/band,
# pred·band] for this many consecutive samples means the adopted kernel
# config's prediction went stale — invalidate the cost-model fit and
# clear the model's autotune entry so the next warmup re-searches
_PRED_BAND = 1.75
_PRED_STRIKES = 3

# device name substring → (peak operations/s, memory bytes/s)
CHIP_PEAKS = (
    # NVIDIA H100 SXM data sheet: INT32 issue rate 132 SMs × 64 lanes ×
    # 1.98 GHz (the walk kernel's integer steps), HBM3 3.35 TB/s
    ("h100", (1.67e13, 3.35e12)),
)
_NOMINAL_PEAKS = (1e12, 100e9)


def chip_peaks(
    device_kind: str, strict: bool = False
) -> Optional[Tuple[float, float]]:
    """(peak operations/s, memory bytes/s) for a device name. Unknown
    kinds return None under ``strict`` or the nominal/env-overridden
    fallback otherwise (live trend gauges)."""
    kind = (device_kind or "").lower()
    for sub, peaks in CHIP_PEAKS:
        if sub in kind:
            return peaks
    if strict:
        return None
    raw = os.environ.get(_PEAKS_ENV)
    if raw:
        try:
            f, b = (float(x) for x in raw.split(","))
            if f > 0 and b > 0:
                return (f, b)
        except ValueError:
            pass
    return _NOMINAL_PEAKS


def roofline(
    dev_rate: float,
    flops_per_record: Optional[float],
    bytes_per_record: Optional[float],
    peaks: Optional[Tuple[float, float]],
) -> Tuple[Optional[float], Optional[float]]:
    """→ (mfu, membw_util) for a measured device record rate against a
    device's peaks; None fields where the counts or peaks are unknown."""
    if peaks is None or dev_rate <= 0:
        return None, None
    flop_peak, membw_peak = peaks
    mfu = (
        dev_rate * flops_per_record / flop_peak
        if flops_per_record else None
    )
    membw = (
        dev_rate * bytes_per_record / membw_peak
        if bytes_per_record else None
    )
    return mfu, membw


def _device_kind() -> str:
    import torch

    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(torch.cuda.current_device())


# ---------------------------------------------------------------------------
# Kernel cost ledger (persisted next to the autotune cache)
# ---------------------------------------------------------------------------


def cost_ledger_path() -> str:
    """``kernel_costs-<device>.json`` in the autotune cache's directory —
    the measured-cost training data lives next to the measured-config
    cache it feeds (``compile/costmodel.py``)."""
    from flink_jpmml_tpu_torch.compile import autotune
    from flink_jpmml_tpu_torch.utils import cache

    return str(autotune.cache_path().parent
               / f"kernel_costs-{cache.device_tag()}.json")


def _read_entries(path: str) -> Dict[str, dict]:
    """Parse one ledger file → entries dict; {} on any problem (the
    corrupt-tolerant contract every cache-dir artifact follows)."""
    try:
        with open(path) as f:
            data = json.load(f)
        entries = data.get("entries")
        if isinstance(entries, dict):
            return {
                k: v for k, v in entries.items() if isinstance(v, dict)
            }
    except (OSError, ValueError, AttributeError):
        pass
    return {}


def read_ledger(path: Optional[str] = None) -> Dict[str, dict]:
    """Merge-on-load entry point for ledger consumers (the cost model's
    training replay, tooling): the on-disk entries as written by ANY
    process — each writer merges entry-wise (newest ``ts`` wins per
    key)."""
    if path is None:
        path = cost_ledger_path()
    return _read_entries(path)


def _merge_entries(
    disk: Dict[str, dict], mine: Dict[str, dict]
) -> Dict[str, dict]:
    """Entry-wise union: unknown keys survive from either side; for a
    shared key the newer ``ts`` wins."""
    out = dict(disk)
    for k, e in mine.items():
        cur = out.get(k)
        if cur is None or float(e.get("ts") or 0) >= float(
            cur.get("ts") or 0
        ):
            out[k] = e
    return out


def _platform() -> str:
    """The current device as ``"<type>:<device tag>"`` (the card when
    there is one, else ``"cpu:cpu"``): the default platform stamped into
    ledger rows and cost-model fits."""
    from flink_jpmml_tpu_torch.compile import autotune

    return autotune.platform_key()


class KernelCostLedger:
    """Observed device cost per (model, backend) vs the analytic counts.

    Every profiler sample updates one entry (EWMA of device
    seconds/record, sample count, last batch shape, the operations and
    bytes per record); entries persist through the corrupt-tolerant
    atomic-replace JSON discipline of the autotune cache, at most once
    per ``flush_interval_s``, on a background thread: the thread that
    records a sample (the score thread) never waits on the file.
    ``flush_interval_s=0`` writes through on the caller's thread;
    ``math.inf`` writes only on :meth:`flush`. ``path`` (default: beside
    the autotune cache, resolved at each write) is the ledger file."""

    def __init__(
        self,
        path: Optional[str] = None,
        flush_interval_s: float = 5.0,
    ):
        self._path = path
        self._flush_interval = flush_interval_s
        self._mu = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self._dirty = False
        self._flusher: Optional[threading.Thread] = None

    def _flush_loop(self) -> None:
        """The background writer: one write an interval while there is
        anything to write, then the thread ends (the next update starts
        another)."""
        while True:
            time.sleep(self._flush_interval)
            self.flush()
            with self._mu:
                if not self._dirty:
                    self._flusher = None
                    return

    def update(
        self,
        model: Optional[str],
        backend: Optional[str],
        device_s: float,
        records: int,
        flops_per_record: Optional[float],
        bytes_per_record: Optional[float],
        variant: Optional[str] = None,
        features: Optional[dict] = None,
        predicted: Optional[float] = None,
        platform: Optional[str] = None,
    ) -> None:
        """Fold one measured (device_s, records) pair into the entry
        for (model, backend[, variant]).

        ``variant``/``features`` are the kernel-search extension: a
        per-variant row whose feature dict is a training sample for the
        cost model; ``predicted`` records the model's prediction at
        measurement time, so the row carries its own residual;
        ``platform`` is where it was measured (default: the current
        device)."""
        if not records or device_s <= 0:
            return
        key = f"{model or 'unknown'}|{backend or 'unknown'}"
        if variant:
            key = f"{key}|{variant}"
        per_rec = device_s / records
        with self._mu:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = {
                    "model": model, "backend": backend,
                    "device_s_per_record": per_rec, "samples": 0,
                }
            else:
                e["device_s_per_record"] = (
                    (1.0 - _EWMA_ALPHA) * e["device_s_per_record"]
                    + _EWMA_ALPHA * per_rec
                )
            e["samples"] += 1
            e["last_batch"] = int(records)
            e["last_device_s"] = round(device_s, 9)
            e["flops_per_record"] = flops_per_record
            e["bytes_per_record"] = bytes_per_record
            e["rec_s"] = round(records / device_s, 1)
            e["platform"] = platform or _platform()
            if variant:
                e["variant"] = variant
            if isinstance(features, dict) and features:
                e["features"] = dict(features)
            if predicted is not None and predicted > 0:
                e["predicted_s_per_record"] = predicted
                e["pred_err"] = round(
                    abs(per_rec - predicted) / predicted, 4
                )
            e["ts"] = time.time()
            self._dirty = True
            through = self._flush_interval <= 0
            if (not through and self._flusher is None
                    and self._flush_interval != math.inf):
                self._flusher = threading.Thread(
                    target=self._flush_loop, name="fjt-cost-ledger",
                    daemon=True)
                self._flusher.start()
        if through:
            self.flush()

    def entries(self) -> Dict[str, dict]:
        with self._mu:
            return {k: dict(v) for k, v in self._entries.items()}

    def flush(self) -> None:
        """Merge-write this process's entries into the on-disk ledger:
        the read→merge→replace runs under an exclusive ``flock`` on a
        sidecar lock file, the merge is entry-wise (newest ``ts`` wins
        per key), and the write is temp file, fsync, ``os.replace``. Any
        I/O or parse failure is silent — a read-only cache dir must not
        break serving."""
        with self._mu:
            if not self._dirty:
                return
            mine = {k: dict(v) for k, v in self._entries.items()}
            self._dirty = False
        path = self._path or cost_ledger_path()
        lock = None
        try:
            import fcntl

            os.makedirs(os.path.dirname(path), exist_ok=True)
            lock = open(f"{path}.lock", "w")
            fcntl.flock(lock, fcntl.LOCK_EX)
        except (ImportError, OSError):
            # no flock (non-posix / read-only dir): the atomic replace
            # below still guarantees readers never see a torn file
            if lock is not None:
                lock.close()
                lock = None
        from flink_jpmml_tpu_torch.utils.diskio import atomic_write_json

        try:
            merged = _merge_entries(_read_entries(path), mine)
            atomic_write_json(path, {"version": 1, "entries": merged})
        finally:
            if lock is not None:
                try:
                    lock.close()  # closing releases the flock
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# The sampled region
# ---------------------------------------------------------------------------

_MARKS = threading.local()


class SampleMarks:
    """The two ends of one sampled dispatch's region on its device:
    timing CUDA events on the card (read once the batch completed), host
    clock readings on the CPU. ``sweep_region`` is False where the region
    is not what the kernel search times for the serving variant."""

    __slots__ = ("device", "start", "stop", "sweep_region")

    def __init__(self):
        self.device = None
        self.start = None
        self.stop = None
        self.sweep_region = True

    def seconds(self) -> Optional[float]:
        """The region's time, or None when a dispatch marked no region
        (or only one end of it). On the card both events must have
        fired: call this after the batch's wait."""
        if self.start is None or self.stop is None:
            return None
        if self.device.type == "cuda":
            return self.start.elapsed_time(self.stop) / 1e3
        return self.stop - self.start


def open_sample() -> SampleMarks:
    """Start collecting marks on this thread, for the dispatch the
    dispatcher is about to run."""
    marks = _MARKS.marks = SampleMarks()
    return marks


def close_sample() -> None:
    _MARKS.marks = None


def active_sample() -> Optional[SampleMarks]:
    """The marks of the sampled dispatch running on this thread, else
    None: the one test an unsampled dispatch pays."""
    return getattr(_MARKS, "marks", None)


def _stamp(device):
    if device.type == "cuda":
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def mark_start(device) -> None:
    """Open the sampled region on ``device`` (its current stream on the
    card) when this thread runs a sampled dispatch. The first mark of a
    dispatch holds: a torch twin that marked its payload's copy keeps
    that start when its scoring stage marks again."""
    marks = getattr(_MARKS, "marks", None)
    if marks is not None and marks.start is None:
        marks.device = device
        marks.start = _stamp(device)


def mark_stop(device) -> None:
    """Close the sampled region on the device that opened it (the last
    mark holds). A mark on another device (a host tier scoring in the
    card's stead) leaves the region unclosed, so no sample is taken."""
    marks = getattr(_MARKS, "marks", None)
    if (marks is not None and marks.device is not None
            and marks.device.type == device.type):
        marks.stop = _stamp(marks.device)


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------


class DeviceProfiler:
    """Rate-limited device-time sampler feeding live roofline gauges.

    The :class:`~flink_jpmml_tpu_torch.runtime.pipeline.
    OverlappedDispatcher` consults :meth:`should_sample` a launch; a
    sampled dispatch carries a timing event pair, read when the batch
    completes and handed to :meth:`record_sample` with the launch site's
    :func:`~flink_jpmml_tpu_torch.obs.attr.dispatch_profile`."""

    def __init__(
        self,
        metrics: MetricsRegistry,
        interval_s: Optional[float] = None,
        overhead_budget: float = _OVERHEAD_BUDGET,
        clock: Callable[[], float] = time.monotonic,
        cost_ledger: Optional[KernelCostLedger] = None,
    ):
        # weak: the _PROFILERS cache keys weakly on the registry, so a
        # strong back-ref here would pin every registry for process
        # lifetime
        self._metrics_ref = weakref.ref(metrics)
        if interval_s is None:
            raw = (os.environ.get(_SAMPLE_ENV) or "").strip().lower()
            if raw in ("0", "off", "false", "no"):
                interval_s = 0.0
            else:
                try:
                    interval_s = float(raw) if raw else _DEFAULT_INTERVAL_S
                except ValueError:
                    interval_s = _DEFAULT_INTERVAL_S
        self._interval = max(0.0, float(interval_s))
        self._budget = overhead_budget
        self._clock = clock
        self._mu = threading.Lock()
        self._t0 = clock()
        self._last_sample = 0.0
        self._overhead_s = 0.0
        # EWMA of ns/record keyed per (model, backend): two models through
        # one dispatcher must not blend one model's rate with another's
        # counts
        self._ns_per_record: Dict[str, float] = {}
        self._peaks = None
        self._peaks_resolved = False
        self.cost_ledger = cost_ledger or KernelCostLedger()
        # predicted-vs-observed tracking per (model, backend): the
        # kernel_pred_error gauge registers lazily (only pipelines
        # serving a search-adopted config carry it) and the strike
        # counters drive the stale-prediction re-search trigger
        self._pred_err_ewma: Dict[str, float] = {}
        self._pred_strikes: Dict[str, int] = {}
        # prediction value that already fired per key: the trigger is
        # one-shot per prediction; a NEW prediction re-arms the band
        self._pred_fired: Dict[str, float] = {}
        self._g_pred_err = None
        self._samples = metrics.counter("device_samples")
        self._g_mfu = metrics.gauge("device_mfu")
        self._g_membw = metrics.gauge("device_membw_util")
        self._g_flops = metrics.gauge("flops_per_record")
        self._g_nsrec = metrics.gauge("device_ns_per_record")

    @property
    def enabled(self) -> bool:
        return self._interval > 0.0

    def should_sample(self) -> bool:
        """One atomic check-and-claim per launch: True at most once per
        interval AND only while accumulated sampling overhead stays
        under the budget share of wall clock. A claimed slot that never
        reaches :meth:`record_sample` wastes one interval, never
        double-samples."""
        if self._interval <= 0.0:
            return False
        now = self._clock()
        with self._mu:
            if now - self._last_sample < self._interval:
                return False
            elapsed = max(now - self._t0, 1e-9)
            if (
                self._overhead_s > 0.0
                and self._overhead_s / elapsed > self._budget
            ):
                return False
            self._last_sample = now
            return True

    def record_sample(
        self,
        device_s: float,
        profile: Optional[dict],
        overhead_s: Optional[float] = None,
    ) -> None:
        """Fold one measured (device seconds, dispatch profile) pair
        into the gauges, the sampled device-stage histogram, and the
        kernel cost ledger. ``overhead_s`` is what the sample cost the
        pipeline, charged against the rate limiter's budget (the
        dispatcher's event pairs cost it nothing: 0)."""
        profile = profile or {}
        records = int(profile.get("records") or 0)
        with self._mu:
            self._overhead_s += (
                overhead_s if overhead_s is not None else device_s
            )
        self._samples.inc()
        if device_s <= 0 or records <= 0:
            return
        per_rec = device_s / records
        key = f"{profile.get('model')}|{profile.get('backend')}"
        with self._mu:
            prev = self._ns_per_record.get(key)
            if prev is None:
                self._ns_per_record[key] = per_rec * 1e9
            else:
                self._ns_per_record[key] = (
                    (1.0 - _EWMA_ALPHA) * prev
                    + _EWMA_ALPHA * per_rec * 1e9
                )
            ns_rec = self._ns_per_record[key]
            if not self._peaks_resolved:
                self._peaks = chip_peaks(_device_kind())
                self._peaks_resolved = True
            peaks = self._peaks
        self._g_nsrec.set(ns_rec)
        # smoothed records/s of device time — THIS model's EWMA against
        # THIS model's counts, so the roofline is internally consistent
        # even when models alternate samples
        dev_rate = 1e9 / ns_rec
        flops = profile.get("flops_per_record")
        bpr = profile.get("bytes_per_record")
        mfu, membw = roofline(dev_rate, flops, bpr, peaks)
        if flops is not None:
            self._g_flops.set(float(flops))
        if mfu is not None:
            self._g_mfu.set(round(mfu, 6))
        if membw is not None:
            self._g_membw.set(round(membw, 6))
        # the sampled device column of the attribution plane
        from flink_jpmml_tpu_torch.obs import attr

        led = attr.ledger_for(self._metrics_ref())
        if led is not None:
            led.observe("device", device_s)
        self._verify_prediction(profile, per_rec)
        self.cost_ledger.update(
            profile.get("model"), profile.get("backend"),
            device_s, records, flops, bpr,
            variant=profile.get("variant"),
            features=profile.get("features"),
            predicted=profile.get("predicted_s_per_record"),
            platform=profile.get("platform"),
        )

    def _verify_prediction(self, profile: dict, per_rec: float) -> None:
        """Predict-then-verify, live: compare the sampled device cost
        against the adopted kernel config's prediction. Updates the
        ``kernel_pred_error`` gauge (relative |obs−pred| EWMA) and, on
        sustained out-of-band drift, invalidates the cost-model fit
        and clears this model's autotune entry — the next warmup
        re-searches instead of trusting the stale prediction."""
        pred = profile.get("predicted_s_per_record")
        try:
            pred = float(pred) if pred else 0.0
        except (TypeError, ValueError):
            return
        if pred <= 0 or per_rec <= 0:
            return
        key = f"{profile.get('model')}|{profile.get('backend')}"
        err = abs(per_rec - pred) / pred
        stale = False
        with self._mu:
            prev = self._pred_err_ewma.get(key)
            ewma = (
                err if prev is None
                else (1.0 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * err
            )
            self._pred_err_ewma[key] = ewma
            already_fired = self._pred_fired.get(key) == pred
            if already_fired:
                pass  # this prediction is already invalidated; only a
                # re-search (new prediction value) re-arms the trigger
            elif pred / _PRED_BAND <= per_rec <= pred * _PRED_BAND:
                self._pred_strikes[key] = max(
                    0, self._pred_strikes.get(key, 0) - 1
                )
                self._pred_fired.pop(key, None)
            else:
                strikes = self._pred_strikes.get(key, 0) + 1
                stale = strikes >= _PRED_STRIKES
                self._pred_strikes[key] = 0 if stale else strikes
                if stale:
                    self._pred_fired[key] = pred
            if self._g_pred_err is None:
                reg = self._metrics_ref()
                if reg is not None:
                    self._g_pred_err = reg.gauge("kernel_pred_error")
        if self._g_pred_err is not None:
            self._g_pred_err.set(round(ewma, 4))
        if not stale:
            return
        from flink_jpmml_tpu_torch.obs import recorder as flight

        flight.record(
            "kernel_search_stale",
            model=profile.get("model"),
            backend=profile.get("backend"),
            predicted_s_per_record=pred,
            observed_s_per_record=round(per_rec, 12),
        )
        from flink_jpmml_tpu_torch.compile import autotune, costmodel

        costmodel.mark_stale(f"drift band: {key}")
        # the cache keys on model_hash; profile["model"] may be the
        # serving registry name (BoundScorer.key) and would clear nothing
        model = profile.get("model_hash") or profile.get("model")
        if model:
            autotune.clear(str(model))


# one profiler per registry (cf. attr.ledger_for); a shared process-wide
# cost ledger so every pipeline's samples land in one file
_COST_LEDGER = KernelCostLedger()
_PROFILERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PROFILERS_MU = threading.Lock()


def profiler_for(
    metrics: Optional[MetricsRegistry],
) -> Optional[DeviceProfiler]:
    if metrics is None:
        return None
    prof = _PROFILERS.get(metrics)
    if prof is None:
        with _PROFILERS_MU:
            prof = _PROFILERS.get(metrics)
            if prof is None:
                prof = _PROFILERS[metrics] = DeviceProfiler(
                    metrics, cost_ledger=_COST_LEDGER
                )
    return prof
