"""Overload resilience: deadline-aware adaptive batching + admission
control with priority-lane load shedding.

The port's copy of ``flink_jpmml_tpu/serving/overload.py``, with the
import lines renamed and its notes on the project's history cut. One
real change: the capacity model persists in the port's own cache
directory, one file per device (``utils/cache.py``:
``~/.cache/flink_jpmml_tpu_torch/capacity_model-<device>.json``), never
beside the JAX package's autotune cache, so a ``c0 + c1·n`` fitted on
the CPU or another card is never read on this one. ``AdaptiveBatcher``
takes ``device=`` to name that device (None: the current card if there
is one, else the CPU). The callers feed it the same observations as in
the JAX package: the block pipelines' completion latency, which on the
card is taken after the CUDA event wait, so ``c1`` is the card's
per-record cost and not only the launch's.

Past capacity a pipeline should degrade by explicit, bounded decisions,
not by unbounded lag. This module is the reflex arc:

:class:`AdaptiveBatcher`
    A live capacity model per (model, backend): per-dispatch latency is
    modelled as ``latency(n) ≈ c0 + c1·n`` (fixed dispatch overhead +
    marginal per-record cost), fitted from the same observations the
    stage/latency histograms see, and used *predict-then-verify*:
    the model predicts the largest dispatch size whose latency fits
    inside ``target_frac × deadline`` (``FJT_SLO_TARGET_MS``), live
    observations verify the prediction, and sustained drift triggers a
    re-estimate. The fitted model persists in the port's cache
    directory (one file per device) so a restarted worker predicts
    before its first observation. Callers: the block pipelines cap
    opportunistic multi-chunk aggregation with :meth:`max_records`
    (deadline-aware batching with no recompile); :meth:`propose` picks
    a compiled batch size from calibration timings.

:class:`AdmissionController`
    Priority lanes + hysteresis shedding, the controller pattern
    (piggybacked ``maybe_tick``, injectable clock, every decision a
    flight event). The input is the composite ``pressure`` score —
    which saturates BEFORE p99 blows through the deadline, so shedding
    starts before the SLO breaches. Lanes are ordered lowest priority
    first; the shed level rises one lane at a time only when pressure
    holds ≥ ``on_threshold`` for a full ``dwell_s``, and recovers one
    lane at a time only when it holds ≤ ``off_threshold`` as long — the
    hysteresis band + dwell keep a sawtooth load from flapping the
    gate. Every admit/shed lands in ``admitted_records`` /
    ``shed_records{lane="..."}`` counters (fleet merge: sum — a scrape
    reports true aggregate degradation) and the ``shed_level`` gauge
    (fleet merge: worst-of); level transitions record
    ``shed_level_change`` flight events and sheds themselves a
    rate-limited ``load_shed`` event.

Wiring: ``BlockPipelineBase(batcher=, admission=)`` sheds whole drained
batches as no-op FIFO window entries (offsets still commit in order,
the sink never sees a shed record) and caps aggregation;
``DynamicScorer(admission=, lane_fn=)`` sheds per event before routing
(shed events emit ``Prediction.empty()`` and are never dispatched,
mirrored, or shadow-diffed); ``chip_smoke.py``'s ``serving_edge``
phase drills the whole loop against offered load at 80% and 150% of
the card's measured capacity.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
from flink_jpmml_tpu_torch.utils.retry import env_float

_TARGET_ENV = "FJT_SLO_TARGET_MS"
_SHED_ON_ENV = "FJT_SHED_ON"
_SHED_OFF_ENV = "FJT_SHED_OFF"
_SHED_DWELL_ENV = "FJT_SHED_DWELL_S"

_DEFAULT_ON = 0.85
_DEFAULT_OFF = 0.55
_DEFAULT_DWELL_S = 0.5
_EWMA_ALPHA = 0.3
_DRIFT_BAND = 1.75  # observed/predicted outside [1/band, band] = drift
_DRIFT_STRIKES = 3
_SHED_EVENT_MIN_PERIOD_S = 1.0


def _env_deadline_s() -> Optional[float]:
    try:
        ms = float(os.environ.get(_TARGET_ENV) or 0.0)
    except ValueError:
        ms = 0.0
    return ms / 1000.0 if ms > 0 else None


def capacity_model_path(device=None) -> str:
    """``capacity_model-<device>.json`` in the port's cache directory
    (``utils/cache.py``): a capacity fit belongs to the device it was
    measured on."""
    from flink_jpmml_tpu_torch.utils import cache

    return cache.device_cache_path("capacity_model", device)


class AdaptiveBatcher:
    """Deadline-aware dispatch sizing from a live ``c0 + c1·n``
    capacity model per (model, backend).

    ``observe(records, latency_s)`` feeds per-dispatch completions
    (EWMA per distinct size, refit across sizes);
    :meth:`max_records` → the largest dispatch size predicted to fit
    inside ``target_frac × deadline`` (None while no deadline is
    configured or nothing is fitted — callers keep their defaults);
    :meth:`propose` picks from explicit candidates (a
    compiled-batch chooser). The fitted model persists (atomic replace,
    corrupt-tolerant, rate-limited) in ``path``, by default
    :func:`capacity_model_path` of ``device``, and seeds a fresh
    process — predict first, let live observations verify."""

    def __init__(
        self,
        metrics: Optional[MetricsRegistry] = None,
        deadline_s: Optional[float] = None,
        target_frac: float = 0.8,
        min_records: int = 64,
        max_records: Optional[int] = None,
        model: Optional[str] = None,
        backend: Optional[str] = None,
        path: Optional[str] = None,
        flush_interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        device=None,
    ):
        self._device = device
        self.deadline_s = (
            deadline_s if deadline_s is not None else _env_deadline_s()
        )
        self.target_frac = float(target_frac)
        self.min_records = max(1, int(min_records))
        self.max_records_bound = (
            int(max_records) if max_records is not None else None
        )
        self._key = f"{model or 'unknown'}|{backend or 'unknown'}"
        self._path = path
        self._flush_interval = flush_interval_s
        self._clock = clock
        self._mu = threading.Lock()
        # size -> [ewma latency_s, count]
        self._obs: Dict[int, list] = {}
        self._c0: Optional[float] = None
        self._c1: Optional[float] = None
        # device-OOM ceiling (runtime/devfault.py ladder): a proven-
        # fitting dispatch size after an allocator refusal; applies
        # even with no deadline configured — memory is a hard wall,
        # the deadline is a soft one
        self._oom_cap: Optional[int] = None
        self._fitted_from = 0  # distinct sizes behind the current fit
        self._samples = 0
        self._drift_strikes = 0
        self._dirty = False
        self._last_flush = 0.0
        # gauge registered LAZILY at the first real cap: registering at
        # construction would pin 0.0 into the registry, and the fleet
        # MIN merge would let one deadline-less worker mask every real
        # worker's cap with a permanent zero
        self._metrics = metrics
        self._gauge = None
        # capacity_rec_s = 1/c1: the fitted sustainable record rate —
        # the capacity half of the headroom telemetry. Same lazy
        # discipline as the cap gauge: no fit, no gauge.
        self._cap_gauge = None
        self._load()
        with self._mu:
            self._publish_capacity_locked()

    # -- the model -----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.deadline_s is not None

    @property
    def fitted(self) -> bool:
        with self._mu:
            return self._c1 is not None

    def coefficients(self) -> Optional[Tuple[float, float]]:
        with self._mu:
            if self._c1 is None:
                return None
            return (self._c0 or 0.0), self._c1

    def observe(self, records: int, latency_s: float) -> None:
        """One completed dispatch of ``records`` records that took
        ``latency_s`` end to end. Verifies the standing prediction and
        re-estimates on sustained drift."""
        if records <= 0 or latency_s <= 0:
            return
        n = int(records)
        due = False
        with self._mu:
            e = self._obs.get(n)
            if e is None:
                self._obs[n] = [float(latency_s), 1]
            else:
                e[0] = (1.0 - _EWMA_ALPHA) * e[0] + _EWMA_ALPHA * latency_s
                e[1] += 1
            self._samples += 1
            refit = False
            if self._c1 is None or len(self._obs) > self._fitted_from:
                refit = True  # nothing standing / a new size landed
            else:
                pred = (self._c0 or 0.0) + self._c1 * n
                if pred > 0 and not (
                    pred / _DRIFT_BAND <= latency_s <= pred * _DRIFT_BAND
                ):
                    self._drift_strikes += 1
                    if self._drift_strikes >= _DRIFT_STRIKES:
                        refit = True
                else:
                    self._drift_strikes = max(0, self._drift_strikes - 1)
            if refit:
                drifted = (
                    self._c1 is not None
                    and self._drift_strikes >= _DRIFT_STRIKES
                )
                self._refit_locked()
                self._publish_capacity_locked()
                self._drift_strikes = 0
                self._dirty = True
                if drifted:
                    flight.record(
                        "capacity_reestimated",
                        key=self._key,
                        c0_ms=round(1e3 * (self._c0 or 0.0), 4),
                        c1_us_per_rec=round(1e6 * (self._c1 or 0.0), 4),
                    )
            now = self._clock()
            if self._dirty and now - self._last_flush >= self._flush_interval:
                self._last_flush = now
                due = True
        if due:
            self.flush()

    def _refit_locked(self) -> None:
        """Least squares over the per-size EWMAs. One size pins only
        the marginal cost (line through the origin — conservative until
        a second size separates the fixed overhead)."""
        pts = [(n, e[0]) for n, e in self._obs.items() if e[1] >= 1]
        if not pts:
            return
        if len(pts) == 1:
            n0, l0 = pts[0]
            self._c0, self._c1 = 0.0, l0 / n0
        else:
            xs = [float(n) for n, _ in pts]
            ys = [l for _, l in pts]
            k = len(pts)
            mx = sum(xs) / k
            my = sum(ys) / k
            sxx = sum((x - mx) ** 2 for x in xs)
            if sxx <= 0:
                self._c0, self._c1 = 0.0, my / mx
            else:
                c1 = sum(
                    (x - mx) * (y - my) for x, y in zip(xs, ys)
                ) / sxx
                # a non-increasing fit (noise at small sample counts)
                # degrades to the origin model rather than predicting
                # free records
                if c1 <= 0:
                    self._c0, self._c1 = 0.0, my / mx
                else:
                    self._c0 = max(0.0, my - c1 * mx)
                    self._c1 = c1
        self._fitted_from = len(self._obs)

    def _publish_capacity_locked(self) -> None:
        if self._metrics is None or not self._c1 or self._c1 <= 0:
            return
        if self._cap_gauge is None:
            self._cap_gauge = self._metrics.gauge("capacity_rec_s")
        self._cap_gauge.set(1.0 / self._c1)

    def predicted_latency(self, records: int) -> Optional[float]:
        with self._mu:
            if self._c1 is None:
                return None
            return (self._c0 or 0.0) + self._c1 * int(records)

    def note_oom_cap(self, records: int) -> int:
        """Device-OOM feedback from the recovery ladder
        (``runtime/block.py _oom_recover``): ``records`` is the largest
        dispatch size the bisection PROVED fits device memory. The cap
        only ever shrinks (min-of) and outlives the deadline logic —
        an OOM wall binds throughput mode too. → the effective cap."""
        cap = max(self.min_records, int(records))
        with self._mu:
            if self._oom_cap is not None:
                cap = min(cap, self._oom_cap)
            self._oom_cap = cap
        flight.record(
            "oom_batch_cap", key=self._key, max_records=cap,
        )
        return cap

    def max_records(self) -> Optional[int]:
        """Largest dispatch size predicted to finish inside
        ``target_frac × deadline``, clamped by any device-OOM ceiling
        (:meth:`note_oom_cap`); None when neither constrains (callers
        keep their own defaults)."""
        n: Optional[int] = None
        if self.deadline_s is not None:
            with self._mu:
                if self._c1 is not None and self._c1 > 0:
                    budget = (
                        self.target_frac * self.deadline_s
                        - (self._c0 or 0.0)
                    )
                    n = int(budget / self._c1) if budget > 0 else 0
            if n is not None:
                n = max(self.min_records, n)
        oom = self._oom_cap
        if oom is not None:
            n = oom if n is None else min(n, oom)
        if n is None:
            return None
        if self.max_records_bound is not None:
            n = min(n, self.max_records_bound)
        if self._metrics is not None:
            if self._gauge is None:
                self._gauge = self._metrics.gauge("adaptive_batch")
            self._gauge.set(float(n))
        return n

    def propose(self, candidates: Sequence[int]) -> int:
        """Pick the largest candidate whose predicted latency fits the
        deadline budget (throughput wants big batches; the deadline
        caps them). With no cap available → the largest candidate."""
        cs = sorted(int(c) for c in candidates)
        if not cs:
            raise ValueError("propose() needs at least one candidate")
        cap = self.max_records()
        if cap is None:
            return cs[-1]
        fitting = [c for c in cs if c <= cap]
        return fitting[-1] if fitting else cs[0]

    # -- persistence (atomic replace, corrupt-tolerant) ----------------------

    def _resolve_path(self) -> Optional[str]:
        if self._path is None:
            try:
                self._path = capacity_model_path(self._device)
            except Exception:
                return None
        return self._path

    def _load(self) -> None:
        path = self._resolve_path()
        if path is None:
            return
        try:
            with open(path) as f:
                data = json.load(f)
            e = data["entries"][self._key]
            c0, c1 = float(e["c0"]), float(e["c1"])
        except (OSError, ValueError, KeyError, TypeError):
            return  # absent/corrupt: predict nothing, observe first
        if c1 > 0 and c0 >= 0:
            with self._mu:
                self._c0, self._c1 = c0, c1

    def flush(self) -> None:
        """Merge-write this batcher's fit into the on-disk model
        (atomic replace; failures silent — a read-only cache dir must
        not break serving)."""
        path = self._resolve_path()
        if path is None:
            return
        with self._mu:
            if not self._dirty or self._c1 is None:
                return
            mine = {
                self._key: {
                    "c0": self._c0 or 0.0,
                    "c1": self._c1,
                    "samples": self._samples,
                    "deadline_ms": (
                        round(1e3 * self.deadline_s, 3)
                        if self.deadline_s is not None else None
                    ),
                    "ts": time.time(),
                }
            }
            self._dirty = False
        disk: Dict[str, dict] = {}
        try:
            with open(path) as f:
                data = json.load(f)
            if isinstance(data.get("entries"), dict):
                disk = data["entries"]
        except (OSError, ValueError, AttributeError):
            disk = {}
        disk.update(mine)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump({"version": 1, "entries": disk}, f)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def state(self) -> dict:
        with self._mu:
            return {
                "key": self._key,
                "c0_ms": (
                    round(1e3 * self._c0, 4) if self._c0 is not None
                    else None
                ),
                "c1_us_per_rec": (
                    round(1e6 * self._c1, 4) if self._c1 is not None
                    else None
                ),
                "samples": self._samples,
                "sizes": {str(n): e[1] for n, e in self._obs.items()},
                "deadline_ms": (
                    round(1e3 * self.deadline_s, 3)
                    if self.deadline_s is not None else None
                ),
            }


class AdmissionController:
    """Priority-lane admission with hysteresis load shedding.

    ``lanes`` is ordered LOWEST priority first — the shed level is the
    length of the lane prefix currently refused. Pressure ≥
    ``on_threshold`` held a full ``dwell_s`` raises the level one lane;
    pressure ≤ ``off_threshold`` held as long lowers it one — the band
    between the thresholds plus the dwell is the anti-flap hysteresis.
    ``pressure_fn`` defaults to the registry's live ``pressure`` gauge
    (the composite, which saturates before p99 breaches — shed
    early, before the SLO does). ``admit(lane, n)`` is the hot-path
    verdict: False = shed, with the counters booked either way."""

    def __init__(
        self,
        metrics: MetricsRegistry,
        lanes: Sequence[str] = ("low", "normal", "high"),
        on_threshold: Optional[float] = None,
        off_threshold: Optional[float] = None,
        dwell_s: Optional[float] = None,
        interval_s: float = 0.1,
        pressure_fn: Optional[Callable[[], float]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        lanes = tuple(lanes)
        if not lanes or len(set(lanes)) != len(lanes):
            raise ValueError(f"bad lane set {lanes!r}")
        self.lanes = lanes
        self._lane_index = {lane: i for i, lane in enumerate(lanes)}
        self.on_threshold = (
            on_threshold if on_threshold is not None
            else env_float(_SHED_ON_ENV, _DEFAULT_ON)
        )
        self.off_threshold = (
            off_threshold if off_threshold is not None
            else env_float(_SHED_OFF_ENV, _DEFAULT_OFF)
        )
        if self.off_threshold >= self.on_threshold:
            raise ValueError(
                f"hysteresis band inverted: off {self.off_threshold} >= "
                f"on {self.on_threshold}"
            )
        self.dwell_s = (
            dwell_s if dwell_s is not None
            else env_float(_SHED_DWELL_ENV, _DEFAULT_DWELL_S)
        )
        self._interval = interval_s
        self._clock = clock
        self.metrics = metrics
        g = metrics.gauge("pressure")
        self._pressure_fn = (
            pressure_fn if pressure_fn is not None else g.get
        )
        self.enabled = True
        self._mu = threading.Lock()
        self._level = 0
        # (direction, held-since) of the current streak past a threshold
        self._streak: Optional[Tuple[str, float]] = None
        self._last_tick = 0.0
        self._last_shed_event = 0.0
        self._gauge = metrics.gauge("shed_level")
        self._admitted = metrics.counter("admitted_records")
        self._shed_counters: Dict[str, object] = {}

    def _shed_counter(self, lane: str):
        c = self._shed_counters.get(lane)
        if c is None:
            # the insert happens under the controller lock so counts() can
            # snapshot the dict without racing a first-shed insertion
            c = self.metrics.counter(f'shed_records{{lane="{lane}"}}')
            with self._mu:
                self._shed_counters.setdefault(lane, c)
                c = self._shed_counters[lane]
        return c

    # -- the gate ------------------------------------------------------------

    @property
    def shed_level(self) -> int:
        return self._level

    @property
    def shedding(self) -> bool:
        return self._level > 0

    def shed_lanes(self) -> Tuple[str, ...]:
        """The lane prefix currently refused (lowest priority first) —
        shedding is lane-ordered by construction."""
        return self.lanes[: self._level]

    def admit(self, lane: str = "normal", n: int = 1) -> bool:
        """The per-decision verdict. Unknown lanes are never shed (the
        safe default for a mislabelled record) but count as admitted."""
        level = self._level
        if self.enabled and level:
            idx = self._lane_index.get(lane)
            if idx is not None and idx < level:
                self._shed_counter(lane).inc(n)
                now = self._clock()
                due = False
                with self._mu:
                    if now - self._last_shed_event >= _SHED_EVENT_MIN_PERIOD_S:
                        self._last_shed_event = now
                        due = True
                if due:  # rate-limited: sheds come in floods by nature
                    flight.record(
                        "load_shed", lane=lane, records=n, level=level,
                    )
                return False
        self._admitted.inc(n)
        return True

    # -- the controller (the piggyback pattern) ------------------------------

    def maybe_tick(self) -> Optional[dict]:
        now = self._clock()
        with self._mu:
            if now - self._last_tick < self._interval:
                return None
            self._last_tick = now
        return self.tick(now)

    def tick(self, now: Optional[float] = None) -> dict:
        now = self._clock() if now is None else now
        try:
            p = float(self._pressure_fn())
        except (TypeError, ValueError):
            p = 0.0
        transition = None
        with self._mu:
            self._last_tick = now
            direction = None
            if p >= self.on_threshold and self._level < len(self.lanes):
                direction = "up"
            elif p <= self.off_threshold and self._level > 0:
                direction = "down"
            if direction is None:
                # inside the band (or already railed): any streak dies —
                # a sawtooth crossing back resets the dwell clock, which
                # is exactly what keeps the gate from flapping
                self._streak = None
            elif self._streak is None or self._streak[0] != direction:
                self._streak = (direction, now)
            elif now - self._streak[1] >= self.dwell_s:
                # one lane per dwell period, in priority order
                self._level += 1 if direction == "up" else -1
                self._streak = (direction, now)
                transition = direction
            level = self._level
        self._gauge.set(float(level))
        if transition is not None:
            boundary = (
                self.lanes[level - 1] if transition == "up"
                else self.lanes[level]
            )
            flight.record(
                "shed_level_change",
                direction=transition,
                level=level,
                lane=boundary,
                pressure=round(p, 4),
            )
        return {"pressure": p, "level": level, "transition": transition}

    def counts(self) -> dict:
        """→ {"admitted": N, "shed": {lane: N}} — the drill/test view."""
        with self._mu:  # a first-shed insert races a live reader
            shed_counters = dict(self._shed_counters)
        return {
            "admitted": self._admitted.get(),
            "shed": {lane: c.get() for lane, c in shed_counters.items()},
        }


def summary(struct: dict) -> Optional[dict]:
    """Overload-plane summary from a metrics struct (chip_smoke's
    ``serving_edge`` line): shed level/lanes, admitted vs shed
    counts, the adaptive batch choice, and p99-vs-deadline when both a
    latency histogram and a deadline gauge are present. None when the
    struct carries no overload telemetry at all."""
    from flink_jpmml_tpu_torch.utils.metrics import Histogram

    gauges = struct.get("gauges") or {}
    counters = struct.get("counters") or {}

    def g(name):
        v = gauges.get(name)
        return v.get("value") if isinstance(v, dict) else None

    shed: Dict[str, float] = {}
    import re

    for name, v in counters.items():
        m = re.match(r'^shed_records\{lane="([^"]+)"\}$', name)
        if m:
            shed[m.group(1)] = v
    out: dict = {}
    level = g("shed_level")
    admitted = counters.get("admitted_records")
    if level is not None or admitted is not None or shed:
        out["shed_level"] = level
        out["admitted_records"] = admitted
        out["shed_records"] = shed
    batch = g("adaptive_batch")
    if batch:  # 0 = never capped (or a merged deadline-less worker)
        out["adaptive_batch"] = batch
    deadline_ms = g("slo_deadline_ms")
    if deadline_ms:
        out["deadline_ms"] = deadline_ms
        for source in ("score_latency_s", "batch_latency_s"):
            state = (struct.get("histograms") or {}).get(source)
            if not isinstance(state, dict):
                continue
            try:
                h = Histogram.from_state(state)
            except (KeyError, TypeError, ValueError):
                continue
            p99 = h.quantile(0.99)
            if p99 is not None:
                out["p99_ms"] = round(1e3 * p99, 3)
                out["p99_vs_deadline_ratio"] = round(
                    1e3 * p99 / deadline_ms, 3
                )
                out["latency_source"] = source
                break
    return out or None
