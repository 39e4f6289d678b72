"""Event-time freshness plane: watermarks, staleness, lag forecasting.

The port's copy of ``flink_jpmml_tpu/obs/freshness.py``, with the import
lines renamed and its notes on the project's history cut. The JAX
package's ``FJT_LAG_WINDOW_S`` / ``FJT_LAG_STALE_S`` overrides are left
out: the forecaster's window and staleness limit are its arguments, by
default the JAX package's 10 s and 30 s.

Everything the pipeline knew about time before this module was
*processing* time: the ``kafka_lag`` gauges are point-in-time offset
deltas sampled at fetch, and the stage ledger attributes wall time
but says nothing about how *stale* the records being scored are or
whether the pipeline is falling behind its producers. This module is
the reference system's Flink-style event-time discipline made concrete:

- **Watermarks** (:class:`FreshnessTracker`): sources stamp batches
  with min/max *event* time (the Kafka record-batch header's
  first/max timestamp — ``runtime/kafka.py``; or an ``event_time_fn``
  over record objects — ``runtime/sources.py``). Per-partition
  watermarks advance monotonically (out-of-order event times within a
  batch can never regress one), the pipeline low-watermark is the MIN
  across partitions, and every stage boundary propagates it through
  :meth:`FreshnessTracker.advance_stage` — also monotone, pinned by
  property tests. Gauges: ``watermark_lag_s{partition="*"}`` (now −
  partition watermark; fleet merge worst-of, like the ratio
  gauges) and ``watermark_ts`` (the pipeline low-watermark as unix
  seconds; fleet merge MIN-of-workers — fleet freshness is the
  slowest worker, never an average — the same merge-exactly
  discipline as DrJAX's map/reduce framing).

- **Staleness**: the sink books ``record_staleness_s`` — a mergeable
  fixed-bucket histogram (the latency wire form) of now − event-time at the
  moment scores reach the sink, observed twice per batch (the batch's
  freshest and stalest record bound the distribution at two
  observations/batch instead of per-record cost). Event times ride an
  offset-keyed stamp channel (:meth:`stamp_ingest` →
  :meth:`observe_sink`) so ring re-chunking between ingest and sink
  cannot detach a batch from its event times.

- **Lag & drain forecasting** (:class:`LagForecaster`): a sliding
  window (``window_s``) over per-partition (produced_rate −
  consumed_rate) emits ``lag_drain_eta_s`` (seconds until the backlog
  drains at current rates; 0 when no lag), ``lag_trend`` (net
  backlog growth in rec/s — positive means falling behind) and
  ``lag_diverging`` (0/1: consumption is NOT outpacing production
  while lag exists — the unbounded-ETA case gets its own boolean so
  the worst-of fleet merge can never hide a diverging worker behind a
  neighbour's finite ETA), plus a rate-limited ``lag_divergence``
  flight event. It also closes the ``kafka_lag`` staleness hole:
  a stalled partition's gauge froze at its last value forever; now
  every observation is age-stamped, ``kafka_lag_age_s{partition=*}``
  says how old each lag reading is, and the first crossing of
  ``stale_s`` records a ``kafka_lag_stale`` flight event.

All series land in the caller's ordinary
:class:`~flink_jpmml_tpu_torch.utils.metrics.MetricsRegistry`, so heartbeat
piggyback, ``merge_structs`` and the ``/metrics`` exposition carry them
with no new wire format; the worst-of / min-of merge rules live in
``utils/metrics.py`` next to the other gauge rules.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Dict, Optional, Tuple

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

_DEFAULT_STALE_S = 30.0
_DEFAULT_WINDOW_S = 10.0
# stamp-channel bound: ~4096 pending ingest→sink batches is minutes of
# backlog at any realistic batch size; beyond it the OLDEST stamps drop
# (staleness under-counts, watermarks stay correct) rather than growing
# without bound on a sink that wedged
_MAX_STAMPS = 4096
_DIVERGENCE_MIN_PERIOD_S = 5.0
_REFRESH_MIN_PERIOD_S = 0.5


class FreshnessTracker:
    """Event-time watermark + staleness state for one registry.

    One tracker per registry (see :func:`freshness_for`) — the source
    (ingest thread) stamps, the score thread observes the sink, the
    same instance serves both, all methods thread-safe. Event times
    are unix seconds (``time.time`` domain); a ``max_ts <= 0`` stamp
    means "no event time" and is ignored everywhere (the Kafka native
    encoder's timestamp-0 batches never fake a 1970 staleness).
    """

    def __init__(self, metrics: MetricsRegistry):
        # weak, like StageLedger: the freshness_for cache key must not
        # be pinned by its own cached value
        self._metrics_ref = weakref.ref(metrics)
        self._mu = threading.Lock()
        self._part_wm: Dict[str, float] = {}  # partition -> max event ts
        self._part_gauges: Dict[str, object] = {}
        self._stage_wm: Dict[str, float] = {}
        self._stage_gauges: Dict[str, object] = {}
        # offset-keyed event-time channel: [first, end, min_ts, max_ts]
        self._stamps: "collections.deque" = collections.deque()
        self._stamps_dropped = 0
        self._last_refresh = 0.0
        self._staleness = metrics.histogram("record_staleness_s")
        # registered LAZILY on the first real watermark: an eager gauge
        # at 0.0 would pin the fleet MIN merge (min-of-workers is the
        # whole point of watermark_ts) at zero for every idle worker
        self._wm_gauge = None
        # scrape-side aging (see MetricsRegistry.add_scrape_hook): a
        # stalled pipeline stops calling observe_source/observe_sink,
        # which would freeze watermark_lag_s at its last fresh-looking
        # value — the scrape itself keeps the lag gauges honest
        metrics.add_scrape_hook(self.refresh)

    def refresh(self) -> None:
        """Re-derive the lag gauges from the wall clock (rate-limited);
        ticked from every struct_snapshot via the scrape hook."""
        self._maybe_refresh(time.time())

    def _set_wm_gauge(self, value: float) -> None:
        g = self._wm_gauge
        if g is None:
            reg = self._metrics_ref()
            if reg is None:
                return
            g = self._wm_gauge = reg.gauge("watermark_ts")
        g.set(value)

    # -- source side ---------------------------------------------------------

    def observe_source(
        self,
        partition,
        min_ts: float,
        max_ts: float,
        now: Optional[float] = None,
    ) -> None:
        """A source batch carried event times [min_ts, max_ts] for
        ``partition``: advance that partition's watermark (monotone —
        out-of-order event times never regress it) and refresh its
        ``watermark_lag_s`` gauge."""
        if max_ts is None or max_ts <= 0:
            return
        part = str(partition)
        now = time.time() if now is None else now
        with self._mu:
            wm = max(self._part_wm.get(part, 0.0), float(max_ts))
            self._part_wm[part] = wm
            g = self._part_gauges.get(part)
            if g is None:
                reg = self._metrics_ref()
                if reg is None:
                    return
                g = reg.gauge(f'watermark_lag_s{{partition="{part}"}}')
                self._part_gauges[part] = g
        g.set(max(now - wm, 0.0))

    def low_watermark(self) -> Optional[float]:
        """The pipeline low-watermark: MIN across partition watermarks
        (None until any partition observed an event time). This is the
        value stage boundaries propagate and the fleet merge MINs."""
        with self._mu:
            if not self._part_wm:
                return None
            return min(self._part_wm.values())

    # -- stage propagation ---------------------------------------------------

    def advance_stage(self, stage: str, watermark: Optional[float]):
        """Propagate a low-watermark across a stage boundary; → the
        stage's effective watermark. MONOTONE: a regressing input (an
        out-of-order batch, a replayed chunk) leaves the stage
        watermark where it was — the pinned never-regress property."""
        with self._mu:
            have = self._stage_wm.get(stage)
            if watermark is not None and watermark > 0:
                have = watermark if have is None else max(have, watermark)
                self._stage_wm[stage] = have
            return have

    def stage_watermark(self, stage: str) -> Optional[float]:
        with self._mu:
            return self._stage_wm.get(stage)

    def propagate_low_watermark(
        self,
        stage: str,
        first_off: Optional[int] = None,
        n: int = 0,
    ) -> Optional[float]:
        """Hot-path stage-boundary propagation: advance ``stage`` under
        ONE lock acquisition (vs. ``low_watermark()`` +
        ``advance_stage()``) and keep the stage's
        ``watermark_stage_ts{stage=*}`` gauge current — fleet merge
        takes the MIN, like ``watermark_ts``, so the fleet's per-stage
        freshness is its slowest worker.

        When ``first_off``/``n`` name the record offsets actually
        crossing the boundary, the watermark is the event-time high
        bound of THEIR ingest stamps (peeked, not consumed — the sink
        still owns the channel), capped by the source low-watermark,
        like the sink. Without offsets — or when the stamps have
        already been consumed — it falls back to the source
        low-watermark alone. The distinction matters under
        backpressure: a deep ring holds minutes of fetched-but-
        undispatched records, and the fetch-time watermark would read
        fresh while the batch crossing ring→device is old — precisely
        the staleness this gauge exists to surface. Partition
        watermarks are monotone, so the gauge writes only when the
        stage actually advances."""
        g = None
        with self._mu:
            if not self._part_wm:
                return self._stage_wm.get(stage)
            wm = None
            if first_off is not None and n > 0:
                end = int(first_off) + int(n)
                # dispatch runs just ahead of the sink's consumption,
                # so this scans at most the in-flight window's stamps
                for entry in self._stamps:
                    if entry[0] >= end:
                        break
                    if entry[1] > first_off:  # overlaps the batch
                        wm = (
                            entry[3] if wm is None
                            else max(wm, entry[3])
                        )
            low = min(self._part_wm.values())
            wm = low if wm is None else min(wm, low)
            have = self._stage_wm.get(stage)
            if have is not None and wm <= have:
                return have
            self._stage_wm[stage] = wm
            g = self._stage_gauges.get(stage)
            if g is None:
                reg = self._metrics_ref()
                if reg is not None:
                    g = self._stage_gauges[stage] = reg.gauge(
                        f'watermark_stage_ts{{stage="{stage}"}}'
                    )
        if g is not None:
            g.set(wm)
        return wm

    # -- ingest→sink stamp channel -------------------------------------------

    def stamp_ingest(
        self, first_off: int, n: int, min_ts: float, max_ts: float
    ) -> None:
        """Record the event-time range of ``n`` records ingested at
        offsets [first_off, first_off+n) — consumed again (in offset
        order) by :meth:`observe_sink` when those records' scores land."""
        if n <= 0 or max_ts is None or max_ts <= 0:
            return
        with self._mu:
            self._stamps.append(
                [int(first_off), int(first_off) + int(n),
                 float(min_ts), float(max_ts)]
            )
            self.advance_stage_locked("source", float(max_ts))
            while len(self._stamps) > _MAX_STAMPS:
                self._stamps.popleft()
                self._stamps_dropped += 1

    def advance_stage_locked(self, stage: str, watermark: float) -> None:
        # caller holds self._mu
        have = self._stage_wm.get(stage)
        self._stage_wm[stage] = (
            watermark if have is None else max(have, watermark)
        )

    def observe_sink(
        self, first_off: int, n: int, now: Optional[float] = None
    ) -> None:
        """Scores for offsets [first_off, first_off+n) reached the sink:
        book ``record_staleness_s`` from the consumed stamps (two
        observations per stamp — the batch's stalest and freshest
        record bound the distribution) and advance the sink-stage
        watermark + the ``watermark_ts`` gauge. The sink watermark is
        capped by the SOURCE low-watermark (min across partition
        watermarks): "everything up to watermark_ts has been scored" is
        only claimable up to the slowest partition's event time — a
        stalled partition's unscored old records must hold the
        watermark back, exactly the straggler the fleet MIN merge
        exists to surface."""
        if n <= 0:
            return
        end = int(first_off) + int(n)
        now = time.time() if now is None else now
        consumed: list = []
        with self._mu:
            while self._stamps and self._stamps[0][0] < end:
                entry = self._stamps[0]
                if entry[1] <= end:
                    consumed.append(self._stamps.popleft())
                else:
                    # the drain re-chunked mid-stamp: consume the covered
                    # prefix (same ts range — batch granularity), keep
                    # the remainder for the next sink batch
                    consumed.append([entry[0], end, entry[2], entry[3]])
                    entry[0] = end
                    break
            if consumed:
                wm = max(e[3] for e in consumed)
                if self._part_wm:
                    wm = min(wm, min(self._part_wm.values()))
                self.advance_stage_locked("sink", wm)
                sink_wm = self._stage_wm["sink"]
            else:
                sink_wm = self._stage_wm.get("sink")
        for _, _, min_ts, max_ts in consumed:
            self._staleness.observe(max(now - min_ts, 0.0))  # stalest
            self._staleness.observe(max(now - max_ts, 0.0))  # freshest
        if sink_wm is not None:
            self._set_wm_gauge(sink_wm)
        self._maybe_refresh(now)

    def observe_batch(
        self,
        min_ts: float,
        max_ts: float,
        now: Optional[float] = None,
        partition="0",
    ) -> None:
        """Offsetless one-shot for micro-batch paths (the dynamic
        scorer): source-observe + sink-book in one call — the batch
        completes synchronously from the caller's point of view."""
        if max_ts is None or max_ts <= 0:
            return
        now = time.time() if now is None else now
        self.observe_source(partition, min_ts, max_ts, now=now)
        with self._mu:
            # capped by the partition low-watermark, like observe_sink
            wm = min(float(max_ts), min(self._part_wm.values()))
            self.advance_stage_locked("sink", wm)
            sink_wm = self._stage_wm["sink"]
        self._staleness.observe(max(now - min_ts, 0.0))
        self._staleness.observe(max(now - max_ts, 0.0))
        self._set_wm_gauge(sink_wm)

    def discard_stamps(self, first_off: int, n: int) -> None:
        """Records [first_off, first_off+n) were explicitly SHED by the
        admission controller: consume their stamps without booking
        staleness or advancing the sink watermark — the records were
        dropped by decision, never scored, and a shed batch booked as
        "fresh delivery" would lie in both directions. Keeps the
        offset-ordered channel healthy for the batches that do sink."""
        if n <= 0:
            return
        end = int(first_off) + int(n)
        with self._mu:
            while self._stamps and self._stamps[0][0] < end:
                entry = self._stamps[0]
                if entry[1] <= end:
                    self._stamps.popleft()
                else:
                    entry[0] = end  # mid-stamp shed: keep the remainder
                    break

    def reset_stamps(self) -> None:
        """A source seek/restore invalidated the offset domain: drop
        pending stamps (watermarks stay — event time never regresses)."""
        with self._mu:
            self._stamps.clear()

    def _maybe_refresh(self, now: float) -> None:
        """Re-derive every partition's lag gauge from the wall clock
        (rate-limited): a partition that stopped fetching would
        otherwise freeze its watermark_lag_s at the last fetch's value
        — the same staleness hole kafka_lag had."""
        with self._mu:
            if now - self._last_refresh < _REFRESH_MIN_PERIOD_S:
                return
            self._last_refresh = now
            pairs = [
                (self._part_gauges.get(p), wm)
                for p, wm in self._part_wm.items()
            ]
        for g, wm in pairs:
            if g is not None:
                g.set(max(now - wm, 0.0))


class LagForecaster:
    """Per-partition produced/consumed rate estimation over a sliding
    window → drain-ETA, trend, and divergence signals, plus the
    age-stamping that keeps ``kafka_lag`` honest on a stalled
    partition. One instance per *source* (partition keys are the
    source's own), fed from its fetch path:
    ``observe(partition, produced_hw, consumed_cursor)``.

    ``clock`` is injectable (monotonic domain) so the window arithmetic
    and staleness transitions are testable in milliseconds."""

    def __init__(
        self,
        metrics: Optional[MetricsRegistry],
        window_s: float = _DEFAULT_WINDOW_S,
        stale_s: float = _DEFAULT_STALE_S,
        clock=time.monotonic,
    ):
        self._metrics = metrics
        self._window = window_s
        self._stale = stale_s
        self._clock = clock
        self._mu = threading.Lock()
        # partition -> deque[(t, produced_hw, consumed_cursor)]
        self._frames: Dict[str, "collections.deque"] = {}
        self._last_obs: Dict[str, float] = {}
        self._age_gauges: Dict[str, object] = {}
        self._stale_parts: set = set()
        self._last_compute = 0.0
        self._last_sweep = 0.0
        self._last_divergence = -_DIVERGENCE_MIN_PERIOD_S
        if metrics is not None:
            self._eta = metrics.gauge("lag_drain_eta_s")
            self._trend = metrics.gauge("lag_trend")
            self._diverging = metrics.gauge("lag_diverging")
            # scrape-side aging: a wedged CONSUMER (full ring, blocked
            # ingest thread) never re-enters the fetch path, so the
            # sweep must also ride the /metrics scrape and heartbeat
            # piggyback — both collect through struct_snapshot and
            # both survive the stall (held weakly: a closed source's
            # forecaster unregisters itself)
            metrics.add_scrape_hook(self.sweep)
        else:
            self._eta = self._trend = self._diverging = None

    @property
    def enabled(self) -> bool:
        return self._metrics is not None

    def observe(
        self, partition, produced: int, consumed: int,
        now: Optional[float] = None,
    ) -> None:
        """One fetch observation: broker high watermark (``produced``)
        vs this consumer's cursor (``consumed``) for ``partition``."""
        if not self.enabled:
            return
        part = str(partition)
        now = self._clock() if now is None else now
        with self._mu:
            frames = self._frames.get(part)
            if frames is None:
                frames = self._frames[part] = collections.deque()
            frames.append((now, int(produced), int(consumed)))
            # keep one frame beyond the horizon as the window baseline
            while len(frames) >= 2 and frames[1][0] <= now - self._window:
                frames.popleft()
            self._last_obs[part] = now
            if part in self._stale_parts:
                self._stale_parts.discard(part)  # fresh data: recovered
            due = now - self._last_compute >= 0.25
            if due:
                self._last_compute = now
        if due:
            self._compute(now)
        self.sweep(now)

    def reset(self) -> None:
        """A source seek invalidated the cursor domain (a cycling
        bench's wrap-to-0 would read as a giant negative consume rate):
        start the windows over."""
        with self._mu:
            self._frames.clear()

    def _compute(self, now: float) -> None:
        lag_total = 0
        prod_rate = 0.0
        cons_rate = 0.0
        rated = 0
        with self._mu:
            for frames in self._frames.values():
                t1, hw1, cur1 = frames[-1]
                lag_total += max(hw1 - cur1, 0)
                t0, hw0, cur0 = frames[0]
                dt = t1 - t0
                # a window needs real span before its rates mean much
                if dt >= min(1.0, 0.25 * self._window):
                    prod_rate += (hw1 - hw0) / dt
                    cons_rate += (cur1 - cur0) / dt
                    rated += 1
        if self._eta is None:
            return
        net = prod_rate - cons_rate
        if not rated and lag_total > 0:
            # backlog exists but no window has real span yet: not
            # enough data to call it draining OR diverging — leave the
            # gauges where they were instead of inventing a verdict
            return
        self._trend.set(round(net, 3) if rated else 0.0)
        # deadband: under ~a quarter-second of consumption (or a fetch's
        # worth, whichever is larger) the "lag" is healthy pipelining
        # jitter — flagging divergence on it would page on every idle
        # oscillation of a perfectly-drained stream
        floor = max(0.25 * cons_rate, 64.0)
        if lag_total <= floor:
            self._eta.set(0.0)
            self._diverging.set(0.0)
            return
        eps = 0.02 * max(prod_rate, cons_rate, 1.0)
        if net < -eps:
            self._eta.set(round(lag_total / -net, 3))
            self._diverging.set(0.0)
            return
        # real backlog and consumption is NOT outpacing production: the
        # ETA is unbounded — say so on its own boolean (a finite
        # neighbour must not mask it in the worst-of fleet merge) and
        # leave the last finite ETA alone rather than faking one
        self._diverging.set(1.0)
        if now - self._last_divergence >= _DIVERGENCE_MIN_PERIOD_S:
            self._last_divergence = now
            flight.record(
                "lag_divergence",
                lag_records=int(lag_total),
                trend_rec_s=round(net, 1),
                window_s=self._window,
            )

    def sweep(self, now: Optional[float] = None) -> None:
        """Age-stamp every partition's last lag observation
        (``kafka_lag_age_s{partition=*}``), flagging the first crossing
        of ``stale_s`` with a ``kafka_lag_stale`` flight event.
        Rate-limited; also safe to tick from outside the fetch path so
        one live partition ages its stalled siblings."""
        if not self.enabled:
            return
        now = self._clock() if now is None else now
        newly_stale = []
        with self._mu:
            if now - self._last_sweep < 1.0:
                return
            self._last_sweep = now
            for part, t_obs in self._last_obs.items():
                age = max(now - t_obs, 0.0)
                g = self._age_gauges.get(part)
                if g is None:
                    g = self._metrics.gauge(
                        f'kafka_lag_age_s{{partition="{part}"}}'
                    )
                    self._age_gauges[part] = g
                g.set(round(age, 3))
                if age > self._stale and part not in self._stale_parts:
                    self._stale_parts.add(part)
                    newly_stale.append((part, age))
        for part, age in newly_stale:
            flight.record(
                "kafka_lag_stale",
                partition=part,
                age_s=round(age, 3),
                stale_after_s=self._stale,
            )

    def stale_partitions(self) -> Tuple[str, ...]:
        with self._mu:
            return tuple(sorted(self._stale_parts))


# one tracker per registry (the ledger_for pattern): the kafka source
# and the pipeline share a registry, so they must share the tracker —
# the source stamps what the pipeline's sink later consumes
_TRACKERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_TRACKERS_MU = threading.Lock()


def freshness_for(
    metrics: Optional[MetricsRegistry],
) -> Optional[FreshnessTracker]:
    if metrics is None:
        return None
    tr = _TRACKERS.get(metrics)
    if tr is None:
        with _TRACKERS_MU:
            tr = _TRACKERS.get(metrics)
            if tr is None:
                tr = _TRACKERS[metrics] = FreshnessTracker(metrics)
    return tr
