"""Backpressure telemetry: the composite pressure score + breach tracker.

The port's copy of ``flink_jpmml_tpu/obs/pressure.py``, with the import
lines renamed and its notes on the project's history cut. The JAX
package reads its breach windows from ``FJT_PRESSURE_WINDOWS`` through
``obs/slo.py``'s grammar; the port takes them as an argument, by default
the JAX package's ``((10, 0.8), (60, 0.6))``, and reads no such knob
(no port caller sets one). Its ``pressure`` gauge is what the port's
``AdmissionController`` sheds on by default.

ROADMAP item 5's adaptive-batching / load-shedding controller needs a
sensor that says "the pipeline is saturating" BEFORE p99 blows through
the deadline. Three independent saturation signals already exist in the
runtime, each partial on its own:

- **ring occupancy** — how full the ingest ring/queue sits
  (``ring_occupancy`` gauge, set by the pipelines' score loops from
  ``len(ring) / capacity``): producers outrunning the device;
- **window-full fraction** — the share of dispatcher launches that
  found the in-flight window full and had to block
  (``window_full_launches`` / ``dispatches`` deltas,
  ``runtime/pipeline.py``): the device outrunning its readback budget;
- **admission wait** — the share of wall clock batches spent waiting
  for a window slot (the ``queue_wait`` stage histogram's sum delta
  over the tick interval, ``obs/attr.py``);
- **prefetch fill** — the pipelined-ingest handoff queue's occupancy
  (``prefetch_occupancy`` gauge + the sidecar's ``note_prefetch``
  peak-hold, ``runtime/prefetch.py``): the fetch/decode sidecar
  outrunning the ring/score side.

:class:`PressureMonitor` folds them into one ``pressure`` score in
[0, 1] — the MAX of the components (saturation anywhere is saturation;
averaging would let an empty ring excuse a blocked window) — exposed as
``pressure`` (+ per-component ``pressure_ring`` / ``pressure_window`` /
``pressure_wait`` / ``pressure_prefetch`` gauges, fleet merge worst-of
like the ratio gauges) on ``/metrics`` and ``/varz``, rendered by
``fjt-top --freshness``.

Sustained pressure raises a **multi-window breach** (trailing windows,
half-window cold-start fallback, breach = EVERY evaluable window over
its threshold, ``health_fn`` composition onto ``/healthz``): ``windows``
pairs ``(window_seconds, mean_pressure_threshold)``; transitions record
``pressure_breach`` / ``pressure_clear`` flight events and a
``pressure_breaches`` counter. Ticks piggyback on the batch loops
(``maybe_tick``, no thread of its own), with an injectable clock for tests.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, List, Optional, Tuple

from flink_jpmml_tpu_torch.obs import attr, recorder as flight
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

_DEFAULT_WINDOWS = ((10.0, 0.8), (60.0, 0.6))


class PressureMonitor:
    """Composite backpressure score + multi-window breach tracker over
    one registry. One monitor per registry (:func:`pressure_for`);
    ``windows`` is ``((window_s, mean_threshold), ...)``."""

    def __init__(
        self,
        metrics: MetricsRegistry,
        windows: Optional[Tuple[Tuple[float, float], ...]] = None,
        interval_s: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._metrics_ref = weakref.ref(metrics)
        self.windows = tuple(windows) if windows else _DEFAULT_WINDOWS
        self._interval = interval_s
        self._clock = clock
        self._mu = threading.Lock()
        self._frames: List[Tuple[float, float]] = []  # (t, pressure)
        self._last_tick = 0.0
        self._breached = False
        self._last = {"pressure": 0.0}
        # pre-drain ring peak since the last tick (note_ring): the
        # ring_occupancy GAUGE reads post-drain, and under
        # deadline-capped multi-chunk aggregation one drain can
        # empty half the ring — a tick sampling only the gauge lands on
        # either side of that sawtooth at random, so sustained
        # saturation looks intermittent exactly when the admission
        # controller needs it steady. The peak-hold keeps the worst
        # occupancy any drain STARTED from within the interval.
        self._ring_peak = 0.0
        # prefetch handoff-queue fill peak since the last tick
        # (runtime/prefetch.py note_prefetch) — the pipelined-ingest
        # twin of the ring peak-hold: a full handoff queue means the
        # fetch side is outrunning everything downstream
        self._prefetch_peak = 0.0
        # delta baselines
        self._dispatches = metrics.counter("dispatches")
        self._window_full = metrics.counter("window_full_launches")
        self._ring = metrics.gauge("ring_occupancy")
        self._prefetch = metrics.gauge("prefetch_occupancy")
        # the queue_wait stage histogram (obs/attr.py naming), resolved
        # through stage_metric_name so the lint's catalogue keeps one
        # wildcard row for the whole stage family
        self._wait_hist = metrics.histogram(
            attr.stage_metric_name("queue_wait")
        )
        self._gauge = metrics.gauge("pressure")
        self._g_ring = metrics.gauge("pressure_ring")
        self._g_window = metrics.gauge("pressure_window")
        self._g_wait = metrics.gauge("pressure_wait")
        self._g_prefetch = metrics.gauge("pressure_prefetch")
        self._breaches = metrics.counter("pressure_breaches")
        self._base_disp = self._dispatches.get()
        self._base_full = self._window_full.get()
        self._base_wait = self._wait_hist.sum()
        self._base_t: Optional[float] = None
        # scrape-side ticking (MetricsRegistry.add_scrape_hook, like
        # the freshness detectors): the batch-completion paths stop
        # calling maybe_tick the moment a sink wedges — exactly when
        # the breach tracker must keep evaluating; the /metrics scrape
        # and heartbeat piggyback survive the stall (rate-limited by
        # the tick interval; held weakly)
        metrics.add_scrape_hook(self.maybe_tick)

    def note_ring(self, occupancy: float) -> None:
        """Record a PRE-drain ring occupancy observation (the block
        score loops call this at drain start); the next tick's ring
        component is the max of the gauge and this peak."""
        with self._mu:
            if occupancy > self._ring_peak:
                self._ring_peak = occupancy

    def note_prefetch(self, occupancy: float) -> None:
        """Record a prefetch handoff-queue fill observation (the
        sidecar calls this on every push); the next tick's prefetch
        component is the max of the gauge and this peak."""
        with self._mu:
            if occupancy > self._prefetch_peak:
                self._prefetch_peak = occupancy

    # -- ticking -------------------------------------------------------------

    def maybe_tick(self) -> Optional[dict]:
        now = self._clock()
        with self._mu:
            if now - self._last_tick < self._interval:
                return None
            # claim the interval before releasing the lock: two submit
            # threads racing past the gate would otherwise both tick,
            # double-weighting this instant in every window mean
            self._last_tick = now
        return self.tick(now)

    def tick(self, now: Optional[float] = None) -> dict:
        now = self._clock() if now is None else now
        with self._mu:
            # delta baselines are read-modify-write: two concurrent
            # submit threads both ticking would otherwise advance the
            # baseline past the real counter and clamp a genuinely
            # saturated window-full fraction to 0 (metric get()/sum()
            # take only their own leaf locks — no ordering cycle)
            d_disp = self._dispatches.get() - self._base_disp
            d_full = self._window_full.get() - self._base_full
            wait_sum = self._wait_hist.sum()
            d_wait = wait_sum - self._base_wait
            dt = (
                None if self._base_t is None
                else max(now - self._base_t, 1e-9)
            )
            self._base_disp += d_disp
            self._base_full += d_full
            self._base_wait = wait_sum
            self._base_t = now
            ring = min(
                max(self._ring.get(), self._ring_peak, 0.0), 1.0
            )
            self._ring_peak = 0.0
            prefetch = min(
                max(self._prefetch.get(), self._prefetch_peak, 0.0), 1.0
            )
            self._prefetch_peak = 0.0
            window = (
                min(max(d_full / d_disp, 0.0), 1.0) if d_disp > 0 else 0.0
            )
            wait = (
                min(max(d_wait / dt, 0.0), 1.0) if dt is not None else 0.0
            )
            p = max(ring, window, wait, prefetch)
            self._last_tick = now
            self._frames.append((now, p))
            widest = max(w for w, _ in self.windows)
            while (
                len(self._frames) >= 2
                and self._frames[1][0] <= now - widest
            ):
                self._frames.pop(0)
            evaluable = 0
            violating = 0
            means: dict = {}
            for w, threshold in self.windows:
                pts = [v for t, v in self._frames if t >= now - w]
                # cold start: evaluate once at least half the window of
                # samples exists (a fresh process must not take a
                # minute to notice saturation)
                span = now - self._frames[0][0]
                if not pts or (span < 0.5 * w and len(self._frames) < 4):
                    continue
                mean = sum(pts) / len(pts)
                means[w] = mean
                evaluable += 1
                if mean > threshold:
                    violating += 1
            breach = evaluable > 0 and violating == evaluable
            transition = None
            if breach and not self._breached:
                self._breached = True
                transition = "breach"
            elif not breach and self._breached and evaluable > 0:
                self._breached = False
                transition = "clear"
            breached = self._breached
            self._last = {
                "pressure": p, "ring": ring, "window": window,
                "wait": wait, "prefetch": prefetch, "means": means,
            }
        self._gauge.set(round(p, 4))
        self._g_ring.set(round(ring, 4))
        self._g_window.set(round(window, 4))
        self._g_wait.set(round(wait, 4))
        self._g_prefetch.set(round(prefetch, 4))
        if transition == "breach":
            self._breaches.inc()
            flight.record(
                "pressure_breach",
                pressure=round(p, 4),
                means={str(int(w)): round(m, 4) for w, m in means.items()},
            )
        elif transition == "clear":
            flight.record(
                "pressure_clear",
                pressure=round(p, 4),
                means={str(int(w)): round(m, 4) for w, m in means.items()},
            )
        return {
            "pressure": p,
            "ring": ring,
            "window": window,
            "wait": wait,
            "prefetch": prefetch,
            "breached": breached,
            "transition": transition,
        }

    # -- surfaces ------------------------------------------------------------

    @property
    def breached(self) -> bool:
        with self._mu:
            return self._breached

    def health(self) -> dict:
        """The ``/healthz`` contribution: liveness stays the server's
        call, the verdict rides along."""
        with self._mu:
            return {
                "pressure": {
                    "ok": not self._breached,
                    "score": round(self._last.get("pressure", 0.0), 4),
                    "components": {
                        k: round(self._last.get(k, 0.0), 4)
                        for k in ("ring", "window", "wait", "prefetch")
                    },
                },
            }

    def health_fn(
        self, base: Optional[Callable[[], dict]] = None
    ) -> Callable[[], dict]:
        def _health() -> dict:
            out = dict(base()) if base is not None else {"ok": True}
            out.update(self.health())
            return out

        return _health


_MONITORS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_MONITORS_MU = threading.Lock()


def pressure_for(
    metrics: Optional[MetricsRegistry],
) -> Optional[PressureMonitor]:
    if metrics is None:
        return None
    mon = _MONITORS.get(metrics)
    if mon is None:
        with _MONITORS_MU:
            mon = _MONITORS.get(metrics)
            if mon is None:
                mon = _MONITORS[metrics] = PressureMonitor(metrics)
    return mon
