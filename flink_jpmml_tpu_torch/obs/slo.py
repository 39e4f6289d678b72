"""SLO tracker: multi-window burn-rate evaluation over latency structs.

The port's copy of ``flink_jpmml_tpu/obs/slo.py``, with the import lines
renamed and its notes on the project's history cut. The block pipelines
take one as ``slo=`` and tick it from their completion path; the dynamic
scorer always builds one over ``score_latency_s``. On the card the
watched histograms are host clocks that end after the CUDA event wait,
so a latency includes the card's work.

A p99 far past the deadline should not go unsaid. This module
watches a deadline-vs-achieved latency histogram (any mergeable
``Histogram`` in a registry — ``batch_latency_s``, ``score_latency_s``,
a stage histogram) and evaluates **burn rates** over several trailing
windows at once, the classic multi-window alert shape: a short window
catches a fast burn, a long window keeps a brief blip from paging.

Definitions (per tick, per window ``w``):

- *good*  = observations ≤ the deadline (bucket-resolution: the
  cumulative count at the smallest bucket edge ≥ the deadline);
- *error rate* = 1 − good/total over the window's delta;
- *burn rate*  = error rate / error budget, where the budget is
  ``1 − objective`` (objective default 0.999);
- **breach** when every evaluable window's burn exceeds its threshold
  (defaults: 14.4× over 5 m AND 6× over 1 h — the standard fast-burn
  pair, scaled down by env for tests/short jobs).

Ticks are piggybacked on the serving loops exactly like the
rollout controller's (``maybe_tick`` between batches; no extra
thread), with an injectable clock so the transition state machine is
testable in milliseconds. State transitions are recorded to the flight
recorder (``slo_breach`` / ``slo_clear``) and the registry
(``slo_burn_rate{window="..."}`` gauges, ``slo_ok`` gauge,
``slo_breaches`` counter), and :meth:`health` folds the current verdict
into a ``/healthz`` payload.

Env config (all optional — without ``FJT_SLO_TARGET_MS`` the tracker is
inert): ``FJT_SLO_TARGET_MS`` (the deadline), ``FJT_SLO_OBJECTIVE``
(default 0.999), ``FJT_SLO_WINDOWS`` (``seconds:burn,...``, default
``300:14.4,3600:6``), ``FJT_SLO_STALL_FRAC`` (the stage-stall fraction,
read by obs/attr.py).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Tuple

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

_TARGET_ENV = "FJT_SLO_TARGET_MS"
_OBJECTIVE_ENV = "FJT_SLO_OBJECTIVE"
_WINDOWS_ENV = "FJT_SLO_WINDOWS"
_DEFAULT_WINDOWS = ((300.0, 14.4), (3600.0, 6.0))


def parse_windows_env(
    env: str,
    default: Tuple[Tuple[float, float], ...],
    max_threshold: Optional[float] = None,
) -> Tuple[Tuple[float, float], ...]:
    """The shared ``window_seconds:threshold,...`` grammar behind
    ``FJT_SLO_WINDOWS`` and ``FJT_PRESSURE_WINDOWS`` (obs/pressure.py):
    garbage entries drop, an all-garbage/empty value falls back to
    ``default``. ``max_threshold`` bounds the threshold when the domain
    has one (pressure means live in [0, 1]; burn rates don't)."""
    raw = os.environ.get(env)
    if not raw:
        return default
    out: List[Tuple[float, float]] = []
    for part in raw.split(","):
        try:
            w, thr = part.split(":")
            w_f, thr_f = float(w), float(thr)
            if w_f > 0 and thr_f > 0 and (
                max_threshold is None or thr_f <= max_threshold
            ):
                out.append((w_f, thr_f))
        except ValueError:
            continue
    return tuple(out) or default


def _env_windows() -> Tuple[Tuple[float, float], ...]:
    return parse_windows_env(_WINDOWS_ENV, _DEFAULT_WINDOWS)


class SLOTracker:
    """Deadline SLO burn-rate state machine over one latency histogram.

    ``source`` names the histogram in ``metrics`` to window over.
    ``deadline_s``/``objective``/``windows`` default from the
    ``FJT_SLO_*`` env; with no deadline configured anywhere the tracker
    is inert (``maybe_tick`` is a cheap no-op, ``health`` reports
    nothing). ``windows`` is ``((window_s, burn_threshold), ...)``."""

    def __init__(
        self,
        metrics: MetricsRegistry,
        source: str = "batch_latency_s",
        deadline_s: Optional[float] = None,
        objective: Optional[float] = None,
        windows: Optional[Tuple[Tuple[float, float], ...]] = None,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.metrics = metrics
        self._source = source
        if deadline_s is None:
            try:
                ms = float(os.environ.get(_TARGET_ENV) or 0.0)
            except ValueError:
                ms = 0.0
            deadline_s = ms / 1000.0 if ms > 0 else None
        self.deadline_s = deadline_s
        if objective is None:
            try:
                objective = float(
                    os.environ.get(_OBJECTIVE_ENV) or 0.999
                )
            except ValueError:
                objective = 0.999
        self.objective = min(max(objective, 0.0), 1.0 - 1e-9)
        self.windows = tuple(windows) if windows else _env_windows()
        self._interval = interval_s
        self._clock = clock
        self._mu = threading.Lock()
        self._frames: List[Tuple[float, int, int]] = []  # (t, good, total)
        self._last_tick = 0.0
        self._breached = False
        self._last_burns: dict = {}
        if self.enabled:
            self.metrics.gauge("slo_ok").set(1.0)
            # the configured deadline as a scrapeable gauge: fjt-top
            # --overload and the overload drill read p99-vs-deadline
            # from one struct without re-parsing the env (fleet merge:
            # worst-of — identical across workers in practice)
            self.metrics.gauge("slo_deadline_ms").set(
                round(self.deadline_s * 1e3, 3)
            )

    @property
    def enabled(self) -> bool:
        return self.deadline_s is not None

    # -- measurement --------------------------------------------------------

    def _good_total(self) -> Tuple[int, int]:
        """Cumulative (good, total) of the watched histogram right now.
        'Good' resolves at bucket granularity: the cumulative count at
        the smallest edge ≥ the deadline (an upper bound on goodness —
        consistent, and exact once the deadline sits on an edge)."""
        h = self.metrics.histogram(self._source)
        state = h.state()
        counts = state.get("counts", {})
        total = int(state.get("n", 0))
        edges = h.edges
        cut = len(edges)  # all real buckets good if deadline > hi
        for i, edge in enumerate(edges):
            if edge >= self.deadline_s:
                cut = i + 1
                break
        good = sum(
            c for i, c in ((int(k), v) for k, v in counts.items())
            if i < cut
        )
        return good, total

    # -- ticking ------------------------------------------------------------

    def maybe_tick(self) -> Optional[dict]:
        """Rate-limited :meth:`tick` — the batch-loop piggyback entry
        point (a None check + clock read when inert or between
        intervals)."""
        if not self.enabled:
            return None
        now = self._clock()
        if now - self._last_tick < self._interval:
            return None
        return self.tick(now)

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """Evaluate every window once; → the evaluation dict (burn
        rates, breach state), or None when inert."""
        if not self.enabled:
            return None
        now = self._clock() if now is None else now
        good, total = self._good_total()
        budget = 1.0 - self.objective
        with self._mu:
            self._last_tick = now
            self._frames.append((now, good, total))
            # prune: keep one frame at/beyond the widest window horizon
            # as that window's baseline, drop everything older
            widest = max(w for w, _ in self.windows)
            while (
                len(self._frames) >= 2
                and self._frames[1][0] <= now - widest
            ):
                self._frames.pop(0)
            burns: dict = {}
            evaluable = 0
            violating = 0
            for w, threshold in self.windows:
                base = None
                for t, g, n in reversed(self._frames):
                    if t <= now - w:
                        base = (g, n)
                        break
                if base is None:
                    # window not yet spanned: fall back to the oldest
                    # frame once at least half the window has elapsed —
                    # a cold start must not take an hour to alarm
                    t0, g0, n0 = self._frames[0]
                    if now - t0 >= 0.5 * w:
                        base = (g0, n0)
                if base is None:
                    continue
                d_total = total - base[1]
                if d_total <= 0:
                    continue
                d_bad = (total - good) - (base[1] - base[0])
                err_rate = max(0.0, d_bad / d_total)
                burn = err_rate / budget
                burns[w] = burn
                evaluable += 1
                if burn > threshold:
                    violating += 1
                self.metrics.gauge(
                    f'slo_burn_rate{{window="{int(w)}"}}'
                ).set(round(burn, 4))
            self._last_burns = burns
            breach = evaluable > 0 and violating == evaluable
            transition = None
            if breach and not self._breached:
                self._breached = True
                transition = "breach"
            elif not breach and self._breached and evaluable > 0:
                self._breached = False
                transition = "clear"
            breached = self._breached
        self.metrics.gauge("slo_ok").set(0.0 if breached else 1.0)
        if transition == "breach":
            self.metrics.counter("slo_breaches").inc()
            flight.record(
                "slo_breach",
                source=self._source,
                deadline_ms=round(self.deadline_s * 1e3, 3),
                objective=self.objective,
                burns={str(int(w)): round(b, 3) for w, b in burns.items()},
            )
        elif transition == "clear":
            flight.record(
                "slo_clear",
                source=self._source,
                burns={str(int(w)): round(b, 3) for w, b in burns.items()},
            )
        return {
            "breached": breached,
            "burns": burns,
            "good": good,
            "total": total,
            "transition": transition,
        }

    # -- surfaces -----------------------------------------------------------

    @property
    def breached(self) -> bool:
        with self._mu:
            return self._breached

    def health(self) -> dict:
        """The ``/healthz`` contribution: liveness stays the server's
        call (an SLO burn is an alert, not a dead process), but the
        verdict and live burn rates ride the payload."""
        if not self.enabled:
            return {}
        with self._mu:
            return {
                "slo": {
                    "ok": not self._breached,
                    "deadline_ms": round(self.deadline_s * 1e3, 3),
                    "objective": self.objective,
                    "burn_rates": {
                        str(int(w)): round(b, 4)
                        for w, b in self._last_burns.items()
                    },
                },
            }

    def health_fn(
        self, base: Optional[Callable[[], dict]] = None
    ) -> Callable[[], dict]:
        """Compose a ``/healthz`` callback: ``base``'s payload (if any)
        plus this tracker's verdict."""

        def _health() -> dict:
            out = dict(base()) if base is not None else {"ok": True}
            out.update(self.health())
            return out

        return _health
