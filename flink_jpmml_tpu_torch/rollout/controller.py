"""Guardrail controller: the loop that makes the obs plane *actuate*.

The port's copy of ``flink_jpmml_tpu/rollout/controller.py`` (no device
code), with the import lines renamed: it reads the port's metrics structs
and prediction sketches (``obs/drift``) and applies the pure transitions
of the port's ``rollout/state``. Local mode is ported whole: the
:class:`~flink_jpmml_tpu_torch.serving.scorer.DynamicScorer` ticks it
from its batch loop, with no thread of its own. Fleet mode is ported
whole too: ``Supervisor.rollout_controller()`` (``runtime/supervisor.py``)
runs it on a thread over the merged ``fleet_metrics()`` with a
:class:`RolloutBook` whose ``forward`` is ``Supervisor.broadcast_rollout``.

The observability plane produces mergeable per-worker measurement
structs (``MetricsRegistry.struct_snapshot``) and an exact fleet merge
(``merge_structs``) — the map-style measure / reduce-style aggregate
pattern. This module closes the loop: a :class:`RolloutController`
consumes those structs over a sliding window and automatically
promotes (shadow → canary → full) or rolls back every active rollout,
emitting each decision to the flight recorder and the ``rollout_*``
metric family.

The controller is deliberately agnostic about WHOSE structs it reads
and WHERE its decisions land:

- **local** (the default): bound to a :class:`ModelRegistry` and the
  scorer's own registry of metrics — decisions apply in-process. The
  :class:`~flink_jpmml_tpu_torch.serving.scorer.DynamicScorer` ticks it from
  the batch loop, so actuation happens between micro-batches on the
  serving thread: no lock dance with routing, no extra thread.
- **fleet**: bound to a :class:`RolloutBook` whose ``apply`` broadcasts
  the decision through the supervisor's heartbeat control channel
  (``Supervisor.broadcast_rollout``) and whose metrics come from
  ``Supervisor.fleet_metrics()`` — one guardrail verdict, every worker
  converges. Run it on a thread via :meth:`start`.

Guardrails evaluated per active rollout, each over the trailing
``spec.window_s`` and only past ``spec.min_samples`` observations:

- **disagreement** — shadow-diff disagreements / comparisons;
- **latency** — candidate p99 vs incumbent p99 of the per-dispatch
  rollout latency histograms (mergeable, so the fleet p99 is exact);
- **errors** — candidate dispatch/decode failures per attempt.

A violation rolls back immediately. A candidate that is healthy, has
met the sample floor, and has dwelt at its stage ``promote_after_s``
is promoted one stage. ``stage_since`` rides the checkpoint, so a
restore mid-canary resumes the dwell rather than restarting it.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from flink_jpmml_tpu_torch.obs import drift as drift_mod
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.rollout.state import (
    NEXT_STAGE,
    STAGE_CANARY,
    STAGE_FULL,
    STAGE_ROLLBACK,
    STAGE_SHADOW,
    RolloutState,
    apply_rollout,
)
from flink_jpmml_tpu_torch.utils.metrics import Histogram, MetricsRegistry

# numeric stage levels for the rollout_stage gauge (dashboards can
# threshold/graph them); 0 = no rollout active
STAGE_LEVEL = {STAGE_SHADOW: 1.0, STAGE_CANARY: 2.0, STAGE_FULL: 3.0}

_NAMED = re.compile(r'^(?P<base>[a-zA-Z0-9_]+)\{model="(?P<name>[^"]*)"\}$')


def _make_message(name: str, version: int, stage: str, timestamp: float):
    # deferred: models.control imports rollout.state at module load, so
    # importing it here at module level would be circular
    from flink_jpmml_tpu_torch.models.control import RolloutMessage

    return RolloutMessage(
        name=name, version=version, stage=stage, timestamp=timestamp
    )


def labelled(base: str, name: str) -> str:
    """The registry-name convention for per-model rollout series:
    ``rollout_x{model="name"}`` — the obs server renders the suffix as a
    real Prometheus label (cf. ``kafka_lag{partition="..."}``)."""
    return f'{base}{{model="{name}"}}'


def labelled_role(base: str, name: str, role: str) -> str:
    """Two-label variant for the per-role score-distribution sketches
    (``rollout_score_dist{model=...,role=...}`` — the order the scorer
    registers them in)."""
    return f'{base}{{model="{name}",role="{role}"}}'


def _named_values(section: dict, base: str) -> Dict[str, float]:
    """→ {model name: value} for every ``base{model="..."}`` entry."""
    out: Dict[str, float] = {}
    if not isinstance(section, dict):
        return out
    for raw, v in section.items():
        m = _NAMED.match(raw)
        if m and m.group("base") == base:
            try:
                out[m.group("name")] = float(v)
            except (TypeError, ValueError):
                continue
    return out


def _counter_delta(new: dict, old: Optional[dict], key: str) -> float:
    nc = (new.get("counters") or {}) if isinstance(new, dict) else {}
    oc = (old.get("counters") or {}) if isinstance(old, dict) else {}
    try:
        d = float(nc.get(key, 0.0)) - float(oc.get(key, 0.0))
    except (TypeError, ValueError):
        return 0.0
    # a restarted worker resets its counters; a negative window means the
    # baseline frame is from a previous incarnation — fall back to the
    # cumulative value rather than reporting impossible negatives
    return d if d >= 0 else float(nc.get(key, 0.0))


def _sketch_window(new: dict, old: Optional[dict], key: str):
    """The observation window's score-distribution sketch (newest
    cumulative state minus the baseline frame — the
    ``drift.sketch_window`` delta, with the same worker-restart
    cumulative fallback as :func:`_hist_window`)."""
    ns = (new.get("sketches") or {}).get(key) if isinstance(new, dict) else None
    os_ = (old.get("sketches") or {}).get(key) if isinstance(old, dict) else None
    return drift_mod.sketch_window(ns, os_)


def _hist_window(new: dict, old: Optional[dict], key: str) -> Optional[Histogram]:
    """The observation window's histogram: newest state minus the
    baseline frame's bucket counts (buckets ADD, so they subtract too).
    None when the window holds no observations or the states don't
    parse; a bucket going backwards (worker restart) falls back to the
    cumulative histogram."""
    nh = (new.get("histograms") or {}).get(key) if isinstance(new, dict) else None
    if not isinstance(nh, dict):
        return None
    oh = (old.get("histograms") or {}).get(key) if isinstance(old, dict) else None
    try:
        if not isinstance(oh, dict) or oh.get("layout") != nh.get("layout"):
            h = Histogram.from_state(nh)
            return h if h.count() > 0 else None
        counts = {k: int(v) for k, v in (nh.get("counts") or {}).items()}
        for k, v in (oh.get("counts") or {}).items():
            counts[k] = counts.get(k, 0) - int(v)
        if any(v < 0 for v in counts.values()):
            h = Histogram.from_state(nh)
            return h if h.count() > 0 else None
        n = int(nh.get("n", 0)) - int(oh.get("n", 0))
        if n <= 0:
            return None
        return Histogram.from_state({
            "layout": nh["layout"],
            "counts": {k: v for k, v in counts.items() if v},
            "sum": float(nh.get("sum", 0.0)) - float(oh.get("sum", 0.0)),
            "n": n,
            # the window max is unknowable from cumulative states; the
            # cumulative max is a safe upper clamp for quantiles
            "max": float(nh.get("max", 0.0)),
        })
    except (KeyError, IndexError, TypeError, ValueError):
        return None


class RolloutBook:
    """Registry-less rollout state book (the supervisor/fleet side).

    Tracks stages with the same pure transitions the registry uses
    (``rollout/state.py apply_rollout``) and hands every applied message
    to ``forward`` — ``Supervisor.broadcast_rollout`` in the fleet
    wiring — so the book's view and the fleet's converge on the same
    message stream."""

    def __init__(self, forward: Callable[..., None]):
        self._forward = forward
        self._mu = threading.Lock()
        self._states: Dict[str, RolloutState] = {}

    def rollouts(self) -> Dict[str, RolloutState]:
        with self._mu:
            return dict(self._states)

    def apply(self, msg) -> bool:
        with self._mu:
            self._states, changed = apply_rollout(self._states, msg)
        # forward even a no-op transition: a worker that missed earlier
        # frames must still converge on the current stage
        self._forward(msg)
        return changed


class RolloutController:
    """Sliding-window guardrail evaluation + promote/rollback actuation.

    ``book`` needs ``rollouts() -> {name: RolloutState}`` and
    ``apply(RolloutMessage)`` — a :class:`ModelRegistry` or a
    :class:`RolloutBook`. ``struct_fn`` yields the cumulative metrics
    struct to window over (a registry's ``struct_snapshot`` or a
    supervisor's ``fleet_metrics``). ``metrics`` receives the decision
    counters and stage gauges (pass the same registry the scorer uses so
    one scrape shows signals and verdicts together)."""

    def __init__(
        self,
        book,
        struct_fn: Callable[[], dict],
        metrics: Optional[MetricsRegistry] = None,
        interval_s: float = 0.5,
        clock: Callable[[], float] = time.time,
    ):
        self._book = book
        self._struct_fn = struct_fn
        self.metrics = metrics or MetricsRegistry()
        self._interval = interval_s
        self._clock = clock
        self._frames: List[Tuple[float, dict]] = []  # (t, cumulative struct)
        self._last_tick = 0.0
        self._mu = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- ticking -----------------------------------------------------------

    def maybe_tick(self) -> List[dict]:
        """Rate-limited :meth:`tick` — the batch-loop piggyback entry
        point (cheap no-op between intervals and with no active
        rollouts)."""
        now = self._clock()
        if now - self._last_tick < self._interval:
            return []
        return self.tick(now)

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Evaluate every active rollout once; → the decisions taken
        (each ``{"name", "action", "stage", "reason", ...}``)."""
        now = self._clock() if now is None else now
        with self._mu:
            self._last_tick = now
            rollouts = self._book.rollouts()
            if not rollouts:
                # idle: drop any stale window so (a) no per-tick struct
                # snapshot keeps burning the serving thread forever and
                # (b) the next rollout starts a fresh baseline
                self._frames.clear()
                return []
            # gauges BEFORE evaluation: _actuate writes the terminal
            # level for promoted/rolled-back names, and the entry is
            # gone from the book afterwards — a post-decision sweep over
            # this (pre-decision) snapshot would resurrect stale stages
            self._set_stage_gauges(rollouts)
            struct = self._struct_fn()
            self._frames.append((now, struct))
            # keep exactly one frame older than every window (the
            # baseline); specs may differ per rollout, so prune to the
            # widest active window
            widest = max(
                st.spec.window_s for st in rollouts.values()
            )
            while (
                len(self._frames) >= 2
                and self._frames[1][0] <= now - widest
            ):
                self._frames.pop(0)
            old = self._frames[0][1] if len(self._frames) >= 2 else None
            decisions = []
            for name, st in sorted(rollouts.items()):
                d = self._evaluate(name, st, struct, old, now)
                if d is not None:
                    decisions.append(d)
        return decisions

    def _set_stage_gauges(self, rollouts: Dict[str, RolloutState]) -> None:
        for name, st in rollouts.items():
            # literal f-string names keep tools/metrics_lint.py able to
            # see the emission sites (same below for the decision counters)
            self.metrics.gauge(f'rollout_stage{{model="{name}"}}').set(
                STAGE_LEVEL.get(st.stage, 0.0)
            )

    # -- evaluation --------------------------------------------------------

    def _evaluate(
        self, name: str, st: RolloutState, new: dict,
        old: Optional[dict], now: float,
    ) -> Optional[dict]:
        spec = st.spec
        compared = _counter_delta(
            new, old, labelled("rollout_shadow_compared", name)
        )
        disagree = _counter_delta(
            new, old, labelled("rollout_shadow_disagree", name)
        )
        cand_records = _counter_delta(
            new, old, labelled("rollout_candidate_records", name)
        )
        errors = _counter_delta(
            new, old, labelled("rollout_candidate_errors", name)
        )
        ch = _hist_window(
            new, old, labelled("rollout_candidate_latency_s", name)
        )
        ih = _hist_window(
            new, old, labelled("rollout_incumbent_latency_s", name)
        )
        stats = {
            "compared": compared, "disagree": disagree,
            "candidate_records": cand_records, "errors": errors,
        }

        reason = None
        if compared >= spec.min_samples:
            rate = disagree / compared
            stats["disagree_rate"] = rate
            if rate > spec.max_disagree_rate:
                reason = (
                    f"disagreement rate {rate:.4f} > "
                    f"{spec.max_disagree_rate:.4f}"
                )
        attempts = cand_records + compared + errors
        if reason is None and attempts >= spec.min_samples and errors > 0:
            rate = errors / attempts
            stats["error_rate"] = rate
            if rate > spec.max_error_rate:
                reason = (
                    f"error rate {rate:.4f} > {spec.max_error_rate:.4f}"
                )
        if (
            reason is None
            and ch is not None and ih is not None
            and ch.count() >= spec.min_samples
            and ih.count() >= spec.min_samples
        ):
            cp99, ip99 = ch.quantile(0.99), ih.quantile(0.99)
            if cp99 is not None and ip99 is not None and ip99 > 0:
                stats["candidate_p99_s"] = cp99
                stats["incumbent_p99_s"] = ip99
                if cp99 > spec.max_latency_ratio * ip99:
                    reason = (
                        f"candidate p99 {cp99 * 1e3:.2f}ms > "
                        f"{spec.max_latency_ratio:g}x incumbent "
                        f"{ip99 * 1e3:.2f}ms"
                    )
        # prediction drift (the data-plane guardrail, obs/drift.py):
        # PSI of the candidate's windowed score distribution against
        # the incumbent's — a candidate can agree record-by-record
        # within tolerance yet shift the score DISTRIBUTION your
        # downstream thresholds were calibrated on
        hold_psi = spec.effective_hold_psi
        pred_psi = None
        if hold_psi is not None or spec.max_prediction_psi is not None:
            cw = _sketch_window(
                new, old,
                labelled_role("rollout_score_dist", name, "candidate"),
            )
            iw = _sketch_window(
                new, old,
                labelled_role("rollout_score_dist", name, "incumbent"),
            )
            if (
                cw is not None and iw is not None
                and cw.count() >= spec.min_samples
                and iw.count() >= spec.min_samples
            ):
                pred_psi = drift_mod.psi(iw, cw)
            if pred_psi is not None:
                stats["prediction_psi"] = pred_psi
                self.metrics.gauge(
                    f'rollout_prediction_psi{{model="{name}"}}'
                ).set(round(pred_psi, 4))
                if (
                    reason is None
                    and spec.max_prediction_psi is not None
                    and pred_psi > spec.max_prediction_psi
                ):
                    reason = (
                        f"prediction PSI {pred_psi:.4f} > "
                        f"{spec.max_prediction_psi:.4f}"
                    )
        if reason is not None:
            return self._actuate(
                name, st, STAGE_ROLLBACK, reason, stats, now
            )

        # promotion: healthy + sample floor met this window + dwelt long
        # enough at the current stage; a prediction PSI above the hold
        # threshold withholds promotion (the candidate keeps serving its
        # current stage until the drift subsides or crosses max)
        floor = compared if st.stage == STAGE_SHADOW else cand_records
        if (
            floor >= spec.min_samples
            and now - st.stage_since >= spec.promote_after_s
        ):
            if (
                hold_psi is not None
                and pred_psi is not None
                and pred_psi > hold_psi
            ):
                flight.record(
                    "rollout_promotion_held", model=name,
                    version=st.candidate_version, stage=st.stage,
                    prediction_psi=round(pred_psi, 4),
                    hold_threshold=hold_psi,
                )
                return None
            return self._actuate(
                name, st, NEXT_STAGE[st.stage],
                f"healthy for {now - st.stage_since:.1f}s", stats, now,
            )
        return None

    # -- actuation ---------------------------------------------------------

    def _actuate(
        self, name: str, st: RolloutState, stage: str,
        reason: str, stats: dict, now: float,
    ) -> dict:
        msg = _make_message(name, st.candidate_version, stage, now)
        self._book.apply(msg)
        action = "rollback" if stage == STAGE_ROLLBACK else "promote"
        if action == "rollback":
            self.metrics.counter(f'rollout_rollbacks{{model="{name}"}}').inc()
        else:
            self.metrics.counter(f'rollout_promotions{{model="{name}"}}').inc()
        if stage in (STAGE_ROLLBACK, STAGE_FULL):
            self.metrics.gauge(f'rollout_stage{{model="{name}"}}').set(
                STAGE_LEVEL[STAGE_FULL] if stage == STAGE_FULL else 0.0
            )
        decision = {
            "name": name, "version": st.candidate_version,
            "action": action, "from_stage": st.stage, "stage": stage,
            "reason": reason, **stats,
        }
        # every decision is a flight-recorder event: the postmortem
        # question after a surprise rollback is always "why"
        flight.record(f"rollout_{action}", **decision)
        return decision

    def promote(self, name: str) -> Optional[dict]:
        """Manual promotion by one stage (the operator override)."""
        st = self._book.rollouts().get(name)
        if st is None:
            return None
        return self._actuate(
            name, st, NEXT_STAGE[st.stage], "manual promote", {},
            self._clock(),
        )

    def rollback(self, name: str, reason: str = "manual") -> Optional[dict]:
        """Manual rollback (the operator override)."""
        st = self._book.rollouts().get(name)
        if st is None:
            return None
        return self._actuate(
            name, st, STAGE_ROLLBACK, reason, {}, self._clock()
        )

    # -- thread mode (fleet controllers) -----------------------------------

    def start(self) -> "RolloutController":
        """Tick on a daemon thread every ``interval_s`` (for controllers
        with no batch loop to piggyback on, e.g. the supervisor's fleet
        controller); idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self._interval):
                try:
                    self.tick()
                except Exception:
                    # a guardrail evaluation crash must not silently end
                    # supervision of every other rollout
                    flight.record("rollout_controller_error")

        self._thread = threading.Thread(
            target=_loop, name="fjt-rollout-ctl", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
