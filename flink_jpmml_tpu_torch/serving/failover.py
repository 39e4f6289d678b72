"""Fallback-tier circuit breaking: keep serving when the card is sick.

The port of ``flink_jpmml_tpu/serving/failover.py``.
``runtime/devfault.py`` tells a device fault apart from record poison;
this module is what the hot paths DO about a persistent one. Three
pieces, composed per pipeline as a :class:`FailoverPlane`:

:class:`CircuitBreaker` (a copy)
    One per (model, backend) key, the classic closed → open →
    half-open machine. ``record_failure`` counts consecutive device
    faults; at ``FJT_FAILOVER_THRESHOLD`` the circuit OPENS and the
    pipeline stops dispatching that model to the card — batches serve on
    the fallback tier instead of crash-looping. After
    ``FJT_FAILOVER_COOLDOWN_S`` the circuit goes HALF-OPEN: dispatches
    flow to the card again as *probes*, any failure re-opens, and
    ``FJT_FAILOVER_GREENS`` consecutive green probes CLOSE it. State is
    exported as ``failover_state{model=...}`` (0 closed / 1 half-open /
    2 open) and every transition is a flight event.

:class:`FallbackTier` (on torch)
    The degraded-mode scorer. **How failover meets the port's
    no-fall-back rule:**

    - *The rank wire reports itself unsupported*, as the JAX tier does
      for a Pallas scorer. Its kernel, ``qtrees_leaf_rows``, is never
      replaced by its plain version (``leaf_rows_reference``) on a live
      pipeline: when the ladder's retries run out it re-raises
      (escalation), and an open circuit keeps dispatching the rank wire
      to the card.
    - *An f32 model serves on the host tier only when the caller asks*,
      with ``failover=<plane>`` or ``FJT_FAILOVER=1``: its lowered
      function runs on a CPU copy of its parameter tensors, cached on the
      model (``_fjt_cpu_params``) as the JAX tier caches its
      ``_params_cpu``. The output crosses to the sink in the same
      :class:`ModelOutput` form as a card dispatch.
    - A plane that armed only because a DLQ is wired runs the breakers
      and the ladder, but its tier serves nothing (``serve=False``).
    - Every record the tier serves counts in ``fallback_records`` and
      leaves a ``fallback_serving`` flight event (rate-limited).

:class:`FailoverPlane`
    Per-registry bundle (``plane_for``): breakers keyed by model,
    the shared tier, and the recovery-ladder accounting —
    ``device_fault_total{kind}``, ``redispatch_records``,
    ``fallback_records``, ``oom_shrinks``.

The plane arms on pipelines that already retain their staging batches (a
DLQ is wired), or explicitly via ``FJT_FAILOVER=1`` / the ``failover=``
constructor knob; a bare loop pays nothing. The ladder itself lives in
the hot paths (``runtime/block.py`` ``_device_recover``,
``runtime/engine.py`` ``_recover_device``); this module owns the state
machines they share.
"""

from __future__ import annotations

import re
import threading
import time
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.utils.exceptions import FlinkJpmmlTpuError
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
from flink_jpmml_tpu_torch.utils.retry import env_float, env_int

_THRESHOLD_ENV = "FJT_FAILOVER_THRESHOLD"
_COOLDOWN_ENV = "FJT_FAILOVER_COOLDOWN_S"
_GREENS_ENV = "FJT_FAILOVER_GREENS"
_RETRIES_ENV = "FJT_DEVICE_RETRIES"

STATE_CLOSED = 0.0
STATE_HALF_OPEN = 1.0
STATE_OPEN = 2.0

_STATE_NAMES = {
    STATE_CLOSED: "closed",
    STATE_HALF_OPEN: "half-open",
    STATE_OPEN: "open",
}

_FALLBACK_EVENT_MIN_PERIOD_S = 1.0


class FallbackUnavailable(FlinkJpmmlTpuError):
    """This scorer has no host fallback twin (the rank wire, or a tier
    that serves nothing): the ladder escalates instead of serving
    degraded."""


class CircuitBreaker:
    """closed → open → half-open per served model; see module doc."""

    def __init__(
        self,
        metrics: Optional[MetricsRegistry] = None,
        key: str = "default",
        fail_threshold: Optional[int] = None,
        cooldown_s: Optional[float] = None,
        probe_greens: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.key = key
        self.fail_threshold = (
            fail_threshold if fail_threshold is not None
            else env_int(_THRESHOLD_ENV, 3)
        )
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None
            else env_float(_COOLDOWN_ENV, 2.0)
        )
        self.probe_greens = (
            probe_greens if probe_greens is not None
            else env_int(_GREENS_ENV, 3)
        )
        self._clock = clock
        self._mu = threading.Lock()
        self._state = STATE_CLOSED
        self._strikes = 0  # consecutive device faults while closed
        self._greens = 0  # consecutive green probes while half-open
        self._opened_at = 0.0
        self._gauge = (
            metrics.gauge(f'failover_state{{model="{key}"}}')
            if metrics is not None else None
        )

    @property
    def state(self) -> float:
        return self._state

    def _set_state(self, state: float) -> None:
        self._state = state
        if self._gauge is not None:
            self._gauge.set(state)

    def allow_dispatch(self) -> bool:
        """Hot-path verdict: may this model dispatch to the device?
        CLOSED and HALF-OPEN → yes (half-open dispatches are probes);
        OPEN → no until the cooldown elapses, at which point the
        circuit flips to HALF-OPEN and the answer becomes yes."""
        if self._state == STATE_CLOSED:
            return True
        with self._mu:
            if self._state == STATE_OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self._set_state(STATE_HALF_OPEN)
                self._greens = 0
                flight.record(
                    "failover_half_open", model=self.key,
                    cooldown_s=self.cooldown_s,
                )
            return True

    def record_failure(self, kind: str = "device_error") -> None:
        """One device fault attributed to this model. Opens the
        circuit past the threshold; any half-open probe failure
        re-opens immediately (the cooldown clock restarts)."""
        with self._mu:
            if self._state == STATE_CLOSED:
                self._strikes += 1
                if self._strikes < self.fail_threshold:
                    return
            self._strikes = 0
            self._greens = 0
            reopened = self._state == STATE_HALF_OPEN
            self._set_state(STATE_OPEN)
            self._opened_at = self._clock()
        flight.record(
            "failover_open", model=self.key, fault=kind,
            probe_failed=reopened,
        )

    def record_success(self) -> None:
        """One clean device completion. Closed: clears the strike
        streak. Half-open: counts a green probe — at ``probe_greens``
        the circuit CLOSES (automatic promotion back)."""
        if self._state == STATE_CLOSED and self._strikes == 0:
            return  # steady-state fast path: no lock
        closed_now = False
        with self._mu:
            if self._state == STATE_CLOSED:
                self._strikes = 0
                return
            if self._state == STATE_HALF_OPEN:
                self._greens += 1
                if self._greens >= self.probe_greens:
                    self._set_state(STATE_CLOSED)
                    self._strikes = 0
                    closed_now = True
        if closed_now:
            flight.record(
                "failover_close", model=self.key,
                greens=self.probe_greens,
            )


class FallbackTier:
    """Host (CPU) scoring twin for degraded-mode serving of f32 models;
    see the module docstring for what it refuses. ``serve=False``: a tier
    that serves nothing (the DLQ-only plane)."""

    def __init__(self, serve: bool = True):
        self.serve = serve

    def supports(self, bound) -> bool:
        """Can this BoundScorer-shaped handle serve on the host tier?
        An f32 model yes, when the tier serves at all; the rank wire
        never (no fall-back from its kernel)."""
        if not self.serve:
            return False
        if getattr(bound, "q", None) is not None:
            return False
        model = getattr(bound, "model", None)
        return getattr(model, "_fn", None) is not None

    @staticmethod
    def _params_cpu(model):
        """CPU-resident params copy cached ON the model itself — its
        lifetime is the model's lifetime."""
        cached = getattr(model, "_fjt_cpu_params", None)
        if cached is not None:
            return cached
        placed = _to_cpu(model.params)
        try:
            object.__setattr__(model, "_fjt_cpu_params", placed)
        except (AttributeError, TypeError):
            pass  # slotted/frozen model: recompute per call
        return placed

    def score_bound(self, bound, X):
        """Score one raw f32 batch on the host tier → the model's
        :class:`ModelOutput` of CPU tensors, the form a card dispatch
        hands its sink. Synchronous — the degraded tier trades latency
        for availability."""
        if getattr(bound, "q", None) is not None:
            raise FallbackUnavailable(
                "the rank wire has no host tier: its kernel is never "
                "replaced by its plain version — escalate instead"
            )
        if not self.serve:
            raise FallbackUnavailable(
                "this tier serves nothing (armed by a DLQ alone; ask "
                "with failover= or FJT_FAILOVER=1)"
            )
        model = getattr(bound, "model", None)
        fn = getattr(model, "_fn", None)
        if fn is None:
            raise FallbackUnavailable(
                f"{type(model).__name__} exposes no lowered function "
                "for the host tier"
            )
        X = np.ascontiguousarray(X, np.float32)
        # f32 path: NaN is the missing convention (cf. block._dispatch_f32)
        M = np.isnan(X)
        if M.any():
            X = np.where(M, 0.0, X).astype(np.float32)
        bs = getattr(model, "batch_size", None)
        if bs is not None and X.shape[0] < bs:
            from flink_jpmml_tpu_torch.compile import prepare

            X, M, _ = prepare.pad_batch(X, M, bs)
        params = self._params_cpu(model)
        with torch.no_grad():
            return fn(params, torch.from_numpy(np.ascontiguousarray(X)),
                      torch.from_numpy(np.ascontiguousarray(M)))


def _to_cpu(obj):
    """A copy of a parameter tree (dicts, lists, tuples, tensors) with
    every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class FailoverPlane:
    """Per-registry bundle: breakers by model key + the fallback tier
    + the recovery ladder's accounting. See module docstring."""

    def __init__(
        self,
        metrics: MetricsRegistry,
        tier: Optional[FallbackTier] = None,
        retries: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        **breaker_kw,
    ):
        self.metrics = metrics
        self.tier = tier if tier is not None else FallbackTier()
        # redispatch attempts per failed batch before the ladder falls
        # through to the fallback tier
        self.retries = (
            retries if retries is not None else env_int(_RETRIES_ENV, 2)
        )
        self._clock = clock
        self._breaker_kw = breaker_kw
        self._mu = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self.fallback_records = metrics.counter("fallback_records")
        self.redispatch_records = metrics.counter("redispatch_records")
        self.oom_shrinks = metrics.counter("oom_shrinks")
        self._last_fallback_event = 0.0

    # -- breakers ----------------------------------------------------------

    def breaker_for(self, key: Optional[str]) -> CircuitBreaker:
        key = key or "default"
        b = self._breakers.get(key)
        if b is None:
            with self._mu:
                b = self._breakers.get(key)
                if b is None:
                    b = CircuitBreaker(
                        self.metrics, key=key, clock=self._clock,
                        **self._breaker_kw,
                    )
                    self._breakers[key] = b
        return b

    def breakers(self) -> Dict[str, CircuitBreaker]:
        with self._mu:
            return dict(self._breakers)

    def record_success(self, key: Optional[str]) -> None:
        """Steady-state per-completion feed: a dict miss (no breaker
        ever created — no fault ever seen) is the whole cost."""
        b = self._breakers.get(key or "default")
        if b is not None:
            b.record_success()

    def should_fallback(self, key: Optional[str], bound) -> bool:
        """True when this model's circuit is OPEN (cooldown not yet
        elapsed) AND the fallback tier can actually serve the handle —
        an unsupported handle keeps dispatching (each failure
        re-ladders) rather than silently dropping to nothing."""
        b = self._breakers.get(key or "default")
        if b is None or b.allow_dispatch():
            return False
        return self.tier.supports(bound)

    # -- accounting --------------------------------------------------------

    def note_fault(self, kind: str, key=None, first_off=None, n=None,
                   error=None) -> None:
        from flink_jpmml_tpu_torch.runtime import devfault

        devfault.note(
            self.metrics, kind, model=key, first_off=first_off, n=n,
            error=error,
        )

    def note_fallback(self, n: int, key=None) -> None:
        self.fallback_records.inc(n)
        now = self._clock()
        due = False
        with self._mu:
            if (
                now - self._last_fallback_event
                >= _FALLBACK_EVENT_MIN_PERIOD_S
            ):
                self._last_fallback_event = now
                due = True
        if due:  # rate-limited: an outage serves MANY fallback batches
            flight.record("fallback_serving", model=key, records=n)


# -- per-registry singletons (the obs/attr.py discipline) --------------------

_PLANES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_planes_mu = threading.Lock()


def plane_for(metrics: Optional[MetricsRegistry],
              serve: bool = True) -> Optional[FailoverPlane]:
    """The registry's failover plane, created on first use (every
    pipeline sharing a registry shares one set of breakers — a sick
    device is sick for all of them). None for a None registry.
    ``serve``: whether its tier may serve f32 models on the host — the
    caller asked (``FJT_FAILOVER=1``); a plane armed by a DLQ alone
    passes False. Once any pipeline of the registry asked, the tier
    serves for all of them."""
    if metrics is None:
        return None
    plane = _PLANES.get(metrics)
    if plane is None:
        with _planes_mu:
            plane = _PLANES.get(metrics)
            if plane is None:
                plane = FailoverPlane(metrics, tier=FallbackTier(serve))
                _PLANES[metrics] = plane
    if serve and not plane.tier.serve:
        plane.tier.serve = True
    return plane


# -- operator summary (fjt-top --failover) -----------------------------------


def state_name(value: float) -> str:
    return _STATE_NAMES.get(float(value), f"?{value}")


def summary(struct: dict) -> Optional[dict]:
    """Failover-plane summary from a metrics struct (``fjt-top
    --failover``, bench artifacts): circuit state per model, fallback
    share of delivered records, redispatch/OOM-shrink counts, the
    device-fault taxonomy totals, and the checkpoint-suspension flag.
    None when the struct carries no failover telemetry at all."""
    gauges = struct.get("gauges") or {}
    counters = struct.get("counters") or {}

    def g(name):
        v = gauges.get(name)
        return v.get("value") if isinstance(v, dict) else None

    states: Dict[str, float] = {}
    for name, v in gauges.items():
        m = re.match(r'^failover_state\{model="([^"]+)"\}$', name)
        if m and isinstance(v, dict):
            states[m.group(1)] = float(v.get("value") or 0.0)
    faults_by_kind: Dict[str, float] = {}
    for name, v in counters.items():
        m = re.match(r'^device_fault_total\{kind="([^"]+)"\}$', name)
        if m:
            faults_by_kind[m.group(1)] = v
    out: dict = {}
    if states:
        out["states"] = {
            k: state_name(s) for k, s in sorted(states.items())
        }
    if faults_by_kind:
        out["device_faults"] = faults_by_kind
    for name in ("fallback_records", "redispatch_records", "oom_shrinks"):
        v = counters.get(name)
        if v:
            out[name] = v
    records_out = counters.get("records_out")
    fb = counters.get("fallback_records")
    if fb and records_out:
        out["fallback_share"] = round(float(fb) / float(records_out), 4)
    suspended = g("checkpoint_suspended")
    if suspended:
        out["checkpoint_suspended"] = suspended
    lost = g("mesh_lost_devices")
    if lost:
        out["mesh_lost_devices"] = lost
    return out or None
