"""Capped exponential backoff with full jitter — the shared retry cadence.

The port's copy of ``flink_jpmml_tpu/utils/retry.py``, with the import
lines renamed and its notes on the project's history cut. ``env_float``
and ``env_int`` are copied as they are. The JAX
package's ``FJT_RETRY_BASE_S`` / ``FJT_RETRY_CAP_S`` / ``FJT_RETRY_MAX``
overrides are left out: the caller's values (defaults 0.05 s, 5 s and 8
attempts, the JAX package's) hold.

Fixed retry cadences are a hazard: N consumers of a dead broker that
each sleep a constant ``reconnect_backoff_s`` retry in lockstep, a
reconnect storm the instant it heals; a checkpoint write with no retry
loses the snapshot cadence to one transient OSError. The kafka reconnect
and the checkpoint writes share this helper:

    delay_k = uniform(0, min(cap, base * 2**k))

— the classic *full jitter* schedule: exponential growth bounds the
pressure a dead dependency sees, the jitter decorrelates a fleet's
retries, the cap bounds the worst-case wait.

Crossing ``max_attempts`` records ONE ``retry_give_up`` flight event per streak
(and a ``retry_give_ups`` counter when a registry is attached); what
"give up" means stays the caller's policy — a streaming consumer keeps
retrying at the cap (degrade loudly, never die silently), a checkpoint
write raises. The current delay is exported as the
``reconnect_backoff_s`` gauge (fleet merge: worst-of) so an operator
can see which worker is deep in a retry streak.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional

from flink_jpmml_tpu_torch.obs import recorder as flight

def env_float(name: str, fallback: float) -> float:
    """Positive-float env knob with a silent fallback (the FJT_* knob
    convention; the failover plane's thresholds read it)."""
    raw = os.environ.get(name)
    if not raw:
        return fallback
    try:
        v = float(raw)
    except ValueError:
        return fallback
    return v if v > 0 else fallback


def env_int(name: str, fallback: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return fallback
    try:
        v = int(raw)
    except ValueError:
        return fallback
    return v if v > 0 else fallback


_DEFAULT_BASE_S = 0.05
_DEFAULT_CAP_S = 5.0
_DEFAULT_MAX = 8


def full_jitter(
    base_s: float,
    cap_s: float,
    attempt: int,
    rng: Callable[[], float] = random.random,
    growth: float = 2.0,
) -> float:
    """One full-jitter delay draw: ``uniform(0, min(cap, base·g^k))``
    for 0-based ``attempt`` k — THE retry schedule, shared by kafka
    reconnects, checkpoint write retries (:class:`Backoff`), and the
    supervisor's worker-restart backoff
    (``runtime/supervisor.RestartPolicy``, which feeds its configured
    multiplier through ``growth``; g ≤ 1 pins the ceiling at the
    base — a fixed-delay policy keeps its ceiling, jittered). The
    exponent clamp keeps an overnight outage's attempt count from
    overflowing the pow."""
    g = growth if growth > 1.0 else 1.0
    ceiling = min(cap_s, base_s * (g ** min(max(attempt, 0), 63)))
    return rng() * ceiling


class Backoff:
    """One retry *streak*'s state: consecutive failures, the jittered
    delay schedule, and the give-up signal.

    ``what`` labels flight events (``"kafka"``, ``"checkpoint"``);
    ``base_s``/``cap_s``/``max_attempts`` are the schedule. ``metrics`` (optional)
    exports the current delay as ``reconnect_backoff_s`` and counts
    ``retry_give_ups``. Call :meth:`reset` on success — it closes the
    streak and re-arms the give-up event."""

    def __init__(
        self,
        what: str,
        base_s: float = _DEFAULT_BASE_S,
        cap_s: float = _DEFAULT_CAP_S,
        max_attempts: int = _DEFAULT_MAX,
        metrics=None,
        rng: Optional[Callable[[], float]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._what = what
        self.base_s = base_s
        self.cap_s = max(cap_s, base_s)
        self.max_attempts = max_attempts
        self._rng = rng if rng is not None else random.random
        self._sleep = sleep
        self._attempts = 0
        self._gave_up = False
        self._gauge = (
            metrics.gauge("reconnect_backoff_s")
            if metrics is not None else None
        )
        self._give_ups = (
            metrics.counter("retry_give_ups")
            if metrics is not None else None
        )

    @property
    def attempts(self) -> int:
        return self._attempts

    @property
    def exhausted(self) -> bool:
        """True once the streak has crossed ``max_attempts`` — the
        caller's abort signal when it has one (checkpoint writes); loop
        callers ignore it and keep paying the capped delay."""
        return self._attempts >= self.max_attempts

    def next_delay(self) -> float:
        """Advance the streak and return the next jittered delay."""
        delay = full_jitter(
            self.base_s, self.cap_s, self._attempts, self._rng
        )
        self._attempts += 1
        if self._gauge is not None:
            self._gauge.set(round(delay, 6))
        if self._attempts >= self.max_attempts and not self._gave_up:
            # once per streak: the loud marker that this dependency has
            # been down past the whole schedule, not a per-retry spam
            self._gave_up = True
            if self._give_ups is not None:
                self._give_ups.inc()
            flight.record(
                "retry_give_up",
                what=self._what,
                attempts=self._attempts,
                cap_s=self.cap_s,
            )
        return delay

    def sleep(self) -> float:
        """Advance the streak and sleep the jittered delay; → the delay."""
        delay = self.next_delay()
        if delay > 0:
            self._sleep(delay)
        return delay

    def reset(self) -> None:
        """Success: close the streak (delay schedule and give-up event
        both re-arm; the exported gauge drops to 0 — healthy)."""
        if self._attempts == 0:
            return
        self._attempts = 0
        self._gave_up = False
        if self._gauge is not None:
            self._gauge.set(0.0)
