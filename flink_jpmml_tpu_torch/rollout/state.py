"""Rollout lifecycle state: stages, guardrail specs, pure transitions.

The port's copy of ``flink_jpmml_tpu/rollout/state.py``, unchanged: the
control messages carry its ``STAGES`` and ``GuardrailSpec``, and the
registry and the guardrail controller (``rollout/controller.py``) apply
its transitions.

The reference system's control stream flips traffic atomically on
``AddMessage`` — the newest served version takes 100% of events the
moment it warms. A staged rollout interposes a lifecycle between "the
candidate is registered" and "the candidate owns the traffic":

    shadow ──promote──▶ canary(p) ──promote──▶ full
       │                   │
       └────rollback───────┴──▶ candidate removed, incumbent keeps 100%

- **shadow** — the incumbent serves every event; the candidate scores a
  mirrored, sampled copy off the hot path and the outputs are diffed
  (disagreement rate, numeric drift). Nothing the candidate produces
  reaches a sink.
- **canary(p)** — a deterministic per-key hash fraction ``p`` of the
  traffic routes to the candidate; the incumbent serves the rest. The
  split is a pure function of (name, candidate version, record key), so
  a checkpoint replay routes every record identically.
- **full** — the rollout entry clears; the candidate is simply the
  newest served version (the reference's latest-wins routing resumes).
- **rollback** — the candidate is dropped from serving entirely; the
  incumbent keeps 100%. Terminal, like ``full``.

This module is deliberately leaf-level (stdlib only): the control
message (:mod:`flink_jpmml_tpu_torch.models.control`), the registry, and the
guardrail controller all import it, in that order, without cycles. All
state is JSON-shaped for the checkpoint wire (C7): a restore mid-canary
resumes the same stage, fraction, and dwell clock instead of
re-flipping to full.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

STAGE_SHADOW = "shadow"
STAGE_CANARY = "canary"
STAGE_FULL = "full"
STAGE_ROLLBACK = "rollback"

# stages a RolloutMessage may carry; shadow/canary keep an entry alive,
# full/rollback are the two terminal transitions
STAGES = (STAGE_SHADOW, STAGE_CANARY, STAGE_FULL, STAGE_ROLLBACK)
ACTIVE_STAGES = (STAGE_SHADOW, STAGE_CANARY)

# the next stage a healthy candidate promotes into
NEXT_STAGE = {STAGE_SHADOW: STAGE_CANARY, STAGE_CANARY: STAGE_FULL}


@dataclass(frozen=True)
class GuardrailSpec:
    """What "healthy" means for a candidate, and how fast to promote.

    All rates are over the controller's sliding ``window_s``; a verdict
    (either direction) requires at least ``min_samples`` observations of
    the relevant signal in the window — a guardrail must not fire, nor a
    promotion clear, on three records' worth of noise.
    """

    # rollback when shadow-diff disagreements exceed this rate
    max_disagree_rate: float = 0.02
    # rollback when candidate p99 latency exceeds incumbent p99 × this
    max_latency_ratio: float = 2.0
    # rollback when candidate dispatch/decode errors exceed this rate
    max_error_rate: float = 0.0
    # prediction-drift guardrails (obs/drift.py PSI of the candidate's
    # windowed score distribution against the incumbent's, both sides
    # past min_samples): above ``hold`` the controller withholds
    # promotion even after the dwell (the candidate keeps proving
    # itself); above ``max`` it rolls back. None disables each;
    # ``hold`` unset with ``max`` set defaults to half of ``max``.
    max_prediction_psi: Optional[float] = None
    hold_prediction_psi: Optional[float] = None
    # observations required in-window before any verdict counts
    min_samples: int = 100
    # healthy dwell at a stage before the controller promotes
    promote_after_s: float = 30.0
    # sliding evaluation window
    window_s: float = 10.0
    # traffic share the canary stage starts with
    canary_fraction: float = 0.1
    # fraction of incumbent traffic mirrored to the candidate for diffing
    shadow_sample: float = 1.0

    def __post_init__(self) -> None:
        if not (0.0 <= self.max_disagree_rate <= 1.0):
            raise ValueError(
                f"max_disagree_rate must be in [0, 1]: {self.max_disagree_rate}"
            )
        if self.max_latency_ratio <= 0:
            raise ValueError(
                f"max_latency_ratio must be > 0: {self.max_latency_ratio}"
            )
        if not (0.0 <= self.max_error_rate <= 1.0):
            raise ValueError(
                f"max_error_rate must be in [0, 1]: {self.max_error_rate}"
            )
        for f_name in ("max_prediction_psi", "hold_prediction_psi"):
            v = getattr(self, f_name)
            if v is not None and v <= 0:
                raise ValueError(f"{f_name} must be > 0: {v}")
        if (
            self.max_prediction_psi is not None
            and self.hold_prediction_psi is not None
            and self.hold_prediction_psi > self.max_prediction_psi
        ):
            raise ValueError(
                "hold_prediction_psi must not exceed max_prediction_psi: "
                f"{self.hold_prediction_psi} > {self.max_prediction_psi}"
            )
        if self.min_samples < 1:
            raise ValueError(f"min_samples must be >= 1: {self.min_samples}")
        if not (0.0 < self.canary_fraction <= 1.0):
            raise ValueError(
                f"canary_fraction must be in (0, 1]: {self.canary_fraction}"
            )
        if not (0.0 < self.shadow_sample <= 1.0):
            raise ValueError(
                f"shadow_sample must be in (0, 1]: {self.shadow_sample}"
            )

    @property
    def effective_hold_psi(self) -> Optional[float]:
        """The promotion-hold threshold actually enforced: the explicit
        ``hold_prediction_psi``, else half the rollback threshold when
        only ``max_prediction_psi`` is set, else None (disabled)."""
        if self.hold_prediction_psi is not None:
            return self.hold_prediction_psi
        if self.max_prediction_psi is not None:
            return self.max_prediction_psi / 2.0
        return None

    def as_dict(self) -> dict:
        out = {
            "max_disagree_rate": self.max_disagree_rate,
            "max_latency_ratio": self.max_latency_ratio,
            "max_error_rate": self.max_error_rate,
            "min_samples": self.min_samples,
            "promote_after_s": self.promote_after_s,
            "window_s": self.window_s,
            "canary_fraction": self.canary_fraction,
            "shadow_sample": self.shadow_sample,
        }
        # absent unless configured: the wire form (checkpoints, control
        # frames) stays byte-compatible with pre-drift readers
        if self.max_prediction_psi is not None:
            out["max_prediction_psi"] = self.max_prediction_psi
        if self.hold_prediction_psi is not None:
            out["hold_prediction_psi"] = self.hold_prediction_psi
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "GuardrailSpec":
        base = cls()
        kw = {}
        for f_name, conv in (
            ("max_disagree_rate", float),
            ("max_latency_ratio", float),
            ("max_error_rate", float),
            ("min_samples", int),
            ("promote_after_s", float),
            ("window_s", float),
            ("canary_fraction", float),
            ("shadow_sample", float),
            ("max_prediction_psi", float),
            ("hold_prediction_psi", float),
        ):
            if f_name in d and d[f_name] is not None:
                kw[f_name] = conv(d[f_name])
        return replace(base, **kw)


@dataclass(frozen=True)
class RolloutState:
    """One name's in-progress rollout (absent = normal latest-wins).

    ``stage_since`` is wall-clock (``time.time()``) so the promotion
    dwell survives checkpoint/restore across processes; a restore
    mid-canary therefore resumes the dwell, it does not restart it.
    """

    name: str
    candidate_version: int
    stage: str
    fraction: float
    spec: GuardrailSpec = field(default_factory=GuardrailSpec)
    stage_since: float = 0.0

    def __post_init__(self) -> None:
        if self.stage not in ACTIVE_STAGES:
            raise ValueError(
                f"a stored rollout stage must be one of {ACTIVE_STAGES}: "
                f"{self.stage!r}"
            )
        if not (0.0 < self.fraction <= 1.0):
            raise ValueError(
                f"rollout fraction must be in (0, 1]: {self.fraction}"
            )

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "candidate_version": self.candidate_version,
            "stage": self.stage,
            "fraction": self.fraction,
            "spec": self.spec.as_dict(),
            "stage_since": self.stage_since,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RolloutState":
        return cls(
            name=str(d["name"]),
            candidate_version=int(d["candidate_version"]),
            stage=str(d["stage"]),
            fraction=float(d["fraction"]),
            spec=GuardrailSpec.from_dict(d.get("spec") or {}),
            stage_since=float(d.get("stage_since", 0.0)),
        )


def apply_rollout(
    states: Dict[str, RolloutState], msg
) -> Tuple[Dict[str, RolloutState], bool]:
    """Pure transition: (rollout map, RolloutMessage) → (new map, changed).

    Shared by the registry (which adds the serving-metadata side
    effects) and the supervisor-side fleet book, so local and fleet
    rollout state machines cannot drift. Never mutates the input.

    Semantics:
    - ``shadow``/``canary`` upsert the entry. A stage *change* resets the
      dwell clock; re-sending the current stage updates fraction/spec in
      place (dwell preserved) — the knob-turn case.
    - ``full``/``rollback`` drop the entry (terminal). A terminal message
      for a version that is not the tracked candidate is a no-op: a
      replayed decision must not cancel a newer rollout.
    """
    cur = states.get(msg.name)
    if msg.stage in ACTIVE_STAGES:
        spec = msg.guardrails or (
            cur.spec if cur is not None and cur.candidate_version == msg.version
            else GuardrailSpec()
        )
        if msg.fraction is not None:
            fraction = msg.fraction
        elif msg.stage == STAGE_CANARY:
            fraction = spec.canary_fraction
        else:
            fraction = 1.0  # shadow mirrors per spec.shadow_sample, not this
        same = (
            cur is not None
            and cur.candidate_version == msg.version
            and cur.stage == msg.stage
        )
        new = RolloutState(
            name=msg.name,
            candidate_version=msg.version,
            stage=msg.stage,
            fraction=fraction,
            spec=spec,
            stage_since=(
                cur.stage_since if same else (msg.timestamp or time.time())
            ),
        )
        if cur == new:
            return states, False
        out = dict(states)
        out[msg.name] = new
        return out, True
    # terminal: full / rollback
    if cur is None or cur.candidate_version != msg.version:
        return states, False
    out = dict(states)
    del out[msg.name]
    return out, True


def incumbent_version(
    served_versions, state: Optional[RolloutState]
) -> int:
    """Newest served version excluding an active rollout's candidate
    (−1 if none): the version latest-wins routing should serve while
    the candidate is still proving itself."""
    cand = state.candidate_version if state is not None else None
    versions = [v for v in served_versions if v != cand]
    return max(versions) if versions else -1
