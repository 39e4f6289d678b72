"""Rollout control plane: staged deployment for dynamically served models.

The port's copy of ``flink_jpmml_tpu/rollout/__init__.py``: the state,
the split and the guardrail controller are all ported; the controller's
fleet binding to the supervisor's heartbeat channel is not (no
supervisor in the port yet), nor the ``fjt-rollout`` CLI. The exports
below resolve on first use: ``models/control`` imports ``rollout.state``
while the compiler is still loading, and the controller and the split
reach back into it.

The reference system flips 100% of a name's traffic to a new version
the moment an ``AddMessage``'s document warms. This package interposes
a guarded lifecycle — shadow scoring, deterministic canary splits, and
guardrail-driven auto-promotion/rollback — on top of the existing
registry/control-stream machinery:

- :mod:`~flink_jpmml_tpu_torch.rollout.state` — stages, guardrail specs, and
  the pure transition function shared by the registry and the fleet
  book (checkpoint-shaped: a restore mid-canary resumes the stage).
- :mod:`~flink_jpmml_tpu_torch.rollout.split` — replay-stable per-key hash
  assignment (canary side + shadow sampling).
- :mod:`~flink_jpmml_tpu_torch.rollout.controller` — the sliding-window
  guardrail loop that turns the obs structs into promote/rollback
  decisions, locally or fleet-wide via the supervisor's heartbeat
  control channel.

Entry points: push a :class:`~flink_jpmml_tpu_torch.models.control
.RolloutMessage` on the control stream (the ``fjt-rollout`` CLI writes
the wire form), and the :class:`~flink_jpmml_tpu_torch.serving.scorer
.DynamicScorer` does the rest. See docs/operations.md §Rollouts.
"""

import importlib

_EXPORTS = {
    "RolloutBook": "controller",
    "RolloutController": "controller",
    "labelled": "controller",
    "assign_candidate": "split",
    "record_key": "split",
    "sample_shadow": "split",
    "ACTIVE_STAGES": "state",
    "STAGE_CANARY": "state",
    "STAGE_FULL": "state",
    "STAGE_ROLLBACK": "state",
    "STAGE_SHADOW": "state",
    "STAGES": "state",
    "GuardrailSpec": "state",
    "RolloutState": "state",
    "apply_rollout": "state",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
