"""Control-stream protocol for dynamic model serving (capability C6).

The port's copy of ``flink_jpmml_tpu/models/control.py``, with the import
lines renamed. The port's registry applies a ``RolloutMessage`` as the JAX
registry does, and the dynamic scorer and its guardrail controller
(``rollout/controller.py``) act on it.

Reference parity: ``ServingMessage`` / ``AddMessage`` / ``DelMessage`` in the
reference's ``…/models/control/`` (SURVEY.md §3 row C2, §4.3 [UNVERIFIED]).
A control stream of these messages is joined with the event stream; the
registry applies them in timestamp order (see
:mod:`flink_jpmml_tpu_torch.serving.managers`).

:class:`RolloutMessage` extends the protocol with staged deployment
(see :mod:`flink_jpmml_tpu_torch.rollout`): instead of the Add-then-flip
atomic swap, a candidate version moves through shadow → canary(p) →
full under guardrails, or is rolled back. The registry applies rollout
messages like any other control message, so they ride the same control
stream, the same checkpointed state, and the same fleet broadcast path.

:func:`to_wire` / :func:`from_wire` are the JSON wire form — what the
``fjt-rollout`` CLI appends to a JSONL control file and what the
supervisor's heartbeat control channel broadcasts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from flink_jpmml_tpu_torch.models.core import ModelId
from flink_jpmml_tpu_torch.rollout.state import STAGES, GuardrailSpec


@dataclass(frozen=True)
class AddMessage:
    """Start serving ``(name, version)`` from the PMML document at ``path``."""

    name: str
    version: int
    path: str
    timestamp: float

    def __post_init__(self) -> None:
        # Validate eagerly so a bad message fails at the producer, not later
        # inside the registry apply step.
        ModelId(self.name, self.version)

    @property
    def model_id(self) -> ModelId:
        return ModelId(self.name, self.version)


@dataclass(frozen=True)
class DelMessage:
    """Stop serving ``(name, version)``."""

    name: str
    version: int
    timestamp: float

    def __post_init__(self) -> None:
        ModelId(self.name, self.version)

    @property
    def model_id(self) -> ModelId:
        return ModelId(self.name, self.version)


@dataclass(frozen=True)
class RolloutMessage:
    """Move ``(name, version)`` to a rollout ``stage``.

    - ``stage="shadow"`` / ``"canary"`` — start or advance a staged
      rollout of the candidate version. ``path`` (optional) registers
      the candidate in the same message (an Add folded in); without it
      the version must already be served. ``fraction`` overrides the
      canary traffic share (else ``guardrails.canary_fraction``);
      ``guardrails`` carries the health spec the controller enforces.
    - ``stage="full"`` — promote: the rollout entry clears and the
      candidate becomes the newest served version (latest-wins resumes).
    - ``stage="rollback"`` — abort: the candidate is dropped from
      serving; the incumbent keeps 100% of traffic.
    """

    name: str
    version: int
    stage: str
    timestamp: float
    path: Optional[str] = None
    fraction: Optional[float] = None
    guardrails: Optional[GuardrailSpec] = None

    def __post_init__(self) -> None:
        ModelId(self.name, self.version)
        if self.stage not in STAGES:
            raise ValueError(
                f"rollout stage must be one of {STAGES}: {self.stage!r}"
            )
        if self.fraction is not None and not (0.0 < self.fraction <= 1.0):
            raise ValueError(
                f"rollout fraction must be in (0, 1]: {self.fraction}"
            )

    @property
    def model_id(self) -> ModelId:
        return ModelId(self.name, self.version)


ServingMessage = Union[AddMessage, DelMessage, RolloutMessage]


# -- JSON wire form (CLI control files, heartbeat control broadcast) -------

def to_wire(msg: ServingMessage) -> dict:
    """Serving message → JSON-shaped dict (inverse of :func:`from_wire`)."""
    if isinstance(msg, AddMessage):
        return {
            "kind": "add", "name": msg.name, "version": msg.version,
            "path": msg.path, "timestamp": msg.timestamp,
        }
    if isinstance(msg, DelMessage):
        return {
            "kind": "del", "name": msg.name, "version": msg.version,
            "timestamp": msg.timestamp,
        }
    if isinstance(msg, RolloutMessage):
        out = {
            "kind": "rollout", "name": msg.name, "version": msg.version,
            "stage": msg.stage, "timestamp": msg.timestamp,
        }
        if msg.path is not None:
            out["path"] = msg.path
        if msg.fraction is not None:
            out["fraction"] = msg.fraction
        if msg.guardrails is not None:
            out["guardrails"] = msg.guardrails.as_dict()
        return out
    raise TypeError(f"not a serving message: {type(msg).__name__}")


def from_wire(d: dict) -> ServingMessage:
    """JSON-shaped dict → serving message; raises ``ValueError`` on a
    malformed frame (callers on untrusted feeds decide whether a bad
    frame poisons the stream or is skipped loudly)."""
    try:
        kind = d["kind"]
        if kind == "add":
            return AddMessage(
                name=str(d["name"]), version=int(d["version"]),
                path=str(d["path"]), timestamp=float(d["timestamp"]),
            )
        if kind == "del":
            return DelMessage(
                name=str(d["name"]), version=int(d["version"]),
                timestamp=float(d["timestamp"]),
            )
        if kind == "rollout":
            g = d.get("guardrails")
            return RolloutMessage(
                name=str(d["name"]), version=int(d["version"]),
                stage=str(d["stage"]), timestamp=float(d["timestamp"]),
                path=(str(d["path"]) if d.get("path") is not None else None),
                fraction=(
                    float(d["fraction"])
                    if d.get("fraction") is not None else None
                ),
                guardrails=(
                    GuardrailSpec.from_dict(g) if isinstance(g, dict) else None
                ),
            )
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed control frame {d!r}: {e}") from e
    raise ValueError(f"unknown control frame kind {d.get('kind')!r}")
