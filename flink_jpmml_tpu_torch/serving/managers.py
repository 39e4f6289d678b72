"""Metadata managers: pure application of control messages to the served map.

The port's copy of ``flink_jpmml_tpu/serving/managers.py``, with the
import lines renamed.

Reference parity: the ``…/api/managers/`` typeclass-style managers
(SURVEY.md §3 row C3 [UNVERIFIED]) — pure functions from (metadata, message)
to metadata, kept separate from the operator so they unit-test in isolation
(reference test strategy, SURVEY.md §5 "manager specs for Add/Del metadata
application").

Semantics:
- ``AddMessage`` is idempotent: re-adding a served (name, version) with the
  same path is a no-op; with a *different* path it is ignored (versions are
  immutable — publish a new version instead).
- ``DelMessage`` for an unknown model is a no-op.
"""

from __future__ import annotations

from typing import Dict, Tuple

from flink_jpmml_tpu_torch.models.control import AddMessage, DelMessage, ServingMessage
from flink_jpmml_tpu_torch.models.core import ModelId, ModelInfo

Metadata = Dict[ModelId, ModelInfo]


def apply_message(meta: Metadata, msg: ServingMessage) -> Tuple[Metadata, bool]:
    """→ (new metadata, changed?). Never mutates the input map."""
    if isinstance(msg, AddMessage):
        return add(meta, msg)
    if isinstance(msg, DelMessage):
        return delete(meta, msg)
    raise TypeError(f"not a serving message: {type(msg).__name__}")


def add(meta: Metadata, msg: AddMessage) -> Tuple[Metadata, bool]:
    mid = msg.model_id
    existing = meta.get(mid)
    if existing is not None:
        return meta, False  # versions are immutable
    out = dict(meta)
    out[mid] = ModelInfo(path=msg.path)
    return out, True


def delete(meta: Metadata, msg: DelMessage) -> Tuple[Metadata, bool]:
    mid = msg.model_id
    if mid not in meta:
        return meta, False
    out = dict(meta)
    del out[mid]
    return out, True


def latest_version(meta: Metadata, name: str) -> int:
    """Highest served version of ``name`` (−1 if none)."""
    versions = [mid.version for mid in meta if mid.name == name]
    return max(versions) if versions else -1
