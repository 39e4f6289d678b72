"""Deterministic per-key traffic assignment for canary splits.

A copy of ``flink_jpmml_tpu/rollout/split.py`` with the import lines
renamed; nothing else differs. The staged-rollout controller that reads
it is not ported yet (ROADMAP Queue 1 item 7); the mesh hot path's
canary-per-shard contract (``assign_candidate`` is key-pure) holds on
its own.

The split must satisfy two properties the reference's atomic flip never
needed:

- **per-key stability** — every record with the same routing key takes
  the same side of the split, across processes, restarts, and replays
  (C7: a restored pipeline re-scores its uncommitted tail; those
  records must route exactly as they did the first time). So the
  assignment is a pure function of (name, candidate version, key) via
  :func:`~flink_jpmml_tpu_torch.parallel.partitioner.stable_hash` — the same
  deterministic CRC the keyed-stream partitioner uses, never Python's
  seeded ``hash()``.
- **version-salted** — the hash is salted with the candidate version so
  consecutive rollouts of one name canary *different* key populations;
  a key that straddled the boundary once doesn't straddle it forever.

Records without an explicit key derive one from their content
(:func:`record_key`), which is equally replay-stable because the
replayed record's content is identical.
"""

from __future__ import annotations

from typing import Any

from flink_jpmml_tpu_torch.parallel.partitioner import stable_hash

# granularity of the split: fractions quantize to 0.01% — fine enough
# for the bench drill's ±1% ratio assertion at modest record counts
_BUCKETS = 10_000
_CANARY_SALT = "fjt-canary"
_SHADOW_SALT = "fjt-shadow"


def record_key(payload: Any) -> Any:
    """Replay-stable routing key for an event payload.

    Dict records use their ``"_key"`` field when present (the explicit
    keyed-stream contract); otherwise the key is a canonicalized view of
    the content — sorted items for dicts, a tuple for vectors — so two
    replays of the same record always agree. Callers with real session/
    user keys should pass a ``key_fn`` instead of relying on content
    addressing (two users with identical features would share a lane).
    """
    if isinstance(payload, dict):
        if "_key" in payload:
            return str(payload["_key"])
        return tuple(
            (str(k), _scalar(v)) for k, v in sorted(payload.items())
        )
    if isinstance(payload, (list, tuple)):
        return tuple(_scalar(v) for v in payload)
    tolist = getattr(payload, "tolist", None)
    if tolist is not None:  # numpy vector
        return record_key(tolist())
    return _scalar(payload)


def _scalar(v: Any) -> Any:
    if isinstance(v, (str, bytes, bool, int, float)):
        return v
    if isinstance(v, (list, tuple)):
        return tuple(_scalar(x) for x in v)
    return repr(v)


def _bucket(salt: str, name: str, version: int, key: Any) -> int:
    return stable_hash((salt, name, version, record_key(key))) % _BUCKETS


def assign_candidate(
    name: str, candidate_version: int, fraction: float, key: Any
) -> bool:
    """True iff ``key`` routes to the candidate under a canary split of
    ``fraction`` — stable per key, monotone in ``fraction`` (growing the
    canary never reassigns a key already on the candidate back to the
    incumbent)."""
    return _bucket(_CANARY_SALT, name, candidate_version, key) < int(
        round(fraction * _BUCKETS)
    )


def sample_shadow(
    name: str, candidate_version: int, sample: float, key: Any
) -> bool:
    """True iff ``key``'s event is mirrored to the candidate for shadow
    diffing. Salted independently of :func:`assign_candidate` so the
    shadow sample is not just a prefix of the future canary population."""
    return _bucket(_SHADOW_SALT, name, candidate_version, key) < int(
        round(sample * _BUCKETS)
    )
