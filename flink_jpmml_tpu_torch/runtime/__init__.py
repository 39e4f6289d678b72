"""Streaming runtime of the port: the overlapped CUDA dispatch window
(``pipeline.py``), the block pipeline (``block.py``), the record engine
(``engine.py``) with its queue, sources and sinks, and the worker
supervisor (``supervisor.py``: restart-from-checkpoint, the fleet
``/metrics`` view and the rollout broadcast).

The exports are the JAX package's ``runtime/__init__.py``'s. They
resolve on first use: the compiler imports ``runtime.native`` while it
is still loading, and the engine reaches back into the compiler."""

import importlib

_EXPORTS = {
    "Pipeline": "engine",
    "Scorer": "engine",
    "StaticScorer": "engine",
    "OverlappedDispatcher": "pipeline",
    "CheckpointManager": "checkpoint",
    "BoundedQueue": "queues",
    "Closed": "queues",
    "BlockFrameServer": "net",
    "TcpBlockSource": "net",
    "TcpRecordSource": "net",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
