"""Record trace contexts: deterministic trace ids for stream offsets.

The port's copy of the context helpers of ``flink_jpmml_tpu/obs/trace.py``
(``trace_id_for``, ``TraceContext``, ``context_for``), with the import
lines renamed. The rest of that module — the thread's active context
(``current`` / ``use``), the W3C ``traceparent`` form, the
``JourneyStore`` that persists record journeys, ``install`` /
``store_for`` and the read side — waits for the journey-tracing slice:
nothing in the port arms a journey store yet. Today a context names the
record in the Kafka source's ``decode_error`` flight event and in the
envelope it hands a DLQ.

:func:`trace_id_for` derives a record's trace id purely from its stream
offset, so two incarnations of the same worker mint the SAME id for the
same record with zero coordination.
"""

from __future__ import annotations

import os
import threading
from hashlib import blake2s
from typing import Optional

_span_lock = threading.Lock()
_span_seq = 0


def _new_span_id() -> str:
    """64-bit span id: pid + monotone sequence, hex-packed — unique
    within a deployment without an os.urandom call per batch."""
    global _span_seq
    with _span_lock:
        _span_seq += 1
        seq = _span_seq
    return f"{(os.getpid() & 0xFFFFFF):06x}{(seq & 0xFFFFFFFFFF):010x}"


def trace_id_for(offset: int) -> str:
    """Deterministic 128-bit trace id for stream offset ``offset``:
    every process (and every incarnation) derives the SAME id for the
    same record with zero coordination."""
    return blake2s(b"fjt-off:%d" % int(offset), digest_size=16).hexdigest()


class TraceContext:
    """One hop's causal coordinates: ``trace_id`` names the journey,
    ``span_id`` this hop, ``parent_id`` the hop that caused it."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(
        self,
        trace_id: str,
        span_id: Optional[str] = None,
        parent_id: Optional[str] = None,
    ):
        self.trace_id = trace_id
        self.span_id = span_id if span_id is not None else _new_span_id()
        self.parent_id = parent_id

    def child(self) -> "TraceContext":
        """A child span in the same journey (parent = this hop)."""
        return TraceContext(self.trace_id, parent_id=self.span_id)


def context_for(offset: int) -> TraceContext:
    """A fresh span in the deterministic journey of ``offset``."""
    return TraceContext(trace_id_for(offset))
