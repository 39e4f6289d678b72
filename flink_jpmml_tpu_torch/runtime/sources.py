"""Stream sources: pluggable record producers with restartable offsets.

The port's copy of ``flink_jpmml_tpu/runtime/sources.py``, unchanged.

Reference parity: Flink sources (``fromCollection``, Kafka connectors, …)
feeding the evaluation operator (SURVEY.md §4.1, §8 step 3). Every source
exposes a monotonically increasing *offset* so checkpoints can record "scored
up to here" and resume exactly (capability C7 — the reference inherited this
from Flink's source-offset checkpoints).

A record can be anything the pipeline's extractor understands: a dict of
field→value, a numpy vector, or an arbitrary event object.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, List, Sequence, Tuple

Record = Any
# poll() → list of (offset, record); offset is the position *after* the record
Polled = List[Tuple[int, Record]]


class Source:
    """Protocol: poll records in offset order; seek for resume.

    ``event_time_fn`` (optional): ``record -> unix seconds`` (or None
    for a record with no event time). Sources that know their records'
    *event* time set it so the engine can stamp batches for the
    freshness plane (obs/freshness.py) — watermarks and the
    ``record_staleness_s`` books; the Kafka sources carry event time in
    the wire batches themselves and need no extractor."""

    event_time_fn = None

    def poll(self, max_n: int) -> Polled:
        raise NotImplementedError

    def seek(self, offset: int) -> None:
        raise NotImplementedError

    @property
    def exhausted(self) -> bool:
        return False

    def close(self) -> None:
        pass


def batch_event_range(records, event_time_fn):
    """min/max event time over a batch of records → (min_ts, max_ts) or
    None when no record carries one. Out-of-order event times within
    the batch are exactly what the min/max pair absorbs — the watermark
    consumer (``FreshnessTracker``) only ever advances monotonically."""
    if event_time_fn is None:
        return None
    lo = hi = None
    for rec in records:
        try:
            ts = event_time_fn(rec)
        except Exception:
            continue  # a malformed record never poisons the stamp
        if ts is None or ts <= 0:
            continue
        ts = float(ts)
        lo = ts if lo is None else min(lo, ts)
        hi = ts if hi is None else max(hi, ts)
    return None if hi is None else (lo, hi)


class InMemorySource(Source):
    """Replayable in-memory record list (the MiniCluster-test equivalent,
    SURVEY.md §5); optionally cycles forever for throughput benchmarking."""

    def __init__(self, records: Sequence[Record], cycle: bool = False,
                 event_time_fn=None):
        self._records = list(records)
        self._pos = 0
        self._cycle = cycle
        self.event_time_fn = event_time_fn

    def poll(self, max_n: int) -> Polled:
        n = len(self._records)
        if n == 0:
            return []
        out: Polled = []
        while len(out) < max_n:
            if self._pos >= n:
                if not self._cycle:
                    break
                self._pos = 0
            out.append((self._pos + 1, self._records[self._pos]))
            self._pos += 1
        return out

    def seek(self, offset: int) -> None:
        self._pos = offset % max(len(self._records), 1) if self._cycle else offset

    @property
    def exhausted(self) -> bool:
        return not self._cycle and self._pos >= len(self._records)


class GeneratorSource(Source):
    """Wraps a callable ``f(n) -> list[Record]`` (unbounded synthetic load).

    Offsets count records produced; ``seek`` just fast-forwards the counter
    (synthetic sources are stateless by construction).
    """

    def __init__(self, fn: Callable[[int], Sequence[Record]],
                 event_time_fn=None):
        self._fn = fn
        self._offset = 0
        self.event_time_fn = event_time_fn

    def poll(self, max_n: int) -> Polled:
        recs = self._fn(max_n)
        out = []
        for r in recs:
            self._offset += 1
            out.append((self._offset, r))
        return out

    def seek(self, offset: int) -> None:
        self._offset = offset


class JsonlFileSource(Source):
    """Tails a JSONL file: each line is one dict record; offset = byte
    position after the last consumed line (exact resume after restart).

    ``follow=True`` keeps polling for appended lines (Kafka-less streaming
    ingestion for a single-host deployment)."""

    def __init__(self, path: str, follow: bool = False,
                 event_time_fn=None):
        self._path = path
        self._f = open(path, "r", encoding="utf-8")
        self._follow = follow
        self._eof = False
        self.event_time_fn = event_time_fn

    def poll(self, max_n: int) -> Polled:
        out: Polled = []
        for _ in range(max_n):
            pos = self._f.tell()
            line = self._f.readline()
            if not line or not line.endswith("\n"):
                # partial line: rewind and wait for the writer to finish it
                self._f.seek(pos)
                self._eof = not self._follow
                break
            line = line.strip()
            if line:
                out.append((self._f.tell(), json.loads(line)))
        return out

    def seek(self, offset: int) -> None:
        self._f.seek(offset)
        self._eof = False

    @property
    def exhausted(self) -> bool:
        return self._eof

    def close(self) -> None:
        self._f.close()


class ControlSource(Source):
    """Thread-safe in-process control-message feed (capability C6): test and
    application code pushes ``AddMessage``/``DelMessage`` while the engine
    polls. Offsets count consumed messages."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buf: List[Record] = []
        self._offset = 0

    def push(self, message: Record) -> None:
        with self._lock:
            self._buf.append(message)

    def poll(self, max_n: int) -> Polled:
        with self._lock:
            take = self._buf[:max_n]
            del self._buf[:max_n]
        out = []
        for m in take:
            self._offset += 1
            out.append((self._offset, m))
        return out

    def seek(self, offset: int) -> None:
        self._offset = offset


class FaultInjectionSource(Source):
    """Wraps a source and raises after N polled records (SURVEY.md §6 row
    "failure detection / fault injection": the reference relies on Flink's
    restart strategies; here recovery = a fresh pipeline restoring the
    checkpointed source offset, and this wrapper is how tests kill the
    first attempt mid-stream deterministically)."""

    def __init__(self, inner: Source, fail_after: int,
                 exc: type = RuntimeError):
        self._inner = inner
        self._fail_after = fail_after
        self._exc = exc
        self._polled = 0
        self.armed = True

    def poll(self, max_n: int):
        if self.armed and self._polled >= self._fail_after:
            raise self._exc(
                f"injected fault after {self._polled} records"
            )
        out = self._inner.poll(max_n)
        self._polled += len(out)
        return out

    def seek(self, offset: int) -> None:
        self._inner.seek(offset)

    @property
    def exhausted(self) -> bool:
        return self._inner.exhausted
