"""Chrome-tracing span export (Perfetto-loadable), env-gated.

The port's copy of ``flink_jpmml_tpu/obs/spans.py``, with the import
lines renamed. ``FJT_TRACE_DIR=/tmp/fjt-trace`` makes the runtime's
host-side stages (featurize / h2d+dispatch / readback / sink via
``profiling.StageTimer`` and ``annotate``) and the
:class:`OverlappedDispatcher` in-flight window emit complete-events
(``"ph": "X"``) into ``$FJT_TRACE_DIR/spans-<pid>.trace.json`` — load the
file in https://ui.perfetto.dev or chrome://tracing to see where stream
time goes, per thread, alongside a ``torch.profiler`` trace.

Every span is a HOST interval on ``time.monotonic``; none synchronizes
the card. On the card ``featurize`` is the host encode (≈ 0 when the
encode is fused), ``h2d_dispatch`` the copy into pinned staging plus the
issue of the asynchronous H2D copy, the kernel launch and the D2H copy —
the card runs them later on its stream — and ``readback`` the host's
wait on the oldest dispatch's CUDA event, which is where the card's own
time shows. No span claims to time device work it did not wait on.

Unset (the default) every emit is a dict lookup + None check — cheap
enough to leave the call sites unconditional. The file is size-bounded
(``FJT_TRACE_MAX_MB``, default 64): when the budget is hit one
truncation marker is written and the writer goes quiet, so a long-lived
worker cannot fill the disk. The format is the JSON Array Format with
one event per line and no closing bracket — both loaders accept the
truncated array, which is exactly what an abruptly-killed worker leaves
behind.

Writes are **buffered**: the original writer flushed the OS file per
event, which put a syscall pair on every hot-path span (measured as the
dominant cost of tracing a ≥1M rec/s stream). Events now accumulate in
a bounded in-memory buffer written out when it reaches
``BUFFER_EVENTS`` (128) events or ``FLUSH_INTERVAL_S`` (0.5 s) has
passed since the last write — and on :func:`flush` (called by the
flight recorder's postmortem dump), on ``close``, and at interpreter
exit. Crash-loss is therefore bounded at ``BUFFER_EVENTS`` events /
one flush interval, a contract pinned by
``tests/test_attr.py::TestSpanBuffering``.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import List, Optional

from flink_jpmml_tpu_torch.obs import trace as trace_mod

_DIR_ENV = "FJT_TRACE_DIR"
_MAX_ENV = "FJT_TRACE_MAX_MB"

BUFFER_EVENTS = 128  # max events lost on an abrupt kill
FLUSH_INTERVAL_S = 0.5


class SpanWriter:
    def __init__(
        self,
        path: str,
        max_bytes: int = 64 << 20,
        buffer_events: int = BUFFER_EVENTS,
        flush_interval_s: float = FLUSH_INTERVAL_S,
    ):
        self._path = path
        self._max = max_bytes
        self._bytes = 0
        self._truncated = False
        self._buf: List[str] = []
        self._buf_max = max(1, int(buffer_events))
        self._flush_interval = flush_interval_s
        self._last_flush = time.monotonic()
        self._lock = threading.Lock()
        self._f = open(path, "w", encoding="utf-8")
        self._f.write("[\n")
        self._f.flush()  # a kill before the first flush leaves a
        # loadable (empty) truncated array, not a zero-byte file

    @property
    def path(self) -> str:
        return self._path

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        chunk = "".join(self._buf)
        self._buf.clear()
        self._last_flush = time.monotonic()
        try:
            self._f.write(chunk)
            self._f.flush()
        except (OSError, ValueError):
            self._truncated = True  # fd gone: go quiet, stay alive

    def emit(
        self, name: str, t0_s: float, dur_s: float, **args
    ) -> None:
        """One complete-event: ``t0_s`` on the ``time.monotonic`` clock
        (every emitter uses it, so spans align across threads)."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": round(t0_s * 1e6, 1),
            "dur": round(dur_s * 1e6, 1),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "cat": "fjt",
        }
        if args:
            ev["args"] = args
        line = json.dumps(ev) + ",\n"
        with self._lock:
            if self._truncated:
                return
            if self._bytes + len(line) > self._max:
                self._truncated = True
                line = json.dumps({
                    "name": "TRACE TRUNCATED (FJT_TRACE_MAX_MB)",
                    "ph": "i", "ts": ev["ts"], "pid": ev["pid"],
                    "tid": ev["tid"], "s": "g",
                }) + ",\n"
                self._buf.append(line)
                self._bytes += len(line)
                self._flush_locked()  # the marker must reach disk
                return
            self._buf.append(line)
            self._bytes += len(line)
            if (
                len(self._buf) >= self._buf_max
                or time.monotonic() - self._last_flush
                >= self._flush_interval
            ):
                self._flush_locked()

    def flush(self) -> None:
        """Write any buffered events out now (postmortem/exit path)."""
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            try:
                self._f.close()
            except OSError:
                pass


_writer: Optional[SpanWriter] = None
_writer_dir: Optional[str] = None
_writer_lock = threading.Lock()


def writer() -> Optional[SpanWriter]:
    """The process's lazy singleton writer; None when tracing is off.
    Re-checks the env var so tests (and long-lived REPLs) can gate it
    on/off without re-importing."""
    global _writer, _writer_dir
    d = os.environ.get(_DIR_ENV)
    if not d:
        return None
    if _writer is None or _writer_dir != d:
        with _writer_lock:
            if _writer is None or _writer_dir != d:
                if _writer is not None:
                    # retargeting: the old writer's buffered tail must
                    # reach ITS file (close flushes), and the fd must
                    # not leak — GC of the file object would write
                    # nothing from the Python-level buffer
                    _writer.close()
                    _writer = None  # a failed reopen must not resurrect it
                try:
                    os.makedirs(d, exist_ok=True)
                    max_mb = float(os.environ.get(_MAX_ENV) or 64)
                    _writer = SpanWriter(
                        os.path.join(d, f"spans-{os.getpid()}.trace.json"),
                        max_bytes=int(max_mb * (1 << 20)),
                    )
                    _writer_dir = d
                except (OSError, ValueError):
                    return None
    return _writer


def enabled() -> bool:
    return bool(os.environ.get(_DIR_ENV))


def emit(name: str, t0_s: float, dur_s: float, **args) -> None:
    w = writer()
    if w is not None:
        # causal linkage (obs/trace.py): when a journey context is
        # active on this thread, every span — StageTimer stages,
        # annotate blocks, featurize/h2d/readback/sink — carries the
        # journey's trace/span ids, so fjt-trace can attach the span
        # timeline to the record journey it belongs to. One
        # thread-local read; only paid when tracing is on at all.
        ctx = trace_mod.current()
        if ctx is not None and "trace_id" not in args:
            args["trace_id"] = ctx.trace_id
            args["span_id"] = ctx.span_id
        w.emit(name, t0_s, dur_s, **args)


def flush() -> None:
    """Flush the singleton writer's buffer (no-op when tracing is off).
    Called by the flight recorder before a postmortem dump and at
    interpreter exit, so the span file and the flight JSONL tell the
    same final story."""
    w = _writer  # don't CREATE a writer just to flush nothing
    if w is not None:
        w.flush()


atexit.register(flush)


def span_clock() -> float:
    """The clock spans are stamped on (`time.monotonic`)."""
    return time.monotonic()
