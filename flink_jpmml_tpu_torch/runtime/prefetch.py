"""Pipelined ingest: the prefetch/decode sidecar feeding the ring.

The port's copy of ``flink_jpmml_tpu/runtime/prefetch.py``, with the
import lines renamed: ``_PrefetchedSourceBase``, the block half
(``PrefetchedBlockSource``, ``maybe_wrap_block``) and the record half
(``PrefetchedRecordSource``, ``maybe_wrap_records``, which the record
engine ``runtime/engine.py`` wraps its source with), ``env_depth`` and
``env_disabled``, with the same knobs. ``maybe_wrap_chips`` waits for the
mesh.

Without it the pipelines' ingest thread runs fetch RPC and wire decode
*serially*: while a fetch long-polls the broker nothing decodes, and
while a batch decodes no fetch is in flight. The stage ledger names
those as ``stage_seconds{stage="fetch"/"decode"}``; the fix is the
classic input-pipeline discipline: overlap host ingest with everything
downstream so the accelerator never waits on the network.

This module adds exactly one pipeline stage: a **sidecar thread** per
source that runs the source's own ``poll()`` loop — fetch, decode,
freshness stamps, DLQ routing, journey ingest hops, all of it, on the
source's existing code paths — and hands finished batches to the
consumer through a **bounded handoff queue**. The pipelines' ingest
thread then only pops a decoded block and memcpys it into the ring,
so fetch N+1 overlaps decode N overlaps ring-push/score N−1. The
sidecar is a PERFORMANCE change, not a semantics change:

- **ordering** — one sidecar per source, a FIFO queue: records emerge
  in exactly the order the source produced them;
- **seek / restore** — pauses the sidecar at a poll boundary, seeks
  the inner source, discards queued batches, resumes (the engine's
  checkpoint hooks proxy through untouched);
- **reconnect** — lives where it always did, inside the source's
  fetch path (backoff, ``kafka_reconnect`` flight events); the
  sidecar just sees an empty poll;
- **errors** — a sidecar exception (e.g. the fail-fast
  ``KafkaPartitionError``) is stashed and re-raised from the
  consumer's ``poll()``, so the pipeline dies exactly as it would
  have single-threaded;
- **shutdown** — ``stop_prefetch()`` parks and joins the sidecar;
  the pipelines call it from ``stop()``.

Telemetry (all on the shared registry, catalogued in
docs/operations.md): ``prefetch_depth`` / ``prefetch_occupancy``
gauges (queue fill; high-water in the gauge's ``_max``),
``prefetch_batches`` / ``prefetch_records`` counters,
``prefetch_stall_s`` (consumer waited on an EMPTY queue — ingest is
the bottleneck; also observed as the ``prefetch_wait`` stage so
``fjt-top`` ranks it against fetch/decode) and ``prefetch_block_s``
(sidecar blocked on a FULL queue — downstream is the bottleneck,
i.e. backpressure, which also feeds the ``PressureMonitor``'s
``pressure_prefetch`` component through the occupancy peak-hold).

Knobs: ``FJT_PREFETCH_DEPTH`` (handoff queue depth in batches,
default 4), ``FJT_PREFETCH_DISABLE`` (operational kill switch — wins
over any explicit enable).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from flink_jpmml_tpu_torch.obs import attr as attr_mod
from flink_jpmml_tpu_torch.obs import pressure as pressure_mod

ENV_DEPTH = "FJT_PREFETCH_DEPTH"
ENV_DISABLE = "FJT_PREFETCH_DISABLE"
DEFAULT_DEPTH = 4

# consumer-side bounded wait for a first batch: long enough to skip
# the caller's sleep-and-retry loop in the common case, short enough
# that control-plane work (stop flags, checkpoint ticks) stays live
_POLL_WAIT_S = 0.005


def env_depth() -> int:
    try:
        d = int(os.environ.get(ENV_DEPTH) or DEFAULT_DEPTH)
    except ValueError:
        return DEFAULT_DEPTH
    return max(1, d)


def env_disabled() -> bool:
    return bool(os.environ.get(ENV_DISABLE))


class _PrefetchedSourceBase:
    """Shared sidecar machinery; subclasses say what one inner poll
    yields (a block tuple / a record batch list) and how many records
    it carried. All queue state is guarded by one condition — the
    depths are single digits, contention is not a concern."""

    _THREAD_NAME = "fjt-prefetch"

    def __init__(self, inner, depth: Optional[int] = None, metrics=None):
        self._inner = inner
        self._depth = max(1, int(depth)) if depth else env_depth()
        self._q: "collections.deque" = collections.deque()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._paused = False
        self._busy = False  # sidecar inside inner.poll right now
        self._eos = False
        self._exc: Optional[BaseException] = None
        self._metrics = metrics
        if metrics is not None:
            self._g_depth = metrics.gauge("prefetch_depth")
            self._g_occ = metrics.gauge("prefetch_occupancy")
            self._c_batches = metrics.counter("prefetch_batches")
            self._c_records = metrics.counter("prefetch_records")
            self._c_stall = metrics.counter("prefetch_stall_s")
            self._c_block = metrics.counter("prefetch_block_s")
            self._ledger = attr_mod.ledger_for(metrics)
            self._monitor = pressure_mod.pressure_for(metrics)
        else:
            self._g_depth = self._g_occ = None
            self._c_batches = self._c_records = None
            self._c_stall = self._c_block = None
            self._ledger = self._monitor = None

    # marks the wrapper so maybe_wrap_* never double-wraps
    prefetch_wrapped = True

    # -- subclass hooks ----------------------------------------------------

    def _poll_inner(self):
        """→ one handoff item or None (nothing available)."""
        raise NotImplementedError

    def _item_records(self, item) -> int:
        raise NotImplementedError

    # -- sidecar -----------------------------------------------------------

    def _ensure_started(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            return
        with self._cv:
            t = self._thread
            if (
                self._stopped
                or self._exc is not None  # sticky until a seek resets
                or (t is not None and t.is_alive())
            ):
                return
            # t is None (first poll) or a dead sidecar whose error a
            # seek/restore cleared: spawn fresh against the re-seeked
            # inner source
            nt = threading.Thread(
                target=self._loop, name=self._THREAD_NAME, daemon=True
            )
            self._thread = nt
            nt.start()

    def _loop(self) -> None:
        while True:
            napping = False
            with self._cv:
                while not self._stopped and (
                    self._paused
                    or self._eos
                    or len(self._q) >= self._depth
                ):
                    was_full = len(self._q) >= self._depth
                    t0 = time.monotonic()
                    self._cv.wait(0.05)
                    if was_full and self._c_block is not None:
                        # backpressure: downstream (ring/score) is the
                        # bottleneck while this accrues
                        self._c_block.inc(time.monotonic() - t0)
                if self._stopped:
                    self._busy = False
                    self._cv.notify_all()
                    return
                self._busy = True
            try:
                # the inner source's OWN poll: fetch + decode +
                # freshness stamps + DLQ routing + journey hops all run
                # here, off the consumer thread, on unchanged code paths
                item = self._poll_inner()
            except BaseException as e:
                with self._cv:
                    self._exc = e  # sticky: re-raised from every poll()
                    self._busy = False
                    self._cv.notify_all()
                return
            with self._cv:
                self._busy = False
                if item is not None:
                    self._q.append(item)
                    self._note_queue(pushed=item)
                elif self._inner.exhausted:
                    self._eos = True  # parked; a seek() un-parks
                else:
                    napping = True
                self._cv.notify_all()
            if napping:
                time.sleep(0.0005)  # starved source (cf. _ingest loops)

    def _note_queue(self, pushed=None) -> None:
        """Gauge/counter updates; callers hold the condition lock."""
        if self._g_depth is None:
            return
        n = len(self._q)
        occ = min(n / self._depth, 1.0)
        self._g_depth.set(float(n))
        self._g_occ.set(occ)
        if pushed is not None:
            self._c_batches.inc()
            self._c_records.inc(self._item_records(pushed))
            if self._monitor is not None:
                # peak-hold, like the ring's pre-drain note: the tick
                # must see the worst fill between scrapes, not whatever
                # instant the gauge happens to read
                self._monitor.note_prefetch(occ)

    def _take(self):
        """→ (item | None, waited_s). Bounded wait on an empty queue;
        sticky sidecar errors re-raise here."""
        self._ensure_started()
        t0 = None
        while True:
            with self._cv:
                if self._q:
                    item = self._q.popleft()
                    self._note_queue()
                    self._cv.notify_all()
                    break
                if self._exc is not None:
                    raise self._exc
                if self._eos or self._stopped:
                    return None, 0.0
                now = time.monotonic()
                if t0 is None:
                    t0 = now
                remaining = t0 + _POLL_WAIT_S - now
                if remaining <= 0:
                    return None, now - t0
                self._cv.wait(remaining)
        waited = 0.0 if t0 is None else time.monotonic() - t0
        return item, waited

    def _account_wait(self, waited: float) -> None:
        if waited <= 0.0:
            return
        if self._c_stall is not None:
            self._c_stall.inc(waited)
        if self._ledger is not None:
            # the hot path's residual ingest cost once fetch/decode
            # moved off-thread — ranked by fjt-top next to them
            self._ledger.observe("prefetch_wait", waited)

    # -- lifecycle / source protocol --------------------------------------

    @contextmanager
    def _pause(self):
        """Park the sidecar at a poll boundary; the body may then
        mutate the inner source and the queue safely. The epilogue
        ALWAYS runs — stale pre-seek batches are discarded even when
        the sidecar already died (pinned by a test: a dead
        sidecar's queue used to survive a seek), and a deliberate
        seek/restore is a retry: it drops a dead sidecar's sticky
        error so the next poll spawns a fresh one against the
        re-seeked inner source."""
        t = self._thread
        if t is not None and t.is_alive():
            with self._cv:
                self._paused = True
                self._cv.notify_all()
                while self._busy:
                    self._cv.wait(0.05)
        try:
            yield
        finally:
            with self._cv:
                self._q.clear()
                self._eos = False
                if not self._stopped and self._exc is not None:
                    self._exc = None
                    if (
                        self._thread is not None
                        and not self._thread.is_alive()
                    ):
                        self._thread = None
                self._note_queue()
                self._paused = False
                self._cv.notify_all()

    def seek(self, offset: int) -> None:
        # in-flight prefetched batches are PRE-seek data: discard them
        # with the pause epilogue, never hand them across the seek
        with self._pause():
            self._inner.seek(offset)

    def stop_prefetch(self, join_timeout: float = 2.0) -> None:
        t = self._thread
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if t is not None and t.is_alive():
            t.join(join_timeout)

    def close(self) -> None:
        # join BEFORE closing the socket: a sidecar mid-fetch on a
        # closed client would ride the reconnect path for nothing
        self.stop_prefetch()
        self._inner.close()

    @property
    def exhausted(self) -> bool:
        if self._thread is None:
            return self._inner.exhausted
        with self._cv:
            return self._eos and not self._q and self._exc is None

    def __getattr__(self, name):
        # checkpoint hooks (checkpoint_state/restore_state), event_time
        # extractors, test probes: resolve against the inner source so
        # optional-protocol getattr() probes see exactly what the inner
        # source offers
        inner_attr = getattr(self._inner, name)
        if name == "restore_state":
            def _restore(state, _inner_restore=inner_attr):
                with self._pause():
                    return _inner_restore(state)

            return _restore
        return inner_attr


class PrefetchedBlockSource(_PrefetchedSourceBase):
    """BlockSource wrapper: the sidecar runs ``inner.poll()`` →
    ``(first_offset, rows)`` blocks through the handoff queue."""

    _THREAD_NAME = "fjt-prefetch-blk"

    def _poll_inner(self):
        return self._inner.poll()

    def _item_records(self, item) -> int:
        return int(item[1].shape[0])

    def poll(self):
        item, waited = self._take()
        self._account_wait(waited)
        return item


class PrefetchedRecordSource(_PrefetchedSourceBase):
    """Record ``Source`` wrapper (engine.Pipeline's shape): the sidecar
    polls fixed-size chunks; the consumer re-chunks to its ``max_n``
    through a consumer-thread-only pending deque."""

    _THREAD_NAME = "fjt-prefetch-rec"

    def __init__(self, inner, depth=None, metrics=None, chunk: int = 1024):
        super().__init__(inner, depth=depth, metrics=metrics)
        self._chunk = max(1, int(chunk))
        self._pending: "collections.deque" = collections.deque()

    @property
    def event_time_fn(self):
        return getattr(self._inner, "event_time_fn", None)

    def _poll_inner(self):
        polled = self._inner.poll(self._chunk)
        return polled if polled else None

    def _item_records(self, item) -> int:
        return len(item)

    def poll(self, max_n: int):
        out = list(self._pending)
        if out:
            self._pending.clear()
        waited = 0.0
        while len(out) < max_n:
            item, w = self._take()
            waited += w
            if item is None:
                break
            out.extend(item)
        self._account_wait(waited)
        if len(out) > max_n:
            self._pending.extend(out[max_n:])
            del out[max_n:]
        return out

    def seek(self, offset: int) -> None:
        self._pending.clear()
        super().seek(offset)

    @property
    def exhausted(self) -> bool:
        if self._pending:
            return False
        return super().exhausted


def _resolve(source, enable: Optional[bool]) -> bool:
    if env_disabled():
        return False  # the operational kill switch wins over everything
    if enable is None:
        return bool(getattr(source, "prefetchable", False))
    return bool(enable)


def maybe_wrap_block(
    source, metrics=None, enable: Optional[bool] = None,
    depth: Optional[int] = None,
):
    """→ ``source`` wrapped in a :class:`PrefetchedBlockSource` when
    pipelined ingest applies (``enable`` True, or None = auto: the
    source marked itself ``prefetchable``), else ``source`` unchanged.
    ``FJT_PREFETCH_DISABLE`` force-disables either way."""
    if getattr(source, "prefetch_wrapped", False) or not _resolve(
        source, enable
    ):
        return source
    return PrefetchedBlockSource(source, depth=depth, metrics=metrics)


def maybe_wrap_records(
    source, metrics=None, enable: Optional[bool] = None,
    depth: Optional[int] = None,
):
    """Record-source twin of :func:`maybe_wrap_block` (engine.Pipeline's
    consumption site)."""
    if getattr(source, "prefetch_wrapped", False) or not _resolve(
        source, enable
    ):
        return source
    return PrefetchedRecordSource(source, depth=depth, metrics=metrics)
