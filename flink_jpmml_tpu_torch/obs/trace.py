"""Causal record-journey tracing: trace contexts + the journey store.

The port's copy of ``flink_jpmml_tpu/obs/trace.py``, with the import
lines renamed. Its hop sites are the JAX package's: the block pipelines
(restore, suspect mode, dispatch, isolation and the DLQ terminal, the
shed terminal, the sink), the record engine, the device-fault note, the
exemplar linkage of ``obs/attr.py``, the Kafka sources' ingest hops and
the DLQ envelope's ids. Armed by ``FJT_JOURNEY_DIR`` (or
:func:`install`); unarmed, :func:`store_for` is a dict miss and one env
lookup and nothing records. Row times are host clocks: a ``sink`` hop's
``latency_s`` ends after the CUDA event wait of its dispatch.

Every sensor plane emits trace-*shaped* fragments — trace ids on
histogram exemplars (obs/attr.py), per-worker chrome-tracing span files
(obs/spans.py), flight events (obs/recorder.py), DLQ envelopes
(runtime/dlq.py) — and this module is the causal layer that joins them,
so a record can be followed through fetch→decode→dispatch→device→sink,
across a worker that was killed mid-batch, or through a DLQ redrive:

- :class:`TraceContext` — a 128-bit trace id + 64-bit span id +
  optional parent span id, W3C ``traceparent``-compatible so it can
  ride a Kafka magic-v2 record *header* across processes
  (``runtime/kafka.py`` grew header support; ``fjt-dlq redrive``
  stamps one so a redriven record's journey links its original).
- **Deterministic ids**: :func:`trace_id_for` derives a record/batch
  trace id purely from its stream offset, so two incarnations of the
  same worker — or two chips of a future mesh — mint the SAME id for
  the same record with zero coordination. Journey state therefore
  merges fleet-exactly like every other plane: the fleet journey set is the plain union of worker
  fragment sets, and reconstruction is a pure function of that union.
- :class:`JourneyStore` — a bounded JSONL ring beside the flight dumps
  holding per-**batch** hop records (``ingest``/``dispatch``/``sink``,
  keyed ``(first_off, n)`` so one dispatch fans out to per-record
  journeys without per-record cost) plus per-record terminal hops
  (``dlq``/``shed``/``decode_error``/``suspect_*``). **Tail-sampled**:
  only *interesting* journeys persist — top-latency (the exemplar
  path marks them), shed, quarantined, decode-error, drift-alarmed,
  plus a small head sample — everything else is dropped and counted
  (``journeys_dropped{reason=*}``). With ``FJT_JOURNEY_DIR`` unset the
  hot-path gate (:func:`store_for`) is a dict miss + one env lookup
  and nothing records (the drift-plane contract); armed, an
  accumulated-overhead budget (``FJT_JOURNEY_BUDGET``) bounds the
  bookkeeping like the sampled profiler's.
- **Crash safety**: interesting/terminal hops are written through the
  OS page cache (``write``+``flush``, no fsync — a SIGKILLed process
  loses nothing the OS already holds; only whole-machine loss needs
  fsync, and the DLQ's envelopes cover the correctness-critical
  records with real fsync). Suspect mode (crash-loop fingerprinting)
  and an armed fault harness flip the store to write-through so "the
  dispatch that died" is durable BEFORE the kill lands — the marker
  protocol's observability twin.

Checkpoints deliberately carry nothing: journeys are reconstructed
from the durable fragments (journey rows + span files + flight dumps +
DLQ envelopes), not from checkpointed state — :func:`read_rows` and
:func:`trace_payload` are the read side, across all worker incarnations
(the ``fjt-trace`` command of the port's ``cli.py`` renders them).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import weakref
from contextlib import contextmanager
from hashlib import blake2s
from typing import Dict, Iterator, List, Optional, Tuple

_DIR_ENV = "FJT_JOURNEY_DIR"
_MAX_MB_ENV = "FJT_JOURNEY_MAX_MB"
_HEAD_ENV = "FJT_JOURNEY_HEAD"
_BUDGET_ENV = "FJT_JOURNEY_BUDGET"
_SYNC_ENV = "FJT_JOURNEY_SYNC"

_SEG_PREFIX = "journeys-"
_SEG_BYTES = 256 << 10          # rotate segments at this size
_PENDING_TRACES = 512           # buffered not-yet-decided journeys
_FLUSHED_IDS = 4096             # remembered already-persisted trace ids

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
    same record with zero coordination — the property that lets
    ``fjt-trace`` (and a future multichip mesh) join per-worker
    journey fragments by plain union."""
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

    def to_traceparent(self) -> str:
        """W3C trace-context form (``00-<trace>-<span>-01``) — what the
        Kafka record header carries across processes."""
        return f"00-{self.trace_id:0>32.32}-{self.span_id:0>16.16}-01"

    @classmethod
    def from_traceparent(cls, s: str) -> Optional["TraceContext"]:
        """Parse a ``traceparent`` header value → context (the carried
        span becomes OUR parent candidate via :meth:`child`); None on
        anything malformed — a bad header must not poison ingest."""
        try:
            parts = str(s).strip().split("-")
            if len(parts) < 3:
                return None
            trace_id, span_id = parts[1], parts[2]
            int(trace_id, 16), int(span_id, 16)
            if len(trace_id) != 32 or len(span_id) != 16:
                return None
            return cls(trace_id, span_id)
        except (ValueError, AttributeError):
            return None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"TraceContext({self.trace_id[:8]}…, span={self.span_id}, "
            f"parent={self.parent_id})"
        )


def context_for(offset: int) -> TraceContext:
    """A fresh span in the deterministic journey of ``offset``."""
    return TraceContext(trace_id_for(offset))


# ---------------------------------------------------------------------------
# The active context (thread-local): spans and exemplars pick it up
# ---------------------------------------------------------------------------

_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The thread's active context (None when nothing is tracing).
    ``obs.spans.emit`` stamps it onto every span and
    ``obs.attr.StageLedger`` uses its trace id as the exemplar id, so
    a ``fjt-top`` exemplar row pivots straight to ``fjt-trace``."""
    return getattr(_tls, "ctx", None)


@contextmanager
def use(ctx: Optional[TraceContext]):
    """Make ``ctx`` the thread's active context for the block (None =
    no-op, so call sites stay unconditional)."""
    if ctx is None:
        yield
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


# ---------------------------------------------------------------------------
# JourneyStore
# ---------------------------------------------------------------------------


def _env_float(name: str, fallback: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return fallback
    try:
        return float(raw)
    except ValueError:
        return fallback


class JourneyStore:
    """Tail-sampled, bounded, durable journey-fragment store.

    Hop rows are per-BATCH (``(first_off, n)``-keyed) dicts buffered in
    memory per trace id; a journey persists to the JSONL ring only when
    the tail-sampling decision at :meth:`finish` keeps it (marked
    interesting, head sample) or a terminal hop (:meth:`terminal`)
    forces it. ``metrics`` books ``journeys_sampled``,
    ``journeys_dropped{reason=*}``, and ``journey_store_bytes``.
    """

    def __init__(
        self,
        directory: str,
        metrics=None,
        max_bytes: Optional[int] = None,
        head_n: Optional[int] = None,
        budget_frac: Optional[float] = None,
        segment_bytes: int = _SEG_BYTES,
    ):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._metrics = metrics
        self._max_bytes = int(
            max_bytes if max_bytes is not None
            else _env_float(_MAX_MB_ENV, 32.0) * (1 << 20)
        )
        self._head_left = int(
            head_n if head_n is not None else _env_float(_HEAD_ENV, 8)
        )
        self._budget = (
            budget_frac if budget_frac is not None
            else _env_float(_BUDGET_ENV, 0.02)
        )
        self._seg_bytes = max(4096, int(segment_bytes))
        self._mu = threading.Lock()
        self._pending: "collections.OrderedDict[str, List[dict]]" = (
            collections.OrderedDict()
        )
        self._marked: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        self._flushed: "collections.deque" = collections.deque(
            maxlen=_FLUSHED_IDS
        )
        self._flushed_set: set = set()
        self._alarm_boost = 0
        # write-through: every hop goes straight to the OS (suspect
        # mode / fault drills — "the dispatch that died" must be on
        # disk BEFORE the kill). Checked lazily so an env-armed fault
        # plan installed before this store exists is honored.
        from flink_jpmml_tpu_torch.runtime import faults as faults_mod

        self.write_through = bool(
            faults_mod.active() or os.environ.get(_SYNC_ENV)
        )
        self._f = None
        self._f_bytes = 0
        self._seq = self._next_seq()
        self._bytes_total = self._dir_bytes()
        self._t0 = time.monotonic()
        self._overhead_s = 0.0
        if metrics is not None:
            self._sampled = metrics.counter("journeys_sampled")
            self._bytes_gauge = metrics.gauge("journey_store_bytes")
            self._bytes_gauge.set(float(self._bytes_total))
        else:
            self._sampled = None
            self._bytes_gauge = None

    # -- accounting --------------------------------------------------------

    def _drop(self, reason: str, n: int = 1) -> None:
        if self._metrics is not None and n:
            self._metrics.counter(
                f'journeys_dropped{{reason="{reason}"}}'
            ).inc(n)

    def overhead_fraction(self) -> float:
        wall = max(time.monotonic() - self._t0, 1e-9)
        return self._overhead_s / wall

    def _over_budget(self) -> bool:
        return self.overhead_fraction() > self._budget

    # -- hop recording -----------------------------------------------------

    def hop(
        self,
        kind: str,
        ctx: TraceContext,
        first_off: Optional[int] = None,
        n: Optional[int] = None,
        durable: bool = False,
        register: bool = True,
        **fields,
    ) -> None:
        """Record one journey hop. Non-durable hops buffer until the
        tail-sampling decision; ``durable=True`` (terminal decisions,
        suspect-mode protocol) writes through immediately and — with
        ``register=True`` — marks the journey kept (counted in
        ``journeys_sampled``, later same-id hops write through).
        ``register=False`` writes a standalone durable fragment without
        adopting the journey (the per-fetch ingest hops: joined by
        offset range, not worth a journeys_sampled count each). The
        accumulated-overhead budget drops ONLY non-durable hops — a
        quarantine record is a correctness surface, not telemetry."""
        t0 = time.monotonic()
        try:
            row = {
                "t": time.time(),
                "pid": os.getpid(),
                "kind": str(kind),
                "trace_id": ctx.trace_id,
                "span_id": ctx.span_id,
            }
            if ctx.parent_id is not None:
                row["parent_id"] = ctx.parent_id
            if first_off is not None:
                row["first_off"] = int(first_off)
            if n is not None:
                row["n"] = int(n)
            if fields:
                row.update(fields)
            with self._mu:
                if durable or self.write_through:
                    if register:
                        self._remember_flushed(ctx.trace_id)
                    buffered = self._pending.pop(ctx.trace_id, None)
                    rows = (buffered or []) + [row]
                    self._write_rows(rows)
                    return
                if ctx.trace_id in self._flushed_set:
                    self._write_rows([row])  # continuation of a kept one
                    return
                if self._over_budget():
                    self._drop("budget")
                    return
                buf = self._pending.get(ctx.trace_id)
                if buf is None:
                    if len(self._pending) >= _PENDING_TRACES:
                        _, evicted = self._pending.popitem(last=False)
                        self._drop("evicted")
                    buf = self._pending[ctx.trace_id] = []
                buf.append(row)
        finally:
            self._overhead_s += time.monotonic() - t0

    def ingest(
        self,
        first_off: int,
        n: int,
        partition: Optional[int] = None,
        traceparents: Optional[Dict[int, str]] = None,
    ) -> None:
        """The ingest hop for one fetched run ``[first_off, first_off+n)``
        — durable (per-FETCH, not per-batch: a handful of rows per
        second, and every sampled journey's timeline needs its ingest
        row, which buffering under a fetch-run-keyed id that nothing
        ever finishes could only evict) but unregistered (not a
        ``journeys_sampled`` journey by itself; joined by offset
        range) — plus, for the (rare) records carrying a
        ``traceparent`` header (an ``fjt-dlq redrive``), a per-record
        durable ingest hop whose context CHILDS the carried one,
        linking the redriven record's new journey segment to its
        original."""
        ctx = context_for(first_off)
        self.hop(
            "ingest", ctx, first_off, n, partition=partition,
            durable=True, register=False,
        )
        for off, tp in (traceparents or {}).items():
            carried = TraceContext.from_traceparent(tp)
            if carried is None:
                continue
            self.hop(
                "ingest", carried.child(), offset=int(off),
                durable=True, redriven=True, partition=partition,
            )

    def mark(self, trace_id: str, reason: str) -> None:
        """Tail-sampling input: this journey is interesting (exemplar
        capture, drift alarm, an operator hook) — :meth:`finish` will
        keep it. Marks whose journey never finishes (isolation paths,
        abandons) are EVICTED oldest-first at the bound rather than
        blocking new marks: a long-lived worker must keep sampling its
        tail forever, not until the first 1024 orphans."""
        with self._mu:
            if trace_id in self._marked:
                return
            while len(self._marked) >= _PENDING_TRACES * 2:
                self._marked.popitem(last=False)
            self._marked[trace_id] = reason

    def note_alarm(self, reason: str = "drift", count: int = 4) -> None:
        """A plane-level alarm (e.g. drift) fired: keep the next few
        finishing journeys so the timeline around the alarm survives."""
        with self._mu:
            self._alarm_boost = max(self._alarm_boost, int(count))
            self._alarm_reason = reason

    def terminal(
        self,
        kind: str,
        ctx: TraceContext,
        first_off: Optional[int] = None,
        n: Optional[int] = None,
        **fields,
    ) -> None:
        """A terminal hop (``shed``/``dlq``/``decode_error``): always
        interesting, always durable — the drop/quarantine decision IS
        the journey's point."""
        self.hop(kind, ctx, first_off, n, durable=True, **fields)

    def finish(
        self,
        ctx: TraceContext,
        first_off: Optional[int] = None,
        n: Optional[int] = None,
        latency_s: Optional[float] = None,
        **fields,
    ) -> None:
        """The sink hop + the tail-sampling decision: persist when the
        journey was marked interesting (exemplar/top-latency, drift),
        is in the head sample, or already persisted; drop (counted)
        otherwise."""
        t0 = time.monotonic()
        try:
            row = {
                "t": time.time(),
                "pid": os.getpid(),
                "kind": "sink",
                "trace_id": ctx.trace_id,
                "span_id": ctx.span_id,
            }
            if ctx.parent_id is not None:
                row["parent_id"] = ctx.parent_id
            if first_off is not None:
                row["first_off"] = int(first_off)
            if n is not None:
                row["n"] = int(n)
            if latency_s is not None:
                row["latency_s"] = round(float(latency_s), 6)
            if fields:
                row.update(fields)
            with self._mu:
                reason = self._marked.pop(ctx.trace_id, None)
                if reason is None and self._alarm_boost > 0:
                    self._alarm_boost -= 1
                    reason = getattr(self, "_alarm_reason", "alarm")
                if reason is None and self._head_left > 0:
                    self._head_left -= 1
                    reason = "head"
                kept = (
                    reason is not None
                    or self.write_through
                    or ctx.trace_id in self._flushed_set
                )
                buffered = self._pending.pop(ctx.trace_id, None)
                if not kept:
                    self._drop("unsampled")
                    return
                if reason is not None:
                    row["sampled"] = reason
                self._remember_flushed(ctx.trace_id)
                self._write_rows((buffered or []) + [row])
        finally:
            self._overhead_s += time.monotonic() - t0

    # -- durable ring ------------------------------------------------------

    def _remember_flushed(self, trace_id: str) -> None:
        if trace_id in self._flushed_set:
            return
        if len(self._flushed) == self._flushed.maxlen:
            self._flushed_set.discard(self._flushed[0])
        self._flushed.append(trace_id)
        self._flushed_set.add(trace_id)
        # one journey persisted (however many hops follow it)
        if self._sampled is not None:
            self._sampled.inc()

    def _seg_path(self) -> str:
        return os.path.join(
            self.directory,
            f"{_SEG_PREFIX}{os.getpid()}-{self._seq:08d}.jsonl",
        )

    def _write_rows(self, rows: List[dict]) -> None:
        """Append rows to the open segment (write+flush — the OS page
        cache makes them SIGKILL-durable), rotating and GC'ing the ring
        at the byte budget. Called under the lock."""
        if not rows:
            return
        try:
            if self._f is None:
                self._f = open(self._seg_path(), "a", encoding="utf-8")
                self._f_bytes = 0
            chunk = "".join(
                json.dumps(r, sort_keys=True, default=repr) + "\n"
                for r in rows
            )
            self._f.write(chunk)
            self._f.flush()
        except (OSError, ValueError):
            self._f = None  # disk gone: drop quietly, stay alive
            self._drop("io_error", len(rows))
            return
        self._f_bytes += len(chunk)
        self._bytes_total += len(chunk)
        if self._f_bytes >= self._seg_bytes:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
            self._seq += 1
            self._gc()
        if self._bytes_gauge is not None:
            self._bytes_gauge.set(float(self._bytes_total))

    def _segments(self) -> List[str]:
        try:
            names = sorted(
                nm for nm in os.listdir(self.directory)
                if nm.startswith(_SEG_PREFIX) and nm.endswith(".jsonl")
            )
        except OSError:
            return []
        return [os.path.join(self.directory, nm) for nm in names]

    def _next_seq(self) -> int:
        pid_tag = f"{_SEG_PREFIX}{os.getpid()}-"
        seqs = [0]
        for p in self._segments():
            nm = os.path.basename(p)
            if nm.startswith(pid_tag):
                try:
                    seqs.append(int(nm[len(pid_tag):-len(".jsonl")]) + 1)
                except ValueError:
                    pass
        return max(seqs)

    def _dir_bytes(self) -> int:
        total = 0
        for p in self._segments():
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def _gc(self) -> None:
        """Ring bound: drop the OLDEST segments (by mtime, across all
        pids sharing the directory) past the byte budget — a journey
        store that outgrows its budget must eat its own tail, counted,
        never the disk."""
        segs = []
        for p in self._segments():
            try:
                segs.append((os.path.getmtime(p), os.path.getsize(p), p))
            except OSError:
                pass
        segs.sort()
        total = sum(sz for _, sz, _ in segs)
        dropped = 0
        for _, sz, p in segs:
            if total <= self._max_bytes:
                break
            try:
                os.unlink(p)
            except OSError:
                continue
            total -= sz
            dropped += 1
        self._bytes_total = total
        if dropped:
            self._drop("ring_gc", dropped)

    def close(self) -> None:
        with self._mu:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


# ---------------------------------------------------------------------------
# Per-registry singletons (the drift-plane gating idiom)
# ---------------------------------------------------------------------------

_STORES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_STORES_MU = threading.Lock()


def install(metrics, directory: Optional[str] = None, **kw) -> JourneyStore:
    """Force-arm a journey store on a registry (bench drills, tests)
    regardless of ``FJT_JOURNEY_DIR``."""
    store = _STORES.get(metrics)
    if store is None:
        with _STORES_MU:
            store = _STORES.get(metrics)
            if store is None:
                d = directory or os.environ.get(_DIR_ENV)
                if not d:
                    raise ValueError(
                        "journey store needs a directory "
                        f"(pass one or set {_DIR_ENV})"
                    )
                store = _STORES[metrics] = JourneyStore(
                    d, metrics=metrics, **kw
                )
    return store


def store_for(metrics) -> Optional[JourneyStore]:
    """The hot-path gate: the registry's store if one is armed, else —
    with ``FJT_JOURNEY_DIR`` set — arm one now. Env unset and nothing
    installed: a dict miss + one env lookup, and NOTHING records (the
    pinned zero-records contract, perf-smoke-guarded ≤2µs)."""
    if metrics is None:
        return None
    store = _STORES.get(metrics)
    if store is not None:
        return store
    if not os.environ.get(_DIR_ENV):
        return None
    return install(metrics)


def peek(metrics) -> Optional[JourneyStore]:
    """The registry's store if (and only if) one is already armed —
    never arms (the /trace endpoint's read path)."""
    if metrics is None:
        return None
    return _STORES.get(metrics)


# ---------------------------------------------------------------------------
# Read side: /trace payloads + fjt-trace's directory scan
# ---------------------------------------------------------------------------


def iter_jsonl(path: str) -> Iterator[dict]:
    """Tolerant JSONL reader shared by every journey-fragment consumer
    (journey segments, span files, the CLI's flight/DLQ scan): skips
    blank lines, torn trailing writes, stray array brackets, and
    non-dict values — an abrupt kill tears at most the unflushed tail,
    and one damaged neighbor must not hide the rest."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            for ln in f:
                ln = ln.strip().rstrip(",")
                if not ln or ln in ("[", "]"):
                    continue
                try:
                    obj = json.loads(ln)
                except ValueError:
                    continue
                if isinstance(obj, dict):
                    yield obj
    except OSError:
        return


def read_rows(
    directory: str, limit: int = 20000
) -> List[dict]:
    """Every journey row retained in ``directory`` (all pids, oldest
    segment first, newest ``limit`` rows kept). Torn/garbage lines are
    skipped — an abrupt kill tears at most the unflushed tail."""
    rows: "collections.deque" = collections.deque(maxlen=max(1, limit))
    try:
        names = [
            nm for nm in os.listdir(directory)
            if nm.startswith(_SEG_PREFIX) and nm.endswith(".jsonl")
        ]
    except OSError:
        return []

    def _order(nm: str):
        # oldest first by mtime (lexical filename order interleaves
        # pids of different digit counts, which under the newest-limit
        # deque would evict the NEWEST incarnation's terminal hops —
        # the rows kill-anywhere reconstruction depends on)
        try:
            return (os.path.getmtime(os.path.join(directory, nm)), nm)
        except OSError:
            return (0.0, nm)

    for nm in sorted(names, key=_order):
        for row in iter_jsonl(os.path.join(directory, nm)):
            rows.append(row)
    return list(rows)


def _span_rows(path: str, limit: int = 2048) -> List[dict]:
    """Trace-id'd chrome-trace events from a span file (newest
    ``limit`` kept) — the only spans a journey timeline can attach;
    uncorrelated ones belong in Perfetto."""
    rows: "collections.deque" = collections.deque(maxlen=max(1, limit))
    for ev in iter_jsonl(path):
        if (ev.get("args") or {}).get("trace_id"):
            rows.append(ev)
    return list(rows)


def trace_payload(metrics=None) -> dict:
    """The ``/trace`` endpoint's JSON: this process's durable journey
    rows (the whole shared directory — prior incarnations included),
    its live flight-ring events, and the active span file's trace-id'd
    events (flushed first, so the page tells the current story), so
    ``fjt-trace <url>`` reconstructs without filesystem access."""
    from flink_jpmml_tpu_torch.obs import recorder as flight
    from flink_jpmml_tpu_torch.obs import spans

    store = peek(metrics) if metrics is not None else None
    d = store.directory if store is not None else os.environ.get(_DIR_ENV)
    w = spans.writer()
    if w is not None:
        w.flush()
    return {
        "pid": os.getpid(),
        "dir": d,
        "journeys": read_rows(d) if d else [],
        "flight": flight.events(),
        "span_file": (w.path if w is not None else None),
        "spans": (_span_rows(w.path) if w is not None else []),
    }
