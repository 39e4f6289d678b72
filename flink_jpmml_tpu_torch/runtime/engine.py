"""The streaming micro-batch engine: source → batcher → device → sink.

The port of ``flink_jpmml_tpu/runtime/engine.py``: the record engine
behind ``StreamEnvironment.evaluate``. It replaces the reference's Flink
operator runtime (SURVEY.md §4.1): where Flink called ``flatMap(event)``
per record on a CPU, each worker runs a two-stage host pipeline:

- **ingest thread**: polls the source, stamps each record with (offset,
  enqueue-time), and puts it on a bounded queue (backpressure point);
- **scoring loop**: drains fill-or-deadline micro-batches, hands each to
  the :class:`Scorer`'s ``submit`` (featurize + queue the device work
  without waiting on it) and keeps a small in-flight window, so host prep
  of batch N+1 overlaps device execution of batch N; ``finish`` reads the
  results back in order and they are sunk in order, and the source offset
  is committed only after the batch is sunk.

Metrics: ``records_in`` / ``records_out``, ``batches``,
``batch_fill_records``, ``record_latency_s`` (enqueue → sink, sampled
lanes), the ``StageTimer`` stages ``featurize_dispatch``, ``readback`` and
``sink``, the ``ring_occupancy`` gauge and the pressure and freshness
planes (the latter when the source carries an ``event_time_fn``).

:class:`StaticScorer` scores the rank wire whenever the model has one
(``quantized_scorer()``): on the card through ``dispatch_quantized`` with
a pinned :class:`HostStaging` and a CUDA stream of its own (so
``qtrees_leaf_rows`` runs the GBM and the vote forests), on the CPU
through the kernel's plain version. Other models go through
``CompiledModel.predict``, padded up to the compile batch.

Recovery, as in the JAX engine:

- **checkpoints** (``Pipeline(checkpoint=)``, a ``CheckpointManager``):
  the committed offset, the in-flight high-water mark and the scorer's
  state (the dynamic scorer's served-model registry) ride each snapshot;
  ``restore()`` seeks the source back and hands the scorer its state;
- **poison isolation** (``dlq=``, or the default DLQ beside the
  checkpoints): a scoring error bisects the micro-batch by synchronous
  submit/finish pairs, quarantines single failing records and delivers
  the rest; a crash-loop fingerprint at restore scores the replay region
  one record per dispatch under persisted markers;
- **the device-fault ladder** (``runtime/devfault.py``), armed where a
  DLQ is wired or with ``FJT_FAILOVER=1``: a device error re-dispatches
  the micro-batch through the scorer under full-jitter backoff, an OOM
  halves the dispatch size, and a lost context (``chip_loss``) or an
  exhausted streak escalates with a raise. The record path has no host
  tier, in either package.

Without a DLQ or ``FJT_FAILOVER`` a scoring or ingest error stops the
pipeline and re-raises from ``join`` (so from
``StreamEnvironment.execute``). The fault sites ``score_batch`` (with the
record offsets), ``device_dispatch`` and ``device_readback`` fire where
the JAX engine fires them.

Record-journey tracing (``obs/trace.py``, armed by ``FJT_JOURNEY_DIR``)
puts its hops where the JAX engine does: restore and suspect mode, one
``dispatch`` hop a micro-batch, the isolation hops and their ``dlq``
terminals, and the ``sink`` hop that closes the micro-batch's journey;
the batch's context is active around submit, readback and sink, so the
scorer's ``score_finish`` span and any exemplar carry its ids.

Keyed state (``StaticScorer(state=)``, runtime/state.py) rides the rank
wire as in the JAX package: the engine hands a state-armed scorer the
records' offsets (its decay clock and exactly-once replay guard), the
table's values ride each checkpoint as an inline payload, and every
isolation or recovery replay scores statelessly, after the table rolls
back to its last snapshot. ``Pipeline(tenant=)`` books delivered records
under ``tenant_records{model=...}`` beside ``records_out``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile import prepare
from flink_jpmml_tpu_torch.compile.compiler import CompiledModel
from flink_jpmml_tpu_torch.models.prediction import Prediction
from flink_jpmml_tpu_torch.obs import freshness as fresh_mod
from flink_jpmml_tpu_torch.obs import pressure as pressure_mod
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.obs import trace as trace_mod
from flink_jpmml_tpu_torch.runtime import devfault
from flink_jpmml_tpu_torch.runtime import faults
from flink_jpmml_tpu_torch.runtime import prefetch as prefetch_mod
from flink_jpmml_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    CheckpointPolicy,
)
from flink_jpmml_tpu_torch.runtime.dlq import (
    REASON_CRASH_LOOP,
    REASON_SCORE,
    CrashFingerprint,
    PoisonIsolationOverflow,
    dlq_for_checkpoint,
    env_count,
    serialize_record,
)
from flink_jpmml_tpu_torch.runtime.pipeline import (
    HostStaging,
    dispatch_f32,
    dispatch_quantized,
)
from flink_jpmml_tpu_torch.runtime.queues import BoundedQueue, Closed
from flink_jpmml_tpu_torch.runtime.sinks import Sink
from flink_jpmml_tpu_torch.runtime.sources import Source, batch_event_range
from flink_jpmml_tpu_torch.utils.config import RuntimeConfig
from flink_jpmml_tpu_torch.runtime import state as state_mod
from flink_jpmml_tpu_torch.utils.exceptions import InputValidationException
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
from flink_jpmml_tpu_torch.utils.profiling import StageTimer

# pinned staging buffers a scorer rotates through: the engine's default
# window (2 in flight) plus the batch being staged, plus one spare
STAGING_SLOTS = 4


@dataclass
class _Stamped:
    offset: int
    record: Any
    t_enq: float


class Scorer:
    """Strategy interface: turn a micro-batch of records into outputs.

    ``submit`` must dispatch device work without blocking on it; ``finish``
    blocks (device→host transfer + decode). Splitting the two lets the engine
    overlap host batch-prep with device execution.
    """

    def submit(self, records: Sequence[Any]) -> Any:
        raise NotImplementedError

    def finish(self, ticket: Any) -> List[Any]:
        raise NotImplementedError

    def state(self) -> dict:
        return {}

    def restore(self, state: dict) -> None:
        pass


ExtractFn = Callable[[Sequence[Any]], Tuple[np.ndarray, np.ndarray]]
EmitFn = Callable[[Sequence[Any], List[Prediction]], List[Any]]


class ScoringStream:
    """A scorer's CUDA stream (nothing on the CPU), where its dispatches'
    H2D copies, kernels and D2H copies queue in order. Created on the
    first dispatch, on the thread that dispatches; creating it
    synchronizes the card once, so that weight copies queued on another
    thread's stream when the model loaded have landed before this stream
    reads them (pool streams do not wait on one another)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = None

    def context(self):
        """→ the context a dispatch runs under."""
        if self.device.type == "cuda" and self._stream is None:
            torch.cuda.synchronize(self.device)
            self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stream)  # None: a no-op


def new_staging(device: torch.device) -> Optional[HostStaging]:
    """Pinned staging for one model's dispatches on the card (None on the
    CPU, where ``dispatch_quantized`` needs none)."""
    if device.type != "cuda":
        return None
    return HostStaging(device, slots=STAGING_SLOTS)


class StaticScorer(Scorer):
    """Single fixed model (the reference's static ``evaluate``, C3).

    ``extract`` turns raw records into an ``(X, M)`` pair — defaults to
    dict-records via the model's field space, or dense vectors; pass a
    custom one for event objects. ``emit`` shapes the sink items —
    defaults to bare ``Prediction``s; the quick-evaluate API uses
    ``(prediction, record)`` pairs like the reference. The model's device
    is the scorer's.
    """

    def __init__(
        self,
        model: CompiledModel,
        extract: Optional[ExtractFn] = None,
        emit: Optional[EmitFn] = None,
        replace_nan: Optional[float] = None,
        use_quantized: bool = True,
        state=None,
    ):
        self._model = model
        self._replace_nan = replace_nan
        self._extract = extract or self._extract_records
        self._emit = emit or (lambda recs, preds: list(preds))
        self._q = model.quantized_scorer() if use_quantized else None
        # keyed session state (runtime/state.py): a StateSpec builds a
        # private table on the model's device (pass a KeyedStateTable
        # built with the pipeline's registry to surface its state_*
        # family); state rides the rank-wire dispatch, so the f32 path
        # cannot carry it
        if isinstance(state, state_mod.StateSpec):
            state = state_mod.KeyedStateTable(state, device=model.device)
        if state is not None and self._q is None:
            raise InputValidationException(
                "keyed state needs the rank-wire scorer (this model "
                "has no quantized path)"
            )
        self.state_table = state
        # the engine passes per-record source offsets (the state decay
        # clock + exactly-once replay guard) only to scorers that ask
        self.accepts_offsets = state is not None
        self._stream = ScoringStream(model.device)
        self._staging = new_staging(model.device)
        # which scoring backend this scorer engages (surfaced in the
        # pipeline's metrics as scorer_backend_*)
        self.backend = (
            f"rank_wire_{self._q.backend}" if self._q is not None else "f32"
        )

    def _extract_records(self, records: Sequence[Any]):
        first = records[0]
        if isinstance(first, dict):
            return prepare.from_records(self._model.field_space, records)
        arr = np.asarray(records, np.float32)
        return prepare.from_dense(
            self._model.field_space, arr, self._replace_nan
        )

    def submit(self, records: Sequence[Any], offsets=None):
        X, M = self._extract(records)
        n = X.shape[0]
        with self._stream.context():
            if self._q is not None:
                table = self.state_table
                armed = table is not None and not table.bypassed
                # dispatch_quantized owns batch alignment (K compile
                # batches, one launch) and, armed, the host slot routing
                # and the state step after the scorer
                out = dispatch_quantized(
                    self._q, X, M, staging=self._staging,
                    state=table if armed else None,
                    state_keys=(table.hash_records(records) if armed
                                else None),
                    offsets=offsets if armed else None,
                )
                return ("q", out, records, n)
            out = dispatch_f32(self._model, X, M)
        return ("f", out, records, n)

    def finish(self, ticket) -> List[Any]:
        kind, out, records, n = ticket
        host = out.result()  # waits for the D2H copy
        host, _derived = state_mod.split_output(host)
        if kind == "q":
            preds = self._q.decode(host, n)
        else:
            preds = self._model.decode(host, n)
        return self._emit(records, preds)

    def state(self) -> dict:
        if self.state_table is None:
            return {}
        try:
            # inline payload (small tables); beyond the inline cap the
            # record path degrades to stateless restore (as the JAX one)
            return {"keyed_state": self.state_table.to_payload()}
        except InputValidationException:
            return {}

    def restore(self, state: dict) -> None:
        payload = state.get("keyed_state")
        if payload and self.state_table is not None:
            self.state_table.from_payload(payload)


class Pipeline:
    """One worker's streaming loop. Thread-safe start/stop; join() drains."""

    def __init__(
        self,
        source: Source,
        scorer: Scorer,
        sink: Sink,
        config: Optional[RuntimeConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
        checkpoint: Optional[CheckpointManager] = None,
        in_flight: int = 2,
        dlq=None,
        prefetch: Optional[bool] = None,
        tenant: Optional[str] = None,
    ):
        # ``tenant`` labels this pipeline's delivered records for the
        # multi-tenant zoo plane (serving/zoo.py): records_out stays the
        # unlabelled total, tenant_records{model=...} adds the per-tenant
        # axis
        self._tenant = tenant
        self._source = source
        self._scorer = scorer
        self._sink = sink
        self._config = config or RuntimeConfig()
        self.metrics = metrics or MetricsRegistry()
        # pipelined ingest (runtime/prefetch.py): prefetchable sources
        # (Kafka — network fetch + decode) poll on a sidecar thread and
        # hand decoded records across a bounded queue; cf. block.py
        self._source = prefetch_mod.maybe_wrap_records(
            self._source, metrics=self.metrics, enable=prefetch
        )
        backend = getattr(scorer, "backend", None)
        if backend:
            self.metrics.counter(f"scorer_backend_{backend}").inc()
        self._ckpt = CheckpointPolicy(
            checkpoint, self._config.checkpoint_interval_s,
            metrics=self.metrics,
        )
        # delivery-correctness plane (runtime/dlq.py): defaults to a DLQ
        # beside the checkpoints; without durable state, fail fast
        self._dlq = dlq if dlq is not None else dlq_for_checkpoint(
            checkpoint, metrics=self.metrics
        )
        ckpt_dir = getattr(checkpoint, "directory", None)
        self._fingerprint = (
            CrashFingerprint(ckpt_dir)
            if (ckpt_dir is not None and self._dlq is not None) else None
        )
        # device-fault recovery arms on the block path's terms: a DLQ
        # wired or the explicit FJT_FAILOVER opt-in
        self._devfault_armed = (
            self._dlq is not None or bool(os.environ.get("FJT_FAILOVER"))
        )
        self._dispatched_hi = 0
        self._replay_until = 0
        self._suspect_until: Optional[int] = None
        self._death_marker: Optional[dict] = None
        self._suspect_gauge = self.metrics.gauge("poison_suspect_mode")
        self._in_flight_max = max(1, in_flight)
        self._queue = BoundedQueue(self._config.batch.queue_capacity)
        self._stop = threading.Event()
        # run_until_exhausted sets this: the score loop then consumes the
        # whole queued backlog after close. A plain stop() leaves it False
        # — queued-but-uncommitted records are discarded, so stop()
        # returns promptly even under a flooding source.
        self._drain_all = False
        self._ingest_thread: Optional[threading.Thread] = None
        self._score_thread: Optional[threading.Thread] = None
        self._committed_offset = 0
        self._error: Optional[BaseException] = None

    # -- lifecycle ---------------------------------------------------------

    def _ckpt_state(self) -> dict:
        state = {
            "source_offset": self._committed_offset,
            # the at-least-once replay region's upper bound (offsets of
            # records handed to submit but not yet committed)
            "inflight_hi": max(self._dispatched_hi, self._committed_offset),
            "scorer": self._scorer.state(),
        }
        snap = getattr(self._source, "checkpoint_state", None)
        if snap is not None:
            extra = snap(self._committed_offset)
            if extra is not None:
                state["source_state"] = extra
        return state

    def restore(self) -> bool:
        """Resume from the latest checkpoint, if any (capability C7)."""
        state = self._ckpt.restore_latest()
        if state is None:
            # no snapshot yet: still count the restore — a poison record
            # in the first uncommitted window crash-loops at offset 0
            self._init_poison_state({})
            return False
        off = int(state.get("source_offset", 0))
        sstate = state.get("source_state")
        rst = getattr(self._source, "restore_state", None)
        if sstate is not None and rst is not None:
            off = int(rst(sstate))
        else:
            self._source.seek(off)
        self._committed_offset = off
        self._scorer.restore(state.get("scorer", {}))
        self._init_poison_state(state)
        return True

    def _init_poison_state(self, state: dict) -> None:
        """Crash-loop fingerprinting (the block pipeline's protocol,
        record-path flavour): the restore counter (crashes.json) or
        ``FJT_RESTART_STREAK`` crossing ``FJT_POISON_RESTARTS`` resumes
        the checkpoint's in-flight range in suspect mode."""
        self._replay_until = max(
            int(state.get("inflight_hi", 0)), self._committed_offset
        )
        if self._fingerprint is None:
            return
        committed = self._committed_offset
        count = self._fingerprint.note_restore(committed)
        streak = env_count("FJT_RESTART_STREAK", 0)
        # markers live in the RECORD-offset domain (stamp − 1): a marker
        # is stale exactly when hi ≤ committed
        self._death_marker = self._fingerprint.read_marker()
        if (
            self._death_marker is not None
            and self._death_marker["hi"] <= committed
        ):
            self._death_marker = None
            self._fingerprint.clear_marker()
        jstore = trace_mod.store_for(self.metrics)
        if jstore is not None:
            jstore.hop(
                "restore", trace_mod.context_for(committed),
                first_off=committed, durable=True,
                restarts=max(count - 1, streak),
            )
        threshold = env_count("FJT_POISON_RESTARTS", 3)
        if max(count - 1, streak) >= threshold:
            hi = self._replay_until
            if hi <= committed:
                hi = committed + self._config.batch.size
            self._suspect_until = hi
            self._suspect_gauge.set(1.0)
            if jstore is not None:
                # see block.py: suspect mode → write-through journeys
                jstore.write_through = True
                jstore.hop(
                    "suspect_mode", trace_mod.context_for(committed),
                    first_off=committed, n=hi - committed, durable=True,
                    restarts=max(count - 1, streak),
                )
            flight.record(
                "poison_suspect_mode", lo=committed, hi=hi,
                restarts=max(count - 1, streak),
                marker=self._death_marker,
            )

    def start(self) -> "Pipeline":
        self._ingest_thread = threading.Thread(
            target=self._ingest_loop, name="fjt-ingest", daemon=True
        )
        self._score_thread = threading.Thread(
            target=self._score_loop, name="fjt-score", daemon=True
        )
        self._ingest_thread.start()
        self._score_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        stop_sidecar = getattr(self._source, "stop_prefetch", None)
        if stop_sidecar is not None:
            stop_sidecar()  # park the prefetch sidecar (cf. block.py)
        self._queue.close()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._ingest_thread:
            self._ingest_thread.join(timeout)
        if self._score_thread:
            self._score_thread.join(timeout)
        if self._error is not None:
            raise self._error

    def run_until_exhausted(self, timeout: float = 60.0) -> None:
        """Process the whole (finite) source, then stop.

        Deterministic drain (no sleep windows): the ingest thread exits on
        its own once the source is exhausted and every record is enqueued;
        only then is the queue closed. ``BoundedQueue.drain`` keeps serving
        remaining items after close, so the score loop consumes everything
        in the queue, then its in-flight window, then exits.
        """
        self.start()
        deadline = time.monotonic() + timeout
        assert self._ingest_thread is not None
        while self._ingest_thread.is_alive() and self._error is None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            self._ingest_thread.join(timeout=min(remaining, 0.05))
        self._drain_all = True
        self._stop.set()
        self._queue.close()
        self.join(timeout=max(10.0, deadline - time.monotonic()))

    @property
    def committed_offset(self) -> int:
        return self._committed_offset

    # -- poison isolation (runtime/dlq.py) ---------------------------------

    @staticmethod
    def _record_off(s: "_Stamped") -> int:
        """A stamp's offset is the RESUME point — one past the record
        (sources emit ``(consumed_count, rec)``). Fault targeting and DLQ
        envelopes use the record's own offset, so ``offset=K`` means the
        same record on this path as on the block path."""
        return s.offset - 1

    def _score_seq(self, seq: List["_Stamped"]) -> List[Any]:
        """Synchronous submit+finish of a sub-batch (the isolation and
        device-recovery paths' dispatch primitive), with the fault sites
        carrying the sub-range's record offsets — a persistent injected
        device fault keeps failing redispatches like a real one."""
        faults.fire(
            "score_batch", offsets=[self._record_off(s) for s in seq]
        )
        # isolation / recovery replays score STATELESSLY: these records
        # may already be folded into the keyed state table (the failed
        # dispatch committed before the error surfaced)
        table = getattr(self._scorer, "state_table", None)
        ctx = table.bypass() if table is not None else (
            contextlib.nullcontext()
        )
        with ctx:
            faults.fire("device_dispatch")
            ticket = self._scorer.submit([s.record for s in seq])
            faults.fire("device_readback")
            return self._scorer.finish(ticket)

    def _roll_back_state(self) -> None:
        """A failed dispatch may have committed a partial or poisoned
        state update (and later in-flight batches chained on it): restore
        the last snapshot before recovery or isolation replays the range
        — bounded, counted loss (``state_rollbacks``); the replayed
        records then score statelessly via ``_score_seq``'s bypass."""
        table = getattr(self._scorer, "state_table", None)
        if table is not None and not table.bypassed:
            table.rollback()

    def _book_tenant(self, n: int) -> None:
        if self._tenant is not None:
            self.metrics.counter(
                f'tenant_records{{model="{self._tenant}"}}'
            ).inc(n)

    def _deliver_seq(self, seq, outputs) -> None:
        self._sink.emit(outputs)
        self.metrics.counter("records_out").inc(len(seq))
        self._book_tenant(len(seq))
        event_time_fn = getattr(self._source, "event_time_fn", None)
        if event_time_fn is not None:
            freshness = fresh_mod.freshness_for(self.metrics)
            tr = batch_event_range([s.record for s in seq], event_time_fn)
            if tr is not None:
                # only DELIVERED records advance the watermark/staleness
                freshness.observe_batch(tr[0], tr[1])

    def _quarantine_stamped(
        self, s: "_Stamped", exc, state: dict,
        reason: str = REASON_SCORE, attempts: int = 1, original=None,
        parent_ctx=None,
    ) -> None:
        cap = env_count("FJT_DLQ_MAX_PER_BATCH", 32)
        if state["q"] >= cap:
            raise PoisonIsolationOverflow(
                state["q"], exc if exc is not None else original
            )
        state["q"] += 1
        off = self._record_off(s)
        # terminal journey hop + the envelope's trace context (the ids a
        # redrive stamps into the traceparent header)
        rctx = trace_mod.TraceContext(
            trace_mod.trace_id_for(off),
            parent_id=(
                None if parent_ctx is None else parent_ctx.span_id
            ),
        )
        jstore = trace_mod.store_for(self.metrics)
        if jstore is not None:
            jstore.terminal(
                "dlq", rctx, offset=off, reason=reason,
                attempts=attempts,
            )
        self._dlq.quarantine(
            serialize_record(s.record), offset=off,
            reason=reason, error=exc, attempts=attempts,
            trace_id=rctx.trace_id, span_id=rctx.span_id,
        )

    def _isolate(self, stamped: List["_Stamped"], error, ctx=None) -> None:
        """Bisection over one failed micro-batch: clean runs reach the
        sink in order, single failing records go to the DLQ, the whole
        range commits (a parked poison record never replays)."""
        jstore = trace_mod.store_for(self.metrics)
        if ctx is None and jstore is not None:
            ctx = trace_mod.context_for(self._record_off(stamped[0]))
        if jstore is not None:
            jstore.hop(
                "suspect_scan", ctx, self._record_off(stamped[0]),
                len(stamped), durable=True, persist=False,
                error=repr(error),
            )
        flight.record(
            "poison_isolation", first=stamped[0].offset,
            n=len(stamped), error=repr(error), persist=False,
            trace_id=None if ctx is None else ctx.trace_id,
        )
        self._suspect_gauge.set(1.0)
        state = {"q": 0}

        def scan(seq: List["_Stamped"]):
            if not seq:
                return
            try:
                outputs = self._score_seq(seq)
            except PoisonIsolationOverflow:
                raise
            except Exception as e:
                if devfault.classify(e) is not None:
                    # a sick card mid-bisection is not record poison:
                    # never quarantine clean records for it — escalate
                    raise
                if len(seq) == 1:
                    self._quarantine_stamped(
                        seq[0], e, state, original=error,
                        parent_ctx=ctx,
                    )
                    return
                mid = len(seq) // 2
                scan(seq[:mid])
                scan(seq[mid:])
                return
            self._deliver_seq(seq, outputs)
            if jstore is not None:
                # surviving runs get durable sink hops, like the block
                # path's emit_run
                jstore.hop(
                    "sink", ctx.child(), self._record_off(seq[0]),
                    len(seq), durable=True, isolated=True,
                )

        try:
            scan(stamped)
        finally:
            self._suspect_gauge.set(
                1.0 if self._suspect_until is not None else 0.0
            )
        self._committed_offset = stamped[-1].offset
        if state["q"]:
            flight.record(
                "poison_isolated", quarantined=state["q"],
                first=stamped[0].offset, n=len(stamped),
            )
        self._ckpt.maybe_save(self._ckpt_state)

    def _isolate_suspect(self, stamped: List["_Stamped"]) -> None:
        """Fingerprint-triggered suspect mode: one record per dispatch,
        marker written BEFORE each — a record that kills the process is
        quarantined by the next incarnation without being dispatched
        again."""
        state = {"q": 0}
        jstore = trace_mod.store_for(self.metrics)
        for s in stamped:
            r = self._record_off(s)
            rctx = (
                trace_mod.context_for(r) if jstore is not None else None
            )
            dm = self._death_marker
            if dm is not None and dm["lo"] == r and dm["hi"] == r + 1:
                # the previous incarnation died dispatching exactly this
                # record: quarantine it unscored
                self._quarantine_stamped(
                    s, None, state, reason=REASON_CRASH_LOOP,
                    attempts=dm.get("attempts", 1), parent_ctx=rctx,
                )
                self._death_marker = None
                self._fingerprint.clear_marker()
                continue
            if self._fingerprint is not None:
                self._fingerprint.write_marker(r, r + 1, attempts=1)
                if jstore is not None:
                    # the marker's journey twin (see block.py): written
                    # BEFORE the dispatch so a kill leaves it behind
                    jstore.hop(
                        "suspect_dispatch", rctx, r, 1, durable=True,
                    )
            try:
                outputs = self._score_seq([s])
            except PoisonIsolationOverflow:
                raise
            except Exception as e:
                if devfault.classify(e) is not None:
                    raise  # device fault ≠ poison: never quarantine
                self._quarantine_stamped(s, e, state, parent_ctx=rctx)
                continue
            self._deliver_seq([s], outputs)
            if jstore is not None:
                jstore.hop(
                    "sink", rctx.child(), r, 1, durable=True,
                    isolated=True,
                )
        if self._fingerprint is not None:
            self._fingerprint.clear_marker()
        self._committed_offset = stamped[-1].offset
        self._ckpt.maybe_save(self._ckpt_state)

    def _recover_device(self, stamped: List["_Stamped"], error,
                        kind: str, ctx=None) -> None:
        """Record-path device-fault ladder: transient errors re-dispatch
        the micro-batch through the real submit/finish path under the
        shared full-jitter backoff; OOM drains in halves (batch-size
        bisection, never record quarantine); a lost context or an
        exhausted streak escalates with a raise, with every delivered
        run committed first."""
        from flink_jpmml_tpu_torch.utils.retry import Backoff

        devfault.note(
            self.metrics, kind, first_off=self._record_off(stamped[0]),
            n=len(stamped), error=error,
        )
        if kind == devfault.KIND_LOST:
            flight.record(
                "device_lost_escalate",
                first=self._record_off(stamped[0]), n=len(stamped),
                error=repr(error),
            )
            raise error
        redispatched = self.metrics.counter("redispatch_records")
        retries = env_count("FJT_DEVICE_RETRIES", 2)
        bo = Backoff(
            "device", base_s=0.02, cap_s=0.5, max_attempts=retries
        )
        pending = list(stamped)
        # OOM dispatch-size cap: HALVES on every OOM failure; a proven
        # size sticks for the remainder
        size = len(pending)
        while pending and not bo.exhausted:
            bo.sleep()
            if kind == devfault.KIND_OOM and size > 1:
                size = max(1, size // 2)
                kind = devfault.KIND_ERROR  # halve once per OOM seen
                # a halving IS progress: only repeated failures at the
                # SAME size spend the streak
                bo.reset()
            seq = pending[:min(size, len(pending))]
            try:
                outputs = self._score_seq(seq)
            except Exception as e2:
                k2 = devfault.classify(e2)
                if k2 is None:
                    # the device fault cleared and record poison
                    # surfaced underneath: isolation's jurisdiction
                    if self._dlq is None:
                        raise
                    self._isolate(pending, e2, ctx=ctx)
                    return
                devfault.note(
                    self.metrics, k2,
                    first_off=self._record_off(seq[0]), n=len(seq),
                    error=e2,
                )
                if k2 == devfault.KIND_LOST:
                    flight.record(
                        "device_lost_escalate",
                        first=self._record_off(seq[0]), n=len(seq),
                        error=repr(e2),
                    )
                    raise e2
                kind = k2
                error = e2
                continue
            self._deliver_seq(seq, outputs)
            redispatched.inc(len(seq))
            self._committed_offset = seq[-1].offset
            self._ckpt.maybe_save(self._ckpt_state)
            pending = pending[size:]
            bo.reset()  # progress re-arms the schedule
        if pending:
            raise error  # exhausted: supervisor restart
        flight.record(
            "device_redispatch",
            first=self._record_off(stamped[0]), n=len(stamped),
        )

    def _exit_suspect_mode(self) -> None:
        flight.record(
            "poison_suspect_exit", committed=self._committed_offset
        )
        self._suspect_until = None
        self._death_marker = None
        if self._fingerprint is not None:
            self._fingerprint.clear_marker()
        self._suspect_gauge.set(0.0)
        jstore = trace_mod.store_for(self.metrics)
        if jstore is not None:
            jstore.hop(
                "suspect_exit",
                trace_mod.context_for(self._committed_offset),
                first_off=self._committed_offset, durable=True,
            )
            jstore.write_through = bool(
                faults.active() or os.environ.get("FJT_JOURNEY_SYNC")
            )

    # -- internals ---------------------------------------------------------

    def _ingest_loop(self) -> None:
        records_in = self.metrics.counter("records_in")
        try:
            while not self._stop.is_set():
                polled = self._source.poll(1024)
                if not polled:
                    if self._source.exhausted:
                        return
                    time.sleep(0.001)
                    continue
                now = time.monotonic()
                for offset, rec in polled:
                    while not self._stop.is_set():
                        if self._queue.put(
                            _Stamped(offset, rec, now), timeout=0.1
                        ):
                            break
                records_in.inc(len(polled))
        except Closed:
            pass
        except BaseException as e:  # surface ingestion failures to join()
            self._error = e
            self._stop.set()

    def _score_loop(self) -> None:
        batch_cfg = self._config.batch
        records_out = self.metrics.counter("records_out")
        batches = self.metrics.counter("batches")
        fill = self.metrics.counter("batch_fill_records")
        lat = self.metrics.histogram("record_latency_s")
        replayed = self.metrics.counter("records_replayed")
        in_flight: List[Tuple[Any, List[_Stamped], Any]] = []
        # record-journey tracing (obs/trace.py): None unless armed
        jstore = trace_mod.store_for(self.metrics)
        stages = StageTimer(self.metrics)
        # the freshness tracker exists only when the source opts in with
        # an event_time_fn; the pressure score always runs (the queue
        # occupancy gauge is this path's ring input)
        event_time_fn = getattr(self._source, "event_time_fn", None)
        freshness = (
            fresh_mod.freshness_for(self.metrics)
            if event_time_fn is not None else None
        )
        monitor = pressure_mod.pressure_for(self.metrics)
        queue_occ = self.metrics.gauge("ring_occupancy")

        def _finish_one():
            ticket, stamped, jctx = in_flight.pop(0)
            try:
                # the finishing batch's context wraps readback + sink:
                # DynamicScorer.finish's span (and any exemplar those
                # stages capture) carries THIS journey's ids
                with trace_mod.use(jctx):
                    with stages.stage("readback"):
                        # readback-time device-fault site (cf. the block
                        # dispatcher's finish_oldest)
                        faults.fire("device_readback")
                        outputs = self._scorer.finish(ticket)
            except PoisonIsolationOverflow:
                raise
            except Exception as e:
                # device-fault triage FIRST: a sick card re-dispatches,
                # record poison bisects — entries ahead of this one
                # already completed (FIFO), so commits stay monotone
                kind = devfault.classify(e)
                if kind is not None:
                    if not self._devfault_armed:
                        raise  # fail fast: restart instead
                    self._roll_back_state()
                    self._recover_device(stamped, e, kind, ctx=jctx)
                    return
                if self._dlq is None:
                    raise
                self._roll_back_state()
                self._isolate(stamped, e, ctx=jctx)
                return
            with trace_mod.use(jctx):
                with stages.stage("sink"):
                    self._sink.emit(outputs)
            now = time.monotonic()
            if jstore is not None and jctx is not None:
                jstore.finish(
                    jctx, self._record_off(stamped[0]), len(stamped),
                    latency_s=now - stamped[0].t_enq,
                )
            # sample a handful of lanes, not all (host-side cost control)
            for s in stamped[:: max(1, len(stamped) // 8)]:
                lat.observe(now - s.t_enq)
            records_out.inc(len(stamped))
            self._book_tenant(len(stamped))
            if stamped[0].offset <= self._replay_until:
                replayed.inc(sum(
                    1 for s in stamped if s.offset <= self._replay_until
                ))
            self._committed_offset = stamped[-1].offset
            if freshness is not None:
                tr = batch_event_range(
                    [s.record for s in stamped], event_time_fn
                )
                if tr is not None:
                    freshness.observe_batch(tr[0], tr[1])
            self._ckpt.maybe_save(self._ckpt_state)
            if monitor is not None:
                monitor.maybe_tick()

        try:
            while True:
                if self._stop.is_set() and not self._drain_all:
                    break  # stop(): skip the uncommitted backlog
                try:
                    stamped = self._queue.drain(
                        batch_cfg.size, batch_cfg.deadline_us
                    )
                except Closed:
                    break
                if not stamped:
                    continue
                queue_occ.set(self._queue.occupancy())
                self._dispatched_hi = max(
                    self._dispatched_hi, stamped[-1].offset
                )
                if (
                    self._suspect_until is not None
                    and stamped[0].offset <= self._suspect_until
                ):
                    # crash-loop fingerprint: the replay region scores
                    # one record per dispatch under persisted markers
                    # (drain the window first)
                    while in_flight:
                        _finish_one()
                    self._isolate_suspect(stamped)
                    if self._committed_offset >= self._suspect_until:
                        self._exit_suspect_mode()
                    batches.inc()
                    fill.inc(len(stamped))
                    continue
                jctx = None
                if jstore is not None:
                    # one dispatch hop per micro-batch, keyed (first
                    # record offset, n) — the record-path twin of the
                    # block pipeline's batch journey
                    jctx = trace_mod.context_for(
                        self._record_off(stamped[0])
                    )
                    jstore.hop(
                        "dispatch", jctx,
                        self._record_off(stamped[0]), len(stamped),
                    )
                try:
                    with trace_mod.use(jctx), \
                            stages.stage("featurize_dispatch"):
                        faults.fire(
                            "score_batch",
                            offsets=[self._record_off(s) for s in stamped],
                        )
                        faults.fire("device_dispatch")
                        if getattr(self._scorer, "accepts_offsets", False):
                            # keyed-state scorers get the record offsets:
                            # the decay clock + the exactly-once guard
                            ticket = self._scorer.submit(
                                [s.record for s in stamped],
                                offsets=[self._record_off(s)
                                         for s in stamped],
                            )
                        else:
                            ticket = self._scorer.submit(
                                [s.record for s in stamped]
                            )
                except PoisonIsolationOverflow:
                    raise
                except Exception as e:
                    # the submit itself raised (featurize, routing, an
                    # injected poison, a launch-time device fault): older
                    # in-flight batches commit first, then this one
                    # recovers or isolates in place
                    kind = devfault.classify(e)
                    if kind is not None and not self._devfault_armed:
                        raise  # fail fast: restart instead
                    if kind is None and self._dlq is None:
                        raise
                    while in_flight:
                        _finish_one()
                    self._roll_back_state()
                    if kind is not None:
                        self._recover_device(stamped, e, kind, ctx=jctx)
                    else:
                        self._isolate(stamped, e, ctx=jctx)
                    batches.inc()
                    fill.inc(len(stamped))
                    continue
                in_flight.append((ticket, stamped, jctx))
                batches.inc()
                fill.inc(len(stamped))
                if len(in_flight) >= self._in_flight_max:
                    _finish_one()
            while in_flight:
                _finish_one()
            self._ckpt.save_now(self._ckpt_state)
        except BaseException as e:
            self._error = e
            self._stop.set()
