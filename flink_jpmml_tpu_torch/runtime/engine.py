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

Not ported (each raises :class:`NotPortedError` and names itself):
checkpoints and the DLQ (``Pipeline(checkpoint=, dlq=)``,
``Pipeline.restore``), device-fault recovery (``FJT_FAILOVER``), keyed
state (``StaticScorer(state=)``) and the zoo's ``tenant=``. Without them
the JAX pipeline fails fast, and so does this one: a scoring or ingest
error stops the pipeline and re-raises from ``join`` (so from
``StreamEnvironment.execute``). Journey tracing and the fault-injection
sites are not ported either.
"""

from __future__ import annotations

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
from flink_jpmml_tpu_torch.runtime import prefetch as prefetch_mod
from flink_jpmml_tpu_torch.runtime.pipeline import (
    HostStaging,
    dispatch_f32,
    dispatch_quantized,
)
from flink_jpmml_tpu_torch.runtime.queues import BoundedQueue, Closed
from flink_jpmml_tpu_torch.runtime.sinks import Sink
from flink_jpmml_tpu_torch.runtime.sources import Source, batch_event_range
from flink_jpmml_tpu_torch.utils.config import RuntimeConfig
from flink_jpmml_tpu_torch.utils.exceptions import NotPortedError, refuse
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
        refuse(state=state)
        self._model = model
        self._replace_nan = replace_nan
        self._extract = extract or self._extract_records
        self._emit = emit or (lambda recs, preds: list(preds))
        self._q = model.quantized_scorer() if use_quantized else None
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

    def submit(self, records: Sequence[Any]):
        X, M = self._extract(records)
        n = X.shape[0]
        with self._stream.context():
            if self._q is not None:
                # dispatch_quantized owns batch alignment (K compile
                # batches, one launch)
                out = dispatch_quantized(
                    self._q, X, M, staging=self._staging
                )
                return ("q", out, records, n)
            out = dispatch_f32(self._model, X, M)
        return ("f", out, records, n)

    def finish(self, ticket) -> List[Any]:
        kind, out, records, n = ticket
        host = out.result()  # waits for the D2H copy
        if kind == "q":
            preds = self._q.decode(host, n)
        else:
            preds = self._model.decode(host, n)
        return self._emit(records, preds)


class Pipeline:
    """One worker's streaming loop. Thread-safe start/stop; join() drains."""

    def __init__(
        self,
        source: Source,
        scorer: Scorer,
        sink: Sink,
        config: Optional[RuntimeConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
        checkpoint=None,
        in_flight: int = 2,
        dlq=None,
        prefetch: Optional[bool] = None,
        tenant: Optional[str] = None,
    ):
        refuse(checkpoint=checkpoint, dlq=dlq, tenant=tenant)
        if os.environ.get("FJT_FAILOVER"):
            raise NotPortedError(
                "FJT_FAILOVER (device-fault recovery) is not ported"
            )
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

    def restore(self) -> bool:
        raise NotPortedError("Pipeline.restore (checkpoints) is not ported")

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
        in_flight: List[Tuple[Any, List[_Stamped]]] = []
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
            ticket, stamped = in_flight.pop(0)
            with stages.stage("readback"):
                outputs = self._scorer.finish(ticket)
            with stages.stage("sink"):
                self._sink.emit(outputs)
            now = time.monotonic()
            # sample a handful of lanes, not all (host-side cost control)
            for s in stamped[:: max(1, len(stamped) // 8)]:
                lat.observe(now - s.t_enq)
            records_out.inc(len(stamped))
            self._committed_offset = stamped[-1].offset
            if freshness is not None:
                tr = batch_event_range(
                    [s.record for s in stamped], event_time_fn
                )
                if tr is not None:
                    freshness.observe_batch(tr[0], tr[1])
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
                # fail fast: a submit error (featurize, routing, launch)
                # stops the pipeline, as the JAX engine does without a
                # DLQ or failover
                with stages.stage("featurize_dispatch"):
                    ticket = self._scorer.submit([s.record for s in stamped])
                in_flight.append((ticket, stamped))
                batches.inc()
                fill.inc(len(stamped))
                if len(in_flight) >= self._in_flight_max:
                    _finish_one()
            while in_flight:
                _finish_one()
        except BaseException as e:
            self._error = e
            self._stop.set()
