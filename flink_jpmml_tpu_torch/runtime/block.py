"""Block pipeline: the high-throughput vector path, on the card.

The port of ``flink_jpmml_tpu/runtime/block.py``. Records are contiguous
float32 blocks end to end:

    BlockSource.poll() → [n, F] numpy block
      → ring (C++ NativeRing, runtime/native.py)         ← backpressure
      → fill-or-deadline drain into a reused batch buffer
      → multi-chunk aggregation on a backed-up ring
      → rank encode (C++ bucketizer on the host, or the device encode
        stage when the scorer's encode placement is "fused")
      → staged H2D copy → kernel (CUDA stream)
      → in-flight window (runtime/pipeline.py) → sink(outputs, n, offset)

Ported: the sources, ``BoundScorer``, and ``BlockPipeline`` over the C++
ring with ``start`` / ``stop`` / ``join`` / ``run_for`` /
``run_until_exhausted``; the prefetch sidecar (``runtime/prefetch.py``:
a source that marks itself ``prefetchable``, as ``KafkaBlockSource``
does, is polled on a sidecar thread; ``prefetch=False`` turns it off,
and ``stop()`` parks it before the ring closes); the stage ledger
(``obs/attr.py``: ``encode``, ``h2d``, ``queue_wait`` and ``readback``
from ``runtime/pipeline.py``, ``sink`` here, and ``fetch``, ``decode``
and ``prefetch_wait`` from the Kafka source and the sidecar, all in the
pipeline's registry); and the freshness and pressure planes, ticked
from the score loop. The JAX package's Python ring (its fall-back when
the C++ library cannot be built) is not ported: the ring raises
``NativeBuildError`` instead. Not ported yet (the JAX package's hooks at
block.py:31-51): checkpoints, the DLQ and poison isolation, keyed
state, the mesh, device-fault recovery (and with it the freshness hooks
of its recovery and fallback paths), admission control, the drift
plane and journey tracing. The score loop marks where each attaches.

The f32 path (``_dispatch_f32``, every family without a rank wire) books
the bytes it ships in ``h2d_bytes``, as the rank-wire path does; the JAX
package's f32 dispatch books none.

The sink receives host tensors (the pinned buffer the D2H copy filled)
once their dispatch has completed; :meth:`BlockPipeline.decode` turns one
into ``Prediction``s.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile import prepare
from flink_jpmml_tpu_torch.compile.compiler import CompiledModel
from flink_jpmml_tpu_torch.obs import attr as attr_mod
from flink_jpmml_tpu_torch.obs import freshness as fresh_mod
from flink_jpmml_tpu_torch.obs import pressure as pressure_mod
from flink_jpmml_tpu_torch.runtime import prefetch as prefetch_mod
from flink_jpmml_tpu_torch.runtime.native import NativeRing
from flink_jpmml_tpu_torch.runtime.pipeline import (
    DeviceOutput,
    HostStaging,
    OverlappedDispatcher,
    device_output,
    dispatch_quantized,
)
from flink_jpmml_tpu_torch.utils.config import RuntimeConfig
from flink_jpmml_tpu_torch.utils.exceptions import InputValidationException
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry


class BlockSource:
    """poll() → (first_offset, block [n,F]) or None when drained/starved."""

    def poll(self) -> Optional[Tuple[int, np.ndarray]]:
        raise NotImplementedError

    @property
    def exhausted(self) -> bool:
        return False


class CyclingBlockSource(BlockSource):
    """Cycles over a fixed dataset in blocks forever (bench/load-gen)."""

    def __init__(self, data: np.ndarray, block_size: int):
        self._data = np.ascontiguousarray(data, np.float32)
        self._block = block_size
        self._pos = 0
        self._offset = 0

    def poll(self):
        n = self._data.shape[0]
        if self._pos + self._block <= n:
            blk = self._data[self._pos : self._pos + self._block]
            self._pos += self._block
        else:
            a = self._data[self._pos :]
            b = self._data[: self._block - a.shape[0]]
            blk = np.concatenate([a, b], axis=0)
            self._pos = self._block - a.shape[0]
        off = self._offset
        self._offset += blk.shape[0]
        return off, blk


class FiniteBlockSource(BlockSource):
    def __init__(self, data: np.ndarray, block_size: int):
        self._data = np.ascontiguousarray(data, np.float32)
        self._block = block_size
        self._pos = 0

    def poll(self):
        if self._pos >= self._data.shape[0]:
            return None
        blk = self._data[self._pos : self._pos + self._block]
        off = self._pos
        self._pos += blk.shape[0]
        return off, blk

    @property
    def exhausted(self) -> bool:
        return self._pos >= self._data.shape[0]


class BoundScorer:
    """One compiled model bound for block scoring: its (maybe) rank-wire
    scorer, the ``rank_wire_*``/``f32`` backend tag, and its decode."""

    def __init__(self, model: CompiledModel, use_quantized: bool):
        self.model = model
        self.q = model.quantized_scorer() if use_quantized else None
        self.backend = (
            f"rank_wire_{self.q.backend}" if self.q is not None else "f32"
        )

    def decode(self, out, n: int):
        if self.q is not None:
            return self.q.decode(out, n)
        return self.model.decode(out, n)


class BlockPipeline:
    """source → ring → batches → rank-wire (or f32) scoring → sink.

    ``sink(out, n: int, first_offset: int)`` receives one completed
    dispatch's host output (a tensor, or the f32 path's
    :class:`ModelOutput` of host tensors) in offset order. ``backend``
    says which scoring path engaged (``rank_wire_cuda`` for the GBM) and
    is also counted in metrics as ``scorer_backend_*``. The model's device
    is the pipeline's device: the card unless it was compiled with
    ``device="cpu"``. Records travel the C++ ring, which raises
    ``NativeBuildError`` when its library cannot be built. The rank-wire
    scorer's ``encode_placement`` says where each batch is encoded
    (``dispatch_quantized``). ``prefetch`` (None = auto: the source's
    own ``prefetchable`` mark) wraps the source in the prefetch sidecar;
    ``FJT_PREFETCH_DISABLE`` turns it off either way.
    """

    def __init__(
        self,
        source: BlockSource,
        model: CompiledModel,
        sink: Callable,
        config: Optional[RuntimeConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
        in_flight: int = 2,
        use_quantized: bool = True,
        max_dispatch_chunks: int = 8,
        prefetch: Optional[bool] = None,
    ):
        if model.batch_size is None:
            raise InputValidationException(
                "BlockPipeline needs a fixed-batch compiled model "
                "(compile_pmml(batch_size=...))"
            )
        self._source = source
        self._sink = sink
        self._arity = model.field_space.arity
        self._batch_size = model.batch_size
        # >1 enables opportunistic multi-chunk dispatch on a backed-up
        # ring (see _aggregate_full_batches); 1 = one batch per dispatch
        self._max_dispatch_chunks = max(1, max_dispatch_chunks)
        self._config = config or RuntimeConfig()
        self.metrics = metrics or MetricsRegistry()
        # pipelined ingest: a prefetchable source (the Kafka source:
        # network fetch + wire decode) is polled on a sidecar thread, so
        # the ingest thread only moves decoded blocks into the ring
        self._source = prefetch_mod.maybe_wrap_block(
            self._source, metrics=self.metrics, enable=prefetch
        )
        self._ring = NativeRing(
            self._config.batch.queue_capacity, self._arity, self._batch_size
        )
        self._in_flight_max = max(1, in_flight)
        self._carry_drain: "List[Tuple[np.ndarray, np.ndarray]]" = []
        # True only for run_until_exhausted's full drain; plain stop()
        # discards the uncommitted ring backlog
        self._drain_all = False
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None
        self.committed_offset = 0
        self.device = model.device
        self._bound = BoundScorer(model, use_quantized)
        self.backend = self._bound.backend
        self.metrics.counter(f"scorer_backend_{self.backend}").inc()
        # the dispatch stream and pinned staging, created on the score
        # thread's first batch
        self._stream = None
        self._staging = None

    @property
    def error(self) -> Optional[BaseException]:
        """The first exception a pipeline thread raised (``join`` re-raises
        it), or None."""
        return self._error

    def decode(self, out, n: int):
        """Sink-received host output → ``Prediction`` list."""
        return self._bound.decode(out, n)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        t1 = threading.Thread(
            target=self._ingest, name="fjt-blk-ingest", daemon=True
        )
        t2 = threading.Thread(
            target=self._score, name="fjt-blk-score", daemon=True
        )
        self._threads = [t1, t2]
        t1.start()
        t2.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        stop_sidecar = getattr(self._source, "stop_prefetch", None)
        if stop_sidecar is not None:
            # park the sidecar before the ring closes, or it would keep
            # fetching into its handoff queue until the process exits
            stop_sidecar()
        self._ring.close()

    def join(self, timeout: Optional[float] = None) -> None:
        for t in self._threads:
            t.join(timeout)
        if self._error is not None:
            raise self._error

    def run_for(self, seconds: float) -> None:
        self.start()
        time.sleep(seconds)
        self.stop()
        self.join(timeout=30.0)

    def run_until_exhausted(self, timeout: float = 60.0) -> None:
        """Deterministic drain: join the ingest thread (it exits once the
        source is exhausted and fully pushed), then close the ring — the
        score loop drains the ring's remainder plus its in-flight window
        before exiting."""
        self.start()
        deadline = time.monotonic() + timeout
        ingest = self._threads[0]
        while ingest.is_alive() and self._error is None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            ingest.join(timeout=min(remaining, 0.05))
        self._drain_all = True
        self.stop()
        self.join(timeout=max(30.0, deadline - time.monotonic()))

    # -- threads -------------------------------------------------------------

    def _ingest(self) -> None:
        records_in = self.metrics.counter("records_in")
        try:
            while not self._stop.is_set():
                polled = self._source.poll()
                if polled is None:
                    if self._source.exhausted:
                        return
                    time.sleep(0.0005)
                    continue
                off, block = polled
                pushed = 0
                while pushed < block.shape[0] and not self._stop.is_set():
                    pushed += self._ring.push_block(
                        block[pushed:], off + pushed, timeout_us=100_000
                    )
                records_in.inc(block.shape[0])
        except BaseException as e:
            self._error = e
            self._stop.set()

    def _aggregate_full_batches(self, X, offsets, bs: int):
        """Opportunistic multi-chunk dispatch: when the first drain came
        back FULL, drain further already-full batches and ship them as
        ONE dispatch (one kernel launch over K × batch rows). K is
        rounded down to a power of two ≤ ``max_dispatch_chunks``; only
        provably-full extra batches are drained, and an offset
        discontinuity (a cycling source's wrap) is carried to the next
        loop iteration as its own dispatch. Drained views alias the
        ring's reuse buffer, hence the copies."""
        avail = 1 + len(self._ring) // bs  # full batches on hand NOW
        k_target = 1
        while k_target * 2 <= avail and k_target * 2 <= self._max_dispatch_chunks:
            k_target *= 2
        if k_target == 1:
            return X, offsets, bs
        parts = [np.array(X, copy=True)]
        off_parts = [np.array(offsets, copy=True)]
        total = bs
        while total < bs * k_target and len(self._ring) >= bs:
            X2, off2 = self._ring.drain(0, 0)
            n2 = X2.shape[0]
            if n2 == 0:
                break
            if n2 < bs or int(off2[0]) != int(off_parts[-1][-1]) + 1:
                self._carry_drain.append(
                    (np.array(X2, copy=True), np.array(off2, copy=True))
                )
                break
            parts.append(np.array(X2, copy=True))
            off_parts.append(np.array(off2, copy=True))
            total += n2
        if len(parts) == 1:
            return parts[0], off_parts[0], bs
        return np.concatenate(parts, axis=0), np.concatenate(off_parts), total

    def _dispatch(self, X, n) -> DeviceOutput:
        """Async dispatch of one drained batch: the rank wire when the
        model is eligible (host-encoded or fused, as the scorer's
        ``encode_placement`` says), the f32 path otherwise. ``X`` may be a view
        of the ring's reused drain buffer: both paths are done with it
        when this returns."""
        q = self._bound.q
        if q is not None:
            return dispatch_quantized(
                q, X, metrics=self.metrics, staging=self._staging
            )
        return self._dispatch_f32(X, n)

    def _dispatch_f32(self, X, n) -> DeviceOutput:
        """f32 path: NaN cells are the missing convention. The mask and the
        zeroed, padded values are made on the host and both cross the bus
        (``h2d_bytes``: 5 bytes a cell, padding rows included)."""
        model = self._bound.model
        M = np.isnan(X)
        Xb = np.where(M, 0.0, X).astype(np.float32)
        target = max(model.batch_size, n)
        if n < target:
            Xb, M, _ = prepare.pad_batch(Xb, M, target)
        self.metrics.counter("h2d_bytes").inc(Xb.nbytes + M.nbytes)
        Xs = torch.from_numpy(Xb).to(self.device, non_blocking=True)
        Ms = torch.from_numpy(M).to(self.device, non_blocking=True)
        return device_output(model.predict(Xs, Ms), Xs)

    def _score(self) -> None:
        batch_cfg = self._config.batch
        records_out = self.metrics.counter("records_out")
        batches = self.metrics.counter("batches")
        fill = self.metrics.counter("batch_fill_records")
        lat = self.metrics.histogram("batch_latency_s")
        ledger = attr_mod.ledger_for(self.metrics)
        # per-registry singletons shared with the source, which stamps
        # event times at fetch; ticked from this loop, no thread of their
        # own
        freshness = fresh_mod.freshness_for(self.metrics)
        monitor = pressure_mod.pressure_for(self.metrics)
        ring_occ = self.metrics.gauge("ring_occupancy")
        ring_cap = float(max(self._config.batch.queue_capacity, 1))

        def _complete(res: DeviceOutput, meta):
            """FIFO completion: sink, then commit — offsets only advance
            past records that reached the sink."""
            n, first_off, t_start = meta
            out = res.result()  # the event wait is booked by the window
            t_sink = time.monotonic()
            self._sink(out, n, first_off)
            t_done = time.monotonic()
            ledger.observe("sink", t_done - t_sink)
            lat.observe(t_done - t_start)
            records_out.inc(n)
            self.committed_offset = first_off + n
            # consume the source's ingest stamps for this offset range
            # (record_staleness_s, the sink watermark)
            freshness.observe_sink(first_off, n)
            monitor.maybe_tick()

        disp = OverlappedDispatcher(
            depth=self._in_flight_max if self._in_flight_max > 1 else 0,
            metrics=self.metrics,
            complete=_complete,
        )
        try:
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
                self._staging = HostStaging(
                    self.device, slots=self._in_flight_max + 2
                )
            with torch.cuda.stream(self._stream):  # None: no-op
                while True:
                    if self._stop.is_set() and not self._drain_all:
                        break  # stop(): skip the uncommitted backlog
                    idle_us = min(batch_cfg.deadline_us, 20_000) if len(disp) else -1
                    # pre-drain occupancy peak-hold for the pressure score
                    monitor.note_ring(min(len(self._ring) / ring_cap, 1.0))
                    if self._carry_drain:
                        X, offsets = self._carry_drain.pop(0)
                    else:
                        X, offsets = self._ring.drain(
                            batch_cfg.deadline_us, idle_us
                        )
                    n = X.shape[0]
                    ring_occ.set(min(len(self._ring) / ring_cap, 1.0))
                    if n == self._batch_size and self._max_dispatch_chunks > 1:
                        X, offsets, n = self._aggregate_full_batches(
                            X, offsets, self._batch_size
                        )
                    if n == 0:
                        if self._ring.closed:
                            break
                        disp.flush()
                        continue
                    # (JAX package hooks not ported here: admission shed,
                    # suspect-mode poison isolation and the DLQ, device-
                    # fault failover, keyed state, journey tracing)
                    first_off = int(offsets[0])
                    # the dispatch-stage watermark advances with this
                    # batch's own ingest-stamp event times
                    freshness.propagate_low_watermark("dispatch", first_off, n)
                    disp.launch(
                        lambda X=X, n=n: self._dispatch(X, n),
                        meta=(n, first_off, time.monotonic()),
                    )
                    batches.inc()
                    fill.inc(n)
                disp.close()  # drain the window: every dispatched batch sinks
        except BaseException as e:
            self._error = e
            self._stop.set()
