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

:class:`BlockPipelineBase` holds the machinery the static
:class:`BlockPipeline` and the dynamic
``serving/block.DynamicBlockPipeline`` share: ingest→ring, the lifecycle
(``start`` / ``stop`` / ``join`` / ``run_for`` / ``run_until_exhausted``),
the score loop, and recovery:

- **checkpoints** (``checkpoint=``, a ``runtime/checkpoint``
  ``CheckpointManager``): the committed offset, the in-flight high-water
  mark and the source's cursor state ride each snapshot; ``restore()``
  seeks the source back to the committed offset (at-least-once replay);
- **poison isolation** (``dlq=``, or the default DLQ beside the
  checkpoints, ``runtime/dlq.py``): a scoring error bisects the failed
  batch by synchronous re-dispatches on the card until single failing
  records remain; those go to the DLQ, clean runs to the sink, and the
  whole range commits. A crash-loop fingerprint at restore turns the
  replay region into suspect mode (markers persisted per sub-dispatch);
- **the device-fault ladder** (``runtime/devfault.py`` +
  ``serving/failover.py``): a device error re-dispatches the
  host-retained batch under full-jitter backoff, an OOM bisects the
  batch size, and a lost context (``chip_loss``) escalates with a raise.
  The ladder arms where a DLQ is wired, with ``failover=<plane>``, or
  with ``FJT_FAILOVER=1``. Every redispatch and bisection probe launches
  ``qtrees_leaf_rows`` on the card: the rank wire has no host tier, so
  when retries run out the ladder re-raises, and an open circuit keeps
  dispatching the rank wire to the card. Only an f32 model whose caller
  asked (``failover=`` or ``FJT_FAILOVER=1``) serves on the host tier.
  For the same reason a transient ``device_error`` inside the OOM
  bisection sends a handle the tier does not serve to the transient rung
  (re-dispatch of that slice under the backoff) instead of bisecting it
  on to one record, where the JAX package's tier takes the record and
  the port's ladder would raise.

Batches are retained past the async dispatch (one private copy each)
only when a DLQ or a failover plane is wired, as in the JAX package.

The prefetch sidecar (``runtime/prefetch.py``) wraps a source that marks
itself ``prefetchable``, as ``KafkaBlockSource`` does; ``prefetch=False``
turns it off, and ``stop()`` parks it before the ring closes. The stage
ledger (``obs/attr.py``: ``encode``, ``h2d``, ``queue_wait`` and
``readback`` from ``runtime/pipeline.py``, ``sink`` here) and the
freshness and pressure planes tick from the score loop. The fault sites
``score_loop`` and ``score_batch`` (with the dispatched offsets) fire
where the JAX package fires them.

The serving edge, as in the JAX package:

- **overload** (``serving/overload.py``): ``batcher=`` (an
  ``AdaptiveBatcher``) caps multi-chunk aggregation at its
  ``max_records()``, observes every completed dispatch's (records,
  latency) — on the card the latency ends after the CUDA event wait, so
  it holds the card's time — and takes the OOM ladder's proven size as a
  hard cap (``note_oom_cap``); ``admission=`` (an
  ``AdmissionController``) sheds whole drained batches under
  ``shed_lane`` (checked against its lanes at construction): a shed batch
  rides the window as an ``accounted=False`` no-op, so its offsets commit
  in FIFO order, it launches no kernel, never reaches the sink, and counts
  in no ``dispatches``. Where the JAX package aggregates a backed-up
  ring's batches and then sheds the aggregate, the port does not
  aggregate while its lane is refused: each drained batch is shed on its
  own, so a shed costs one ring drain and no aggregation copies, and
  shedding drains a full ring faster than the load that filled it. The
  shed and admitted totals and the commit order are the JAX package's;
- **SLO burn rate**: ``slo=`` (an ``obs/slo.SLOTracker``) ticks from the
  completion path;
- **journeys** (``obs/trace.py``, armed by ``FJT_JOURNEY_DIR``): restore,
  suspect mode, one ``dispatch`` hop a batch, the suspect scan's hops and
  its ``dlq`` terminal, the ``shed`` terminal and the ``sink`` hop that
  closes a batch's journey; the batch's context is active around its
  launch and its sink, so spans and exemplars carry its ids. Unarmed,
  every site is one None test;
- **spans** (``obs/spans.py``, ``FJT_TRACE_DIR``): the ``sink`` span here,
  ``featurize`` / ``h2d_dispatch`` / ``readback`` in the dispatcher;
- **device profiling** (``obs/profiler.py``): each scoring launch carries
  ``attr.dispatch_profile`` while the registry's profiler is on
  (``FJT_PROF_SAMPLE``), so a sampled dispatch books the ``device``
  stage, the roofline gauges and the kernel cost ledger.

The mesh (``mesh=``, ``parallel/mesh.Mesh``), as in the JAX package:
the compiled model is promoted to ``parallel/sharding.mesh_sharded``
(the compile batch must divide by the data axis), so it scores on the
f32 path; the in-flight window deepens to cover the data rows
(``parallel/assignment.mesh_in_flight``) and rides the model as carried
``dispatch_state`` with its ``ChipAssignment``; per-chip telemetry
(``obs/mesh.py``) books every delivered batch when there are two or more
data rows. The ``chip_loss`` rung is mesh-aware (``_lost_recover``): a
sharded model rebuilds over the surviving devices
(``ShardedModel.without_devices``), the pipeline adopts the rebuild and
redispatches the retained batch synchronously on the degraded mesh; with
one data row left (a single card's 1×1 mesh included) it escalates with
the raise. CUDA's errors do not name the device, and a sticky error
stays ``chip_loss`` (``runtime/devfault.py``), so on a multi-card mesh
the rung retires the LAST data row, the choice the JAX package makes when
its runtime names no chip. The f32 dispatch pads a batch up to the data
axis after such a rebuild (``runtime/pipeline.dispatch_f32``).

Where it differs: the JAX package's Python ring (its fall-back when the
C++ library cannot be built) is not ported — the ring raises
``NativeBuildError`` instead. The f32 path (``_dispatch_f32``) books the
bytes it ships in ``h2d_bytes``, as the rank-wire path does. ``donate=``
raises :class:`NotPortedError`: the port already reuses its staging
buffers once their H2D copy's event has passed.

Keyed state (``state=``, runtime/state.py), as in the JAX package: a
``StateSpec`` builds the table on the pipeline's device in its registry;
each rank-wire dispatch routes its keys on the host and runs the state
step after the kernel on the pipeline's stream, with the batch's offsets
as the decay clock. The table rides each checkpoint (an ``.npz`` sidecar
beside the snapshots, or an inline payload without a directory) and
``restore()`` brings it back, its ``applied_hi`` making replayed records
bypass it. The recovery ladder and the suspect scan score with the table
disarmed (``_state_bypass``), after it rolled back to its last snapshot,
so a DLQ'd or re-dispatched record never folds into it twice. The sink
sees the stateless output. ``tenant=`` / :meth:`set_tenant` book
delivered records under ``tenant_records{model=...}``.

The data-drift plane (``obs/drift.py``; armed by ``FJT_DRIFT_SAMPLE`` or
``drift.install`` on the pipeline's registry) sees every batch twice, as
in the JAX package: its features in ``dispatch_quantized`` before the
encode, and at the sink its predictions (the read-back host output,
under the decode's ``model_hash``, so only where the dispatch names its
model: the dynamic pipeline) and, on a state-armed pipeline, the derived
session features under ``<model_hash>#state``
(``state.record_derived``). A shed batch never reaches the sink, so it
cannot skew a sketch.

The sink receives host tensors (the pinned buffer the D2H copy filled)
once their dispatch has completed; :meth:`BlockPipeline.decode` turns one
into ``Prediction``s.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.compiler import CompiledModel
from flink_jpmml_tpu_torch.obs import attr as attr_mod
from flink_jpmml_tpu_torch.obs import drift as drift_mod
from flink_jpmml_tpu_torch.obs import freshness as fresh_mod
from flink_jpmml_tpu_torch.obs import pressure as pressure_mod
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.obs import spans
from flink_jpmml_tpu_torch.obs import trace as trace_mod
from flink_jpmml_tpu_torch.runtime import devfault
from flink_jpmml_tpu_torch.runtime import faults
from flink_jpmml_tpu_torch.runtime import prefetch as prefetch_mod
from flink_jpmml_tpu_torch.runtime import state as state_mod
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointPolicy
from flink_jpmml_tpu_torch.runtime.dlq import (
    REASON_CRASH_LOOP,
    REASON_SCORE,
    CrashFingerprint,
    PoisonIsolationOverflow,
    dlq_for_checkpoint,
    env_count,
)
from flink_jpmml_tpu_torch.runtime.native import NativeRing
from flink_jpmml_tpu_torch.runtime.pipeline import (
    DeviceOutput,
    HostStaging,
    OverlappedDispatcher,
    dispatch_f32,
    dispatch_quantized,
)
from flink_jpmml_tpu_torch.utils.config import RuntimeConfig
from flink_jpmml_tpu_torch.utils.exceptions import (
    FlinkJpmmlTpuError,
    InputValidationException,
    refuse,
)
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry


class BlockSource:
    """poll() → (first_offset, block [n,F]) or None when drained/starved."""

    def poll(self) -> Optional[Tuple[int, np.ndarray]]:
        raise NotImplementedError

    def seek(self, offset: int) -> None:
        """Resume hook: next poll starts at this record offset."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support offset seek/resume"
        )

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

    def seek(self, offset: int) -> None:
        self._offset = offset
        self._pos = offset % self._data.shape[0]


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

    def seek(self, offset: int) -> None:
        self._pos = offset

    @property
    def exhausted(self) -> bool:
        return self._pos >= self._data.shape[0]


class BoundScorer:
    """One servable compiled model bound for block scoring: its (maybe)
    rank-wire scorer, the ``rank_wire_*``/``f32`` backend tag, and the
    decode callable (carrying ``model_key``) handed to dynamic sinks.
    Shared by the static and dynamic pipelines."""

    def __init__(self, key: str, model: CompiledModel, use_quantized: bool):
        self.key = key
        self.model = model
        self.q = model.quantized_scorer() if use_quantized else None
        self.backend = (
            f"rank_wire_{self.q.backend}" if self.q is not None else "f32"
        )

        def decode(out, n):
            if self.q is not None:
                return self.q.decode(out, n)
            return self.model.decode(out, n)

        decode.model_key = key
        # the drift plane's content-addressed label: the one the feature
        # profiles of dispatch_quantized are recorded under, so a model's
        # feature and prediction series share one baseline
        decode.model_hash = (
            self.q.model_hash if self.q is not None else None
        )
        self.decode = decode


class _Dispatched:
    """One dispatch in the window: its :class:`DeviceOutput` and the
    decode bound to the model that scored it (None on the static path).
    Readiness and the wait are the output's."""

    __slots__ = ("res", "decode")

    def __init__(self, res: DeviceOutput, decode):
        self.res = res
        self.decode = decode

    def ready(self) -> bool:
        return self.res.ready()

    def synchronize(self) -> None:
        self.res.synchronize()


class BlockPipelineBase:
    """Shared machinery of the static and dynamic block pipelines:
    ingest→ring, lifecycle, the ``_drain_all`` stop protocol, the score
    loop, checkpoints, poison isolation and the device-fault ladder.
    Subclass hooks:

    - ``_acquire(finish_one)`` → per-batch scoring handle (or None to
      abandon the loop — the dynamic pipeline's bounded give-up); called
      with a drained batch pending, between batches.
    - ``_dispatch(handle, X, n)`` → ``(DeviceOutput, decode_or_None)``,
      the async device dispatch.
    - ``_emit(out, n, first_off, decode)`` → deliver to the sink.
    - ``_on_idle()`` — called when the ring drain returns empty on an
      open ring; reachable only when ``_IDLE_WAIT_US >= 0`` bounds the
      drain's wait for a first record.
    """

    _THREAD_TAG = "blk"
    _IDLE_WAIT_US = -1  # block indefinitely for the first record

    def __init__(
        self,
        source: BlockSource,
        sink: Callable,
        arity: int,
        batch_size: int,
        device: torch.device,
        config: Optional[RuntimeConfig],
        metrics: Optional[MetricsRegistry],
        in_flight: int,
        checkpoint,
        max_dispatch_chunks: int = 8,
        dlq=None,
        prefetch: Optional[bool] = None,
        failover=None,
        slo=None,
        batcher=None,
        admission=None,
        shed_lane: str = "block",
        tenant: Optional[str] = None,
        state=None,
    ):
        # per-tenant delivery label (serving/zoo.py plane): records_out
        # stays the total, tenant_records{model=...} adds the tenant axis;
        # the dynamic pipeline re-labels it on a served-model swap
        self._tenant = tenant
        self._source = source
        self._sink = sink
        # optional obs/slo.SLOTracker: ticked from the completion path
        # (between batches, on the score thread), so burn-rate state
        # stays live without a thread of its own
        self._slo = slo
        # overload plane (serving/overload.py), both optional:
        # - batcher: AdaptiveBatcher — caps opportunistic multi-chunk
        #   aggregation at the size predicted to fit the deadline, fed
        #   from every completed dispatch;
        # - admission: AdmissionController — drained batches it refuses
        #   ride the FIFO window as no-op entries (offsets commit in
        #   order, the sink never sees a shed record) under
        #   ``shed_lane``; its controller ticks between batches.
        self._batcher = batcher
        self._admission = admission
        self._shed_lane = shed_lane
        if admission is not None and shed_lane not in admission.lanes:
            # unknown lanes are never shed (the safe per-record
            # default), which here would mean a controller that climbs
            # levels and reports shedding while refusing NOTHING — fail
            # loudly at construction instead
            raise InputValidationException(
                f"shed_lane {shed_lane!r} is not one of the admission "
                f"controller's lanes {admission.lanes!r} — this "
                "pipeline could never shed"
            )
        self._arity = arity
        self._batch_size = batch_size
        self.device = device
        # >1 enables opportunistic multi-chunk dispatch on a backed-up
        # ring (see _aggregate_full_batches); 1 = one batch per dispatch
        self._max_dispatch_chunks = max(1, max_dispatch_chunks)
        self._config = config or RuntimeConfig()
        self.metrics = metrics or MetricsRegistry()
        # pipelined ingest: a prefetchable source (the Kafka source:
        # network fetch + wire decode) is polled on a sidecar thread, so
        # the ingest thread only moves decoded blocks into the ring; the
        # wrapper proxies seek and the checkpoint hooks
        self._source = prefetch_mod.maybe_wrap_block(
            self._source, metrics=self.metrics, enable=prefetch
        )
        self._ring = NativeRing(
            self._config.batch.queue_capacity, arity, batch_size
        )
        self._in_flight_max = max(1, in_flight)
        # drained-but-undispatched batches carried across loop
        # iterations (aggregation stops at an offset discontinuity, and
        # the poison plane splits mid-batch gaps)
        self._carry_drain: "List[Tuple[np.ndarray, np.ndarray]]" = []
        # the aggregate buffer (rows, offsets), made at the first
        # multi-chunk dispatch (see _aggregate_full_batches)
        self._agg = None
        # True only for run_until_exhausted's full drain; plain stop()
        # discards the uncommitted ring backlog
        self._drain_all = False
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None
        self.committed_offset = 0
        self._ckpt = CheckpointPolicy(
            checkpoint, self._config.checkpoint_interval_s,
            metrics=self.metrics,
        )
        # -- delivery-correctness plane (runtime/dlq.py) ------------------
        # the DLQ defaults to living BESIDE the checkpoints; dlq=None with
        # no checkpoint keeps fail-fast (a scoring error stops the worker)
        self._dlq = dlq if dlq is not None else dlq_for_checkpoint(
            checkpoint, metrics=self.metrics
        )
        ckpt_dir = getattr(checkpoint, "directory", None)
        self._ckpt_dir = ckpt_dir
        self._fingerprint = (
            CrashFingerprint(ckpt_dir)
            if (ckpt_dir is not None and self._dlq is not None) else None
        )
        # -- device-fault resilience (runtime/devfault.py +
        #    serving/failover.py) -------------------------------------------
        # the ladder arms where the staging batches are already retained
        # (a DLQ is wired), or explicitly via failover=<plane> /
        # FJT_FAILOVER=1; only the explicit forms let the host tier serve
        # (an f32 model; the rank wire never). failover=False disables.
        asked = bool(os.environ.get("FJT_FAILOVER"))
        if failover is False:
            self._failover = None
        elif failover is not None:
            self._failover = failover
        elif self._dlq is not None or asked:
            from flink_jpmml_tpu_torch.serving import failover as failover_mod

            self._failover = failover_mod.plane_for(
                self.metrics, serve=asked
            )
        else:
            self._failover = None
        # retain the drained batch (private copy) past the async
        # dispatch: poison isolation AND device-fault recovery both
        # re-dispatch from this host-retained copy
        self._retain_batches = (
            self._dlq is not None or self._failover is not None
        )
        # highest offset ever handed to a dispatch (+n): checkpointed as
        # inflight_hi so a restart knows the at-least-once replay region
        self._dispatched_hi = 0
        # replay accounting + crash-loop suspect mode, armed by restore()
        self._replay_until = 0
        self._suspect_until: Optional[int] = None
        self._death_marker: Optional[dict] = None
        self._suspect_gauge = self.metrics.gauge("poison_suspect_mode")
        # synchronous card dispatches the ladder and the suspect scan
        # made beside the window's ``dispatches`` (the port adds it: on
        # the rank wire each is one kernel launch)
        self._redispatches = self.metrics.counter("redispatches")
        # the dispatch stream and pinned staging, created on the score
        # thread's first batch
        self._stream = None
        self._staging = None
        # -- keyed per-record state (runtime/state.py) --------------------
        # a StateSpec builds the table in THIS pipeline's registry on its
        # device; a prebuilt KeyedStateTable passes through
        if isinstance(state, state_mod.StateSpec):
            state = state_mod.KeyedStateTable(
                state, metrics=self.metrics, device=device)
        self._state = state
        # >0 while a recovery / isolation path dispatches: those
        # re-dispatches (and bisection probes, which score records MORE
        # THAN ONCE) must never mutate the table
        self._state_bypass = 0
        # the offsets of the dispatch being launched (the state stage's
        # decay clock and replay guard; the score loop is single-threaded)
        self._cur_offsets = None
        # per-chip mesh telemetry (obs/mesh.MeshTelemetry), attached by
        # the subclass when the bound model is mesh-sharded; None keeps
        # the single-chip completion path one None test
        self._mesh_obs = None

    @property
    def error(self) -> Optional[BaseException]:
        """The first exception a pipeline thread raised (``join`` re-raises
        it), or None."""
        return self._error

    # -- checkpoint / restore -------------------------------------------------

    def _ckpt_state(self) -> dict:
        state = {
            "source_offset": self.committed_offset,
            # [source_offset, inflight_hi) is the at-least-once replay
            # region on restore
            "inflight_hi": max(self._dispatched_hi, self.committed_offset),
        }
        # sources whose resume needs more than the scalar offset (the
        # multi-partition Kafka cursor vector) embed it
        snap = getattr(self._source, "checkpoint_state", None)
        if snap is not None:
            extra = snap(self.committed_offset)
            if extra is not None:
                state["source_state"] = extra
        if self._state is not None:
            # the keyed state table rides the checkpoint: an npz sidecar
            # beside the snapshots referenced by name, or an inline payload
            # for a small dirless table. Saved at the same instant as the
            # offsets, on the score thread; the table's own applied_hi
            # makes replayed records below it bypass after restore
            ref = (
                self._state.save_sidecar(self._ckpt_dir)
                if self._ckpt_dir is not None else None
            )
            if ref is not None:
                state["state_sidecar"] = ref
            else:
                try:
                    state["state"] = self._state.to_payload()
                except Exception:
                    # a large table with no checkpoint directory: state
                    # is not durable, offsets stay correct
                    pass
        return state

    def restore(self) -> bool:
        """Resume from the latest checkpoint: seek the source to the last
        committed record offset (commit happens after sink). A
        source-state payload takes precedence. → False when no snapshot
        exists (the crash-loop fingerprint still counts the restore)."""
        state = self._ckpt.restore_latest()
        if state is None:
            self._init_poison_state({})
            return False
        off = int(state.get("source_offset", 0))
        sstate = state.get("source_state")
        rst = getattr(self._source, "restore_state", None)
        if sstate is not None and rst is not None:
            off = int(rst(sstate))
        else:
            self._source.seek(off)
        self.committed_offset = off
        self._init_poison_state(state)
        self._restore_extra(state)
        return True

    def _init_poison_state(self, state: dict) -> None:
        """Crash-loop fingerprinting at restore: count consecutive
        restores stuck at the same committed offset (``crashes.json``
        beside the checkpoints) and read ``FJT_RESTART_STREAK`` — either
        crossing ``FJT_POISON_RESTARTS`` flips the checkpoint's in-flight
        range into suspect mode."""
        self._replay_until = max(
            int(state.get("inflight_hi", 0)), self.committed_offset
        )
        if self._fingerprint is None:
            return
        committed = self.committed_offset
        count = self._fingerprint.note_restore(committed)
        streak = env_count("FJT_RESTART_STREAK", 0)
        self._death_marker = self._fingerprint.read_marker()
        if (
            self._death_marker is not None
            and self._death_marker["hi"] <= committed
        ):
            # marker from a range that later committed: stale
            self._death_marker = None
            self._fingerprint.clear_marker()
        jstore = trace_mod.store_for(self.metrics)
        if jstore is not None:
            # the incarnation boundary, durable: the pid change + the
            # committed offset this restore resumed at
            jstore.hop(
                "restore", trace_mod.context_for(committed),
                first_off=committed, durable=True,
                restarts=max(count - 1, streak),
            )
        threshold = env_count("FJT_POISON_RESTARTS", 3)
        if max(count - 1, streak) >= threshold:
            hi = self._replay_until
            if hi <= committed:
                hi = committed + self._batch_size
            self._suspect_until = hi
            self._suspect_gauge.set(1.0)
            if jstore is not None:
                # suspect mode flips the journey store to write-through:
                # every hop of the bisection protocol must be on disk
                # BEFORE a process-killing record strikes again
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

    def _restore_extra(self, state: dict) -> None:
        """Restore what ``_ckpt_state`` added past the offsets: the keyed
        state table (subclasses extend it)."""
        if self._state is None:
            return
        ref = state.get("state_sidecar")
        if ref and self._ckpt_dir is not None:
            self._state.restore_sidecar(self._ckpt_dir, ref)
        elif state.get("state"):
            self._state.from_payload(state["state"])

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        t1 = threading.Thread(
            target=self._ingest,
            name=f"fjt-{self._THREAD_TAG}-ingest",
            daemon=True,
        )
        t2 = threading.Thread(
            target=self._score,
            name=f"fjt-{self._THREAD_TAG}-score",
            daemon=True,
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

    # -- subclass hooks --------------------------------------------------------

    def _acquire(self, finish_one):
        raise NotImplementedError

    def _dispatch(self, handle, X, n):
        raise NotImplementedError

    def _emit(self, out, n, first_off, decode) -> None:
        self._sink(out, n, first_off)

    def _on_idle(self) -> None:
        pass

    # -- dispatch --------------------------------------------------------------

    def _aggregate_full_batches(self, X, offsets, bs: int):
        """Opportunistic multi-chunk dispatch: when the first drain came
        back FULL, drain further already-full batches and ship them as
        ONE dispatch (one kernel launch over K × batch rows). K is
        rounded down to a power of two ≤ ``max_dispatch_chunks``; only
        provably-full extra batches are drained, and an offset
        discontinuity (a cycling source's wrap) is carried to the next
        loop iteration as its own dispatch. Drained views alias the
        ring's reuse buffer, so each batch is copied once, into the
        pipeline's aggregate buffer; the returned arrays are views of it,
        valid until the next aggregation (every dispatch path is done with
        its batch when it returns, and a retained batch is copied)."""
        avail = 1 + len(self._ring) // bs  # full batches on hand NOW
        k_cap = self._max_dispatch_chunks
        if self._batcher is not None:
            # deadline-aware aggregation cap: a backed-up ring wants the
            # biggest dispatch, the deadline wants the smallest — the
            # capacity model's max_records() is where they meet (None =
            # no deadline/no fit yet: keep the static cap)
            mr = self._batcher.max_records()
            if mr is not None:
                k_cap = min(k_cap, max(1, mr // bs))
        k_target = 1
        while k_target * 2 <= avail and k_target * 2 <= k_cap:
            k_target *= 2
        if k_target == 1:
            return X, offsets, bs
        # one copy a drained batch, into an aggregate buffer the pipeline
        # keeps (already faulted in after its first use): the dispatch is
        # done with it when it returns, and each drain reuses the ring's
        # buffer, so the first batch moves out before the next drain
        rows = bs * self._max_dispatch_chunks
        agg = self._agg
        if (agg is None or agg[0].shape[0] < rows
                or agg[0].shape[1:] != X.shape[1:]):
            agg = self._agg = (
                np.empty((rows,) + X.shape[1:], X.dtype),
                np.empty(rows, offsets.dtype),
            )
        buf, obuf = agg
        buf[:bs] = X
        obuf[:bs] = offsets
        total = bs
        while total < bs * k_target and len(self._ring) >= bs:
            X2, off2 = self._ring.drain(0, 0)
            n2 = X2.shape[0]
            if n2 == 0:
                break
            if n2 < bs or int(off2[0]) != int(obuf[total - 1]) + 1:
                self._carry_drain.append(
                    (np.array(X2, copy=True), np.array(off2, copy=True))
                )
                break
            buf[total:total + n2] = X2
            obuf[total:total + n2] = off2
            total += n2
        return buf[:total], obuf[:total], total

    def _shedding(self) -> bool:
        """True while the admission controller refuses this pipeline's
        lane: the drained batch is about to be shed, so aggregating more
        batches into it would only add host copies to a shed (the port
        sheds drained batches one at a time; the JAX package aggregates
        first). The decision itself stays ``admit``'s."""
        adm = self._admission
        return (
            adm is not None and adm.enabled
            and self._shed_lane in adm.shed_lanes()
        )

    def _dispatch_bound(self, bound: BoundScorer, X, n) -> DeviceOutput:
        """Async dispatch of one drained batch through a
        :class:`BoundScorer`: the rank wire when the model is eligible
        (host-encoded or fused, as the scorer's ``encode_placement``
        says), the f32 path otherwise. ``X`` may be a view of the ring's
        reused drain buffer: both paths are done with it when this
        returns."""
        if bound.q is not None:
            # keyed state arms here and only here: the recovery ladder and
            # bisection probes raise _state_bypass
            st = (self._state if self._state is not None
                  and not self._state_bypass else None)
            return dispatch_quantized(
                bound.q, X, metrics=self.metrics, staging=self._staging,
                state=st,
                offsets=self._cur_offsets if st is not None else None,
            )
        if self._state is not None and not self._state_bypass:
            raise InputValidationException(
                "stateful scoring requires the rank-wire scorer (the f32 "
                "dispatch cannot carry the state stage)"
            )
        return self._dispatch_f32(bound.model, X)

    def _dispatch_f32(self, model, X) -> DeviceOutput:
        """f32 path: NaN cells are the missing convention. The mask and the
        zeroed, padded values are made on the host and both cross the bus
        (``h2d_bytes``: 5 bytes a cell, padding rows included;
        ``dispatch_f32`` pads up to a mesh-sharded model's data axis)."""
        M = np.isnan(X)
        Xb = np.where(M, 0.0, X).astype(np.float32)
        return dispatch_f32(model, Xb, M, metrics=self.metrics)

    def _dispatch_checked(self, handle, X, n, offsets) -> _Dispatched:
        """The one dispatch entry carrying the batch's offsets past the
        fault harness: ``poison_record`` faults match against exactly the
        range being scored, so bisection isolates an injected poison the
        same way it isolates a real one."""
        faults.fire("score_batch", offsets=offsets)
        self._cur_offsets = offsets  # state decay clock + replay guard
        res, decode = self._dispatch(handle, X, n)
        return _Dispatched(res, decode)

    # -- poison isolation and the device-fault ladder --------------------------

    def _on_dispatch_error(self, out, meta, error) -> bool:
        """Dispatcher error hook, with device-fault triage FIRST: a sick
        card runs the recovery ladder and record poison the suspect scan.
        → False (re-raise) when the entry carries no retained batch or the
        matching plane is not wired, or for a shed no-op."""
        n, first_off, t_start, shed, handle, X, offsets, ctx = meta
        if shed or X is None or offsets is None:
            return False
        if self._state is not None and not self._state_bypass:
            # the failed dispatch may have committed a poisoned update,
            # and later in-flight batches chained on it: restore the last
            # snapshot before any recovery re-dispatch (bounded, counted
            # loss: state_rollbacks); the recovery paths score statelessly
            self._state.rollback()
        kind = devfault.classify(error)
        if kind is not None:
            if self._failover is None:
                return False  # fail fast: die, restart
            self._device_recover(handle, X, offsets, error, kind, ctx=ctx)
            return True
        if self._dlq is None:
            return False
        self._suspect_scan(handle, X, offsets, error=error, ctx=ctx)
        return True

    def _redispatch_sync(self, handle, X, n, offsets) -> _Dispatched:
        """One synchronous re-dispatch of a host-retained batch through
        the real dispatch path (fault sites included, so an injected
        persistent fault keeps failing here exactly like a real one) →
        the completed dispatch."""
        faults.fire("device_dispatch")
        self._state_bypass += 1  # recovery re-scores: never re-fold state
        try:
            d = self._dispatch_checked(handle, X, n, offsets)
        finally:
            self._state_bypass -= 1
        self._redispatches.inc()
        faults.fire("device_readback")
        d.synchronize()
        return d

    def _emit_recovered(self, d: _Dispatched, offsets, lo, hi,
                        ctx=None, t0=None) -> None:
        """Deliver + commit one recovered run (redispatch, OOM sub-batch
        or host-tier score): sink in offset order, freshness stamps
        consumed, offsets committed — the failed dispatch never reached
        the completion callback, so nothing is delivered twice."""
        n_run = hi - lo
        first = int(offsets[lo])
        self._emit(d.res.result(), n_run, first, d.decode)
        self.metrics.counter("records_out").inc(n_run)
        self._book_tenant(n_run)
        fresh_mod.freshness_for(self.metrics).observe_sink(first, n_run)
        jstore = trace_mod.store_for(self.metrics)
        if jstore is not None:
            c = ctx if ctx is not None else trace_mod.context_for(first)
            jstore.hop(
                "sink", c.child(), first, n_run, durable=True,
                recovered=True,
            )
        if t0 is not None:
            # host-tier batches are real deliveries: their latency
            # belongs in the histogram
            self.metrics.histogram("batch_latency_s").observe(
                time.monotonic() - t0
            )
        self.committed_offset = int(offsets[hi - 1]) + 1
        self._ckpt.maybe_save(self._ckpt_state)

    def _device_recover(self, handle, X, offsets, error, kind,
                        ctx=None) -> None:
        """The recovery ladder for one device-classified dispatch
        failure: (1) transient errors re-dispatch the retained batch
        under the shared full-jitter backoff; (2) OOM bisects the BATCH
        SIZE (never the records); (3) exhausted retries fall through to
        the host tier where it serves, else re-raise; (4) a lost context
        escalates with a raise. The OOM rung feeds its proven size to the
        adaptive batcher as a hard cap."""
        from flink_jpmml_tpu_torch.utils.retry import Backoff

        plane = self._failover
        n = int(X.shape[0])
        first = int(offsets[0])
        key = getattr(handle, "key", None) or "default"
        plane.note_fault(kind, key, first_off=first, n=n, error=error)
        if kind == devfault.KIND_LOST:
            self._lost_recover(handle, X, offsets, error, ctx=ctx)
            return
        breaker = plane.breaker_for(key)
        breaker.record_failure(kind)
        if kind == devfault.KIND_OOM:
            self._oom_recover(handle, X, offsets, error, ctx=ctx)
            return
        bo = Backoff(
            "device", base_s=0.02, cap_s=0.5,
            max_attempts=plane.retries,
        )
        while not bo.exhausted:
            bo.sleep()
            try:
                d = self._redispatch_sync(handle, X, n, offsets)
            except Exception as e2:
                k2 = devfault.classify(e2)
                if k2 is None:
                    # the device fault cleared and a RECORD error
                    # surfaced underneath: poison's jurisdiction
                    if self._dlq is not None:
                        self._suspect_scan(
                            handle, X, offsets, error=e2, ctx=ctx
                        )
                        return
                    raise
                plane.note_fault(k2, key, first_off=first, n=n, error=e2)
                if k2 == devfault.KIND_LOST:
                    self._lost_recover(handle, X, offsets, e2, ctx=ctx)
                    return
                breaker.record_failure(k2)
                if k2 == devfault.KIND_OOM:
                    self._oom_recover(handle, X, offsets, e2, ctx=ctx)
                    return
                error = e2
                continue
            breaker.record_success()
            plane.redispatch_records.inc(n)
            flight.record(
                "device_redispatch", model=key, first=first, n=n,
                attempts=bo.attempts,
            )
            self._emit_recovered(d, offsets, 0, n, ctx=ctx)
            return
        # retries exhausted: the host tier serves where it may (an f32
        # model whose caller asked); the rank wire escalates
        if plane.tier.supports(handle):
            self._serve_fallback(handle, X, offsets, jctx=ctx)
            return
        raise error

    def set_tenant(self, tenant) -> None:
        """Re-label delivered records (the dynamic block pipeline calls
        this on a served-model swap, so tenant_records follows the key
        actually serving)."""
        self._tenant = tenant

    def _book_tenant(self, n: int) -> None:
        if self._tenant is not None:
            self.metrics.counter(
                f'tenant_records{{model="{self._tenant}"}}'
            ).inc(n)

    def _lost_recover(self, handle, X, offsets, error, ctx=None) -> None:
        """The ``chip_loss`` rung of the ladder, mesh-aware: a sharded
        model rebuilds over the surviving devices in place
        (``ShardedModel.without_devices`` — dispatcher state and the
        partition/key assignment carry through) and the retained batch
        redispatches synchronously on the degraded mesh: zero loss,
        (N−1)/N capacity, no process restart. A single-device model (or
        an unsurvivable mesh, or one data row left) keeps the single-chip
        contract — escalate to the supervisor with the raise. A sticky
        CUDA error leaves that device's context unusable, so an
        in-process retry on it could not succeed anyway."""
        plane = self._failover
        n = int(X.shape[0])
        first = int(offsets[0])
        key = getattr(handle, "key", None) or "default"
        rebuilt = self._mesh_rebuild(handle, error)
        if rebuilt is None:
            flight.record(
                "device_lost_escalate", model=key, first=first, n=n,
                error=repr(error),
            )
            raise error
        try:
            d = self._redispatch_sync(handle, X, n, offsets)
        except Exception as e2:
            k2 = devfault.classify(e2)
            if k2 is None:
                # the chip loss cleared and a RECORD error surfaced
                # underneath: poison's jurisdiction
                if self._dlq is not None:
                    self._suspect_scan(
                        handle, X, offsets, error=e2, ctx=ctx
                    )
                    return
                raise
            # the degraded mesh is live but THIS dispatch failed again:
            # re-enter the ladder from the top (another chip_loss shrinks
            # once more — bounded, without_devices raises once no full
            # data row survives)
            self._device_recover(handle, X, offsets, e2, k2, ctx=ctx)
            return
        plane.redispatch_records.inc(n)
        flight.record(
            "mesh_rebuild_redispatch", model=key, first=first, n=n,
            data=rebuilt.batch_divisor,
        )
        self._emit_recovered(d, offsets, 0, n, ctx=ctx)

    def _mesh_rebuild(self, handle, error):
        """Chip loss on a mesh-sharded model: rebuild over the survivors
        and adopt the rebuilt model into the live scoring handle → the
        rebuilt ``ShardedModel``, or None when there is no mesh to shrink
        (single-device model, one data row left) or no survivable
        rebuild."""
        model = getattr(handle, "model", None)
        if not hasattr(model, "without_devices"):
            return None
        lost = self._lost_devices(model, error)
        if not lost:
            return None
        try:
            rebuilt = model.without_devices(lost)
        except FlinkJpmmlTpuError:
            return None  # unsurvivable: escalate like a single chip
        self._adopt_rebuilt(handle, rebuilt)
        self.metrics.counter("mesh_rebuilds").inc()
        self.metrics.gauge("mesh_lost_devices").set(float(len(lost)))
        if self._mesh_obs is not None:
            self._mesh_obs.note_rebuild(rebuilt, lost)
        from flink_jpmml_tpu_torch.parallel.mesh import device_id

        flight.record(
            "mesh_rebuild",
            lost=[str(device_id(d)) for d in lost],
            data=rebuilt.batch_divisor,
        )
        return rebuilt

    def _lost_devices(self, model, error) -> list:
        """Which device(s) died. CUDA's errors do not name the device, so
        an explicit ``error.devices`` / ``error.device`` attribute wins;
        otherwise the LAST data row of the mesh is retired — retiring any
        one full row restores (N−1)/N capacity with the model axis
        intact, and last-row is the choice every process derives
        identically with no coordination (row identity — the first
        device of each surviving row — is what the carried
        ChipAssignment's rendezvous weights key on, so survivor rows keep
        their partitions and keys)."""
        dev = getattr(error, "devices", None)
        if dev is None:
            dev = getattr(error, "device", None)
        if dev is not None:
            if isinstance(dev, (list, tuple, set, frozenset)):
                return list(dev)
            return [dev]
        mesh = getattr(model, "mesh", None)
        if mesh is None:
            return []
        from flink_jpmml_tpu_torch.parallel.mesh import DATA_AXIS

        rows = mesh.devices.reshape(mesh.shape[DATA_AXIS], -1)
        if rows.shape[0] <= 1:
            return []  # one data row left: nothing to shrink onto
        return list(rows[-1])

    def _adopt_rebuilt(self, handle, rebuilt) -> None:
        """Swap the rebuilt model into the live scoring handle (the
        BoundScorer's decode closure follows ``handle.model``, so the
        sink path needs no rebind)."""
        handle.model = rebuilt
        if self._state is not None:
            # chip loss moves state WITH its keys: slot = hash % capacity
            # is mesh-independent, so re-placing the value rows over the
            # survivors preserves every key's state
            mesh = getattr(rebuilt, "mesh", None)
            if mesh is not None:
                self._state.migrate(mesh)

    def _oom_recover(self, handle, X, offsets, error, ctx=None) -> None:
        """Device-OOM ladder step: bisect the BATCH SIZE until runs fit
        and deliver each run in offset order, then feed the largest size
        that fit to the adaptive batcher as a hard cap. Records are never
        quarantined — an allocator refusal says nothing about the
        data."""
        plane = self._failover
        n = int(X.shape[0])
        key = getattr(handle, "key", None) or "default"
        state = {"max_ok": 0}

        def attempt(lo: int, hi: int) -> None:
            size = hi - lo
            try:
                d = self._redispatch_sync(
                    handle, X[lo:hi], size, offsets[lo:hi]
                )
            except Exception as e2:
                k2 = devfault.classify(e2)
                if k2 is None:
                    if self._dlq is not None:
                        self._suspect_scan(
                            handle, X[lo:hi], offsets[lo:hi],
                            error=e2, ctx=ctx,
                        )
                        return
                    raise
                if (k2 == devfault.KIND_ERROR
                        and not plane.tier.supports(handle)):
                    # no host tier below the slice (module docstring):
                    # the transient rung re-dispatches it
                    self._device_recover(
                        handle, X[lo:hi], offsets[lo:hi], e2, k2, ctx=ctx
                    )
                    return
                plane.note_fault(
                    k2, key, first_off=int(offsets[lo]), n=size,
                    error=e2,
                )
                if k2 == devfault.KIND_LOST:
                    self._lost_recover(
                        handle, X[lo:hi], offsets[lo:hi], e2, ctx=ctx
                    )
                    return
                plane.breaker_for(key).record_failure(k2)
                if size == 1:
                    # one record alone exceeds the card: the host tier
                    # serves it where it may, or the worker escalates —
                    # a sick card never quarantines a clean record
                    if plane.tier.supports(handle):
                        self._serve_fallback(
                            handle, X[lo:hi], offsets[lo:hi], jctx=ctx
                        )
                        return
                    raise e2
                mid = (lo + hi) // 2
                attempt(lo, mid)
                attempt(mid, hi)
                return
            state["max_ok"] = max(state["max_ok"], size)
            plane.redispatch_records.inc(size)
            self._emit_recovered(d, offsets, lo, hi, ctx=ctx)

        attempt(0, n)
        plane.oom_shrinks.inc()
        cap = state["max_ok"] or None
        if cap and self._batcher is not None:
            cap = self._batcher.note_oom_cap(cap)
        flight.record(
            "oom_batch_shrink", model=key, from_records=n,
            to_records=cap,
        )
        plane.record_success(key)

    def _fallback_dispatch(self, handle, X, n) -> _Dispatched:
        """Host-tier scoring hook → the completed dispatch in the
        subclass's sink shape (the static path's sink takes no decode)."""
        return _Dispatched(
            DeviceOutput(self._failover.tier.score_bound(handle, X)), None
        )

    def _fallback_checked(self, handle, X, n, offsets) -> _Dispatched:
        """The host tier's ``_dispatch_checked`` twin: still a real
        scoring site, so record-targeted faults strike it too."""
        faults.fire("score_batch", offsets=offsets)
        return self._fallback_dispatch(handle, X, n)

    def _serve_fallback(self, handle, X, offsets, jctx=None) -> None:
        """Score one batch on the host tier (an f32 model whose caller
        asked for it) — degraded, not down. Record poison that surfaces
        here isolates on the host tier, never by re-dispatching to the
        sick card."""
        plane = self._failover
        n = int(X.shape[0])
        first = int(offsets[0])
        key = getattr(handle, "key", None) or "default"
        # the host tier IS the dispatch stage while degraded
        fresh_mod.freshness_for(self.metrics).propagate_low_watermark(
            "dispatch", first, n
        )
        t0 = time.monotonic()
        try:
            d = self._fallback_checked(handle, X, n, offsets)
        except Exception as e:
            if devfault.classify(e) is not None or self._dlq is None:
                raise
            self._suspect_scan(
                handle, X, offsets, error=e, ctx=jctx,
                dispatch=self._fallback_checked,
            )
            return
        plane.note_fallback(n, key)
        self._emit_recovered(d, offsets, 0, n, ctx=jctx, t0=t0)

    def _suspect_scan(
        self, handle, X, offsets, error, persist: bool = False,
        ctx=None, dispatch=None,
    ) -> None:
        """Bisection ("suspect mode") over one failed batch: dispatch
        halves synchronously until the offending record(s) are single —
        those go to the DLQ (never the sink); every clean run proceeds to
        the sink in offset order. The whole range then commits, so a
        restart never replays the quarantined record back to life.

        ``persist=True`` (crash-loop fingerprint mode) writes the suspect
        MARKER before every sub-dispatch: a record that kills the process
        narrows the marker by one bisection level per incarnation, and a
        single-record marker is quarantined without being dispatched.

        More than ``FJT_DLQ_MAX_PER_BATCH`` quarantines in one batch
        aborts isolation (:class:`PoisonIsolationOverflow`).

        ``dispatch`` overrides the sub-dispatch primitive (default: the
        card's ``_dispatch_checked``; the host tier passes its twin)."""
        on_card = dispatch is None
        dispatch = dispatch if dispatch is not None else (
            self._dispatch_checked
        )
        if self._state is not None:
            # bisection probes score records MORE THAN ONCE (and DLQ'd
            # records must never land at all): every sub-dispatch of the
            # scan runs with the state stage disarmed
            inner_dispatch = dispatch

            def dispatch(h, Xs, ns, os_, _inner=inner_dispatch):
                self._state_bypass += 1
                try:
                    return _inner(h, Xs, ns, os_)
                finally:
                    self._state_bypass -= 1
        n = int(X.shape[0])
        if n == 0:
            return
        freshness = fresh_mod.freshness_for(self.metrics)
        records_out = self.metrics.counter("records_out")
        cap = env_count("FJT_DLQ_MAX_PER_BATCH", 32)
        state = {"q": 0}
        # journey trail (obs/trace.py): isolation is exactly the story
        # a journey exists to tell, so every bisection hop is durable
        jstore = trace_mod.store_for(self.metrics)
        if ctx is None and jstore is not None:
            ctx = trace_mod.context_for(int(offsets[0]))
        if jstore is not None:
            jstore.hop(
                "suspect_scan", ctx, int(offsets[0]), n, durable=True,
                persist=persist,
                error=None if error is None else repr(error),
            )
        flight.record(
            "poison_isolation",
            first=int(offsets[0]), n=n, persist=persist,
            error=None if error is None else repr(error),
            trace_id=None if ctx is None else ctx.trace_id,
        )
        self._suspect_gauge.set(1.0)

        def quarantine(i: int, exc, reason=REASON_SCORE, attempts=1):
            if state["q"] >= cap:
                raise PoisonIsolationOverflow(
                    state["q"], exc if exc is not None else error
                )
            state["q"] += 1
            off = int(offsets[i])
            # the terminal hop + the envelope's trace context: the ids
            # the DLQ carries are what a redrive stamps into the
            # traceparent header, linking the redriven journey segment
            rctx = trace_mod.TraceContext(
                trace_mod.trace_id_for(off),
                parent_id=None if ctx is None else ctx.span_id,
            )
            if jstore is not None:
                jstore.terminal(
                    "dlq", rctx, offset=off, reason=reason,
                    attempts=attempts,
                )
            self._dlq.quarantine(
                X[i].tobytes(), offset=off, reason=reason, error=exc,
                attempts=attempts, model=getattr(handle, "key", None),
                trace_id=rctx.trace_id, span_id=rctx.span_id,
            )
            # a quarantined record was DROPPED, not delivered: its
            # ingest stamp must not advance the sink watermark
            freshness.discard_stamps(off, 1)

        def emit_run(d: _Dispatched, lo: int, hi: int):
            n_run = hi - lo
            first = int(offsets[lo])
            self._emit(d.res.result(), n_run, first, d.decode)
            records_out.inc(n_run)
            self._book_tenant(n_run)
            if jstore is not None:
                jstore.hop(
                    "sink", ctx.child(), first, n_run, durable=True,
                    isolated=True,
                )
            freshness.observe_sink(first, n_run)

        def scan(lo: int, hi: int):
            if hi <= lo:
                return
            n_sub = hi - lo
            off_lo, off_hi = int(offsets[lo]), int(offsets[hi - 1]) + 1
            dm = self._death_marker if persist else None
            if dm is not None and off_lo <= dm["lo"] and dm["hi"] <= off_hi:
                # a previous incarnation DIED dispatching dm's range
                if dm["hi"] - dm["lo"] == 1:
                    hit = np.nonzero(
                        offsets[lo:hi] == np.uint64(dm["lo"])
                    )[0]
                    if hit.size:
                        i = lo + int(hit[0])
                        scan(lo, i)
                        quarantine(
                            i, None, reason=REASON_CRASH_LOOP,
                            attempts=dm.get("attempts", 1),
                        )
                        self._death_marker = None
                        self._fingerprint.clear_marker()
                        scan(i + 1, hi)
                        return
                elif n_sub > 1:
                    # never re-dispatch a span that already killed a
                    # process whole: split first
                    mid = (lo + hi) // 2
                    scan(lo, mid)
                    scan(mid, hi)
                    return
            if persist and self._fingerprint is not None:
                attempts = 1
                if (
                    dm is not None
                    and dm["lo"] == off_lo and dm["hi"] == off_hi
                ):
                    attempts = dm.get("attempts", 1) + 1
                self._fingerprint.write_marker(off_lo, off_hi, attempts)
                if jstore is not None:
                    # the marker's journey twin, written BEFORE the
                    # sub-dispatch: if this range kills the process the
                    # hop survives
                    jstore.hop(
                        "suspect_dispatch", ctx.child(),
                        off_lo, off_hi - off_lo, durable=True,
                        attempts=attempts,
                    )
            try:
                d = dispatch(handle, X[lo:hi], n_sub, offsets[lo:hi])
                if on_card:
                    self._redispatches.inc()
                d.synchronize()
            except PoisonIsolationOverflow:
                raise
            except Exception as e:
                if devfault.classify(e) is not None:
                    # a SICK CARD mid-bisection is not record poison:
                    # quarantining clean records for it is the one thing
                    # this scan must never do — escalate
                    raise
                if n_sub == 1:
                    quarantine(lo, e)
                    return
                mid = (lo + hi) // 2
                scan(lo, mid)
                scan(mid, hi)
                return
            emit_run(d, lo, hi)

        try:
            scan(0, n)
        finally:
            self._suspect_gauge.set(
                1.0 if self._suspect_until is not None else 0.0
            )
        if persist and self._fingerprint is not None:
            self._fingerprint.clear_marker()
            self._death_marker = None
        # the WHOLE range commits — quarantined offsets included
        self.committed_offset = int(offsets[-1]) + 1
        if state["q"]:
            flight.record(
                "poison_isolated", quarantined=state["q"],
                first=int(offsets[0]), n=n,
            )
        self._ckpt.maybe_save(self._ckpt_state)

    def _exit_suspect_mode(self) -> None:
        flight.record(
            "poison_suspect_exit", committed=self.committed_offset
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
                trace_mod.context_for(self.committed_offset),
                first_off=self.committed_offset, durable=True,
            )
            # back to tail-sampled buffering — unless a fault drill (or
            # FJT_JOURNEY_SYNC) armed write-through for the process
            jstore.write_through = bool(
                faults.active() or os.environ.get("FJT_JOURNEY_SYNC")
            )

    # -- threads ---------------------------------------------------------------

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

    def _score(self) -> None:
        batch_cfg = self._config.batch
        records_out = self.metrics.counter("records_out")
        batches = self.metrics.counter("batches")
        fill = self.metrics.counter("batch_fill_records")
        lat = self.metrics.histogram("batch_latency_s")
        replayed = self.metrics.counter("records_replayed")
        ledger = attr_mod.ledger_for(self.metrics)
        # per-registry singletons shared with the source, which stamps
        # event times at fetch; ticked from this loop, no thread of their
        # own
        freshness = fresh_mod.freshness_for(self.metrics)
        monitor = pressure_mod.pressure_for(self.metrics)
        # record-journey tracing (obs/trace.py): None unless
        # FJT_JOURNEY_DIR armed it — one env check at loop start, and
        # with it None every per-batch site below is a None test
        jstore = trace_mod.store_for(self.metrics)
        # the data-drift plane (obs/drift.py): None unless FJT_DRIFT_SAMPLE
        # is set or a caller installed one — predictions are sketched at
        # the sink, features already rode dispatch_quantized
        dplane = drift_mod.plane_for(self.metrics)
        ring_occ = self.metrics.gauge("ring_occupancy")
        ring_cap = float(max(self._config.batch.queue_capacity, 1))

        def _complete(d: Optional[_Dispatched], meta):
            """FIFO completion: sink, then commit — offsets only advance
            past records that reached the sink. A SHED entry (admission
            refusal, a no-op through the same FIFO window) commits its
            offsets and consumes its freshness stamps without ever
            touching the sink."""
            n, first_off, t_start, shed, handle = meta[:5]
            jctx = meta[7]
            if first_off < self._replay_until:
                # at-least-once replay accounting: records below the
                # previous incarnation's in-flight high-water mark
                replayed.inc(min(n, self._replay_until - first_off))
            if shed:
                self.committed_offset = first_off + n
                freshness.discard_stamps(first_off, n)
                self._ckpt.maybe_save(self._ckpt_state)
                monitor.maybe_tick()
                return
            out = d.res.result()  # the event wait is booked by the window
            # a state-armed dispatch returns (score_out, derived): the sink
            # sees exactly the stateless output shape, and the derived
            # session features feed the drift plane under the model's
            # "#state" label (state corruption surfaces as feature drift)
            out, derived = state_mod.split_output(out)
            t_sink = time.monotonic()
            # the completing batch's OWN context wraps the sink: its span
            # (and any exemplar the sink stage captures) carries THIS
            # journey's ids
            with trace_mod.use(jctx):
                self._emit(out, n, first_off, d.decode)
                t_done = time.monotonic()
                spans.emit(
                    "sink", t_sink, t_done - t_sink, n=n,
                    first_off=first_off,
                )
                ledger.observe("sink", t_done - t_sink)
            if dplane is not None:
                # score-distribution sketch at the sink (sampled), on the
                # read-back host output
                dplane.record_predictions(
                    getattr(d.decode, "model_hash", None)
                    or getattr(d.decode, "model_key", None),
                    out, n,
                )
                if derived is not None:
                    state_mod.record_derived(
                        dplane, self._state,
                        getattr(getattr(handle, "q", None), "model_hash",
                                None),
                        derived, n,
                    )
            if jstore is not None and jctx is not None:
                # the sink hop closes the journey: tail-sampling keeps
                # it only if it is interesting (exemplar-marked, head
                # sample, terminal elsewhere)
                jstore.finish(
                    jctx, first_off, n, latency_s=t_done - t_start,
                )
            lat.observe(t_done - t_start)
            records_out.inc(n)
            self._book_tenant(n)
            if self._mesh_obs is not None:
                # per-chip accounting (obs/mesh.py): one call per BATCH
                # — a data-parallel dispatch spans every chip equally,
                # so the split is arithmetic, not a per-record loop
                self._mesh_obs.note_batch(n, len(disp))
            if self._failover is not None:
                # green completion: clears strike streaks / counts a
                # half-open probe
                self._failover.record_success(getattr(handle, "key", None))
            if self._batcher is not None:
                # the capacity model's verify half: every completed
                # dispatch is a (size, latency) observation; the latency
                # ends after the CUDA event wait, so it holds card time
                self._batcher.observe(n, t_done - t_start)
            self.committed_offset = first_off + n
            # consume the source's ingest stamps for this offset range
            # (record_staleness_s, the sink watermark)
            freshness.observe_sink(first_off, n)
            self._ckpt.maybe_save(self._ckpt_state)
            if self._slo is not None:
                self._slo.maybe_tick()
            monitor.maybe_tick()

        disp = OverlappedDispatcher(
            depth=self._in_flight_max if self._in_flight_max > 1 else 0,
            metrics=self.metrics,
            complete=_complete,
            # a failed completion runs the device-fault ladder or the
            # suspect scan instead of killing the worker (only when the
            # matching plane is wired)
            on_error=self._on_dispatch_error,
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
                    # worker-wedge injection point: one global load +
                    # None check when no faults are configured
                    faults.fire("score_loop")
                    idle_us = (
                        min(batch_cfg.deadline_us, 20_000)
                        if len(disp) and self._IDLE_WAIT_US < 0
                        else self._IDLE_WAIT_US
                    )
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
                    if (
                        n == self._batch_size
                        and self._max_dispatch_chunks > 1
                        and not self._shedding()
                    ):
                        X, offsets, n = self._aggregate_full_batches(
                            X, offsets, self._batch_size
                        )
                    if n == 0:
                        if self._ring.closed:
                            break
                        disp.flush()
                        self._on_idle()
                        continue
                    if self._dlq is not None and n > 1:
                        # a decode-quarantined record leaves an offset GAP
                        # the ring can stitch into one drained batch:
                        # split at the first break and carry the rest
                        brk = np.nonzero(
                            np.diff(offsets.astype(np.int64)) != 1
                        )[0]
                        if brk.size:
                            cut = int(brk[0]) + 1
                            self._carry_drain.insert(0, (
                                np.array(X[cut:], copy=True),
                                np.array(offsets[cut:], copy=True),
                            ))
                            X, offsets = X[:cut], offsets[:cut]
                            n = cut
                    if self._admission is not None:
                        self._admission.maybe_tick()
                        if not self._admission.admit(self._shed_lane, n):
                            # explicit load shed: the batch rides the
                            # FIFO window as a no-op entry, so its
                            # offsets commit strictly in launch order
                            # behind the in-flight dispatches — the sink
                            # never sees it, no kernel launches, and the
                            # entry is UNACCOUNTED (no dispatch counted)
                            if jstore is not None:
                                # the shed decision IS the journey's
                                # point: terminal hop, always kept
                                jstore.terminal(
                                    "shed",
                                    trace_mod.context_for(int(offsets[0])),
                                    int(offsets[0]), n,
                                    lane=self._shed_lane,
                                )
                            disp.launch(
                                lambda: None,
                                meta=(
                                    n, int(offsets[0]), time.monotonic(),
                                    True, None, None, None, None,
                                ),
                                accounted=False,
                            )
                            continue
                    handle = self._acquire(disp.finish_oldest)
                    if handle is None:
                        # abandoned (dynamic give-up): drop un-fetched
                        # work; records replay from the committed offset
                        disp.close(drain=False)
                        return
                    if self._retain_batches:
                        # isolation AND device-fault recovery re-dispatch
                        # the RAW batch past the async dispatch (drained
                        # views alias the ring's reuse buffer): one
                        # private copy, paid only when a plane is wired
                        X = np.array(X, copy=True)
                        offsets = np.array(offsets, copy=True)
                    first_off = int(offsets[0])
                    self._dispatched_hi = max(
                        self._dispatched_hi, first_off + n
                    )
                    if (
                        self._suspect_until is not None
                        and first_off < self._suspect_until
                    ):
                        # crash-loop fingerprint: score this range
                        # synchronously under persisted suspect markers
                        # (nothing else in flight)
                        disp.flush()
                        self._suspect_scan(
                            handle, X, offsets, error=None, persist=True,
                            ctx=(
                                trace_mod.context_for(first_off)
                                if jstore is not None else None
                            ),
                        )
                        if self.committed_offset >= self._suspect_until:
                            self._exit_suspect_mode()
                        batches.inc()
                        fill.inc(n)
                        continue
                    if (
                        self._failover is not None
                        and self._failover.should_fallback(
                            getattr(handle, "key", None), handle
                        )
                    ):
                        # circuit OPEN for a model the host tier serves:
                        # drain the window first (FIFO commit order),
                        # then serve this batch there
                        disp.flush()
                        self._serve_fallback(
                            handle, X, offsets,
                            jctx=(
                                trace_mod.context_for(first_off)
                                if jstore is not None else None
                            ),
                        )
                        batches.inc()
                        fill.inc(n)
                        continue
                    # the dispatch-stage watermark advances with this
                    # batch's own ingest-stamp event times
                    freshness.propagate_low_watermark("dispatch", first_off, n)
                    t_start = time.monotonic()
                    # the batch's journey context: trace id derived
                    # purely from first_off, one dispatch hop per BATCH;
                    # active around the launch so the featurize / h2d /
                    # readback spans and any exemplar carry its ids
                    jctx = (
                        trace_mod.context_for(first_off)
                        if jstore is not None else None
                    )
                    if jstore is not None:
                        jstore.hop(
                            "dispatch", jctx, first_off, n,
                            model=getattr(handle, "key", None),
                        )
                        if self._state is not None and not self._state_bypass:
                            # the state read / update rides THIS dispatch
                            jstore.hop(
                                "state", jctx, first_off, n,
                                resident=self._state.resident,
                            )
                    try:
                        with trace_mod.use(jctx):
                            disp.launch(
                                lambda h=handle, X=X, n=n, o=offsets: (
                                    self._dispatch_checked(h, X, n, o)
                                ),
                                meta=(
                                    n, first_off, t_start, False, handle,
                                    X if self._retain_batches else None,
                                    offsets if self._retain_batches
                                    else None,
                                    jctx,
                                ),
                                # opts this launch into the sampled
                                # device-timing pool (obs/profiler.py):
                                # the live roofline gauges, the device
                                # stage and the kernel cost ledger
                                profile=(
                                    attr_mod.dispatch_profile(handle, n)
                                    if disp.profiling else None
                                ),
                            )
                    except PoisonIsolationOverflow:
                        raise  # isolation already abandoned: die honestly
                    except Exception as e:
                        # the dispatch itself raised (host encode, an
                        # injected poison, a device fault at launch):
                        # errors of OLDER entries were handled inside
                        # launch's trim, so this one is THIS batch's
                        kind = devfault.classify(e)
                        if (
                            self._state is not None
                            and not self._state_bypass
                            and (kind is not None and self._failover
                                 is not None
                                 or kind is None and self._dlq is not None)
                        ):
                            # a recoverable launch failure may have half-
                            # applied this batch (host mirror mutated, the
                            # step never queued): restore the snapshot
                            self._state.rollback()
                        if kind is not None and self._failover is not None:
                            # older in-flight batches commit first
                            disp.flush()
                            self._device_recover(
                                handle, X, offsets, e, kind, ctx=jctx
                            )
                        elif kind is not None or self._dlq is None:
                            raise
                        else:
                            disp.flush()
                            self._suspect_scan(
                                handle, X, offsets, error=e, ctx=jctx
                            )
                    batches.inc()
                    fill.inc(n)
                disp.close()  # drain the window: every dispatched batch sinks
            self._ckpt.save_now(self._ckpt_state)  # clean drain → exact resume
        except BaseException as e:
            self._error = e
            self._stop.set()


class BlockPipeline(BlockPipelineBase):
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

    ``checkpoint`` (a ``CheckpointManager``), ``dlq`` and ``failover``
    arm recovery (module docstring); ``restore()`` resumes from the
    newest checkpoint. ``slo``, ``batcher`` and ``admission`` /
    ``shed_lane`` arm the serving edge (module docstring).
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
        checkpoint=None,
        max_dispatch_chunks: int = 8,
        dlq=None,
        prefetch: Optional[bool] = None,
        failover=None,
        slo=None,
        batcher=None,
        admission=None,
        shed_lane: str = "block",
        state=None,
        mesh=None,
        donate: Optional[bool] = None,
        tenant: Optional[str] = None,
    ):
        refuse(donate=donate)
        if model.batch_size is None:
            raise InputValidationException(
                "BlockPipeline needs a fixed-batch compiled model "
                "(compile_pmml(batch_size=...))"
            )
        if mesh is not None and not hasattr(model, "without_devices"):
            # promote the compiled model onto the mesh: batch split over
            # the data axis, wide params TP-sharded over the model axis —
            # the scoring contract and the sink shape are unchanged
            # (ShardedModel proxies the CompiledModel surface). An
            # already-sharded model passes through untouched.
            from flink_jpmml_tpu_torch.parallel.mesh import DATA_AXIS
            from flink_jpmml_tpu_torch.parallel.sharding import mesh_sharded

            n_data = int(mesh.shape.get(DATA_AXIS, 1))
            if model.batch_size % max(n_data, 1) != 0:
                raise InputValidationException(
                    f"batch_size {model.batch_size} must divide by the "
                    f"mesh data-axis size {n_data}"
                )
            model = mesh_sharded(model, mesh)
        if hasattr(model, "in_flight_depth"):
            # mesh-aware in-flight window: deep enough to cover the data
            # rows (parallel/assignment.mesh_in_flight), recorded as
            # carried dispatch state so a degraded-mesh rebuild keeps the
            # window geometry without re-derivation
            in_flight = model.in_flight_depth(in_flight)
            model.with_dispatch_state(in_flight=in_flight)
            if getattr(model, "assignment", None) is None:
                from flink_jpmml_tpu_torch.parallel.assignment import (
                    assignment_for,
                )

                model.assignment = assignment_for(
                    model.mesh, getattr(source, "partitions", ()) or ()
                )
        super().__init__(
            source=source,
            sink=sink,
            arity=model.field_space.arity,
            batch_size=model.batch_size,
            device=model.device,
            config=config,
            metrics=metrics,
            in_flight=in_flight,
            checkpoint=checkpoint,
            max_dispatch_chunks=max_dispatch_chunks,
            dlq=dlq,
            prefetch=prefetch,
            failover=failover,
            slo=slo,
            batcher=batcher,
            admission=admission,
            shed_lane=shed_lane,
            tenant=tenant,
            state=state,
        )
        self._bound = BoundScorer("static", model, use_quantized)
        self.backend = self._bound.backend
        self.metrics.counter(f"scorer_backend_{self.backend}").inc()
        if self._state is not None:
            # shard the table over the mesh data axis alongside the model
            # it rides with (None: a single-device model, a no-op)
            self._state.shard(getattr(model, "mesh", None))
        if hasattr(model, "batch_divisor"):
            from flink_jpmml_tpu_torch.obs import mesh as mesh_obs

            self._mesh_obs = mesh_obs.telemetry_for(self.metrics, model)

    def decode(self, out, n: int):
        """Sink-received host output → ``Prediction`` list."""
        return self._bound.decode(out, n)

    def _acquire(self, finish_one):
        return self._bound  # one static model: nothing to resolve

    def _dispatch(self, bound, X, n):
        return self._dispatch_bound(bound, X, n), None
