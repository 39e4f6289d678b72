"""Dynamic model serving on the block path (C6 × the block data plane).

The port of ``flink_jpmml_tpu/serving/block.py``. Swap served models from
a control stream while traffic flows (SURVEY.md §1 C6, §4.3), on the
block pipeline's data plane — the composition of the record engine's
Add/Del serving with :class:`~flink_jpmml_tpu_torch.runtime.block
.BlockPipelineBase`'s loop:

    BlockSource → ring → drained f32 batches
                     ↘ control stream (Add/Del) → ModelRegistry
    batch × current-model → rank-wire (qtrees_leaf_rows) or f32 scoring
                          → sink(out, n, first_offset, decode)

Swap protocol (double-buffered, non-draining):

- An ``AddMessage`` starts a *background* parse + compile + first launch
  on the registry's warm pool; the score loop keeps dispatching against
  the current scorer the whole time — no batch ever waits on a compile.
- Between batches (never mid-batch) the loop adopts the newest
  *warm-and-ready* served version whose arity matches the stream.
  Readiness is judged by the registry's compiled-model instance, so a
  Del + re-Add of the same id with a new document is adopted afresh.
  In-flight batches dispatched under the previous version ride the same
  FIFO window and commit in order.
- A ``DelMessage`` of the serving version drops it; the loop falls back
  to the newest remaining warm version. With nothing servable the loop
  *holds* the drained batch (ring backpressure upstream); on shutdown the
  hold is bounded (``drain_hold_timeout_s``) and abandoned records replay
  from the committed offset on restore.

The sink gains a 4th argument vs the static path: ``decode``, a callable
(out, n) → [Prediction] bound to the exact model that scored the batch
(``decode.model_key`` names it).

Recovery is the base's: ``checkpoint=`` snapshots carry the served-model
registry beside the offsets (``_ckpt_state`` / ``_restore_extra``), so a
restored pipeline re-warms and serves the version that was serving;
``dlq=`` isolates poison through the current bound scorer (envelopes
carry its model key); the device-fault ladder keys its circuit breaker
on the served key. Every dispatch, redispatch and bisection probe of a
rank-wire model goes through ``dispatch_quantized`` and launches
``qtrees_leaf_rows`` on the card.

The serving edge is the base's too: ``slo=`` ticks from the completion
path, ``batcher=`` caps aggregation and learns from completions,
``admission=`` sheds drained batches under ``shed_lane`` as FIFO no-ops
that launch nothing, and the journey hops of an armed
``FJT_JOURNEY_DIR`` ride every dispatch, as in the JAX package.

The mesh, as in the JAX package: ``mesh=`` (a ``parallel/mesh.Mesh``)
makes the registry warm every version as a mesh-sharded model (the f32
path), the compile batch must divide by the data axis, and the in-flight
window deepens to cover the data rows. An adopted sharded model carries
the window depth and a ``ChipAssignment`` over the source's partitions,
and arms per-chip telemetry; a degraded-mesh rebuild on the ladder's
``chip_loss`` rung is adopted into the registry too (``_adopt_rebuilt``),
so the next latest-wins pass cannot swap the dead mesh back in.

Where it differs: models come from the port's ``ModelRegistry`` on the
pipeline's ``device`` (the card by default, ``"cpu"`` on request; the
mesh's primary device with ``mesh=``). ``donate=`` raises
:class:`NotPortedError` (the port reuses its staging once the H2D copy's
event has passed). As in the JAX package, an active rollout's candidate
is never adopted here: the block path serves whole batches to one model,
so the candidate reaches it only at promotion to full (the split and the
shadow mirrors are the record-path ``DynamicScorer``'s).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

import torch

from flink_jpmml_tpu_torch.models.control import ServingMessage
from flink_jpmml_tpu_torch.models.core import ModelId
from flink_jpmml_tpu_torch.runtime.block import (
    BlockPipelineBase,
    BlockSource,
    BoundScorer,
    _Dispatched,
)
from flink_jpmml_tpu_torch.runtime.pipeline import DeviceOutput
from flink_jpmml_tpu_torch.runtime.sources import ControlSource
from flink_jpmml_tpu_torch.serving.registry import ModelRegistry
from flink_jpmml_tpu_torch.utils.config import CompileConfig, RuntimeConfig
from flink_jpmml_tpu_torch.utils.exceptions import (
    InputValidationException,
    refuse,
)
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry


class DynamicBlockPipeline(BlockPipelineBase):
    """Block-speed scoring with control-stream model serving.

    ``sink(out, n, first_offset, decode)`` — see module docstring.
    ``name`` pins which served model name this stream scores (versions of
    it swap in and out); the newest warm version wins.
    """

    _THREAD_TAG = "dblk"
    # bounded wait for the first record: an idle stream still applies
    # Add/Del and kicks background warms every ~20ms (see _on_idle)
    _IDLE_WAIT_US = 20_000

    def __init__(
        self,
        source: BlockSource,
        control: ControlSource,
        sink: Callable,
        name: str,
        arity: int,
        batch_size: int,
        config: Optional[RuntimeConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
        compile_config: Optional[CompileConfig] = None,
        in_flight: int = 2,
        use_quantized: bool = True,
        checkpoint=None,
        hold_poll_s: float = 0.005,
        drain_hold_timeout_s: float = 5.0,
        max_dispatch_chunks: int = 8,
        dlq=None,
        failover=None,
        device: Optional[Union[str, torch.device]] = None,
        mesh=None,
        slo=None,
        batcher=None,
        admission=None,
        shed_lane: str = "block",
        donate: Optional[bool] = None,
    ):
        refuse(donate=donate)
        if batch_size <= 0:
            raise InputValidationException(
                f"batch_size must be positive: {batch_size}"
            )
        if mesh is not None:
            n_data = mesh.shape.get("data", 1)
            if batch_size % max(n_data, 1) != 0:
                raise InputValidationException(
                    f"batch_size {batch_size} must divide by the mesh "
                    f"data-axis size {n_data} (sharded dispatch pads to "
                    "the batch, which must split evenly across devices)"
                )
            # mesh-aware in-flight window: deep enough to cover the data
            # rows (parallel/assignment.mesh_in_flight); the single-chip
            # depth is untouched when data=1
            from flink_jpmml_tpu_torch.parallel.assignment import (
                mesh_in_flight,
            )

            in_flight = mesh_in_flight(mesh, in_flight)
        # the registry resolves the device (the card unless "cpu") and
        # books its warms (cold_start_s, one launch each on the rank
        # wire) in the pipeline's registry — the JAX one books none
        metrics = metrics or MetricsRegistry()
        registry = ModelRegistry(
            batch_size=batch_size, compile_config=compile_config,
            device=device, metrics=metrics, mesh=mesh,
        )
        super().__init__(
            source=source,
            sink=sink,
            arity=arity,
            batch_size=batch_size,
            device=registry.device,
            config=config,
            metrics=metrics,
            in_flight=in_flight,
            checkpoint=checkpoint,
            max_dispatch_chunks=max_dispatch_chunks,
            dlq=dlq,
            failover=failover,
            slo=slo,
            batcher=batcher,
            admission=admission,
            shed_lane=shed_lane,
        )
        self.registry = registry
        self._control = control
        self._name = name
        self._use_quantized = use_quantized
        self._hold_poll_s = hold_poll_s
        self._drain_hold_timeout_s = drain_hold_timeout_s
        self._current: Optional[BoundScorer] = None
        self._rejected: set = set()  # arity-mismatched served ids
        self.swaps = self.metrics.counter("model_swaps")

    @property
    def serving_key(self) -> Optional[str]:
        cur = self._current
        return cur.key if cur is not None else None

    @property
    def backend(self) -> Optional[str]:
        cur = self._current
        return cur.backend if cur is not None else None

    # -- checkpoint (source offset + served metadata, like the reference's
    #    checkpointed operator state) ------------------------------------------

    def _ckpt_state(self) -> dict:
        state = super()._ckpt_state()
        state["registry"] = self.registry.state()
        return state

    def _restore_extra(self, state: dict) -> None:
        super()._restore_extra(state)
        self.registry.restore(state.get("registry", {}))

    # -- model resolution ------------------------------------------------------

    def _poll_control(self) -> None:
        """Drain pending Add/Del messages; adopt the newest warm,
        arity-matching compiled model when it differs from the current
        one. Runs between batches only."""
        changed = False
        while True:
            msgs = self._control.poll(64)
            if not msgs:
                break
            for _, msg in msgs:
                if isinstance(msg, ServingMessage):
                    changed |= self.registry.apply(msg)
        if changed:
            # a registry change may supersede any quarantine (a corrected
            # document can be re-Added under the same name+version)
            self._rejected.clear()
        cur = self._current
        # current version un-served (Del): drop it even with nothing warm
        if cur is not None:
            mid = ModelId.from_key(cur.key)
            if self.registry.resolve(mid.name, mid.version) is None:
                self._current = None
                cur = None
        # an active rollout's candidate is NOT adoptable: the block path
        # serves whole dense batches to one model, so the candidate becomes
        # visible here only at promotion to full
        ro = self.registry.rollout(self._name)
        cand_version = ro.candidate_version if ro is not None else None
        best_mid = None
        best_model = None
        for mid in sorted(
            (m for m in self.registry.served if m.name == self._name),
            key=lambda m: m.version,
            reverse=True,
        ):
            if mid in self._rejected or mid.version == cand_version:
                continue
            model = self.registry.model_if_warm(mid)  # kicks warm if cold
            if model is None:
                continue
            if model.field_space.arity != self._arity:
                # served document doesn't fit this stream's record shape
                self._rejected.add(mid)
                self.metrics.counter("arity_rejected_models").inc()
                continue
            best_mid, best_model = mid, model
            break
        if best_model is None:
            return
        if cur is not None and cur.model is best_model:
            return  # already serving exactly this compiled instance
        bound = BoundScorer(best_mid.key(), best_model, self._use_quantized)
        if hasattr(best_model, "with_dispatch_state"):
            # sharded serving: record the window geometry + partition
            # ownership on the adopted model so a degraded-mesh rebuild
            # carries both (ShardedModel.without_devices), and arm the
            # per-chip telemetry for the adopted mesh
            best_model.with_dispatch_state(in_flight=self._in_flight_max)
            if getattr(best_model, "assignment", None) is None:
                from flink_jpmml_tpu_torch.parallel.assignment import (
                    assignment_for,
                )

                best_model.assignment = assignment_for(
                    best_model.mesh,
                    getattr(self._source, "partitions", None) or (),
                )
            from flink_jpmml_tpu_torch.obs import mesh as mesh_obs

            self._mesh_obs = mesh_obs.telemetry_for(
                self.metrics, best_model
            )
        self._current = bound
        # tenant_records follows the key actually serving
        self.set_tenant(best_mid.key())
        self.swaps.inc()
        self.metrics.counter(f"scorer_backend_{bound.backend}").inc()

    # -- BlockPipelineBase hooks -----------------------------------------------

    def _on_idle(self) -> None:
        self._poll_control()  # idle ring: still apply Add/Del promptly

    def _acquire(self, finish_one):
        self._poll_control()
        hold_start = time.monotonic()
        while self._current is None:
            # hold the batch (never drop it) until something is servable;
            # in-flight keeps draining meanwhile
            if self._stop.is_set() or self._ring.closed:
                if not self._drain_all:
                    return None
                # draining shutdown: bounded wait, then give up — the held
                # batch replays from the committed offset on restore
                if (
                    time.monotonic() - hold_start
                    > self._drain_hold_timeout_s
                ):
                    return None
            finish_one()
            time.sleep(self._hold_poll_s)
            self._poll_control()
        return self._current

    def _dispatch(self, bound, X, n):
        return self._dispatch_bound(bound, X, n), bound.decode

    def _adopt_rebuilt(self, handle, rebuilt) -> None:
        # degraded-mesh rebuild (runtime/block.py chip_loss rung): the
        # registry's compiled instance must follow, or the next
        # latest-wins re-adoption would swap the dead mesh back in
        super()._adopt_rebuilt(handle, rebuilt)
        self.registry.adopt_rebuilt(handle.key, rebuilt)

    def _fallback_dispatch(self, bound, X, n):
        # host-tier output decodes through the SAME bound decode
        return _Dispatched(
            DeviceOutput(self._failover.tier.score_bound(bound, X)),
            bound.decode,
        )

    def _emit(self, out, n, first_off, decode) -> None:
        self._sink(out, n, first_off, decode)
