"""DynamicScorer: the two-input (event ⋈ control) operator, vectorized.

The port of ``flink_jpmml_tpu/serving/scorer.py``. Reference parity
(SURVEY.md §4.3): a ``RichCoFlatMapFunction`` joining the event stream
with a control stream of Add/Del messages, scoring each event against its
target served model, with the served-metadata map in checkpointed
operator state. Here the join happens once per *micro-batch*:

1. drain all pending control messages (in arrival order) into the
   registry;
2. group the batch's events by their routed ``(name, version)``;
3. dispatch one device call per distinct model (without waiting on it),
   through one shared :class:`OverlappedDispatcher` window;
4. reassemble results in event order; events routed to an unserved,
   failed or still-cold model get ``Prediction.empty()`` — totality (C5),
   never an exception.

Event routing: by default an event is a ``(model_name, record)`` pair or
a dict with a ``"_model"`` key (optionally ``"_version"``); pass ``route``
to override.

On the card each served model's rank-wire group goes through
``dispatch_quantized`` (so ``qtrees_leaf_rows`` scores a GBM or a vote
forest; a micro-batch that mixes two models makes two launches), on one
CUDA stream of the scorer's, with a pinned :class:`HostStaging` per
served model: two models of different widths never share (and keep
reallocating) one buffer set. A model's staging is dropped when a Del
removes it from the registry; a dispatch in flight keeps its model, its
scorer and its staging referenced from its ticket until ``finish`` has
waited on it, so a Del that lands between ``submit`` and ``finish`` frees
nothing the card still reads.

Device-fault recovery is the JAX scorer's: ``device_retry`` (None, the
default, means True) re-dispatches a group whose wait raised a
device-classified fault (``runtime/devfault.py``) from its retained
payloads, under the shared full-jitter backoff, for up to
``FJT_DEVICE_RETRIES`` attempts; each redispatch launches the same
kernel on the card and counts in ``redispatches`` (the port adds it). Each group recovers on its own. A lost context
(``chip_loss``), an exhausted streak or a record error re-raises from
``finish`` — where the record engine's ladder (or its poison isolation)
takes over. ``device_retry=False`` fails fast. The checkpointed state
(the served-model registry) rides the record engine's checkpoint.

The serving edge is the JAX scorer's: ``admission=`` (an
``AdmissionController``) sheds per event before routing, by the lane
``lane_fn`` gives its payload (:func:`default_lane`: a dict's ``"_lane"``,
else ``"normal"``) — a shed event is never resolved or dispatched and
leaves ``finish`` as ``Prediction.empty()``, so a micro-batch whose every
event is shed launches no kernel; ``batcher=`` observes each micro-batch's
(scored events, submit→finish seconds), a latency that ends after the
CUDA event wait; ``self.slo`` is always an ``SLOTracker`` over
``score_latency_s`` (inert without ``FJT_SLO_TARGET_MS``), ticked every
``finish``; and ``finish`` emits the ``score_finish`` span.

The multi-tenant zoo is the JAX scorer's: ``zoo=True`` (or a
``serving/zoo.ZooManager``) collapses the pack-eligible per-model groups
of a micro-batch into one dispatch per planned pack
(``compile/packs.PackedScorer``: one launch of the walk kernel over every
``"cuda"`` member, then each member's epilogue; each ``"torch"`` member's
own ``qfn``), host-encoded and staged through the pack's own pinned
buffers, each member's output byte-identical to its solo dispatch. Before
packing, a tenant over the zoo's quota (``FJT_TENANT_QUOTA_FRAC`` of the
batch) sheds its excess as empty predictions
(``tenant_shed_records{model=*}``); every delivered group books
``tenant_records`` and ``tenant_latency_s`` under its served key. A
device fault on a pack re-dispatches each member's group solo, as any
faulted group does.

Sampled launches: every group's launch, solo or packed, carries
``attr.dispatch_profile`` when the profiler is on, and the scorer marks
the sweep's region (the kernel and its epilogue on codes on the card), as
the block pipelines' launches do.

Staged rollouts are the JAX scorer's (``rollout/``): while a name has an
active rollout, unpinned events split per record key (``key_fn``,
default ``rollout/split.record_key``: a dict's ``"_key"``, else the
record's content) — the incumbent serves everything at the shadow stage
and ``1 − p`` at the canary stage; the candidate serves its slice only
once warm (a cold candidate's slice stays on the incumbent). Incumbent
events are also mirrored (sampled per the rollout's guardrail spec) to
the candidate: one more group, so on the card one more launch of
``qtrees_leaf_rows`` on the scorer's stream, whose outputs are diffed
against the incumbent's at ``finish`` (``rollout_shadow_compared`` /
``_disagree`` / ``_drift``) and never emitted. Rollout groups launch
solo, never in a zoo pack: their per-role records, latency and errors
are what the guardrail controller reads. Both roles' latency
(``rollout_{candidate,incumbent}_latency_s``) is taken over one bracket,
the group's ``runtime/pipeline.LaunchSpan``: on the card, timing events on
the scorer's stream at the group's H2D copy and behind its D2H copy, read
after the wait the window makes anyway, so no role is timed with a
synchronize the other lacks, and neither is charged the host's featurize
or another group's wait and decode; on the CPU, the host time of the
synchronous launch. The JAX scorer takes host time from the launch to
the decode for both roles instead: on the card that charged whichever
group the host finished last (a mirror after the incumbent's decode)
with host work, and a host pause of tens of milliseconds in front of one
dispatch read as a slow candidate. A candidate whose dispatch
fails empties its lanes and counts ``rollout_candidate_errors`` instead
of killing the stream. The attached :class:`RolloutController` ticks from
``submit`` (every ``rollout_interval_s``) unless ``auto_rollout=False``;
``guardrails`` is stamped onto a ``RolloutMessage`` that carries none.
Per-role score sketches (``rollout_score_dist{model,role}``) feed its
prediction-PSI guardrail.

The data-drift plane (``obs/drift.py``, armed by ``FJT_DRIFT_SAMPLE`` or
``drift.install`` on the scorer's registry) profiles each rank-wire
group's raw batch in ``dispatch_quantized`` and sketches each delivered
group's predictions at ``finish`` under its served document's
``model_hash`` (zoo members included).

``mesh=`` serves every model (the default included) mesh-sharded, on the
f32 path (``ModelRegistry``); a group pads up to the mesh's data axis
(``runtime/pipeline.dispatch_f32``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flink_jpmml_tpu_torch.api.reader import ModelReader
from flink_jpmml_tpu_torch.compile import prepare
from flink_jpmml_tpu_torch.models.control import RolloutMessage, from_wire
from flink_jpmml_tpu_torch.models.core import ModelId
from flink_jpmml_tpu_torch.models.prediction import Prediction
from flink_jpmml_tpu_torch.obs import attr as attr_mod
from flink_jpmml_tpu_torch.obs import drift as drift_mod
from flink_jpmml_tpu_torch.obs import freshness as fresh_mod
from flink_jpmml_tpu_torch.obs import pressure as pressure_mod
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.obs import spans
from flink_jpmml_tpu_torch.obs.slo import SLOTracker
from flink_jpmml_tpu_torch.rollout import split as rsplit
from flink_jpmml_tpu_torch.rollout.controller import RolloutController
from flink_jpmml_tpu_torch.rollout.state import (
    ACTIVE_STAGES,
    STAGE_CANARY,
    GuardrailSpec,
)
from flink_jpmml_tpu_torch.runtime import devfault
from flink_jpmml_tpu_torch.runtime.engine import (
    Scorer,
    ScoringStream,
    new_staging,
)
from flink_jpmml_tpu_torch.runtime.pipeline import (
    DeviceOutput,
    LaunchSpan,
    OverlappedDispatcher,
    device_output,
    dispatch_f32,
    dispatch_quantized,
)
from flink_jpmml_tpu_torch.runtime.sources import ControlSource, batch_event_range
from flink_jpmml_tpu_torch.serving.registry import ModelRegistry
from flink_jpmml_tpu_torch.utils.config import CompileConfig
from flink_jpmml_tpu_torch.utils.exceptions import FlinkJpmmlTpuError
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

# route(event) -> (name, version|None, record)
RouteFn = Callable[[Any], Tuple[Optional[str], Optional[int], Any]]

_DEFAULT_KEY = "__default__"


def default_route(event: Any) -> Tuple[Optional[str], Optional[int], Any]:
    if isinstance(event, tuple) and len(event) == 2:
        return event[0], None, event[1]
    if isinstance(event, dict) and "_model" in event:
        payload = {k: v for k, v in event.items() if k not in ("_model", "_version")}
        return event["_model"], event.get("_version"), payload
    return None, None, event


def default_lane(payload: Any) -> str:
    """Admission lane of a routed payload: the ``"_lane"`` key on dict
    records, else ``"normal"``."""
    if isinstance(payload, dict):
        lane = payload.get("_lane")
        if isinstance(lane, str):
            return lane
    return "normal"


class DynamicScorer(Scorer):
    def __init__(
        self,
        control: ControlSource,
        batch_size: int,
        route: Optional[RouteFn] = None,
        default_reader: Optional[ModelReader] = None,
        replace_nan: Optional[float] = None,
        compile_config: Optional[CompileConfig] = None,
        emit_pairs: bool = True,
        emit: Optional[Callable[[Sequence[Any], List[Prediction]], List[Any]]] = None,
        async_warmup: bool = True,
        mesh=None,
        metrics: Optional[MetricsRegistry] = None,
        in_flight: Optional[int] = None,
        key_fn: Optional[Callable[[Any], Any]] = None,
        guardrails: Optional[GuardrailSpec] = None,
        auto_rollout: bool = True,
        rollout_interval_s: float = 0.5,
        event_time_fn: Optional[Callable[[Any], Optional[float]]] = None,
        admission=None,
        lane_fn: Optional[Callable[[Any], str]] = None,
        batcher=None,
        device_retry: Optional[bool] = None,
        zoo=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """``async_warmup=False`` disables background warming: a newly
        Added model compiles synchronously inside ``submit`` on its first
        matching event (the reference's operator-blocking lazy load).

        Per-group device dispatches run through a shared
        :class:`OverlappedDispatcher`. ``in_flight`` optionally bounds
        pending group dispatches across tickets; the default None is
        unbounded because the :class:`Scorer` contract requires ``submit``
        to dispatch without blocking on device work — the engine's own
        submit/finish window is the backpressure. ``metrics`` shares a
        registry (stall time, in-flight depth, ``encode_s`` /
        ``h2d_bytes``, the stage ledger, ``score_latency_s``, the
        registry's ``cold_start_s`` and warm-pool counters).

        ``event_time_fn`` (``event -> unix seconds`` or None) opts this
        scorer into the freshness plane: each finished micro-batch books
        ``record_staleness_s`` and advances the event-time watermark.
        ``device`` picks the card (None, the default) or ``"cpu"`` for
        every model this scorer serves.

        ``zoo=True`` (or a ``ZooManager``) turns on cross-model packed
        dispatch (module docstring). ``mesh`` serves every model (default
        included) mesh-aware — see :class:`ModelRegistry`.

        Rollout knobs: ``key_fn`` derives the canary-split routing key
        from an event payload (default: ``"_key"`` on dict records, else
        content addressing — ``rollout/split.record_key``);
        ``guardrails`` is the default spec stamped onto
        ``RolloutMessage``s that carry none; ``auto_rollout=False``
        disables the attached controller's batch-loop ticks (manual
        promote / rollback / ``tick`` through
        ``scorer.rollout_controller`` only); ``rollout_interval_s`` is
        the least time between two of its ticks."""
        self.metrics = metrics or MetricsRegistry()
        self.registry = ModelRegistry(
            batch_size=batch_size,
            compile_config=compile_config,
            async_warmup=async_warmup,
            mesh=mesh,
            metrics=self.metrics,
            device=device,
        )
        self.device = self.registry.device
        self._batch_size = batch_size
        if zoo is True:
            from flink_jpmml_tpu_torch.serving.zoo import ZooManager

            zoo = ZooManager(metrics=self.metrics)
        self._zoo = zoo or None
        self._zoo_sync_needed = False
        # pinned staging per planned pack (its member keys), made on the
        # pack's first dispatch and dropped with the pack's membership
        self._pack_staging: Dict[Tuple[str, ...], Any] = {}
        self._control = control
        self._route = route or default_route
        self._default_model = (
            default_reader.load(
                batch_size=batch_size, config=compile_config,
                device=self.device, mesh=mesh,
            )
            if default_reader is not None
            else None
        )
        self._replace_nan = replace_nan
        self._emit_pairs = emit_pairs
        self._emit = emit
        self._dispatcher = OverlappedDispatcher(
            depth=in_flight, metrics=self.metrics
        )
        self._stream = ScoringStream(self.device)
        # pinned staging per served model key (the default model's under
        # _DEFAULT_KEY), made on its first dispatch, dropped on its Del
        self._staging: Dict[str, Any] = {}
        # submit→finish latency per micro-batch (mergeable histogram)
        self._lat = self.metrics.histogram("score_latency_s")
        self._event_time_fn = event_time_fn
        self._freshness = (
            fresh_mod.freshness_for(self.metrics)
            if event_time_fn is not None else None
        )
        self._pressure = pressure_mod.pressure_for(self.metrics)
        # models whose load/compile failed: don't re-attempt every batch;
        # cleared when the registry changes (a fixed version can be re-Added)
        self._failed: set = set()
        # device-fault group redispatch: default ON — the retry is
        # bounded, the payloads are already retained, and totality wants
        # a transient card hiccup absorbed; device_retry=False fails fast
        self._device_retry = (
            device_retry if device_retry is not None else True
        )
        # deadline SLO burn-rate tracking over the submit→finish latency
        # histogram, ticked from the batch loop; inert without
        # FJT_SLO_TARGET_MS
        self.slo = SLOTracker(self.metrics, source="score_latency_s")
        self.admission = admission
        self.batcher = batcher
        self._lane_fn = lane_fn or default_lane
        self._key_fn = key_fn or rsplit.record_key
        self._default_guardrails = guardrails
        self._auto_rollout = auto_rollout
        # the guardrail loop, ticked from the batch loop (between
        # micro-batches, on the serving thread): promote/rollback
        # decisions actuate on this registry with no extra thread
        self.rollout_controller = RolloutController(
            book=self.registry,
            struct_fn=self.metrics.struct_snapshot,
            metrics=self.metrics,
            interval_s=rollout_interval_s,
        )

    def _drain_control(self) -> None:
        while True:
            msgs = self._control.poll(256)
            if not msgs:
                break
            for _, msg in msgs:
                if isinstance(msg, dict):
                    # JSONL control feeds deliver wire dicts; a bad frame
                    # is skipped loudly, never poisons the stream
                    try:
                        msg = from_wire(msg)
                    except ValueError as e:
                        flight.record(
                            "control_frame_rejected", error=str(e)
                        )
                        continue
                if (
                    isinstance(msg, RolloutMessage)
                    and msg.guardrails is None
                    and self._default_guardrails is not None
                ):
                    msg = dataclasses.replace(
                        msg, guardrails=self._default_guardrails
                    )
                if self.registry.apply(msg):
                    self._failed.clear()
                    served = {m.key() for m in self.registry.served}
                    for key in list(self._staging):
                        if key != _DEFAULT_KEY and key not in served:
                            del self._staging[key]
                    for gk in list(self._pack_staging):
                        if not set(gk) <= served:
                            del self._pack_staging[gk]
                    # a Del changes the zoo's membership multiset: the
                    # manager drops the dead tenant (and re-plans) before
                    # the next pack dispatch
                    self._zoo_sync_needed = True

    def _resolve(self, name: str, version: Optional[int]):
        """→ (model, group key) for a named event; the model is None when
        nothing can serve it now (unserved, failed, or cold behind a warm)."""
        reg = self.registry
        failed = self._failed
        mid = reg.resolve(name, version)
        if mid is None:
            return None, None
        key = mid.key()
        if not reg.async_warmup:
            # warming disabled: reference-style lazy load — the compile
            # happens synchronously in the operator
            if mid in failed:
                return None, key
            try:
                return reg.model(mid), key
            except FlinkJpmmlTpuError:
                failed.add(mid)
                return None, key
        # double-buffered swap (SURVEY §8(d)): a ready model is used as-is;
        # while a *new* version is still compiling in the background (or
        # failed to), unpinned events keep scoring the newest warm version
        # and pinned-cold events go empty — the batch loop never stalls on
        # a compile. Only the first deployment of a name (nothing warm to
        # serve) blocks, joining the in-flight warm.
        if mid not in failed:
            model = reg.model_if_warm(mid)
            if model is not None:
                return model, key
            if reg.warm_error(mid) is not None:
                failed.add(mid)
        fb = reg.resolve_warm(name)
        if version is None and fb is not None and fb != mid:
            model = reg.model_if_warm(fb)
            if model is not None:
                return model, fb.key()
        if mid in failed or (fb is not None and reg.is_warming(mid)):
            return None, key  # empty lanes this batch, no stall
        try:
            return reg.model(mid), key
        except FlinkJpmmlTpuError:
            # bad path / uncompilable document → lanes go empty, id
            # quarantined, the stream lives
            failed.add(mid)
            return None, key

    def submit(self, records: Sequence[Any]):
        self._drain_control()
        if self._auto_rollout:
            self.rollout_controller.maybe_tick()
        if self.admission is not None:
            self.admission.maybe_tick()
        active = self.registry.rollouts()  # name -> RolloutState
        n = len(records)
        # model key -> [model, [indices], [payloads], rollinfo], where
        # rollinfo is (rollout name, "candidate"|"incumbent") for groups of
        # a name with an active rollout, else None
        groups: dict = {}
        # rollout name -> [candidate model, [indices], [payloads], its key]:
        # mirrored copies of incumbent-served events for shadow diffing
        mirrors: dict = {}
        # per-batch memos: the answers cannot change within one batch
        # (model_if_warm and resolve take the registry lock)
        cand_models: dict = {}
        resolved: dict = {}
        unserved: List[int] = []
        shed: List[int] = []
        for i, event in enumerate(records):
            name, version, payload = self._route(event)
            if self.admission is not None and not self.admission.admit(
                self._lane_fn(payload)
            ):
                # shed BEFORE any model work: the event is never
                # resolved, dispatched, mirrored or diffed — it leaves
                # finish() as an explicit empty prediction
                shed.append(i)
                continue
            ro = active.get(name) if name is not None else None
            cand_model = rkey = None
            if ro is not None:
                # the candidate participates only once warm: its canary
                # slice keeps scoring on the incumbent (and mirroring
                # skips) until the background warm lands
                if name in cand_models:
                    cand_model = cand_models[name]
                else:
                    cand_model = cand_models[name] = (
                        self.registry.model_if_warm(
                            ModelId(name, ro.candidate_version)))
                # one canonicalization per event, shared by the canary
                # assignment and the shadow sampling below
                rkey = self._key_fn(payload)
            if name is None:
                model, key = self._default_model, _DEFAULT_KEY
            elif (
                cand_model is not None
                and version is None
                and ro.stage == STAGE_CANARY
                and rsplit.assign_candidate(
                    name, ro.candidate_version, ro.fraction, rkey)
            ):
                # deterministic per-key canary slice → the candidate
                model = cand_model
                key = ModelId(name, ro.candidate_version).key()
            else:
                hit = resolved.get((name, version))
                if hit is None:
                    hit = resolved[(name, version)] = self._resolve(
                        name, version)
                model, key = hit
            if model is None:
                unserved.append(i)
                continue
            rollinfo = None
            if ro is not None:
                role = "candidate" if model is cand_model else "incumbent"
                rollinfo = (name, role)
                if (
                    role == "incumbent"
                    and cand_model is not None
                    and ro.stage in ACTIVE_STAGES
                    and rsplit.sample_shadow(
                        name, ro.candidate_version,
                        ro.spec.shadow_sample, rkey)
                ):
                    # mirror a copy to the candidate, off the emitting
                    # path: its output is diffed in finish(), never sunk
                    m = mirrors.get(name)
                    if m is None:
                        mirrors[name] = [
                            cand_model, [i], [payload],
                            ModelId(name, ro.candidate_version).key()]
                    else:
                        m[1].append(i)
                        m[2].append(payload)
            g = groups.get(key)
            if g is None:
                groups[key] = [model, [i], [payload], rollinfo]
            else:
                g[1].append(i)
                g[2].append(payload)
        tickets = []
        shadows = []
        with self._stream.context():
            if self._zoo is not None:
                self._submit_packed(groups, tickets, shed)
            for key, (model, idxs, payloads, rollinfo) in groups.items():
                tickets.append(
                    self._launch_group(key, model, idxs, payloads,
                                       timed=rollinfo is not None)
                    + (rollinfo,))
            for name, (model, idxs, payloads, key) in mirrors.items():
                shadows.append((self._launch_group(
                    key, model, idxs, payloads, timed=True), name))
        return n, records, tickets, shadows, unserved, shed, time.monotonic()

    def _submit_packed(self, groups, tickets, shed) -> None:
        """Zoo fast path for one micro-batch (the JAX scorer's): quota-shed
        oversize tenants, then collapse pack-eligible per-model groups into
        one dispatch per planned pack (serving/zoo.py decides which models
        share a buffer). Packed groups are POPPED from ``groups``; the rest
        launch solo. Rollout-role groups always stay solo: their per-role
        latency and error accounting is the guardrail controller's signal
        and must not blend into a shared launch."""
        from flink_jpmml_tpu_torch.compile import packs

        zoo = self._zoo
        if self._zoo_sync_needed:
            zoo.sync({m.key() for m in self.registry.served})
            self._zoo_sync_needed = False
        quota = zoo.quota_rows(self._batch_size) if self._batch_size else None
        if quota is not None:
            for key, g in groups.items():
                if len(g[1]) > quota:
                    # fairness over the shared slots: the excess rows shed
                    # exactly like admission shedding — an explicit empty
                    # prediction, never dispatched
                    excess = g[1][quota:]
                    g[1] = g[1][:quota]
                    g[2] = g[2][:quota]
                    shed.extend(excess)
                    self.metrics.counter(
                        f'tenant_shed_records{{model="{key}"}}'
                    ).inc(len(excess))
        eligible = {}
        for key, (model, _idxs, payloads, rollinfo) in groups.items():
            if key == _DEFAULT_KEY or rollinfo is not None:
                continue
            q = model.quantized_scorer()
            if (
                q is not None
                and packs.pack_eligible(q)
                and len(payloads) <= (q.batch_size or 0)
            ):
                eligible[key] = q
        if not eligible:
            return
        for unit in zoo.batch_plan(eligible):
            rows = {}
            live = [0] * unit.pack.n_members
            t0 = time.monotonic()
            for slot, key in unit.slots:
                model, _idxs, payloads, _ = groups[key]
                X, M = self._featurize(model, payloads)
                # the pack stages host-encoded rank codes — the byte-parity
                # oracle every other encode path is held to — so a member's
                # slot holds exactly its solo host dispatch's codes
                rows[slot] = eligible[key].wire.encode(X, M)
                live[slot] = rows[slot].shape[0]
            Xp, total = unit.pack.assemble(rows)
            t1 = time.monotonic()
            self.metrics.counter("encode_s").inc(t1 - t0)
            self.metrics.counter("h2d_bytes").inc(Xp.nbytes)
            attr_mod.ledger_for(self.metrics).observe("encode", t1 - t0)
            gk = tuple(unit.pack.keys)
            staging = self._pack_staging.get(gk)
            if staging is None and self.device.type == "cuda":
                staging = self._pack_staging[gk] = new_staging(self.device)
            pack = unit.pack
            handle = self._dispatcher.launch(
                lambda p=pack, Xp=Xp, st=staging, r=live: _dispatch_pack(
                    p, Xp, st, r),
                profile=(
                    attr_mod.dispatch_profile(pack, total)
                    if self._dispatcher.profiling else None
                ),
            )
            shared = _PackFetch(self._dispatcher, handle)
            zoo.book_dispatch(unit, total)
            t_launch = time.monotonic()
            for slot, key in unit.slots:
                model, idxs, payloads, _ = groups.pop(key)
                tickets.append((
                    eligible[key], idxs, _PackSlice(shared, slot), model,
                    staging, key, payloads, key, t_launch, None, None,
                ))

    def _featurize(self, model, payloads):
        first = payloads[0]
        if isinstance(first, dict):
            return prepare.from_records(model.field_space, payloads)
        return prepare.from_dense(
            model.field_space,
            np.asarray(payloads, np.float32),
            self._replace_nan,
        )

    def _launch_group(self, key: str, model, idxs, payloads,
                      timed: bool = False):
        """Featurize + dispatch one per-model group through the shared
        window → its ticket entry: (the object whose ``decode`` matches the
        dispatch, indices, handle, model, staging, key, payloads — the
        two last let a device-faulted group re-dispatch —, the tenant label
        (the served key in zoo mode, else None), the launch time and, with
        ``timed``, the group's :class:`LaunchSpan`, else None). With the profiler on, the launch
        carries its dispatch profile and the scorer marks the sampled
        region, as the block pipelines' launches do."""
        X, M = self._featurize(model, payloads)
        n = len(payloads)
        tenant = key if self._zoo is not None else None
        q = model.quantized_scorer()
        span = LaunchSpan(self.device) if timed else None
        if q is None:
            handle = self._dispatcher.launch(
                lambda: dispatch_f32(model, X, M, span=span),
                profile=(
                    attr_mod.dispatch_profile(model, n)
                    if self._dispatcher.profiling else None
                ),
            )
            if span is not None:
                span.close()
            return (model, idxs, handle, model, None, key, payloads, tenant,
                    time.monotonic(), span)
        staging = self._staging.get(key)
        if staging is None and self.device.type == "cuda":
            staging = self._staging[key] = new_staging(self.device)
        handle = self._dispatcher.launch(
            lambda: dispatch_quantized(
                q, X, M, metrics=self.metrics, staging=staging, span=span
            ),
            profile=(
                attr_mod.dispatch_profile(q, n)
                if self._dispatcher.profiling else None
            ),
        )
        if span is not None:
            span.close()
        return (q, idxs, handle, model, staging, key, payloads, tenant,
                time.monotonic(), span)

    def _wait_handle(self, handle):
        """The host output of one ticket's dispatch: the FIFO wait for a
        solo handle, the memoized slot of a packed member's."""
        if isinstance(handle, _PackSlice):
            return handle.fetch()
        return self._dispatcher.wait(handle).result()

    def finish(self, ticket) -> List[Any]:
        n, records, tickets, shadows, unserved, shed, t_submit = ticket
        preds: List[Optional[Prediction]] = [None] * n
        # the data-drift plane: None unless FJT_DRIFT_SAMPLE armed it or a
        # caller installed one — the record path's sink is this loop, so
        # score sketches book here, per served document
        dplane = drift_mod.plane_for(self.metrics)
        for (scorer, idxs, handle, model, _staging, key, payloads, tenant,
             t_launch, span, rollinfo) in tickets:
            role = rollinfo[1] if rollinfo is not None else None
            failed = False
            try:
                decoded = scorer.decode(self._wait_handle(handle), len(idxs))
            except Exception as e:
                kind = devfault.classify(e)
                decoded = None
                if kind is not None:
                    # book EVERY classified fault, chip loss included
                    devfault.note(self.metrics, kind, n=len(idxs), error=e)
                if (
                    kind is not None
                    and kind != devfault.KIND_LOST
                    and self._device_retry
                ):
                    decoded, e = self._redispatch_group(
                        key, model, idxs, payloads, e
                    )
                if decoded is None and role != "candidate":
                    raise e
                if decoded is None:
                    # a poisoned candidate must not kill the stream: its
                    # lanes go empty and the failure lands where the
                    # guardrail controller reads it — the rollback signal
                    failed = True
                    self.metrics.counter(
                        f'rollout_candidate_errors{{model="{rollinfo[0]}"}}'
                    ).inc(len(idxs))
                    flight.record("rollout_candidate_error",
                                  model=rollinfo[0], error=repr(e))
                    decoded = [Prediction.empty()] * len(idxs)
            if rollinfo is not None and not failed:
                # failed groups count ONLY as errors: as served records
                # they would halve the controller's error rate, and their
                # fail-fast timings would skew the latency histogram
                self._observe_rollout_group(rollinfo[0], role, len(idxs),
                                            span.seconds())
                self._record_score_dist(rollinfo[0], role, decoded)
            if tenant is not None and not failed:
                # per-tenant telemetry (zoo mode), labelled by served key
                self.metrics.counter(
                    f'tenant_records{{model="{tenant}"}}'
                ).inc(len(idxs))
                self.metrics.histogram(
                    f'tenant_latency_s{{model="{tenant}"}}'
                ).observe(time.monotonic() - t_launch)
            if dplane is not None and not failed:
                dplane.record_predictions(scorer, decoded)
            for i, p in zip(idxs, decoded):
                preds[i] = p
        self._diff_shadows(shadows, preds)
        for i in unserved:
            preds[i] = Prediction.empty()
        for i in shed:
            # explicit degradation, not an error: the lane was refused
            # by the admission controller at submit
            preds[i] = Prediction.empty()
        if tickets:  # an all-unserved batch scored nothing: no sample
            dt = time.monotonic() - t_submit
            self._lat.observe(dt)
            # the micro-batch's submit→finish span (host clock; it ends
            # after the CUDA event waits above): under a journey context
            # it picks up the journey's ids
            spans.emit(
                "score_finish", t_submit, dt,
                groups=len(tickets), n=n,
            )
            if self.batcher is not None:
                scored = n - len(unserved) - len(shed)
                if scored > 0:
                    self.batcher.observe(scored, dt)
        self.slo.maybe_tick()  # burn-rate state rides the batch loop
        if self._freshness is not None and records:
            if shed:
                # shed records were DROPPED, not delivered: booking
                # their event times would advance the sink watermark
                shed_set = set(shed)
                served = [
                    r for i, r in enumerate(records)
                    if i not in shed_set
                ]
            else:
                served = records
            tr = batch_event_range(served, self._event_time_fn)
            if tr is not None:
                self._freshness.observe_batch(tr[0], tr[1])
        if self._pressure is not None:
            self._pressure.maybe_tick()
        if self._emit is not None:
            return self._emit(records, preds)
        if self._emit_pairs:
            return [(p, r) for p, r in zip(preds, records)]
        return list(preds)

    def _redispatch_group(self, key, model, idxs, payloads, error):
        """Device-fault recovery for one per-model group: re-launch it
        from the retained payloads through the same window under the
        shared full-jitter backoff → (decoded, last_error), with
        ``decoded=None`` when the streak exhausted or the fault turned
        into a lost context or a record error (the caller re-raises)."""
        from flink_jpmml_tpu_torch.utils.retry import Backoff, env_int

        n_idxs = len(idxs)
        bo = Backoff(
            "device", base_s=0.02, cap_s=0.5,
            max_attempts=env_int("FJT_DEVICE_RETRIES", 2),
        )
        while not bo.exhausted:
            bo.sleep()
            try:
                with self._stream.context():
                    scorer, _, handle = self._launch_group(
                        key, model, idxs, payloads
                    )[:3]
                self.metrics.counter("redispatches").inc()
                decoded = scorer.decode(self._wait_handle(handle), n_idxs)
            except Exception as e2:
                error = e2
                k2 = devfault.classify(e2)
                if k2 is None or k2 == devfault.KIND_LOST:
                    return None, e2
                devfault.note(self.metrics, k2, n=n_idxs, error=e2)
                continue
            self.metrics.counter("redispatch_records").inc(n_idxs)
            return decoded, error
        return None, error

    # -- rollout accounting / shadow diffing -------------------------------

    def _observe_rollout_group(
        self, name: str, role: str, n_records: int, latency: float
    ) -> None:
        """Per-role traffic + latency accounting for a rolled-out name:
        the signals the guardrail controller windows over. Both roles'
        latency is one bracket, a group's :class:`LaunchSpan`, so the
        comparison is like-for-like."""
        if role == "candidate":
            self.metrics.counter(
                f'rollout_candidate_records{{model="{name}"}}'
            ).inc(n_records)
            self.metrics.histogram(
                f'rollout_candidate_latency_s{{model="{name}"}}'
            ).observe(latency)
        else:
            self.metrics.counter(
                f'rollout_incumbent_records{{model="{name}"}}'
            ).inc(n_records)
            self.metrics.histogram(
                f'rollout_incumbent_latency_s{{model="{name}"}}'
            ).observe(latency)

    def _record_score_dist(self, name: str, role: str, decoded) -> None:
        """Sketch one rolled-out group's score values per role
        (``rollout_score_dist{model,role}``): the guardrail controller's
        prediction-PSI signal reads their windowed divergence."""
        vals = [
            float(p.score.value)
            for p in decoded
            if p is not None and not p.is_empty and p.score is not None
        ]
        if vals:
            self.metrics.sketch(
                f'rollout_score_dist{{model="{name}",role="{role}"}}'
            ).observe_many(np.asarray(vals, np.float64))

    def _diff_shadows(self, shadows, preds) -> None:
        """Fetch + decode the mirrored candidate dispatches and diff them
        against the incumbent's emitted predictions: disagreement rate and
        numeric drift are the shadow stage's health signals. Shadow
        outputs never reach ``preds`` — zero sink leakage."""
        for entry, name in shadows:
            scorer, idxs, handle, span = (
                entry[0], entry[1], entry[2], entry[9])
            try:
                decoded = scorer.decode(self._wait_handle(handle), len(idxs))
            except Exception as e:
                self.metrics.counter(
                    f'rollout_candidate_errors{{model="{name}"}}'
                ).inc(len(idxs))
                flight.record(
                    "rollout_candidate_error", model=name, error=repr(e),
                    shadow=True,
                )
                continue
            # mirrored dispatches are real candidate work: they feed the
            # candidate latency histogram (the shadow stage's only latency
            # signal) and the candidate score sketch, so the prediction-PSI
            # guardrails evaluate at the shadow stage too
            self.metrics.histogram(
                f'rollout_candidate_latency_s{{model="{name}"}}'
            ).observe(span.seconds())
            self._record_score_dist(name, "candidate", decoded)
            disagreements = 0
            drift = self.metrics.histogram(
                f'rollout_shadow_drift{{model="{name}"}}'
            )
            for i, cp in zip(idxs, decoded):
                ip = preds[i]
                if ip is None:
                    continue
                if self._disagrees(ip, cp, drift):
                    disagreements += 1
            self.metrics.counter(
                f'rollout_shadow_compared{{model="{name}"}}'
            ).inc(len(idxs))
            if disagreements:
                self.metrics.counter(
                    f'rollout_shadow_disagree{{model="{name}"}}'
                ).inc(disagreements)

    @staticmethod
    def _disagrees(ip: Prediction, cp: Prediction, drift) -> bool:
        """One mirrored pair's verdict: emptiness or label mismatch is a
        disagreement outright; numeric values disagree past f32 noise.
        Every numeric diff (target value + shared numeric output fields)
        lands in the drift histogram either way."""
        if ip.is_empty or cp.is_empty:
            return ip.is_empty != cp.is_empty
        il = ip.target.label if ip.target is not None else None
        cl = cp.target.label if cp.target is not None else None
        iv, cv = ip.score.value, cp.score.value
        d = abs(cv - iv)
        drift.observe(d)
        if ip.outputs and cp.outputs:
            for k, v in ip.outputs.items():
                w = cp.outputs.get(k)
                if isinstance(v, (int, float)) and isinstance(w, (int, float)):
                    drift.observe(abs(float(w) - float(v)))
        if il != cl:
            return True
        return d > 1e-6 * max(1.0, abs(iv))

    # -- checkpointed operator state (C6/C7) ------------------------------

    def state(self) -> dict:
        return self.registry.state()

    def restore(self, state: dict) -> None:
        self.registry.restore(state)


def _dispatch_pack(pack, Xp: np.ndarray, staging, rows) -> DeviceOutput:
    """One packed dispatch: on the card the buffer is copied into the
    pack's pinned staging and the launch, the epilogues and the D2H copy
    of every member's output queue on the current stream; on the CPU the
    work is done when this returns."""
    if pack.device.type != "cuda":
        return device_output(pack.dispatch(Xp, rows))
    staged = staging.stage(Xp, Xp.shape[0])
    return device_output(pack.dispatch(staged, rows), staged)


class _PackFetch:
    """Memoized fetch of one packed dispatch, shared by the member tickets
    riding it: the first member's ``finish`` pays the FIFO wait, the rest
    read the cached tuple (or re-raise the cached failure, so each member
    runs its OWN solo device-fault recovery)."""

    __slots__ = ("_dispatcher", "handle", "_done", "_out", "_err")

    def __init__(self, dispatcher, handle):
        self._dispatcher = dispatcher
        self.handle = handle
        self._done = False
        self._out = None
        self._err: Optional[BaseException] = None

    def result(self):
        if not self._done:
            try:
                self._out = self._dispatcher.wait(self.handle).result()
            except Exception as e:
                self._err = e
            self._done = True
        if self._err is not None:
            raise self._err
        return self._out


class _PackSlice:
    """One member's view of a packed dispatch: its fetch de-multiplexes
    the member's slot from the pack's output tuple (byte-identical to the
    member's solo dispatch)."""

    __slots__ = ("_shared", "slot")

    def __init__(self, shared: _PackFetch, slot: int):
        self._shared = shared
        self.slot = slot

    def fetch(self):
        return self._shared.result()[self.slot]
