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

Not ported (each raises :class:`NotPortedError` and names itself):
staged rollouts (``RolloutMessage``, ``guardrails=``, ``key_fn=``,
``auto_rollout=False``, another ``rollout_interval_s``), the overload
plane (``admission=``, ``lane_fn=``, ``batcher=``), the zoo (``zoo=``)
and ``mesh=``. The drift plane and the ``score_finish`` span wait for
their slices.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flink_jpmml_tpu_torch.api.reader import ModelReader
from flink_jpmml_tpu_torch.compile import prepare
from flink_jpmml_tpu_torch.models.control import from_wire
from flink_jpmml_tpu_torch.models.prediction import Prediction
from flink_jpmml_tpu_torch.obs import freshness as fresh_mod
from flink_jpmml_tpu_torch.obs import pressure as pressure_mod
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.runtime import devfault
from flink_jpmml_tpu_torch.runtime.engine import (
    Scorer,
    ScoringStream,
    new_staging,
)
from flink_jpmml_tpu_torch.runtime.pipeline import (
    OverlappedDispatcher,
    dispatch_f32,
    dispatch_quantized,
)
from flink_jpmml_tpu_torch.runtime.sources import ControlSource, batch_event_range
from flink_jpmml_tpu_torch.serving.registry import ModelRegistry
from flink_jpmml_tpu_torch.utils.config import CompileConfig
from flink_jpmml_tpu_torch.utils.exceptions import (
    FlinkJpmmlTpuError,
    NotPortedError,
    refuse,
)
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
        guardrails=None,
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
        every model this scorer serves."""
        refuse(mesh=mesh, key_fn=key_fn, guardrails=guardrails,
               admission=admission, lane_fn=lane_fn, batcher=batcher,
               zoo=zoo)
        if auto_rollout is not True or rollout_interval_s != 0.5:
            raise NotPortedError("auto_rollout= / rollout_interval_s= "
                                 "(staged rollouts) are not ported")
        self.metrics = metrics or MetricsRegistry()
        self.registry = ModelRegistry(
            batch_size=batch_size,
            compile_config=compile_config,
            async_warmup=async_warmup,
            metrics=self.metrics,
            device=device,
        )
        self.device = self.registry.device
        self._control = control
        self._route = route or default_route
        self._default_model = (
            default_reader.load(
                batch_size=batch_size, config=compile_config,
                device=self.device,
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
                if self.registry.apply(msg):
                    self._failed.clear()
                    served = {m.key() for m in self.registry.served}
                    for key in list(self._staging):
                        if key != _DEFAULT_KEY and key not in served:
                            del self._staging[key]

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
        n = len(records)
        # model key -> [model, [indices], [payloads]]
        groups: dict = {}
        # per-batch (name, version) -> (model, key) memo: the answer cannot
        # change within one batch
        resolved: dict = {}
        unserved: List[int] = []
        for i, event in enumerate(records):
            name, version, payload = self._route(event)
            if name is None:
                model, key = self._default_model, _DEFAULT_KEY
            else:
                hit = resolved.get((name, version))
                if hit is None:
                    hit = resolved[(name, version)] = self._resolve(
                        name, version)
                model, key = hit
            if model is None:
                unserved.append(i)
                continue
            g = groups.get(key)
            if g is None:
                groups[key] = [model, [i], [payload]]
            else:
                g[1].append(i)
                g[2].append(payload)
        tickets = []
        with self._stream.context():
            for key, (model, idxs, payloads) in groups.items():
                tickets.append(self._launch_group(key, model, idxs, payloads))
        return n, records, tickets, unserved, time.monotonic()

    def _launch_group(self, key: str, model, idxs, payloads):
        """Featurize + dispatch one per-model group through the shared
        window → its ticket entry: (the object whose ``decode`` matches the
        dispatch, indices, handle, model, staging, key, payloads — the
        last two let a device-faulted group re-dispatch)."""
        first = payloads[0]
        if isinstance(first, dict):
            X, M = prepare.from_records(model.field_space, payloads)
        else:
            X, M = prepare.from_dense(
                model.field_space,
                np.asarray(payloads, np.float32),
                self._replace_nan,
            )
        q = model.quantized_scorer()
        if q is None:
            handle = self._dispatcher.launch(
                lambda: dispatch_f32(model, X, M)
            )
            return model, idxs, handle, model, None, key, payloads
        staging = self._staging.get(key)
        if staging is None and self.device.type == "cuda":
            staging = self._staging[key] = new_staging(self.device)
        handle = self._dispatcher.launch(
            lambda: dispatch_quantized(
                q, X, M, metrics=self.metrics, staging=staging
            )
        )
        return q, idxs, handle, model, staging, key, payloads

    def finish(self, ticket) -> List[Any]:
        n, records, tickets, unserved, t_submit = ticket
        preds: List[Optional[Prediction]] = [None] * n
        for scorer, idxs, handle, model, _staging, key, payloads in tickets:
            try:
                out = self._dispatcher.wait(handle)
                decoded = scorer.decode(out.result(), len(idxs))
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
                if decoded is None:
                    raise e
            for i, p in zip(idxs, decoded):
                preds[i] = p
        for i in unserved:
            preds[i] = Prediction.empty()
        if tickets:  # an all-unserved batch scored nothing: no sample
            self._lat.observe(time.monotonic() - t_submit)
        if self._freshness is not None and records:
            tr = batch_event_range(records, self._event_time_fn)
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
                    scorer, _, handle, _, _, _, _ = self._launch_group(
                        key, model, idxs, payloads
                    )
                self.metrics.counter("redispatches").inc()
                out = self._dispatcher.wait(handle)
                decoded = scorer.decode(out.result(), n_idxs)
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

    # -- checkpointed operator state (C6/C7) ------------------------------

    def state(self) -> dict:
        return self.registry.state()

    def restore(self, state: dict) -> None:
        self.registry.restore(state)
