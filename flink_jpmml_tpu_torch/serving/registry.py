"""Served-model registry: metadata + lazily compiled models (capability C6).

The port of ``flink_jpmml_tpu/serving/registry.py``. Reference parity
(SURVEY.md §4.3): the dynamic co-operator holds a checkpointed map
``ModelId → ModelInfo``; model *instances* are loaded lazily from their
path on the first matching event, never checkpointed. Here "loaded" means
parsed + compiled on the registry's device, via the ``ModelReader``
compile cache (same path, mtime and device load once per process).

Compile stalls are kept off the hot path by **background warming +
double-buffered swap** (SURVEY.md §8 hard part (d)): an ``AddMessage``
kicks off a warm on a small thread pool (``fjt-warm``, 3 workers) that
parses, compiles and runs the new version once while traffic keeps
flowing — the scorer serves unpinned events from the newest already-warm
version until the new one is ready, then swaps. Only the first deployment
of a name (nothing warm to fall back to) waits, joining the in-flight
warm rather than duplicating it.

A warm ends with one dispatch of the model on zero codes of the compile
batch (the rank wire's ``predict_padded``, or ``warmup()``) and then a
``torch.cuda.synchronize``: the warm thread's stream is not the scoring
thread's, and pool streams do not wait on one another, so a model is
published as warm only once its weight copies and its first launch (and
with it the kernel's build, ``qtrees_cuda.build``, bound once a process
under its lock) have landed. A synchronous load does the same
synchronize.

State for checkpointing is the metadata map alone, as
``{"name_version": path}`` — JSON-shaped, tiny, resumable (C7). Restore
re-kicks background warming for every served id.

``mesh=`` (a ``parallel/mesh.Mesh``) makes every load and warm produce a
mesh-sharded ``ShardedModel`` on the mesh's primary device, so the swap
itself stays compile-free on a mesh; ``adopt_rebuilt`` replaces a served
id's instance after a degraded-mesh rebuild (``runtime/block.py``'s
``chip_loss`` rung), so latest-wins re-adoption never swaps the dead
mesh back in.

Where it differs: ``ModelRegistry(device=None)`` resolves its device at
construction (the card by default, ``"cpu"`` on request; the mesh's
primary device with ``mesh=``).

Staged rollouts are the JAX registry's: ``apply(RolloutMessage)`` moves a
candidate through shadow → canary → full or rolls it back
(``rollout/state.apply_rollout``), registering it first when the message
carries a ``path``; while a rollout is active, latest-wins routing
(``resolve(name)``, ``resolve_warm``) excludes the candidate, so only the
scorer's split and shadow mirrors send it traffic. A candidate warms like
an Add (once: a warm already in flight is joined). Rollouts ride
``state()``; ``restore`` brings them back with their ``stage_since``, so
a restore mid-canary resumes the dwell, and a candidate whose path
changed warms again.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from flink_jpmml_tpu_torch.api.reader import ModelReader
from flink_jpmml_tpu_torch.compile.compiler import CompiledModel
from flink_jpmml_tpu_torch.models.control import (
    AddMessage,
    RolloutMessage,
    ServingMessage,
)
from flink_jpmml_tpu_torch.models.core import ModelId, ModelInfo
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.rollout.state import (
    ACTIVE_STAGES,
    STAGE_ROLLBACK,
    RolloutState,
    apply_rollout,
)
from flink_jpmml_tpu_torch.serving import managers
from flink_jpmml_tpu_torch.utils.config import CompileConfig
from flink_jpmml_tpu_torch.utils.device import resolve_device
from flink_jpmml_tpu_torch.utils.exceptions import (
    FlinkJpmmlTpuError,
    ModelLoadingException,
)


class _WarmTask:
    """One in-flight background compile: join-able, result-or-error.

    ``info`` pins the exact registration (ModelInfo identity) the warm
    started from — a Del + re-Add with a different path, or a restore(),
    creates a *new* ModelInfo, so a stale warm's result/error is never
    attributed to the new registration."""

    def __init__(self, info: ModelInfo) -> None:
        self.info = info
        self.done = threading.Event()
        self.result: Optional[CompiledModel] = None
        self.error: Optional[BaseException] = None


class ModelRegistry:
    def __init__(
        self,
        batch_size: Optional[int] = None,
        compile_config: Optional[CompileConfig] = None,
        async_warmup: bool = True,
        warm_workers: int = 3,
        warm_join_timeout_s: float = 300.0,
        mesh=None,
        metrics=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """``mesh`` (a ``parallel/mesh.Mesh``) makes every load/warm
        produce a mesh-aware ``ShardedModel`` (same predict/decode
        contract; batch split over the data axis, wide linear stages
        feature-sharded over the model axis). Background warming shards
        the incoming version for the mesh, so the swap itself stays
        compile-free (C6 on a mesh)."""
        if mesh is not None and device is None:
            device = mesh.primary
        self.device = resolve_device(device)
        self._mesh = mesh
        self._meta: managers.Metadata = {}
        # name -> served versions, rebuilt on every _meta change: the
        # per-event resolve() must not scan the whole map under the lock
        self._by_name: Dict[str, List[int]] = {}
        self._compiled: Dict[ModelId, CompiledModel] = {}
        self._warming: Dict[ModelId, _WarmTask] = {}
        self._warm_failed: Dict[ModelId, BaseException] = {}
        # in-progress staged rollouts by model name (rollout/state.py):
        # while an entry is active, latest-wins routing (resolve with
        # version=None, resolve_warm) EXCLUDES the candidate version —
        # the split/shadow machinery in the scorer is the only way the
        # candidate sees traffic before promotion to full
        self._rollouts: Dict[str, RolloutState] = {}
        self._lock = threading.Lock()
        self._batch_size = batch_size
        self._compile_config = compile_config
        self._async = async_warmup
        # warms run on a small bounded pool, not a thread per model: a
        # restore() of a registry serving many models must not trigger a
        # simultaneous parse+compile storm
        self._warm_workers = max(1, warm_workers)
        self._warm_pool: Optional[ThreadPoolExecutor] = None
        # bounded join for in-flight warms (a wedged compile must surface
        # as ModelLoadingException, not hang the scoring thread)
        self._warm_join_timeout_s = warm_join_timeout_s
        # cold-start observability: every full parse+compile+first run —
        # background warm or synchronous lazy load — lands in
        # cold_start_s; resolve_warm books whether the double-buffer
        # fallback found a warm body (warm_pool_hits) or came up empty
        # (warm_pool_misses). A registry without metrics stays silent.
        self._h_cold = (
            metrics.histogram("cold_start_s") if metrics is not None
            else None
        )
        self._c_warm_hit = (
            metrics.counter("warm_pool_hits") if metrics is not None
            else None
        )
        self._c_warm_miss = (
            metrics.counter("warm_pool_misses") if metrics is not None
            else None
        )

    @property
    def async_warmup(self) -> bool:
        return self._async

    def apply(self, msg: ServingMessage) -> bool:
        """Apply one control message; returns True if the registry changed.
        An accepted Add immediately starts warming the new version in the
        background so the hot path never pays it."""
        if isinstance(msg, RolloutMessage):
            return self._apply_rollout(msg)
        with self._lock:
            new_meta, changed = managers.apply_message(self._meta, msg)
            if changed:
                removed = set(self._meta) - set(new_meta)
                self._meta = new_meta
                self._reindex_locked()
                for mid in removed:
                    self._compiled.pop(mid, None)
                    self._warm_failed.pop(mid, None)
                self._prune_rollouts_locked()
        if changed and self._async and isinstance(msg, AddMessage):
            self.ensure_warming(msg.model_id)
        return changed

    def _apply_rollout(self, msg: RolloutMessage) -> bool:
        """Rollout transitions, with their serving-metadata side effects:
        an active stage may register the candidate (``path`` = an Add
        folded in); ``full`` clears the entry so latest-wins takes over;
        ``rollback`` drops the candidate from serving entirely. A
        terminal message for a version that is not the tracked candidate
        is a no-op (a replayed decision must not cancel a newer rollout
        or un-serve a promoted model)."""
        mid = msg.model_id
        warm = False
        events = []
        with self._lock:
            changed = False
            if msg.stage in ACTIVE_STAGES:
                if mid not in self._meta:
                    if msg.path is None:
                        events.append((
                            "rollout_rejected",
                            dict(model=mid.key(),
                                 reason="unserved candidate without a path"),
                        ))
                        self._flight(events)
                        return False
                    meta = dict(self._meta)
                    meta[mid] = ModelInfo(path=msg.path)
                    self._meta = meta
                    self._reindex_locked()
                    changed = True
                cur = self._rollouts.get(msg.name)
                if cur is not None and cur.candidate_version != msg.version:
                    # a new rollout supersedes the old one: the abandoned
                    # candidate must NOT fall through to latest-wins
                    # routing un-promoted — drop it like a rollback
                    old = ModelId(msg.name, cur.candidate_version)
                    if old in self._meta:
                        meta = dict(self._meta)
                        del meta[old]
                        self._meta = meta
                        self._reindex_locked()
                    self._compiled.pop(old, None)
                    self._warm_failed.pop(old, None)
                    events.append((
                        "rollout_superseded",
                        dict(model=old.key(), by=mid.key()),
                    ))
                others = [
                    m.version for m in self._meta
                    if m.name == msg.name and m.version != msg.version
                ]
                if not others:
                    # first deployment of the name: there is no incumbent
                    # to split against or diff with — the candidate serves
                    # directly (degenerate promotion to full)
                    changed |= self._rollouts.pop(msg.name, None) is not None
                    events.append((
                        "rollout_degenerate_full", dict(model=mid.key()),
                    ))
                else:
                    self._rollouts, ch = apply_rollout(self._rollouts, msg)
                    changed |= ch
                    if ch:
                        events.append((
                            "rollout_stage",
                            dict(model=mid.key(), stage=msg.stage,
                                 fraction=self._rollouts[msg.name].fraction),
                        ))
                warm = changed
            elif msg.stage == STAGE_ROLLBACK:
                self._rollouts, ch = apply_rollout(self._rollouts, msg)
                if ch:
                    changed = True
                    if mid in self._meta:
                        meta = dict(self._meta)
                        del meta[mid]
                        self._meta = meta
                        self._reindex_locked()
                    self._compiled.pop(mid, None)
                    self._warm_failed.pop(mid, None)
                    events.append((
                        "rollout_rollback", dict(model=mid.key()),
                    ))
            else:  # full
                self._rollouts, ch = apply_rollout(self._rollouts, msg)
                changed = ch
                if ch:
                    events.append((
                        "rollout_full", dict(model=mid.key()),
                    ))
        self._flight(events)
        if warm and self._async:
            self.ensure_warming(mid)
        return changed

    @staticmethod
    def _flight(events) -> None:
        for kind, fields in events:  # outside the lock: recorder I/O-free
            flight.record(kind, **fields)

    def _prune_rollouts_locked(self) -> None:
        """Drop rollout entries an Add/Del made meaningless: a deleted
        candidate kills its rollout; a deleted incumbent hands the
        candidate the traffic (nothing else can serve the name)."""
        for name, st in list(self._rollouts.items()):
            cand = ModelId(name, st.candidate_version)
            if cand not in self._meta or not any(
                m.name == name and m.version != st.candidate_version
                for m in self._meta
            ):
                del self._rollouts[name]


    def _reindex_locked(self) -> None:
        by: Dict[str, List[int]] = {}
        for mid in self._meta:
            by.setdefault(mid.name, []).append(mid.version)
        self._by_name = by

    def resolve(
        self, name: str, version: Optional[int] = None
    ) -> Optional[ModelId]:
        """Served id for (name, version); version None → newest served,
        EXCLUDING the candidate of an active rollout (the incumbent —
        canary/shadow traffic to the candidate is the scorer's explicit
        decision, never latest-wins fallthrough). A pinned version still
        resolves the candidate directly."""
        with self._lock:
            if version is not None:
                mid = ModelId(name, version)
                return mid if mid in self._meta else None
            ro = self._rollouts.get(name)
            cand = ro.candidate_version if ro is not None else None
            best = max(
                (v for v in self._by_name.get(name, ()) if v != cand),
                default=None,
            )
            return ModelId(name, best) if best is not None else None

    def resolve_warm(self, name: str) -> Optional[ModelId]:
        """Newest *compiled-and-ready* version of ``name`` (the
        double-buffer fallback target), or None. An active rollout's
        candidate is never a fallback target — a cold incumbent must not
        silently hand the candidate 100% of the traffic."""
        with self._lock:
            ro = self._rollouts.get(name)
            cand = ro.candidate_version if ro is not None else None
            versions = [
                mid.version for mid in self._compiled
                if mid.name == name and mid.version != cand
            ]
        if versions:
            if self._c_warm_hit is not None:
                self._c_warm_hit.inc()
            return ModelId(name, max(versions))
        if self._c_warm_miss is not None:
            self._c_warm_miss.inc()
        return None

    # -- rollout views -----------------------------------------------------

    def rollout(self, name: str) -> Optional[RolloutState]:
        """The active rollout for ``name`` (immutable), or None."""
        with self._lock:
            return self._rollouts.get(name)

    def rollouts(self) -> Dict[str, RolloutState]:
        with self._lock:
            return dict(self._rollouts)

    def model_if_warm(self, mid: ModelId) -> Optional[CompiledModel]:
        """The compiled model iff it is ready *now* — never compiles, never
        blocks. A served-but-cold id gets a background warm kicked off."""
        with self._lock:
            cached = self._compiled.get(mid)
            served = mid in self._meta
            failed = mid in self._warm_failed
        if cached is not None:
            return cached
        if served and not failed and self._async:
            self.ensure_warming(mid)
        return None

    def warm_error(self, mid: ModelId) -> Optional[BaseException]:
        """The recorded background-warm failure for ``mid``, if any."""
        with self._lock:
            return self._warm_failed.get(mid)

    def is_warming(self, mid: ModelId) -> bool:
        with self._lock:
            return mid in self._warming

    def ensure_warming(self, mid: ModelId) -> None:
        """Start (once per registration) a background warm for a served
        id. A warm left over from a superseded registration (same id,
        different ModelInfo) is replaced, not reused."""
        with self._lock:
            info = self._meta.get(mid)
            if (
                info is None
                or mid in self._compiled
                or mid in self._warm_failed
            ):
                return
            existing = self._warming.get(mid)
            if existing is not None and existing.info is info:
                return
            task = _WarmTask(info)
            self._warming[mid] = task
            if self._warm_pool is None:
                self._warm_pool = ThreadPoolExecutor(
                    max_workers=self._warm_workers,
                    thread_name_prefix="fjt-warm",
                )
            pool = self._warm_pool
        pool.submit(self._warm_one, mid, task)

    def _warm_one(self, mid: ModelId, task: _WarmTask) -> None:
        try:
            t0 = time.monotonic()
            compiled = self._load(task.info)
            self._prewarm(compiled)
            if self._h_cold is not None:
                self._h_cold.observe(time.monotonic() - t0)
            task.result = compiled
            with self._lock:
                # attribute only to the registration this warm started
                # from — deleted/re-added/restored ids get a fresh warm
                if self._meta.get(mid) is task.info:
                    self._compiled[mid] = compiled
        except BaseException as e:  # recorded, surfaced via warm_error/model
            task.error = e
            with self._lock:
                if self._meta.get(mid) is task.info:
                    self._warm_failed[mid] = e
        finally:
            with self._lock:
                if self._warming.get(mid) is task:
                    del self._warming[mid]
            task.done.set()

    def _load(self, info: ModelInfo) -> CompiledModel:
        model = ModelReader(info.path).load(
            batch_size=self._batch_size,
            config=self._compile_config,
            device=self.device,
            mesh=self._mesh,
        )
        self._synchronize()
        return model

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prewarm(self, compiled: CompiledModel) -> None:
        """One dispatch on zero input of the compile batch, so the first
        event on this version pays a dispatch, not a first launch (nor
        the rank wire's build); then the synchronize of the module
        docstring."""
        q = compiled.quantized_scorer()
        if q is None:
            compiled.warmup()
        else:
            b = q.batch_size or 1
            q.predict_padded(np.zeros((b, len(q.wire.fields)), q.wire.dtype))
        self._synchronize()

    def adopt_rebuilt(self, mid_key: str, rebuilt) -> None:
        """Replace the compiled instance for a served id in place — the
        degraded-mesh rebuild path (runtime/block.py's ``chip_loss`` rung
        rebuilt the serving ``ShardedModel`` over the surviving devices).
        Without this, the next latest-wins re-adoption would compare
        against the pre-loss instance and swap the dead mesh back into
        service."""
        try:
            mid = ModelId.from_key(mid_key)
        except (ValueError, TypeError):
            return
        with self._lock:
            if mid in self._compiled:
                self._compiled[mid] = rebuilt

    def model(self, mid: ModelId) -> Optional[CompiledModel]:
        """The compiled model for a served id, compiling if needed (C6
        'lazy load on first matching event'). Joins an in-flight background
        warm instead of duplicating it; blocks only when the model is not
        yet compiled anywhere. Returns None if unserved; raises on a bad
        path / uncompilable document — callers decide whether that poisons
        the lane or the stream."""
        with self._lock:
            cached = self._compiled.get(mid)
            info = self._meta.get(mid)
            task = self._warming.get(mid)
            failed = self._warm_failed.get(mid)
        if cached is not None:
            return cached
        if info is None:
            return None
        if failed is not None:
            if isinstance(failed, FlinkJpmmlTpuError):
                raise failed
            raise ModelLoadingException(
                f"background compile of {mid.key()} failed: {failed!r}"
            ) from failed
        if task is not None and task.info is info:
            if not task.done.wait(self._warm_join_timeout_s):
                raise ModelLoadingException(
                    f"background warm of {mid.key()} did not complete "
                    f"within {self._warm_join_timeout_s:.0f}s (wedged "
                    "compile); model quarantined for now"
                )
            if task.error is not None:
                return self.model(mid)  # re-enter to raise the recorded error
            return task.result
        t0 = time.monotonic()
        compiled = self._load(info)
        if self._h_cold is not None:
            # the synchronous lazy-load cold start: the stall the warm
            # pool exists to avoid, so it books in the same histogram
            self._h_cold.observe(time.monotonic() - t0)
        with self._lock:
            # attribute only to this registration (see _warm_one)
            if self._meta.get(mid) is info:
                self._compiled[mid] = compiled
        return compiled

    @property
    def served(self) -> Dict[ModelId, ModelInfo]:
        with self._lock:
            return dict(self._meta)

    # -- checkpoint state (C7) --------------------------------------------

    def state(self) -> dict:
        with self._lock:
            out = {
                "served": {
                    mid.key(): info.path for mid, info in self._meta.items()
                }
            }
            if self._rollouts:
                # staged rollouts are checkpointed state (C7): a restore
                # mid-canary resumes the same stage / fraction / dwell
                # clock instead of re-flipping the candidate to full
                out["rollouts"] = {
                    name: st.as_dict()
                    for name, st in self._rollouts.items()
                }
            return out

    def restore(self, state: dict) -> None:
        meta: managers.Metadata = {}
        for key, path in state.get("served", {}).items():
            try:
                meta[ModelId.from_key(key)] = ModelInfo(path=path)
            except (ValueError, TypeError) as e:
                raise ModelLoadingException(
                    f"corrupt registry checkpoint entry {key!r}: {e}"
                ) from e
        rollouts: Dict[str, RolloutState] = {}
        for name, rs in (state.get("rollouts") or {}).items():
            try:
                rollouts[name] = RolloutState.from_dict(rs)
            except (KeyError, TypeError, ValueError) as e:
                raise ModelLoadingException(
                    f"corrupt rollout checkpoint entry {name!r}: {e}"
                ) from e
        with self._lock:
            # re-attribute what survives the restore instead of starting
            # cold: an id whose PMML path is unchanged keeps its in-flight
            # warm (the warm's identity check then lands the result on the
            # new registration) or its compiled model. A changed path is a
            # different document: it re-warms from scratch.
            preserved: Dict[ModelId, CompiledModel] = {}
            for mid, info in list(meta.items()):
                task = self._warming.get(mid)
                if task is not None and task.info.path == info.path:
                    meta[mid] = task.info
                    continue
                old = self._meta.get(mid)
                if old is not None and old.path == info.path:
                    meta[mid] = old
                    cm = self._compiled.get(mid)
                    if cm is not None:
                        preserved[mid] = cm
            self._meta = meta
            self._reindex_locked()
            self._compiled = preserved
            self._warm_failed.clear()
            # a rollout whose candidate vanished from the served map is
            # checkpoint skew, not a reason to fail the restore
            self._rollouts = {
                name: st for name, st in rollouts.items()
                if ModelId(name, st.candidate_version) in meta
            }
        if self._async:
            # recovered worker: warm everything served so the first event
            # after resume pays a dispatch, not a compile
            for mid in meta:
                self.ensure_warming(mid)
