"""Worker supervision: automatic restart-from-checkpoint (SURVEY.md §6
row "Failure detection / elastic recovery", recovery half).

The reference's user gets automatic job restart from the Flink runtime:
heartbeats detect a dead TaskManager, the restart strategy (fixed-delay
or failure-rate, both bounded) relaunches the job, and execution resumes
from the last completed checkpoint. ``parallel/health.py`` provides the
detection half; this module owns the recovery half — so detection →
restart is in-tree and automatic, not "the operator runs a script"
(docs/operations.md pre-round-5).

:class:`Supervisor` owns a set of worker *processes*:

- spawn: each :class:`WorkerSpec` is an argv the supervisor launches
  with ``FJT_SUPERVISOR_ADDR`` / ``FJT_WORKER_ID`` in the environment;
  the worker is expected to (a) beat via :func:`reporter_from_env` and
  (b) resume from its own checkpoint on startup — restart-from-
  checkpoint stays the worker's C7 contract (idempotent load, seek to
  committed offset); the supervisor never migrates state.
- detect: two independent signals, either sufficient —
  * **process exit** (a watcher thread polls ``Popen``), the fast
    path for crashes/kill -9;
  * **heartbeat silence** (``HealthCoordinator.on_dead``), the only
    path for a *wedged* worker whose process is still alive — that
    worker is killed first, then restarted.
- restart: per-worker bounded retries with exponential backoff
  (:class:`RestartPolicy` — Flink's fixed-delay strategy; a
  ``window_s`` turns it into the failure-rate strategy: only failures
  inside the trailing window count against ``max_restarts``).
- give up: a worker exceeding the policy stays down and
  ``on_give_up(worker_id)`` fires exactly once — the operator
  escalation point, matching Flink's job-failure terminal state.

A worker that exits rc=0 is *finished*, not failed: it is
deregistered and never restarted (streaming jobs normally never exit;
batch drains do).

The port's copy of ``flink_jpmml_tpu/runtime/supervisor.py`` (process
supervision, no device code), with the import lines renamed: spawn,
detection, the restart policy, group mode, the give-up, the fleet
views and the rollout broadcast are the JAX module's, and so are both
deadlines' defaults (``heartbeat_timeout_s=2.0``,
``first_beat_timeout_s=30.0``). A worker that must create a CUDA
context first should do so before it starts beating, so that the
start falls under the first-beat deadline, not the silence deadline;
its stdout is its own to redirect (``Popen`` inherits the
supervisor's, as in JAX).
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.obs.server import ObsServer
from flink_jpmml_tpu_torch.parallel.health import HealthCoordinator, HealthReporter
from flink_jpmml_tpu_torch.rollout.controller import RolloutBook, RolloutController
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry, merge_structs

_ADDR_ENV = "FJT_SUPERVISOR_ADDR"
_ID_ENV = "FJT_WORKER_ID"


def rollout_control_hook(registry) -> Callable[[dict], None]:
    """→ an ``on_control`` hook applying broadcast rollout decisions to
    ``registry`` (a ``ModelRegistry``; pass ``scorer.registry``). The
    worker half of fleet-wide rollback convergence: the supervisor's
    guardrail controller broadcasts one decision, every beating worker
    applies it within a heartbeat interval."""
    from flink_jpmml_tpu_torch.models.control import from_wire
    from flink_jpmml_tpu_torch.utils.exceptions import FlinkJpmmlTpuError

    def hook(doc: dict) -> None:
        frame = doc.get("rollout")
        if not isinstance(frame, dict):
            return
        try:
            registry.apply(from_wire(frame))
        except (ValueError, FlinkJpmmlTpuError) as e:
            # a malformed/unapplicable broadcast must not take the
            # heartbeat down; the flight ring says what was refused
            flight.record("rollout_control_rejected", error=str(e))

    return hook


def reporter_from_env(
    interval_s: float = 0.25, metrics=None, rollout_registry=None,
    on_control=None,
) -> Optional[HealthReporter]:
    """Worker side: start beating to the supervising coordinator named
    by the environment (no-op → None when not under supervision).
    ``metrics`` (a ``MetricsRegistry``) makes every beat piggyback its
    ``struct_snapshot`` so the supervisor's ``/metrics`` endpoint can
    serve this worker's counters/histograms — the one-line opt-in to
    fleet observability. ``rollout_registry`` (a ``ModelRegistry``,
    e.g. ``scorer.registry``) additionally subscribes this worker to
    the supervisor's rollout control broadcasts (fleet-wide
    promote/rollback convergence); ``on_control`` is the raw-hook
    override for custom control documents."""
    addr = os.environ.get(_ADDR_ENV)
    wid = os.environ.get(_ID_ENV)
    if not addr or not wid:
        return None
    host, port = addr.rsplit(":", 1)
    if on_control is None and rollout_registry is not None:
        on_control = rollout_control_hook(rollout_registry)
    if metrics is not None:
        # supervision is also the worker's history opt-in: with
        # FJT_HISTORY_DIR set (inherited from the supervisor), the
        # recorder starts capturing durable delta frames — the frames
        # a SIGKILLed worker's incident window is reconstructed from
        from flink_jpmml_tpu_torch.obs import history

        history.history_for(metrics)
    return HealthReporter(
        host, int(port), wid, interval_s=interval_s,
        snapshot_fn=(
            metrics.struct_snapshot if metrics is not None else None
        ),
        on_control=on_control,
    )


@dataclass(frozen=True)
class RestartPolicy:
    """Flink restart-strategy analogue. ``window_s=None`` = fixed-delay
    (lifetime budget of ``max_restarts``); a window makes it
    failure-rate (``max_restarts`` per trailing ``window_s``).

    The backoff draws from the SHARED capped-exponential-full-jitter
    schedule (utils/retry.full_jitter — the kafka-reconnect and
    checkpoint-retry cadence): a deterministic exponential synchronizes
    a fleet's restart storms — every worker of a dead dependency
    respawns at the same instant and re-kills it — while full jitter
    decorrelates them. ``backoff_multiplier`` still governs the
    ceiling's growth (1.0 = a fixed-delay policy's constant ceiling,
    jittered); ``FJT_RESTART_BASE_S`` / ``FJT_RESTART_CAP_S`` override
    ``backoff_s`` / ``max_backoff_s`` fleet-wide when set (the
    ``FJT_RETRY_*`` convention)."""

    max_restarts: int = 3
    backoff_s: float = 0.2
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 10.0
    window_s: Optional[float] = None
    # a restarted worker that stays up this long is healthy again: the
    # exponential backoff resets (failures months apart must not pay
    # the max backoff forever)
    reset_after_s: float = 10.0

    def backoff(
        self, consecutive_failures: int,
        rng: Optional[Callable[[], float]] = None,
    ) -> float:
        from flink_jpmml_tpu_torch.utils.retry import env_float, full_jitter
        import random

        base = env_float("FJT_RESTART_BASE_S", self.backoff_s)
        cap = max(env_float("FJT_RESTART_CAP_S", self.max_backoff_s), base)
        return full_jitter(
            base, cap, max(consecutive_failures - 1, 0),
            rng if rng is not None else random.random,
            growth=self.backoff_multiplier,
        )

    def backoff_ceiling(self, consecutive_failures: int) -> float:
        """The schedule's ceiling at this failure count (what a jitter
        draw of 1.0 yields) — tests and capacity planning read it."""
        return self.backoff(consecutive_failures, rng=lambda: 1.0)


@dataclass(frozen=True)
class WorkerSpec:
    worker_id: str
    argv: Sequence[str]
    env: Optional[Dict[str, str]] = None
    cwd: Optional[str] = None


@dataclass
class _WorkerState:
    spec: WorkerSpec
    proc: Optional[subprocess.Popen] = None
    spawned_at: float = 0.0
    failure_times: List[float] = field(default_factory=list)
    consecutive_failures: int = 0
    restart_at: Optional[float] = None  # backoff deadline, monotonic
    finished: bool = False  # exited rc=0: do not restart
    gave_up: bool = False
    gave_up_notified: bool = False  # on_give_up fired exactly once
    restarts: int = 0  # successful respawns (observability)


class Supervisor:
    """Spawn, watch, and automatically restart worker processes.

    ``heartbeat_timeout_s=None`` disables the coordinator (process-exit
    detection only — enough when workers can only die, not wedge)."""

    def __init__(
        self,
        specs: Sequence[WorkerSpec],
        policy: RestartPolicy = RestartPolicy(),
        heartbeat_timeout_s: Optional[float] = 2.0,
        first_beat_timeout_s: float = 30.0,
        on_give_up: Optional[Callable[[str], None]] = None,
        on_restart: Optional[Callable[[str, int], None]] = None,
        poll_interval_s: float = 0.05,
        restart_group: bool = False,
    ):
        """``restart_group=True`` is Flink's full-job restart strategy:
        ANY worker failure tears down every live worker and respawns
        the whole set after one shared backoff, with ONE shared policy
        budget. This is the right mode for a ``torch.distributed``
        process group — a dead rank breaks the group's collectives, so
        the surviving ranks cannot continue and must restart together
        from the shared checkpoint. The default (False) restarts
        workers independently — right for shared-nothing scoring
        workers that each own a partition."""
        ids = [s.worker_id for s in specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids: {ids}")
        self._policy = policy
        self._first_beat_timeout = first_beat_timeout_s
        self._on_give_up = on_give_up
        self._on_restart = on_restart
        self._poll_interval = poll_interval_s
        # supervisor-local metrics (fleet rollout-controller decisions
        # land here); merged into the unlabeled aggregate on /metrics
        self.metrics = MetricsRegistry()
        self._rollout_ctl: Optional[RolloutController] = None
        self._mu = threading.Lock()
        self._workers: Dict[str, _WorkerState] = {
            s.worker_id: _WorkerState(spec=s) for s in specs
        }
        self._closing = False
        self._obs: Optional[ObsServer] = None
        # telemetry history (obs/history.py): armed in start() when
        # FJT_HISTORY_DIR is set — the supervisor records the FLEET
        # AGGREGATE (merge of heartbeat snapshots, which outlive their
        # workers) under the reserved "_fleet" source
        self._history = None
        self._history_due = 0.0
        self._group = restart_group
        # group mode: ONE shared failure budget + backoff clock
        self._group_failures: List[float] = []
        self._group_consecutive = 0
        self._group_restart_at: Optional[float] = None
        self._group_gave_up = False
        self._coord: Optional[HealthCoordinator] = None
        if heartbeat_timeout_s is not None:
            self._coord = HealthCoordinator(
                timeout_s=heartbeat_timeout_s,
                on_dead=self._on_heartbeat_dead,
                # a successfully restarted worker resumes beating under
                # the same id; recovery needs no action here
            )
        self._watcher = threading.Thread(target=self._watch, daemon=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        give_up: List[str] = []
        if os.environ.get("FJT_HISTORY_DIR"):
            from flink_jpmml_tpu_torch.obs import history

            # no capture thread: the watch loop is the tick source, so
            # fleet frames stop exactly when supervision stops
            self._history = history.install(
                self.metrics, start_thread=False
            )
        with self._mu:
            if self._group:
                ok = all(
                    self._spawn_locked_raw(st)
                    for st in list(self._workers.values())
                )
                if not ok:  # a partial group cannot run collectives
                    self._kill_live_locked()
                    self._count_group_failure_locked(
                        time.monotonic(), give_up
                    )
            else:
                for st in self._workers.values():
                    self._spawn_locked(st)
        # a spawn failure that immediately exhausts the budget must
        # still reach the operator (callbacks outside the lock)
        for wid in give_up:
            flight.record("worker_give_up", worker=wid)
            flight.dump(reason=f"worker_give_up:{wid}")
            if self._on_give_up is not None:
                try:
                    self._on_give_up(wid)
                except Exception:
                    pass
        self._watcher.start()

    def stop(self, grace_s: float = 5.0) -> None:
        """Terminate all workers (SIGTERM, then SIGKILL after grace)."""
        with self._mu:
            self._closing = True
            procs = [
                st.proc for st in self._workers.values()
                if st.proc is not None and st.proc.poll() is None
            ]
        for p in procs:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + grace_s
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                    p.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        if self._watcher.is_alive():
            self._watcher.join(timeout=5.0)
        if self._rollout_ctl is not None:
            self._rollout_ctl.close()
            self._rollout_ctl = None
        if self._coord is not None:
            self._coord.close()
        if self._obs is not None:
            self._obs.close()
            self._obs = None
        if self._history is not None:
            self._history.close()  # flushes pending coarse frames
            self._history = None

    # -- views -------------------------------------------------------------

    def status(self) -> Dict[str, dict]:
        """Per-worker liveness + the worker's latest heartbeat-
        piggybacked metrics struct (None until its first metric-bearing
        beat, or without a coordinator) — the fleet view in one call."""
        snaps = self.metrics_snapshots()
        with self._mu:
            return {
                wid: {
                    "alive": st.proc is not None
                    and st.proc.poll() is None,
                    "pid": st.proc.pid if st.proc is not None else None,
                    "restarts": st.restarts,
                    "finished": st.finished,
                    "gave_up": st.gave_up,
                    "metrics": snaps.get(wid),
                }
                for wid, st in self._workers.items()
            }

    def metrics_snapshots(self) -> Dict[str, dict]:
        """Latest piggybacked metrics struct per worker id."""
        if self._coord is None:
            return {}
        return self._coord.metrics_snapshots()

    def fleet_metrics(self) -> dict:
        """The merged fleet view: counters/gauges add, histogram
        buckets add — quantiles over the merge are exact
        (utils/metrics.merge_structs). Includes the supervisor's own
        registry (fleet rollout decisions)."""
        return merge_structs(
            list(self.metrics_snapshots().values())
            + [self.metrics.struct_snapshot()]
        )

    # -- fleet rollout control plane ---------------------------------------

    def broadcast_control(self, doc: dict, key: str = "") -> int:
        """Publish a control document to every beating worker over the
        heartbeat reply channel (workers opt in via
        ``reporter_from_env(..., rollout_registry=...)`` /
        ``on_control=``); → the document's sequence number. Documents
        replace per ``key`` only — independent decisions (different
        rollout names) all reach a reconnecting worker."""
        if self._coord is None:
            raise RuntimeError(
                "broadcast_control needs the heartbeat coordinator "
                "(heartbeat_timeout_s must not be None)"
            )
        return self._coord.set_control(doc, key=key)

    def broadcast_rollout(self, msg) -> int:
        """Broadcast one rollout decision fleet-wide. Workers apply it
        to their local registries on their next beat, so a guardrail
        rollback converges across the fleet within a heartbeat
        interval; a worker that restarts meanwhile converges on its
        first beat (the coordinator re-serves each name's current
        document — keyed per name, so concurrent rollouts' decisions
        never shadow each other)."""
        from flink_jpmml_tpu_torch.models.control import to_wire

        seq = self.broadcast_control(
            {"rollout": to_wire(msg)}, key=f"rollout:{msg.name}"
        )
        flight.record(
            "rollout_broadcast", seq=seq,
            model=f"{msg.name}_{msg.version}", stage=msg.stage,
        )
        return seq

    def rollout_controller(
        self, interval_s: float = 0.5, start: bool = True
    ) -> RolloutController:
        """The fleet guardrail controller: evaluates the MERGED fleet
        metrics (exact histogram merges — the map/reduce-style aggregate over
        per-worker measurements) and actuates via
        :meth:`broadcast_rollout`, so one verdict moves every worker.
        Feed it rollouts with ``controller._book.apply(msg)`` (or
        :meth:`broadcast_rollout` plus a book apply) when initiating
        from the supervisor side. Closed by :meth:`stop`."""
        if self._rollout_ctl is not None:
            return self._rollout_ctl
        book = RolloutBook(self.broadcast_rollout)
        self._rollout_ctl = RolloutController(
            book=book,
            struct_fn=self.fleet_metrics,
            metrics=self.metrics,
            interval_s=interval_s,
        )
        if start:
            self._rollout_ctl.start()
        return self._rollout_ctl

    def start_obs_server(
        self, host: str = "127.0.0.1", port: int = 0
    ) -> ObsServer:
        """Expose the fleet on HTTP: ``/metrics`` (Prometheus text —
        the aggregate unlabeled, per-worker series labeled
        ``worker="..."``), ``/healthz`` (503 once nothing is alive and
        not everything finished cleanly), ``/varz`` (raw structs).
        Closed by :meth:`stop`; calling again first closes the previous
        server (releasing its port) — a rebind, not a leak."""
        if self._obs is not None:
            self._obs.close()
            self._obs = None

        def collect():
            snaps = self.metrics_snapshots()
            sources: Dict[Optional[str], dict] = {
                None: merge_structs(
                    list(snaps.values())
                    + [self.metrics.struct_snapshot()]
                )
            }
            sources.update(snaps)
            return sources

        def health():
            st = self.status()
            ok = any(s["alive"] for s in st.values()) or (
                bool(st) and all(s["finished"] for s in st.values())
            )
            return {
                "ok": ok,
                "workers": {
                    w: {k: v for k, v in s.items() if k != "metrics"}
                    for w, s in st.items()
                },
            }

        from flink_jpmml_tpu_torch.obs import history

        self._obs = ObsServer(
            collect, host=host, port=port, health_fn=health,
            # /history serves the shared frame directory: per-worker
            # sources by default, the supervisor's "_fleet" aggregate
            # on ?source=_fleet
            history_fn=(
                lambda params: history.history_payload(
                    self.metrics, params
                )
            ),
        )
        return self._obs

    @property
    def coordinator_address(self) -> Optional[str]:
        if self._coord is None:
            return None
        return f"{self._coord.host}:{self._coord.port}"

    # -- internals ---------------------------------------------------------

    def _spawn_locked_raw(self, st: _WorkerState) -> bool:
        """Popen one worker; False on OSError (fork EAGAIN under memory
        pressure, ENOENT after a deploy replaced the binary) with NO
        policy accounting — group mode owns its own shared budget. Must
        NEVER raise: an exception here would kill the watcher thread
        and silently disable ALL supervision."""
        env = dict(os.environ)
        if st.spec.env:
            env.update(st.spec.env)
        env[_ID_ENV] = st.spec.worker_id
        # the supervisor half of crash-loop fingerprinting: the spawned
        # incarnation KNOWS how many consecutive failures preceded it,
        # so a pipeline restoring at the same offset can flip into
        # suspect mode (runtime/dlq.py) even when the deaths happened
        # before its first checkpoint ever landed
        env["FJT_RESTART_STREAK"] = str(max(
            st.consecutive_failures,
            self._group_consecutive if self._group else 0,
        ))
        if self._coord is not None:
            env[_ADDR_ENV] = f"{self._coord.host}:{self._coord.port}"
        try:
            st.proc = subprocess.Popen(
                list(st.spec.argv), env=env, cwd=st.spec.cwd
            )
        except OSError as e:
            st.proc = None
            flight.record(
                "worker_spawn_failed", worker=st.spec.worker_id,
                error=str(e),
            )
            return False
        st.spawned_at = time.monotonic()
        st.restart_at = None
        flight.record(
            "worker_spawn", worker=st.spec.worker_id, pid=st.proc.pid
        )
        return True

    def _spawn_locked(self, st: _WorkerState) -> bool:
        """Per-worker spawn: a Popen failure counts as an immediate
        worker failure against that worker's restart policy."""
        if self._spawn_locked_raw(st):
            return True
        (
            st.failure_times,
            st.consecutive_failures,
            st.gave_up,
            st.restart_at,
        ) = self._strike(
            st.failure_times, st.consecutive_failures, time.monotonic()
        )
        return False

    def _on_heartbeat_dead(self, worker_id: str) -> None:
        """A worker stopped beating. If its process is still alive it is
        wedged (hung device call, deadlock): kill it — the watcher then
        sees the exit and takes the normal restart path. A process
        already dead is the watcher's job; nothing to do here."""
        with self._mu:
            st = self._workers.get(worker_id)
            if st is None or self._closing or st.finished or st.gave_up:
                return
            proc = st.proc
            spawned_at = st.spawned_at
        last = (
            self._coord.last_seen(worker_id)
            if self._coord is not None
            else None
        )
        if last is not None and last < spawned_at:
            # the silence belongs to a PREVIOUS incarnation (e.g. it was
            # just killed and respawned): the current one hasn't had a
            # chance to beat yet — the watcher's first-beat deadline
            # covers it, and killing it here would cycle restarts forever
            return
        if proc is not None and proc.poll() is None:
            flight.record(
                "worker_wedged_kill", worker=worker_id, pid=proc.pid
            )
            try:
                proc.send_signal(signal.SIGKILL)
            except OSError:
                pass

    def _kill_live_locked(self) -> None:
        for st in self._workers.values():
            if st.proc is not None and st.proc.poll() is None:
                try:
                    st.proc.send_signal(signal.SIGKILL)
                except OSError:
                    pass

    def _strike(self, times: List[float], consecutive: int, now: float):
        """Register one failure against a policy budget → (pruned
        failure times, consecutive+1, gave_up, restart_at). The ONE
        implementation of the window/backoff/give-up arithmetic, shared
        by per-worker spawns, per-worker sweeps, and the group budget."""
        times = times + [now]
        consecutive += 1
        if self._policy.window_s is not None:
            times = [t for t in times if now - t <= self._policy.window_s]
        gave_up = len(times) > self._policy.max_restarts
        restart_at = (
            None if gave_up else now + self._policy.backoff(consecutive)
        )
        return times, consecutive, gave_up, restart_at

    def _first_beat_kill_locked(self, wid, st, now) -> None:
        """SIGKILL a live worker whose CURRENT incarnation has never
        beaten past the first-beat deadline (shared by both sweep
        modes; the kill surfaces as an exit next sweep)."""
        if self._coord is None:
            return
        last = self._coord.last_seen(wid)
        if (
            (last is None or last < st.spawned_at)
            and now - st.spawned_at > self._first_beat_timeout
        ):
            try:
                st.proc.send_signal(signal.SIGKILL)
            except OSError:
                pass

    def _watch_group_locked(self, now, give_up, restarted, deaths) -> None:
        """One sweep of full-job restart semantics (Flink's default):
        any failure → tear down all → one shared backoff → respawn
        all. Appends to the callback lists; caller holds the lock."""
        if self._group_gave_up:
            for wid, st in self._workers.items():
                if not (st.gave_up_notified or st.finished):
                    st.gave_up = True
                    st.gave_up_notified = True
                    give_up.append(wid)
            return
        live = [
            st for st in self._workers.values()
            if st.proc is not None and st.proc.poll() is None
        ]
        if self._group_restart_at is not None:
            if live or now < self._group_restart_at:
                return  # still tearing down / backing off
            pending = [
                (wid, st) for wid, st in self._workers.items()
                if not st.finished
            ]
            if all(self._spawn_locked_raw(st) for _, st in pending):
                # commit the restart only once the WHOLE group is up —
                # a partial group is as dead as a failed one
                for wid, st in pending:
                    st.restarts += 1
                    restarted.append(wid)
                self._group_restart_at = None
            else:
                self._kill_live_locked()
                self._count_group_failure_locked(now, give_up)
            return
        # healthy-uptime reset for the shared backoff
        if (
            self._group_consecutive > 0
            and live
            and all(
                now - st.spawned_at > self._policy.reset_after_s
                for st in live
            )
        ):
            self._group_consecutive = 0
        failed = False
        for wid, st in self._workers.items():
            proc = st.proc
            if proc is None or st.finished:
                continue
            if proc.poll() is None:
                self._first_beat_kill_locked(wid, st, now)
                continue
            if proc.returncode == 0:
                st.finished = True
                if self._coord is not None:
                    self._coord.remove(wid)
            else:
                deaths.append(
                    {"worker": wid, "returncode": proc.returncode,
                     "pid": proc.pid}
                )
                failed = True
        if failed:
            self._kill_live_locked()
            self._count_group_failure_locked(now, give_up)

    def _count_group_failure_locked(self, now, give_up) -> None:
        (
            self._group_failures,
            self._group_consecutive,
            gave_up,
            self._group_restart_at,
        ) = self._strike(
            self._group_failures, self._group_consecutive, now
        )
        if gave_up:
            self._group_gave_up = True
            self._kill_live_locked()  # idempotent: nothing survives
            for wid, st in self._workers.items():
                if st.finished:
                    continue  # rc=0 means finished, never failed
                st.gave_up = True
                st.gave_up_notified = True
                if self._coord is not None:
                    self._coord.remove(wid)
                give_up.append(wid)

    def _watch(self) -> None:
        while True:
            give_up: List[str] = []
            restarted: List[str] = []
            deaths: List[dict] = []
            with self._mu:
                if self._closing:
                    return
                now = time.monotonic()
                if self._group:
                    self._watch_group_locked(
                        now, give_up, restarted, deaths
                    )
                for wid, st in (
                    {} if self._group else self._workers
                ).items():
                    if st.gave_up:
                        if not st.gave_up_notified:
                            st.gave_up_notified = True
                            if self._coord is not None:
                                self._coord.remove(wid)
                            give_up.append(wid)
                        continue
                    if st.finished:
                        continue
                    if st.restart_at is not None:
                        if now >= st.restart_at:
                            if self._spawn_locked(st):
                                st.restarts += 1
                                restarted.append(wid)
                            # a failed respawn re-arms restart_at (or
                            # gives up) inside _spawn_locked
                        continue
                    proc = st.proc
                    if proc is None or proc.poll() is None:
                        if proc is not None:
                            if (
                                st.consecutive_failures > 0
                                and now - st.spawned_at
                                > self._policy.reset_after_s
                            ):
                                st.consecutive_failures = 0
                            # a worker wedged before its FIRST heartbeat
                            # is invisible to the on_dead path (it only
                            # covers live beats): kill it, the exit
                            # takes the normal restart path next sweep
                            self._first_beat_kill_locked(wid, st, now)
                        continue
                    if proc.returncode == 0:
                        st.finished = True
                        if self._coord is not None:
                            self._coord.remove(wid)
                        continue
                    deaths.append(
                        {"worker": wid, "returncode": proc.returncode,
                         "pid": proc.pid}
                    )
                    # failed: count against the policy window
                    (
                        st.failure_times,
                        st.consecutive_failures,
                        gave_up_now,
                        st.restart_at,
                    ) = self._strike(
                        st.failure_times, st.consecutive_failures, now
                    )
                    if gave_up_now:
                        st.gave_up = True
                        st.gave_up_notified = True
                        if self._coord is not None:
                            self._coord.remove(wid)
                        give_up.append(wid)
            # flight recording + callbacks outside the lock (dump does
            # file I/O; callbacks may inspect status())
            for d in deaths:
                flight.record("worker_death", **d)
            if deaths:
                # the postmortem artifact the acceptance drill reads:
                # last-N events as JSONL, written at the moment the
                # supervisor observed the death(s)
                flight.dump(
                    reason="worker_death:"
                    + ",".join(d["worker"] for d in deaths)
                )
            for wid in restarted:
                flight.record(
                    "worker_restart", worker=wid,
                    restarts=self._workers[wid].restarts,
                )
                if self._on_restart is not None:
                    try:
                        self._on_restart(
                            wid, self._workers[wid].restarts
                        )
                    except Exception:
                        pass
            for wid in give_up:
                flight.record("worker_give_up", worker=wid)
                flight.dump(reason=f"worker_give_up:{wid}")
                if self._on_give_up is not None:
                    try:
                        self._on_give_up(wid)
                    except Exception:
                        pass
            self._history_tick()
            time.sleep(self._poll_interval)

    def _history_tick(self) -> None:
        """Capture the fleet aggregate into the history store at the
        recorder's interval. The aggregate merges the workers' LAST
        heartbeat snapshots — the coordinator keeps a dead worker's —
        so the ``_fleet`` timeline stays continuous across worker
        death, which is what lets an incident window be read back
        after the victim is gone."""
        rec = self._history
        if rec is None:
            return
        now = time.time()
        if now < self._history_due:
            return
        self._history_due = now + rec.interval_s
        from flink_jpmml_tpu_torch.obs import history

        try:
            fm = self.fleet_metrics()
            # the merged struct's ts is the STALEST member's capture
            # time (frozen once a worker dies) — the frame's clock is
            # the supervisor's capture, or the timeline would stop
            # advancing with the victim
            fm["ts"] = now
            rec.capture_struct(history.FLEET_SRC, fm, now=now)
        except Exception:
            pass  # history must never take supervision down
