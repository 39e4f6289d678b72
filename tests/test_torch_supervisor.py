"""The port's worker supervisor (runtime/supervisor.py) held to the JAX
package on the CPU.

The twins of the JAX tests/test_supervisor.py cases and of the
supervisor cases of tests/test_obs.py (``TestHeartbeatPiggyback``,
``TestSupervisorDeathDump``, ``TestFleetMetricsDrill``). The cases whose
workers only exit or sleep run under both packages' supervisors, which
must end in the same state (restarts, finished, give-up, callbacks). The
workers that beat are ``python -c`` bodies that import the port, never
jax; a torch import under a loaded test host takes seconds, so their
first-beat deadlines are 60 s. Two wedge paths are held: a worker that
never beats (the first-beat deadline) and one that beats and then falls
silent (the heartbeat coordinator's death, then the wedge kill). The JAX
file's kill -9 drill is here too, marked slow as the JAX one is; its card
counterpart is chip_smoke.py's ``fleet`` phase.
"""

import json
import os
import signal
import sys
import textwrap
import time
import urllib.request

import numpy as np
import pytest

from flink_jpmml_tpu.runtime import supervisor as jsup
from flink_jpmml_tpu_torch.obs import history
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.obs.trace import iter_jsonl
from flink_jpmml_tpu_torch.runtime import supervisor as tsup
from flink_jpmml_tpu_torch.runtime.supervisor import (
    RestartPolicy,
    Supervisor,
    WorkerSpec,
)
from flink_jpmml_tpu_torch.utils.metrics import Histogram, merge_structs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a worker that beats imports torch first: seconds under six test workers
FIRST_BEAT_S = 60.0


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    # a worker's death makes the supervisor dump its flight ring
    monkeypatch.setenv("FJT_FLIGHT_DIR", str(tmp_path / "flightdir"))


@pytest.fixture(params=["port", "jax"])
def sup_mod(request):
    return tsup if request.param == "port" else jsup


def _py(body: str) -> list:
    return [sys.executable, "-c", textwrap.dedent(body)]


def _wait(pred, timeout_s: float, interval_s: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return pred()


def _stable(pred, hold_s: float, timeout_s: float) -> bool:
    """True once ``pred()`` has held for ``hold_s`` without a break."""
    deadline = time.monotonic() + timeout_s
    since = None
    while time.monotonic() < deadline:
        if pred():
            since = since or time.monotonic()
            if time.monotonic() - since >= hold_s:
                return True
        else:
            since = None
        time.sleep(0.02)
    return False


def _settles(value_fn, hold_s: float, timeout_s: float) -> bool:
    """True once ``value_fn()`` stops changing for ``hold_s``."""
    deadline = time.monotonic() + timeout_s
    last, t0 = value_fn(), time.monotonic()
    while time.monotonic() < deadline:
        cur = value_fn()
        if cur != last:
            last, t0 = cur, time.monotonic()
        elif time.monotonic() - t0 >= hold_s:
            return True
        time.sleep(0.05)
    return False


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


# -- the restart policy ----------------------------------------------------------


def test_backoff_ceiling_grows_and_caps_like_jax():
    one = lambda: 1.0  # noqa: E731
    for kw in (dict(backoff_s=0.5, max_backoff_s=3.0),
               dict(backoff_s=0.5, backoff_multiplier=1.0, max_backoff_s=3.0),
               dict(backoff_s=0.5, backoff_multiplier=3.0,
                    max_backoff_s=50.0)):
        p, j = RestartPolicy(**kw), jsup.RestartPolicy(**kw)
        for k in range(1, 11):
            assert p.backoff(k, rng=one) == j.backoff(k, rng=one)
            assert p.backoff(k, rng=lambda: 0.25) == j.backoff(
                k, rng=lambda: 0.25)
    p = RestartPolicy(backoff_s=0.5, max_backoff_s=3.0)
    assert [p.backoff(k, rng=one) for k in (1, 2, 3, 4, 10)] == [
        0.5, 1.0, 2.0, 3.0, 3.0]
    assert p.backoff_ceiling(10) == 3.0
    assert p.backoff(3, rng=lambda: 0.25) == pytest.approx(0.5)
    assert RestartPolicy(backoff_s=0.5, backoff_multiplier=3.0,
                         max_backoff_s=50.0).backoff(3, rng=one) == (
        pytest.approx(4.5))


def test_backoff_draws_stay_under_ceiling():
    p = RestartPolicy(backoff_s=0.1, max_backoff_s=1.0)
    for k in range(1, 12):
        ceil = p.backoff_ceiling(k)
        assert all(0.0 <= p.backoff(k) <= ceil for _ in range(32))


def test_backoff_env_override(monkeypatch):
    monkeypatch.setenv("FJT_RESTART_BASE_S", "0.25")
    monkeypatch.setenv("FJT_RESTART_CAP_S", "0.5")
    p = RestartPolicy(backoff_s=5.0, max_backoff_s=50.0)
    assert p.backoff(1, rng=lambda: 1.0) == 0.25
    assert p.backoff(4, rng=lambda: 1.0) == 0.5
    j = jsup.RestartPolicy(backoff_s=5.0, max_backoff_s=50.0)
    assert j.backoff(4, rng=lambda: 1.0) == 0.5


# -- supervision of workers that exit or sleep, under both supervisors -----------


def test_clean_exit_is_finished_not_restarted(sup_mod):
    sup = sup_mod.Supervisor(
        [sup_mod.WorkerSpec("w0", _py("pass"))],
        policy=sup_mod.RestartPolicy(backoff_s=0.01),
        heartbeat_timeout_s=None)
    sup.start()
    try:
        assert _wait(lambda: sup.status()["w0"]["finished"], 10.0)
        assert _stable(
            lambda: (lambda st: st["finished"] and st["restarts"] == 0
                     and not st["gave_up"])(sup.status()["w0"]),
            hold_s=0.2, timeout_s=10.0), sup.status()
    finally:
        sup.stop()


def test_crash_restarts_then_gives_up(sup_mod):
    gave_up = []
    sup = sup_mod.Supervisor(
        [sup_mod.WorkerSpec("w0", _py("import sys; sys.exit(3)"))],
        policy=sup_mod.RestartPolicy(max_restarts=2, backoff_s=0.01),
        heartbeat_timeout_s=None, on_give_up=gave_up.append)
    sup.start()
    try:
        assert _wait(lambda: sup.status()["w0"]["gave_up"], 15.0)
        assert sup.status()["w0"]["restarts"] == 2
        assert _wait(lambda: gave_up == ["w0"], 10.0), gave_up
        # the give-up fires once, and nothing respawns after it
        assert _stable(lambda: gave_up == ["w0"]
                       and not sup.status()["w0"]["alive"], 0.3, 10.0)
    finally:
        sup.stop()


def test_failure_rate_window_forgives_old_failures(sup_mod, tmp_path):
    flag = tmp_path / "crashed-once"
    body = f"""
    import os, time, sys
    flag = {str(flag)!r}
    if not os.path.exists(flag):
        open(flag, "w").close()
        sys.exit(1)
    time.sleep(60)
    """
    sup = sup_mod.Supervisor(
        [sup_mod.WorkerSpec("w0", _py(body))],
        policy=sup_mod.RestartPolicy(max_restarts=1, backoff_s=0.01,
                                     window_s=5.0),
        heartbeat_timeout_s=None)
    sup.start()
    try:
        assert _wait(lambda: sup.status()["w0"]["restarts"] == 1, 10.0)
        assert _stable(lambda: (lambda st: st["alive"] and not st["gave_up"])(
            sup.status()["w0"]), hold_s=0.3, timeout_s=10.0), sup.status()
    finally:
        sup.stop()


def test_restart_streak_exported_to_workers(sup_mod, tmp_path):
    log = tmp_path / "streaks.log"
    body = f"""
    import os, sys, time
    with open({str(log)!r}, "a") as f:
        f.write(os.environ.get("FJT_RESTART_STREAK", "?") + "\\n")
    if len(open({str(log)!r}).read().split()) < 3:
        sys.exit(1)
    time.sleep(60)
    """
    sup = sup_mod.Supervisor(
        [sup_mod.WorkerSpec("w0", _py(body))],
        policy=sup_mod.RestartPolicy(max_restarts=5, backoff_s=0.01),
        heartbeat_timeout_s=None)
    sup.start()
    try:
        assert _wait(lambda: log.exists()
                     and len(log.read_text().split()) >= 3, 15.0)
        assert log.read_text().split()[:3] == ["0", "1", "2"]
    finally:
        sup.stop()


def test_two_workers_independent(sup_mod):
    sup = sup_mod.Supervisor(
        [sup_mod.WorkerSpec("crasher", _py("import sys; sys.exit(2)")),
         sup_mod.WorkerSpec("steady", _py("import time; time.sleep(60)"))],
        policy=sup_mod.RestartPolicy(max_restarts=1, backoff_s=0.01),
        heartbeat_timeout_s=None)
    sup.start()
    try:
        assert _wait(lambda: sup.status()["crasher"]["gave_up"], 15.0)
        st = sup.status()
        assert st["steady"]["alive"] and not st["steady"]["gave_up"]
    finally:
        sup.stop()


def test_one_death_restarts_the_whole_group(sup_mod):
    sleep = _py("import time; time.sleep(120)")
    sup = sup_mod.Supervisor(
        [sup_mod.WorkerSpec(f"r{i}", sleep) for i in range(3)],
        policy=sup_mod.RestartPolicy(max_restarts=3, backoff_s=0.05),
        heartbeat_timeout_s=None, restart_group=True)
    sup.start()
    try:
        assert _wait(lambda: all(s["alive"] for s in sup.status().values()),
                     15.0), sup.status()
        pids = {w: s["pid"] for w, s in sup.status().items()}
        os.kill(pids["r1"], signal.SIGKILL)
        assert _wait(lambda: all(s["alive"] and s["restarts"] >= 1
                                 for s in sup.status().values()), 20.0)
        new = {w: s["pid"] for w, s in sup.status().items()}
        assert all(new[w] != pids[w] for w in pids)
    finally:
        sup.stop()


def test_group_budget_is_shared(sup_mod):
    gave_up = []
    sup = sup_mod.Supervisor(
        [sup_mod.WorkerSpec("r0", _py("import sys; sys.exit(9)")),
         sup_mod.WorkerSpec("r1", _py("import time; time.sleep(120)"))],
        policy=sup_mod.RestartPolicy(max_restarts=2, backoff_s=0.02),
        heartbeat_timeout_s=None, restart_group=True,
        on_give_up=gave_up.append)
    sup.start()
    try:
        assert _wait(lambda: all(s["gave_up"]
                                 for s in sup.status().values()), 20.0)
        assert _wait(lambda: sorted(gave_up) == ["r0", "r1"], 10.0), gave_up
        assert _wait(lambda: not sup.status()["r1"]["alive"], 10.0)
    finally:
        sup.stop()


def test_first_beat_deadline_kills_a_silent_worker(sup_mod, tmp_path):
    # incarnation 1 never beats (wedged before its first heartbeat): the
    # first-beat deadline kills it; incarnation 2 finishes cleanly
    flag = tmp_path / "silent-once"
    body = f"""
    import os, time
    flag = {str(flag)!r}
    if not os.path.exists(flag):
        open(flag, "w").close()
        time.sleep(120)
    """
    sup = sup_mod.Supervisor(
        [sup_mod.WorkerSpec("w0", _py(body))],
        policy=sup_mod.RestartPolicy(max_restarts=3, backoff_s=0.01),
        heartbeat_timeout_s=30.0, first_beat_timeout_s=1.0)
    sup.start()
    try:
        assert _wait(lambda: sup.status()["w0"]["finished"], 30.0), (
            sup.status())
        st = sup.status()["w0"]
        assert st["restarts"] == 1 and not st["gave_up"]
    finally:
        sup.stop()


def _dumped_spawn_and_death(directory, worker):
    """The first ``flight-*`` dump that parses whole and holds ``worker``'s
    death with returncode 3 → (its spawn event, its death event), paired
    by the worker's pid; None while no dump does. A dump is written in
    place (the recorder opens its file, then writes the lines), so a read
    can meet it half-written: such a file is read again at the next poll.
    """
    for n in sorted(os.listdir(directory)):
        if not n.startswith("flight-"):
            continue
        try:
            with open(os.path.join(directory, n), encoding="utf-8") as f:
                events = [json.loads(ln) for ln in f if ln.strip()]
        except (OSError, ValueError):
            continue
        for d in events:
            if (d.get("kind") == "worker_death" and d.get("worker") == worker
                    and d.get("returncode") == 3):
                spawns = [e for e in events
                          if e.get("kind") == "worker_spawn"
                          and e.get("worker") == worker
                          and e.get("pid") == d.get("pid")]
                if spawns:
                    return spawns[0], d
    return None


def test_worker_death_dumps_flight_jsonl(sup_mod, tmp_path, monkeypatch):
    monkeypatch.setenv("FJT_FLIGHT_DIR", str(tmp_path))
    # the ring is process-wide: without a clear, a dump carries the events
    # of earlier tests run in the same process
    sup_mod.flight.DEFAULT.clear()
    sup = sup_mod.Supervisor(
        [sup_mod.WorkerSpec("w0", _py("import sys; sys.exit(3)"))],
        policy=sup_mod.RestartPolicy(max_restarts=0),
        heartbeat_timeout_s=None)
    sup.start()
    try:
        found = []
        assert _wait(lambda: found.append(
            _dumped_spawn_and_death(tmp_path, "w0")) or found[-1], 15.0)
        spawn, death = found[-1]
        assert death["worker"] == "w0" and death["returncode"] == 3
        assert spawn["worker"] == "w0" and spawn["pid"] == death["pid"]
        assert spawn["seq"] < death["seq"]
    finally:
        sup.stop()


def test_duplicate_ids_and_control_without_a_coordinator_raise():
    spec = WorkerSpec("w0", _py("pass"))
    with pytest.raises(ValueError):
        Supervisor([spec, spec])
    sup = Supervisor([spec], heartbeat_timeout_s=None)
    assert sup.coordinator_address is None
    with pytest.raises(RuntimeError):
        sup.broadcast_control({"x": 1})
    assert tsup.reporter_from_env() is None  # not under supervision


# -- heartbeats: the metrics piggyback and the control channel ---------------------


def test_snapshots_reach_the_coordinator():
    from flink_jpmml_tpu_torch.parallel.health import (
        HealthCoordinator,
        HealthReporter,
    )
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.counter("records_out").inc(123)
    reg.histogram("batch_latency_s").observe(0.02)
    coord = HealthCoordinator(timeout_s=5.0)
    rep = HealthReporter(coord.host, coord.port, "w0", interval_s=0.05,
                         snapshot_fn=reg.struct_snapshot)
    try:
        assert _wait(lambda: "w0" in coord.metrics_snapshots(), 10.0)
        snap = coord.metrics_snapshots()["w0"]
        assert snap["counters"]["records_out"] == 123
        assert Histogram.from_state(
            snap["histograms"]["batch_latency_s"]).count() == 1
        coord.remove("w0")
        assert "w0" not in coord.metrics_snapshots()
    finally:
        rep.stop()
        coord.close()


def test_a_broken_snapshot_fn_does_not_stop_beats():
    from flink_jpmml_tpu_torch.parallel.health import (
        HealthCoordinator,
        HealthReporter,
    )

    coord = HealthCoordinator(timeout_s=5.0)
    rep = HealthReporter(coord.host, coord.port, "w0", interval_s=0.05,
                         snapshot_fn=lambda: 1 / 0)
    try:
        assert _wait(lambda: coord.last_seen("w0") is not None, 10.0)
        assert coord.metrics_snapshots() == {}
    finally:
        rep.stop()
        coord.close()


def test_rollout_control_hook_applies_and_refuses(tmp_path):
    from flink_jpmml_tpu_torch.models.control import (
        AddMessage,
        RolloutMessage,
        to_wire,
    )
    from flink_jpmml_tpu_torch.serving.registry import ModelRegistry

    reg = ModelRegistry(async_warmup=False, device="cpu")
    reg.apply(AddMessage("a", 1, "/tmp/a1.pmml", 1.0))
    reg.apply(RolloutMessage("a", 2, "canary", 1.0, path="/tmp/a2.pmml"))
    hook = tsup.rollout_control_hook(reg)
    seq0 = flight.DEFAULT._seq
    hook({"rollout": {"name": "a", "stage": "nonsense"}})
    hook({"other": 1})  # not a rollout document: ignored
    assert reg.rollout("a") is not None
    assert [e["kind"] for e in flight.events() if e["seq"] > seq0] == [
        "rollout_control_rejected"]
    hook({"rollout": to_wire(RolloutMessage("a", 2, "rollback", 2.0))})
    assert reg.rollout("a") is None and reg.resolve("a", 2) is None


# -- supervised workers that beat (they import the port) -----------------------------


_WEDGE_WORKER = """
import os, sys, time
sys.path.insert(0, {repo!r})
from flink_jpmml_tpu_torch.runtime.supervisor import reporter_from_env
assert "jax" not in sys.modules
rep = reporter_from_env(interval_s=0.05)
assert rep is not None
flag = {flag!r}
if not os.path.exists(flag):
    open(flag, "w").close()
    time.sleep(0.5)
    rep.stop()  # wedged: alive, no longer beating
time.sleep(120)
"""


def test_a_worker_that_stops_beating_is_killed_and_restarted(tmp_path):
    seq0 = flight.DEFAULT._seq
    body = _WEDGE_WORKER.format(repo=REPO, flag=str(tmp_path / "wedged"))
    sup = Supervisor([WorkerSpec("w0", _py(body))],
                     policy=RestartPolicy(max_restarts=8, backoff_s=0.01),
                     heartbeat_timeout_s=2.0,
                     first_beat_timeout_s=FIRST_BEAT_S)
    sup.start()
    try:
        assert _wait(lambda: sup.status()["w0"]["restarts"] >= 1, 90.0), (
            sup.status())
        assert _settles(lambda: sup.status()["w0"]["restarts"], hold_s=2.5,
                        timeout_s=60.0), sup.status()
        st = sup.status()["w0"]
        assert st["alive"] and not st["gave_up"], st
        kills = [e for e in flight.events() if e["seq"] > seq0
                 and e["kind"] == "worker_wedged_kill"]
        assert kills and kills[0]["worker"] == "w0"
    finally:
        sup.stop()


@pytest.mark.slow  # as the JAX twin: a first-beat deadline sized for imports
def test_wedged_worker_is_killed_and_restarted(tmp_path):
    flag = tmp_path / "wedged-once"
    body = f"""
    import os, sys, time
    sys.path.insert(0, {REPO!r})
    from flink_jpmml_tpu_torch.runtime.supervisor import reporter_from_env
    flag = {str(flag)!r}
    if not os.path.exists(flag):
        open(flag, "w").close()
        time.sleep(120)  # wedged: no heartbeat, no exit
    rep = reporter_from_env()
    assert rep is not None
    time.sleep(120)
    """
    sup = Supervisor([WorkerSpec("w0", _py(body))],
                     policy=RestartPolicy(max_restarts=8, backoff_s=0.01),
                     heartbeat_timeout_s=2.0, first_beat_timeout_s=15.0)
    sup.start()
    try:
        assert _wait(lambda: sup.status()["w0"]["restarts"] >= 1, 60.0)
        assert _settles(lambda: sup.status()["w0"]["restarts"], hold_s=2.5,
                        timeout_s=30.0), sup.status()
        st = sup.status()["w0"]
        assert st["alive"] and not st["gave_up"], st
    finally:
        sup.stop()


_OBS_WORKER = """
import os, sys, time
sys.path.insert(0, {repo!r})
from flink_jpmml_tpu_torch.runtime.supervisor import reporter_from_env
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
assert "jax" not in sys.modules

wid = os.environ["FJT_WORKER_ID"]
reg = MetricsRegistry()
reg.counter("records_out").inc(100 if wid == "w0" else 50)
h = reg.histogram("batch_latency_s")
vals = (0.0012, 0.012) if wid == "w0" else (0.12, 0.9)
for v in vals:
    for _ in range(50):
        h.observe(v)
rep = reporter_from_env(interval_s=0.05, metrics=reg)
assert rep is not None
while True:
    reg.counter("records_out").inc(0)
    time.sleep(0.05)
"""


def test_two_worker_aggregate_history_and_death_dump(tmp_path, monkeypatch):
    """The JAX TestFleetMetricsDrill on the port: the aggregated /metrics
    and /varz equal the merge of the workers' registries, a SIGKILLed
    worker leaves a flight dump with its death and its last snapshot
    keeps serving. With FJT_HISTORY_DIR set the workers record their own
    frames and the supervisor the ``_fleet`` aggregate, which
    ``/history?source=_fleet`` serves; the killed incarnation's frames
    read back, and downsample(merge) equals merge(downsample)."""
    flight_dir = tmp_path / "flight"
    hdir = tmp_path / "history"
    monkeypatch.setenv("FJT_FLIGHT_DIR", str(flight_dir))
    monkeypatch.setenv("FJT_HISTORY_DIR", str(hdir))
    monkeypatch.setenv("FJT_HISTORY_INTERVAL_S", "0.25")
    monkeypatch.setenv("FJT_HISTORY_RES", "0.25,1")
    body = textwrap.dedent(_OBS_WORKER.format(repo=REPO))
    sup = Supervisor(
        [WorkerSpec("w0", [sys.executable, "-c", body]),
         WorkerSpec("w1", [sys.executable, "-c", body])],
        policy=RestartPolicy(max_restarts=3, backoff_s=0.05),
        heartbeat_timeout_s=2.0, first_beat_timeout_s=FIRST_BEAT_S)
    sup.start()
    srv = sup.start_obs_server()
    try:
        assert _wait(lambda: set(sup.metrics_snapshots()) == {"w0", "w1"},
                     90.0), sup.metrics_snapshots().keys()
        st = sup.status()
        assert st["w0"]["metrics"]["counters"]["records_out"] == 100
        assert st["w1"]["metrics"]["counters"]["records_out"] == 50

        status, body_ = _get(srv.url + "/varz")
        varz = json.loads(body_)
        assert status == 200 and set(varz) == {"", "w0", "w1"}
        merged = merge_structs([varz["w0"], varz["w1"]])
        agg = dict(varz[""])
        # the aggregate also folds in the supervisor's own registry (its
        # history counters) and its uptime and capture time
        sup_counters = sup.metrics.struct_snapshot()["counters"]
        for k in ("uptime_s", "ts"):
            agg.pop(k, None)
            merged.pop(k, None)
        for name in ("records_out",):
            assert agg["counters"][name] == merged["counters"][name] == 150
        assert agg["histograms"] == merged["histograms"]
        assert set(agg["counters"]) >= set(merged["counters"])
        assert set(agg["counters"]) - set(merged["counters"]) <= set(
            sup_counters)
        h_agg = Histogram.from_state(agg["histograms"]["batch_latency_s"])
        h_merge = Histogram.from_state(
            varz["w0"]["histograms"]["batch_latency_s"]).merge(
            Histogram.from_state(varz["w1"]["histograms"]["batch_latency_s"]))
        for q in (0.5, 0.99, 0.999):
            assert h_agg.quantile(q) == h_merge.quantile(q)
        assert 0.012 <= h_agg.quantile(0.5) <= 0.012 * 1.7783
        assert 0.9 <= h_agg.quantile(0.999) <= 0.9 * 1.7783

        status, text = _get(srv.url + "/metrics")
        assert status == 200
        assert "fjt_records_out 150\n" in text
        assert 'fjt_records_out{worker="w0"} 100\n' in text
        assert 'fjt_records_out{worker="w1"} 50\n' in text
        assert "fjt_batch_latency_s_count 200\n" in text
        status, body_ = _get(srv.url + "/healthz")
        assert status == 200 and json.loads(body_)["ok"] is True

        # both workers' frames and the supervisor's _fleet timeline
        assert _wait(lambda: {f["src"] for f in history.read_frames(
            str(hdir), res=0.25)} >= {"w0", "w1"}, 30.0)
        assert _wait(lambda: history.read_frames(
            str(hdir), res=0.25, sources=[history.FLEET_SRC]), 30.0)
        status, body_ = _get(srv.url + "/history?source=_fleet&step=0.25")
        fleet = json.loads(body_)["frames"]
        assert status == 200 and fleet
        assert {f["src"] for f in fleet} == {history.FLEET_SRC}

        pid = sup.status()["w0"]["pid"]
        os.kill(pid, signal.SIGKILL)
        assert _wait(lambda: flight_dir.is_dir() and any(
            n.startswith("flight-") for n in os.listdir(flight_dir)), 30.0)
        events = []
        for n in sorted(os.listdir(flight_dir)):
            if n.startswith("flight-"):
                with open(flight_dir / n, encoding="utf-8") as f:
                    events += [json.loads(ln) for ln in f if ln.strip()]
        assert [e for e in events if e.get("kind") == "worker_death"
                and e.get("worker") == "w0"]
        assert "w0" in sup.metrics_snapshots()  # the last snapshot serves
    finally:
        sup.stop()
    # the killed incarnation's own segments read back
    killed = [f for n in sorted(os.listdir(hdir)) if f"-{pid}-" in n
              for f in iter_jsonl(str(hdir / n))]
    assert killed and {f["src"] for f in killed} == {"w0"}
    fine = history.read_frames(str(hdir), res=0.25, sources=["w0", "w1"])
    direct = [history.canonical(f) for f in history.downsample(fine, 1.0)]
    per = [f for w in ("w0", "w1") for f in history.downsample(
        [f for f in fine if f["src"] == w], 1.0)]
    assert direct and direct == [history.canonical(f)
                                 for f in history.downsample(per, 1.0)]


def test_fleet_controller_rolls_back_over_the_broadcast(tmp_path):
    """The supervisor's guardrail controller judges the merged heartbeat
    structs and carries its rollback over the beat replies: a worker whose
    struct shows a disagreeing canary converges on v1 through
    ``reporter_from_env(rollout_registry=)``'s hook."""
    from flink_jpmml_tpu_torch.models.control import RolloutMessage
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.rollout.state import GuardrailSpec

    status_file = tmp_path / "status.json"
    body = f"""
    import json, os, sys, time
    sys.path.insert(0, {REPO!r})
    from flink_jpmml_tpu_torch.models.control import (
        AddMessage, RolloutMessage)
    from flink_jpmml_tpu_torch.runtime.supervisor import reporter_from_env
    from flink_jpmml_tpu_torch.serving.registry import ModelRegistry
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
    reg = ModelRegistry(async_warmup=False, device="cpu")
    reg.apply(AddMessage("m", 1, "/tmp/m1.pmml", 1.0))
    reg.apply(RolloutMessage("m", 2, "canary", 2.0, path="/tmp/m2.pmml",
                             fraction=0.2))
    m = MetricsRegistry()
    m.counter('rollout_shadow_compared{{model="m"}}').inc(400)
    m.counter('rollout_shadow_disagree{{model="m"}}').inc(200)
    m.counter('rollout_candidate_records{{model="m"}}').inc(100)
    rep = reporter_from_env(interval_s=0.05, metrics=m,
                            rollout_registry=reg)
    while reg.rollout("m") is not None:
        time.sleep(0.01)
    with open({str(status_file)!r} + ".tmp", "w") as f:
        json.dump({{"rollout": reg.rollout("m") is None,
                   "v2": reg.resolve("m", 2) is None,
                   "serves": str(reg.resolve("m"))}}, f)
    os.replace({str(status_file)!r} + ".tmp", {str(status_file)!r})
    time.sleep(120)
    """
    sup = Supervisor([WorkerSpec("w0", _py(body))],
                     policy=RestartPolicy(max_restarts=2, backoff_s=0.05),
                     first_beat_timeout_s=FIRST_BEAT_S)
    sup.start()
    try:
        assert _wait(lambda: "w0" in sup.metrics_snapshots(), 90.0)
        ctl = sup.rollout_controller(interval_s=0.05)
        assert sup.rollout_controller() is ctl
        ctl._book.apply(RolloutMessage(
            "m", 2, "canary", time.time(), guardrails=GuardrailSpec(
                min_samples=50, promote_after_s=3600.0)))
        assert _wait(status_file.exists, 30.0)
        assert json.loads(status_file.read_text()) == {
            "rollout": True, "v2": True, "serves": str(ModelId("m", 1))}
        assert ctl._book.rollouts() == {}
        counters = sup.fleet_metrics()["counters"]
        assert counters['rollout_rollbacks{model="m"}'] == 1.0
    finally:
        sup.stop()


_DRILL_WORKER = """
import os, sys, time
sys.path.insert(0, {repo!r})
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
from flink_jpmml_tpu_torch.runtime.kafka import KafkaBlockSource
from flink_jpmml_tpu_torch.runtime.supervisor import reporter_from_env
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

host, port, topic, pmml, ckdir, outfile, total = (
    sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], sys.argv[6], int(sys.argv[7]),
)
rep = reporter_from_env()
cm = compile_pmml(parse_pmml_file(pmml), batch_size=64, device="cpu")
out = open(outfile, "a", buffering=1)

def sink(o, n, first_off):
    out.write(f"E {{first_off}} {{n}}\\n")

src = KafkaBlockSource(host, port, topic, n_cols=5, max_wait_ms=20)
pipe = BlockPipeline(
    src, cm, sink,
    RuntimeConfig(batch=BatchConfig(size=64, deadline_us=2000),
                  checkpoint_interval_s=0.05),
    checkpoint=CheckpointManager(ckdir),
)
restored = pipe.restore()
out.write(f"R {{pipe.committed_offset if restored else 0}}\\n")
pipe.start()
while pipe.committed_offset < total:
    time.sleep(0.01)
pipe.stop(); pipe.join(timeout=30.0)
src.close()
out.close()
"""


@pytest.mark.slow  # as the JAX twin: a 60k-record broker stream
def test_kill9_auto_restart_resumes_exactly(tmp_path):
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.runtime.kafka import MiniKafkaBroker

    pmml = gen_gbm(str(tmp_path), n_trees=10, depth=3, n_features=5)
    N = 60_000
    data = np.random.default_rng(5).normal(0, 1.5, size=(N, 5)).astype(
        np.float32)
    outfile = tmp_path / "emissions.log"
    outfile.touch()
    ckdir = tmp_path / "ck"
    broker = MiniKafkaBroker(topic="drill")
    sup = None
    try:
        broker.append_rows(data)
        sup = Supervisor(
            [WorkerSpec("scorer", [
                sys.executable, "-c", _DRILL_WORKER.format(repo=REPO),
                broker.host, str(broker.port), "drill", pmml, str(ckdir),
                str(outfile), str(N)])],
            policy=RestartPolicy(max_restarts=5, backoff_s=0.05),
            heartbeat_timeout_s=5.0, first_beat_timeout_s=FIRST_BEAT_S)
        sup.start()

        def committed():
            try:
                st = CheckpointManager(str(ckdir)).load_latest()
                return st["source_offset"] if st else 0
            except Exception:
                return 0

        assert _wait(lambda: 0 < committed() < N, 90.0, 0.05)
        os.kill(sup.status()["scorer"]["pid"], signal.SIGKILL)
        assert _wait(lambda: sup.status()["scorer"]["finished"], 180.0, 0.1)
        assert sup.status()["scorer"]["restarts"] >= 1
    finally:
        if sup is not None:
            sup.stop()
        broker.close()
    emitted, restores = [], []
    for ln in outfile.read_text().splitlines():
        kind, *rest = ln.split()
        if kind == "E":
            emitted.append((int(rest[0]), int(rest[1])))
        elif kind == "R":
            restores.append(int(rest[0]))
    assert restores[0] == 0 and len(restores) >= 2
    c = restores[-1]
    assert 0 < c < N
    covered = np.zeros(N, np.int64)
    for off, n in emitted:
        covered[off:off + n] += 1
    assert (covered >= 1).all()
    assert (covered[:c] == 1).all()
    assert (covered <= 2).all()
