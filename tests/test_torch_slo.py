"""The SLO burn-rate tracker of the port (``obs/slo.py``) on the CPU
against the JAX package's: the same latency observations on the same
fake clock give the same burn rates, ``breached``, ``health`` payload,
gauges, counters and flight events; the window grammar parses alike; and
the port's ``DynamicScorer`` always carries its tracker over
``score_latency_s``, as the JAX one does, ticking it every micro-batch.
Everything is compared exactly."""

import time
import types

import pytest

from test_torch_checkpoint import B, TWINS, gbm_path  # noqa: F401


def slo_pkg(name):
    if name == "jax":
        from flink_jpmml_tpu.obs import recorder as flight
        from flink_jpmml_tpu.obs import slo
        from flink_jpmml_tpu.utils import metrics
    else:
        from flink_jpmml_tpu_torch.obs import recorder as flight
        from flink_jpmml_tpu_torch.obs import slo
        from flink_jpmml_tpu_torch.utils import metrics
    return types.SimpleNamespace(slo=slo, flight=flight, metrics=metrics)


# each step: (seconds to advance, latencies observed before the tick)
SCENARIOS = {
    # healthy, then a burst far past the deadline breaches both windows,
    # then healthy traffic clears the short window
    "breach_and_clear": (
        [(1.0, [0.004] * 50)] * 12
        + [(1.0, [0.2] * 50)] * 12
        + [(1.0, [0.004] * 500)] * 30),
    # a brief blip trips only the short window: no page
    "blip": ([(1.0, [0.004] * 100)] * 30 + [(1.0, [0.5] * 20)]
             + [(1.0, [0.004] * 100)] * 10),
    # deadline between bucket edges, cold start (half-window rule)
    "edges": [(0.5, [0.0099, 0.0101, 0.01, 0.011])] * 40,
    "idle": [(1.0, [])] * 20,
}


def _run(name, steps, deadline_s=0.01, windows=((5.0, 14.4), (20.0, 6.0))):
    pk = slo_pkg(name)
    pk.flight.DEFAULT.clear()
    m = pk.metrics.MetricsRegistry()
    now = [1000.0]
    tr = pk.slo.SLOTracker(m, source="batch_latency_s",
                           deadline_s=deadline_s, objective=0.99,
                           windows=windows, interval_s=0.25,
                           clock=lambda: now[0])
    h = m.histogram("batch_latency_s")
    trail = []
    for dt, lats in steps:
        now[0] += dt
        for v in lats:
            h.observe(v)
        r = tr.maybe_tick()
        trail.append(None if r is None else (
            r["breached"], r["transition"], r["good"], r["total"],
            {w: round(b, 9) for w, b in r["burns"].items()}))
    snap = m.struct_snapshot()
    events = [{k: v for k, v in e.items()
               if k not in ("t", "ts", "pid", "seq")}
              for e in pk.flight.events()
              if e["kind"] in ("slo_breach", "slo_clear")]
    return (trail, tr.breached, tr.health(), snap["gauges"],
            snap["counters"], events)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_burn_rates_like_the_jax_tracker(scenario):
    got = {name: _run(name, SCENARIOS[scenario]) for name in TWINS}
    assert got["port"] == got["jax"]
    transitions = [t[1] for t in got["port"][0] if t is not None]
    if scenario == "breach_and_clear":
        assert transitions.count("breach") == 1
        assert transitions.count("clear") == 1
        assert got["port"][4]["slo_breaches"] == 1
    if scenario == "blip":
        assert "breach" not in transitions


def test_inert_without_a_deadline_like_the_jax_tracker(monkeypatch):
    monkeypatch.delenv("FJT_SLO_TARGET_MS", raising=False)
    got = {}
    for name in TWINS:
        pk = slo_pkg(name)
        m = pk.metrics.MetricsRegistry()
        tr = pk.slo.SLOTracker(m)
        got[name] = (tr.enabled, tr.maybe_tick(), tr.tick(), tr.health(),
                     tr.health_fn()(), m.struct_snapshot()["gauges"])
    assert got["port"] == got["jax"]
    assert got["port"][0] is False


@pytest.mark.parametrize("raw", [
    None, "", "60:2,600:1.5", "garbage", "10:0.5,bad,0:3,5:-1",
    "30:0.9,30:1.2",
])
def test_window_grammar_like_the_jax_one(raw, monkeypatch):
    got = {}
    for name in TWINS:
        pk = slo_pkg(name)
        if raw is None:
            monkeypatch.delenv("FJT_SLO_WINDOWS", raising=False)
        else:
            monkeypatch.setenv("FJT_SLO_WINDOWS", raw)
        got[name] = (
            pk.slo.parse_windows_env("FJT_SLO_WINDOWS", ((1.0, 1.0),)),
            pk.slo.parse_windows_env("FJT_SLO_WINDOWS", ((1.0, 1.0),),
                                     max_threshold=1.0),
            pk.slo._env_windows(),
        )
    assert got["port"] == got["jax"]


def test_env_config_like_the_jax_tracker(monkeypatch):
    monkeypatch.setenv("FJT_SLO_TARGET_MS", "25")
    monkeypatch.setenv("FJT_SLO_OBJECTIVE", "0.95")
    monkeypatch.setenv("FJT_SLO_WINDOWS", "60:2")
    got = {}
    for name in TWINS:
        pk = slo_pkg(name)
        m = pk.metrics.MetricsRegistry()
        tr = pk.slo.SLOTracker(m)
        got[name] = (tr.deadline_s, tr.objective, tr.windows,
                     m.struct_snapshot()["gauges"])
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0.025


def _dynamic(name, gbm_path):
    from flink_jpmml_tpu.models import control as jcontrol
    from flink_jpmml_tpu.runtime.sources import ControlSource as JControl
    from flink_jpmml_tpu.serving.scorer import DynamicScorer as JDynamic
    from flink_jpmml_tpu_torch.models import control as tcontrol
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    if name == "jax":
        ctrl = JControl()
        sc = JDynamic(control=ctrl, batch_size=B)
        control = jcontrol
    else:
        ctrl = ControlSource()
        sc = DynamicScorer(control=ctrl, batch_size=B, device="cpu")
        control = tcontrol
    ctrl.push(control.AddMessage("m", 1, gbm_path, time.time()))
    sc._drain_control()
    sc.registry.model(sc.registry.resolve("m", 1))
    return sc


@pytest.mark.parametrize("target", [None, "200"])
def test_dynamic_scorer_carries_the_slo_tracker_like_the_jax_one(
        target, gbm_path, monkeypatch):
    if target is None:
        monkeypatch.delenv("FJT_SLO_TARGET_MS", raising=False)
    else:
        monkeypatch.setenv("FJT_SLO_TARGET_MS", target)
    got = {}
    for name in TWINS:
        sc = _dynamic(name, gbm_path)
        assert type(sc.slo).__name__ == "SLOTracker"
        assert sc.slo._source == "score_latency_s"
        events = [("m", [0.1 * i] * 5) for i in range(B)]
        sc.finish(sc.submit(events))
        sc.slo.tick()  # the window needs two frames to evaluate
        sc.finish(sc.submit(events))
        tick = sc.slo.tick()
        gauges = sc.metrics.struct_snapshot()["gauges"]
        got[name] = (sc.slo.enabled, sc.slo.deadline_s,
                     sorted(g for g in gauges if g.startswith("slo_")),
                     None if tick is None else tick["total"])
    assert got["port"] == got["jax"]
    if target is not None:
        assert "slo_deadline_ms" in got["port"][2]
        assert "slo_ok" in got["port"][2]
