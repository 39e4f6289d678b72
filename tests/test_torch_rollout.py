"""Staged rollouts in the port (rollout/controller.py, the registry's
rollout transitions, DynamicScorer's split, shadow mirrors and guardrail
ticks) held to the JAX package on the CPU.

Every scenario of the JAX package's tests/test_rollout.py that needs no
supervisor runs here through the port's ``DynamicScorer`` on the CPU, most
of them through the JAX scorer too on the same events, and the two must
route, emit and decide alike. The guardrail controller is also held to
the JAX controller directly: the same sequence of metrics structs on the
same injected clock gives the same decisions, field for field. Constant
regression documents make the two versions' outputs tell which one
served an event (1.0 the incumbent, 2.0 the candidate).
"""

import pathlib
import time

import numpy as np
import pytest

from flink_jpmml_tpu.models import control as jcontrol
from flink_jpmml_tpu.rollout import controller as jctl
from flink_jpmml_tpu.rollout import split as jsplit
from flink_jpmml_tpu.rollout import state as jstate
from flink_jpmml_tpu.runtime.sources import ControlSource as JControl
from flink_jpmml_tpu.serving.registry import ModelRegistry as JRegistry
from flink_jpmml_tpu.serving.scorer import DynamicScorer as JScorer
from flink_jpmml_tpu.utils import metrics as jmetrics
from flink_jpmml_tpu_torch.models.control import (
    AddMessage,
    RolloutMessage,
    from_wire,
    to_wire,
)
from flink_jpmml_tpu_torch.models.core import ModelId
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.rollout import controller as tctl
from flink_jpmml_tpu_torch.rollout import split as rsplit
from flink_jpmml_tpu_torch.rollout.state import (
    GuardrailSpec,
    RolloutState,
    apply_rollout,
)
from flink_jpmml_tpu_torch.runtime.sources import ControlSource
from flink_jpmml_tpu_torch.serving.registry import ModelRegistry
from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer
from flink_jpmml_tpu_torch.utils import metrics as tmetrics

_CONST_XML = """<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3">
  <Header/>
  <DataDictionary numberOfFields="2">
    <DataField name="a" optype="continuous" dataType="double"/>
    <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <RegressionModel functionName="regression">
    <MiningSchema>
      <MiningField name="y" usageType="target"/>
      <MiningField name="a"/>
    </MiningSchema>
    <RegressionTable intercept="{c}"/>
  </RegressionModel></PMML>"""

B = 64


def _write_const(tmp_path, name, c):
    p = pathlib.Path(tmp_path, name)
    p.write_text(_CONST_XML.format(c=c))
    return str(p)


def _wait_warm(reg, mid, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if reg.model_if_warm(mid) is not None:
            return
        err = reg.warm_error(mid)
        assert err is None, f"warm of {mid} failed: {err!r}"
        time.sleep(0.01)
    raise AssertionError(f"{mid} never warmed")


def _values(results):
    return [p.score.value if not p.is_empty else None for p, _ in results]


def _events(name, n, start=0):
    return [(name, {"a": 0.0, "_key": f"k{start + i}"}) for i in range(n)]


def _run(sc, events, batch=B):
    out = []
    for off in range(0, len(events), batch):
        out += sc.finish(sc.submit(events[off: off + batch]))
    return out


def _counters(sc):
    return sc.metrics.struct_snapshot()["counters"]


class _Twins:
    """The port's and the JAX package's dynamic scorers, each serving
    ``m`` v1 from the same document and fed the same control messages."""

    def __init__(self, v1, **kw):
        self.ctrl = ControlSource()
        self.jctrl = JControl()
        self.sc = DynamicScorer(control=self.ctrl, batch_size=B,
                                auto_rollout=False, device="cpu", **kw)
        self.jsc = JScorer(control=self.jctrl, batch_size=B,
                           auto_rollout=False, **kw)
        self.push(AddMessage("m", 1, v1, timestamp=1.0))
        self.run(_events("m", 1))

    def push(self, msg):
        self.ctrl.push(msg)
        self.jctrl.push(jcontrol.from_wire(to_wire(msg)))
        self.sc._drain_control()
        self.jsc._drain_control()

    def wait(self, version):
        _wait_warm(self.sc.registry, ModelId("m", version))
        _wait_warm(self.jsc.registry, jcontrol.ModelId("m", version))

    def run(self, events):
        return _values(_run(self.sc, events)), _values(_run(self.jsc, events))


# -- the split, the transitions and the window helpers -------------------------


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.5])
@pytest.mark.parametrize("version", [2, 3])
def test_split_equals_the_jax_one(version, fraction):
    keys = [f"u{i}" for i in range(4000)]
    a = [rsplit.assign_candidate("m", version, fraction, k) for k in keys]
    assert a == [jsplit.assign_candidate("m", version, fraction, k)
                 for k in keys]
    assert abs(sum(a) / len(a) - fraction) < 0.02
    wider = [rsplit.assign_candidate("m", version, 0.6, k) for k in keys]
    assert all(w or not s for s, w in zip(a, wider))  # never reassigned back
    assert [rsplit.sample_shadow("m", version, fraction, k) for k in keys] \
        == [jsplit.sample_shadow("m", version, fraction, k) for k in keys]
    recs = [{"a": float(i), "b": "x"} for i in range(50)]
    assert [rsplit.record_key(r) for r in recs] == [
        jsplit.record_key(r) for r in recs]
    assert rsplit.record_key({"_key": "s1", "a": 1.0}) == "s1"


TRANSITIONS = [
    [RolloutMessage("m", 2, "shadow", 10.0),
     RolloutMessage("m", 2, "shadow", 50.0, fraction=0.5),
     RolloutMessage("m", 2, "canary", 99.0)],
    [RolloutMessage("m", 3, "canary", 1.0),
     RolloutMessage("m", 2, "rollback", 2.0),
     RolloutMessage("m", 3, "full", 3.0)],
    [RolloutMessage("m", 2, "canary", 1.0, fraction=0.3,
                    guardrails=GuardrailSpec(max_disagree_rate=0.1)),
     RolloutMessage("n", 5, "shadow", 2.0),
     RolloutMessage("m", 2, "rollback", 3.0)],
]


@pytest.mark.parametrize("case", range(len(TRANSITIONS)))
def test_transitions_equal_the_jax_ones(case):
    states, jstates = {}, {}
    for msg in TRANSITIONS[case]:
        assert from_wire(to_wire(msg)) == msg
        states, ch = apply_rollout(states, msg)
        jstates, jch = jstate.apply_rollout(
            jstates, jcontrol.from_wire(to_wire(msg)))
        assert ch == jch
        assert {k: v.as_dict() for k, v in states.items()} == {
            k: v.as_dict() for k, v in jstates.items()}
    if case == 0:  # a knob turn keeps the dwell, a stage change resets it
        assert states["m"].stage_since == 99.0
    with pytest.raises(ValueError):
        RolloutState("m", 2, "full", 1.0)  # terminal is not storable


def test_windows_equal_the_jax_ones():
    out = []
    for m, ctl in ((tmetrics, tctl), (jmetrics, jctl)):
        h, s = m.Histogram(), m.QuantileSketch()
        for v in (0.001,) * 50:
            h.observe(v)
        s.observe_many(np.full(50, 1.0))
        old = {"histograms": {"x": h.state()}, "sketches": {"y": s.state()}}
        for v in (0.1,) * 50:
            h.observe(v)
        s.observe_many(np.full(70, 3.0))
        new = {"histograms": {"x": h.state()}, "sketches": {"y": s.state()}}
        win = ctl._hist_window(new, old, "x")
        back = ctl._hist_window(old, new, "x")  # a restart: cumulative
        sw = ctl._sketch_window(new, old, "y")
        out.append((win.state(), back.count(), sw.state()))
    assert out[0] == out[1]
    assert out[0][0]["n"] == 50 and out[0][1] == 50 and out[0][2]["n"] == 70


# -- the controller on the same structs and clock as the JAX one ---------------


def _struct(m, *, compared=0, disagree=0, cand=0, inc=0, errors=0,
            cand_lat=(), inc_lat=(), cand_scores=(), inc_scores=()):
    """A cumulative metrics struct of one rollout ``m``, built with the
    package ``m``'s own metric classes."""
    reg = m.MetricsRegistry()
    for name, v in (("rollout_shadow_compared", compared),
                    ("rollout_shadow_disagree", disagree),
                    ("rollout_candidate_records", cand),
                    ("rollout_incumbent_records", inc),
                    ("rollout_candidate_errors", errors)):
        if v:
            reg.counter(f'{name}{{model="m"}}').inc(v)
    for role, lats in (("candidate", cand_lat), ("incumbent", inc_lat)):
        for v in lats:
            reg.histogram(f'rollout_{role}_latency_s{{model="m"}}').observe(v)
    for role, vals in (("candidate", cand_scores), ("incumbent", inc_scores)):
        if len(vals):
            reg.sketch(f'rollout_score_dist{{model="m",role="{role}"}}'
                       ).observe_many(np.asarray(vals, np.float64))
    return reg.struct_snapshot()


_RNG = np.random.default_rng(16)
_INC = _RNG.normal(0, 1, 2000)
_SHIFTED = np.concatenate([_RNG.normal(0, 1, 2000), _RNG.normal(5, 1, 2000)])
_MODERATE = np.concatenate([_RNG.normal(0, 1, 2000),
                            _RNG.normal(2, 1, 2000)])
_INC2 = np.concatenate([_INC, _RNG.normal(0, 1, 2000)])

# (stage, spec, [(time, struct kwargs)]): one tick per step
CONTROLLER_CASES = {
    "disagreement_rollback": ("canary", GuardrailSpec(
        min_samples=50, promote_after_s=3600.0), [
        (1.0, dict(compared=100, disagree=0, cand=30)),
        (2.0, dict(compared=400, disagree=40, cand=90))]),
    "error_rollback": ("canary", GuardrailSpec(min_samples=50), [
        (1.0, dict(cand=100, errors=3))]),
    "latency_rollback": ("canary", GuardrailSpec(
        min_samples=8, promote_after_s=3600.0, max_disagree_rate=1.0), [
        (1.0, dict(cand=80, cand_lat=[0.05] * 10, inc_lat=[0.001] * 10))]),
    "healthy_promotes": ("shadow", GuardrailSpec(
        min_samples=50, promote_after_s=0.0, max_latency_ratio=1000.0), [
        (1.0, dict(compared=512, cand_lat=[0.002] * 8,
                   inc_lat=[0.002] * 8))]),
    "dwell_not_met": ("canary", GuardrailSpec(
        min_samples=50, promote_after_s=30.0), [
        (1.0, dict(cand=100)), (20.0, dict(cand=200)),
        (31.0, dict(cand=300))]),
    "sample_floor": ("canary", GuardrailSpec(min_samples=500), [
        (1.0, dict(cand=100, errors=5))]),
    "prediction_psi_rollback": ("canary", GuardrailSpec(
        max_prediction_psi=0.25, min_samples=100, promote_after_s=1e9), [
        (0.0, dict(cand=2000, cand_scores=_RNG.normal(0, 1, 2000),
                   inc_scores=_INC)),
        (1.0, dict(cand=4000, cand_scores=_SHIFTED, inc_scores=_INC2))]),
    "prediction_psi_hold": ("canary", GuardrailSpec(
        max_prediction_psi=50.0, hold_prediction_psi=0.05, min_samples=100,
        promote_after_s=0.0, window_s=0.9), [
        (1.0, dict(cand=4000, cand_scores=_MODERATE, inc_scores=_INC2))]),
}


class _Book:
    def __init__(self, state_cls, stage, spec):
        self._st = state_cls(name="m", candidate_version=2, stage=stage,
                             fraction=0.2, spec=spec, stage_since=0.0)
        self.applied = []

    def rollouts(self):
        return {"m": self._st} if not self.applied else {}

    def apply(self, msg):
        self.applied.append(msg)
        return True


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_decisions_equal_the_jax_ones(case):
    stage, spec, steps = CONTROLLER_CASES[case]
    jspec = jstate.GuardrailSpec.from_dict(spec.as_dict())
    runs = []
    for m, ctl, st_cls, sp in ((tmetrics, tctl, RolloutState, spec),
                               (jmetrics, jctl, jstate.RolloutState, jspec)):
        t, cur = [0.0], [None]
        book = _Book(st_cls, stage, sp)
        c = ctl.RolloutController(book=book, struct_fn=lambda: cur[0],
                                  metrics=m.MetricsRegistry(),
                                  interval_s=0.0, clock=lambda: t[0])
        trail = []
        for when, kw in steps:
            t[0], cur[0] = when, _struct(m, **kw)
            trail.append(c.tick())
        runs.append((trail, [(x.stage, x.version, x.timestamp)
                             for x in book.applied]))
    assert runs[0] == runs[1]
    fired = [d for step in runs[0][0] for d in step]
    actions = [(d["action"], d["stage"]) for d in fired]
    expected = {
        "disagreement_rollback": [("rollback", "rollback")],
        "error_rollback": [("rollback", "rollback")],
        "latency_rollback": [("rollback", "rollback")],
        "healthy_promotes": [("promote", "canary")],
        "dwell_not_met": [("promote", "full")],
        "sample_floor": [],
        "prediction_psi_rollback": [("rollback", "rollback")],
        "prediction_psi_hold": [],
    }[case]
    assert actions == expected
    if case == "dwell_not_met":
        assert len(runs[0][0][0]) == len(runs[0][0][1]) == 0


def test_rollout_book_forwards_and_tracks():
    sent = []
    book = tctl.RolloutBook(sent.append)
    msg = RolloutMessage("m", 2, "canary", 1.0)
    assert book.apply(msg)
    assert book.rollouts()["m"].stage == "canary"
    assert book.apply(RolloutMessage("m", 2, "rollback", 2.0))
    assert book.rollouts() == {} and len(sent) == 2
    assert sent[0] is msg and sent[1].stage == "rollback"


def test_fleet_controller_thread_forwards_a_decision():
    sent = []
    book = tctl.RolloutBook(sent.append)
    book.apply(RolloutMessage("m", 2, "canary", 0.0, guardrails=GuardrailSpec(
        min_samples=10, promote_after_s=3600.0)))
    ctl = tctl.RolloutController(
        book=book, struct_fn=lambda: _struct(tmetrics, cand=50, errors=5),
        interval_s=0.01)
    ctl.start()
    try:
        deadline = time.monotonic() + 10.0
        while len(sent) < 2:
            assert time.monotonic() < deadline, "no decision forwarded"
            time.sleep(0.01)
    finally:
        ctl.close()
    assert sent[-1].stage == "rollback" and book.rollouts() == {}


# -- canary serving through both scorers -----------------------------------------


def test_split_serves_the_fraction_like_the_jax_scorer(tmp_path):
    tw = _Twins(_write_const(tmp_path, "v1.pmml", 1.0))
    tw.push(RolloutMessage("m", 2, "canary", time.time(),
                           path=_write_const(tmp_path, "v2.pmml", 2.0),
                           fraction=0.25))
    tw.wait(2)
    events = _events("m", 1024)
    vals, jvals = tw.run(events)
    assert vals == jvals
    share = sum(1 for v in vals if v == 2.0) / len(vals)
    assert abs(share - 0.25) < 0.05
    assert tw.run(events)[0] == vals  # per-key stable on replay
    for (_, rec), v in zip(events, vals):
        assert v == (2.0 if rsplit.assign_candidate(
            "m", 2, 0.25, rec["_key"]) else 1.0)
    c = _counters(tw.sc)
    assert c['rollout_candidate_records{model="m"}'] == 2 * sum(
        1 for v in vals if v == 2.0)
    # each canary batch mirrored its incumbent events to the candidate
    assert c['rollout_shadow_compared{model="m"}'] == 2 * sum(
        1 for v in vals if v == 1.0)


def test_shadow_stage_serves_the_incumbent_only_no_sink_leakage(tmp_path):
    tw = _Twins(_write_const(tmp_path, "v1.pmml", 1.0))
    tw.push(RolloutMessage("m", 2, "shadow", time.time(),
                           path=_write_const(tmp_path, "v2.pmml", 2.0)))
    tw.wait(2)
    vals, jvals = tw.run(_events("m", 512))
    assert vals == jvals and len(vals) == 512 and set(vals) == {1.0}
    for sc in (tw.sc, tw.jsc):
        c = _counters(sc)
        assert c.get('rollout_candidate_records{model="m"}', 0) == 0
        assert c['rollout_shadow_compared{model="m"}'] == 512
        assert c['rollout_shadow_disagree{model="m"}'] == 512
    h = tw.sc.metrics.struct_snapshot()["histograms"]
    assert h['rollout_candidate_latency_s{model="m"}']["n"] == 512 // B
    assert h['rollout_shadow_drift{model="m"}']["n"] >= 512


def test_cold_candidate_slice_stays_on_the_incumbent(tmp_path):
    ctrl = ControlSource()
    sc = DynamicScorer(control=ctrl, batch_size=B, auto_rollout=False,
                       device="cpu")
    orig_load = sc.registry._load

    def stall_v2(info):
        if "v2" in info.path:
            time.sleep(1.5)
        return orig_load(info)

    sc.registry._load = stall_v2
    ctrl.push(AddMessage("m", 1, _write_const(tmp_path, "v1.pmml", 1.0),
                         timestamp=1.0))
    _run(sc, _events("m", 1))
    ctrl.push(RolloutMessage("m", 2, "canary", time.time(),
                             path=_write_const(tmp_path, "v2.pmml", 2.0),
                             fraction=0.5))
    sc._drain_control()
    t0 = time.monotonic()
    out = _run(sc, _events("m", 128))
    dt = time.monotonic() - t0
    assert set(_values(out)) == {1.0}
    assert dt < 1.0, f"canary batch stalled {dt:.2f}s on a cold candidate"
    _wait_warm(sc.registry, ModelId("m", 2))


# -- guardrails end to end -----------------------------------------------------


def _decisions_alike(d, jd):
    keys = ("name", "version", "action", "from_stage", "stage", "compared",
            "disagree", "candidate_records", "errors")
    assert [{k: x.get(k) for k in keys} for x in d] == [
        {k: x.get(k) for k in keys} for x in jd]


def test_disagreeing_candidate_rolled_back_under_canary(tmp_path):
    spec = GuardrailSpec(min_samples=50, window_s=30.0,
                         promote_after_s=3600.0, max_disagree_rate=0.02)
    tw = _Twins(_write_const(tmp_path, "v1.pmml", 1.0))
    tw.push(RolloutMessage("m", 2, "canary", time.time(),
                           path=_write_const(tmp_path, "v2.pmml", 2.0),
                           fraction=0.25, guardrails=spec))
    tw.wait(2)
    vals, jvals = tw.run(_events("m", 512))
    assert vals == jvals
    now = time.time()
    d = tw.sc.rollout_controller.tick(now)
    jd = tw.jsc.rollout_controller.tick(now)
    _decisions_alike(d, jd)
    assert len(d) == 1 and d[0]["action"] == "rollback"
    assert "disagreement" in d[0]["reason"]
    reg = tw.sc.registry
    assert reg.rollout("m") is None
    assert reg.resolve("m") == ModelId("m", 1) and reg.resolve("m", 2) is None
    assert set(tw.run(_events("m", 64))[0]) == {1.0}
    evs = [e for e in flight.events() if e["kind"] == "rollout_rollback"
           and e.get("name") == "m"]
    assert evs and "disagreement" in evs[-1]["reason"]
    assert _counters(tw.sc)['rollout_rollbacks{model="m"}'] == 1


class _SlowModel:
    """A compiled model whose dispatches take ``delay`` seconds longer: on
    the CPU a dispatch completes inside its launch, so the sleep sits in
    ``predict``, inside the bracket both roles' latency is taken over —
    where a slow device puts it."""

    def __init__(self, inner, delay):
        self._inner = inner
        self._delay = delay

    def quantized_scorer(self):
        return None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def predict(self, X, M):
        time.sleep(self._delay)
        return self._inner.predict(X, M)


def test_slow_candidate_rolled_back_on_latency(tmp_path):
    spec = GuardrailSpec(min_samples=8, window_s=60.0, promote_after_s=3600.0,
                         max_latency_ratio=2.0, max_disagree_rate=1.0)
    ctrl = ControlSource()
    sc = DynamicScorer(control=ctrl, batch_size=B, auto_rollout=False,
                       device="cpu")
    orig = sc.registry._load
    sc.registry._load = lambda info: (
        _SlowModel(orig(info), 0.05) if "v2slow" in info.path
        else orig(info))
    ctrl.push(AddMessage("m", 1, _write_const(tmp_path, "v1.pmml", 1.0),
                         timestamp=1.0))
    _run(sc, _events("m", 1))
    ctrl.push(RolloutMessage("m", 2, "canary", time.time(),
                             path=_write_const(tmp_path, "v2slow.pmml", 1.0),
                             fraction=0.25, guardrails=spec))
    sc._drain_control()
    _wait_warm(sc.registry, ModelId("m", 2))
    # an incumbent key first in every batch: the incumbent group launches
    # (and completes, FIFO) ahead of the slow candidate
    events = _events("m", 10 * B)
    for off in range(0, len(events), B):
        chunk = events[off: off + B]
        for j, (_nm, rec) in enumerate(chunk):
            if not rsplit.assign_candidate("m", 2, 0.25, rec["_key"]):
                chunk[0], chunk[j] = chunk[j], chunk[0]
                break
        events[off: off + B] = chunk
    _run(sc, events)
    d = sc.rollout_controller.tick()
    assert len(d) == 1 and d[0]["action"] == "rollback"
    assert "p99" in d[0]["reason"]
    assert sc.registry.rollout("m") is None
    assert sc.registry.resolve("m") == ModelId("m", 1)


def test_healthy_candidate_promotes_shadow_to_canary_to_full(tmp_path):
    spec = GuardrailSpec(min_samples=50, window_s=60.0, promote_after_s=0.0,
                         canary_fraction=0.25, max_latency_ratio=1000.0)
    tw = _Twins(_write_const(tmp_path, "v1.pmml", 1.0))
    tw.push(RolloutMessage("m", 2, "shadow", time.time(),
                           path=_write_const(tmp_path, "v2.pmml", 1.0),
                           guardrails=spec))
    tw.wait(2)
    events = _events("m", 512)
    tw.run(events)
    now = time.time()
    d1 = tw.sc.rollout_controller.tick(now)
    _decisions_alike(d1, tw.jsc.rollout_controller.tick(now))
    assert [d["stage"] for d in d1] == ["canary"]
    st = tw.sc.registry.rollout("m")
    assert st.stage == "canary" and st.fraction == 0.25
    vals, jvals = tw.run(events)
    assert vals == jvals == tw.run(events)[0]
    assert _counters(tw.sc)['rollout_candidate_records{model="m"}'] > 0
    now = time.time()
    d2 = tw.sc.rollout_controller.tick(now)
    _decisions_alike(d2, tw.jsc.rollout_controller.tick(now))
    assert [d["stage"] for d in d2] == ["full"]
    assert tw.sc.registry.rollout("m") is None
    assert tw.sc.registry.resolve("m") == ModelId("m", 2)
    assert _counters(tw.sc)['rollout_promotions{model="m"}'] == 2


def test_auto_rollout_ticks_from_the_batch_loop(tmp_path):
    spec = GuardrailSpec(min_samples=50, window_s=60.0, promote_after_s=0.0,
                         max_latency_ratio=1000.0)
    ctrl = ControlSource()
    sc = DynamicScorer(control=ctrl, batch_size=B, rollout_interval_s=0.0,
                       guardrails=spec, device="cpu")
    ctrl.push(AddMessage("m", 1, _write_const(tmp_path, "v1.pmml", 1.0),
                         timestamp=1.0))
    _run(sc, _events("m", 1))
    ctrl.push(RolloutMessage("m", 2, "shadow", time.time(),
                             path=_write_const(tmp_path, "v2.pmml", 1.0)))
    sc._drain_control()
    _wait_warm(sc.registry, ModelId("m", 2))
    assert sc.registry.rollout("m").spec == spec  # the default, stamped
    for _ in range(6):
        _run(sc, _events("m", 256))
        if sc.registry.rollout("m") is None:
            break
    assert sc.registry.rollout("m") is None
    assert sc.registry.resolve("m") == ModelId("m", 2)


# -- the review regressions ----------------------------------------------------


def test_superseding_rollout_drops_the_abandoned_candidate():
    for reg, msgs in ((ModelRegistry(async_warmup=False, device="cpu"),
                       lambda m: m),
                      (JRegistry(async_warmup=False),
                       lambda m: jcontrol.from_wire(to_wire(m)))):
        reg.apply(msgs(AddMessage("m", 1, "/tmp/v1.pmml", 1.0)))
        reg.apply(msgs(RolloutMessage("m", 2, "canary", 2.0,
                                      path="/tmp/v2.pmml", fraction=0.2)))
        reg.apply(msgs(RolloutMessage("m", 3, "shadow", 3.0,
                                      path="/tmp/v3.pmml")))
        st = reg.rollout("m")
        assert st is not None and st.candidate_version == 3
        assert reg.resolve("m", 2) is None
        assert reg.resolve("m").version == 1
        assert not reg.apply(msgs(RolloutMessage("m", 2, "rollback", 4.0)))
        assert reg.rollout("m").candidate_version == 3
        assert reg.state()["rollouts"]["m"]["stage"] == "shadow"


def test_a_del_prunes_the_rollout(tmp_path):
    from flink_jpmml_tpu_torch.models.control import DelMessage

    reg = ModelRegistry(async_warmup=False, device="cpu")
    reg.apply(AddMessage("m", 1, "/tmp/v1.pmml", 1.0))
    reg.apply(RolloutMessage("m", 2, "canary", 2.0, path="/tmp/v2.pmml"))
    reg.apply(DelMessage("m", 1, 3.0))  # the incumbent goes: no rollout
    assert reg.rollout("m") is None and reg.resolve("m").version == 2


class _Poisoned(_SlowModel):
    def decode(self, out, n):
        raise RuntimeError("injected candidate poison")


def test_failed_candidate_counts_errors_not_records(tmp_path):
    ctrl = ControlSource()
    sc = DynamicScorer(control=ctrl, batch_size=B, auto_rollout=False,
                       device="cpu")
    orig = sc.registry._load
    sc.registry._load = lambda info: (
        _Poisoned(orig(info), 0.0) if "v2" in info.path else orig(info))
    ctrl.push(AddMessage("m", 1, _write_const(tmp_path, "v1.pmml", 1.0),
                         timestamp=1.0))
    _run(sc, _events("m", 1))
    ctrl.push(RolloutMessage("m", 2, "canary", time.time(),
                             path=_write_const(tmp_path, "v2.pmml", 2.0),
                             fraction=0.5))
    sc._drain_control()
    _wait_warm(sc.registry, ModelId("m", 2))
    vals = _values(_run(sc, _events("m", 128)))
    assert None in vals and 1.0 in vals and 2.0 not in vals
    snap = sc.metrics.struct_snapshot()
    c = snap["counters"]
    # canary lanes and the shadow mirrors both failed
    assert c['rollout_candidate_errors{model="m"}'] == 128
    assert c.get('rollout_candidate_records{model="m"}', 0) == 0
    assert 'rollout_candidate_latency_s{model="m"}' not in snap["histograms"]


def test_keyed_control_delivers_every_names_decision():
    from flink_jpmml_tpu_torch.parallel.health import (
        HealthCoordinator,
        HealthReporter,
    )

    applied = []
    coord = HealthCoordinator(timeout_s=5.0)
    coord.set_control({"rollout": to_wire(
        RolloutMessage("a", 2, "rollback", 1.0))}, key="rollout:a")
    coord.set_control({"rollout": to_wire(
        RolloutMessage("b", 5, "full", 2.0))}, key="rollout:b")
    rep = HealthReporter(coord.host, coord.port, "w0", interval_s=0.05,
                         on_control=applied.append)
    try:
        deadline = time.monotonic() + 10.0
        while len(applied) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sorted(d["rollout"]["name"] for d in applied) == ["a", "b"]
        reg = ModelRegistry(async_warmup=False, device="cpu")
        reg.apply(AddMessage("a", 1, "/tmp/a1.pmml", 1.0))
        reg.apply(RolloutMessage("a", 2, "canary", 1.0, path="/tmp/a2.pmml"))
        for d in applied:  # what a worker's control hook applies
            reg.apply(from_wire(d["rollout"]))
        assert reg.rollout("a") is None and reg.resolve("a", 2) is None
    finally:
        rep.stop()
        coord.close()


# -- checkpoint durability -------------------------------------------------------


def test_restore_mid_canary_resumes_stage_and_split(tmp_path):
    tw = _Twins(_write_const(tmp_path, "v1.pmml", 1.0))
    spec = GuardrailSpec(promote_after_s=123.0)
    tw.push(RolloutMessage("m", 2, "canary", 777.0,
                           path=_write_const(tmp_path, "v2.pmml", 2.0),
                           fraction=0.25, guardrails=spec))
    tw.wait(2)
    events = _events("m", 512)
    vals = tw.run(events)[0]
    state = tw.sc.state()
    assert state == tw.jsc.state()  # the same checkpoint document
    sc2 = DynamicScorer(control=ControlSource(), batch_size=B,
                        auto_rollout=False, device="cpu")
    sc2.restore(state)
    st = sc2.registry.rollout("m")
    assert st.stage == "canary" and st.fraction == 0.25
    assert st.stage_since == 777.0 and st.spec.promote_after_s == 123.0
    _wait_warm(sc2.registry, ModelId("m", 1))
    _wait_warm(sc2.registry, ModelId("m", 2))
    assert _values(_run(sc2, events)) == vals


def test_restore_while_warm_in_flight_no_double_compile(tmp_path):
    v1 = _write_const(tmp_path, "v1.pmml", 1.0)
    reg = ModelRegistry(batch_size=8, device="cpu")
    loads = {}
    orig = reg._load

    def slow_load(info):
        loads[info.path] = loads.get(info.path, 0) + 1
        time.sleep(0.5)
        return orig(info)

    reg._load = slow_load
    mid = ModelId("m", 1)
    reg.apply(AddMessage("m", 1, v1, timestamp=1.0))
    reg.apply(RolloutMessage("m", 2, "shadow", 2.0, path=v1 + ".v2"))
    assert reg.is_warming(mid)
    reg.restore(reg.state())  # warm still mid-compile
    model = reg.model(mid)
    assert model is not None and loads[v1] == 1, loads
    assert reg.model_if_warm(mid) is model
    assert reg.rollout("m").stage == "shadow"


def test_restore_with_changed_path_rewarms(tmp_path):
    v1 = _write_const(tmp_path, "v1.pmml", 1.0)
    v2 = _write_const(tmp_path, "v2.pmml", 2.0)
    v2b = _write_const(tmp_path, "v2b.pmml", 3.0)
    reg = ModelRegistry(batch_size=8, async_warmup=False, device="cpu")
    reg.apply(AddMessage("m", 1, v1, timestamp=1.0))
    reg.apply(RolloutMessage("m", 2, "canary", 2.0, path=v2))
    assert reg.model(ModelId("m", 2)).score_records([{"a": 0.0}])[
        0].score.value == 2.0
    state = reg.state()
    state["served"]["m_2"] = v2b  # a different document for the candidate
    reg.restore(state)
    assert reg.rollout("m").candidate_version == 2
    assert reg.model(ModelId("m", 2)).score_records([{"a": 0.0}])[
        0].score.value == 3.0


def test_scorer_sketches_both_roles_score_distributions(tmp_path):
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.obs import drift

    pmml = gen_gbm(str(tmp_path), n_trees=10, depth=3, n_features=6)
    # a byte-identical copy at another path: the candidate
    v2 = str(tmp_path / "v2.pmml")
    pathlib.Path(v2).write_bytes(pathlib.Path(pmml).read_bytes())
    ctrl = ControlSource()
    sc = DynamicScorer(control=ctrl, batch_size=B, auto_rollout=False,
                       device="cpu")
    drift.install(sc.metrics, interval_s=0.0, budget_frac=0)
    ctrl.push(AddMessage("m", 1, pmml, timestamp=time.time()))
    sc._drain_control()
    _wait_warm(sc.registry, ModelId("m", 1))
    ctrl.push(RolloutMessage("m", 2, "shadow", time.time(), path=v2))
    sc._drain_control()
    _wait_warm(sc.registry, ModelId("m", 2))
    rng = np.random.default_rng(18)
    fields = [f"f{j}" for j in range(6)]
    for _ in range(4):
        sc.finish(sc.submit([("m", dict(zip(fields, rng.normal(
            0, 1, 6).tolist()))) for _ in range(B)]))
    sk = sc.metrics.sketches()
    cand = sk['rollout_score_dist{model="m",role="candidate"}']
    inc = sk['rollout_score_dist{model="m",role="incumbent"}']
    assert inc.count() == cand.count() == 4 * B
    assert drift.psi(inc, cand) < 0.1
    c = _counters(sc)
    assert c['rollout_shadow_compared{model="m"}'] == 4 * B
    assert c.get('rollout_shadow_disagree{model="m"}', 0) == 0
    # the drift plane sketched the served document's predictions
    q = sc.registry.model(ModelId("m", 1)).quantized_scorer()
    assert sk[f'prediction_values{{model="{q.model_hash}"}}'].count() > 0


def test_zoo_tenant_canary_and_per_document_sketches(tmp_path):
    """Under the zoo, one tenant's canary splits its keys (its groups
    launch solo, as the JAX scorer's rollout groups do: their per-role
    accounting is the controller's signal) while the other tenants keep
    riding the pack; every emission equals the zoo-off scorer's, and the
    drift plane sketches each served document under its own hash."""
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.obs import drift

    docs = [gen_gbm(str(tmp_path), n_trees=10, depth=3, n_features=4,
                    seed=100 + i, name=f"z{i}.pmml") for i in range(3)]
    cand = str(tmp_path / "z0_v2.pmml")
    pathlib.Path(cand).write_bytes(pathlib.Path(docs[0]).read_bytes())
    names = [f"t{i}" for i in range(6)]
    rng = np.random.default_rng(21)
    events = [(n, dict(zip([f"f{j}" for j in range(4)],
                           rng.normal(0, 1.5, 4).tolist()), _key=f"k{i}"))
              for i in range(B) for n in names]
    out = {}
    for zoo in (True, False):
        ctrl = ControlSource()
        sc = DynamicScorer(control=ctrl, batch_size=B, zoo=zoo,
                           auto_rollout=False, device="cpu")
        for i, n in enumerate(names):
            ctrl.push(AddMessage(n, 1, docs[i % 3], timestamp=1.0))
        sc._drain_control()
        for n in names:
            _wait_warm(sc.registry, ModelId(n, 1))
        ctrl.push(RolloutMessage("t0", 2, "canary", time.time(), path=cand,
                                 fraction=0.3))
        sc._drain_control()
        _wait_warm(sc.registry, ModelId("t0", 2))
        drift.install(sc.metrics, interval_s=0.0, budget_frac=0)
        out[zoo] = _values(_run(sc, events, batch=len(names) * B // 4))
        c = _counters(sc)
        assert c['rollout_candidate_records{model="t0"}'] == sum(
            rsplit.assign_candidate("t0", 2, 0.3, f"k{i}") for i in range(B))
        if zoo:
            assert c["pack_dispatches"] > 0
            sk = sc.metrics.struct_snapshot()["sketches"]
            labels = {m.group(1) for m in (drift._PRED_SKETCH.match(k)
                                           for k in sk) if m}
            assert len(labels) == 3  # one a served document
    assert out[True] == out[False] and None not in out[True]


def test_block_path_adopts_a_candidate_only_at_full(tmp_path):
    """``DynamicBlockPipeline`` serves whole batches to one model, so an
    active rollout's candidate is never adopted there before it is
    promoted to full (the JAX pipeline's rule)."""
    from flink_jpmml_tpu_torch.runtime.block import FiniteBlockSource
    from flink_jpmml_tpu_torch.serving.block import DynamicBlockPipeline

    ctrl = ControlSource()
    pipe = DynamicBlockPipeline(
        FiniteBlockSource(np.zeros((B, 1), np.float32), B), ctrl,
        lambda *a: None, "m", 1, B, device="cpu")
    ctrl.push(AddMessage("m", 1, _write_const(tmp_path, "v1.pmml", 1.0),
                         timestamp=1.0))
    ctrl.push(RolloutMessage("m", 2, "canary", 2.0, fraction=0.5,
                             path=_write_const(tmp_path, "v2.pmml", 2.0)))
    pipe._poll_control()
    for v in (1, 2):
        _wait_warm(pipe.registry, ModelId("m", v))
    pipe._poll_control()
    assert pipe.serving_key == ModelId("m", 1).key()
    ctrl.push(RolloutMessage("m", 2, "full", 3.0))
    pipe._poll_control()
    assert pipe.serving_key == ModelId("m", 2).key()
