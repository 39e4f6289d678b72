"""Dynamic serving of the port on the CPU against the JAX package's: the
managers, the registry (warm pool, latest-wins routing, state round
trip), and ``DynamicScorer``, the event ⋈ control join, alone and under
``StreamEnvironment.with_control_stream``.

Both packages get the same control messages and the same seed-made events
(a GBM and a 2-class vote forest of 21 trees, so no record's vote can
tie; a logistic regression as the default model), and their outputs are
compared batch by batch, in order: values at rtol 1e-4 / atol 1e-5,
labels and empty lanes exactly. Each side waits for its warms before a
batch whose routing depends on them, so both route alike."""

import threading
import time

import numpy as np
import pytest

from flink_jpmml_tpu.api import ModelReader as JReader
from flink_jpmml_tpu.api import StreamEnvironment as JEnv
from flink_jpmml_tpu.models import control as jcontrol
from flink_jpmml_tpu.models.core import ModelId as JModelId
from flink_jpmml_tpu.runtime.sources import ControlSource as JControl
from flink_jpmml_tpu.serving import managers as jmanagers
from flink_jpmml_tpu.serving.scorer import DynamicScorer as JDynamic
from flink_jpmml_tpu.utils.config import BatchConfig as JBatch
from flink_jpmml_tpu.utils.config import RuntimeConfig as JConfig
from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_iris_lr, gen_vote_forest
from flink_jpmml_tpu_torch.compile import qtrees_cuda
from flink_jpmml_tpu_torch.models import control as tcontrol
from flink_jpmml_tpu_torch.models.core import ModelId
from flink_jpmml_tpu_torch.runtime.sources import ControlSource
from flink_jpmml_tpu_torch.serving import managers as tmanagers
from flink_jpmml_tpu_torch.serving.registry import ModelRegistry
from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer, default_route
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
from test_torch_stream import assert_same, vectors

B = 32


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serving"))
    return {
        "iris": gen_iris_lr(d),
        "iris2": gen_iris_lr(str(tmp_path_factory.mktemp("iris2")), seed=99),
        "gbm": gen_gbm(d, n_trees=20, depth=4, n_features=6),
        "gbm2": gen_gbm(d, n_trees=20, depth=4, n_features=6, seed=12,
                        name="gbm_v2.pmml"),
        "votes": gen_vote_forest(d, n_trees=21, depth=4, n_features=6,
                                 n_classes=2),
    }


class Twins:
    """One JAX and one port ``DynamicScorer`` fed the same control
    messages and batches."""

    def __init__(self, **kw):
        self.jctrl, self.tctrl = JControl(), ControlSource()
        self.j = JDynamic(control=self.jctrl, batch_size=B, **kw)
        self.t = DynamicScorer(control=self.tctrl, batch_size=B,
                               device="cpu", **kw)

    def push(self, kind, *args):
        self.jctrl.push(getattr(jcontrol, kind)(*args))
        self.tctrl.push(getattr(tcontrol, kind)(*args))

    def warm(self, name, version):
        """Drain the control stream into both registries and join both
        warms of (name, version)."""
        self.j._drain_control()
        self.t._drain_control()
        assert self.j.registry.model(JModelId(name, version)) is not None
        assert self.t.registry.model(ModelId(name, version)) is not None

    def score(self, events):
        """→ (JAX pairs, port pairs), each (prediction, event) in order."""
        ref = self.j.finish(self.j.submit(events))
        got = self.t.finish(self.t.submit(events))
        assert [e for _, e in got] == events
        assert_same([p for p, _ in got], [p for p, _ in ref])
        return ref, got


def mixed_events(seed, n=120, names=("gbm", "votes", "ghost")):
    X = vectors(n, 6, seed=seed)
    rng = np.random.default_rng(seed + 100)
    return [(names[i], list(map(float, x)))
            for i, x in zip(rng.integers(len(names), size=n), X)]


# -- managers (tests/test_runtime.py TestManagers) --------------------------

MANAGERS = [pytest.param((jmanagers, jcontrol), id="jax"),
            pytest.param((tmanagers, tcontrol), id="port")]


@pytest.mark.parametrize("twin", MANAGERS)
def test_add_idempotent_del_unknown_noop(twin):
    managers, control = twin
    meta, ch = managers.apply_message({}, control.AddMessage("m", 1, "/p", 1.0))
    assert ch and len(meta) == 1
    meta2, ch2 = managers.apply_message(
        meta, control.AddMessage("m", 1, "/q", 2.0))
    assert not ch2 and meta2 == meta  # versions are immutable
    _, ch3 = managers.apply_message(meta, control.DelMessage("x", 9, 3.0))
    assert not ch3
    meta4, ch4 = managers.apply_message(meta, control.DelMessage("m", 1, 4.0))
    assert ch4 and not meta4
    meta5, _ = managers.apply_message(meta, control.AddMessage("m", 4, "/r", 5))
    assert managers.latest_version(meta5, "m") == 4
    assert managers.latest_version(meta5, "zz") == -1
    with pytest.raises(TypeError):
        managers.apply_message(meta, "not a message")


@pytest.mark.parametrize("msg", [
    tcontrol.AddMessage("m", 3, "/p.pmml", 1.5),
    tcontrol.DelMessage("m", 3, 2.5),
    tcontrol.RolloutMessage("m", 4, "canary", 3.5, path="/q", fraction=0.2),
])
def test_wire_form_round_trips_like_the_jax_one(msg):
    wire = tcontrol.to_wire(msg)
    assert tcontrol.from_wire(wire) == msg
    assert jcontrol.to_wire(jcontrol.from_wire(wire)) == wire


@pytest.mark.parametrize("bad", [
    {"kind": "add", "name": "m"}, {"kind": "nope"}, {"kind": "del",
                                                     "name": "a_b",
                                                     "version": 1,
                                                     "timestamp": 1}])
def test_malformed_wire_frames_raise_value_error(bad):
    with pytest.raises(ValueError):
        tcontrol.from_wire(bad)
    with pytest.raises(ValueError):
        jcontrol.from_wire(bad)


# -- the join against the JAX package ---------------------------------------


def test_add_v2_del_unserved_match_the_jax_package(paths, monkeypatch):
    tw = Twins()
    tw.push("AddMessage", "gbm", 1, paths["gbm"], 1.0)
    tw.push("AddMessage", "votes", 1, paths["votes"], 1.5)
    tw.warm("gbm", 1)
    tw.warm("votes", 1)
    # a batch mixing two served models makes one dispatch each, each a
    # run of the kernel's plain version on the CPU
    calls = []
    plain = qtrees_cuda.leaf_rows_reference
    monkeypatch.setattr(qtrees_cuda, "leaf_rows_reference",
                        lambda *a: calls.append(1) or plain(*a))
    d0 = tw.t.metrics.counter("dispatches").get()
    _, got = tw.score(mixed_events(1))
    assert len(calls) == 2
    assert tw.t.metrics.counter("dispatches").get() - d0 == 2
    assert all(p.is_empty == (e[0] == "ghost") for p, e in got)
    # a second version of the same width: latest-wins once it is warm
    tw.push("AddMessage", "gbm", 2, paths["gbm2"], 2.0)
    tw.warm("gbm", 2)
    assert len(calls) == 3  # v2's warm runs it once, on zero codes
    calls.clear()
    _, got = tw.score(mixed_events(2))
    assert len(calls) == 2
    # Del v1, then events pinned to v1 (empty), to v2, and unpinned (v2)
    tw.push("DelMessage", "gbm", 1, 3.0)
    X = vectors(30, 6, seed=4)
    fields = [f"f{j}" for j in range(6)]
    pinned = [dict({f: float(v) for f, v in zip(fields, x)},
                   _model="gbm", _version=1 + i % 2)
              for i, x in enumerate(X)]
    # (a group's payloads share one shape: the pinned v2 dicts are the
    # only v2 events of this batch)
    _, got = tw.score(pinned + mixed_events(3, n=40,
                                            names=("votes", "ghost")))
    assert all(p.is_empty for p, _ in got[:30:2])  # pinned to v1
    assert not any(p.is_empty for p, _ in got[1:30:2])  # pinned to v2
    assert set(tw.t.registry.served) == {ModelId("gbm", 2),
                                         ModelId("votes", 1)}


def test_default_model_and_stream_api_match(paths):
    """``with_control_stream(ctrl).evaluate(default_reader)``: events that
    name no model go to the default reader's model (a dense vector of the
    regression), named ones route through the registry."""
    events = [("iris", v)
              for v in vectors(20, 4, seed=5, missing=0.0).tolist()]
    events += [("unknown", v) for v in vectors(5, 4, seed=9).tolist()]
    events += vectors(7, 4, seed=6).tolist()  # the default model
    sides = (
        (JEnv(JConfig(batch=JBatch(size=B, deadline_us=2000))), JReader,
         JControl(), jcontrol),
        (StreamEnvironment(RuntimeConfig(batch=BatchConfig(
            size=B, deadline_us=2000)), device="cpu"), ModelReader,
         ControlSource(), tcontrol),
    )
    out = []
    for env, reader, ctrl, ctl in sides:
        ctrl.push(ctl.AddMessage("iris", 1, paths["iris"], 1.0))
        sink = env.from_collection(events).with_control_stream(
            ctrl).evaluate(reader(paths["iris2"])).collect()
        env.execute(timeout=60.0)
        out.append(sink.items)
    ref, got = out
    assert len(got) == 32
    assert_same([p for p, _ in got], [p for p, _ in ref])
    assert all(p.is_empty for p, e in got[20:25])  # totality, not failure
    assert not any(p.is_empty for p, e in got[:20])


def test_version_routing_latest_wins(paths):
    tw = Twins()
    tw.push("AddMessage", "iris", 1, paths["iris"], 1.0)
    tw.push("AddMessage", "iris", 2, paths["iris2"], 2.0)
    tw.warm("iris", 1)
    tw.warm("iris", 2)
    events = [("iris", v) for v in vectors(12, 4, seed=7, missing=0).tolist()]
    ref, got = tw.score(events)
    v2 = ModelReader(paths["iris2"]).load(batch_size=B, device="cpu")
    direct = v2.score_dense(np.asarray([e[1] for e in events], np.float32))
    assert [p.target.label for p, _ in got] == [p.target.label
                                                for p in direct]


def test_bad_path_lanes_empty_stream_alive(paths):
    tw = Twins()
    tw.push("AddMessage", "ghost", 1, "/nonexistent/m.pmml", 1.0)
    tw.push("AddMessage", "iris", 1, paths["iris"], 1.5)
    _, got = tw.score([("ghost", [1.0, 2.0, 3.0, 4.0]),
                       ("iris", [1.0, 2.0, 3.0, 4.0])])
    assert got[0][0].is_empty and not got[1][0].is_empty
    # the failed id is quarantined, and the stream keeps going
    _, got = tw.score([("ghost", [0.0] * 4)])
    assert got[0][0].is_empty
    assert tw.t.registry.warm_error(ModelId("ghost", 1)) is not None


@pytest.mark.parametrize("async_warmup", [True, False])
def test_wire_dict_control_frames(paths, async_warmup):
    """JSONL control feeds deliver wire dicts; a bad frame is skipped."""
    ctrl = ControlSource()
    scorer = DynamicScorer(control=ctrl, batch_size=B, device="cpu",
                           async_warmup=async_warmup, emit_pairs=False)
    ctrl.push({"kind": "garbage"})
    ctrl.push(tcontrol.to_wire(tcontrol.AddMessage("iris", 1, paths["iris"],
                                                   1.0)))
    out = scorer.finish(scorer.submit([("iris", [1.0, 2.0, 3.0, 4.0])]))
    assert not out[0].is_empty
    assert scorer.registry.is_warming(ModelId("iris", 1)) is False


# -- Del between batches (tests/test_runtime.py:229) ------------------------


def test_del_takes_effect_between_batches(paths):
    tw = Twins()
    tw.push("AddMessage", "gbm", 1, paths["gbm"], 1.0)
    events = [("gbm", v) for v in vectors(4, 6, seed=8).tolist()]
    _, got = tw.score(events)
    assert all(not p.is_empty for p, _ in got)
    tw.push("DelMessage", "gbm", 1, 2.0)
    _, got = tw.score(events)
    assert all(p.is_empty for p, _ in got)


def test_del_between_submit_and_finish_keeps_the_dispatch(paths):
    """A Del that lands while a dispatch is in flight frees nothing that
    dispatch still reads: the ticket holds the model and its scorer."""
    ctrl = ControlSource()
    scorer = DynamicScorer(control=ctrl, batch_size=B, device="cpu")
    ctrl.push(tcontrol.AddMessage("gbm", 1, paths["gbm"], 1.0))
    events = [("gbm", v) for v in vectors(6, 6, seed=8).tolist()]
    t1 = scorer.submit(events)
    ctrl.push(tcontrol.DelMessage("gbm", 1, 2.0))
    t2 = scorer.submit(events)  # drains the Del first
    out1, out2 = scorer.finish(t1), scorer.finish(t2)
    assert not any(p.is_empty for p, _ in out1)
    assert all(p.is_empty for p, _ in out2)
    assert scorer.registry.served == {}


# -- the warm pool ------------------------------------------------------------


def test_cold_v2_serves_warm_v1_until_it_lands(paths, monkeypatch):
    """Double-buffered swap: while v2 warms, unpinned events keep scoring
    the newest warm version and v2-pinned events go empty; once v2 lands,
    latest-wins moves to it. The warm pool's books show both."""
    metrics = MetricsRegistry()
    ctrl = ControlSource()
    scorer = DynamicScorer(control=ctrl, batch_size=B, device="cpu",
                           metrics=metrics)
    reg = scorer.registry
    ctrl.push(tcontrol.AddMessage("gbm", 1, paths["gbm"], 1.0))
    scorer._drain_control()
    assert reg.model(ModelId("gbm", 1)) is not None
    gate = threading.Event()
    prewarm = reg._prewarm
    monkeypatch.setattr(reg, "_prewarm",
                        lambda m: (gate.wait(30.0), prewarm(m)))
    ctrl.push(tcontrol.AddMessage("gbm", 2, paths["gbm2"], 2.0))
    X = vectors(8, 6, seed=10, missing=0.0)
    recs = [{f"f{j}": float(v) for j, v in enumerate(x)} for x in X]
    # dict events throughout: the pinned one shares v2's group later
    events = [dict(r, _model="gbm") for r in recs] + [
        dict(recs[0], _model="gbm", _version=2)]
    out = scorer.finish(scorer.submit(events))
    v1 = ModelReader(paths["gbm"]).load(batch_size=B, device="cpu")
    v2 = ModelReader(paths["gbm2"]).load(batch_size=B, device="cpu")
    np.testing.assert_allclose(
        [p.score.value for p, _ in out[:8]],
        [p.score.value for p in v1.quantized_scorer().score(X)],
        rtol=1e-6)
    assert out[8][0].is_empty  # pinned to the cold v2
    assert reg.is_warming(ModelId("gbm", 2))
    gate.set()
    assert reg.model(ModelId("gbm", 2)) is not None
    out = scorer.finish(scorer.submit(events))
    np.testing.assert_allclose(
        [p.score.value for p, _ in out[:8]],
        [p.score.value for p in v2.quantized_scorer().score(X)],
        rtol=1e-6)
    assert not out[8][0].is_empty
    snap = metrics.snapshot()
    assert snap["warm_pool_hits"] >= 1 and "cold_start_s_p50" in snap
    assert snap["score_latency_s_p50"] > 0


def test_registry_state_checkpoint_roundtrip(paths):
    reg = ModelRegistry(batch_size=8, device="cpu")
    reg.apply(tcontrol.AddMessage("m", 1, paths["iris"], 1.0))
    reg.apply(tcontrol.AddMessage("m", 2, paths["iris"], 2.0))
    reg.apply(tcontrol.DelMessage("m", 1, 3.0))
    state = reg.state()
    assert state == {"served": {"m_2": paths["iris"]}}
    reg2 = ModelRegistry(batch_size=8, device="cpu")
    reg2.restore(state)
    assert reg2.resolve("m").version == 2 and reg2.resolve("m", 1) is None
    assert reg2.model(ModelId("m", 2)) is not None
    assert reg2.rollouts() == {}
    # a DynamicScorer's operator state is its registry's
    scorer = DynamicScorer(control=ControlSource(), batch_size=8,
                           device="cpu")
    scorer.restore(state)
    assert scorer.state() == state
    from flink_jpmml_tpu_torch.utils.exceptions import ModelLoadingException

    with pytest.raises(ModelLoadingException):
        reg2.restore({"served": {"no-version": "/p"}})


def test_default_route():
    assert default_route(("m", [1.0])) == ("m", None, [1.0])
    assert default_route({"_model": "m", "_version": 3, "x": 1.0}) == (
        "m", 3, {"x": 1.0})
    assert default_route([1.0, 2.0]) == (None, None, [1.0, 2.0])


def test_bounded_in_flight_window(paths):
    """``in_flight`` bounds the pending group dispatches across tickets."""
    ctrl = ControlSource()
    scorer = DynamicScorer(control=ctrl, batch_size=B, device="cpu",
                           in_flight=1)
    ctrl.push(tcontrol.AddMessage("gbm", 1, paths["gbm"], 1.0))
    ctrl.push(tcontrol.AddMessage("votes", 1, paths["votes"], 1.5))
    tickets = [scorer.submit(mixed_events(s, n=20)) for s in range(3)]
    assert len(scorer._dispatcher) <= 1
    outs = [scorer.finish(t) for t in tickets]
    assert [len(o) for o in outs] == [20, 20, 20]


# -- the dispatcher's handle API, which the join rides ---------------------


class _Out:
    """A dispatch result: waiting on it raises ``error`` when set."""

    def __init__(self, error=None):
        self.error = error
        self.waits = 0

    def ready(self):
        return False

    def synchronize(self):
        self.waits += 1
        if self.error is not None:
            raise self.error


def test_unbounded_window_never_waits_and_wait_is_fifo():
    from flink_jpmml_tpu_torch.runtime.pipeline import OverlappedDispatcher

    disp = OverlappedDispatcher(depth=None)
    outs = [_Out() for _ in range(5)]
    handles = [disp.launch(lambda o=o: o, meta=i) for i, o in enumerate(outs)]
    assert len(disp) == 5
    assert not any(o.waits for o in outs)  # launch never blocks
    assert disp.wait(handles[2]) is outs[2]
    # FIFO: the older entries were finished first, the younger stay
    assert [o.waits for o in outs] == [1, 1, 1, 0, 0] and len(disp) == 2
    assert handles[0].done and not handles[3].done
    assert disp.wait(handles[0]) is outs[0] and outs[0].waits == 1
    assert disp.finish_oldest() == (outs[3], 3)
    assert disp.metrics.counter("dispatches").get() == 5


def test_wait_re_raises_a_failed_entry_every_time():
    from flink_jpmml_tpu_torch.runtime.pipeline import OverlappedDispatcher

    disp = OverlappedDispatcher(depth=None)
    bad = disp.launch(lambda: _Out(RuntimeError("device fault")))
    good = disp.launch(_Out)
    with pytest.raises(RuntimeError, match="device fault"):
        disp.wait(good)  # the older failed entry surfaces first
    assert bad.done and bad.error is not None and len(disp) == 1
    for _ in range(2):
        with pytest.raises(RuntimeError, match="device fault"):
            disp.wait(bad)
    assert disp.wait(good) is good.out


def test_abandon_and_close_without_drain():
    from flink_jpmml_tpu_torch.runtime.pipeline import (
        DispatcherClosed,
        OverlappedDispatcher,
    )

    disp = OverlappedDispatcher(depth=None)
    handles = [disp.launch(_Out) for _ in range(3)]
    assert disp.abandon() == 3 and len(disp) == 0
    # a dropped handle is still waited on, never handed back unfinished
    assert disp.wait(handles[1]).waits == 1 and handles[1].done
    disp.launch(_Out)
    disp.close(drain=False)
    assert len(disp) == 0
    with pytest.raises(DispatcherClosed):
        disp.launch(_Out)


# -- the freshness plane on both record paths --------------------------------


def test_event_time_books_staleness_like_the_jax_package(paths):
    """``event_time_fn`` (on the dynamic scorer, and on a source feeding
    the static engine) books ``record_staleness_s`` and the sink
    watermark from each finished batch's event times."""
    from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JRegistry
    from flink_jpmml_tpu_torch.runtime.engine import Pipeline, StaticScorer
    from flink_jpmml_tpu_torch.runtime.sinks import CollectSink
    from flink_jpmml_tpu_torch.runtime.sources import InMemorySource

    now = time.time()
    events = [("iris", [1.0, 2.0, 3.0, 4.0], now - 5.0 + i) for i in range(4)]
    watermarks = []
    for Scorer, Ctrl, Registry, ctl, kw in (
        (JDynamic, JControl, JRegistry, jcontrol, {}),
        (DynamicScorer, ControlSource, MetricsRegistry, tcontrol,
         {"device": "cpu"}),
    ):
        ctrl, reg = Ctrl(), Registry()
        scorer = Scorer(control=ctrl, batch_size=B, metrics=reg,
                        route=lambda e: (e[0], None, e[1]),
                        event_time_fn=lambda e: e[2], **kw)
        ctrl.push(ctl.AddMessage("iris", 1, paths["iris"], 1.0))
        out = scorer.finish(scorer.submit(events))
        assert not any(p.is_empty for p, _ in out)
        snap = reg.snapshot()
        assert snap["record_staleness_s_p50"] >= 1.0
        watermarks.append(snap["watermark_ts"])
    assert watermarks[0] == watermarks[1] == now - 2.0
    reg = MetricsRegistry()
    sink = CollectSink()
    pipe = Pipeline(
        InMemorySource([e[1] for e in events],
                       event_time_fn=lambda r: now - 3.0),
        StaticScorer(ModelReader(paths["iris"]).load(batch_size=B,
                                                     device="cpu")),
        sink, RuntimeConfig(batch=BatchConfig(size=B, deadline_us=2000)),
        metrics=reg)
    pipe.run_until_exhausted(timeout=30.0)
    assert len(sink.items) == 4 and pipe.committed_offset == 4
    assert reg.snapshot()["watermark_ts"] == now - 3.0


# -- a device fault at default settings (the JAX scorer retries) ------------


def test_default_scorer_redispatches_a_device_faulted_group(paths):
    """``DynamicScorer`` with default arguments retries a device fault, as
    the JAX scorer does (``device_retry=None`` means retry): one injected
    ``device_error`` on a group's readback, and every event is scored on
    both packages, the group re-dispatched from its payloads."""
    from flink_jpmml_tpu.runtime import faults as jfaults
    from flink_jpmml_tpu_torch.runtime import faults as tfaults

    tw = Twins()
    tw.push("AddMessage", "gbm", 1, paths["gbm"], 1.0)
    tw.push("AddMessage", "votes", 1, paths["votes"], 1.5)
    tw.warm("gbm", 1)
    tw.warm("votes", 1)
    events = mixed_events(5)
    try:
        for f in (jfaults, tfaults):
            f.inject("device_error", site="device_readback", n=1)
        _, got = tw.score(events)
        fired = (jfaults.stats(), tfaults.stats())
    finally:
        jfaults.clear()
        tfaults.clear()
    assert fired[0] == fired[1] == {"device_error": 1}
    assert all(p.is_empty == (e[0] == "ghost") for p, e in got)
    j = tw.j.metrics.struct_snapshot()["counters"]
    t = tw.t.metrics.struct_snapshot()["counters"]
    for k in ("redispatch_records", 'device_fault_total{kind="device_error"}'):
        assert t[k] == j[k] > 0
    assert t["redispatches"] == 1
