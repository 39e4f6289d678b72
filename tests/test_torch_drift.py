"""The port's data-drift plane (obs/drift.py, utils/metrics.QuantileSketch /
Reservoir) held to the JAX package's on the CPU.

The same numpy-seeded inputs go through both packages: sketch and
reservoir states, the fleet merge and the series governor's ``sketches``
sections, PSI / JS divergence, a ``DriftPlane`` fed the same batches and
the monitor's alarm / clear transitions on an injected clock must be
EQUAL (the port's copies are numpy on the host in float64, so there is no
tolerance to state). Then the port's own contracts: baselines on disk in
the port's cache, the unarmed plane recording nothing, armed dispatches
giving byte-equal outputs to unarmed ones on both encode placements, and
the derived state features reaching the plane through a stateful
``BlockPipeline`` without changing its table.
"""

import itertools
import json

import numpy as np
import pytest

from flink_jpmml_tpu.obs import drift as jdrift
from flink_jpmml_tpu.utils import metrics as jmetrics
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.obs import drift
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized
from flink_jpmml_tpu_torch.utils import metrics as tmetrics

PACKAGES = {"jax": (jdrift, jmetrics), "port": (drift, tmetrics)}
B = 64
F = 6


def _values(seed: int) -> np.ndarray:
    """Signed, heavy-tailed, with zeros, tiny values and non-finites: every
    branch of the bucket index."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(0.0, 1.0, 3000),
        rng.normal(50.0, 5.0, 1500),
        -rng.lognormal(0.0, 2.0, 1000),
        np.zeros(50), np.full(20, 1e-12),
        [np.nan, np.inf, -np.inf, 1e150, -1e-300],
    ])


def _orders(vals):
    asc = np.sort(vals)
    return {"given": vals, "asc": asc, "desc": asc[::-1],
            "interleave": np.concatenate([asc[::2], asc[1::2][::-1]])}


class _FakeWire:
    def __init__(self, fields, cuts):
        self.fields = tuple(fields)
        self.cuts = tuple(np.asarray(c, np.float32) for c in cuts)


class _FakeScorer:
    def __init__(self, fields=("a", "b", "c"), cuts=None, model_hash="m01"):
        if cuts is None:
            cuts = [np.array([-1.0, 0.0, 1.0])] * len(fields)
        self.wire = _FakeWire(fields, cuts)
        self.model_hash = model_hash


def _strip(struct: dict) -> dict:
    """A struct without its clocks (uptime, capture time)."""
    return {k: v for k, v in struct.items() if k not in ("uptime_s", "ts")}


# -- QuantileSketch / Reservoir ----------------------------------------------


@pytest.mark.parametrize("budget", [tmetrics.QuantileSketch.DEFAULT_BUDGET, 16])
@pytest.mark.parametrize("order", ["given", "asc", "desc", "interleave"])
def test_sketch_state_equals_the_jax_one(order, budget):
    vals = _orders(_values(0))[order]
    states = {}
    for name, (_, m) in PACKAGES.items():
        s = m.QuantileSketch(budget=budget)
        s.observe_many(vals)
        states[name] = s.state()
    assert states["port"] == states["jax"]
    if budget == 16:  # compaction at the budget kept every count
        assert len(states["port"]["pos"]) <= 16
        assert states["port"]["n"] == np.isfinite(vals).sum()


@pytest.mark.parametrize("perm", list(itertools.permutations(range(3))))
def test_sketch_merges_in_every_order_equal_the_jax_ones(perm):
    parts = np.array_split(_values(1), 3)
    merged = {}
    for name, (_, m) in PACKAGES.items():
        sk = [m.QuantileSketch(budget=64) for _ in parts]
        for s, p in zip(sk, parts):
            s.observe_many(p)
        # through the wire form, as the fleet merge sees them
        a, b, c = (m.QuantileSketch.from_state(json.loads(json.dumps(
            sk[i].state()))) for i in perm)
        merged[name] = a.merge(b.merge(c))
    assert merged["port"].state() == merged["jax"].state()
    for q in (0.001, 0.01, 0.5, 0.99, 0.999):
        assert merged["port"].quantile(q) == merged["jax"].quantile(q)
    # the fold order changes nothing: bucket counts add
    whole = tmetrics.QuantileSketch(budget=64)
    whole.observe_many(np.concatenate(parts))
    for key in ("pos", "neg", "zero", "n"):
        assert merged["port"].state()[key] == whole.state()[key]


def test_reservoir_state_equals_the_jax_one():
    vals = np.random.default_rng(2).exponential(1.0, 20_000)
    states = []
    for _, m in PACKAGES.values():
        r = m.Reservoir(capacity=512)
        for v in vals:
            r.observe(float(v))
        states.append((r.state(), r.quantile(0.5), r.quantile(0.99)))
    assert states[0] == states[1]
    back = tmetrics.Reservoir.from_state(states[1][0])
    assert back.state() == states[1][0]


def _fill(m, seed: int):
    """A registry with counters, a histogram, two sketches and a
    reservoir, the same in both packages for one seed."""
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry()
    reg.counter("records_out").inc(100 + seed)
    reg.histogram("score_latency_s").observe(1e-3 * (seed + 1))
    for j in range(2):
        reg.sketch(f'feature_values{{model="m",feature="f{j}"}}'
                   ).observe_many(rng.normal(j, 1.0 + seed, 500))
    for t in range(5):
        reg.sketch(f'prediction_values{{model="t{t}"}}').observe_many(
            rng.normal(t, 1.0, 10 * (t + 1)))
    reg.reservoir("r").observe(1.0)
    return reg


def test_merge_structs_sketches_equal_the_jax_ones():
    out = {}
    for name, (_, m) in PACKAGES.items():
        structs = [_fill(m, s).struct_snapshot() for s in range(3)]
        structs.append({"sketches": {"x": "garbage"}})  # skipped
        out[name] = _strip(m.merge_structs(structs))
    assert out["port"] == out["jax"]
    assert "x" not in out["port"]["sketches"]
    assert len(out["port"]["sketches"]) == 7
    # a struct without sketches keeps its shape
    bare = tmetrics.MetricsRegistry().struct_snapshot()
    assert "sketches" not in bare
    assert "sketches" not in tmetrics.merge_structs([bare])
    # reservoirs never ride the fleet wire, but the flat snapshot reads them
    reg = _fill(tmetrics, 0)
    assert "r_p50" in reg.snapshot()
    assert "r" not in reg.struct_snapshot()["sketches"]


def test_govern_struct_sketches_equal_the_jax_ones():
    out = {}
    for name, (_, m) in PACKAGES.items():
        merged = m.merge_structs([_fill(m, s).struct_snapshot()
                                  for s in range(2)])
        out[name] = _strip(m.govern_struct(merged, max_series=2))
    assert out["port"] == out["jax"]
    sk = out["port"]["sketches"]
    # five prediction series folded to two, one of them the "_other" tail
    preds = [k for k in sk if k.startswith("prediction_values")]
    assert len(preds) == 2 and any("_other" in k for k in preds)


@pytest.mark.parametrize("shift", [0.0, 0.3, 4.0])
@pytest.mark.parametrize("fn", ["psi", "js_divergence"])
def test_divergences_equal_the_jax_ones(fn, shift):
    rng = np.random.default_rng(3)
    base, live = rng.normal(0, 1, 4000), rng.normal(shift, 1, 4000)
    got = {}
    for name, (d, m) in PACKAGES.items():
        a, b = m.QuantileSketch(), m.QuantileSketch()
        a.observe_many(base)
        b.observe_many(live)
        got[name] = getattr(d, fn)(a, b)
        assert getattr(d, fn)(m.QuantileSketch(), b) is None
    assert got["port"] == got["jax"]
    assert (got["port"] > 0.25) is (shift == 4.0)


def test_sketch_window_equals_the_jax_one():
    rng = np.random.default_rng(4)
    out = {}
    for name, (d, m) in PACKAGES.items():
        s = m.QuantileSketch()
        s.observe_many(rng.normal(0, 1, 500))
        old = s.state()
        s.observe_many(rng.normal(3, 1, 500))
        win = d.sketch_window(s.state(), old)
        back = d.sketch_window(old, s.state())  # a restart: cumulative
        out[name] = (win.state(), back.state())
        rng = np.random.default_rng(4)
    assert out["port"] == out["jax"]
    assert out["port"][0]["n"] == 500 and out["port"][1]["n"] == 500


# -- DriftPlane ----------------------------------------------------------------


def _feed_plane(d, m, batches, preds):
    reg = m.MetricsRegistry()
    plane = d.DriftPlane(reg, interval_s=0.0, budget_frac=0, max_rows=40,
                         store=d.BaselineStore("/nonexistent-drift-dir"))
    q = _FakeScorer(cuts=[np.array([-1.0, 1.0]), np.empty((0,)),
                          np.array([0.5])])
    for (X, M), p in zip(batches, preds):
        assert plane.record_features(q, X, M)
        assert plane.record_predictions("m01", p, len(p) - 3)
    return reg


def test_plane_fed_the_same_batches_equals_the_jax_one():
    rng = np.random.default_rng(5)
    batches, preds = [], []
    for b in range(6):
        X = rng.normal(0, 2, (100 + 7 * b, 3)).astype(np.float32)
        X[rng.random(X.shape) < 0.1] = np.nan
        M = rng.random(X.shape) < 0.05 if b % 2 else None
        batches.append((X, M))
        preds.append(rng.normal(0, 1, 90))
    got = {name: _strip(_feed_plane(d, m, batches, preds).struct_snapshot())
           for name, (d, m) in PACKAGES.items()}
    assert got["port"] == got["jax"]
    c = got["port"]["counters"]
    # the ceil stride spans each batch, at most max_rows rows of it
    rows = sum(len(X[::-(-len(X) // 40)][:40]) for X, _ in batches)
    assert c['drift_feature_records{model="m01",feature="a"}'] == rows
    assert c['drift_feature_unseen{model="m01",feature="a"}'] > 0
    assert c.get('drift_feature_unseen{model="m01",feature="b"}', 0) == 0
    # the prediction sample honours n (87 of 90) and the row cap
    assert got["port"]["sketches"]['prediction_values{model="m01"}'][
        "n"] == 6 * len(np.arange(87)[::3])


def test_interval_and_budget_gates_on_an_injected_clock():
    t = [0.0]
    reg = tmetrics.MetricsRegistry()  # the plane holds it weakly
    plane = drift.DriftPlane(reg, interval_s=1.0,
                             budget_frac=0.02, clock=lambda: t[0])
    q, X = _FakeScorer(), np.zeros((8, 3), np.float32)
    t[0] = 0.001
    assert plane.record_features(q, X)
    assert not plane.record_features(q, X)  # inside the interval
    t[0] = 1.5
    with plane._mu:
        plane._spent = 1.0  # an expensive past: the budget is spent
    assert not plane.record_features(q, X)
    assert plane.stats()["skipped"] == 1
    t[0] = 100.0  # the wall clock caught up
    assert plane.record_features(q, X)
    assert plane.record_predictions("m01", np.ones(4))
    assert not plane.record_predictions("m01", np.ones(4))


# -- baselines -----------------------------------------------------------------


def test_baseline_store_round_trip_and_corruption(tmp_path):
    store = drift.BaselineStore(tmp_path / "bl")
    payload = {"features": {"a": {"n": 1}}, "stats": {}, "predictions": None}
    path = store.save("m/01", payload)
    assert path.name == "baseline_m_01.json"
    got = store.load("m/01")
    assert got["features"] == payload["features"] and got["model"] == "m/01"
    assert store.models() == ["m/01"]
    # the JAX store reads the same bytes the same way
    assert jdrift.BaselineStore(tmp_path / "bl").load("m/01") == got
    # truncated, edited, not JSON, not a dict: all read as absent
    for body in (path.read_text()[:-5],
                 path.read_text().replace('"n": 1', '"n": 2'),
                 "garbage", "[1, 2]"):
        path.write_text(body)
        assert store.load("m/01") is None
    assert store.load("never-saved") is None
    (tmp_path / "ro").write_text("a file where the directory should be")
    with pytest.raises(OSError):
        drift.BaselineStore(tmp_path / "ro").save("m", payload)


def test_baselines_live_in_the_port_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("FJT_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    root = drift.BaselineStore().root
    assert root == tmp_path / ".cache" / "flink_jpmml_tpu_torch" / (
        "drift_baselines")
    # beside the autotune cache when that is pointed elsewhere
    monkeypatch.setenv("FJT_AUTOTUNE_CACHE", str(tmp_path / "t" / "a.json"))
    assert drift.BaselineStore().root == tmp_path / "t" / "drift_baselines"


def test_snapshot_registry_arms_the_monitor_and_persists(tmp_path):
    reg = tmetrics.MetricsRegistry()
    store = drift.BaselineStore(tmp_path / "bl")
    plane = drift.install(reg, interval_s=0.0, budget_frac=0, store=store)
    rng = np.random.default_rng(6)
    q = _FakeScorer(fields=("a", "b"), cuts=[np.array([-1.0, 1.0])] * 2)
    for _ in range(4):
        plane.record_features(q, rng.normal(0, 1, (64, 2)).astype(np.float32))
    plane.record_predictions("m01", rng.normal(0, 1, 64))
    saved = drift.snapshot_registry(reg, store=store)
    assert set(saved["m01"]["features"]) == {"a", "b"}
    assert saved["m01"]["stats"]["a"]["records"] == 256
    assert store.load("m01")["features"] == saved["m01"]["features"]
    assert plane.monitor._baselines["m01"]["features"] == saved["m01"][
        "features"]
    assert drift.plane_for(reg) is plane


# -- DriftMonitor hysteresis on an injected clock, against the JAX monitor ---


def _monitor_run(d, m, steps, **kw):
    """Feed a cumulative sketch per step; → the transitions of each tick."""
    t = [0.0]
    sk, pred = m.QuantileSketch(), m.QuantileSketch()

    def struct():
        out = {d.feature_sketch_name("m", "x"): sk.state()}
        if pred.count():
            out[d.prediction_sketch_name("m")] = pred.state()
        return {"sketches": out, "counters": {}}

    gauges = m.MetricsRegistry()
    mon = d.DriftMonitor(struct_fn=struct,
                         store=d.BaselineStore("/nonexistent-drift-dir"),
                         interval_s=0.0, clock=lambda: t[0],
                         gauge_metrics=gauges, **kw)
    rng = np.random.default_rng(7)
    sk.observe_many(rng.normal(0, 1, 4000))
    pred.observe_many(rng.normal(2, 1, 4000))
    mon.set_baseline("m", d.snapshot_from_struct(struct())["m"])
    trail = [mon.tick()]
    for when, mean, pmean in steps:
        sk.observe_many(rng.normal(mean, 1, 4000))
        pred.observe_many(rng.normal(pmean, 1, 4000))
        t[0] = when
        trail.append([(tr["feature"], tr["transition"]) for tr in mon.tick()])
    snap = gauges.struct_snapshot()
    return trail, mon.alarms(), snap["gauges"], snap["counters"]


MONITOR_CASES = {
    # (steps of (time, feature mean, prediction mean), monitor knobs)
    "alarm_after_dwell": ([(1.0, 4, 2), (3.0, 4, 2), (6.5, 4, 2),
                           (7.0, 4, 2)],
                          dict(dwell_s=5.0, window_s=1e9)),
    "band_holds": ([(1.0, 4, 2), (2.0, 0.35, 2)],
                   dict(dwell_s=0.0, window_s=0.9)),
    "clear_after_dwell": ([(1.0, 4, 2), (3.2, 4, 2), (4.0, 0, 2),
                           (5.0, 0, 2), (6.2, 0, 2), (7.3, 0, 2)],
                          dict(dwell_s=2.0, window_s=0.9)),
    "prediction_series": ([(1.0, 0, 9)], dict(dwell_s=0.0, window_s=1e9)),
    "sample_floor": ([(1.0, 9, 9)], dict(dwell_s=0.0, min_n=10**6)),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_monitor_transitions_equal_the_jax_ones(case):
    steps, knobs = MONITOR_CASES[case]
    knobs = dict(dict(psi_alarm=0.25, psi_clear=0.1, min_n=50), **knobs)
    got = {name: _monitor_run(d, m, steps, **knobs)
           for name, (d, m) in PACKAGES.items()}
    assert got["port"] == got["jax"]
    trail, alarms = got["port"][0], got["port"][1]
    fired = [tr for step in trail for tr in step]
    if case == "alarm_after_dwell":
        assert trail[1:] == [[], [], [("x", "alarm")], []] and alarms
    elif case == "clear_after_dwell":
        assert fired == [("x", "alarm"), ("x", "clear")] and not alarms
    elif case == "prediction_series":
        assert fired == [(None, "alarm")]
    elif case == "band_holds":
        assert fired == [("x", "alarm")] and alarms
    else:
        assert fired == [] and not alarms


def test_scrape_hook_ticks_the_registry_monitor():
    reg = tmetrics.MetricsRegistry()
    t = [0.0]
    mon = drift.monitor_for(reg)
    mon._clock, mon._interval, mon.dwell_s, mon.min_n = (
        lambda: t[0]), 0.0, 0.0, 50
    rng = np.random.default_rng(8)
    sk = reg.sketch(drift.feature_sketch_name("m", "x"))
    sk.observe_many(rng.normal(0, 1, 4000))
    mon.set_baseline("m", drift.snapshot_from_struct(
        reg.struct_snapshot())["m"])
    sk.observe_many(rng.normal(8, 1, 4000))
    t[0] = 1.0
    reg.struct_snapshot()  # the scrape is the tick
    assert mon.alarms() and not mon.health()["drift"]["ok"]
    h = mon.health_fn(lambda: {"ok": True})()
    assert h["ok"] and h["drift"]["alarms"][0]["feature"] == "x"
    assert drift.summary(reg)["m"]["features"]["x"]["alarmed"]
    assert drift.artifact_fields(reg)["m"]["alarmed_features"] == ["x"]


# -- on the dispatch path ------------------------------------------------------


@pytest.fixture(scope="module")
def gbm(tmp_path_factory):
    from flink_jpmml_tpu.compile import compile_pmml as jcompile
    from flink_jpmml_tpu.pmml import parse_pmml_file as jparse

    path = gen_gbm(str(tmp_path_factory.mktemp("gbm")), n_trees=10, depth=3,
                   n_features=F)
    return (compile_pmml(parse_pmml_file(path), batch_size=B, device="cpu"),
            jcompile(jparse(path), batch_size=B))


def _batch(seed: int, n: int = B) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.5, (n, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.2] = np.nan
    return X


def _out(res):
    out = res.result()
    return out.numpy() if hasattr(out, "numpy") else np.asarray(out)


def test_unarmed_dispatch_records_nothing(gbm, monkeypatch):
    monkeypatch.delenv("FJT_DRIFT_SAMPLE", raising=False)
    reg = tmetrics.MetricsRegistry()
    q = gbm[0].quantized_scorer()
    dispatch_quantized(q, _batch(0), metrics=reg).result()
    assert drift.plane_for(reg) is None
    snap = reg.struct_snapshot()
    assert "sketches" not in snap
    assert not any(k.startswith("drift_") for k in snap["counters"])
    monkeypatch.setenv("FJT_DRIFT_SAMPLE", "0")
    dispatch_quantized(q, _batch(0), metrics=reg).result()
    assert drift.plane_for(reg) is not None  # the env armed it
    assert reg.struct_snapshot()["sketches"]


@pytest.mark.parametrize("placement", ["host", "fused"])
def test_armed_dispatch_is_byte_equal_and_sketches_equal_the_jax(
        gbm, placement):
    from flink_jpmml_tpu.runtime.pipeline import (
        dispatch_quantized as jdispatch,
    )

    cm, jcm = gbm
    q, jq = cm.quantized_scorer(), jcm.quantized_scorer()
    q.encode_mode = placement
    try:
        cold, hot, jhot = (tmetrics.MetricsRegistry(),
                           tmetrics.MetricsRegistry(),
                           jmetrics.MetricsRegistry())
        drift.install(hot, interval_s=0.0, budget_frac=0)
        jdrift.install(jhot, interval_s=0.0, budget_frac=0)
        for seed in range(4):
            X = _batch(seed, B * (1 + seed % 2) - 3 * seed)
            before = X.copy()
            a = _out(dispatch_quantized(q, X, metrics=cold))
            b = _out(dispatch_quantized(q, X, metrics=hot))
            np.asarray(jdispatch(jq, X, metrics=jhot))
            assert a.tobytes() == b.tobytes()
            assert np.array_equal(X, before, equal_nan=True)
        assert q.encode_placement == placement
    finally:
        q.encode_mode = None
    sk, jsk = (r.struct_snapshot()["sketches"] for r in (hot, jhot))
    assert sk == jsk and len(sk) == F
    assert sk[f'feature_values{{model="{q.model_hash}",feature="f0"}}'][
        "n"] > 0
    assert "sketches" not in cold.struct_snapshot()


def _state_run(cm, data, armed: bool):
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.state import StateSpec

    reg = tmetrics.MetricsRegistry()
    if armed:
        drift.install(reg, interval_s=0.0, budget_frac=0)
    outs = []
    pipe = BlockPipeline(
        FiniteBlockSource(data, block_size=B), cm,
        lambda out, n, off: outs.append(np.asarray(out)[:n].copy()),
        max_dispatch_chunks=1, metrics=reg,
        state=StateSpec(capacity=256, stride=16))
    pipe.run_until_exhausted(timeout=60.0)
    return pipe, reg, np.concatenate(outs)


def test_stateful_block_pipeline_feeds_the_derived_features(gbm):
    cm = gbm[0]
    rng = np.random.default_rng(9)
    data = _batch(9, 8 * B)
    data[:, 0] = rng.integers(0, 40, len(data)).astype(np.float32)
    pipe0, reg0, out0 = _state_run(cm, data, armed=False)
    pipe1, reg1, out1 = _state_run(cm, data, armed=True)
    assert out0.tobytes() == out1.tobytes()
    # the plane reads the table's step; it never writes the table
    assert (pipe0._state.host_values().tobytes()
            == pipe1._state.host_values().tobytes())
    label = f"{cm.quantized_scorer().model_hash}#state"
    sk = reg1.struct_snapshot()["sketches"]
    state_series = [k for k in sk if f'model="{label}"' in k]
    assert len(state_series) == 8  # one per derived feature
    assert all(sk[k]["n"] > 0 for k in state_series)
    c = reg1.struct_snapshot()["counters"]
    assert c[f'drift_feature_records{{model="{label}",'
             f'feature="state_count"}}'] == len(data)
    # the raw features rode dispatch_quantized under the model's own label
    assert any(f'model="{label[:-6]}"' in k for k in sk)
    assert "sketches" not in reg0.struct_snapshot()
