"""The overload plane of the port on the CPU against the JAX package's
(``serving/overload.py`` and its wiring): the same observation sequence
through both ``AdaptiveBatcher``s gives the same fit, caps, proposals,
OOM cap and persisted JSON; the same pressure trace through both
``AdmissionController``s gives the same shed levels, counters and flight
events (mirroring ``tests/test_overload.py``'s classes); and the block
and scorer shed paths give the same sink contents, committed offsets and
``shed_records`` as the JAX pipelines, with shed events empty.

Shedding is driven by a pressure schedule and a fake clock the test
owns, never by thread timing. The port runs with ``device="cpu"``;
values at rtol 1e-4 / atol 1e-5, offsets, counts and events exactly."""

import json
import os
import time
import types

import numpy as np
import pytest

from test_torch_checkpoint import (  # noqa: F401  (fixtures)
    B,
    F,
    TWINS,
    _clean_faults,
    cfg,
    coverage,
    data,
    gbm_path,
    models,
    same_deliveries,
    twin,
)
from test_torch_stream import assert_same


def edge(name):
    """One package's overload surface under common names."""
    if name == "jax":
        from flink_jpmml_tpu.obs import recorder as flight
        from flink_jpmml_tpu.serving import overload
        from flink_jpmml_tpu.utils import exceptions, metrics
    else:
        from flink_jpmml_tpu_torch.obs import recorder as flight
        from flink_jpmml_tpu_torch.serving import overload
        from flink_jpmml_tpu_torch.utils import exceptions, metrics
    return types.SimpleNamespace(overload=overload, flight=flight,
                                 metrics=metrics, exceptions=exceptions)


# -- AdaptiveBatcher ------------------------------------------------------------

OBSERVATIONS = {
    # synthetic truth c0 = 2 ms, c1 = 10 µs a record, three sizes
    "three_sizes": [(n, 0.002 + 1e-5 * n) for n in (128, 512, 2048)
                    for _ in range(3)],
    "one_size": [(100, 0.001)],
    # a non-increasing fit degrades to the origin model
    "noisy_decreasing": [(128, 0.004), (512, 0.003), (2048, 0.002)],
    # the workload slows 5x: sustained drift re-estimates
    "drift": [(256, 0.002)] * 4 + [(256, 0.010)] * 12,
    "ignored": [(0, 0.1), (10, 0.0), (64, 0.0005)],
}


def _batcher_run(name, obs, path):
    pk = edge(name)
    now = [0.0]
    m = pk.metrics.MetricsRegistry()
    b = pk.overload.AdaptiveBatcher(
        metrics=m, deadline_s=0.010, target_frac=0.8, min_records=16,
        max_records=8192, model="m", backend="b", path=path,
        flush_interval_s=1.0, clock=lambda: now[0],
    )
    pk.flight.DEFAULT.clear()
    trail = []
    for n, lat in obs:
        now[0] += 0.4
        b.observe(n, lat)
        trail.append((b.coefficients(), b.max_records()))
    b.flush()
    with open(path) as f:
        disk = json.load(f) if os.path.getsize(path) else None
    for e in disk["entries"].values():
        e.pop("ts")
    events = [(e["kind"], {k: v for k, v in e.items()
                           if k not in ("kind", "t", "ts", "pid", "seq")})
              for e in pk.flight.events()
              if e["kind"] == "capacity_reestimated"]
    return {
        "trail": trail,
        "propose": [b.propose(c) for c in ([128, 256, 512, 1024],
                                           [64, 8192], [1])],
        "state": b.state(),
        "gauges": m.struct_snapshot()["gauges"],
        "disk": disk,
        "events": events,
        "predicted": [b.predicted_latency(n) for n in (1, 1000)],
    }


@pytest.mark.parametrize("case", sorted(OBSERVATIONS))
def test_batcher_fits_like_the_jax_one(case, tmp_path):
    obs = OBSERVATIONS[case]
    runs = {name: _batcher_run(name, obs, str(tmp_path / f"{name}.json"))
            for name in TWINS}
    assert runs["port"] == runs["jax"]
    if case == "three_sizes":
        c0, c1 = runs["port"]["trail"][-1][0]
        assert c0 == pytest.approx(0.002, rel=0.2)
        assert c1 == pytest.approx(1e-5, rel=0.2)
    if case == "drift":
        assert runs["port"]["events"], "sustained drift must re-estimate"


@pytest.mark.parametrize("deadline", [None, 0.01])
def test_batcher_oom_cap_like_the_jax_one(deadline, tmp_path, monkeypatch):
    monkeypatch.delenv("FJT_SLO_TARGET_MS", raising=False)
    got = {}
    for name in TWINS:
        pk = edge(name)
        m = pk.metrics.MetricsRegistry()
        b = pk.overload.AdaptiveBatcher(
            metrics=m, deadline_s=deadline, min_records=64,
            path=str(tmp_path / f"{name}.json"),
        )
        trail = [b.max_records()]
        b.observe(512, 0.004)
        trail.append(b.max_records())
        for cap in (4096, 100, 8, 2048):  # only ever shrinks, ≥ min
            trail.append((b.note_oom_cap(cap), b.max_records()))
        got[name] = (trail, m.struct_snapshot()["gauges"])
    assert got["port"] == got["jax"]
    assert got["port"][0][-1] == (64, 64)


def test_batcher_persists_and_survives_corruption_like_the_jax_one(tmp_path):
    got = {}
    for name in TWINS:
        pk = edge(name)
        path = str(tmp_path / f"{name}.json")
        b = pk.overload.AdaptiveBatcher(deadline_s=0.01, model="m",
                                        backend="b", path=path)
        b.observe(128, 0.002)
        b.observe(512, 0.006)
        b.flush()
        b2 = pk.overload.AdaptiveBatcher(deadline_s=0.01, model="m",
                                         backend="b", path=path)
        seeded = (b2.coefficients(), b2.max_records())
        with open(path, "w") as f:
            f.write("\x00garbage{{{")
        b3 = pk.overload.AdaptiveBatcher(deadline_s=0.01, model="m",
                                         backend="b", path=path)
        fresh = b3.coefficients()
        b3.observe(128, 0.002)
        b3.flush()
        with open(path) as f:
            keys = sorted(json.load(f)["entries"])
        got[name] = (seeded, fresh, keys)
    assert got["port"] == got["jax"]
    assert got["port"][1] is None and got["port"][2] == ["m|b"]


def test_capacity_model_lives_in_the_ports_cache_keyed_by_device(
        tmp_path, monkeypatch):
    from flink_jpmml_tpu_torch.serving import overload
    from flink_jpmml_tpu_torch.utils import cache

    monkeypatch.setenv("HOME", str(tmp_path))
    path = overload.capacity_model_path("cpu")
    assert path == os.path.join(str(tmp_path), ".cache",
                                "flink_jpmml_tpu_torch",
                                "capacity_model-cpu.json")
    assert cache.device_tag("cpu") == "cpu"
    b = overload.AdaptiveBatcher(deadline_s=0.01, device="cpu")
    b.observe(256, 0.003)
    b.flush()
    assert os.path.exists(path)
    # a fit for the CPU is never read as another device's
    assert overload.AdaptiveBatcher(deadline_s=0.01, device="cpu") \
        .coefficients() is not None
    other = os.path.join(os.path.dirname(path),
                         "capacity_model-NVIDIA_H100_80GB_HBM3.json")
    assert not os.path.exists(other)
    # the JAX package's cache directory is never touched
    assert not os.path.exists(os.path.join(str(tmp_path), ".cache",
                                           "flink_jpmml_tpu"))


# -- AdmissionController ----------------------------------------------------------


def _controller(pk, metrics, lanes, schedule, dwell=0.5):
    """A controller whose pressure follows ``schedule`` (one value a
    tick, the last repeated) on a clock the caller advances."""
    t = [0.0]
    ticks = [0]

    def pressure():
        i = min(ticks[0], len(schedule) - 1)
        ticks[0] += 1
        return schedule[i]

    adm = pk.overload.AdmissionController(
        metrics, lanes=lanes, dwell_s=dwell, interval_s=0.01,
        on_threshold=0.8, off_threshold=0.3,
        pressure_fn=pressure, clock=lambda: t[0],
    )
    return adm, t


def _forced(pk, metrics, lanes, level):
    """Driven to ``level`` through its own ticks, then frozen there."""
    adm, t = _controller(pk, metrics, lanes, [1.0] * 64 + [0.5], dwell=0.1)
    while adm.shed_level < level:
        t[0] += 0.2
        adm.tick()
    adm._pressure_fn = lambda: 0.5
    return adm


def _events(pk, kind):
    return [{k: v for k, v in e.items()
             if k not in ("t", "ts", "pid", "seq")}
            for e in pk.flight.events() if e["kind"] == kind]


TRACES = {
    # a sawtooth crossing on every other tick never raises the level
    "sawtooth": [0.95, 0.1] * 100,
    # sustained pressure climbs one lane a dwell
    "climb": [0.95] * 40,
    # brief calm keeps the level, sustained calm recovers one a dwell
    "recover": [0.95] * 12 + [0.1] * 3 + [0.5] + [0.1] * 40,
}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_admission_hysteresis_like_the_jax_one(trace):
    got = {}
    for name in TWINS:
        pk = edge(name)
        pk.flight.DEFAULT.clear()
        m = pk.metrics.MetricsRegistry()
        adm, t = _controller(pk, m, ("low", "normal", "high"),
                             TRACES[trace])
        levels = []
        for _ in TRACES[trace]:
            t[0] += 0.1
            r = adm.tick()
            levels.append((r["level"], r["transition"]))
        got[name] = (levels, _events(pk, "shed_level_change"),
                     m.struct_snapshot()["gauges"])
    assert got["port"] == got["jax"]
    levels = [lv for lv, _ in got["port"][0]]
    assert all(b - a in (-1, 0, 1) for a, b in zip(levels, levels[1:]))
    if trace == "sawtooth":
        assert max(levels) == 0
    elif trace == "climb":
        assert max(levels) == 3
    else:
        assert max(levels) >= 2 and levels[-1] == 0


@pytest.mark.parametrize("lanes", [
    ("low", "normal", "high"),
    ("bulk", "batch", "interactive", "system"),
    ("only",),
])
def test_shed_is_the_same_priority_prefix(lanes):
    got = {}
    for name in TWINS:
        pk = edge(name)
        trail = []
        for level in range(len(lanes) + 1):
            m = pk.metrics.MetricsRegistry()
            adm = _forced(pk, m, lanes, level)
            verdicts = [adm.admit(lane, n=3) for lane in lanes]
            verdicts.append(adm.admit("mystery"))  # never shed
            trail.append((adm.shed_level, adm.shed_lanes(), verdicts,
                          adm.counts(), m.struct_snapshot()["counters"]))
        got[name] = trail
    assert got["port"] == got["jax"]
    for level, (lv, shed, verdicts, _, _) in enumerate(got["port"]):
        assert lv == level and shed == lanes[:level]
        assert verdicts == [i >= level for i in range(len(lanes))] + [True]


def test_shed_events_and_counters_like_the_jax_one():
    got = {}
    for name in TWINS:
        pk = edge(name)
        pk.flight.DEFAULT.clear()
        m = pk.metrics.MetricsRegistry()
        adm = _forced(pk, m, ("low", "high"), 1)
        out = [adm.admit("low", n=10), adm.admit("high", n=7),
               adm.admit("low", n=2)]
        snap = m.struct_snapshot()
        got[name] = (out, adm.counts(), snap["counters"], snap["gauges"],
                     _events(pk, "shed_level_change"))
    assert got["port"] == got["jax"]
    assert got["port"][1] == {"admitted": 7.0, "shed": {"low": 12.0}}


def test_inverted_band_and_bad_lanes_are_rejected_alike():
    for name in TWINS:
        pk = edge(name)
        with pytest.raises(ValueError, match="hysteresis band"):
            pk.overload.AdmissionController(
                pk.metrics.MetricsRegistry(), on_threshold=0.5,
                off_threshold=0.6)
        for lanes in ((), ("a", "a")):
            with pytest.raises(ValueError, match="bad lane set"):
                pk.overload.AdmissionController(
                    pk.metrics.MetricsRegistry(), lanes=lanes)


def test_summary_reads_a_struct_like_the_jax_one():
    got = {}
    for name in TWINS:
        pk = edge(name)
        m = pk.metrics.MetricsRegistry()
        adm = _forced(pk, m, ("low", "high"), 1)
        adm.admit("low", n=5)
        adm.admit("high", n=9)
        m.gauge("slo_deadline_ms").set(10.0)
        m.gauge("adaptive_batch").set(512.0)
        for v in (0.004, 0.004, 0.02):
            m.histogram("batch_latency_s").observe(v)
        got[name] = (pk.overload.summary(m.struct_snapshot()),
                     pk.overload.summary({"gauges": {}, "counters": {}}))
    assert got["port"] == got["jax"]
    assert got["port"][0]["shed_records"] == {"low": 5.0}
    assert got["port"][1] is None


# -- the block shed path -----------------------------------------------------------

# one pressure value a tick (the pipeline ticks once a drained batch):
# high long enough to climb one level, then calm back down
SCHEDULES = {
    "none": [0.0],
    "all": [1.0],
    "burst": [1.0] * 6 + [0.0] * 64,
}


def run_edge(name, model, X, schedule, ckdir=None, **kw):
    """A ``BlockPipeline`` over ``X`` in blocks of B with an admission
    controller on ``schedule`` (a fake clock advancing 1 s a call, so
    every drained batch ticks it) → (pipeline, deliveries, registry)."""
    pk = twin(name)
    ek = edge(name)
    m = pk.metrics.MetricsRegistry()
    t = [0.0]
    ticks = [0]

    def clock():
        t[0] += 1.0
        return t[0]

    def pressure():
        i = min(ticks[0], len(schedule) - 1)
        ticks[0] += 1
        return schedule[i]

    adm = ek.overload.AdmissionController(
        m, lanes=("block",), dwell_s=0.5, interval_s=0.1,
        on_threshold=0.8, off_threshold=0.3, pressure_fn=pressure,
        clock=clock,
    )
    out = []

    def sink(o, n, first):
        out.append((int(first), int(n), np.asarray(o)[:n].copy()))

    pipe = pk.block.BlockPipeline(
        pk.block.FiniteBlockSource(X, B), model, sink, cfg(pk),
        metrics=m, max_dispatch_chunks=1, admission=adm,
        checkpoint=(pk.checkpoint.CheckpointManager(ckdir)
                    if ckdir else None), **kw)
    pipe.run_until_exhausted(timeout=60)
    return pipe, out, m


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_block_shed_matches_the_jax_pipeline(schedule, models, tmp_path):
    X = data(24 * B, seed=5)
    runs = {}
    for name in TWINS:
        pipe, out, m = run_edge(name, models[name], X, SCHEDULES[schedule],
                                ckdir=str(tmp_path / name))
        c = m.struct_snapshot()["counters"]
        runs[name] = (out, pipe.committed_offset, {
            k: c.get(k, 0) for k in ('shed_records{lane="block"}',
                                     "admitted_records", "dispatches",
                                     "records_out")})
    (jo, jc, jk), (to, tc, tk) = runs["jax"], runs["port"]
    same_deliveries(to, jo)
    assert tc == jc == 24 * B  # shed offsets commit all the same
    assert tk == jk
    # a shed batch reaches no sink and launches nothing: the dispatches
    # are exactly the delivered batches
    assert tk["dispatches"] * B == tk["records_out"] == sum(
        n for _, n, _ in to)
    assert tk['shed_records{lane="block"}'] + tk["records_out"] == 24 * B
    cov = coverage(to, 24 * B)
    assert cov.max() <= 1
    if schedule == "burst":
        assert 0 < tk['shed_records{lane="block"}'] < 24 * B


def test_block_shed_launches_no_kernel(models, monkeypatch):
    """On the CPU the rank wire runs the kernel's plain version; a shed
    batch must not reach it (the wrapper's launch count on the card)."""
    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    calls = []
    real = qtrees_cuda.leaf_rows_reference

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(qtrees_cuda, "leaf_rows_reference", counted)
    pipe, out, m = run_edge("port", models["port"], data(16 * B, seed=6),
                            SCHEDULES["burst"])
    assert pipe.backend == "rank_wire_cuda_plain"
    c = m.struct_snapshot()["counters"]
    assert len(calls) == c["dispatches"] == len(out)
    assert c['shed_records{lane="block"}'] > 0


def test_a_refused_lane_sheds_drained_batches_unaggregated(models):
    """While its lane is refused the port sheds each drained batch on its
    own (no aggregation copies); admitted batches aggregate as before."""
    pk, ek = twin("port"), edge("port")
    m = pk.metrics.MetricsRegistry()
    adm = ek.overload.AdmissionController(
        m, lanes=("block",), on_threshold=0.85, off_threshold=0.55,
        pressure_fn=lambda: 0.7)  # inside the band: the level holds
    adm._level = 1
    calls = []
    pipe = pk.block.BlockPipeline(
        pk.block.FiniteBlockSource(data(32 * B), 8 * B), models["port"],
        lambda *a: None, cfg(pk), metrics=m, max_dispatch_chunks=8,
        admission=adm)
    real = pipe._aggregate_full_batches
    pipe._aggregate_full_batches = lambda *a: calls.append(1) or real(*a)
    pipe.run_until_exhausted(timeout=60)
    c = m.struct_snapshot()["counters"]
    assert calls == [] and c.get("dispatches", 0) == 0
    assert c['shed_records{lane="block"}'] == 32 * B
    assert pipe.committed_offset == 32 * B


def test_shed_lane_outside_the_controller_is_rejected_alike(models):
    for name in TWINS:
        pk, ek = twin(name), edge(name)
        adm = ek.overload.AdmissionController(
            ek.metrics.MetricsRegistry(), lanes=("low", "normal", "high"))
        with pytest.raises(ek.exceptions.InputValidationException,
                           match="could never shed"):
            pk.block.BlockPipeline(
                pk.block.FiniteBlockSource(data(B), B), models[name],
                lambda *a: None, admission=adm)


def test_batcher_caps_aggregation_on_the_port(models):
    """A batcher capped at one batch keeps every aggregated dispatch at
    one batch, on a pipeline allowed eight."""
    pk, ek = twin("port"), edge("port")
    m = pk.metrics.MetricsRegistry()
    b = ek.overload.AdaptiveBatcher(m, min_records=B, path=os.devnull)
    b.note_oom_cap(B)
    sizes = []
    pipe = pk.block.BlockPipeline(
        pk.block.FiniteBlockSource(data(64 * B), 4 * B), models["port"],
        lambda o, n, first: sizes.append(n), cfg(pk), metrics=m,
        max_dispatch_chunks=8, batcher=b)
    pipe.run_until_exhausted(timeout=60)
    assert sum(sizes) == 64 * B and max(sizes) == B
    assert b.state()["samples"] == len(sizes)
    assert m.snapshot()["adaptive_batch"] == float(B)


def test_oom_ladder_pins_the_batchers_cap_like_the_jax_one(
        models, tmp_path, monkeypatch):
    monkeypatch.setenv("FJT_FAILOVER_THRESHOLD", "10")
    got = {}
    for name in TWINS:
        pk, ek = twin(name), edge(name)
        pk.faults.inject("device_oom", site="device_dispatch", n=3)
        m = pk.metrics.MetricsRegistry()
        b = ek.overload.AdaptiveBatcher(m, min_records=1,
                                        path=str(tmp_path / f"{name}.json"))
        out = []
        pipe = pk.block.BlockPipeline(
            pk.block.FiniteBlockSource(data(20 * B, seed=12), B),
            models[name],
            lambda o, n, first: out.append(
                (int(first), int(n), np.asarray(o)[:n].copy())),
            cfg(pk), metrics=m, max_dispatch_chunks=1, batcher=b,
            checkpoint=pk.checkpoint.CheckpointManager(
                str(tmp_path / name)))
        pipe.run_until_exhausted(timeout=60)
        pk.faults.clear()
        got[name] = (b.max_records(), m.snapshot()["adaptive_batch"],
                     m.snapshot()["oom_shrinks"], out)
    assert got["port"][:3] == got["jax"][:3]
    # the launch, its full redispatch and the first half failed: the
    # largest run that fit is a half batch, and the cap pins there
    assert got["port"][0] == B // 2
    same_deliveries(got["port"][3], got["jax"][3])


# -- the scorer shed path ----------------------------------------------------------


def _scorers(gbm_path, level):
    """One JAX and one port ``DynamicScorer`` serving the GBM as "m",
    each with an admission controller forced to ``level``."""
    from flink_jpmml_tpu.models import control as jcontrol
    from flink_jpmml_tpu.runtime.sources import ControlSource as JControl
    from flink_jpmml_tpu.serving.scorer import DynamicScorer as JDynamic
    from flink_jpmml_tpu_torch.models import control as tcontrol
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    out = {}
    for name, dyn, ctrl_cls, control, kw in (
            ("jax", JDynamic, JControl, jcontrol, {}),
            ("port", DynamicScorer, ControlSource, tcontrol,
             {"device": "cpu"})):
        ek = edge(name)
        m = ek.metrics.MetricsRegistry()
        adm = _forced(ek, m, ("low", "normal", "high"), level)
        ctrl = ctrl_cls()
        sc = dyn(control=ctrl, batch_size=B, metrics=m, admission=adm,
                 **kw)
        ctrl.push(control.AddMessage("m", 1, gbm_path, time.time()))
        sc._drain_control()
        sc.registry.model(sc.registry.resolve("m", 1))  # join the warm
        out[name] = sc
    return out


def _lane_events(n, lane, seed):
    X = data(n, seed=seed)
    return [("m", {**{f"f{j}": float(v) for j, v in enumerate(row)
                      if not np.isnan(v)}, "_lane": lane})
            for row in X]


@pytest.mark.parametrize("level", [0, 1, 3])
def test_scorer_sheds_like_the_jax_one(level, gbm_path):
    sc = _scorers(gbm_path, level)
    events = (_lane_events(8, "low", 1) + _lane_events(8, "normal", 2)
              + _lane_events(8, "high", 3))
    res = {name: s.finish(s.submit(events)) for name, s in sc.items()}
    lanes = ["low", "normal", "high"]
    assert_same([p for p, _ in res["port"]], [p for p, _ in res["jax"]])
    for i, (p, _) in enumerate(res["port"]):
        assert p.is_empty == (lanes.index(events[i][1]["_lane"]) < level)
    assert sc["port"].admission.counts() == sc["jax"].admission.counts()
    disp = {n: s.metrics.struct_snapshot()["counters"].get("dispatches", 0)
            for n, s in sc.items()}
    # a micro-batch of shed events only dispatches nothing
    assert disp["port"] == disp["jax"] == (0 if level == 3 else 1)


def test_scorer_carries_an_slo_tracker_and_feeds_its_batcher(
        gbm_path, monkeypatch, tmp_path):
    from flink_jpmml_tpu_torch.serving.overload import AdaptiveBatcher

    monkeypatch.setenv("FJT_SLO_TARGET_MS", "50")
    sc = _scorers(gbm_path, 0)["port"]
    assert sc.slo.enabled and sc.slo.deadline_s == 0.05
    sc.batcher = AdaptiveBatcher(path=str(tmp_path / "cap.json"))
    sc.finish(sc.submit(_lane_events(12, "normal", 4)))
    assert sc.batcher.state()["sizes"] == {"12": 1}
    assert sc.metrics.snapshot()["slo_deadline_ms"] == 50.0
