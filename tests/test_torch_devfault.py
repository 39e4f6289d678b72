"""The device-fault ladder of the port on the CPU against the JAX
package's: the CUDA classification table, the ladder's
``redispatch_records`` / ``oom_shrinks`` / ``device_fault_total`` on both
hot paths, the circuit breaker's transitions under a fake clock, and the
one deliberate difference — the rank wire has no host tier in the port,
so where the JAX package's XLA-backend tier would serve a persistent
fault, the port escalates with a raise.

The same seeded records and the same fault plan drive both packages
(each through its own ``faults`` module); the port runs with
``device="cpu"``. Counts and offsets exactly, values at rtol 1e-4 /
atol 1e-5."""

import numpy as np
import pytest
import torch

from test_torch_checkpoint import (  # noqa: F401  (fixtures)
    ATOL,
    B,
    RTOL,
    TWINS,
    _clean_faults,
    cfg,
    counters,
    coverage,
    data,
    gbm_path,
    models,
    run_block,
    same_deliveries,
    twin,
    values,
)
from flink_jpmml_tpu_torch.compile.qtrees_cuda import (
    KernelBuildError,
    KernelLaunchError,
)
from flink_jpmml_tpu_torch.runtime import devfault, faults
from flink_jpmml_tpu_torch.runtime.dlq import PoisonIsolationOverflow
from flink_jpmml_tpu_torch.serving import failover
from flink_jpmml_tpu_torch.utils.exceptions import (
    DeviceUnavailableError,
    NativeBuildError,
    NotPortedError,
)

# -- classification -------------------------------------------------------------


def _cuda_error(text):
    """A ``torch.cuda.CudaError`` with the runtime's bare text (its own
    constructor asks the CUDA runtime for the text, absent on the CPU)."""
    e = torch.cuda.CudaError.__new__(torch.cuda.CudaError)
    RuntimeError.__init__(e, text)
    return e


CASES = {
    "injected_oom": (faults.InjectedDeviceOOM, "device_oom"),
    "injected_error": (faults.InjectedDeviceError, "device_error"),
    "injected_chip_loss": (faults.InjectedChipLoss, "chip_loss"),
    "injected_poison": (lambda: faults.InjectedPoisonRecord([3]), None),
    "torch_oom": (lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 64.00 TiB"), "device_oom"),
    "launch_2_allocation": (
        lambda: KernelLaunchError("x", cuda_error=2), "device_oom"),
    "launch_700_illegal_address": (
        lambda: KernelLaunchError("x", cuda_error=700), "chip_loss"),
    "launch_710_assert": (
        lambda: KernelLaunchError("x", cuda_error=710), "chip_loss"),
    "launch_719_launch_failure": (
        lambda: KernelLaunchError("x", cuda_error=719), "chip_loss"),
    "launch_1_invalid_value": (
        lambda: KernelLaunchError("x", cuda_error=1), "device_error"),
    "text_illegal_address": (lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
        "chip_loss"),
    "text_device_assert": (lambda: RuntimeError(
        "CUDA error: device-side assert triggered\nCUDA kernel errors "
        "might be asynchronously reported"), "chip_loss"),
    "text_out_of_memory": (lambda: RuntimeError(
        "CUDA error: out of memory"), "device_oom"),
    "text_other": (lambda: RuntimeError(
        "CUDA error: invalid configuration argument"), "device_error"),
    "cuda_error_type": (lambda: _cuda_error(
        "an illegal memory access was encountered (700)"), "chip_loss"),
    "kernel_build": (lambda: KernelBuildError("nvcc refused"), None),
    "native_build": (lambda: NativeBuildError("g++ refused"), None),
    "no_card": (lambda: DeviceUnavailableError("no card"), None),
    "not_ported": (lambda: NotPortedError("mesh= is not ported"), None),
    "plain_runtime_error": (lambda: RuntimeError("shape mismatch"), None),
    "value_error": (lambda: ValueError("bad record"), None),
    "isolation_overflow": (lambda: PoisonIsolationOverflow(
        3, RuntimeError("CUDA error: an illegal memory access")), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_classification_table(case):
    make, kind = CASES[case]
    assert devfault.classify(make()) == kind


@pytest.mark.parametrize("kind", ["device_oom", "device_error", "chip_loss"])
def test_injected_kinds_classify_as_in_the_jax_package(kind):
    from flink_jpmml_tpu.runtime import devfault as jdevfault
    from flink_jpmml_tpu.runtime import faults as jfaults

    cls = {"device_oom": "InjectedDeviceOOM",
           "device_error": "InjectedDeviceError",
           "chip_loss": "InjectedChipLoss"}[kind]
    assert devfault.classify(getattr(faults, cls)()) == \
        jdevfault.classify(getattr(jfaults, cls)()) == kind
    assert devfault.KINDS == jdevfault.KINDS


def test_note_books_the_same_counter():
    from flink_jpmml_tpu.runtime import devfault as jdevfault
    from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JReg
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry as TReg

    got = []
    for dv, reg in ((jdevfault, JReg()), (devfault, TReg())):
        dv.note(reg, "device_error", model="m", first_off=0, n=4)
        dv.note(reg, "device_error")
        got.append(reg.struct_snapshot()["counters"])
    assert got[0] == got[1] == {'device_fault_total{kind="device_error"}': 2}


# -- the circuit breaker ----------------------------------------------------------


def _breaker_trace(mod, reg):
    now = [0.0]
    b = mod.CircuitBreaker(reg, key="m", fail_threshold=3, cooldown_s=1.0,
                           probe_greens=2, clock=lambda: now[0])
    trace = []

    def step(what):
        if what == "fail":
            b.record_failure("device_error")
        elif what == "ok":
            b.record_success()
        elif what == "ask":
            trace.append(b.allow_dispatch())
        else:
            now[0] += what
        trace.append(b.state)

    for what in ("fail", "fail", "ok", "fail", "fail", "ask", "fail",
                 "ask", 0.5, "ask", 0.6, "ask", "fail", "ask", 1.1, "ask",
                 "ok", "ok", "ask", "fail"):
        step(what)
    return trace, reg.struct_snapshot()["gauges"]


def test_breaker_transitions_match_under_a_fake_clock():
    from flink_jpmml_tpu.serving import failover as jfailover
    from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JReg
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry as TReg

    j = _breaker_trace(jfailover, JReg())
    t = _breaker_trace(failover, TReg())
    assert t == j
    states = t[0]
    assert failover.STATE_OPEN in states and failover.STATE_HALF_OPEN in states
    assert states[-1] == failover.STATE_CLOSED  # re-closed, then one strike


def test_plane_accounting_matches(monkeypatch):
    from flink_jpmml_tpu.serving import failover as jfailover
    from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JReg
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry as TReg

    monkeypatch.setenv("FJT_DEVICE_RETRIES", "5")
    out = []
    for mod, reg in ((jfailover, JReg()), (failover, TReg())):
        plane = mod.plane_for(reg)
        assert plane is mod.plane_for(reg) and plane.retries == 5
        plane.note_fault("device_oom", "m", first_off=0, n=8)
        plane.note_fallback(8, "m")
        plane.redispatch_records.inc(8)
        plane.oom_shrinks.inc()
        out.append(mod.summary(reg.struct_snapshot()))
    assert out[0] == out[1]
    assert failover.plane_for(None) is None


# -- the host tier -------------------------------------------------------------


def test_rank_wire_has_no_host_tier(models):
    from flink_jpmml_tpu_torch.runtime.block import BoundScorer

    bound = BoundScorer("static", models["port"], use_quantized=True)
    assert bound.q is not None
    tier = failover.FallbackTier()
    assert not tier.supports(bound)
    with pytest.raises(failover.FallbackUnavailable):
        tier.score_bound(bound, data(B))


def test_f32_host_tier_serves_only_when_asked(models):
    from flink_jpmml_tpu_torch.runtime.block import BoundScorer

    cm = models["port"]
    bound = BoundScorer("static", cm, use_quantized=False)
    asked, dlq_only = failover.FallbackTier(), failover.FallbackTier(False)
    assert asked.supports(bound) and not dlq_only.supports(bound)
    with pytest.raises(failover.FallbackUnavailable):
        dlq_only.score_bound(bound, data(B))
    X = data(B, seed=11)
    host = bound.decode(asked.score_bound(bound, X), B)
    M = np.isnan(X)
    ref = cm.decode(cm.predict(np.where(M, 0.0, X), M), B)
    np.testing.assert_allclose(values(host), values(ref), rtol=RTOL,
                               atol=ATOL)
    assert cm._fjt_cpu_params is not None  # the CPU copy, cached


def test_plane_armed_by_a_dlq_alone_serves_nothing(models, tmp_path,
                                                   monkeypatch):
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager

    def pipe(d):
        return BlockPipeline(FiniteBlockSource(data(B), B), models["port"],
                             lambda *a: None, use_quantized=False,
                             checkpoint=CheckpointManager(d))

    assert not pipe(str(tmp_path / "a"))._failover.tier.serve
    monkeypatch.setenv("FJT_FAILOVER", "1")
    assert pipe(str(tmp_path / "b"))._failover.tier.serve


# -- the block ladder ---------------------------------------------------------------


def _ladder(models, tmp_path, plan, chunks=1, n=20 * B, **kw):
    runs = {}
    for name in TWINS:
        pk = twin(name)
        for kind, params in plan:
            pk.faults.inject(kind, **params)
        m = pk.metrics.MetricsRegistry()
        pipe, out = run_block(pk, models[name], data(n, seed=12),
                              str(tmp_path / name), metrics=m,
                              chunks=chunks, **kw)
        c = counters(m)
        runs[name] = ({k: c.get(k, 0) for k in (
            "redispatch_records", "oom_shrinks", "fallback_records",
            'device_fault_total{kind="device_error"}',
            'device_fault_total{kind="device_oom"}',
            'device_fault_total{kind="chip_loss"}')},
            pk.faults.stats(), out, sorted(pipe._dlq.offsets()))
        pk.faults.clear()
    return runs


def test_transient_error_redispatches_like_the_jax_package(models,
                                                           tmp_path):
    runs = _ladder(models, tmp_path,
                   [("device_error", {"site": "device_readback", "n": 1})])
    assert runs["port"][:2] == runs["jax"][:2]
    assert runs["port"][0]["redispatch_records"] == B
    assert runs["port"][0]["fallback_records"] == 0
    assert runs["port"][3] == runs["jax"][3] == []  # nothing quarantined
    same_deliveries(runs["port"][2], runs["jax"][2])
    assert (coverage(runs["port"][2], 20 * B) == 1).all()


def test_oom_bisects_like_the_jax_package(models, tmp_path, monkeypatch):
    # the launch fails, its full redispatch fails, one half fails: the
    # bisection splits down to quarters. Three strikes would open the
    # circuit, and the JAX package's XLA tier would then serve the rest
    # (the port's rank wire keeps to the card; see the escalation test
    # below): the threshold is raised on both so the ladder alone is
    # compared
    monkeypatch.setenv("FJT_FAILOVER_THRESHOLD", "10")
    runs = _ladder(models, tmp_path,
                   [("device_oom", {"site": "device_dispatch", "n": 3})])
    assert runs["port"][:2] == runs["jax"][:2]
    assert runs["port"][0]["oom_shrinks"] == 1
    assert runs["port"][0]['device_fault_total{kind="device_oom"}'] == 3
    assert runs["port"][3] == []
    same_deliveries(runs["port"][2], runs["jax"][2])


def test_transient_error_inside_the_oom_bisection_redispatches(
        models, tmp_path, monkeypatch):
    """An OOM, then a device_error streak the bisection meets: the JAX
    package bisects each slice on to one record, which its XLA tier
    serves; the port's rank wire has no host tier, so a transient error
    in the bisection sends the slice to the transient rung (re-dispatch
    under the backoff) instead of raising at one record. Both deliver
    every record once and quarantine nothing."""
    monkeypatch.setenv("FJT_FAILOVER_THRESHOLD", "100")
    monkeypatch.setenv("FJT_DEVICE_RETRIES", "9")
    runs = _ladder(models, tmp_path, [
        ("device_oom", {"site": "device_dispatch", "n": 1}),
        ("device_error", {"site": "device_readback", "n": 8}),
    ])
    for name in TWINS:
        assert (coverage(runs[name][2], 20 * B) == 1).all(), name
        assert runs[name][3] == [], name
        assert runs[name][1] == {"device_oom": 1, "device_error": 8}, name
    port = runs["port"][0]
    assert port["fallback_records"] == 0
    assert port["oom_shrinks"] == 1
    assert port["redispatch_records"] == B

    def by_offset(out):
        got = np.empty(20 * B, np.float32)
        for off, n, v in out:
            got[off:off + n] = v
        return got

    np.testing.assert_allclose(by_offset(runs["port"][2]),
                               by_offset(runs["jax"][2]),
                               rtol=RTOL, atol=ATOL)


def test_poison_beside_device_errors_quarantines_exactly(models, tmp_path):
    runs = _ladder(models, tmp_path, [
        ("poison_record", {"offset": 100}),
        ("device_error", {"site": "device_readback", "n": 2}),
    ])
    assert runs["port"][:2] == runs["jax"][:2]
    assert runs["port"][3] == runs["jax"][3] == [100]
    same_deliveries(runs["port"][2], runs["jax"][2])


def test_chip_loss_escalates_on_both(models, tmp_path):
    got = {}
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("chip_loss", n=1)
        m = pk.metrics.MetricsRegistry()
        run_block(pk, models[name], data(10 * B), str(tmp_path / name),
                  metrics=m, expect=pk.faults.InjectedChipLoss)
        c = counters(m)
        # (the raise leaves the ladder inside the next launch's trim, and
        # the score loop books it once more against that launch: the
        # JAX package counts the same)
        got[name] = c.get('device_fault_total{kind="chip_loss"}')
        assert c.get("redispatch_records", 0) == 0
        pk.faults.clear()
    assert got["port"] == got["jax"] >= 1


def test_fail_fast_without_a_plane_on_both(models):
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("device_error", n=1)
        run_block(pk, models[name], data(4 * B), None,
                  expect=pk.faults.InjectedDeviceError)
        pk.faults.clear()


def test_rank_wire_escalates_where_the_jax_xla_tier_serves(models,
                                                           tmp_path):
    """The deliberate difference: a persistent device error exhausts the
    retries. The JAX package's rank wire runs on XLA, whose host tier
    serves the batch (``fallback_records`` > 0); the port's rank wire has
    no host tier (its kernel is never replaced by the plain version on a
    live pipeline), so the ladder re-raises the error."""
    plan = [("device_error", {"site": "device_readback", "n": 50})]
    X = data(8 * B, seed=13)
    jpk, tpk = twin("jax"), twin("port")
    for pk in (jpk, tpk):
        for kind, params in plan:
            pk.faults.inject(kind, **params)
    jm, tm = jpk.metrics.MetricsRegistry(), tpk.metrics.MetricsRegistry()
    jpipe, jout = run_block(jpk, models["jax"], X, str(tmp_path / "j"),
                            metrics=jm)
    assert counters(jm).get("fallback_records", 0) > 0
    assert (coverage(jout, len(X)) == 1).all()
    tpipe, tout = run_block(tpk, models["port"], X, str(tmp_path / "t"),
                            metrics=tm, expect=faults.InjectedDeviceError)
    c = counters(tm)
    assert c.get("fallback_records", 0) == 0
    # one strike and two retries for the failed batch (and, as in the JAX
    # package, the raise leaves through the next launch, whose batch
    # runs the ladder once more before the pipeline stops)
    assert c.get('device_fault_total{kind="device_error"}') >= 3
    assert c.get("redispatch_records", 0) == 0
    assert tpipe._failover.tier.supports(tpipe._bound) is False
    # nothing was delivered twice, and nothing past the failed batch
    cov = coverage(tout, len(X))
    assert cov.max() <= 1 and tpipe.committed_offset <= B


def test_f32_model_serves_on_the_host_tier_when_asked(models, tmp_path,
                                                      monkeypatch):
    """``FJT_FAILOVER=1`` on an f32 pipeline: a persistent device error
    trips the breaker and the host tier serves, as in the JAX package."""
    monkeypatch.setenv("FJT_FAILOVER", "1")
    X = data(12 * B, seed=14)
    runs = {}
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("device_error", site="device_readback", n=6)
        m = pk.metrics.MetricsRegistry()
        out = []
        pipe = pk.block.BlockPipeline(
            pk.block.FiniteBlockSource(X, B), models[name],
            lambda o, n, f: out.append((int(f), int(n))), cfg(pk),
            metrics=m, use_quantized=False, max_dispatch_chunks=1)
        pipe.run_until_exhausted(timeout=60)
        c = counters(m)
        runs[name] = (c.get("fallback_records", 0) > 0,
                      c.get('device_fault_total{kind="device_error"}'),
                      sorted(out))
        pk.faults.clear()
    assert runs["port"] == runs["jax"]
    assert runs["port"][0]


# -- the record engine's ladder and the dynamic scorer's -----------------------------


def _records(pk, model, recs, ckdir=None):
    sink = pk.sinks.CollectSink()
    m = pk.metrics.MetricsRegistry()
    pipe = pk.engine.Pipeline(
        pk.sources.InMemorySource(recs), pk.engine.StaticScorer(model),
        sink, cfg(pk, 0.05), metrics=m,
        checkpoint=(pk.checkpoint.CheckpointManager(ckdir)
                    if ckdir else None))
    return pipe, sink, m


@pytest.mark.parametrize("plan", [
    [("device_error", {"site": "device_readback", "n": 1})],
    [("device_oom", {"site": "device_readback", "n": 3})],
], ids=["error", "oom"])
def test_record_engine_ladder_matches(models, tmp_path, plan):
    recs = [list(map(float, r)) for r in data(96, seed=15)]
    runs = {}
    for name in TWINS:
        pk = twin(name)
        for kind, params in plan:
            pk.faults.inject(kind, **params)
        pipe, sink, m = _records(pk, models[name], recs,
                                 str(tmp_path / name))
        pipe.run_until_exhausted(timeout=60)
        c = counters(m)
        runs[name] = ({k: v for k, v in c.items()
                       if k.startswith("device_fault") or k ==
                       "redispatch_records"}, values(sink.items),
                      list(pipe._dlq.offsets()))
        pk.faults.clear()
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][0]["redispatch_records"] > 0
    assert runs["port"][2] == runs["jax"][2] == []
    assert len(runs["port"][1]) == len(recs)
    np.testing.assert_allclose(runs["port"][1], runs["jax"][1], rtol=RTOL,
                               atol=ATOL)


def test_record_engine_unarmed_fails_fast_and_chip_loss_escalates(
        models, tmp_path):
    recs = [list(map(float, r)) for r in data(64, seed=16)]
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("device_error", n=1)
        pipe, _, _ = _records(pk, models[name], recs)
        with pytest.raises(pk.faults.InjectedDeviceError):
            pipe.run_until_exhausted(timeout=60)
        pk.faults.clear()
        pk.faults.inject("chip_loss", n=1)
        pipe, _, _ = _records(pk, models[name], recs, str(tmp_path / name))
        with pytest.raises(pk.faults.InjectedChipLoss):
            pipe.run_until_exhausted(timeout=60)
        pk.faults.clear()


def test_dispatcher_on_error_hook_handles_or_reraises():
    from flink_jpmml_tpu_torch.runtime.pipeline import (
        DeviceOutput,
        OverlappedDispatcher,
    )

    seen, done = [], []
    disp = OverlappedDispatcher(
        depth=1, complete=lambda out, meta: done.append(meta),
        on_error=lambda out, meta, e: seen.append((meta, type(e))) or
        meta == "handled")
    faults.inject("device_error", n=1)
    disp.launch(lambda: DeviceOutput(torch.zeros(1)), meta="handled")
    disp.launch(lambda: DeviceOutput(torch.zeros(1)), meta="next")
    disp.flush()
    assert seen == [("handled", faults.InjectedDeviceError)]
    assert done == ["next"]  # the handled entry skipped its completion
    faults.clear()
    faults.inject("device_error", n=1)
    disp.launch(lambda: DeviceOutput(torch.zeros(1)), meta="raised")
    with pytest.raises(faults.InjectedDeviceError):
        disp.launch(lambda: DeviceOutput(torch.zeros(1)), meta="after")
    faults.clear()
    faults.inject("device_oom", site="device_dispatch", n=1)
    with pytest.raises(faults.InjectedDeviceOOM):
        disp.launch(lambda: DeviceOutput(torch.zeros(1)))
