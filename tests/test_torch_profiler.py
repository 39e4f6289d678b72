"""The port's sampled device profiler (``flink_jpmml_tpu_torch/obs/
profiler.py``), ``attr.dispatch_profile`` and the dispatcher's sampling,
on the CPU.

Mirrors the profiler cases of the JAX package's ``tests/test_attr.py``.
What a sample counts: for a ``cuda`` scorer (the walk kernel) the walk's
integer steps per record (the sum of the trees' depths) and the bytes the
kernel moves (its codes in, its f32 row out), held to the H100 row's
INT32 rate and HBM3 bandwidth; for the torch twin the JAX package's
path-matrix count, equal to the JAX function's for the same model. The
dispatcher takes a sample from the region the scorer marks, the one the
kernel search times (on the card an event pair, here fakes of CUDA
events or the host clock), when the dispatch completes, and adds no
wait: host work around the region is not device time, so a tuned
scorer's samples agree with its sweep and its prediction. The cost
ledger writes off the recording thread, to the path of the moment."""

import os

import math
import time

import numpy as np
import pytest
import torch

from flink_jpmml_tpu.compile.qtrees import build_quantized_scorer as jax_bqs
from flink_jpmml_tpu.obs import attr as jattr
from flink_jpmml_tpu.pmml import parse_pmml as jparse
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse_file
from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_vote_forest
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.compile.qtrees import build_quantized_scorer
from flink_jpmml_tpu_torch.obs import attr, profiler
from flink_jpmml_tpu_torch.pmml import parse_pmml, parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, FiniteBlockSource
from flink_jpmml_tpu_torch.runtime.pipeline import (
    DeviceOutput,
    OverlappedDispatcher,
)
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
from flink_jpmml_tpu_torch.utils.metrics import Histogram, MetricsRegistry
from test_layouts import stump_forest_xml


def _profile(records=1000):
    return {"records": records, "flops_per_record": 1280.0,
            "bytes_per_record": 6.0, "model": "m", "backend": "cuda"}


def _prof(tmp_path, interval=0.0, clock=time.monotonic):
    m = MetricsRegistry()
    return m, profiler.DeviceProfiler(
        m, interval_s=interval, clock=clock,
        cost_ledger=profiler.KernelCostLedger(path=str(tmp_path / "kc.json")))


class TestPeaksAndRoofline:
    def test_the_h100_row(self):
        assert profiler.chip_peaks("NVIDIA H100 80GB HBM3") == (1.67e13,
                                                               3.35e12)
        assert profiler.chip_peaks("NVIDIA H100 80GB HBM3", strict=True) \
            == (1.67e13, 3.35e12)
        # 132 SMs × 64 INT32 lanes × 1.98 GHz
        assert 132 * 64 * 1.98e9 == pytest.approx(1.67e13, rel=2e-3)

    def test_unknown_kinds_strict_fallback_and_env(self, monkeypatch):
        assert profiler.chip_peaks("TPU v4", strict=True) is None
        assert profiler.chip_peaks("", strict=True) is None
        assert profiler.chip_peaks("weird chip") == (1e12, 100e9)
        monkeypatch.setenv("FJT_PROF_PEAKS", "2e12,5e11")
        assert profiler.chip_peaks("weird chip") == (2e12, 5e11)
        monkeypatch.setenv("FJT_PROF_PEAKS", "garbage")
        assert profiler.chip_peaks("weird chip") == (1e12, 100e9)

    def test_roofline_math(self):
        mfu, membw = profiler.roofline(1e6, 1280.0, 6.0, (1e12, 1e9))
        assert mfu == pytest.approx(1.28e-3)
        assert membw == pytest.approx(6e-3)
        assert profiler.roofline(0.0, 1.0, 1.0, (1e12, 1e9)) == (None, None)
        assert profiler.roofline(1e6, None, None, (1e12, 1e9)) == \
            (None, None)


class TestDispatchProfile:
    @pytest.mark.parametrize("kind", ["gbm", "votes"])
    def test_cuda_scorer_counts_path_steps_and_kernel_bytes(self, tmp_path,
                                                           kind):
        if kind == "gbm":
            path = gen_gbm(str(tmp_path), n_trees=12, depth=5, n_features=8)
            C = 1
        else:
            path = gen_vote_forest(str(tmp_path), n_trees=12, depth=4,
                                   n_features=8, n_classes=3, seed=2)
            C = 3
        q = build_quantized_scorer(parse_pmml_file(path), batch_size=64,
                                   device="cpu")
        assert q.backend == "cuda_plain"
        walk = q.params["walk"]
        steps = float(((walk[:, 0] >> 8) & 0xFF).sum())
        p = attr.dispatch_profile(q, 64)
        assert p["records"] == 64
        assert p["flops_per_record"] == steps
        assert p["bytes_per_record"] == 8.0 + 4.0 * C
        assert p["model"] == p["model_hash"] == q.model_hash
        assert (p["backend"], p["platform"]) == ("cuda_plain", "cpu:cpu")
        # not the dense path-matrix count the JAX package states
        jq = jax_bqs(jparse_file(path), batch_size=64)
        assert jattr._scorer_flops_per_record(jq) != steps

    def test_torch_twin_counts_the_jax_path_matrix(self):
        xml = stump_forest_xml()
        q = build_quantized_scorer(parse_pmml(xml), batch_size=32,
                                   device="cpu")
        jq = jax_bqs(jparse(xml), batch_size=32, backend="xla")
        assert q.backend == "torch"
        p = attr.dispatch_profile(q, 32)
        assert p["flops_per_record"] == jattr._scorer_flops_per_record(jq)
        assert p["bytes_per_record"] == 4.0 + 4.0  # uint16 × 2, f32 out

    def test_f32_fallback_is_honest(self):
        p = attr.dispatch_profile(object(), 32)
        assert p["records"] == 32
        assert p["flops_per_record"] is None and p["bytes_per_record"] is None


class TestSampler:
    def test_sample_feeds_gauges_device_stage_and_ledger(self, tmp_path):
        m, prof = _prof(tmp_path)
        prof.record_sample(0.001, _profile(), overhead_s=0.0)
        snap = m.struct_snapshot()
        assert snap["counters"]["device_samples"] == 1
        assert snap["gauges"]["device_ns_per_record"]["value"] == \
            pytest.approx(1000.0)
        assert snap["gauges"]["flops_per_record"]["value"] == 1280.0
        assert snap["gauges"]["device_mfu"]["value"] > 0
        assert snap["gauges"]["device_membw_util"]["value"] > 0
        h = Histogram.from_state(
            snap["histograms"][attr.stage_metric_name("device")])
        assert h.count() == 1
        (e,) = prof.cost_ledger.entries().values()
        assert e["device_s_per_record"] == pytest.approx(1e-6)

    def test_disabled_by_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FJT_PROF_SAMPLE", "off")
        m = MetricsRegistry()
        prof = profiler.DeviceProfiler(m)
        assert not prof.enabled and not prof.should_sample()
        assert not OverlappedDispatcher(metrics=m, profiler=prof).profiling

    def test_rate_limited(self, tmp_path):
        # an injected clock two intervals in: the limit holds whatever the
        # host's own uptime (time.monotonic starts near boot)
        now = [7200.0]
        m, prof = _prof(tmp_path, interval=3600.0, clock=lambda: now[0])
        assert prof.should_sample()
        assert not prof.should_sample()
        now[0] += 3599.0
        assert not prof.should_sample()
        now[0] += 1.0
        assert prof.should_sample()

    @pytest.mark.parametrize("start", [0.0, 1800.0, 3599.0, 3600.0])
    def test_first_claim_on_a_fresh_clock_is_the_jax_one(self, tmp_path,
                                                         start):
        """The first claim counts from a last sample at 0 on the
        profiler's clock, in both packages: a clock that starts below one
        interval claims nothing until it reaches it."""
        from flink_jpmml_tpu.obs import profiler as jprofiler
        from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JReg

        now = [start]
        _, prof = _prof(tmp_path, interval=3600.0, clock=lambda: now[0])
        jprof = jprofiler.DeviceProfiler(
            JReg(), interval_s=3600.0, clock=lambda: now[0],
            cost_ledger=jprofiler.KernelCostLedger(
                path=str(tmp_path / "jkc.json")))
        first = [prof.should_sample(), jprof.should_sample()]
        assert first == [start >= 3600.0] * 2
        now[0] = 3600.0
        assert prof.should_sample() == jprof.should_sample() == (
            start < 3600.0)


class _Event:
    """A fired CUDA event's stand-in: ``elapsed_time`` in ms, as torch's."""

    def __init__(self, t_ms=0.0):
        self.t_ms = t_ms

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


def _mark_on_card(start_ms, stop_ms):
    """What the scorer's marks leave on the card: an event pair."""
    marks = profiler.active_sample()
    marks.device = torch.device("cuda")
    marks.start, marks.stop = _Event(start_ms), _Event(stop_ms)


class TestDispatcherSampling:
    def test_event_pair_is_the_sample_and_host_work_is_not(self, tmp_path):
        m, prof = _prof(tmp_path, interval=1e-9)
        disp = OverlappedDispatcher(depth=2, metrics=m, profiler=prof)

        def dispatch():
            time.sleep(0.05)  # host staging before the device work
            _mark_on_card(5.0, 20.0)  # the kernel's region
            return DeviceOutput(torch.zeros(4), _Event(30.0))

        disp.launch(dispatch, profile=_profile())
        assert m.struct_snapshot()["counters"].get("device_samples", 0) == 0
        disp.close()  # the sample is read at completion
        dev = m.struct_snapshot()["histograms"][
            attr.stage_metric_name("device")]
        assert dev["n"] == 1 and dev["sum"] == pytest.approx(0.015)

    def test_no_profile_no_sample_and_shed_entries_never_sample(
            self, tmp_path):
        m, prof = _prof(tmp_path, interval=1e-9)
        disp = OverlappedDispatcher(depth=2, metrics=m, profiler=prof)
        disp.launch(lambda: DeviceOutput(torch.zeros(4)))
        disp.launch(lambda: None, profile=_profile(), accounted=False)
        disp.close()
        assert m.struct_snapshot()["counters"].get("device_samples", 0) == 0

    def test_cpu_dispatch_is_timed_on_the_host(self, tmp_path):
        m, prof = _prof(tmp_path, interval=1e-9)
        disp = OverlappedDispatcher(depth=0, metrics=m, profiler=prof)
        cpu = torch.device("cpu")

        def dispatch():
            time.sleep(0.3)  # host encode: outside the region
            profiler.mark_start(cpu)
            time.sleep(0.02)
            profiler.mark_stop(cpu)
            return DeviceOutput(torch.zeros(4))

        disp.launch(dispatch, profile=_profile())
        dev = m.struct_snapshot()["histograms"][
            attr.stage_metric_name("device")]
        assert dev["n"] == 1 and 0.02 <= dev["sum"] < 0.3

    def test_unmarked_or_elsewhere_scored_dispatch_takes_no_sample(
            self, tmp_path):
        m, prof = _prof(tmp_path, interval=1e-9)
        disp = OverlappedDispatcher(depth=0, metrics=m, profiler=prof)
        on_card = dict(_profile(), platform="cuda:NVIDIA_H100_80GB_HBM3")
        disp.launch(lambda: DeviceOutput(torch.zeros(4)), profile=on_card)

        def host_tier():
            # a host tier scoring in the card's stead marks the CPU
            profiler.mark_start(torch.device("cpu"))
            profiler.mark_stop(torch.device("cpu"))
            return DeviceOutput(torch.zeros(4))

        disp.launch(host_tier, profile=on_card)
        disp.close()
        assert m.struct_snapshot()["counters"].get("device_samples", 0) == 0
        assert profiler.active_sample() is None

    def test_region_the_sweep_did_not_time_trains_nothing(self, tmp_path):
        m, prof = _prof(tmp_path, interval=1e-9)
        disp = OverlappedDispatcher(depth=0, metrics=m, profiler=prof)
        p = dict(_profile(), variant="torch_ref", features={"depth": 3.0},
                 predicted_s_per_record=1e-12)

        def dispatch():
            _mark_on_card(0.0, 10.0)
            profiler.active_sample().sweep_region = False
            return DeviceOutput(torch.zeros(4))

        for _ in range(4):
            disp.launch(dispatch, profile=p)
        snap = m.struct_snapshot()
        assert snap["counters"]["device_samples"] == 4
        assert "kernel_pred_error" not in snap["gauges"]
        (e,) = prof.cost_ledger.entries().values()
        assert "features" not in e and "variant" not in e

    def test_block_pipeline_profiles_its_dispatches(self, tmp_path,
                                                    monkeypatch):
        monkeypatch.setenv("FJT_PROF_SAMPLE", "1e-9")
        path = gen_gbm(str(tmp_path), n_trees=8, depth=4, n_features=6)
        cm = compile_pmml(parse_pmml_file(path), batch_size=256,
                          device="cpu")
        q = cm.quantized_scorer()
        X = np.random.default_rng(1).normal(0, 1.5, (2048, 6)).astype(
            np.float32)
        got = []
        m = MetricsRegistry()
        pipe = BlockPipeline(
            FiniteBlockSource(X, block_size=512), cm,
            lambda out, n, off: got.append((off, np.asarray(out)[:n])),
            RuntimeConfig(batch=BatchConfig(size=256, deadline_us=2000)),
            metrics=m)
        pipe.run_until_exhausted(timeout=60)
        assert sum(len(v) for _, v in got) == 2048
        snap = m.struct_snapshot()
        assert snap["counters"]["device_samples"] >= 1
        steps = q._meta["path_steps"]
        assert snap["gauges"]["flops_per_record"]["value"] == steps
        assert attr.stage_metric_name("device") in snap["histograms"]
        rows = [e for e in profiler._COST_LEDGER.entries().values()
                if e.get("model") == "static"
                and e.get("backend") == "cuda_plain"]
        assert rows and rows[0]["flops_per_record"] == steps
        assert rows[0]["platform"] == "cpu:cpu"


class _FakeClock:
    """``time.perf_counter`` that moves only by the work a test books."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def test_tuned_scorer_samples_agree_with_its_sweep(tmp_path, monkeypatch):
    """A tuned scorer served through the dispatcher: its samples time the
    region its sweep timed, not the host encode around it, so with a
    kernel-only prediction equal to the sweep's reading the drift band
    never fires, the cache entry and the cost-model fit stay, and the
    ledger row for the serving variant keeps the sweep's value. The
    clock moves 1 µs a record scored and 1 s an encode, so a sample of
    the whole dispatch would sit some 250× outside the band."""
    from flink_jpmml_tpu_torch.compile import autotune, costmodel, qtrees_cuda
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized

    clock = _FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    reference = qtrees_cuda.leaf_rows_reference

    def timed_reference(codes, tables):
        clock.advance(1e-6 * codes.shape[0])
        return reference(codes, tables)

    monkeypatch.setattr(qtrees_cuda, "leaf_rows_reference", timed_reference)
    path = gen_gbm(str(tmp_path), n_trees=12, depth=4, n_features=6)
    q = build_quantized_scorer(parse_pmml_file(path), batch_size=4096,
                               device="cpu")
    X = np.random.default_rng(5).normal(0, 1.5, (4096, 6)).astype(np.float32)
    cfg = autotune.ensure_tuned(q, X, top_k=3)
    chosen = cfg.search["chosen"]
    sweep_s = 1.0 / cfg.rates[chosen]
    assert sweep_s == pytest.approx(1e-6)
    key = f"{q.model_hash}|{q.backend}|{chosen}"
    assert profiler.read_ledger()[key]["device_s_per_record"] == \
        pytest.approx(sweep_s)
    # the kernel-only prediction the live band verifies
    q._pred_s_per_record = sweep_s
    q.encode_mode = "host"
    pack = q.pack_wire

    def slow_pack(Xq):
        clock.advance(1.0)  # host work of the dispatch
        return pack(Xq)

    q.pack_wire = slow_pack
    gen0 = costmodel.generation()
    m = MetricsRegistry()
    prof = profiler.DeviceProfiler(m, interval_s=1e-9,
                                   cost_ledger=profiler.KernelCostLedger(
                                       flush_interval_s=math.inf))
    disp = OverlappedDispatcher(depth=1, metrics=m, profiler=prof)
    for _ in range(5):
        disp.launch(lambda: dispatch_quantized(q, X, metrics=m),
                    profile=attr.dispatch_profile(q, X.shape[0]))
    disp.close()
    snap = m.struct_snapshot()
    assert snap["counters"]["device_samples"] == 5
    assert snap["gauges"]["kernel_pred_error"]["value"] == \
        pytest.approx(0.0, abs=1e-9)
    assert snap["gauges"]["device_ns_per_record"]["value"] == \
        pytest.approx(1e3)
    assert costmodel.generation() == gen0
    assert autotune.lookup(q.model_hash, autotune.backend_key(q)) is not None
    row = profiler.read_ledger()[key]
    assert row["device_s_per_record"] == pytest.approx(sweep_s)
    assert row["samples"] > 1


class TestLedgerWrites:
    def test_written_off_the_recording_thread(self, tmp_path):
        path = str(tmp_path / "kc.json")
        led = profiler.KernelCostLedger(path=path, flush_interval_s=0.2)
        led.update("m", "cuda", 0.1, 100, None, None)
        assert not os.path.exists(path)  # no write on the caller's thread
        deadline = time.monotonic() + 30
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert profiler.read_ledger(path)["m|cuda"]["samples"] == 1
        while led._flusher is not None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert led._flusher is None  # the writer ends when idle

    def test_path_is_resolved_at_each_write(self, tmp_path, monkeypatch):
        led = profiler.KernelCostLedger(flush_interval_s=math.inf)
        for name in ("a", "b"):
            monkeypatch.setenv("FJT_AUTOTUNE_CACHE",
                               str(tmp_path / name / "autotune.json"))
            led.update(name, "cuda", 0.1, 100, None, None)
            led.flush()
            assert f"{name}|cuda" in profiler.read_ledger()
        assert os.path.dirname(profiler.cost_ledger_path()) == str(
            tmp_path / "b")

    def test_a_dispatcher_writes_its_ledger_at_close(self, tmp_path):
        path = str(tmp_path / "kc.json")
        m = MetricsRegistry()
        prof = profiler.DeviceProfiler(
            m, interval_s=1e-9, cost_ledger=profiler.KernelCostLedger(
                path=path, flush_interval_s=3600.0))
        disp = OverlappedDispatcher(depth=0, metrics=m, profiler=prof)

        def dispatch():
            _mark_on_card(0.0, 1.0)
            return DeviceOutput(torch.zeros(4))

        disp.launch(dispatch, profile=_profile())
        assert not os.path.exists(path)
        disp.close()
        assert "m|cuda" in profiler.read_ledger(path)


def _timed_plain_kernel(monkeypatch, clock):
    """The kernel's plain version, booked at 1 µs a record on ``clock``."""
    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    reference = qtrees_cuda.leaf_rows_reference

    def timed_reference(codes, tables):
        clock.advance(1e-6 * codes.shape[0])
        return reference(codes, tables)

    monkeypatch.setattr(qtrees_cuda, "leaf_rows_reference", timed_reference)


@pytest.mark.parametrize("zoo", [False, True])
def test_dynamic_scorer_samples_its_launches_like_the_block_path(
        tmp_path, monkeypatch, zoo):
    """The dynamic scorer's launches (a group's solo launch, and with the
    zoo a pack's) carry their dispatch profile, and the sample times the
    region the scorer marks — the kernel on codes on the device — not the
    host encode around it: the clock moves 1 µs a record scored and 1 s
    an encode, so a whole-dispatch sample would read some 10^4 times
    more."""
    from flink_jpmml_tpu_torch.compile.qtrees import QuantizedWire
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    clock = _FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    _timed_plain_kernel(monkeypatch, clock)
    encode = QuantizedWire.encode

    def slow_encode(self, X, M=None):
        clock.advance(1.0)  # host work of the dispatch
        return encode(self, X, M)

    monkeypatch.setattr(QuantizedWire, "encode", slow_encode)
    monkeypatch.setenv("FJT_PROF_SAMPLE", "1e-9")
    ctrl = ControlSource()
    m = MetricsRegistry()
    sc = DynamicScorer(control=ctrl, batch_size=64, device="cpu", metrics=m,
                       async_warmup=False, zoo=zoo)
    assert sc._dispatcher.profiling
    names = ("g0", "g1")
    for i, name in enumerate(names):
        path = gen_gbm(str(tmp_path), n_trees=4 + i, depth=3, n_features=4,
                       seed=i, name=name)
        ctrl.push(AddMessage(name, 1, path, timestamp=1.0))
    rng = np.random.default_rng(2)
    events = [(names[i % 2], {f"f{j}": float(v) for j, v in
                              enumerate(rng.normal(size=4))})
              for i in range(128)]  # a whole batch a model: no pad rows
    out = sc.finish(sc.submit(events))
    assert not any(p.is_empty for p, _ in out)
    snap = m.struct_snapshot()
    launches = 1 if zoo else 2
    assert snap["counters"]["device_samples"] == launches
    assert snap["counters"].get("pack_dispatches", 0) == (1 if zoo else 0)
    # 1 µs a record scored: the sample is the kernel region alone
    assert snap["gauges"]["device_ns_per_record"]["value"] == \
        pytest.approx(1e3)
