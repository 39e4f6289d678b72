"""The port's obs planes against the JAX package's on the CPU: the stage
ledger's stages, threads and metric names, ``attr.summary``, the
``FreshnessTracker``, the ``LagForecaster`` and the ``PressureMonitor``
give the same results for the same observations, the structured snapshot
carries the same keys, and the constants that stand in for the JAX
package's environment knobs are its defaults."""

import pytest

from flink_jpmml_tpu.obs import attr as jattr
from flink_jpmml_tpu.obs import freshness as jfresh
from flink_jpmml_tpu.obs import pressure as jpressure
from flink_jpmml_tpu.obs import recorder as jflight
from flink_jpmml_tpu.utils import retry as jretry
from flink_jpmml_tpu.utils.metrics import Histogram as JHistogram
from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JRegistry
from flink_jpmml_tpu_torch.obs import attr as tattr
from flink_jpmml_tpu_torch.obs import freshness as tfresh
from flink_jpmml_tpu_torch.obs import pressure as tpressure
from flink_jpmml_tpu_torch.obs import recorder as tflight
from flink_jpmml_tpu_torch.utils import retry as tretry
from flink_jpmml_tpu_torch.utils.metrics import Histogram as THistogram
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

T0 = 1_700_000_000.0  # a fixed wall clock for the event-time planes


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("FJT_FLIGHT_DIR", str(tmp_path / "flight"))


def _struct(reg) -> dict:
    """The snapshot without its clocks; exemplars carry a pid-based id
    and a capture time, so only their bucket indices are compared."""
    s = reg.struct_snapshot(run_hooks=False)
    s.pop("ts")
    s.pop("uptime_s")
    for h in s["histograms"].values():
        if "exemplars" in h:
            h["exemplars"] = sorted(h["exemplars"])
    return s


def test_stages_threads_and_names_are_the_jax_packages():
    assert tattr.STAGES == jattr.STAGES
    assert tattr.STAGE_THREADS == jattr.STAGE_THREADS
    for stage in tattr.STAGES:
        assert tattr.stage_metric_name(stage) == jattr.stage_metric_name(stage)


# the observations a Kafka-fed dispatch books, in the order it books them
OBSERVATIONS = [
    ("fetch", 0.0021), ("decode", 0.0009), ("prefetch_wait", 0.0004),
    ("encode", 0.00004), ("h2d", 0.0011), ("queue_wait", 0.031),
    ("readback", 0.0002), ("sink", 0.00001), ("fetch", 0.0190),
    ("decode", 0.0012), ("prefetch_wait", 0.0), ("queue_wait", 0.045),
    ("sink", 0.00002), ("h2d", 0.0009), ("encode", 0.00005),
]


@pytest.mark.parametrize("prefix", [5, len(OBSERVATIONS)])
def test_ledger_summary_and_snapshot_match(prefix):
    structs, summaries = [], []
    for attr, reg in ((jattr, JRegistry()), (tattr, TRegistry())):
        led = attr.ledger_for(reg)
        assert attr.ledger_for(reg) is led
        for stage, s in OBSERVATIONS[:prefix]:
            led.observe(stage, s)
        summaries.append(attr.summary(reg))
        structs.append(_struct(reg))
    assert summaries[1] == summaries[0]
    assert structs[1] == structs[0]
    assert set(summaries[1]) == {s for s, _ in OBSERVATIONS[:prefix]}


def test_summary_of_a_registry_without_stages_is_none():
    assert tattr.summary(TRegistry()) is None is jattr.summary(JRegistry())
    assert tattr.ledger_for(None) is None


@pytest.mark.parametrize("lo,hi,bpd", [(1e-6, 1e3, 4), (1e-3, 10.0, 10)])
def test_histogram_state_round_trip_matches(lo, hi, bpd):
    hs = [JHistogram(lo, hi, bpd), THistogram(lo, hi, bpd)]
    for h in hs:
        for i, v in enumerate((0.0, 2e-6, 0.5, 0.5, 7.0, 2e3)):
            h.observe(v, exemplar=f"t{i}" if v > 1 else None)
    assert hs[1].edges == hs[0].edges and hs[1].layout == hs[0].layout
    for h in hs:
        assert h.count() == 6 and h.sum() == pytest.approx(2008.000002)
    st = [h.state() for h in hs]
    for s in st:
        s["exemplars"] = {k: v[:2] for k, v in s["exemplars"].items()}
    assert st[1] == st[0]
    back = THistogram.from_state(hs[1].state())
    assert back.state() == hs[1].state()
    for q in (0.5, 0.99):
        assert back.quantile(q) == hs[0].quantile(q)


def _freshness_run(fresh, reg):
    tr = fresh.freshness_for(reg)
    assert fresh.freshness_for(reg) is tr
    tr.observe_source(0, T0 - 9.0, T0 - 4.0, now=T0)
    tr.observe_source(1, T0 - 8.0, T0 - 6.0, now=T0)
    tr.observe_source(1, T0 - 30.0, T0 - 20.0, now=T0 + 1)  # out of order
    tr.stamp_ingest(0, 100, T0 - 9.0, T0 - 4.0)
    tr.stamp_ingest(100, 50, T0 - 8.0, T0 - 6.0)
    tr.stamp_ingest(150, 0, T0, T0)  # empty: ignored
    tr.propagate_low_watermark("dispatch", 0, 120)
    tr.observe_sink(0, 60, now=T0 + 2)
    tr.observe_sink(60, 90, now=T0 + 3)
    tr.discard_stamps(150, 10)
    out = {
        "low": tr.low_watermark(),
        "stages": {s: tr.stage_watermark(s)
                   for s in ("source", "dispatch", "sink")},
    }
    fc = fresh.LagForecaster(reg)
    for i, (hw, cur) in enumerate(((1000, 100), (1500, 400), (1600, 900))):
        fc.observe(0, hw, cur, now=T0 + i)
    fc.sweep(now=T0 + 3)
    return out, _struct(reg)


def test_freshness_tracker_and_forecaster_match():
    jax_run = _freshness_run(jfresh, JRegistry())
    port_run = _freshness_run(tfresh, TRegistry())
    assert port_run == jax_run
    assert port_run[0]["low"] == T0 - 6.0
    hist = port_run[1]["histograms"]["record_staleness_s"]
    assert hist["n"] == 6  # two observations a consumed stamp or part


def _pressure_run(pressure, attr, reg):
    clock = [100.0]
    mon = pressure.PressureMonitor(reg, windows=((2.0, 0.5), (6.0, 0.3)),
                                   interval_s=0.5, clock=lambda: clock[0])
    led = attr.ledger_for(reg)
    ticks = []
    for step in range(12):
        clock[0] += 1.0
        reg.counter("dispatches").inc(4)
        reg.counter("window_full_launches").inc(4 if step > 3 else 1)
        reg.gauge("ring_occupancy").set(0.2 + 0.05 * step)
        mon.note_ring(min(1.0, 0.3 + 0.1 * step))
        mon.note_prefetch(0.25 * (step % 5))
        led.observe("queue_wait", 0.01 * step)
        ticks.append(mon.maybe_tick())
    return ticks, mon.breached, mon.health(), _struct(reg)


def test_pressure_monitor_matches():
    jax_run = _pressure_run(jpressure, jattr, JRegistry())
    port_run = _pressure_run(tpressure, tattr, TRegistry())
    assert port_run == jax_run
    assert port_run[1] is True  # the saturated tail breaches


@pytest.mark.parametrize("port,jax,names", [
    (tfresh, jfresh, ("_DEFAULT_WINDOW_S", "_DEFAULT_STALE_S")),
    (tpressure, jpressure, ("_DEFAULT_WINDOWS",)),
    (tretry, jretry, ("_DEFAULT_BASE_S", "_DEFAULT_CAP_S", "_DEFAULT_MAX")),
], ids=["lag", "pressure", "retry"])
def test_constants_are_the_jax_packages_defaults(monkeypatch, port, jax,
                                                 names):
    # the port reads no FJT_LAG_* / FJT_PRESSURE_WINDOWS / FJT_RETRY_*
    # knob: its constants are the values the JAX package runs without them
    for knob in ("FJT_LAG_WINDOW_S", "FJT_LAG_STALE_S", "FJT_PRESSURE_WINDOWS",
                 "FJT_RETRY_BASE_S", "FJT_RETRY_CAP_S", "FJT_RETRY_MAX"):
        monkeypatch.delenv(knob, raising=False)
    for name in names:
        assert getattr(port, name) == getattr(jax, name)
    if port is tpressure:
        assert (tpressure.PressureMonitor(TRegistry()).windows
                == jpressure.PressureMonitor(JRegistry()).windows)
    if port is tretry:
        t, j = tretry.Backoff("kafka"), jretry.Backoff("kafka")
        assert (t.base_s, t.cap_s, t.max_attempts) == \
            (j.base_s, j.cap_s, j.max_attempts)
    if port is tfresh:
        t, j = tfresh.LagForecaster(None), jfresh.LagForecaster(None)
        assert (t._window, t._stale) == (j._window, j._stale)


def test_flight_recorder_dumps_into_its_directory(tmp_path):
    for flight in (jflight, tflight):
        flight.record("kafka_reconnect", topic="t", attempt=1)
    path = tflight.dump(reason="test")
    assert path is not None and path.startswith(str(tmp_path / "flight"))
    kinds = [e["kind"] for e in tflight.events()]
    assert "kafka_reconnect" in kinds
    assert tflight.flight_dir() == jflight.flight_dir()
