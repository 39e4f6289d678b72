"""The port's exposition server (obs/server.py) held to the JAX package on
the CPU.

The twins of the JAX tests/test_obs.py ``TestPrometheusText`` and
``TestObsServer`` cases: each struct is built once per package with its
own ``MetricsRegistry`` and rendered by its own ``prometheus_text``, and
the two pages must be the same bytes (and the pinned golden where the
JAX case pins one). ``/healthz`` is also composed with each package's
drift monitor (``DriftMonitor.health_fn``) on the same sketches and the
same clock, and the two bodies must be equal. Servers bind port 0.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from flink_jpmml_tpu.obs import drift as jdrift
from flink_jpmml_tpu.obs import server as jserver
from flink_jpmml_tpu.utils import metrics as jmetrics
from flink_jpmml_tpu_torch.obs import ObsServer, prometheus_text
from flink_jpmml_tpu_torch.obs import drift
from flink_jpmml_tpu_torch.obs import server as tserver
from flink_jpmml_tpu_torch.utils import metrics as tmetrics

PACKAGES = [(tmetrics, tserver), (jmetrics, jserver)]


def _get(url: str, accept: str = None):
    req = urllib.request.Request(url)
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _both(build, **kw) -> str:
    """``build(metrics_module)`` → a struct or {key: struct}; render it in
    each package; → the page, after asserting the two are the same bytes."""
    pages = []
    for m, srv in PACKAGES:
        src = build(m)
        sources = src if isinstance(src, dict) and None in src else {None: src}
        pages.append(srv.prometheus_text(sources, **kw))
    assert pages[0] == pages[1]
    return pages[0]


def _golden_struct(m):
    reg = m.MetricsRegistry()
    reg.counter("records_out").inc(3)
    reg.gauge("inflight_depth").set(2)
    h = reg.histogram("lat_s", lo=0.01, hi=1.0, buckets_per_decade=1)
    h.observe(0.005)
    h.observe(0.05)
    h.observe(7.0)
    s = reg.struct_snapshot()
    s["uptime_s"] = 12.5
    return s


def test_golden_render_is_the_jax_bytes():
    assert _both(_golden_struct) == (
        "# TYPE fjt_inflight_depth gauge\n"
        "fjt_inflight_depth 2\n"
        "# TYPE fjt_inflight_depth_max gauge\n"
        "fjt_inflight_depth_max 2\n"
        "# TYPE fjt_lat_s histogram\n"
        'fjt_lat_s_bucket{le="0.01"} 1\n'
        'fjt_lat_s_bucket{le="0.1"} 2\n'
        'fjt_lat_s_bucket{le="1"} 2\n'
        'fjt_lat_s_bucket{le="+Inf"} 3\n'
        "fjt_lat_s_sum 7.055\n"
        "fjt_lat_s_count 3\n"
        "# TYPE fjt_records_out counter\n"
        "fjt_records_out 3\n"
        "# TYPE fjt_uptime_s gauge\n"
        "fjt_uptime_s 12.5\n"
    )


def _exemplar_struct(m):
    reg = m.MetricsRegistry()
    h = reg.histogram('stage_seconds{stage="sink"}', lo=0.01, hi=1.0,
                      buckets_per_decade=1)
    h.observe(0.05)
    h.observe(0.5, exemplar="abc-1")
    s = reg.struct_snapshot()
    s["uptime_s"] = 1.0
    s["histograms"]['stage_seconds{stage="sink"}']["exemplars"]["2"][2] = 99.5
    return s


def test_exemplar_exposition_is_the_jax_bytes():
    assert _both(_exemplar_struct, openmetrics=True) == (
        "# TYPE fjt_stage_seconds histogram\n"
        'fjt_stage_seconds_bucket{stage="sink",le="0.01"} 0\n'
        'fjt_stage_seconds_bucket{stage="sink",le="0.1"} 1\n'
        'fjt_stage_seconds_bucket{stage="sink",le="1"} 2'
        ' # {trace_id="abc-1"} 0.5 99.5\n'
        'fjt_stage_seconds_bucket{stage="sink",le="+Inf"} 2\n'
        'fjt_stage_seconds_sum{stage="sink"} 0.55\n'
        'fjt_stage_seconds_count{stage="sink"} 2\n'
        "# TYPE fjt_uptime_s gauge\n"
        "fjt_uptime_s 1\n"
        "# EOF\n"
    )
    classic = _both(_exemplar_struct)
    assert "trace_id" not in classic and "# EOF" not in classic

    def counter_only(m):
        reg = m.MetricsRegistry()
        reg.counter("records_out").inc(3)
        s = reg.struct_snapshot()
        s["uptime_s"] = 1.0
        return s

    assert "# TYPE fjt_records_out counter" in _both(counter_only)
    om = _both(counter_only, openmetrics=True)
    assert "# TYPE fjt_records_out unknown" in om
    assert "fjt_records_out 3\n" in om and om.endswith("# EOF\n")


def test_worker_labels_and_unlabeled_aggregate():
    def fleet(m):
        agg, w0 = m.MetricsRegistry(), m.MetricsRegistry()
        agg.counter("records_out").inc(15)
        w0.counter("records_out").inc(15)
        out = {}
        for key, reg in ((None, agg), ("w0", w0)):
            out[key] = reg.struct_snapshot()
            out[key]["uptime_s"] = 2.0
        return out

    text = _both(fleet)
    assert "fjt_records_out 15\n" in text
    assert 'fjt_records_out{worker="w0"} 15\n' in text
    assert text.count("# TYPE fjt_records_out counter") == 1


def test_labelled_registry_name_passthrough():
    def lag(m):
        reg = m.MetricsRegistry()
        reg.gauge('kafka_lag{partition="3"}').set(42)
        s = reg.struct_snapshot()
        s["uptime_s"] = 3.0
        return s

    assert 'fjt_kafka_lag{partition="3"} 42\n' in _both(lag)
    pages = [srv.prometheus_text({"w1": lag(m)}) for m, srv in PACKAGES]
    assert pages[0] == pages[1]
    assert 'fjt_kafka_lag{partition="3",worker="w1"} 42\n' in pages[0]


def _busy_struct(m, seed: int):
    """Counters, labelled gauges, histograms of several layouts and a
    sketch, filled from one seeded stream."""
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry()
    for i in range(6):
        reg.counter(f'tenant_records{{model="t{i}"}}').inc(
            float(rng.integers(1, 10_000)))
    reg.counter("records_out").inc(float(rng.random() * 1e6))
    reg.gauge("pressure").set(float(rng.random()))
    reg.gauge('kafka_lag{partition="0"}').set(float(rng.integers(0, 99)))
    for name, lo, hi in (("batch_latency_s", 1e-5, 10.0),
                         ('stage_seconds{stage="h2d"}', 1e-6, 1.0)):
        h = reg.histogram(name, lo=lo, hi=hi)
        for v in rng.lognormal(-6, 2, 500):
            h.observe(float(v))
    reg.sketch("score_dist").observe_many(rng.normal(0, 1, 300))
    s = reg.struct_snapshot()
    s["uptime_s"] = 42.25
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("openmetrics", [False, True])
def test_a_busy_fleet_page_is_the_jax_bytes(seed, openmetrics):
    def fleet(m):
        parts = [_busy_struct(m, seed + k) for k in range(2)]
        merged = m.merge_structs(parts)
        merged["uptime_s"] = 42.25
        return {None: merged, "w0": parts[0], "w1": parts[1]}

    page = _both(fleet, openmetrics=openmetrics)
    assert 'fjt_tenant_records{model="t0",worker="w1"}' in page
    # the port renders the JAX package's struct as JAX does, and back
    js, ts = fleet(jmetrics), fleet(tmetrics)
    assert (tserver.prometheus_text(js, openmetrics=openmetrics)
            == jserver.prometheus_text(ts, openmetrics=openmetrics) == page)


def test_endpoints():
    m = tmetrics.MetricsRegistry()
    m.counter("records_out").inc(9)
    m.histogram("lat_s").observe(0.01)
    health = {"ok": True}
    srv = ObsServer.for_registry(m, health_fn=lambda: dict(health))
    try:
        status, ctype, text = _get(srv.url + "/metrics")
        assert status == 200 and "version=0.0.4" in ctype
        assert "fjt_records_out 9\n" in text
        assert 'fjt_lat_s_bucket{le="+Inf"} 1\n' in text
        status, ctype, text = _get(srv.url + "/metrics",
                                   accept="application/openmetrics-text")
        assert "openmetrics" in ctype and text.endswith("# EOF\n")

        status, _, body = _get(srv.url + "/varz")
        assert status == 200
        assert json.loads(body)[""]["counters"]["records_out"] == 9

        status, _, body = _get(srv.url + "/healthz")
        assert status == 200 and json.loads(body)["ok"] is True
        health["ok"] = False
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/healthz")
        assert e.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/nope")
        assert e.value.code == 404

        status, _, body = _get(srv.url + "/trace")
        assert status == 200 and isinstance(json.loads(body), dict)
        # history unarmed (no FJT_HISTORY_DIR): an empty payload
        status, _, body = _get(srv.url + "/history")
        assert status == 200 and json.loads(body)["frames"] == []
    finally:
        srv.close()


def _drift_health(m, d, shift: float):
    """A registry whose monitor has a baseline for feature x and then sees
    ``x`` shifted by ``shift``; → (registry, health_fn), on an injected
    clock."""
    reg = m.MetricsRegistry()
    t = [0.0]
    mon = d.monitor_for(reg)
    mon._clock, mon._interval, mon.dwell_s, mon.min_n = (
        lambda: t[0]), 0.0, 0.0, 50
    rng = np.random.default_rng(9)
    sk = reg.sketch(d.feature_sketch_name("m", "x"))
    sk.observe_many(rng.normal(0, 1, 4000))
    mon.set_baseline("m", d.snapshot_from_struct(reg.struct_snapshot())["m"])
    sk.observe_many(rng.normal(shift, 1, 4000))
    t[0] = 1.0
    reg.struct_snapshot()  # the scrape ticks the monitor
    return reg, mon.health_fn(lambda: {"ok": True, "workers": 2})


@pytest.mark.parametrize("shift", [0.0, 8.0])
def test_healthz_composes_the_drift_monitor_like_jax(shift):
    bodies = []
    for m, srv_mod, d in ((tmetrics, tserver, drift),
                          (jmetrics, jserver, jdrift)):
        reg, fn = _drift_health(m, d, shift)
        srv = srv_mod.ObsServer.for_registry(reg, health_fn=fn)
        try:
            status, _, body = _get(srv.url + "/healthz")
        finally:
            srv.close()
        bodies.append((status, json.loads(body)))
    assert bodies[0] == bodies[1]
    status, body = bodies[0]
    # the drift verdict rides the payload; liveness stays the server's
    assert status == 200 and body["ok"] and body["workers"] == 2
    assert body["drift"]["ok"] is (shift == 0.0)
    if shift:
        assert body["drift"]["alarms"][0]["feature"] == "x"


def test_a_failing_collect_is_a_500_not_a_dead_server():
    def boom():
        raise RuntimeError("collector down")

    srv = tserver.ObsServer(boom)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/metrics")
        assert e.value.code == 500
        status, _, _ = _get(srv.url + "/healthz")
        assert status == 200
    finally:
        srv.close()
