"""The port's telemetry history (obs/history.py) held to the JAX package on
the CPU.

The twins of the JAX tests/test_history.py cases: the exact wire codec,
the merge (bitwise order- and grouping-free), the downsampling cascade,
gauge and counter-reset semantics, the segment rings (byte budget, torn
tails, a SIGKILL mid-append), range queries and their HTTP parameters,
and the cardinality governor. Every frame is built by both packages from
the same inputs, and the two canonical JSON strings must be equal; the
recorder is driven on an injected clock through both packages' capture
paths and must write the same frames. The JAX file's replay-CLI and
bench-trend cases belong to ``cli.py`` and ``tools/``, which the port does
not have; their places are taken by ``frame_to_struct``, the recorder and
the arming gate.
"""

import os
import random
import signal
import subprocess
import sys
import time
from fractions import Fraction

import pytest

from flink_jpmml_tpu.obs import history as jh
from flink_jpmml_tpu.utils import metrics as jmetrics
from flink_jpmml_tpu_torch.obs import history as th
from flink_jpmml_tpu_torch.utils import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ADVERSARIAL = [0.1, 0.2, 0.3, 1e-17, 1e17, 3.333333333333333, 7.0]


def _struct(ts, uptime, counters=None, gauges=None, hists=None):
    return {
        "ts": float(ts),
        "uptime_s": float(uptime),
        "counters": dict(counters or {}),
        "gauges": {n: {"value": float(v), "max": float(v)}
                   for n, v in (gauges or {}).items()},
        "histograms": dict(hists or {}),
    }


def _frame(h, src, t0, t1, counters, gauges=None, res=1.0):
    prev = _struct(t0, 1.0, {n: 0.0 for n in counters})
    cur = _struct(t1, 1.0 + (t1 - t0), counters, gauges)
    return h.capture_frame(prev, cur, src, res, t0=t0, t1=t1)


def _canon(h, frames):
    return [h.canonical(f) for f in frames]


def test_wire_codec_is_exact_and_the_jax_one():
    total = Fraction(0)
    for v in _ADVERSARIAL * 3:
        total += th._dec(v)
    wire = th._enc(total)
    assert wire == jh._enc(total) and th._dec(wire) == total
    assert abs(th.wire_float(wire) - float(total)) <= abs(float(total)) * 1e-15
    assert th._enc(Fraction(0.5)) == 0.5
    assert sum((th._dec(0.1) for _ in range(10)), Fraction(0)) == (
        Fraction(0.1) * 10)
    for x in (Fraction(1 << 60), Fraction(3, 7), Fraction(-5, 1 << 80)):
        assert th._enc(x) == jh._enc(x)


def _adversarial_frames(h):
    frames = []
    for si, src in enumerate(("w0", "w1", "w2", "w3")):
        for slot in range(3):
            t0 = float(slot)
            counters = {
                "records_out": _ADVERSARIAL[(si + slot) % len(_ADVERSARIAL)],
                "shed_records":
                    _ADVERSARIAL[(si * 3 + slot) % len(_ADVERSARIAL)],
            }
            frames.append(_frame(h, src, t0, t0 + 1.0, counters,
                                 gauges={"queue_depth": float(si) + 0.1 * slot}))
    return frames


def test_frames_are_the_jax_frames():
    assert _canon(th, _adversarial_frames(th)) == _canon(
        jh, _adversarial_frames(jh))


def test_merge_is_order_free_and_the_jax_merge():
    frames = _adversarial_frames(th)
    baseline = th.canonical(th.merge_frames(frames))
    assert baseline == jh.canonical(jh.merge_frames(_adversarial_frames(jh)))
    for seed in (0, 7, 11, 23, 41):
        shuffled = list(frames)
        random.Random(seed).shuffle(shuffled)
        assert th.canonical(th.merge_frames(shuffled)) == baseline


def test_merge_is_associative_under_adversarial_groupings():
    frames = _adversarial_frames(th)
    baseline = th.canonical(th.merge_frames(frames))
    for seed in (3, 13, 29):
        rng = random.Random(seed)
        shuffled = list(frames)
        rng.shuffle(shuffled)
        partials, i = [], 0
        while i < len(shuffled):
            k = rng.randint(1, 4)
            partials.append(th.merge_frames(shuffled[i:i + k]))
            i += k
        rng.shuffle(partials)
        assert th.canonical(th.merge_frames(partials)) == baseline
        assert jh.canonical(jh.merge_frames(partials)) == baseline


def _fine(h):
    frames = []
    for src in ("w0", "w1"):
        for i in range(40):
            t0 = i * 0.5
            frames.append(_frame(
                h, src, t0, t0 + 0.5,
                {"records_out": _ADVERSARIAL[i % len(_ADVERSARIAL)]},
                gauges={"queue_depth": float(i % 5)}, res=0.5))
    return frames


def test_downsample_cascade_equals_direct_and_the_jax_one():
    frames = _fine(th)
    direct = th.downsample(frames, 5.0)
    cascaded = th.downsample(th.downsample(frames, 1.0), 5.0)
    assert len(direct) == len(cascaded) == 4
    assert _canon(th, direct) == _canon(th, cascaded)
    assert _canon(th, direct) == _canon(jh, jh.downsample(_fine(jh), 5.0))
    # fleet aggregation across sources == downsampling across time
    per = [f for w in ("w0", "w1") for f in th.downsample(
        [f for f in frames if f["src"] == w], 5.0)]
    assert _canon(th, th.downsample(per, 5.0)) == _canon(th, direct)


def test_gauge_merge_semantics():
    for h in (th, jh):
        a = _frame(h, "w0", 0.0, 1.0, {}, gauges={"queue_depth": 3.0})
        b = _frame(h, "w1", 0.0, 1.0, {}, gauges={"queue_depth": 5.0})
        g = h.merge_frames([a, b])["gauges"]["queue_depth"]
        assert g["min"] == 3.0 and g["max"] == 5.0
        assert set(g["last"]) == {"w0", "w1"}
        assert h.combined_last("queue_depth", g["last"]) == 8.0
    # a worst-of gauge combines by its declared mode in both packages
    last = {"w0": [1.0, 0.25], "w1": [1.0, 0.75]}
    assert th.combined_last("pressure", last) == jh.combined_last(
        "pressure", last)


@pytest.mark.parametrize("case", ["backwards_counter", "backwards_uptime",
                                  "true_delta", "histogram_reset"])
def test_counter_reset_falls_back_to_cumulative(case):
    hist = {"layout": [1e-3, 10.0, 4], "counts": {"1": 5, "2": 3},
            "sum": 0.7, "n": 8, "max": 0.5}
    smaller = dict(hist, counts={"1": 2}, sum=0.1, n=2)
    prev, cur, want, resets = {
        "backwards_counter": (
            _struct(10.0, 50.0, {"records_out": 100.0}),
            _struct(11.0, 51.0, {"records_out": 40.0}), 40.0, 1),
        "backwards_uptime": (
            _struct(10.0, 50.0, {"records_out": 60.0, "batches": 9.0}),
            _struct(11.0, 2.0, {"records_out": 70.0, "batches": 12.0}),
            70.0, 2),
        "true_delta": (
            _struct(10.0, 50.0, {"records_out": 60.0}),
            _struct(11.0, 51.0, {"records_out": 70.0}), 10.0, 0),
        "histogram_reset": (
            _struct(10.0, 50.0, {"records_out": 60.0}, hists={"lat": hist}),
            _struct(11.0, 51.0, {"records_out": 61.0},
                    hists={"lat": smaller}), 1.0, 1),
    }[case]
    f = th.capture_frame(prev, cur, "w0", 1.0)
    assert th.canonical(f) == jh.canonical(jh.capture_frame(prev, cur, "w0",
                                                            1.0))
    assert th.wire_float(f["counters"]["records_out"]) == want
    assert f["resets"] == resets


def test_ring_retention_under_byte_budget(tmp_path):
    m = tmetrics.MetricsRegistry()
    store = th.HistoryStore(str(tmp_path), metrics=m, max_bytes=48 * 1024,
                            resolutions=(1.0,), segment_bytes=4096)
    for i in range(600):
        store.append(_frame(th, "w0", float(i), float(i + 1),
                            {"records_out": 1.0 * i}))
    store.close()
    assert store.bytes_total() <= 48 * 1024 + 4096
    frames = th.read_frames(str(tmp_path))
    assert frames and frames[0]["t0"] > 0.0 and frames[-1]["t0"] == 599.0
    # the JAX reader reads the port's rings as its own
    assert _canon(jh, jh.read_frames(str(tmp_path))) == _canon(th, frames)
    snap = m.struct_snapshot()
    assert snap["counters"]['history_dropped{reason="ring_gc"}'] > 0
    assert snap["counters"]["history_frames"] == 600.0


def test_torn_tail_and_garbage_lines_are_skipped(tmp_path):
    store = th.HistoryStore(str(tmp_path), resolutions=(1.0,))
    for i in range(5):
        store.append(_frame(th, "w0", float(i), float(i + 1),
                            {"records_out": 2.0}))
    store.close()
    segs = sorted(p for p in os.listdir(tmp_path) if p.endswith(".jsonl"))
    with open(os.path.join(tmp_path, segs[-1]), "a") as f:
        f.write("not json at all\n")
        f.write('{"v":1,"src":"w0","res":1.0,"t0":99.0,"t1":')
    frames = th.read_frames(str(tmp_path))
    assert len(frames) == 5 and all(f["t0"] < 99.0 for f in frames)


_KILL_CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[2])
from flink_jpmml_tpu_torch.obs import history
assert "jax" not in sys.modules
store = history.HistoryStore(sys.argv[1], resolutions=(1.0,))
i = 0
while True:
    prev = {"ts": float(i), "uptime_s": 1.0,
            "counters": {"records_out": float(i)}, "gauges": {},
            "histograms": {}}
    cur = {"ts": float(i + 1), "uptime_s": 2.0,
           "counters": {"records_out": float(i + 1)}, "gauges": {},
           "histograms": {}}
    store.append(history.capture_frame(prev, cur, "w0", 1.0))
    i += 1
    time.sleep(0.002)
"""


def test_sigkill_mid_append_leaves_a_readable_store(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, str(tmp_path), REPO],
        cwd=str(tmp_path), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError("writer died early: " + proc.stderr.read(
                ).decode(errors="replace")[-2000:])
            if len(th.read_frames(str(tmp_path))) >= 5:
                break
            time.sleep(0.02)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    frames = th.read_frames(str(tmp_path))
    assert len(frames) >= 5
    for f in frames:
        assert th.wire_float(f["counters"]["records_out"]) == 1.0
    t0s = [f["t0"] for f in frames]
    assert t0s == [float(i) for i in range(len(t0s))]


def _populated_store(h, directory):
    store = h.HistoryStore(str(directory), resolutions=(1.0, 5.0))
    fine = [_frame(h, src, float(i), float(i + 1),
                   {"records_out": 3.0, "records_in": 4.0},
                   gauges={"queue_depth": float(i)})
            for src in ("w0", "w1") for i in range(10)]
    for f in fine:
        store.append(f)
    for f in h.downsample(fine, 5.0):
        store.append(f)
    store.append(_frame(h, h.FLEET_SRC, 0.0, 10.0, {"records_out": 60.0}))
    store.close()


_QUERIES = [
    dict(step=1.0), dict(sources=["_fleet"]), dict(step=5.0),
    dict(step=7.0), dict(start=3.0, end=6.0, step=1.0),
    dict(step=5.0, start=0.0, end=10.0),
    dict(names=["records_out"], step=1.0),
    dict(names=["queue_*"], step=2.0, sources=["w1"]),
]


@pytest.mark.parametrize("kw", _QUERIES, ids=lambda kw: ",".join(kw))
def test_query_results_and_frame_to_struct_are_the_jax_ones(tmp_path, kw):
    _populated_store(th, tmp_path / "port")
    _populated_store(jh, tmp_path / "jax")
    p = th.query(str(tmp_path / "port"), **kw)
    j = jh.query(str(tmp_path / "jax"), **kw)
    assert p["frames"]
    for k in ("res", "step", "resolutions", "series"):
        assert p.get(k) == j.get(k)
    assert _canon(th, p["frames"]) == _canon(jh, j["frames"])
    assert ([th.frame_to_struct(f) for f in p["frames"]]
            == [jh.frame_to_struct(f) for f in j["frames"]])


def test_query_range_step_and_source_semantics(tmp_path):
    _populated_store(th, tmp_path)
    d = str(tmp_path)
    p = th.query(d, step=1.0)
    assert all(th.FLEET_SRC not in f["src"].split("+") for f in p["frames"])
    assert sum(th.wire_float(f["counters"]["records_out"])
               for f in p["frames"]) == 60.0
    p = th.query(d, sources=[th.FLEET_SRC])
    assert len(p["frames"]) == 1
    assert th.wire_float(p["frames"][0]["counters"]["records_out"]) == 60.0
    assert th.query(d, step=5.0)["res"] == 5.0
    assert th.query(d, step=1.0)["res"] == 1.0
    assert th.query(d, step=7.0)["res"] == 5.0
    p = th.query(d, start=3.0, end=6.0, step=1.0)
    assert p["frames"] and all(
        f["t1"] >= 3.0 and f["t0"] <= 6.0 for f in p["frames"])
    p = th.query(d, step=5.0, start=0.0, end=10.0)
    assert [th.wire_float(f["counters"]["records_out"])
            for f in p["frames"]] == [30.0, 30.0]
    p = th.query(d, names=["records_out"], step=1.0)
    assert all(set(f["counters"]) <= {"records_out"} and not f["gauges"]
               for f in p["frames"])
    assert "records_out" in p["series"]


def test_query_params_decodes_http_query_strings():
    params = {"name": ["records_out,headroom_frac"], "source": ["w0"],
              "start": ["3.0"], "end": ["9"], "step": ["5"]}
    q = th.query_params(params)
    assert q == jh.query_params(params)
    assert q["names"] == ["records_out", "headroom_frac"]
    assert q["sources"] == ["w0"]
    assert (q["start"], q["end"], q["step"]) == (3.0, 9.0, 5.0)
    assert th.query_params({"step": ["x"]})["step"] is None


def _tenants(m, zoo):
    reg = m.MetricsRegistry()
    for i in range(zoo):
        reg.counter('tenant_records{model="z%04d"}' % i).inc(i + 1)
    return reg.struct_snapshot()


def test_governor_bounds_1000_tenants_with_exact_totals():
    zoo = 1000
    snap = _tenants(tmetrics, zoo)
    governed = tmetrics.govern_struct(snap, max_series=8)
    jgov = jmetrics.govern_struct(_tenants(jmetrics, zoo), max_series=8)
    assert governed["counters"] == jgov["counters"]
    tenant = {n: v for n, v in governed["counters"].items()
              if n.startswith("tenant_records{")}
    assert len(tenant) == 8
    other = tenant.pop('tenant_records{model="_other"}')
    assert 'tenant_records{model="z0999"}' in tenant
    assert 'tenant_records{model="z0000"}' not in tenant
    assert sum(tenant.values()) + other == zoo * (zoo + 1) / 2
    assert len([n for n in snap["counters"]
                if n.startswith("tenant_records{")]) == zoo


def test_govern_frame_matches_the_struct_governor_and_jax():
    zoo = 1000
    counters = {'tenant_records{model="z%04d"}' % i: float(i + 1)
                for i in range(zoo)}
    frame = _frame(th, "w0", 0.0, 1.0, counters)
    governed = th.govern_frame(frame, max_series=8)
    assert th.canonical(governed) == jh.canonical(jh.govern_frame(
        _frame(jh, "w0", 0.0, 1.0, counters), max_series=8))
    tenant = {n: v for n, v in governed["counters"].items()
              if n.startswith("tenant_records{")}
    assert len(tenant) == 8 and 'tenant_records{model="_other"}' in tenant
    assert sum((th._dec(v) for v in tenant.values()), Fraction(0)) == (
        Fraction(zoo * (zoo + 1), 2))
    assert len(frame["counters"]) == zoo
    assert th.canonical(th.merge_frames([governed, governed])) == (
        th.canonical(th.merge_frames([governed, dict(governed)])))


def _snapshots(m):
    """A worker's cumulative structs over eight captures, with a restart
    (uptime back to 0.5) before the sixth, built by ``m``'s registry."""
    reg = m.MetricsRegistry()
    out = []
    for k in range(8):
        if k == 5:
            reg = m.MetricsRegistry()
        reg.counter("records_out").inc(1000.0 + 0.1 * k)
        reg.counter("records_in").inc(1100.0)
        reg.gauge("capacity_rec_s").set(8800.0)
        reg.gauge("pressure").set(0.125 * k)
        h = reg.histogram("batch_latency_s")
        for v in (0.001, 0.01 * (k + 1), 0.2):
            h.observe(v)
        s = reg.struct_snapshot()
        s["ts"] = 100.0 + 0.25 * k
        s["uptime_s"] = 0.5 + 0.25 * (k if k < 5 else k - 5)
        out.append(s)
    return out


def _record(h, m, directory, sources):
    rec = h.HistoryRecorder(m.MetricsRegistry(), str(directory), src="w0",
                            interval_s=0.25, resolutions=(0.25, 1.0),
                            budget_frac=1.0, start_thread=False)
    finest = []
    for k, snap in enumerate(_snapshots(m)):
        for src in sources:
            f = rec.capture_struct(src, snap, now=100.0 + 0.25 * k)
            if f is not None and src == sources[0]:
                finest.append(h.canonical(f))
    rec.close()
    return finest


def test_recorder_writes_the_jax_frames_on_an_injected_clock(tmp_path):
    sources = ["w0", th.FLEET_SRC]
    pf = _record(th, tmetrics, tmp_path / "port", sources)
    jf = _record(jh, jmetrics, tmp_path / "jax", sources)
    assert len(pf) == 7 and pf == jf
    for res in (0.25, 1.0):
        for srcs in (None, sources):
            p = th.read_frames(str(tmp_path / "port"), res=res, sources=srcs)
            j = jh.read_frames(str(tmp_path / "jax"), res=res, sources=srcs)
            assert p and _canon(th, p) == _canon(jh, j)
    # the restart before the sixth capture falls back to the cumulative
    frames = th.read_frames(str(tmp_path / "port"), res=0.25, sources=["w0"])
    assert [f["resets"] > 0 for f in frames] == [False] * 4 + [True] + [
        False] * 2
    # capacity headroom rides every frame: 1 - offered / capacity
    assert frames[0]["gauges"]["offered_rec_s"]["max"] == 4400.0
    assert frames[0]["gauges"]["headroom_frac"]["max"] == 0.5
    # the stored coarse tier is the downsample of the fine one
    coarse = th.read_frames(str(tmp_path / "port"), res=1.0, sources=["w0"])
    assert _canon(th, coarse) == _canon(th, th.downsample(frames, 1.0))


def test_budget_gate_drops_and_counts(tmp_path):
    m = tmetrics.MetricsRegistry()
    m.counter("records_out").inc(5)
    rec = th.HistoryRecorder(m, str(tmp_path), interval_s=0.25,
                             resolutions=(0.25,), budget_frac=0.0,
                             start_thread=False)
    rec._overhead_s = 1.0  # any spent time is over a zero budget
    assert not rec.maybe_capture(now=1.0)
    assert m.struct_snapshot()["counters"][
        'history_dropped{reason="budget"}'] == 1.0
    rec.close()


def test_history_for_gates_on_the_env(tmp_path, monkeypatch):
    monkeypatch.delenv("FJT_HISTORY_DIR", raising=False)
    m = tmetrics.MetricsRegistry()
    assert th.history_for(m) is None and th.peek(m) is None
    assert th.history_payload(m, {}) == {"dir": None, "resolutions": [],
                                         "frames": []}
    monkeypatch.setenv("FJT_HISTORY_DIR", str(tmp_path))
    monkeypatch.setenv("FJT_HISTORY_BUDGET", "0.5")
    rec = th.history_for(m)
    try:
        assert rec is not None and th.history_for(m) is rec
        assert th.peek(m) is rec and rec._budget == 0.5
        assert rec.store.directory == str(tmp_path)
    finally:
        rec.close()
