"""Chrome-trace span files of the port (``obs/spans.py`` and its emit
sites) on the CPU against the JAX package's: the buffered writer's
crash-loss bound, interval and close flushes, the ``FJT_TRACE_MAX_MB``
byte budget with its single truncation marker, the flight recorder's
flush before a dump, and — on a CPU port pipeline — one ``h2d_dispatch``
and one ``readback`` span a dispatch, as many of each as the JAX
pipeline writes for the same records, carrying the batch's journey ids
when journeys are armed. Counts and event fields exactly."""

import json
import os

import pytest

from test_torch_checkpoint import (  # noqa: F401  (fixtures)
    B,
    TWINS,
    _clean_faults,
    cfg,
    data,
    gbm_path,
    models,
    twin,
)


def spans_mod(name):
    if name == "jax":
        from flink_jpmml_tpu.obs import spans
    else:
        from flink_jpmml_tpu_torch.obs import spans
    return spans


def _events(path):
    raw = open(path, encoding="utf-8").read()
    return json.loads(raw.rstrip().rstrip(",") + "]")


@pytest.fixture(autouse=True)
def _fresh_writers(monkeypatch):
    """Each test starts with no span writer in either package and leaves
    none open behind it."""
    monkeypatch.delenv("FJT_TRACE_DIR", raising=False)
    monkeypatch.delenv("FJT_TRACE_MAX_MB", raising=False)
    for name in TWINS:
        sp = spans_mod(name)
        monkeypatch.setattr(sp, "_writer", None)
        monkeypatch.setattr(sp, "_writer_dir", None)
    yield
    for name in TWINS:
        w = spans_mod(name)._writer
        if w is not None:
            w.close()


def _strip(evs):
    return [{k: v for k, v in e.items() if k not in ("pid", "tid")}
            for e in evs]


@pytest.mark.parametrize("name", TWINS)
def test_crash_loss_is_bounded_by_the_buffer(name, tmp_path):
    w = spans_mod(name).SpanWriter(str(tmp_path / "t.trace.json"),
                                   buffer_events=8, flush_interval_s=1e9)
    for i in range(7):
        w.emit("s", float(i), 0.001)
    assert _events(w.path) == []  # buffered, none on disk yet
    w.emit("s", 7.0, 0.001)  # the 8th fills the buffer: flushed
    assert len(_events(w.path)) == 8
    for i in range(30):
        w.emit("s", float(8 + i), 0.001)
    assert 38 - len(_events(w.path)) < 8
    w.flush()
    assert len(_events(w.path)) == 38
    w.close()


def test_writers_write_the_same_events(tmp_path):
    got = {}
    for name in TWINS:
        w = spans_mod(name).SpanWriter(str(tmp_path / f"{name}.json"),
                                       buffer_events=4, flush_interval_s=1e9)
        w.emit("featurize", 1.0, 0.5, n=64)
        w.emit("readback", 2.25, 1e-6, inflight=2)
        w.emit("sink", 3.0, 0.0)
        w.close()  # close flushes
        got[name] = _strip(_events(w.path))
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"name": "featurize", "ph": "X", "ts": 1e6,
                              "dur": 5e5, "cat": "fjt", "args": {"n": 64}}


@pytest.mark.parametrize("interval", [0.0, 1e9])
def test_interval_flush_like_the_jax_writer(interval, tmp_path):
    got = {}
    for name in TWINS:
        w = spans_mod(name).SpanWriter(str(tmp_path / f"{name}.json"),
                                       buffer_events=10_000,
                                       flush_interval_s=interval)
        w.emit("s", 0.0, 0.001)
        got[name] = len(_events(w.path))
        w.close()
    assert got["port"] == got["jax"] == (1 if interval == 0.0 else 0)


@pytest.mark.parametrize("max_bytes", [0, 150, 400, 4000])
def test_byte_budget_truncates_once_like_the_jax_writer(max_bytes,
                                                        tmp_path):
    got = {}
    for name in TWINS:
        w = spans_mod(name).SpanWriter(str(tmp_path / f"{name}.json"),
                                       max_bytes=max_bytes)
        for i in range(100):
            w.emit("s", float(i), 0.001)
        w.close()
        raw = open(w.path, encoding="utf-8").read()
        got[name] = (len(raw), raw.count("TRACE TRUNCATED"),
                     [e["name"] for e in _events(w.path)])
    assert got["port"] == got["jax"]
    assert got["port"][1] == 1


def test_env_budget_and_retarget(tmp_path, monkeypatch):
    sp = spans_mod("port")
    assert sp.writer() is None
    sp.emit("noop", 0.0, 1.0)  # unarmed: a silent no-op
    sp.flush()
    assert sp._writer is None
    monkeypatch.setenv("FJT_TRACE_DIR", str(tmp_path / "a"))
    monkeypatch.setenv("FJT_TRACE_MAX_MB", "0.0004")  # ~420 bytes
    for i in range(50):
        sp.emit("s", float(i), 0.001)
    wa = sp.writer()
    assert wa.path == os.path.join(str(tmp_path / "a"),
                                   f"spans-{os.getpid()}.trace.json")
    # retargeting closes (and so flushes) the old writer
    monkeypatch.setenv("FJT_TRACE_DIR", str(tmp_path / "b"))
    wb = sp.writer()
    assert wb is not wa and os.path.dirname(wb.path) == str(tmp_path / "b")
    raw = open(wa.path, encoding="utf-8").read()
    assert raw.count("TRACE TRUNCATED") == 1 and len(raw) < 700


def test_flight_dump_flushes_spans(tmp_path, monkeypatch):
    from flink_jpmml_tpu_torch.obs import recorder

    sp = spans_mod("port")
    monkeypatch.setenv("FJT_TRACE_DIR", str(tmp_path))
    sp.emit("pre_crash", 1.0, 0.5)
    w = sp.writer()
    assert _events(w.path) == []  # still buffered
    r = recorder.FlightRecorder()
    r.record("worker_death", pid=123)
    assert r.dump(path=str(tmp_path / "f.jsonl")) is not None
    assert [e["name"] for e in _events(w.path)] == ["pre_crash"]


def test_stage_timer_and_annotate_emit_spans(tmp_path, monkeypatch):
    from flink_jpmml_tpu_torch.obs import trace
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
    from flink_jpmml_tpu_torch.utils.profiling import StageTimer, annotate

    monkeypatch.setenv("FJT_TRACE_DIR", str(tmp_path))
    ctx = trace.context_for(9)
    timer = StageTimer(MetricsRegistry())
    with trace.use(ctx):
        with timer.stage("featurize"):
            pass
        with annotate("named"):
            pass
    with timer.stage("untraced"):
        pass
    sp = spans_mod("port")
    sp.flush()
    by = {e["name"]: e for e in _events(sp.writer().path)}
    for name in ("featurize", "named"):
        assert by[name]["args"] == {"trace_id": ctx.trace_id,
                                    "span_id": ctx.span_id}
    assert "args" not in by["untraced"]


def _pipeline_spans(name, model, tmp_path, monkeypatch, journeys=False):
    pk = twin(name)
    d = tmp_path / name
    monkeypatch.setenv("FJT_TRACE_DIR", str(d))
    m = pk.metrics.MetricsRegistry()
    if journeys:
        if name == "jax":
            from flink_jpmml_tpu.obs import trace
        else:
            from flink_jpmml_tpu_torch.obs import trace
        trace.install(m, str(tmp_path / f"{name}-j"), head_n=0)
    pipe = pk.block.BlockPipeline(
        pk.block.FiniteBlockSource(data(12 * B, seed=4), B), model,
        lambda *a: None, cfg(pk), metrics=m, max_dispatch_chunks=1)
    pipe.run_until_exhausted(timeout=60)
    sp = spans_mod(name)
    sp.flush()
    evs = _events(sp.writer().path)
    sp.writer().close()
    monkeypatch.delenv("FJT_TRACE_DIR")
    counts = {}
    for e in evs:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts, evs, int(m.struct_snapshot()["counters"]["dispatches"])


def test_pipeline_writes_a_span_pair_a_dispatch_like_the_jax_one(
        models, tmp_path, monkeypatch):
    got = {name: _pipeline_spans(name, models[name], tmp_path, monkeypatch)
           for name in TWINS}
    (tc, tevs, tdisp), (jc, _, jdisp) = got["port"], got["jax"]
    assert tdisp == jdisp == 12
    for span in ("h2d_dispatch", "readback", "sink", "featurize"):
        assert tc[span] == jc[span] == tdisp, span
    for e in tevs:
        assert e["ph"] == "X" and e["dur"] >= 0
    h2d = [e for e in tevs if e["name"] == "h2d_dispatch"]
    assert all(e["args"]["bytes"] > 0 for e in h2d)
    rb = [e for e in tevs if e["name"] == "readback"]
    # the window's depth when the oldest entry was waited on: the depth-2
    # window plus the launch that overflowed it
    assert all(1 <= e["args"]["inflight"] <= 3 for e in rb)


def test_pipeline_spans_carry_the_batch_journey(models, tmp_path,
                                                monkeypatch):
    from flink_jpmml_tpu_torch.obs import trace

    counts, evs, disp = _pipeline_spans("port", models["port"], tmp_path,
                                        monkeypatch, journeys=True)
    h2d = [e for e in evs if e["name"] == "h2d_dispatch"]
    sink = [e for e in evs if e["name"] == "sink"]
    assert len(h2d) == len(sink) == disp
    want = {trace.trace_id_for(i * B) for i in range(disp)}
    assert {e["args"]["trace_id"] for e in h2d} == want
    assert {e["args"]["trace_id"] for e in sink} == want
    assert {e["args"]["first_off"] for e in sink} == {
        i * B for i in range(disp)}
