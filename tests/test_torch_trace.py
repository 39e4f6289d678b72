"""Record-journey tracing of the port (``obs/trace.py`` and its hop
sites) on the CPU against the JAX package's: ``traceparent`` round
trips, the same hop sequence through both ``JourneyStore``s gives the
same rows (modulo the pid-derived span ids), the Kafka header decoders
give the same output on the same record sets, a poisoned Kafka-fed
pipeline gives the same hop kinds for the poisoned offset K in both
packages, the record engine's isolation leaves the same trail, and an
unarmed registry has no store and writes no file.

The port runs with ``device="cpu"``. Rows, offsets and kinds exactly."""

import json
import os
import threading
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
    data,
    gbm_path,
    models,
    twin,
)


def tpkg(name):
    if name == "jax":
        from flink_jpmml_tpu.obs import recorder as flight
        from flink_jpmml_tpu.obs import trace
        from flink_jpmml_tpu.runtime import kafka
        from flink_jpmml_tpu.utils import metrics
    else:
        from flink_jpmml_tpu_torch.obs import recorder as flight
        from flink_jpmml_tpu_torch.obs import trace
        from flink_jpmml_tpu_torch.runtime import kafka
        from flink_jpmml_tpu_torch.utils import metrics
    return types.SimpleNamespace(trace=trace, kafka=kafka, flight=flight,
                                 metrics=metrics)


@pytest.fixture(autouse=True)
def _clean_journey_env(monkeypatch):
    for name in ("FJT_JOURNEY_DIR", "FJT_JOURNEY_SYNC", "FJT_TRACE_DIR",
                 "FJT_RESTART_STREAK"):
        monkeypatch.delenv(name, raising=False)


# -- contexts ------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 1374, 2**40 + 3])
def test_traceparent_round_trips_like_the_jax_one(offset):
    from flink_jpmml_tpu.obs import trace as jtrace
    from flink_jpmml_tpu_torch.obs import trace as ttrace

    assert ttrace.trace_id_for(offset) == jtrace.trace_id_for(offset)
    ctx = ttrace.TraceContext(ttrace.trace_id_for(offset), "0123456789abcdef")
    jctx = jtrace.TraceContext(jtrace.trace_id_for(offset), "0123456789abcdef")
    tp = ctx.to_traceparent()
    assert tp == jctx.to_traceparent()
    assert tp.startswith("00-") and tp.endswith("-01")
    back = ttrace.TraceContext.from_traceparent(tp)
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    child = back.child()
    assert child.trace_id == ctx.trace_id and child.parent_id == ctx.span_id


@pytest.mark.parametrize("bad", [
    "", "garbage", "00-zz-yy-01", "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 15 + "-01", None, 17,
])
def test_malformed_traceparent_is_none_in_both(bad):
    from flink_jpmml_tpu.obs import trace as jtrace
    from flink_jpmml_tpu_torch.obs import trace as ttrace

    assert ttrace.TraceContext.from_traceparent(bad) is None
    assert jtrace.TraceContext.from_traceparent(bad) is None


def test_active_context_nests_like_the_jax_one():
    for name in TWINS:
        tr = tpkg(name).trace
        assert tr.current() is None
        a, b = tr.context_for(1), tr.context_for(2)
        with tr.use(a):
            assert tr.current() is a
            with tr.use(None):
                assert tr.current() is a  # None is a no-op
            with tr.use(b):
                assert tr.current() is b
            assert tr.current() is a
        assert tr.current() is None


# -- the journey store -----------------------------------------------------------

_PID_FIELDS = ("t", "pid", "span_id", "parent_id")


def _norm(rows):
    return [{k: v for k, v in r.items() if k not in _PID_FIELDS}
            for r in rows]


def _seq_tail(tr, store):
    kept, dropped = tr.context_for(0), tr.context_for(64)
    store.hop("dispatch", kept, 0, 64, model="m")
    store.mark(kept.trace_id, "exemplar")
    store.finish(kept, 0, 64, latency_s=0.5)
    store.hop("dispatch", dropped, 64, 64)
    store.finish(dropped, 64, 64, latency_s=0.001)


def _seq_head(tr, store):
    a, b = tr.context_for(0), tr.context_for(32)
    store.hop("dispatch", a, 0, 32)
    store.finish(a, 0, 32)
    store.hop("extra", a.child(), 0, 32)  # a kept journey continues
    store.hop("dispatch", b, 32, 32)
    store.finish(b, 32, 32)


def _seq_terminal(tr, store):
    ctx = tr.context_for(7)
    store.hop("dispatch", ctx, 7, 1)
    store.terminal("dlq", ctx.child(), offset=7, reason="score")
    store.terminal("shed", tr.context_for(40), 40, 8, lane="block")


def _seq_evict(tr, store):
    for i in range(tr._PENDING_TRACES + 10):
        store.hop("dispatch", tr.context_for(i), i, 1)


def _seq_write_through(tr, store):
    store.write_through = True
    for i in range(3):
        store.hop("dispatch", tr.context_for(i), i, 1)
    store.finish(tr.context_for(0), 0, 1, latency_s=0.25)


def _seq_ingest(tr, store):
    origin = tr.TraceContext(tr.trace_id_for(12345), "00000000000000aa")
    store.ingest(100, 50, partition=0,
                 traceparents={120: origin.to_traceparent(),
                               130: "not-a-traceparent"})
    store.ingest(150, 10)


def _seq_alarm(tr, store):
    store.note_alarm("drift", count=2)
    for i in range(4):
        ctx = tr.context_for(i)
        store.hop("dispatch", ctx, i, 1)
        store.finish(ctx, i, 1)


SEQUENCES = {
    "tail": (_seq_tail, {}), "head": (_seq_head, {"head_n": 1}),
    "terminal": (_seq_terminal, {}), "evict": (_seq_evict, {}),
    "write_through": (_seq_write_through, {}), "ingest": (_seq_ingest, {}),
    "alarm": (_seq_alarm, {}),
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_journey_store_rows_like_the_jax_one(seq, tmp_path):
    fn, kw = SEQUENCES[seq]
    got = {}
    for name in TWINS:
        pk = tpkg(name)
        m = pk.metrics.MetricsRegistry()
        kw2 = {"head_n": 0, "budget_frac": 1.0, **kw}
        store = pk.trace.JourneyStore(str(tmp_path / name), metrics=m, **kw2)
        store.write_through = False
        fn(pk.trace, store)
        store.close()
        rows = pk.trace.read_rows(store.directory)
        got[name] = (_norm(rows), m.struct_snapshot()["counters"])
    assert got["port"] == got["jax"]
    if seq == "ingest":
        redriven = [r for r in got["port"][0] if r.get("redriven")]
        assert [r["offset"] for r in redriven] == [120]


def test_ring_gc_and_torn_lines_like_the_jax_one(tmp_path):
    got = {}
    for name in TWINS:
        pk = tpkg(name)
        m = pk.metrics.MetricsRegistry()
        store = pk.trace.JourneyStore(str(tmp_path / name), metrics=m,
                                      max_bytes=4096, segment_bytes=512,
                                      head_n=0, budget_frac=1.0)
        store.write_through = True
        for i in range(200):
            store.hop("dispatch", pk.trace.context_for(i), i, 1,
                      pad="x" * 64)
        store.close()
        seg = sorted(os.listdir(store.directory))[-1]
        with open(os.path.join(store.directory, seg), "a") as f:
            f.write('{"torn": tr\n[\n]\n7\n')
        rows = pk.trace.read_rows(store.directory)
        total = sum(os.path.getsize(os.path.join(store.directory, s))
                    for s in os.listdir(store.directory))
        got[name] = ([r["first_off"] for r in rows],
                     m.struct_snapshot()["counters"], total <= 4096 + 1024)
    assert got["port"] == got["jax"]
    assert got["port"][2]


def test_store_for_gate_and_unarmed_writes_nothing(tmp_path, models,
                                                   monkeypatch):
    from flink_jpmml_tpu_torch.obs import trace
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    m = MetricsRegistry()
    assert trace.store_for(None) is None
    assert trace.store_for(m) is None and trace.peek(m) is None
    with pytest.raises(ValueError, match="FJT_JOURNEY_DIR"):
        trace.install(m)
    # an unarmed pipeline run: no store, no journey file anywhere
    pk = twin("port")
    monkeypatch.chdir(tmp_path)
    pipe = pk.block.BlockPipeline(
        pk.block.FiniteBlockSource(data(8 * B), B), models["port"],
        lambda *a: None, cfg(pk), metrics=m,
        checkpoint=pk.checkpoint.CheckpointManager(str(tmp_path / "ck")))
    pipe.run_until_exhausted(timeout=60)
    assert trace.store_for(m) is None
    assert not [p for _, _, fs in os.walk(tmp_path) for p in fs
                if p.startswith("journeys-")]
    # the env arms it at the first gate call
    monkeypatch.setenv("FJT_JOURNEY_DIR", str(tmp_path / "j"))
    store = trace.store_for(m)
    assert store is not None and trace.peek(m) is store
    assert trace.install(m) is store


# -- the Kafka header decoders -----------------------------------------------------


def _record_sets():
    """Record sets made by the JAX package's encoder (the port's has no
    producer-side headers)."""
    from flink_jpmml_tpu.obs import trace as jtrace
    from flink_jpmml_tpu.runtime.kafka import encode_record_batch

    tp = jtrace.TraceContext(jtrace.trace_id_for(99),
                             "00000000000000ff").to_traceparent().encode()
    vals = [json.dumps({"i": i}).encode() for i in range(6)]
    plain = encode_record_batch(10, vals)
    mixed = encode_record_batch(20, vals, headers=[
        None, [("traceparent", tp)], [("k", b"v"), ("traceparent", tp[:20])],
        [("a", b"")], None, [("traceparent", tp), ("x", b"\x00\xff")]])
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    fixed = encode_record_batch(0, [r.tobytes() for r in rows],
                                timestamp_ms=5)
    return {
        "plain": plain,
        "mixed": mixed,
        "two_batches": plain + mixed,
        "truncated": mixed + plain[:-7],
        "fixed_rows": fixed,
        "empty": b"",
    }


@pytest.mark.parametrize("case", sorted(_record_sets()))
def test_header_decoders_like_the_jax_ones(case):
    from flink_jpmml_tpu.runtime import kafka as jk
    from flink_jpmml_tpu_torch.runtime import kafka as tk

    buf = _record_sets()[case]
    assert tk.decode_record_batches_h(buf) == jk.decode_record_batches_h(buf)
    assert (tk.record_batch_traceparents(buf)
            == jk.record_batch_traceparents(buf))
    # the header-skipping decoder agrees on offsets and values
    assert [(o, v) for o, v, _ in tk.decode_record_batches_h(buf)] == \
        tk.decode_record_batches(buf)
    if case == "mixed":
        assert sorted(tk.record_batch_traceparents(buf)) == [21, 22, 25]


def test_header_decoders_reject_and_tolerate_like_the_jax_ones():
    from flink_jpmml_tpu.runtime import kafka as jk
    from flink_jpmml_tpu_torch.runtime import kafka as tk

    buf = bytearray(_record_sets()["mixed"])
    buf[-1] ^= 0xFF  # CRC mismatch: the decode raises, the walk returns
    for k in (jk, tk):
        with pytest.raises(ValueError, match="CRC32C"):
            k.decode_record_batches_h(bytes(buf))
    assert tk.record_batch_traceparents(bytes(buf)) == \
        jk.record_batch_traceparents(bytes(buf))
    buf = bytearray(_record_sets()["plain"])
    buf[16] = 1  # foreign magic
    for k in (jk, tk):
        with pytest.raises(ValueError, match="magic"):
            k.decode_record_batches_h(bytes(buf))
    assert tk.record_batch_traceparents(bytes(buf)) == {} == \
        jk.record_batch_traceparents(bytes(buf))


def test_record_source_picks_up_traceparents_like_the_jax_one(tmp_path):
    """A traceparent header on a record of the JAX broker's log reaches
    the port source's ingest hop as a redriven journey row, across a
    poll surplus (the header survives the next fetch)."""
    from flink_jpmml_tpu.runtime.kafka import MiniKafkaBroker

    got = {}
    for name in TWINS:
        pk = tpkg(name)
        broker = MiniKafkaBroker(topic="t")
        try:
            origin = pk.trace.TraceContext(pk.trace.trace_id_for(12345),
                                           "00000000000000aa")
            vals = [json.dumps({"i": i}).encode() for i in range(5)]
            broker.append(*vals, headers=[
                None, None, None, None,
                [("traceparent", origin.to_traceparent().encode())]])
            m = pk.metrics.MetricsRegistry()
            pk.trace.install(m, str(tmp_path / name))
            src = pk.kafka.KafkaRecordSource(broker.host, broker.port, "t",
                                             max_wait_ms=20, metrics=m)
            first = src.poll(3)
            broker.append(*[json.dumps({"i": i}).encode()
                            for i in range(5, 10)])
            second = src.poll(3)
            src.close()
            rows = pk.trace.read_rows(str(tmp_path / name))
            got[name] = ([(o, r["i"]) for o, r in first + second],
                         sorted(((r["kind"], r.get("first_off"), r.get("n"),
                                  r.get("offset"), r.get("redriven"),
                                  r["trace_id"], r.get("parent_id"))
                                 for r in rows), key=repr))
        finally:
            broker.close()
    assert got["port"] == got["jax"]
    redriven = [r for r in got["port"][1] if r[4]]
    assert redriven == [("ingest", None, None, 4, True,
                         pk.trace.trace_id_for(12345), "00000000000000aa")]


# -- journeys through the hot paths --------------------------------------------------

K = 97


def _kafka_poisoned(name, model, X, tmp_path):
    """One package's checkpointed BlockPipeline (DLQ beside the
    checkpoints) over its own loopback broker holding ``X``, journeys
    armed, a poison at offset K → (journey rows, DLQ envelopes,
    deliveries)."""
    pk, tk = twin(name), tpkg(name)
    m = pk.metrics.MetricsRegistry()
    # no overhead budget: at this size the bookkeeping is a large share
    # of a short wall, and the budget would drop K's buffered dispatch hop
    tk.trace.install(m, str(tmp_path / name / "j"), head_n=0,
                     budget_frac=1.0)
    pk.faults.inject("poison_record", offset=K)
    out = {}
    lock = threading.Lock()

    def sink(o, n, first):
        with lock:
            out[int(first)] = (int(n), np.asarray(o)[:n].copy())

    broker = tk.kafka.MiniKafkaBroker(topic="t")
    src = None
    try:
        broker.append_rows(X)
        src = tk.kafka.KafkaBlockSource(broker.host, broker.port, "t",
                                        n_cols=X.shape[1], metrics=m,
                                        max_wait_ms=5, max_bytes=4000)
        ckdir = str(tmp_path / name / "ck")
        pipe = pk.block.BlockPipeline(
            src, model, sink, cfg(pk), metrics=m, max_dispatch_chunks=1,
            checkpoint=pk.checkpoint.CheckpointManager(ckdir))
        pipe.start()
        deadline = time.monotonic() + 60
        while (pipe.committed_offset < X.shape[0] and pipe._error is None
               and time.monotonic() < deadline):
            time.sleep(0.005)
        pipe.stop()
        pipe.join(timeout=30)
    finally:
        if src is not None:
            src.close()
        broker.close()
        pk.faults.clear()
    rows = tk.trace.read_rows(str(tmp_path / name / "j"))
    envs = list(pk.dlq.DeadLetterQueue(os.path.join(ckdir, "dlq")).scan())
    return rows, envs, out


def _hops_of(rows, k, trace_id_for):
    """The kinds of the rows on offset k's journey: its own trace id, or
    a batch row whose range covers it."""
    tid = trace_id_for(k)
    kinds = set()
    for r in rows:
        lo, n = r.get("first_off"), r.get("n")
        covers = lo is not None and n is not None and lo <= k < lo + n
        if r["trace_id"] == tid or r.get("offset") == k or covers:
            kinds.add(r["kind"])
    return kinds


def test_poisoned_kafka_pipeline_journey_like_the_jax_one(models, tmp_path):
    X = data(12 * B, seed=21)
    got = {}
    for name in TWINS:
        rows, envs, out = _kafka_poisoned(name, models[name], X, tmp_path)
        got[name] = (_hops_of(rows, K, tpkg(name).trace.trace_id_for),
                     rows, envs, out)
    (jk, jrows, jenvs, jout), (tkinds, trows, tenvs, tout) = (
        got["jax"], got["port"])
    assert tkinds == jk
    assert {"ingest", "dispatch", "suspect_scan", "dlq"} <= tkinds
    dlq = [r for r in trows if r["kind"] == "dlq"]
    assert [(r["offset"], r["reason"]) for r in dlq] == [(K, "score")]
    assert dlq[0]["trace_id"] == tpkg("port").trace.trace_id_for(K)
    assert [e["offset"] for e in tenvs] == [e["offset"] for e in jenvs] == [K]
    assert (tenvs[0]["trace_id"], tenvs[0]["span_id"]) == (
        dlq[0]["trace_id"], dlq[0]["span_id"])
    assert any(r["kind"] == "sink" and r.get("isolated") for r in trows)
    # the deliveries skip exactly K, as the JAX pipeline's (how records
    # fall into batches follows fetch timing, so only the offsets delivered
    # are compared, not the batch boundaries)
    def delivered(out):
        return sorted(o + i for o, (n, _) in out.items() for i in range(n))

    assert delivered(tout) == delivered(jout) == [
        i for i in range(12 * B) if i != K]


def test_shed_terminal_hop_like_the_jax_one(models, tmp_path):
    got = {}
    for name in TWINS:
        pk, tk = twin(name), tpkg(name)
        if name == "jax":
            from flink_jpmml_tpu.serving.overload import AdmissionController
        else:
            from flink_jpmml_tpu_torch.serving.overload import (
                AdmissionController,
            )
        m = pk.metrics.MetricsRegistry()
        store = tk.trace.install(m, str(tmp_path / name), head_n=0)
        store.write_through = False
        adm = AdmissionController(m, lanes=("block",))
        adm._level = 1  # shed everything on the block lane
        sunk = []
        pipe = pk.block.BlockPipeline(
            pk.block.FiniteBlockSource(data(4 * B), B), models[name],
            lambda *a: sunk.append(a), cfg(pk), metrics=m,
            max_dispatch_chunks=1, admission=adm)
        pipe.run_until_exhausted(timeout=60)
        rows = tk.trace.read_rows(store.directory)
        got[name] = (sunk, sorted((r["kind"], r["first_off"], r["n"],
                                   r["lane"], r["trace_id"])
                                  for r in rows))
    assert got["port"] == got["jax"]
    assert [r[1] for r in got["port"][1]] == [0, B, 2 * B, 3 * B]


def test_engine_isolation_journey_like_the_jax_one(gbm_path, tmp_path):
    """The record engine's dispatch / suspect_scan / dlq / isolated sink
    trail for a poisoned record, in both packages."""
    got = {}
    n = 100
    rows_in = [list(map(float, r)) for r in np.nan_to_num(data(n, seed=3))]
    for name in TWINS:
        pk, tk = twin(name), tpkg(name)
        m = pk.metrics.MetricsRegistry()
        store = tk.trace.install(m, str(tmp_path / name / "j"), head_n=2,
                                 budget_frac=1.0)
        store.write_through = False
        pk.faults.inject("poison_record", offset=56)
        model = pk.api.ModelReader(gbm_path).load(batch_size=B, **pk.kw)
        sink = pk.sinks.CollectSink()
        pipe = pk.engine.Pipeline(
            pk.sources.InMemorySource(rows_in),
            pk.engine.StaticScorer(model), sink, cfg(pk), metrics=m,
            checkpoint=pk.checkpoint.CheckpointManager(
                str(tmp_path / name / "ck")))
        pipe.run_until_exhausted(timeout=60)
        pk.faults.clear()
        rows = tk.trace.read_rows(store.directory)
        got[name] = (len(sink.items), _hops_of(rows, 56,
                                               tk.trace.trace_id_for),
                     sorted((r["kind"], r.get("offset"), r.get("reason"))
                            for r in rows if r["kind"] == "dlq"),
                     any(r["kind"] == "sink" and r.get("isolated")
                         for r in rows))
    assert got["port"] == got["jax"]
    assert got["port"][0] == n - 1
    assert {"dispatch", "suspect_scan", "dlq"} <= got["port"][1]
    assert got["port"][2] == [("dlq", 56, "score")]
    assert got["port"][3]  # the isolation's clean runs are durable


def test_exemplar_marks_and_names_a_kept_journey(models, tmp_path):
    """The port's stage ledger uses the active journey's trace id as its
    exemplar and marks the journey kept, as the JAX ledger does."""
    pk, tk = twin("port"), tpkg("port")
    m = pk.metrics.MetricsRegistry()
    store = tk.trace.install(m, str(tmp_path / "j"), head_n=0)
    store.write_through = False
    tk.flight.DEFAULT.clear()
    pipe = pk.block.BlockPipeline(
        pk.block.FiniteBlockSource(data(8 * B), B), models["port"],
        lambda *a: None, cfg(pk), metrics=m, max_dispatch_chunks=1)
    pipe.run_until_exhausted(timeout=60)
    rows = tk.trace.read_rows(store.directory)
    by_id = {}
    for r in rows:
        by_id.setdefault(r["trace_id"], set()).add(r["kind"])
    complete = {t for t, k in by_id.items() if {"dispatch", "sink"} <= k}
    ex = {e.get("trace_id") for e in tk.flight.events()
          if e.get("kind") == "latency_exemplar"}
    assert complete and complete & ex
