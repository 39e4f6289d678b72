"""Poison isolation and the dead-letter queue of the port on the CPU
against the JAX package's: the same quarantined offsets and the same
envelope fingerprints, the same sink outputs on the block pipeline and
the record engine, and crash-loop suspect mode entering and exiting
alike (a restart streak over the checkpoint's replay region, and a
death marker that quarantines its record without dispatching it).

The same seeded records and the same ``poison_record`` plan drive both
packages (each through its own ``faults`` module); the port runs with
``device="cpu"``. Values at rtol 1e-4 / atol 1e-5; offsets, reasons and
fingerprints exactly."""

import numpy as np

from test_torch_checkpoint import (  # noqa: F401  (fixtures)
    ATOL,
    B,
    RTOL,
    TWINS,
    _clean_faults,
    cfg,
    coverage,
    data,
    gbm_path,
    models,
    run_block,
    same_deliveries,
    twin,
    values,
)


def envelopes(q):
    """(offset, reason, fingerprint, attempts, model) of every envelope,
    offset order."""
    return sorted((int(e["offset"]), e["reason"], e["fingerprint"],
                   int(e["attempts"]), e.get("model")) for e in q.scan())


def test_block_poison_quarantines_the_same_offsets(models, tmp_path):
    X = data(40 * B, seed=6)
    poison = (5, 333, 1000, 1279)
    runs = {}
    for name in TWINS:
        pk = twin(name)
        for off in poison:
            pk.faults.inject("poison_record", offset=off)
        m = pk.metrics.MetricsRegistry()
        pipe, out = run_block(pk, models[name], X, str(tmp_path / name),
                              metrics=m)
        pk.faults.clear()
        runs[name] = (envelopes(pipe._dlq), out, pipe.committed_offset,
                      m.struct_snapshot()["counters"].get("records_out"),
                      m.struct_snapshot()["gauges"]["poison_suspect_mode"])
    j, t = runs["jax"], runs["port"]
    assert t[0] == j[0]
    assert [e[0] for e in t[0]] == list(poison)
    assert {e[1] for e in t[0]} == {"score"}
    assert [e[4] for e in t[0]] == ["static"] * len(poison)
    same_deliveries(t[1], j[1])
    cov = coverage(t[1], len(X))
    assert (cov[list(poison)] == 0).all()
    assert (np.delete(cov, list(poison)) == 1).all()
    assert t[2:] == j[2:]
    assert t[2] == len(X) and t[3] == len(X) - len(poison)
    assert t[4]["value"] == 0.0


def test_block_poison_in_an_aggregated_dispatch(models, tmp_path):
    # four batches a dispatch: the bisection splits a 128-record range
    X = data(32 * B, seed=7)
    runs = {}
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("poison_record", offset=700)
        pipe, out = run_block(pk, models[name], X, str(tmp_path / name),
                              chunks=4)
        pk.faults.clear()
        runs[name] = (envelopes(pipe._dlq), out)
    assert runs["port"][0] == runs["jax"][0]
    assert [e[0] for e in runs["port"][0]] == [700]
    # the records reach the sink once each either way; the split into
    # dispatches follows the ring's timing, so compare by offset
    for name in TWINS:
        cov = coverage(runs[name][1], len(X))
        assert cov[700] == 0 and (np.delete(cov, 700) == 1).all()
    vals = {name: np.concatenate([v for _, _, v in sorted(
        runs[name][1], key=lambda d: d[0])]) for name in TWINS}
    np.testing.assert_allclose(vals["port"], vals["jax"], rtol=RTOL,
                               atol=ATOL)


def test_poison_without_a_dlq_fails_fast_on_both(models):
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("poison_record", offset=40)
        run_block(pk, models[name], data(4 * B), None,
                  expect=pk.faults.InjectedPoisonRecord)
        pk.faults.clear()


def test_dlq_overflow_aborts_isolation_on_both(models, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("FJT_DLQ_MAX_PER_BATCH", "2")
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("poison_record", every=10)
        run_block(pk, models[name], data(4 * B), str(tmp_path / name),
                  expect=pk.dlq.PoisonIsolationOverflow)
        pk.faults.clear()


def test_record_engine_poison_quarantines_alike(models, tmp_path):
    recs = [list(map(float, r)) for r in data(160, seed=8)]
    poison = (0, 41, 42, 159)  # record offsets (a stamp's offset − 1)
    runs = {}
    for name in TWINS:
        pk = twin(name)
        for off in poison:
            pk.faults.inject("poison_record", offset=off)
        sink = pk.sinks.CollectSink()
        pipe = pk.engine.Pipeline(
            pk.sources.InMemorySource(recs), pk.engine.StaticScorer(
                models[name]), sink, cfg(pk, 0.0),
            checkpoint=pk.checkpoint.CheckpointManager(
                str(tmp_path / name)))
        pipe.run_until_exhausted(timeout=60)
        pk.faults.clear()
        runs[name] = (envelopes(pipe._dlq), values(sink.items),
                      pipe.committed_offset)
    j, t = runs["jax"], runs["port"]
    assert t[0] == j[0]
    assert [e[0] for e in t[0]] == list(poison)
    assert len(t[1]) == len(recs) - len(poison)
    np.testing.assert_allclose(t[1], j[1], rtol=RTOL, atol=ATOL)
    assert t[2] == j[2] == len(recs)


# -- crash-loop suspect mode ----------------------------------------------------


def test_block_suspect_mode_enters_and_exits_alike(models, tmp_path,
                                                   monkeypatch):
    """A restart streak at restore flips the checkpoint's replay region
    into suspect mode: scored synchronously under persisted markers, then
    left once the committed offset passes it. A death marker on one
    record quarantines it as ``crash_loop`` without a dispatch."""
    X = data(12 * B, seed=9)
    k = 4 * B
    marked = k + 3
    runs = {}
    for name in TWINS:
        pk = twin(name)
        d = str(tmp_path / name)
        run_block(pk, models[name], X[:k], d)
        # the previous incarnation died dispatching exactly `marked`
        pk.dlq.CrashFingerprint(d).write_marker(marked, marked + 1, 2)
        monkeypatch.setenv("FJT_RESTART_STREAK", "3")
        out = []
        pipe = pk.block.BlockPipeline(
            pk.block.FiniteBlockSource(X, B), models[name],
            lambda o, n, f: out.append((int(f), int(n),
                                        np.asarray(o)[:n].copy())),
            cfg(pk), checkpoint=pk.checkpoint.CheckpointManager(d),
            max_dispatch_chunks=1)
        assert pipe.restore() is True
        entered = (pipe._suspect_until,
                   pipe.metrics.struct_snapshot()["gauges"][
                       "poison_suspect_mode"]["value"])
        pipe.run_until_exhausted(timeout=60)
        monkeypatch.delenv("FJT_RESTART_STREAK")
        kinds = [e["kind"] for e in pk.flight.events()]
        runs[name] = (
            entered, pipe._suspect_until,
            pipe.metrics.struct_snapshot()["gauges"][
                "poison_suspect_mode"]["value"],
            envelopes(pipe._dlq), out, pipe.committed_offset,
            "poison_suspect_mode" in kinds, "poison_suspect_exit" in kinds,
            pk.dlq.CrashFingerprint(d).read_marker(),
        )
    j, t = runs["jax"], runs["port"]
    assert t[0] == j[0] == (k + B, 1.0)  # entered at restore
    assert t[1:4] == j[1:4]
    assert t[1] is None and t[2] == 0.0  # and left
    assert t[3] == [(marked, "crash_loop", t[3][0][2], 2, "static")]
    same_deliveries(t[4], j[4])
    assert t[5:] == j[5:] == (len(X), True, True, None)
    cov = coverage(t[4], len(X))
    assert cov[marked] == 0 and (cov[k:marked] == 1).all()
    assert (cov[marked + 1:] == 1).all()


def test_record_engine_suspect_mode_enters_and_exits_alike(
        models, tmp_path, monkeypatch):
    recs = [list(map(float, r)) for r in data(120, seed=10)]
    k = 48
    runs = {}
    for name in TWINS:
        pk = twin(name)
        d = str(tmp_path / name)

        def pipeline(records):
            sink = pk.sinks.CollectSink()
            return pk.engine.Pipeline(
                pk.sources.InMemorySource(records),
                pk.engine.StaticScorer(models[name]), sink, cfg(pk, 0.0),
                checkpoint=pk.checkpoint.CheckpointManager(d)), sink

        first, _ = pipeline(recs[:k])
        first.run_until_exhausted(timeout=60)
        pk.faults.inject("poison_record", offset=k + 5)
        monkeypatch.setenv("FJT_RESTART_STREAK", "3")
        pipe, sink = pipeline(recs)
        assert pipe.restore() is True
        entered = pipe._suspect_until
        pipe.run_until_exhausted(timeout=60)
        monkeypatch.delenv("FJT_RESTART_STREAK")
        pk.faults.clear()
        runs[name] = (entered, pipe._suspect_until, envelopes(pipe._dlq),
                      values(sink.items), pipe.committed_offset)
    j, t = runs["jax"], runs["port"]
    assert t[0] == j[0] == k + B
    assert t[1] is None and j[1] is None
    assert t[2] == j[2] and [e[0] for e in t[2]] == [k + 5]
    np.testing.assert_allclose(t[3], j[3], rtol=RTOL, atol=ATOL)
    assert t[4] == j[4] == len(recs)
