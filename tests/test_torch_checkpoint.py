"""Checkpoints and restore of the port on the CPU against the JAX
package's: the same policy writes the same checkpoint JSON (timestamps
aside), an injected ``checkpoint_write`` failure and a full disk behave
alike, and ``restore()`` resumes at the same offset on both hot paths —
the block pipeline, and the record engine (static, and dynamic through
``with_checkpointing`` / ``execute(restore=True)``).

Both packages get the same seeded records and the same fault plan, each
in its own ``faults`` module; the port runs with ``device="cpu"`` (the
kernel's plain version). Outputs are compared at rtol 1e-4 / atol 1e-5,
offsets exactly. The JAX package's retry schedule is shortened with its
``FJT_RETRY_*`` knobs, the port's (which reads none) by handing its
checkpoint writer the same short :class:`Backoff`.

``Twin`` and the runners here are shared by the DLQ, device-fault and
dynamic-block test files."""

import functools
import json
import os
import types

import numpy as np
import pytest

RTOL, ATOL = 1e-4, 1e-5
B = 32
F = 5


def twin(name: str) -> types.SimpleNamespace:
    """One package's recovery surface under common names."""
    if name == "jax":
        from flink_jpmml_tpu import api
        from flink_jpmml_tpu.compile import compile_pmml
        from flink_jpmml_tpu.models import control
        from flink_jpmml_tpu.obs import recorder
        from flink_jpmml_tpu.pmml import parse_pmml_file
        from flink_jpmml_tpu.runtime import (
            block, checkpoint, devfault, dlq, engine, faults, sinks, sources,
        )
        from flink_jpmml_tpu.serving import block as sblock
        from flink_jpmml_tpu.serving import failover, scorer
        from flink_jpmml_tpu.utils import config, metrics, retry

        def compile_(path, batch=B):
            return compile_pmml(parse_pmml_file(path), batch_size=batch)

        kw = {}
    else:
        from flink_jpmml_tpu_torch import api
        from flink_jpmml_tpu_torch.compile import compile_pmml
        from flink_jpmml_tpu_torch.models import control
        from flink_jpmml_tpu_torch.obs import recorder
        from flink_jpmml_tpu_torch.pmml import parse_pmml_file
        from flink_jpmml_tpu_torch.runtime import (
            block, checkpoint, devfault, dlq, engine, faults, sinks, sources,
        )
        from flink_jpmml_tpu_torch.serving import block as sblock
        from flink_jpmml_tpu_torch.serving import failover, scorer
        from flink_jpmml_tpu_torch.utils import config, metrics, retry

        def compile_(path, batch=B):
            return compile_pmml(parse_pmml_file(path), batch_size=batch,
                                device="cpu")

        kw = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, api=api, compile=compile_, control=control,
        flight=recorder, block=block, checkpoint=checkpoint,
        devfault=devfault, dlq=dlq, engine=engine, faults=faults,
        sinks=sinks, sources=sources, sblock=sblock, failover=failover,
        scorer=scorer, config=config, metrics=metrics, retry=retry, kw=kw,
    )


TWINS = ("jax", "port")


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """No fault plan leaks between tests; short retry schedules on both
    sides (the JAX package's knobs; the port's checkpoint Backoff)."""
    from flink_jpmml_tpu.runtime import faults as jf
    from flink_jpmml_tpu_torch.runtime import checkpoint as tck
    from flink_jpmml_tpu_torch.runtime import faults as tf
    from flink_jpmml_tpu_torch.utils import retry as tretry

    monkeypatch.setenv("FJT_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("FJT_RETRY_CAP_S", "0.002")
    monkeypatch.setattr(tck, "Backoff", functools.partial(
        tretry.Backoff, base_s=0.001, cap_s=0.002))
    for name in ("FJT_FAILOVER", "FJT_RESTART_STREAK",
                 "FJT_POISON_RESTARTS", "FJT_DEVICE_RETRIES"):
        monkeypatch.delenv(name, raising=False)
    jf.clear()
    tf.clear()
    yield
    jf.clear()
    tf.clear()


@pytest.fixture(scope="module")
def gbm_path(tmp_path_factory):
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm

    return gen_gbm(str(tmp_path_factory.mktemp("ckpt-gbm")), n_trees=8,
                   depth=3, n_features=F)


@pytest.fixture(scope="module")
def models(gbm_path):
    return {name: twin(name).compile(gbm_path) for name in TWINS}


def data(n, seed=0, cols=F):
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.5, size=(n, cols)).astype(np.float32)
    X[rng.random(size=X.shape) < 0.15] = np.nan
    return X


def cfg(pk, interval_s=0.0, batch=B):
    return pk.config.RuntimeConfig(
        batch=pk.config.BatchConfig(size=batch, deadline_us=2000),
        checkpoint_interval_s=interval_s,
    )


def run_block(pk, model, X, ckdir=None, *, restore=False, chunks=1,
              dlq=None, failover=None, interval_s=0.0, metrics=None,
              expect=None):
    """A ``BlockPipeline`` over ``X`` in blocks of B → (pipeline,
    deliveries as (first offset, n, values)). ``expect``: the exception
    type the run must raise."""
    out = []

    def sink(o, n, first):
        out.append((int(first), int(n), np.asarray(o)[:n].copy()))

    pipe = pk.block.BlockPipeline(
        pk.block.FiniteBlockSource(X, B), model, sink, cfg(pk, interval_s),
        metrics=metrics or pk.metrics.MetricsRegistry(),
        checkpoint=(pk.checkpoint.CheckpointManager(ckdir)
                    if ckdir else None),
        max_dispatch_chunks=chunks, dlq=dlq, failover=failover,
    )
    if restore:
        pipe.restore()
    if expect is None:
        pipe.run_until_exhausted(timeout=60)
    else:
        with pytest.raises(expect):
            pipe.run_until_exhausted(timeout=60)
    return pipe, out


def same_deliveries(got, ref):
    assert [(o, n) for o, n, _ in got] == [(o, n) for o, n, _ in ref]
    for (_, _, g), (_, _, r) in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


def coverage(deliveries, n):
    cov = np.zeros(n, np.int64)
    for off, cnt, _ in deliveries:
        cov[off:off + cnt] += 1
    return cov


def snapshots(d):
    """Every retained checkpoint file's JSON, oldest first, without its
    timestamp."""
    names = sorted(x for x in os.listdir(d) if x.startswith("ckpt-"))
    out = []
    for x in names:
        with open(os.path.join(d, x)) as f:
            doc = json.load(f)
        assert set(doc) == {"timestamp", "state"}
        out.append(doc["state"])
    return out


def counters(metrics) -> dict:
    return metrics.struct_snapshot()["counters"]


# -- the block pipeline -------------------------------------------------------


def test_block_checkpoints_write_the_same_json(models, tmp_path):
    X = data(20 * B)
    runs = {}
    for name in TWINS:
        d = str(tmp_path / name)
        pipe, out = run_block(twin(name), models[name], X, d)
        runs[name] = (snapshots(d), out, pipe.committed_offset)
    (js, jo, jc), (ts, to, tc) = runs["jax"], runs["port"]
    assert ts == js and len(ts) == 3  # the retention keeps three
    assert ts[-1] == {"source_offset": 20 * B, "inflight_hi": 20 * B}
    assert tc == jc == 20 * B
    same_deliveries(to, jo)


def test_block_restore_resumes_at_the_same_offset(models, tmp_path):
    X = data(24 * B, seed=1)
    k = 9 * B + 7  # mid-batch: the first run ends with a short drain
    got = {}
    for name in TWINS:
        pk = twin(name)
        d = str(tmp_path / name)
        run_block(pk, models[name], X[:k], d)
        pipe, out = run_block(pk, models[name], X, d, restore=True)
        assert pipe.committed_offset == len(X)
        got[name] = out
    assert got["port"][0][0] == got["jax"][0][0] == k
    same_deliveries(got["port"], got["jax"])
    cov = coverage(got["port"], len(X))
    assert (cov[:k] == 0).all() and (cov[k:] == 1).all()


def test_restore_without_a_checkpoint_is_false_on_both(models, tmp_path):
    for name in TWINS:
        pk = twin(name)
        pipe = pk.block.BlockPipeline(
            pk.block.FiniteBlockSource(data(B), B), models[name],
            lambda *a: None, cfg(pk),
            checkpoint=pk.checkpoint.CheckpointManager(
                str(tmp_path / name)))
        assert pipe.restore() is False
        assert pipe.committed_offset == 0


# -- checkpoint write failures ------------------------------------------------


def test_transient_write_failure_retries_alike(models, tmp_path):
    X = data(6 * B, seed=2)
    runs = {}
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("checkpoint_fail", n=2)
        d = str(tmp_path / name)
        pipe, out = run_block(pk, models[name], X, d)
        kinds = [e["kind"] for e in pk.flight.events()]
        runs[name] = (snapshots(d)[-1], pk.faults.stats(), out,
                      kinds.count("checkpoint_save_retry") >= 2)
        pk.faults.clear()
    assert runs["port"][:2] == runs["jax"][:2]
    assert runs["port"][1] == {"checkpoint_fail": 2}
    assert runs["port"][3] and runs["jax"][3]
    same_deliveries(runs["port"][2], runs["jax"][2])


def test_full_disk_suspends_then_resumes_alike(models, tmp_path,
                                               monkeypatch):
    from flink_jpmml_tpu_torch.runtime import checkpoint as tck
    from flink_jpmml_tpu_torch.utils import retry as tretry

    # two attempts a streak on both sides
    monkeypatch.setenv("FJT_RETRY_MAX", "2")
    monkeypatch.setattr(tck, "Backoff", functools.partial(
        tretry.Backoff, base_s=0.001, cap_s=0.002, max_attempts=2))
    X = data(30 * B, seed=3)
    runs = {}
    for name in TWINS:
        pk = twin(name)
        # ENOSPC for the first 8 write attempts, then the space returns
        pk.faults.inject("checkpoint_fail", errno=28, n=8)
        m = pk.metrics.MetricsRegistry()
        d = str(tmp_path / name)
        pipe, out = run_block(pk, models[name], X, d, metrics=m)
        kinds = [e["kind"] for e in pk.flight.events()]
        gauge = m.struct_snapshot()["gauges"]["checkpoint_suspended"]
        runs[name] = (
            "checkpoint_suspended" in kinds, "checkpoint_resumed" in kinds,
            gauge["value"], pk.faults.stats(),
            pk.checkpoint.CheckpointManager(d).load_latest(),
        )
        assert (coverage(out, len(X)) == 1).all()  # serving never stopped
        pk.faults.clear()
    assert runs["port"] == runs["jax"]
    assert runs["port"][:3] == (True, True, 0.0)
    assert runs["port"][4]["source_offset"] == len(X)


def test_persistent_write_failure_raises_alike(models, tmp_path,
                                               monkeypatch):
    from flink_jpmml_tpu_torch.runtime import checkpoint as tck
    from flink_jpmml_tpu_torch.utils import retry as tretry

    monkeypatch.setenv("FJT_RETRY_MAX", "2")
    monkeypatch.setattr(tck, "Backoff", functools.partial(
        tretry.Backoff, base_s=0.001, cap_s=0.002, max_attempts=2))
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("checkpoint_fail")  # persistent, no errno
        from_pkg = __import__(
            f"{'flink_jpmml_tpu' if name == 'jax' else 'flink_jpmml_tpu_torch'}"
            ".utils.exceptions", fromlist=["CheckpointException"])
        run_block(pk, models[name], data(10 * B), str(tmp_path / name),
                  expect=from_pkg.CheckpointException)
        pk.faults.clear()


# -- the record engine ----------------------------------------------------------


def run_records(pk, model, records, ckdir, restore=False):
    sink = pk.sinks.CollectSink()
    pipe = pk.engine.Pipeline(
        pk.sources.InMemorySource(records), pk.engine.StaticScorer(model),
        sink, cfg(pk, 0.0),
        checkpoint=pk.checkpoint.CheckpointManager(ckdir),
    )
    if restore:
        assert pipe.restore() is True
    pipe.run_until_exhausted(timeout=60)
    return pipe, sink.items


def values(preds):
    return np.array([p.score.value for p in preds])


def test_record_engine_checkpoint_and_restore(models, tmp_path):
    recs = [list(map(float, r)) for r in data(200, seed=4)]
    k = 120
    runs = {}
    for name in TWINS:
        pk = twin(name)
        d = str(tmp_path / name)
        first, items1 = run_records(pk, models[name], recs[:k], d)
        state1 = snapshots(d)[-1]
        second, items2 = run_records(pk, models[name], recs, d,
                                     restore=True)
        runs[name] = (state1, snapshots(d)[-1], values(items1),
                      values(items2), second.committed_offset)
    j, t = runs["jax"], runs["port"]
    assert t[0] == j[0] == {"source_offset": k, "inflight_hi": k,
                            "scorer": {}}
    assert t[1] == j[1] and t[4] == j[4] == len(recs)
    assert len(t[3]) == len(recs) - k  # resumed at k: the rest only
    np.testing.assert_allclose(t[2], j[2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[3], j[3], rtol=RTOL, atol=ATOL)


def test_stream_api_with_checkpointing_restores_the_dynamic_scorer(
        gbm_path, tmp_path):
    """``with_control_stream(ctrl).evaluate(...).with_checkpointing(dir)``
    then ``execute(restore=True)`` in a fresh environment: the offset and
    the scorer's served-model registry come back on both packages."""
    X = data(150, seed=5)
    events = [("gbm", list(map(float, r))) for r in X]
    k = 90
    runs = {}
    for name in TWINS:
        pk = twin(name)
        d = str(tmp_path / name)
        got = []
        for evs, ctrl_msgs in ((events[:k], True), (events, False)):
            env = pk.api.StreamEnvironment(cfg(pk, 0.0), **pk.kw)
            ctrl = pk.sources.ControlSource()
            if ctrl_msgs:
                ctrl.push(pk.control.AddMessage("gbm", 1, gbm_path, 1.0))
            sink = (env.from_collection(evs).with_control_stream(ctrl)
                    .evaluate(pk.api.ModelReader(gbm_path))
                    .with_checkpointing(d).collect())
            env.execute(timeout=60, restore=True)
            got.append([p for p, _ in sink.items])
        state = snapshots(d)[-1]
        runs[name] = (got, state)
    (jg, js), (tg, ts) = runs["jax"], runs["port"]
    assert ts == js
    assert ts["source_offset"] == len(events)
    assert ts["scorer"] == {"served": {"gbm_1": gbm_path}}
    assert [len(g) for g in tg] == [k, len(events) - k]
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(values(a), values(b), rtol=RTOL,
                                   atol=ATOL)
