"""The framed-TCP feed of the port (``runtime/net.py``) on the CPU
against the JAX package's: the ``FJT1`` frames of either package's
``BlockFrameServer`` feed either package's sources with the same rows
and offsets, ``seek`` replays from the same offset, a record source
resumes mid-frame at the checkpointed offset, a TCP-fed port
``BlockPipeline`` scores what the JAX one scores, and a kill and resume
through checkpoints sinks every offset exactly once.

Loopback sockets only. The port runs with ``device="cpu"``; rows and
offsets exactly, values at rtol 1e-4 / atol 1e-5."""

import threading
import time

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
    twin,
)

RTOL, ATOL = 1e-4, 1e-5


def net(name):
    if name == "jax":
        from flink_jpmml_tpu.runtime import net
    else:
        from flink_jpmml_tpu_torch.runtime import net
    return net


def _drain_blocks(src, n_total, timeout=10.0):
    got, count = [], 0
    deadline = time.monotonic() + timeout
    while count < n_total and time.monotonic() < deadline:
        polled = src.poll()
        if polled is None:
            if src.exhausted:
                break
            time.sleep(0.001)
            continue
        off, blk = polled
        got.append((off, np.array(blk)))
        count += blk.shape[0]
    return got


@pytest.mark.parametrize("server", TWINS)
@pytest.mark.parametrize("client", TWINS)
def test_frames_cross_between_the_packages(server, client):
    X = data(1000, seed=1, cols=6)
    srv = net(server).BlockFrameServer(X, block_size=128)
    try:
        src = net(client).TcpBlockSource("127.0.0.1", srv.port, arity=6)
        got = _drain_blocks(src, 1000)
        pos = 0
        for off, blk in got:
            assert off == pos
            np.testing.assert_array_equal(blk, X[off:off + len(blk)])
            pos += len(blk)
        assert pos == 1000
        assert src.poll() is None and src.exhausted  # end of stream
        src.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("name", TWINS)
def test_seek_replays_from_an_offset(name):
    X = np.arange(200 * 2, dtype=np.float32).reshape(200, 2)
    srv = net(name).BlockFrameServer(X, block_size=64)
    try:
        src = net("port").TcpBlockSource("127.0.0.1", srv.port)
        _drain_blocks(src, 200)
        assert src.poll() is None and src.exhausted
        src.seek(150)
        got = _drain_blocks(src, 50)
        assert got[0][0] == 150
        assert sum(len(b) for _, b in got) == 50
        np.testing.assert_array_equal(np.concatenate([b for _, b in got]),
                                      X[150:])
        src.close()
    finally:
        srv.stop()


def test_record_source_resumes_mid_frame_like_the_jax_one():
    records = [{"f0": float(i), "f1": float(-i)} for i in range(100)]
    got = {}
    for name in TWINS:
        nm = net(name)
        srv = nm.BlockFrameServer(records, block_size=7)
        try:
            src1 = nm.TcpRecordSource("127.0.0.1", srv.port)
            first = []
            deadline = time.monotonic() + 10.0
            while len(first) < 28 and time.monotonic() < deadline:
                first.extend(src1.poll(28 - len(first)))
            src1.close()
            k = first[23][0]  # committed through record 24: mid-frame
            src2 = nm.TcpRecordSource("127.0.0.1", srv.port)
            src2.seek(k)
            rest = []
            deadline = time.monotonic() + 10.0
            while not src2.exhausted and time.monotonic() < deadline:
                rest.extend(src2.poll(1024))
            src2.close()
            got[name] = (k, first[:24] + rest)
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    k, recs = got["port"]
    assert k == 24
    assert [o for o, _ in recs] == list(range(1, 101))
    assert [r for _, r in recs] == records


def _tcp_pipeline(name, model, X, ckdir=None, stop_at=None, block=100):
    """A TCP-fed BlockPipeline of one package → (deliveries, committed).
    ``stop_at`` stops it once that many records committed (the kill)."""
    pk, nm = twin(name), net(name)
    out = []
    lock = threading.Lock()

    def sink(o, n, first):
        with lock:
            out.append((int(first), int(n), np.asarray(o)[:n].copy()))

    srv = nm.BlockFrameServer(X, block_size=block)
    src = nm.TcpBlockSource("127.0.0.1", srv.port, arity=X.shape[1])
    try:
        pipe = pk.block.BlockPipeline(
            src, model, sink, cfg(pk, 0.0), metrics=pk.metrics.MetricsRegistry(),
            checkpoint=(pk.checkpoint.CheckpointManager(ckdir)
                        if ckdir else None))
        if stop_at is None:
            pipe.run_until_exhausted(timeout=60)
        else:
            if ckdir and pipe.restore():
                assert pipe.committed_offset > 0
            pipe.start()
            deadline = time.monotonic() + 30
            while (pipe.committed_offset < stop_at and pipe._error is None
                   and time.monotonic() < deadline):
                time.sleep(0.002)
            pipe.stop()
            pipe.join(timeout=30)
        return out, pipe.committed_offset
    finally:
        src.close()
        srv.stop()


def test_tcp_fed_pipeline_scores_like_the_jax_one(models):
    X = data(40 * B, seed=7)
    runs = {name: _tcp_pipeline(name, models[name], X) for name in TWINS}
    for name in TWINS:
        out, committed = runs[name]
        assert committed == 40 * B
        assert (coverage(out, 40 * B) == 1).all()
    order = {name: np.concatenate([v for _, _, v in sorted(
        runs[name][0], key=lambda d: d[0])]) for name in TWINS}
    np.testing.assert_allclose(order["port"], order["jax"],
                               rtol=RTOL, atol=ATOL)


def test_kill_and_resume_sinks_every_offset_once(models, tmp_path):
    X = data(60 * B, seed=8)
    ck = str(tmp_path / "ck")
    first, c1 = _tcp_pipeline("port", models["port"], X, ck,
                              stop_at=10 * B)
    assert 0 < c1 < 60 * B
    second, c2 = _tcp_pipeline("port", models["port"], X, ck,
                               stop_at=60 * B)
    assert c2 == 60 * B
    # checkpoints every batch: the restore resumes at the committed
    # offset, so nothing is lost and nothing is sunk twice
    assert (coverage(first + second, 60 * B) == 1).all()
    ref, _ = _tcp_pipeline("jax", models["jax"], X)
    got = np.concatenate([v for _, _, v in sorted(first + second,
                                                  key=lambda d: d[0])])
    want = np.concatenate([v for _, _, v in sorted(ref,
                                                   key=lambda d: d[0])])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_source_survives_a_server_restart():
    nm = net("port")
    X = np.arange(600 * 3, dtype=np.float32).reshape(600, 3)
    srv = nm.BlockFrameServer(X, block_size=50, throttle_s=0.02)
    port = srv.port
    src = nm.TcpBlockSource("127.0.0.1", port)
    got = _drain_blocks(src, 200)
    srv.stop()  # the server dies mid-stream
    while True:
        polled = src.poll()
        if polled is None:
            break
        got.append((polled[0], np.array(polled[1])))
    n_before = sum(len(b) for _, b in got)
    assert 200 <= n_before < 600
    srv2 = nm.BlockFrameServer(X, block_size=50, port=port)
    try:
        got2 = _drain_blocks(src, 600 - n_before)
        assert got2[0][0] == n_before  # reconnected at the next offset
        cov = np.zeros(600, np.int32)
        for off, blk in got + got2:
            cov[off:off + len(blk)] += 1
        assert (cov == 1).all()
        src.close()
    finally:
        srv2.stop()


def test_record_stream_through_the_engine_like_the_jax_one(gbm_path):
    rng = np.random.default_rng(1)
    recs = [{f"f{j}": float(v) for j, v in enumerate(row)}
            for row in rng.normal(0, 1.5, size=(150, F))]
    got = {}
    for name in TWINS:
        pk, nm = twin(name), net(name)
        model = pk.api.ModelReader(gbm_path).load(batch_size=B, **pk.kw)
        srv = nm.BlockFrameServer(recs, block_size=40)
        try:
            src = nm.TcpRecordSource("127.0.0.1", srv.port)
            sink = pk.sinks.CollectSink()
            pipe = pk.engine.Pipeline(src, pk.engine.StaticScorer(model),
                                      sink, cfg(pk))
            pipe.run_until_exhausted(timeout=30.0)
            src.close()
        finally:
            srv.stop()
        got[name] = np.asarray([p.score.value for p in sink.items])
    assert len(got["port"]) == len(got["jax"]) == 150
    np.testing.assert_allclose(got["port"], got["jax"], rtol=RTOL, atol=ATOL)
