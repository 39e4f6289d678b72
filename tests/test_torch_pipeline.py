"""The PyTorch port's slice as a whole on the CPU: PMML → compile →
``BlockPipeline`` over a finite source → sink, against the JAX package's
``quantized_scorer().score`` on the same records (the repo's rank-wire
bar rtol 1e-4 / atol 1e-5), host-encoded and fused, plus the dispatch
window's FIFO contract and its stage ledger. The Kafka cases feed a port
``BlockPipeline`` from a port ``MiniKafkaBroker`` and a JAX one from a JAX
broker with the same rows, with the prefetch sidecar on and off; every
broker listens on loopback port 0 and is closed in a ``finally``."""

import threading
import time

import numpy as np
import pytest

from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.obs import attr as jattr
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse
from flink_jpmml_tpu.runtime import kafka as jk
from flink_jpmml_tpu.runtime.block import BlockPipeline as JBlockPipeline
from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JRegistry
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.obs import attr as tattr
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime import kafka as tk
from flink_jpmml_tpu_torch.runtime import native
from flink_jpmml_tpu_torch.runtime.block import (
    BlockPipeline,
    CyclingBlockSource,
    FiniteBlockSource,
)
from flink_jpmml_tpu_torch.runtime.pipeline import (
    DispatcherClosed,
    OverlappedDispatcher,
    dispatch_quantized,
)
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
from flink_jpmml_tpu_torch.utils.exceptions import NativeBuildError
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

RTOL, ATOL = 1e-4, 1e-5
B = 256


@pytest.fixture(scope="module")
def gbm(tmp_path_factory):
    path = gen_gbm(str(tmp_path_factory.mktemp("gbm")), n_trees=40, depth=4,
                   n_features=8)
    rng = np.random.default_rng(0)
    X = rng.normal(0.0, 1.5, size=(5000, 8)).astype(np.float32)
    X[rng.random(size=X.shape) < 0.15] = np.nan
    ref = jcompile(jparse(path), batch_size=B).quantized_scorer().score(X)
    return path, X, np.asarray([p.score.value for p in ref], np.float32)


def _run(path, X, use_quantized=True, block=700, chunks=8, encode_mode=None):
    cm = compile_pmml(parse_pmml_file(path), batch_size=B, device="cpu")
    if use_quantized:
        cm.quantized_scorer().encode_mode = encode_mode
    got = []
    lock = threading.Lock()

    def sink(out, n, first_off):
        with lock:
            got.append((first_off, n, out))

    pipe = BlockPipeline(
        FiniteBlockSource(X, block), cm, sink,
        RuntimeConfig(batch=BatchConfig(size=B, deadline_us=2000)),
        use_quantized=use_quantized, max_dispatch_chunks=chunks,
    )
    pipe.run_until_exhausted(timeout=120)
    return pipe, got


@pytest.mark.parametrize("chunks", [1, 8])
def test_block_pipeline_matches_jax_scores(gbm, chunks):
    path, X, ref = gbm
    pipe, got = _run(path, X, chunks=chunks)
    assert pipe.backend == "rank_wire_cuda_plain"
    # every offset delivered once, in order
    expect = 0
    for first_off, n, _ in got:
        assert first_off == expect
        expect += n
    assert expect == X.shape[0] == pipe.committed_offset
    scores = np.concatenate([
        np.asarray([p.score.value for p in pipe.decode(out, n)], np.float32)
        for _, n, out in got
    ])
    np.testing.assert_allclose(scores, ref, rtol=RTOL, atol=ATOL)
    snap = pipe.metrics.snapshot()
    assert snap["records_out"] == X.shape[0] == snap["batch_fill_records"]
    assert snap["h2d_bytes"] == X.shape[0] * 8  # live rows only
    if chunks == 1:
        assert all(n <= B for _, n, _ in got)


@pytest.mark.parametrize("chunks", [1, 8])
def test_encode_placements_agree(gbm, chunks):
    # host-encoded (the CPU's default placement) and the device encode
    # stage asked for by hand: the same records, offsets and scores, bit
    # for bit
    path, X, ref = gbm
    runs = {}
    for name, mode in (("host", None), ("fused", "fused")):
        pipe, got = _run(path, X, chunks=chunks, encode_mode=mode)
        snap = pipe.metrics.snapshot()
        assert snap[f"encode_{name}"] == snap["dispatches"]
        assert pipe.committed_offset == X.shape[0]
        assert [off for off, _, _ in got] == list(
            np.cumsum([0] + [n for _, n, _ in got])[:-1])
        runs[name] = np.concatenate(
            [np.asarray(out)[:n] for _, n, out in got])
        # 8 codes a record host-encoded, 8 f32 fused: the alignment rows
        # of a partial dispatch are not staged
        assert snap["h2d_bytes"] == X.shape[0] * (32 if name == "fused" else 8)
    np.testing.assert_allclose(runs["host"], ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(runs["fused"], runs["host"])


@pytest.mark.parametrize("mode", ["host", "fused"])
@pytest.mark.parametrize("n", [1, 100, B, B + 1, 3 * B - 7])
def test_dispatch_stages_only_live_rows(gbm, mode, n):
    # a batch that is not whole compile batches scores as K aligned
    # batches, but only its n live rows count as staged
    path, X, ref = gbm
    q = compile_pmml(parse_pmml_file(path), batch_size=B,
                     device="cpu").quantized_scorer()
    q.encode_mode = mode
    reg = TRegistry()
    vals = np.asarray(dispatch_quantized(q, X[:n], metrics=reg).result())
    assert vals.shape == (-(-n // B) * B,)
    np.testing.assert_allclose(vals[:n], ref[:n], rtol=RTOL, atol=ATOL)
    assert reg.counter("h2d_bytes").get() == n * (32 if mode == "fused" else 8)
    assert reg.counter(f"encode_{mode}").get() == 1


def test_f32_path_pipeline_matches(gbm):
    path, X, ref = gbm
    pipe, got = _run(path, X[:1000], use_quantized=False)
    assert pipe.backend == "f32"
    scores = np.concatenate([
        np.asarray([p.score.value for p in pipe.decode(out, n)], np.float32)
        for _, n, out in got
    ])
    np.testing.assert_allclose(scores, ref[:1000], rtol=RTOL, atol=ATOL)


def test_run_for_over_a_cycling_source(gbm):
    path, X, ref = gbm
    cm = compile_pmml(parse_pmml_file(path), batch_size=B, device="cpu")
    seen = []
    pipe = BlockPipeline(CyclingBlockSource(X[:1024], 512), cm,
                         lambda out, n, off: seen.append((off, n)))
    pipe.run_for(0.5)
    assert seen and seen[0][0] == 0
    for (o1, n1), (o2, _) in zip(seen, seen[1:]):
        assert o2 == o1 + n1  # contiguous commits across the wrap
    assert pipe.committed_offset == seen[-1][0] + seen[-1][1]


class _Pending:
    """A dispatch result that becomes ready only when released."""

    def __init__(self):
        self.released = False
        self.waited = False

    def ready(self):
        return self.released

    def synchronize(self):
        self.waited = True


def test_dispatcher_is_fifo_and_bounded():
    done = []
    disp = OverlappedDispatcher(depth=2,
                                complete=lambda out, meta: done.append(meta))
    outs = [_Pending() for _ in range(5)]
    for i, o in enumerate(outs[:2]):
        disp.launch(lambda o=o: o, meta=i)
    assert len(disp) == 2 and done == []
    disp.launch(lambda: outs[2], meta=2)  # overflow: finishes the oldest
    assert done == [0] and outs[0].waited and len(disp) == 2
    assert disp.metrics.counter("window_full_launches").get() == 1
    outs[1].released = True
    disp.launch(lambda: outs[3], meta=3)  # oldest already ready: not full
    assert done == [0, 1]
    assert disp.metrics.counter("window_full_launches").get() == 1
    disp.launch(lambda: outs[4], meta=4)
    disp.close()  # flushes, in order
    assert done == [0, 1, 2, 3, 4] and len(disp) == 0
    assert all(o.waited for o in outs)
    assert disp.metrics.counter("dispatches").get() == 5
    with pytest.raises(DispatcherClosed):
        disp.launch(lambda: outs[0])


def test_synchronous_window_finishes_each_launch():
    done = []
    disp = OverlappedDispatcher(depth=0,
                                complete=lambda out, meta: done.append(meta))
    for i in range(3):
        disp.launch(_Pending, meta=i)
        assert done == list(range(i + 1)) and len(disp) == 0


def test_window_books_queue_wait_and_readback():
    disp = OverlappedDispatcher(depth=1)
    for i in range(3):
        disp.launch(_Pending, meta=i)  # the 2nd and 3rd wait for a slot
    disp.close()  # the last is read back
    summary = tattr.summary(disp.metrics)
    assert summary["queue_wait"]["n"] == 2 and summary["readback"]["n"] == 1
    sync = OverlappedDispatcher(depth=0)
    sync.launch(_Pending)  # no window: the host reads its own batch back
    assert set(tattr.summary(sync.metrics)) == {"readback"}


# -- fed from Kafka ------------------------------------------------------------

KAFKA_STAGES = {"fetch", "decode", "encode", "h2d", "queue_wait", "readback",
                "sink"}


def _kafka_run(pkg, path, X, prefetch):
    """One package's BlockPipeline over its own broker holding ``X`` →
    (scores in offset order, committed offset, stage summary, source
    type name)."""
    if pkg == "jax":
        kmod, cm, reg = jk, jcompile(jparse(path), batch_size=B), JRegistry()
        pipe_cls, attr = JBlockPipeline, jattr
    else:
        kmod, reg = tk, TRegistry()
        cm = compile_pmml(parse_pmml_file(path), batch_size=B, device="cpu")
        pipe_cls, attr = BlockPipeline, tattr
    got = {}
    lock = threading.Lock()

    def sink(out, n, first_off):
        with lock:
            got[first_off] = (n, out)

    broker = kmod.MiniKafkaBroker(topic="t")
    src = None
    try:
        broker.append_rows(X)
        src = kmod.KafkaBlockSource(broker.host, broker.port, "t",
                                    n_cols=X.shape[1], metrics=reg,
                                    max_wait_ms=5, max_bytes=20_000)
        pipe = pipe_cls(src, cm, sink,
                        RuntimeConfig(batch=BatchConfig(size=B,
                                                        deadline_us=2000)),
                        metrics=reg, prefetch=prefetch)
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
    scores, expect = [], 0
    for first_off in sorted(got):
        assert first_off == expect  # every offset once, in order
        n, out = got[first_off]
        scores.append(np.asarray(
            [p.score.value for p in pipe.decode(out, n)], np.float32))
        expect += n
    return (np.concatenate(scores), pipe.committed_offset,
            attr.summary(reg), type(pipe._source).__name__)


@pytest.mark.parametrize("prefetch", [None, False], ids=["sidecar", "serial"])
def test_kafka_fed_pipeline_matches_the_jax_one(gbm, prefetch):
    path, X, ref = gbm
    j_scores, j_off, j_stages, j_src = _kafka_run("jax", path, X, prefetch)
    t_scores, t_off, t_stages, t_src = _kafka_run("port", path, X, prefetch)
    np.testing.assert_allclose(t_scores, j_scores, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_scores, ref, rtol=RTOL, atol=ATOL)
    assert t_off == j_off == X.shape[0]
    assert t_src == j_src == ("PrefetchedBlockSource" if prefetch is None
                              else "KafkaBlockSource")
    want = KAFKA_STAGES | ({"prefetch_wait"} if prefetch is None else set())
    for stages in (j_stages, t_stages):
        assert want <= set(stages), stages
        assert all(stages[s]["n"] > 0 for s in want)
    if prefetch is not None:
        assert "prefetch_wait" not in t_stages


def _broken_loader():
    raise NativeBuildError("g++ failed (1):\nfjt_native.cpp: error: injected")


def test_a_failed_native_build_raises_through_the_kafka_path(monkeypatch):
    X = np.zeros((20, 8), np.float32)
    broker = tk.MiniKafkaBroker(topic="t")
    src = tk.KafkaBlockSource(broker.host, broker.port, "t", n_cols=8,
                              max_wait_ms=5, metrics=TRegistry())
    try:
        # the Python encoder (a stamped append) fills the log; the C++
        # decoder then fails to build under the consumer
        broker.append_rows(X, timestamp_ms=1_700_000_000_000)
        monkeypatch.setattr(native, "load", _broken_loader)
        with pytest.raises(NativeBuildError, match="injected"):
            src.poll()
        with pytest.raises(NativeBuildError, match="injected"):
            broker.append_rows(X)
    finally:
        src.close()
        broker.close()
