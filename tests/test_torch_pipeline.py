"""The PyTorch port's slice as a whole on the CPU: PMML → compile →
``BlockPipeline`` over a finite source → sink, against the JAX package's
``quantized_scorer().score`` on the same records (the repo's rank-wire
bar rtol 1e-4 / atol 1e-5), host-encoded and fused, plus the dispatch
window's FIFO contract."""

import threading

import numpy as np
import pytest

from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import (
    BlockPipeline,
    CyclingBlockSource,
    FiniteBlockSource,
)
from flink_jpmml_tpu_torch.runtime.pipeline import (
    DispatcherClosed,
    OverlappedDispatcher,
)
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

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
    assert snap["h2d_bytes"] >= X.shape[0] * 8
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
        # 8 codes a record host-encoded, 8 f32 fused (pad rows aside)
        per_record = snap["h2d_bytes"] / X.shape[0]
        assert per_record >= (32 if name == "fused" else 8)
        assert per_record < (32 if name == "fused" else 8) * B
    np.testing.assert_allclose(runs["host"], ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(runs["fused"], runs["host"])


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
