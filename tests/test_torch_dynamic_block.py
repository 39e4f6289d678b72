"""``DynamicBlockPipeline`` of the port on the CPU against the JAX
package's: the same Add/Del messages at the same points of the stream
give the same deliveries (offsets, serving model key, values), the
checkpointed serving key comes back on restore, poison isolates through
the served model with its key on the envelope, and the options that
wait for other slices raise ``NotPortedError``.

Control lands at marks the source holds until every earlier record was
sunk and the pipeline serves what the mark expects, so both packages
swap at the same offset. The port runs with ``device="cpu"``; values at
rtol 1e-4 / atol 1e-5, offsets and keys exactly."""

import time

import numpy as np
import pytest

from test_torch_checkpoint import (  # noqa: F401  (fixtures)
    ATOL,
    B,
    F,
    RTOL,
    TWINS,
    _clean_faults,
    cfg,
    coverage,
    data,
    twin,
)
from flink_jpmml_tpu_torch.utils.exceptions import NotPortedError


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_vote_forest

    d = str(tmp_path_factory.mktemp("dynblock"))
    return {
        "v1": gen_gbm(d, n_trees=8, depth=3, n_features=F),
        "v2": gen_gbm(d, n_trees=8, depth=3, n_features=F, seed=12,
                      name="gbm_v2.pmml"),
        "votes": gen_vote_forest(d, n_trees=9, depth=3, n_features=F,
                                 n_classes=3),
    }


def wait_for(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


class Marked:
    """A finite block source whose ``marks`` — ``(offset, action)`` —
    run on the ingest thread before the block at that offset."""

    def __init__(self, pk, X, marks):
        self._src = pk.block.FiniteBlockSource(X, B)
        self._marks = list(marks)

    def poll(self):
        if self._marks and self._src._pos >= self._marks[0][0]:
            self._marks.pop(0)[1]()
        return self._src.poll()

    def seek(self, offset):
        self._src.seek(offset)

    @property
    def exhausted(self):
        return self._src.exhausted and not self._marks


def dyn(pk, source, ctrl, sink, name="gbm", ckdir=None, **kw):
    return pk.sblock.DynamicBlockPipeline(
        source, ctrl, sink, name, F, B, cfg(pk, 0.0),
        checkpoint=(pk.checkpoint.CheckpointManager(ckdir)
                    if ckdir else None),
        max_dispatch_chunks=1, **pk.kw, **kw)


def collector(out):
    def sink(o, n, first, decode):
        if isinstance(o, tuple):
            vals = tuple(np.asarray(a)[:n].copy() for a in o)
        else:
            vals = np.asarray(o)[:n].copy()
        out.append((int(first), int(n), decode.model_key, vals))
    return sink


def same(got, ref):
    assert [d[:3] for d in got] == [d[:3] for d in ref]
    for g, r in zip(got, ref):
        gv = g[3] if isinstance(g[3], tuple) else (g[3],)
        rv = r[3] if isinstance(r[3], tuple) else (r[3],)
        for a, b in zip(gv, rv):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=RTOL, atol=ATOL)


def swap_run(pk, paths, X, ckdir):
    """Add v1 before the run; at a quarter Add v2 and hold until it
    serves; at half Del v1."""
    n = len(X)
    ctrl = pk.sources.ControlSource()
    holder, out = {}, []

    def add_v2():
        p = holder["pipe"]
        wait_for(lambda: p.committed_offset >= n // 4, "the first quarter")
        ctrl.push(pk.control.AddMessage("gbm", 2, paths["v2"], 2.0))
        wait_for(lambda: p.serving_key == "gbm_2", "v2 serving")

    def del_v1():
        p = holder["pipe"]
        wait_for(lambda: p.committed_offset >= n // 2, "the first half")
        ctrl.push(pk.control.DelMessage("gbm", 1, 3.0))

    ctrl.push(pk.control.AddMessage("gbm", 1, paths["v1"], 1.0))
    pipe = holder["pipe"] = dyn(
        pk, Marked(pk, X, [(n // 4, add_v2), (n // 2, del_v1)]), ctrl,
        collector(out), ckdir=ckdir)
    pipe.run_until_exhausted(timeout=120)
    return pipe, out


def test_add_del_swap_matches_the_jax_package(paths, tmp_path):
    X = data(24 * B, seed=20)
    runs = {}
    for name in TWINS:
        pipe, out = swap_run(twin(name), paths, X, str(tmp_path / name))
        runs[name] = (out, pipe.serving_key, pipe.backend,
                      sorted(k.key() for k in pipe.registry.served),
                      pipe.committed_offset,
                      pipe.metrics.struct_snapshot()["counters"][
                          "model_swaps"])
    (jo, *jr), (to, *tr) = runs["jax"], runs["port"]
    same(to, jo)
    keys = [d[2] for d in to]
    assert keys[:6] == ["gbm_1"] * 6 and set(keys[6:]) == {"gbm_2"}
    assert to[6][0] == len(X) // 4  # v2 from the quarter on
    assert tr[0] == jr[0] == "gbm_2" and tr[2:] == jr[2:]
    assert tr[1] == "rank_wire_cuda_plain" and jr[1].startswith("rank_wire")
    assert tr[2] == ["gbm_2"] and tr[3] == len(X) and tr[4] == 2
    assert (coverage([(o, k, None) for o, k, _, _ in to], len(X)) == 1).all()


def test_checkpointed_serving_key_is_restored(paths, tmp_path):
    X = data(16 * B, seed=21)
    more = np.concatenate([X, data(4 * B, seed=22)])
    runs = {}
    for name in TWINS:
        pk = twin(name)
        d = str(tmp_path / name)
        swap_run(pk, paths, X, d)
        state = pk.checkpoint.CheckpointManager(d).load_latest()
        out = []
        pipe = dyn(pk, pk.block.FiniteBlockSource(more, B),
                   pk.sources.ControlSource(), collector(out), ckdir=d)
        assert pipe.restore() is True
        restored = (pipe.committed_offset, pipe.registry.state())
        pipe.run_until_exhausted(timeout=120)
        runs[name] = (state, restored, out, pipe.serving_key)
    (js, jr, jo, jk), (ts, tr, to, tk) = runs["jax"], runs["port"]
    assert ts == js
    assert ts["registry"] == {"served": {"gbm_2": paths["v2"]}}
    assert ts["source_offset"] == len(X)
    assert tr == jr == (len(X), {"served": {"gbm_2": paths["v2"]}})
    same(to, jo)
    assert {d[2] for d in to} == {"gbm_2"} and tk == jk == "gbm_2"
    assert to[0][0] == len(X) and sum(d[1] for d in to) == 4 * B


def test_vote_forest_serves_like_the_jax_package(paths):
    X = data(10 * B, seed=23)
    runs = {}
    for name in TWINS:
        pk = twin(name)
        ctrl = pk.sources.ControlSource()
        ctrl.push(pk.control.AddMessage("votes", 1, paths["votes"], 1.0))
        out = []
        pipe = dyn(pk, pk.block.FiniteBlockSource(X, B), ctrl,
                   collector(out), name="votes")
        pipe.run_until_exhausted(timeout=120)
        runs[name] = out
    same(runs["port"], runs["jax"])
    assert sum(d[1] for d in runs["port"]) == len(X)


def test_poison_isolates_through_the_served_model(paths, tmp_path):
    X = data(12 * B, seed=24)
    runs = {}
    for name in TWINS:
        pk = twin(name)
        pk.faults.inject("poison_record", offset=77)
        ctrl = pk.sources.ControlSource()
        ctrl.push(pk.control.AddMessage("gbm", 1, paths["v1"], 1.0))
        out = []
        pipe = dyn(pk, pk.block.FiniteBlockSource(X, B), ctrl,
                   collector(out), ckdir=str(tmp_path / name))
        pipe.run_until_exhausted(timeout=120)
        pk.faults.clear()
        runs[name] = ([(int(e["offset"]), e["fingerprint"], e["model"])
                       for e in pipe._dlq.scan()], out)
    assert runs["port"][0] == runs["jax"][0]
    assert [(o, m) for o, _, m in runs["port"][0]] == [(77, "gbm_1")]
    same(runs["port"][1], runs["jax"][1])


@pytest.mark.parametrize("option", ["mesh", "slo", "batcher", "admission",
                                    "donate"])
def test_options_of_later_slices_raise_not_ported(option):
    pk = twin("port")
    with pytest.raises(NotPortedError, match=f"{option}="):
        dyn(pk, pk.block.FiniteBlockSource(data(B), B),
            pk.sources.ControlSource(), lambda *a: None,
            **{option: object()})


@pytest.mark.parametrize("option", ["mesh", "slo", "batcher", "admission",
                                    "state", "donate"])
def test_block_pipeline_options_of_later_slices_raise_not_ported(paths,
                                                                 option):
    pk = twin("port")
    with pytest.raises(NotPortedError, match=f"{option}="):
        pk.block.BlockPipeline(pk.block.FiniteBlockSource(data(B), B),
                               pk.compile(paths["v1"]), lambda *a: None,
                               **{option: object()})
