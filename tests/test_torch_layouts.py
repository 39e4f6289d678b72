"""The port's layout catalogue (``flink_jpmml_tpu_torch/compile/layouts.py``)
against the JAX package's, on the CPU.

The numpy helpers must give the same permutations, the same
``WirePack`` bytes and the same pack partitions for the same seeded
inputs; the torch unpack stage must equal the XLA one. Every layout a
scorer can adopt must score bit-equal to ``ref``: the torch twin's
``bfs`` / ``wirepack`` / ``bfs_wirepack`` through the port's own path,
and the walk table's breadth-first order through a walk that reads only
the ``walk`` table (as the kernel does) and through the kernel's plain
version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_jpmml_tpu.compile import layouts as jlayouts
from flink_jpmml_tpu.compile.qtrees import build_quantized_scorer as jax_bqs
from flink_jpmml_tpu.pmml import parse_pmml as jparse
from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_vote_forest
from flink_jpmml_tpu_torch.compile import layouts, qtrees_cuda
from flink_jpmml_tpu_torch.compile.qtrees import (
    QuantizedWire,
    build_quantized_scorer,
)
from flink_jpmml_tpu_torch.pmml import parse_pmml, parse_pmml_file
from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
from test_layouts import _adversarial_X, stump_forest_xml


def _mixed_wire():
    cuts = (
        np.linspace(-1, 1, 300).astype(np.float32),
        np.linspace(-1, 1, 5).astype(np.float32),
        np.linspace(-2, 2, 700).astype(np.float32),
        np.linspace(-1, 1, 254).astype(np.float32),
    )
    kw = dict(fields=("a", "b", "c", "d"), cuts=cuts, dtype=np.uint16,
              sentinel=65535, repl=np.zeros((4,), np.float32),
              has_repl=np.zeros((4,), bool))
    return QuantizedWire(**kw), kw


def _codes(rng, n=256):
    codes = np.stack([
        rng.integers(0, 301, size=n), rng.integers(0, 6, size=n),
        rng.integers(0, 701, size=n), rng.integers(0, 255, size=n),
    ], axis=1).astype(np.uint16)
    codes[rng.random(size=codes.shape) < 0.2] = 65535
    codes[1, 0] = 255  # a rank that collides with uint8's marker
    return codes


class TestNumpyHelpersMatchJax:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_bfs_split_order_and_apply(self, seed):
        rng = np.random.default_rng(seed)
        T, S, L = 7, 15, 16
        P = rng.integers(-1, 2, size=(T, S, L)).astype(np.int8)
        P[:, rng.random(S) < 0.2, :] = 0  # padded split slots
        perm = layouts.bfs_split_order(P)
        np.testing.assert_array_equal(perm, jlayouts.bfs_split_order(P))
        tabs = (rng.integers(0, 32, (T, S)), rng.integers(0, 255, (T, S)),
                rng.random((T, S)) < 0.5, P)
        got = layouts.apply_split_order(perm, *tabs)
        want = jlayouts.apply_split_order(perm, *tabs)
        for k in ("feat", "qthr", "dleft", "P"):
            np.testing.assert_array_equal(got[k], want[k])

    def test_bfs_order(self):
        rng = np.random.default_rng(3)
        children = [[] for _ in range(40)]
        for i in range(1, 40):
            children[int(rng.integers(0, i))].append(i)
        assert layouts.bfs_order(children) == jlayouts.bfs_order(children)

    @pytest.mark.parametrize("seed", [0, 5])
    def test_wirepack_bytes_and_unpack_stages(self, seed):
        wire, _ = _mixed_wire()
        wp = layouts.plan_wire_pack(wire)
        jwp = jlayouts.plan_wire_pack(wire)
        assert wp is not None and wp.width == jwp.width == 2 + 1 + 2 + 1
        codes = _codes(np.random.default_rng(seed))
        packed = wp.pack(codes)
        np.testing.assert_array_equal(packed, jwp.pack(codes))
        np.testing.assert_array_equal(wp.unpack_host(packed),
                                      jwp.unpack_host(packed))
        np.testing.assert_array_equal(wp.unpack_host(packed),
                                      codes.astype(np.int64))
        got = wp.unpack_stage()(torch.from_numpy(packed))
        want = np.asarray(jwp.unpack_stage()(jnp.asarray(packed)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_plan_none_cases(self, tmp_path):
        doc = parse_pmml_file(gen_gbm(str(tmp_path), n_trees=4, depth=2,
                                      n_features=4))
        q = build_quantized_scorer(doc, batch_size=32, device="cpu")
        assert q.wire.dtype is np.uint8
        assert layouts.plan_wire_pack(q.wire) is None
        cuts = tuple(np.linspace(-1, 1, 300).astype(np.float32)
                     for _ in range(2))
        wire = QuantizedWire(
            fields=("a", "b"), cuts=cuts, dtype=np.uint16, sentinel=65535,
            repl=np.zeros((2,), np.float32), has_repl=np.zeros((2,), bool))
        assert layouts.plan_wire_pack(wire) is None
        assert jlayouts.plan_wire_pack(wire) is None

    @pytest.mark.parametrize("n_models", [1, 5, 23])
    def test_pack_partitions_and_waste(self, n_models):
        rng = np.random.default_rng(n_models)
        metas = {
            f"m{i:02d}": {
                "trees": float(rng.integers(5, 60)),
                "splits": float(rng.integers(3, 63)),
                "leaves": float(rng.integers(4, 64)),
                "fields": float(rng.integers(2, 40)),
                "batch": 256.0,
                "dtype_rank": float(rng.choice([1, 2])),
                "classification": float(rng.integers(0, 2)),
            } for i in range(n_models)
        }
        parts = layouts.pack_partitions(metas)
        assert parts == jlayouts.pack_partitions(metas)
        for part in parts:
            assert layouts.pack_pad_waste(metas, part) == pytest.approx(
                jlayouts.pack_pad_waste(metas, part), rel=0, abs=0)

    def test_variant_ids(self):
        assert layouts.variant_id("cuda", "ref", None, None) == "cuda_auto"
        assert layouts.variant_id("cuda", "bfs", None, None) == \
            "cuda_auto_bfs"
        assert layouts.variant_id("cuda_plain", "ref", 128, 12288) == \
            "cuda_t128_c12288"
        assert layouts.variant_id("torch", "bfs_wirepack", None, None) == \
            "torch_bfs_wirepack"
        assert layouts.SPACE_TAG != jlayouts.SPACE_TAG


class TestTorchTwinLayouts:
    def test_every_layout_scores_like_ref(self):
        xml = stump_forest_xml()
        q_ref = build_quantized_scorer(parse_pmml(xml), batch_size=32,
                                       device="cpu")
        assert q_ref.backend == "torch" and q_ref.wire.dtype is np.uint16
        assert layouts.torch_layouts(q_ref.wire) == (
            "ref", "bfs", "wirepack", "bfs_wirepack")
        jq = jax_bqs(jparse(xml), batch_size=32, backend="xla")
        rng = np.random.default_rng(2)
        for n in (20, 32, 77):
            X = _adversarial_X(rng, n, 2)
            ref = q_ref.predict_wire(q_ref.wire.encode(X)).numpy()[:n]
            jref = np.asarray(jq.predict_wire(jq.wire.encode(X)),
                              np.float32)[:n]
            np.testing.assert_allclose(ref, jref, rtol=1e-4, atol=1e-5)
            for lay in ("bfs", "wirepack", "bfs_wirepack"):
                q = build_quantized_scorer(parse_pmml(xml), batch_size=32,
                                           device="cpu")
                built = q.build_variant(lay)
                assert built is not None, lay
                q.adopt_variant(built, lay)
                assert q.layout == lay
                # the packed host payload, unpacked by the torch stage
                got = q.predict_padded(*q.pad_wire(q.pack_wire(
                    q.wire.encode(X)))).numpy()[:n]
                np.testing.assert_array_equal(got, ref)
                if "wirepack" in lay:
                    assert q.staged_bytes_per_record == 3.0 < \
                        q_ref.staged_bytes_per_record

    def test_dispatch_accounts_packed_bytes(self):
        q = build_quantized_scorer(parse_pmml(stump_forest_xml()),
                                   batch_size=32, device="cpu")
        q.adopt_variant(q.build_variant("wirepack"), "wirepack")
        X = np.random.default_rng(4).normal(size=(32, 2)).astype(np.float32)
        m = MetricsRegistry()
        q.encode_mode = "host"
        out = dispatch_quantized(q, X, metrics=m).result()
        assert m.counter("h2d_bytes").get() == 32 * 3
        ref = build_quantized_scorer(parse_pmml(stump_forest_xml()),
                                     batch_size=32, device="cpu")
        np.testing.assert_array_equal(
            out.numpy(), ref.predict_wire(ref.wire.encode(X)).numpy())

    def test_cuda_layouts_refuse_what_they_cannot_take(self, tmp_path):
        doc = parse_pmml_file(gen_gbm(str(tmp_path), n_trees=4, depth=3,
                                      n_features=4))
        q = build_quantized_scorer(doc, batch_size=32, device="cpu")
        assert q.backend == "cuda_plain"
        assert q.build_variant("wirepack") is None
        assert q.build_variant("mega") is None
        assert q.build_variant("ref", threads=48) is None
        assert q.build_variant("ref", threads=512) is None
        qt = build_quantized_scorer(parse_pmml(stump_forest_xml()),
                                    batch_size=32, device="cpu")
        assert qt.build_variant("ref", threads=128) is None


def _walk_rows(codes, walk, S, L, C):
    """The kernel's walk and row read in plain PyTorch, from the ``walk``
    table alone (node words, then the row section): u8[N, F] → f32[N, C],
    rows added in ascending tree order."""
    T = walk.shape[0]
    N = codes.shape[0]
    x = codes.long()
    rec = torch.arange(N)
    rows = walk[:, 1 + S + L:].contiguous().view(torch.float32)
    acc = torch.zeros((N, C), dtype=torch.float32)
    for t in range(T):
        head = int(walk[t, 0])
        node = torch.full((N,), head & 0xFF, dtype=torch.int64)
        for _ in range((head >> 8) & 0xFF):
            w = walk[t][node]
            c = x[rec, w & 0xFF]
            go = torch.where(c == qtrees_cuda.SENTINEL,
                             ((w >> 16) & 1).bool(), c <= ((w >> 8) & 0xFF))
            node = torch.where(go, (w >> 32) & 0xFF, (w >> 40) & 0xFF)
        leaf = node - (1 + S)
        idx = leaf[:, None] * C + torch.arange(C)[None, :]
        acc = acc + rows[t][idx]
    return acc


def _cuda_scorer(tmp_path, kind):
    if kind == "gbm":
        path = gen_gbm(str(tmp_path), n_trees=25, depth=6, n_features=16,
                       seed=4)
    else:
        path = gen_vote_forest(str(tmp_path), n_trees=25, depth=5,
                               n_features=16, n_classes=3, seed=4)
    q = build_quantized_scorer(parse_pmml_file(path), batch_size=64,
                               device="cpu")
    assert q.backend == "cuda_plain"
    return q


@pytest.mark.parametrize("kind", ["gbm", "votes"])
def test_bfs_walk_reaches_the_same_rows(tmp_path, kind):
    q = _cuda_scorer(tmp_path, kind)
    S = q.params["split"].shape[1]
    L, C = q.params["rows"].shape[1:]
    walk = q.params["walk"]
    bfs = torch.from_numpy(layouts.bfs_walk(walk.numpy(), S, L, C))
    assert bfs.shape == walk.shape and not torch.equal(bfs, walk)
    # breadth-first: the root is node 1, and a parent's number is below
    # its children's
    assert bool(((bfs[:, 0] & 0xFF) == 1).all())
    for t in range(bfs.shape[0]):
        for n in range(1, 1 + S):
            w = int(bfs[t, n])
            if w:
                assert n < (w >> 32) & 0xFF and n < (w >> 40) & 0xFF
    rng = np.random.default_rng(6)
    X = rng.normal(0.0, 1.5, (300, 16)).astype(np.float32)
    X[rng.random(X.shape) < 0.2] = np.nan
    codes = torch.from_numpy(q.wire.encode(X))
    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    plain = qtrees_cuda.leaf_rows_reference(codes, tables)
    assert torch.equal(_walk_rows(codes, walk, S, L, C), plain)
    assert torch.equal(_walk_rows(codes, bfs, S, L, C), plain)
    # the scorer's bfs variant carries that table, and scores as ref
    built = q.build_variant("bfs")
    assert torch.equal(built["params"]["walk"], bfs)
    ref = q.predict_wire(q.wire.encode(X))
    q.adopt_variant(built, "bfs")
    got = q.predict_wire(q.wire.encode(X))
    if isinstance(ref, tuple):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    else:
        assert torch.equal(got, ref)


def test_model_hash_is_the_jax_packages(tmp_path):
    path = gen_gbm(str(tmp_path), n_trees=12, depth=4, n_features=8)
    q = build_quantized_scorer(parse_pmml_file(path), batch_size=64,
                               device="cpu")
    from flink_jpmml_tpu.pmml import parse_pmml_file as jparse_file

    jq = jax_bqs(jparse_file(path), batch_size=64)
    assert q.model_hash == jq.model_hash
    for k, v in jq._meta.items():
        assert q._meta[k] == v
    assert q._meta["path_steps"] == float(
        ((q.params["walk"][:, 0] >> 8) & 0xFF).sum())
