"""The Hopper kernel's walk table against the mask form, on the CPU.

``_walk_leaves`` follows the kernel's walk step for
step (root, ``depth`` node reads, a leaf idles on itself). Per record and
tree it must reach the one leaf that ``_leaf_hits`` selects: the mask form
of the JAX package's ``sign @ P == count``, which ``leaf_rows_reference``
(the kernel's plain version) reads and which knows nothing of the walk
table. Adding the reached leaves' rows in ascending tree order must give
``leaf_rows_reference``'s sums bit for bit. Forests: the fixtures
(``gen_gbm``, ``gen_vote_forest``, the ragged ``_forest_xml`` vote
forests) and ``chip_smoke.py``'s seeded ones (depths 1-12 mixed, single-
leaf trees, padded split and leaf slots, splits numbered in random order,
the 64-split caterpillar with 65 leaves), with 0% and 20% missing codes.
Then the packer's refusals and the tables ``convert`` carries across."""

import numpy as np
import pytest
import torch

from chip_smoke import (
    _caterpillar_paths,
    caterpillar_forest,
    forest_inputs,
    ragged_forest,
    random_codes,
)
from flink_jpmml_tpu.compile.qtrees import build_quantized_scorer as jax_bqs
from flink_jpmml_tpu.pmml import parse_pmml
from flink_jpmml_tpu_torch import convert
from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_vote_forest
from flink_jpmml_tpu_torch.compile import qtrees_cuda
from flink_jpmml_tpu_torch.compile.qtrees import build_quantized_scorer
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse_str
from flink_jpmml_tpu_torch.pmml import parse_pmml_file as tparse
from test_torch_qtrees import _forest_xml


def _X(rng, n, F, missing):
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    X[rng.random(size=X.shape) < missing] = np.nan
    return X


def _tables(inputs):
    return {k: torch.from_numpy(v)
            for k, v in qtrees_cuda.pack_tables(**inputs).items()}


def _scorer_tables(q):
    return {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}


def _walk_leaves(codes, tables):
    """The kernel's walk in plain PyTorch: u8[N, F] codes → i64[N, T], the
    leaf slot each record reaches in each tree. Step for step as the
    kernel: from the header's root, ``depth`` times read the node word,
    the record's code for its feature, go left iff ``code == SENTINEL ?
    dleft : code <= qthr``, and move to that child (a leaf names itself).
    It reads only ``walk``, so it is independent of the masks."""
    walk = tables["walk"]
    S = tables["split"].shape[1]
    N, T = codes.shape[0], walk.shape[0]
    x = codes.long()
    rec = torch.arange(N)
    out = torch.empty((N, T), dtype=torch.int64)
    for t in range(T):
        head = int(walk[t, 0])
        node = torch.full((N,), head & 0xFF, dtype=torch.int64)
        for _ in range((head >> 8) & 0xFF):
            w = walk[t][node]
            c = x[rec, w & 0xFF]
            go = torch.where(c == qtrees_cuda.SENTINEL,
                             ((w >> 16) & 1).bool(), c <= ((w >> 8) & 0xFF))
            node = torch.where(go, (w >> 32) & 0xFF, (w >> 40) & 0xFF)
        out[:, t] = node - (1 + S)
    return out


def _mask_leaves(codes, tables):
    """i64[N, T]: the leaf the mask form selects, which must be the only
    one it selects."""
    out = []
    for t, hit in qtrees_cuda._leaf_hits(codes, tables):
        assert bool((hit.sum(dim=1) == 1).all()), f"tree {t}"
        out.append(hit.long().argmax(dim=1))
    return torch.stack(out, dim=1)


def _walk_sums(codes, tables):
    """The kernel's arithmetic on the walk's leaves: per record, the
    reached leaves' rows added in ascending tree order."""
    leaves = _walk_leaves(codes, tables)
    rows = tables["rows"]
    acc = torch.zeros((codes.shape[0], rows.shape[2]), dtype=torch.float32)
    for t in range(rows.shape[0]):
        acc = acc + rows[t][leaves[:, t]]
    return acc


def _check_walk(codes, tables):
    leaves = _walk_leaves(codes, tables)
    assert leaves.shape == (codes.shape[0], tables["rows"].shape[0])
    assert torch.equal(leaves, _mask_leaves(codes, tables))
    assert torch.equal(_walk_sums(codes, tables),
                       qtrees_cuda.leaf_rows_reference(codes, tables))
    return leaves


def _gbm(tmp_path):
    path = gen_gbm(str(tmp_path), n_trees=30, depth=6, n_features=32)
    return build_quantized_scorer(tparse(path), device="cpu")


def _votes(tmp_path):
    path = gen_vote_forest(str(tmp_path), n_trees=24, depth=4, n_features=8,
                           n_classes=3, weighted=True)
    return build_quantized_scorer(tparse(path), device="cpu")


def _xml_forest(weighted):
    xml = _forest_xml("weightedMajorityVote" if weighted else "majorityVote",
                      weighted, n_trees=11)
    return build_quantized_scorer(tparse_str(xml), device="cpu")


SCORERS = {
    "gbm_t30_d6_f32": lambda tmp: _gbm(tmp),
    "votes_t24_d4_f8_c3": lambda tmp: _votes(tmp),
    "forest_xml_majority": lambda tmp: _xml_forest(False),
    "forest_xml_weighted": lambda tmp: _xml_forest(True),
}
GENERATED = {
    "ragged_t80_c1": lambda: ragged_forest(21, 80, 32, 1),
    "ragged_t80_c3": lambda: ragged_forest(22, 80, 32, 3),
    "ragged_t40_f5_c2": lambda: ragged_forest(23, 40, 5, 2),
    "caterpillar_c1": lambda: caterpillar_forest(24, 32, 1),
    "caterpillar_c16": lambda: caterpillar_forest(25, 32, 16),
}


class TestWalkEqualsMasks:
    @pytest.mark.parametrize("missing", [0.0, 0.2])
    @pytest.mark.parametrize("name", sorted(SCORERS))
    def test_fixtures(self, tmp_path, name, missing):
        q = SCORERS[name](tmp_path)
        assert q.backend == "cuda_plain"
        F = len(q.wire.fields)
        codes = torch.from_numpy(q.wire.encode(
            _X(np.random.default_rng(7), 600, F, missing)))
        _check_walk(codes, _scorer_tables(q))

    @pytest.mark.parametrize("missing", [0.0, 0.2])
    @pytest.mark.parametrize("name", sorted(GENERATED))
    def test_seeded_forests(self, name, missing):
        inputs = GENERATED[name]()
        tables = _tables(inputs)
        codes = torch.from_numpy(
            random_codes(8, 3000, inputs["n_fields"], missing))
        _check_walk(codes, tables)

    def test_ragged_forest_covers_what_the_fixtures_lack(self):
        inputs = ragged_forest(21, 80, 32, 1)
        walk = qtrees_cuda.pack_tables(**inputs)["walk"]
        depth = (walk[:, 0] >> 8) & 0xFF
        assert set(depth.tolist()) == set(range(1, 13))
        count, P = inputs["count"], inputs["P"]
        assert (count < 0).any(axis=1).all()  # padded leaf slots per tree
        assert ((P != 0).sum(axis=2) == 0).any(axis=1).all()  # split slots
        # single-leaf trees: the no-op split (the top rank, missing →
        # left) with the same row on both sides
        rows = qtrees_cuda.pack_tables(**inputs)["rows"]
        for t in range(3, 80, 17):
            s = np.flatnonzero((P[t] != 0).any(axis=1))
            leaves = np.flatnonzero(count[t] >= 0)
            assert len(s) == 1 and len(leaves) == 2 and depth[t] == 1
            assert inputs["qthr"][t, s] == 254 and inputs["dleft"][t, s]
            assert (rows[t, leaves[0]] == rows[t, leaves[1]]).all()

    def test_caterpillar_reaches_its_65_leaves(self):
        inputs = caterpillar_forest(24, 32, 1)
        tables = _tables(inputs)
        walk = tables["walk"]
        assert int(walk[0, 0]) >> 8 & 0xFF == 64
        # every leaf slot of the widest tree is named as a child, the 65th
        # (node 1 + 64 + 64 = 129) included: 7 bits would not reach it
        kids = torch.cat([(walk[0, 1:65] >> 32) & 0xFF,
                          (walk[0, 1:65] >> 40) & 0xFF])
        assert sorted(set(kids.tolist()) - set(range(1, 65))) == list(
            range(65, 130))
        codes = torch.from_numpy(random_codes(9, 20000, 32, 0.2))
        leaves = _check_walk(codes, tables)
        depth = torch.from_numpy(inputs["count"][0].astype(np.int64))
        assert int(depth[leaves[:, 0]].max()) == 64

    def test_path_order_ignores_the_split_numbering(self, tmp_path):
        # the same trees with split slots reversed and leaf slots rolled:
        # preorder numbering gone, the same leaf per record
        q = _gbm(tmp_path)
        p = {k: q.params[k].numpy() for k in
             ("feat", "qthr", "dleft", "P_i8", "count_i8")}
        S = p["feat"].shape[1]
        rev = np.arange(S)[::-1]
        P = np.roll(p["P_i8"][:, rev], 5, axis=2)
        hi = torch.roll(q.params["vhi"], 5, dims=1)
        lo = torch.roll(q.params["vlo"], 5, dims=1)
        tables = _tables(dict(
            feat=p["feat"][:, rev], qthr=p["qthr"][:, rev],
            dleft=p["dleft"][:, rev], P=P,
            count=np.roll(p["count_i8"], 5, axis=1), hi=hi, lo=lo,
            n_fields=32))
        codes = torch.from_numpy(q.wire.encode(
            _X(np.random.default_rng(3), 500, 32, 0.2)))
        leaves = _check_walk(codes, tables)
        orig = _walk_leaves(codes, _scorer_tables(q))
        assert torch.equal(leaves, (orig + 5) % tables["rows"].shape[1])
        assert torch.equal(
            qtrees_cuda.leaf_rows_reference(codes, tables),
            qtrees_cuda.leaf_rows_reference(codes, _scorer_tables(q)))

    def test_a_lone_leaf_is_its_own_root(self):
        # a real leaf with an empty path and a padded split slot: depth 0,
        # the walk stays at the root, the mask form hits it always
        vals = torch.tensor([[2.5, 7.0]], dtype=torch.bfloat16)
        tables = _tables(dict(
            feat=np.zeros((1, 1), np.int64), qthr=np.zeros((1, 1), np.uint8),
            dleft=np.zeros((1, 1), bool), P=np.zeros((1, 1, 2), np.int8),
            count=np.array([[0, -5]]), hi=vals, lo=torch.zeros_like(vals),
            n_fields=3))
        assert int(tables["walk"][0, 0]) == 2  # root: leaf node 1 + 1 + 0
        codes = torch.tensor([[0, 1, 2], [255, 255, 255]], dtype=torch.uint8)
        leaves = _check_walk(codes, tables)
        assert leaves.tolist() == [[0], [0]]
        assert qtrees_cuda.leaf_rows(codes, tables, 3).tolist() == [
            [2.5], [2.5]]


class TestWalkTable:
    def test_layout(self):
        inputs = ragged_forest(31, 12, 32, 3)
        out = qtrees_cuda.pack_tables(**inputs)
        walk, rows = out["walk"], out["rows"]
        T, S = inputs["feat"].shape
        L, C = rows.shape[1:]
        assert walk.dtype == np.int64
        assert walk.shape == (T, qtrees_cuda.walk_words(S, L, C))
        assert walk.shape[1] % 2 == 0  # 16-byte tree slices
        # rows as f32 pairs after the header, split and leaf nodes
        base = 1 + S + L
        tail = np.ascontiguousarray(walk[:, base:]).view(np.float32)
        np.testing.assert_array_equal(tail[:, : L * C],
                                      rows.reshape(T, L * C))
        assert not tail[:, L * C:].any()
        for t in range(T):
            real_split = (inputs["P"][t] != 0).any(axis=1)
            real_leaf = inputs["count"][t] >= 0
            node = walk[t, 1:base]
            assert (node[:S][~real_split] == 0).all()  # padded split slots
            assert (node[S:][~real_leaf] == 0).all()  # padded leaf slots
            s = np.flatnonzero(real_split)
            np.testing.assert_array_equal(node[s] & 0xFF,
                                          inputs["feat"][t, s])
            np.testing.assert_array_equal(node[s] >> 8 & 0xFF,
                                          inputs["qthr"][t, s])
            np.testing.assert_array_equal(node[s] >> 16 & 1,
                                          inputs["dleft"][t, s])
            leaf = 1 + S + np.flatnonzero(real_leaf)
            np.testing.assert_array_equal(walk[t, leaf],
                                          leaf << 32 | leaf << 40)
            depth = walk[t, 0] >> 8 & 0xFF
            assert depth == inputs["count"][t][real_leaf].max()

    def _one_tree(self, P, count):
        P = np.asarray(P, np.int8)[None]
        S, L = P.shape[1:]
        vals = torch.zeros((1, L), dtype=torch.bfloat16)
        return dict(feat=np.zeros((1, S), np.int64),
                    qthr=np.zeros((1, S), np.uint8),
                    dleft=np.zeros((1, S), bool), P=P,
                    count=np.asarray(count)[None], hi=vals, lo=vals,
                    n_fields=2)

    @pytest.mark.parametrize("P,count,match", [
        # split 1 has a left child only
        ([[1, -1], [1, 0]], [2, 1], "lacks a child"),
        # leaves 0 and 1 share the path (split 0, left)
        ([[1, 1, -1]], [1, 1, 1], "two children on one side"),
        # two trees side by side: no common root
        ([[1, -1, 0, 0], [0, 0, 1, -1]], [1, 1, 1, 1], "more than one root"),
        # both splits have both leaves under them: no chain
        ([[1, -1], [1, -1]], [2, 2], "no root-to-leaf chain"),
        # no real leaf at all
        ([[0, 0]], [-5, -5], "no real leaf"),
    ], ids=["one_child", "shared_path", "two_roots", "no_chain", "empty"])
    def test_packer_refuses_what_is_no_full_binary_tree(self, P, count,
                                                        match):
        with pytest.raises(ValueError, match=match):
            qtrees_cuda.pack_tables(**self._one_tree(P, count))

    def test_packer_refuses_node_numbers_past_8_bits(self):
        paths = _caterpillar_paths(64)
        inputs = forest_inputs([paths], 4, 1, seed=0, pad_leaves=191)
        with pytest.raises(ValueError, match="8 bits"):
            qtrees_cuda.pack_tables(**inputs)

    def test_wrapper_rejects_a_walk_table_of_another_shape(self):
        tables = _tables(ragged_forest(32, 6, 8, 3))
        codes = torch.zeros((4, 8), dtype=torch.uint8)
        with pytest.raises(ValueError, match="table 'walk'"):
            qtrees_cuda.leaf_rows(
                codes, dict(tables, walk=tables["walk"][:, :-2]), 8)
        with pytest.raises(ValueError, match="table 'walk'"):
            qtrees_cuda.leaf_rows(
                codes, dict(tables, walk=tables["walk"].int()), 8)

    @pytest.mark.parametrize("weighted", [False, True])
    def test_convert_carries_the_walk_table_bit_for_bit(self, weighted):
        # the ragged (depth 1-2) _forest_xml forest: the JAX package's
        # tables through convert give the port's own walk table
        xml = _forest_xml(
            "weightedMajorityVote" if weighted else "majorityVote", weighted)
        jx = jax_bqs(parse_pmml(xml), backend="xla")
        src = {k: np.asarray(jx.params[k]) for k in
               ("feat", "qthr", "dleft", "P_i8", "count_i8", "phi", "plo",
                "lab")}
        src.update(cuts=jx.wire.cuts, repl=jx.wire.repl,
                   has_repl=jx.wire.has_repl)
        conv = convert.quantized_params_from_jax(src, device="cpu")
        tq = build_quantized_scorer(tparse_str(xml), device="cpu")
        assert torch.equal(conv["walk"], tq.params["walk"])
        depth = (conv["walk"][:, 0] >> 8) & 0xFF
        assert set(depth.tolist()) == {2}


def test_ptxas_report_reads_the_build_log(tmp_path, monkeypatch):
    monkeypatch.setattr(qtrees_cuda, "BUILD_DIR", tmp_path)
    assert qtrees_cuda.ptxas_report() == []
    log = qtrees_cuda._lib_path().with_suffix(".ptxas.txt")
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z4walkILi1EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z4walkILi1EEvv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z4walkILi4EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z4walkILi4EEvv\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, 16 bytes smem, used 1 "
        "barriers\n")
    assert qtrees_cuda.ptxas_report() == [
        {"kernel": "_Z4walkILi1EEvv", "stack_bytes": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 32, "smem_bytes": 0},
        {"kernel": "_Z4walkILi4EEvv", "stack_bytes": 8, "spill_stores": 4,
         "spill_loads": 4, "registers": 255, "smem_bytes": 16},
    ]
