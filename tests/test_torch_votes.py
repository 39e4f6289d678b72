"""The PyTorch port's vote-forest path against the JAX package.

majorityVote / weightedMajorityVote forests on the uint8 rank wire: the
kernel's plain version (what ``qtrees_cuda.leaf_rows`` runs on a CPU
tensor) against the JAX package's Pallas kernels ``_kernel_cls`` (grid
form) and ``_kernel_mega_cls`` (the ``mega`` layout) in interpret mode and
against its XLA path; then the tables carried across by ``convert``, the
scorer's backend choice, ``score()`` and a CPU ``BlockPipeline``.

Bar: vote shares and values at rtol 1e-4 / atol 1e-5 (the repo's rank-wire
bar, tests/test_qtrees_pallas.py); labels exactly equal on every row whose
classes do not tie on vote total. On a tied row the port's label is the
lowest-indexed tied class (its ascending-tree f32 sum gives equal addends
equal partial sums, so count ties stay exact) and the JAX label is one of
the tied classes: the JAX package's f32 contraction rounds tied totals in
an order of its own, so its pick among them is not fixed. Ties are found
from exact vote totals — integer counts for majorityVote, float64 sums of
the segment weights for weightedMajorityVote — never from either package's
f32 shares."""

import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from flink_jpmml_tpu.compile.qtrees import build_quantized_scorer as jax_bqs
from flink_jpmml_tpu.pmml import parse_pmml
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse
from flink_jpmml_tpu_torch import convert
from flink_jpmml_tpu_torch.assets_gen import gen_vote_forest
from flink_jpmml_tpu_torch.compile import compile_pmml, qtrees_cuda
from flink_jpmml_tpu_torch.compile.qtrees import build_quantized_scorer
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse_str
from flink_jpmml_tpu_torch.pmml import parse_pmml_file as tparse
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, FiniteBlockSource
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
from test_torch_qtrees import _forest_xml

RTOL, ATOL = 1e-4, 1e-5
JAX_KEYS = ("feat", "qthr", "dleft", "P_i8", "count_i8", "phi", "plo", "lab")
CASES = [
    pytest.param(dict(n_trees=24, depth=4, n_features=8, n_classes=3),
                 id="t24_d4_f8_c3"),
    # 19 trees: not a multiple of the TPU kernel's group of 4 trees, so
    # its padded trees run
    pytest.param(dict(n_trees=19, depth=6, n_features=32, n_classes=5),
                 id="t19_d6_f32_c5"),
]


def _X(rng, n, F, missing=0.2):
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    X[rng.random(size=X.shape) < missing] = np.nan
    return X


def _jax_np_params(qx):
    p = {k: np.asarray(qx.params[k]) for k in JAX_KEYS}
    p.update(cuts=qx.wire.cuts, repl=qx.wire.repl, has_repl=qx.wire.has_repl)
    return p


def _segment_weights(doc):
    return np.array(
        [s.weight for s in doc.model.segmentation.segments], np.float64
    )


def _vote_totals(tables, lab, weights, codes, C=None):
    """Exact per-class vote totals f64[N, C]: each tree's hit leaf label
    (from the port's front half, independent of the f32 class rows) plus
    its segment weight, summed in float64 (integer counts for equal
    weights)."""
    C = tables["rows"].shape[2] if C is None else C
    leaf_ids = torch.arange(lab.shape[1])
    tot = np.zeros((codes.shape[0], C), np.float64)
    rows = np.arange(codes.shape[0])
    for t, hit in qtrees_cuda._leaf_hits(codes, tables):
        assert bool((hit.sum(dim=1) == 1).all()), "one leaf per tree"
        leaf = torch.where(hit, leaf_ids[None, :], -1).amax(dim=1).numpy()
        np.add.at(tot, (rows, lab[t, leaf].astype(np.int64)), weights[t])
    return tot


def check_labels(got, ref, totals, lowest=True) -> int:
    """The label rule of the module docstring → the number of tied rows.
    With ``lowest=False`` (the torch twin, whose f32 contraction rounds
    tied totals as the JAX package's does, in an order of its own) ``got``
    too need only be one of the tied classes."""
    top = totals.max(axis=1, keepdims=True)
    tied_set = totals == top
    tied = tied_set.sum(axis=1) > 1
    rows = np.arange(len(ref))
    np.testing.assert_array_equal(got[~tied], ref[~tied])
    if lowest:
        np.testing.assert_array_equal(got[tied],
                                      tied_set.argmax(axis=1)[tied])
    assert tied_set[rows, got][tied].all()
    assert tied_set[rows, ref][tied].all()
    return int(tied.sum())


def _jax_scorers(path, B):
    """(grid-form Pallas kernel, mega-layout Pallas kernel, XLA) scorers."""
    jp = jax_bqs(jparse(path), batch_size=B, backend="pallas",
                 pallas_interpret=True)
    assert jp is not None and jp.backend == "pallas"
    jm = jax_bqs(jparse(path), batch_size=B, backend="pallas",
                 pallas_interpret=True)
    built = jm.build_variant("mega")
    # build_variant swallows every error and returns None
    assert built is not None
    jm.adopt_variant(built, "mega")
    jx = jax_bqs(jparse(path), batch_size=B, backend="xla")
    assert jx.backend == "xla"
    return {"pallas": jp, "pallas_mega": jm, "xla": jx}


class TestVoteKernelPlainVersion:
    @pytest.mark.parametrize("missing", [0.0, 0.2])
    @pytest.mark.parametrize("weighted", [False, True],
                             ids=["majority", "weighted"])
    @pytest.mark.parametrize("kw", CASES)
    def test_matches_cls_kernels_and_xla(self, tmp_path, kw, weighted,
                                         missing):
        B = 128
        path = gen_vote_forest(str(tmp_path), weighted=weighted, **kw)
        jax_q = _jax_scorers(path, B)
        jx = jax_q["xla"]
        tables = convert.quantized_params_from_jax(_jax_np_params(jx),
                                                   device="cpu")
        X = _X(np.random.default_rng(0), B, kw["n_features"], missing)
        codes = torch.from_numpy(jx.wire.encode(X))
        before = qtrees_cuda.leaf_rows.launches
        probs = qtrees_cuda.leaf_rows(codes, tables, kw["n_features"])
        assert qtrees_cuda.leaf_rows.launches == before  # CPU: no launch
        assert probs.shape == (B, kw["n_classes"])
        lab = torch.argmax(probs, dim=1).numpy()
        value = probs.numpy()[np.arange(B), lab]

        w = _segment_weights(tparse(path)) if weighted else np.ones(
            kw["n_trees"])
        totals = _vote_totals(tables, tables["lab"].numpy(), w, codes)
        np.testing.assert_allclose(probs.numpy(), totals / w.sum(),
                                   rtol=RTOL, atol=ATOL)
        for name, jq in jax_q.items():
            jv, jp, jl = (np.asarray(a) for a in jq.predict_wire(codes.numpy()))
            np.testing.assert_allclose(probs.numpy(), jp, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
            np.testing.assert_allclose(value, jv, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
            n_tied = check_labels(lab, jl, totals)
            print(f"{name}: {n_tied} of {B} rows tied on vote total")

    def test_ties_occur_and_take_the_lowest_class(self, tmp_path):
        # 24 equal-weight trees over 3 classes tie often: the rule above
        # must act on real rows, and the shares of tied classes must be
        # exactly equal
        B = 512
        path = gen_vote_forest(str(tmp_path), n_trees=24, depth=4,
                               n_features=8, n_classes=3)
        jx = jax_bqs(jparse(path), batch_size=B, backend="xla")
        tq = build_quantized_scorer(tparse(path), batch_size=B, device="cpu")
        X = _X(np.random.default_rng(7), B, 8)
        codes = jx.wire.encode(X)
        _, probs, lab = tq.predict_wire(codes)
        tables = {k: tq.params[k] for k in qtrees_cuda.TABLE_KEYS}
        totals = _vote_totals(tables, tq.params["lab"].numpy(),
                              np.ones(24), torch.from_numpy(codes))
        n_tied = check_labels(lab.numpy(), np.asarray(jx.predict_wire(codes)[2]),
                              totals)
        print(f"{n_tied} of {B} rows tied on vote count")
        assert n_tied > 0
        top = totals == totals.max(axis=1, keepdims=True)
        shares = probs.numpy()
        for r in np.nonzero(top.sum(axis=1) > 1)[0]:
            assert len(set(shares[r][top[r]].tolist())) == 1

    @pytest.mark.parametrize("weighted", [False, True],
                             ids=["majority", "weighted"])
    def test_forest_xml_fixture(self, weighted):
        # the repo's own vote-forest fixture (tests/test_qtrees.py)
        xml = _forest_xml(
            "weightedMajorityVote" if weighted else "majorityVote", weighted
        )
        B = 64
        jqs = {
            name: jax_bqs(parse_pmml(xml), batch_size=B, backend=backend,
                          pallas_interpret=True)
            for name, backend in (("pallas", "pallas"), ("xla", "xla"))
        }
        built = jqs["pallas"].build_variant("mega")
        assert built is not None
        jm = jax_bqs(parse_pmml(xml), batch_size=B, backend="pallas",
                     pallas_interpret=True)
        jm.adopt_variant(built, "mega")
        jqs["pallas_mega"] = jm
        td = tparse_str(xml)
        tq = build_quantized_scorer(td, batch_size=B, device="cpu")
        assert tq.backend == "cuda_plain"
        X = _X(np.random.default_rng(5), B, 4, missing=0.15)
        codes = jqs["xla"].wire.encode(X)
        tv, tp, tl = (t.numpy() for t in tq.predict_wire(codes))
        w = _segment_weights(td) if weighted else np.ones(7)
        tables = {k: tq.params[k] for k in qtrees_cuda.TABLE_KEYS}
        totals = _vote_totals(tables, tq.params["lab"].numpy(), w,
                              torch.from_numpy(codes))
        for name, jq in jqs.items():
            jv, jp, jl = (np.asarray(a) for a in jq.predict_wire(codes))
            np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
            np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
            print(f"{name}: {check_labels(tl, jl, totals)} of {B} rows tied")


class TestConvertVotes:
    @pytest.mark.parametrize("weighted", [False, True],
                             ids=["majority", "weighted"])
    def test_same_tables_as_the_port(self, tmp_path, weighted):
        path = gen_vote_forest(str(tmp_path), n_trees=19, depth=4,
                               n_features=8, n_classes=3, weighted=weighted)
        jx = jax_bqs(jparse(path), batch_size=64, backend="xla")
        src = _jax_np_params(jx)
        conv = convert.quantized_params_from_jax(src, device="cpu")
        for k in ("phi", "plo"):  # bf16 bits carried, not rounded again
            np.testing.assert_array_equal(
                conv[k].view(torch.int16).numpy(), src[k].view(np.int16)
            )
        np.testing.assert_array_equal(conv["lab"].numpy(), src["lab"])
        assert "vhi" not in conv and "vals" not in conv
        tq = build_quantized_scorer(tparse(path), batch_size=64, device="cpu")
        assert tq.backend == "cuda_plain"
        for k in JAX_KEYS + qtrees_cuda.TABLE_KEYS:
            a, b = tq.params[k], conv[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), k
        # the one f32 class table is the bf16 pair's sum, bit for bit
        pair = conv["phi"].float() + conv["plo"].float()
        assert torch.equal(conv["rows"].view(torch.int32),
                           pair.view(torch.int32))


def _single_tree_xml(path):
    """The first TreeModel of a generated vote forest as a document of its
    own (multipleModelMethod "single" in the scorer)."""
    ns = "{http://www.dmg.org/PMML-4_3}"
    ET.register_namespace("", ns[1:-1])
    root = ET.parse(path).getroot()
    mm = root.find(f"{ns}MiningModel")
    tree = mm.find(f"{ns}Segmentation/{ns}Segment/{ns}TreeModel")
    root.remove(mm)
    root.append(tree)
    return ET.tostring(root, encoding="unicode")


class TestScorer:
    @pytest.mark.parametrize("weighted", [False, True],
                             ids=["majority", "weighted"])
    def test_vote_forests_take_the_kernel(self, tmp_path, weighted):
        path = gen_vote_forest(str(tmp_path), n_trees=19, depth=5,
                               n_features=8, n_classes=4, weighted=weighted)
        td = tparse(path)
        tq = compile_pmml(td, batch_size=64, device="cpu").quantized_scorer()
        assert tq.backend == "cuda_plain" and tq.is_classification
        jq = jax_bqs(jparse(path), batch_size=64, backend="xla")
        X = _X(np.random.default_rng(11), 150, 8)  # ragged: 3 batches
        got, ref = tq.score(X), jq.score(X)
        assert len(got) == len(ref) == 150
        w = _segment_weights(td) if weighted else np.ones(19)
        codes = torch.from_numpy(tq.wire.encode(X))
        tables = {k: tq.params[k] for k in qtrees_cuda.TABLE_KEYS}
        totals = _vote_totals(tables, tq.params["lab"].numpy(), w, codes)
        labels = list(tq.labels)
        check_labels(
            np.array([labels.index(p.target.label) for p in got]),
            np.array([labels.index(p.target.label) for p in ref]), totals,
        )
        for g, r in zip(got, ref):
            assert g.target.probabilities.keys() == r.target.probabilities.keys()
            np.testing.assert_allclose(
                list(g.target.probabilities.values()),
                list(r.target.probabilities.values()), rtol=RTOL, atol=ATOL,
            )

    def test_single_tree_stays_on_the_twin(self, tmp_path):
        path = gen_vote_forest(str(tmp_path), n_trees=3, depth=3,
                               n_features=4, n_classes=3)
        xml = _single_tree_xml(path)
        tq = build_quantized_scorer(tparse_str(xml), device="cpu")
        assert tq is not None and tq.backend == "torch"
        jq = jax_bqs(parse_pmml(xml), backend="xla")
        X = _X(np.random.default_rng(1), 40, 4)
        assert [p.target.label for p in tq.score(X)] == [
            p.target.label for p in jq.score(X)]

    def test_more_classes_than_the_kernel_stays_on_the_twin(self, tmp_path):
        C = qtrees_cuda.MAX_CLASSES + 1
        path = gen_vote_forest(str(tmp_path), n_trees=40, depth=5,
                               n_features=6, n_classes=C)
        tq = build_quantized_scorer(tparse(path), batch_size=32, device="cpu")
        assert len(tq.labels) == C and tq.backend == "torch"
        jq = jax_bqs(jparse(path), batch_size=32, backend="xla")
        Xq = jq.wire.encode(_X(np.random.default_rng(2), 32, 6))
        tv, tp, tl = (t.numpy() for t in tq.predict_wire(Xq))
        jv, jp, jl = (np.asarray(a) for a in jq.predict_wire(Xq))
        np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
        # exact vote counts from the front half of the kernel's tables,
        # packed here only to find the ties (the scorer holds none)
        p = {k: tq.params[k].numpy()
             for k in ("feat", "qthr", "dleft", "P_i8", "count_i8", "lab")}
        masks = {k: torch.from_numpy(v) for k, v in qtrees_cuda._pack_masks(
            p["feat"], p["qthr"], p["dleft"], p["P_i8"], p["count_i8"],
            6).items()}
        totals = _vote_totals(masks, p["lab"], np.ones(40),
                              torch.from_numpy(Xq), C)
        n_tied = check_labels(tl, jl, totals, lowest=False)
        print(f"{n_tied} of 32 rows tied on vote count")


def test_block_pipeline_delivers_vote_triples(tmp_path):
    B = 128
    path = gen_vote_forest(str(tmp_path), n_trees=24, depth=4, n_features=8,
                           n_classes=3, weighted=True)
    X = _X(np.random.default_rng(3), 1000, 8)
    cm = compile_pmml(tparse(path), batch_size=B, device="cpu")
    got = []
    pipe = BlockPipeline(
        FiniteBlockSource(X, 300), cm,
        lambda out, n, off: got.append((off, n, out)),
        RuntimeConfig(batch=BatchConfig(size=B, deadline_us=2000)),
        max_dispatch_chunks=4,
    )
    assert pipe.backend == "rank_wire_cuda_plain"
    pipe.run_until_exhausted(timeout=120)
    expect = 0
    for off, n, out in got:
        assert off == expect and len(out) == 3
        expect += n
    assert expect == 1000
    value, probs, lab = (
        np.concatenate([np.asarray(out[i])[:n] for _, n, out in got])
        for i in range(3)
    )
    jq = jax_bqs(jparse(path), batch_size=B, backend="xla")
    jv, jp, jl = (np.asarray(a)[:1000] for a in
                  jq.predict_wire(jq.wire.encode(X)))
    np.testing.assert_allclose(probs, jp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(value, jv, rtol=RTOL, atol=ATOL)
    q = pipe._bound.q
    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    totals = _vote_totals(tables, q.params["lab"].numpy(),
                          _segment_weights(tparse(path)),
                          torch.from_numpy(q.wire.encode(X)))
    check_labels(lab, jl, totals)
    decoded = pipe.decode(got[0][2], got[0][1])
    assert decoded[0].target.label in q.labels


class TestVoteWrapper:
    def _tables(self, tmp_path, C=3):
        path = gen_vote_forest(str(tmp_path), n_trees=5, depth=3,
                               n_features=4, n_classes=C)
        q = build_quantized_scorer(tparse(path), device="cpu")
        return q, {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}

    @pytest.mark.parametrize("width", [3, 5])
    def test_rejects_codes_of_another_width(self, tmp_path, width):
        q, tables = self._tables(tmp_path)
        codes = torch.zeros((8, width), dtype=torch.uint8)
        with pytest.raises(ValueError, match="packed for 4"):
            qtrees_cuda.leaf_rows(codes, tables, 4)
        with pytest.raises(ValueError, match="packed for 4"):
            q.predict_wire(codes.numpy())

    def test_rejects_too_many_classes(self, tmp_path):
        _, tables = self._tables(tmp_path)
        T, L = tables["on"].shape
        wide = dict(tables, rows=torch.zeros(
            (T, L, qtrees_cuda.MAX_CLASSES + 1)))
        codes = torch.zeros((4, 4), dtype=torch.uint8)
        with pytest.raises(ValueError, match="classes outside"):
            qtrees_cuda.leaf_rows(codes, wide, 4)
        split = tables["split"].numpy()
        phi = torch.zeros((T, L, qtrees_cuda.MAX_CLASSES + 1),
                          dtype=torch.bfloat16)
        P = np.zeros((T, split.shape[1], L), np.int8)
        with pytest.raises(ValueError, match="classes outside"):
            qtrees_cuda.pack_tables(
                split & 0xFFFF, np.zeros_like(split), split < 0, P,
                np.full((T, L), -5), phi, phi, 4,
            )

    def test_rejects_inconsistent_tables(self, tmp_path):
        q, tables = self._tables(tmp_path)
        codes = torch.zeros((4, 4), dtype=torch.uint8)
        T, L = tables["on"].shape
        with pytest.raises(ValueError, match="table 'rows'"):
            qtrees_cuda.leaf_rows(
                codes, dict(tables, rows=tables["rows"][: T - 1]), 4)
        with pytest.raises(ValueError, match="table 'rows'"):
            qtrees_cuda.leaf_rows(
                codes, dict(tables, rows=tables["rows"].double()), 4)
        with pytest.raises(ValueError, match="table 'on'"):
            qtrees_cuda.leaf_rows(
                codes, dict(tables, on=tables["on"].int()), 4)
        with pytest.raises(ValueError, match="u8"):
            qtrees_cuda.leaf_rows(codes.float(), tables, 4)
        p = q.params
        with pytest.raises(ValueError, match="bf16 pair"):
            qtrees_cuda.pack_tables(
                p["feat"].numpy(), p["qthr"].numpy(), p["dleft"].numpy(),
                p["P_i8"].numpy(), p["count_i8"].numpy(), p["phi"].float(),
                p["plo"], 4)
        with pytest.raises(ValueError, match="path counts"):
            qtrees_cuda.pack_tables(
                p["feat"].numpy(), p["qthr"].numpy(), p["dleft"].numpy(),
                p["P_i8"].numpy(), p["count_i8"].numpy() + 1, p["phi"],
                p["plo"], 4)

    def test_padded_leaves_never_vote(self):
        # one split, two real leaves and a padded slot (count -5) whose
        # class row must never be added
        feat = np.zeros((1, 1), np.int64)
        rows = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [100.0, 100.0]]])
        hi = rows.to(torch.bfloat16)
        lo = (rows - hi.float()).to(torch.bfloat16)
        tables = {k: torch.from_numpy(v) for k, v in
                  qtrees_cuda.pack_tables(
                      feat, np.array([[3]], np.uint8), np.array([[False]]),
                      np.array([[[1, -1, 0]]], np.int8),
                      np.array([[1, 1, -5]]), hi, lo, 1).items()}
        codes = torch.tensor([[0], [3], [4], [255]], dtype=torch.uint8)
        assert qtrees_cuda.leaf_rows(codes, tables, 1).tolist() == [
            [1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]]

    def test_class_limit_matches_the_kernel_source(self):
        src = qtrees_cuda.SOURCE.read_text()
        m = re.search(r"constexpr int kMaxClasses = (\d+);", src)
        assert m and int(m.group(1)) == qtrees_cuda.MAX_CLASSES
