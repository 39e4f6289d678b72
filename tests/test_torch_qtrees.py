"""Rank wire of the PyTorch port against the JAX package.

Rank codes must be byte-identical to ``QuantizedWire.encode``; the Hopper
kernel's plain version (what the kernel wrapper runs on a CPU tensor)
must match the JAX package's Pallas kernel in interpret mode and its XLA
path, and the torch twin of the XLA ``qfn`` must match the XLA path, at
the repo's rank-wire bar rtol 1e-4 / atol 1e-5 (tests/test_qtrees_pallas.py
— the order of the f32 tree sum differs between the backends). Tables
carry across through ``convert.quantized_params_from_jax``."""

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from flink_jpmml_tpu.compile.qtrees import build_quantized_scorer as jax_bqs
from flink_jpmml_tpu.pmml import parse_pmml, parse_pmml_file as jparse
from flink_jpmml_tpu_torch import convert
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml, qtrees_cuda
from flink_jpmml_tpu_torch.compile.common import apply_targets_value
from flink_jpmml_tpu_torch.compile.qtrees import (
    _match_ensemble,
    _torch_qfn,
    build_quantized_scorer,
)
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse_str
from flink_jpmml_tpu_torch.pmml import parse_pmml_file as tparse

RTOL, ATOL = 1e-4, 1e-5
JAX_KEYS = ("feat", "qthr", "dleft", "P_i8", "count_i8", "vhi", "vlo")


def _docs(path):
    return tparse(path), jparse(path)


def _gbm(tmp_path, **kw):
    return gen_gbm(str(tmp_path), **kw)


def _X(rng, n, F, missing=0.2):
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    X[rng.random(size=X.shape) < missing] = np.nan
    return X


def _jax_np_params(qx):
    p = {k: np.asarray(qx.params[k]) for k in JAX_KEYS}
    p.update(cuts=qx.wire.cuts, repl=qx.wire.repl, has_repl=qx.wire.has_repl)
    return p


def _with_replacements(path, repl):
    """Declare mining-schema missingValueReplacement on the top model."""
    ET.register_namespace("", "http://www.dmg.org/PMML-4_3")
    tree = ET.parse(path)
    ns = "{http://www.dmg.org/PMML-4_3}"
    mm = tree.getroot().find(f"{ns}MiningModel")
    for mf in mm.find(f"{ns}MiningSchema"):
        if mf.get("name") in repl:
            mf.set("missingValueReplacement", repl[mf.get("name")])
    tree.write(path, encoding="utf-8", xml_declaration=True)
    return path


class TestRankCodes:
    @pytest.mark.parametrize("kw", [
        dict(n_trees=21, depth=4, n_features=8),
        dict(n_trees=40, depth=4, n_features=8, hist_bins=None),
        dict(n_trees=300, depth=5, n_features=2, hist_bins=None),  # u16
    ])
    def test_codes_byte_identical(self, tmp_path, kw):
        td, jd = _docs(_gbm(tmp_path, **kw))
        tq = build_quantized_scorer(td, device="cpu")
        jq = jax_bqs(jd, backend="xla")
        assert tq.wire.dtype is jq.wire.dtype
        for a, b in zip(tq.wire.cuts, jq.wire.cuts):
            np.testing.assert_array_equal(a, b)
        rng = np.random.default_rng(1)
        X = _X(rng, 257, kw["n_features"])
        X[0, :] = np.nan
        X[1, :] = np.inf
        X[2, :] = -np.inf
        M = rng.random(size=X.shape) < 0.1
        for mask in (None, M):
            got, ref = tq.wire.encode(X, mask), jq.wire.encode(X, mask)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)

    def test_codes_with_mining_schema_replacement(self, tmp_path):
        path = _with_replacements(
            _gbm(tmp_path, n_trees=21, depth=4, n_features=8),
            {"f1": "0.25", "f5": "-1.5"},
        )
        td, jd = _docs(path)
        tq = build_quantized_scorer(td, device="cpu")
        jq = jax_bqs(jd, backend="xla")
        assert tq.wire.has_repl.sum() == 2
        X = _X(np.random.default_rng(2), 300, 8, missing=0.3)
        got = tq.wire.encode(X)
        np.testing.assert_array_equal(got, jq.wire.encode(X))
        assert (got[:, [1, 5]] != tq.wire.sentinel).all()
        np.testing.assert_allclose(
            tq.predict_wire(got).numpy(), np.asarray(jq.predict_wire(got)),
            rtol=RTOL, atol=ATOL,
        )


class TestConvert:
    def test_round_trip_and_same_tables_as_the_port(self, tmp_path):
        td, jd = _docs(_gbm(tmp_path, n_trees=19, depth=4, n_features=8))
        jx = jax_bqs(jd, batch_size=64, backend="xla")
        src = _jax_np_params(jx)
        conv = convert.quantized_params_from_jax(src, device="cpu")
        # round trip: every JAX table comes back unchanged
        for k in ("feat", "qthr", "dleft", "P_i8", "count_i8"):
            np.testing.assert_array_equal(
                conv[k].numpy(), src[k].astype(conv[k].numpy().dtype)
            )
        for k in ("vhi", "vlo"):
            np.testing.assert_array_equal(
                conv[k].view(torch.int16).numpy(), src[k].view(np.int16)
            )
        for j, c in enumerate(src["cuts"]):
            n = int(conv["n_cuts"][j])
            np.testing.assert_array_equal(conv["cuts"][j, :n].numpy(), c)
            assert torch.isinf(conv["cuts"][j, n:]).all()
        # the port's own build from the same PMML yields the same tables
        tq = build_quantized_scorer(td, batch_size=64, device="cpu")
        assert tq.backend == "cuda_plain"
        for k in JAX_KEYS + qtrees_cuda.TABLE_KEYS:
            a, b = tq.params[k], conv[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                               else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16
                               else b), k


class TestKernelPlainVersion:
    @pytest.mark.parametrize("kw,B,missing", [
        (dict(n_trees=21, depth=4, n_features=8), 64, 0.2),
        (dict(n_trees=19, depth=3, n_features=4), 32, 0.0),  # padded groups
        (dict(n_trees=19, depth=6, n_features=32), 64, 0.2),
    ])
    def test_matches_pallas_interpret_and_xla(self, tmp_path, kw, B, missing):
        td, jd = _docs(_gbm(tmp_path, **kw))
        jp = jax_bqs(jd, batch_size=B, backend="pallas", pallas_interpret=True)
        jx = jax_bqs(jd, batch_size=B, backend="xla")
        assert jp is not None and jp.backend == "pallas"
        tables = convert.quantized_params_from_jax(_jax_np_params(jx),
                                                   device="cpu")
        X = _X(np.random.default_rng(0), B, kw["n_features"], missing)
        codes = jx.wire.encode(X)
        before = qtrees_cuda.leaf_rows.launches
        raw = qtrees_cuda.leaf_rows(torch.from_numpy(codes), tables,
                                    kw["n_features"])
        assert qtrees_cuda.leaf_rows.launches == before  # CPU: no launch
        assert raw.shape == (B, 1)
        got = apply_targets_value(raw[:, 0], td.targets).numpy()
        np.testing.assert_allclose(got, np.asarray(jp.predict_wire(codes)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jx.predict_wire(codes)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(
            got,
            qtrees_cuda.leaf_rows_reference(torch.from_numpy(codes), tables)
            [:, 0].add(0.5).numpy(),  # gen_gbm's Targets rescaleConstant
        )

    def test_oversized_and_ragged_batches(self, tmp_path):
        td, jd = _docs(_gbm(tmp_path, n_trees=13, depth=3, n_features=4))
        B = 32
        tq = build_quantized_scorer(td, batch_size=B, device="cpu")
        jp = jax_bqs(jd, batch_size=B, backend="pallas", pallas_interpret=True)
        rng = np.random.default_rng(2)
        for n in (B - 5, B, 2 * B, 2 * B + 7):
            X = _X(rng, n, 4, missing=0.15)
            Xq, K = tq.pad_wire(tq.wire.encode(X))
            assert Xq.shape[0] == K * B >= n
            got = [p.score.value for p in tq.score(X)]
            ref = [p.score.value for p in jp.score(X)]
            assert len(got) == n
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


class TestTorchTwin:
    def test_u16_wire_matches_xla(self, tmp_path):
        # tests/test_qtrees.py:61's model: >254 cuts per feature → uint16,
        # which the kernel does not take
        td, jd = _docs(_gbm(tmp_path, n_trees=300, depth=5, n_features=2,
                            hist_bins=None))
        tq = compile_pmml(td, device="cpu").quantized_scorer()
        jq = jax_bqs(jd)
        assert tq.wire.dtype is np.uint16 and tq.backend == "torch"
        X = _X(np.random.default_rng(3), 64, 2, missing=0.1)
        Xq = jq.wire.encode(X)
        np.testing.assert_allclose(
            tq.predict_wire(Xq).numpy(), np.asarray(jq.predict_wire(Xq)),
            rtol=RTOL, atol=ATOL,
        )

    @pytest.mark.parametrize("method", ["max", "median", "average",
                                        "weightedAverage"])
    def test_aggregates_match_xla(self, tmp_path, method):
        path = _gbm(tmp_path, n_trees=12, depth=3, n_features=6)
        xml = open(path).read().replace(
            'multipleModelMethod="sum"', f'multipleModelMethod="{method}"')
        for t in range(12):
            xml = xml.replace(f'<Segment id="{t}">',
                              f'<Segment id="{t}" weight="{0.5 + 0.1 * t}">')
        td, jd = tparse_str(xml), parse_pmml(xml)
        tq = build_quantized_scorer(td, batch_size=16, device="cpu")
        jq = jax_bqs(jd, batch_size=16, backend="xla")
        assert tq.backend == ("torch" if method in ("max", "median")
                              else "cuda_plain")
        X = _X(np.random.default_rng(4), 40, 6)
        got = [p.score.value for p in tq.score(X)]
        ref = [p.score.value for p in jq.score(X)]
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("weighted", [False, True])
    def test_vote_forest_matches_xla(self, weighted):
        xml = _forest_xml(
            "weightedMajorityVote" if weighted else "majorityVote", weighted
        )
        td = tparse_str(xml)
        kq = build_quantized_scorer(td, device="cpu")
        jq = jax_bqs(parse_pmml(xml), backend="xla")
        assert kq.backend == "cuda_plain" and kq.is_classification
        # the twin's majority / weighted branch, on the same tables: it
        # still scores vote forests the kernel does not take (uint16
        # wires, > 64 split slots, > MAX_CLASSES classes)
        tq = dataclasses.replace(kq, backend="torch", _fn=_torch_qfn(
            _match_ensemble(td)[2], True, False, kq.wire.sentinel,
            td.targets))
        X = _X(np.random.default_rng(5), 128, 4, missing=0.15)
        Xq = jq.wire.encode(X)
        tv, tp, tl = tq.predict_wire(Xq)
        jv, jp, jl = (np.asarray(a) for a in jq.predict_wire(Xq))
        np.testing.assert_array_equal(tl.numpy(), jl)
        np.testing.assert_allclose(tp.numpy(), jp, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), jv, rtol=RTOL, atol=ATOL)
        assert [p.target.label for p in tq.score(X)] == [
            p.target.label for p in jq.score(X)
        ]


class TestKernelWrapper:
    def _tables(self, tmp_path):
        td = tparse(_gbm(tmp_path, n_trees=5, depth=3, n_features=4))
        q = build_quantized_scorer(td, device="cpu")
        return {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}

    def test_rejects_what_the_kernel_does_not_take(self, tmp_path):
        tables = self._tables(tmp_path)
        with pytest.raises(ValueError, match="u8"):
            qtrees_cuda.leaf_rows(torch.zeros(4, 4), tables, 4)
        with pytest.raises(ValueError, match="no kernel"):
            qtrees_cuda.leaf_rows(
                torch.zeros(4, 4, dtype=torch.uint8, device="meta"), tables, 4
            )

    @pytest.mark.parametrize("width", [3, 5])
    def test_rejects_codes_of_another_width(self, tmp_path, width):
        # the kernel gathers code[feat] from a row of the packed width: a
        # narrower batch would read the neighbouring row's codes
        td = tparse(_gbm(tmp_path, n_trees=5, depth=3, n_features=4))
        q = build_quantized_scorer(td, batch_size=8, device="cpu")
        codes = np.zeros((8, width), np.uint8)
        with pytest.raises(ValueError, match="packed for 4"):
            qtrees_cuda.leaf_rows(
                torch.from_numpy(codes),
                {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}, 4,
            )
        with pytest.raises(ValueError, match="packed for 4"):
            q.predict_wire(codes)

    def test_packer_rejects_inconsistent_tables(self):
        feat = np.zeros((1, 1), np.int64)
        P = np.array([[[1, -1]]], np.int8)
        vals = torch.zeros((1, 2), dtype=torch.bfloat16)
        ok = qtrees_cuda.pack_tables(feat, feat.astype(np.uint8), feat > 0,
                                     P, np.array([[1, 1]]), vals, vals, 2)
        assert ok["on"].tolist() == [[1, 1]] and ok["left"].tolist() == [[1, 0]]
        assert ok["rows"].shape == (1, 2, 1)
        with pytest.raises(ValueError, match="path counts"):
            qtrees_cuda.pack_tables(feat, feat.astype(np.uint8), feat > 0,
                                    P, np.array([[2, 1]]), vals, vals, 2)
        with pytest.raises(ValueError, match="split slots"):
            qtrees_cuda.pack_tables(
                np.zeros((1, 65), np.int64), np.zeros((1, 65), np.uint8),
                np.zeros((1, 65), bool), np.zeros((1, 65, 2), np.int8),
                np.array([[-5, -5]]), vals, vals, 2,
            )

    def test_padded_leaves_never_hit(self):
        # tree 0 has 2 real leaves and one padded slot (count -5): the
        # padded slot's value must never be added
        feat = np.zeros((1, 1), np.int64)
        P = np.array([[[1, -1, 0]]], np.int8)
        vals = torch.tensor([[1.0, 2.0, 100.0]], dtype=torch.bfloat16)
        tables = {k: torch.from_numpy(v) for k, v in qtrees_cuda.pack_tables(
            feat, np.array([[3]], np.uint8), np.array([[False]]), P,
            np.array([[1, 1, -5]]), vals, torch.zeros_like(vals), 1).items()}
        codes = torch.tensor([[0], [3], [4], [255]], dtype=torch.uint8)
        out = qtrees_cuda.leaf_rows(codes, tables, 1)
        assert out.tolist() == [[1.0], [1.0], [2.0], [2.0]]  # 255: missing → right


def _forest_xml(method="majorityVote", weighted=False, n_trees=7, seed=21):
    """A small classification vote forest (tests/test_qtrees.py's)."""
    rng = np.random.default_rng(seed)
    segs = []
    for t in range(n_trees):
        w = f' weight="{0.5 + 0.25 * t}"' if weighted else ""
        f1, f2 = rng.integers(0, 4, size=2)
        t1, t2 = rng.normal(0, 1, size=2)
        labs = rng.choice(["p", "q", "r"], size=3)
        segs.append(f"""<Segment{w}><True/>
          <TreeModel functionName="classification" missingValueStrategy="defaultChild" splitCharacteristic="binarySplit">
            <MiningSchema><MiningField name="y" usageType="target"/>
              <MiningField name="f0"/><MiningField name="f1"/>
              <MiningField name="f2"/><MiningField name="f3"/></MiningSchema>
            <Node id="0" defaultChild="1"><True/>
              <Node id="1" defaultChild="3">
                <SimplePredicate field="f{f1}" operator="lessThan" value="{t1:.6f}"/>
                <Node id="3" score="{labs[0]}"><SimplePredicate field="f{f2}" operator="lessThan" value="{t2:.6f}"/></Node>
                <Node id="4" score="{labs[1]}"><SimplePredicate field="f{f2}" operator="greaterOrEqual" value="{t2:.6f}"/></Node>
              </Node>
              <Node id="2" score="{labs[2]}"><SimplePredicate field="f{f1}" operator="greaterOrEqual" value="{t1:.6f}"/></Node>
            </Node>
          </TreeModel></Segment>""")
    return f"""<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3">
      <Header/>
      <DataDictionary numberOfFields="5">
        <DataField name="f0" optype="continuous" dataType="double"/>
        <DataField name="f1" optype="continuous" dataType="double"/>
        <DataField name="f2" optype="continuous" dataType="double"/>
        <DataField name="f3" optype="continuous" dataType="double"/>
        <DataField name="y" optype="categorical" dataType="string">
          <Value value="p"/><Value value="q"/><Value value="r"/></DataField>
      </DataDictionary>
      <MiningModel functionName="classification">
        <MiningSchema><MiningField name="y" usageType="target"/>
          <MiningField name="f0"/><MiningField name="f1"/>
          <MiningField name="f2"/><MiningField name="f3"/></MiningSchema>
        <Segmentation multipleModelMethod="{method}">{''.join(segs)}</Segmentation>
      </MiningModel></PMML>"""
