"""Mesh-aware compile in the port (BASELINE config 5) against the JAX
package, on the CPU: the twin of tests/test_mesh_compile.py.

``compile_pmml(..., mesh=)`` must feature-shard the stacked model's wide
linear stage over the ``model`` axis inside the compiled scorer, pick the
same leaves as the JAX rule, and agree with the JAX sharded model, the
unsharded port and the oracle. The JAX side runs on the 8-device virtual
CPU mesh; the port's on logical ``cpu:i`` devices.
"""

import numpy as np
import pytest

from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse_file
from flink_jpmml_tpu.pmml.interp import evaluate
from flink_jpmml_tpu.utils.config import CompileConfig as JCompileConfig
from flink_jpmml_tpu.utils.config import MeshConfig as JMeshConfig
from flink_jpmml_tpu_torch.assets_gen import gen_stacked
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.compile.common import TpLeaf
from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices, make_mesh
from flink_jpmml_tpu_torch.parallel.sharding import (
    ShardedModel,
    mesh_sharded,
)
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.utils.config import CompileConfig, MeshConfig
from flink_jpmml_tpu_torch.utils.exceptions import NotPortedError

WIDE_F = 10_000  # config 5's 10k-dim feature space
RTOL, ATOL = 1e-4, 1e-5
SHAPES = [(8, 1), (4, 2), (2, 4)]


def tmesh(data, model):
    return make_mesh(MeshConfig(data=data, model=model),
                     devices=cpu_devices(8))


def jmesh(data, model):
    return jmake_mesh(JMeshConfig(data=data, model=model))


@pytest.fixture(scope="module")
def wide_path(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_wide_stacked")
    return gen_stacked(
        str(out), n_trees=10, depth=3, n_features=WIDE_F, wide_lr=True
    )


@pytest.fixture(scope="module")
def wide_doc(wide_path):
    return parse_pmml_file(wide_path)


@pytest.fixture(scope="module")
def jwide_doc(wide_path):
    return jparse_file(wide_path)


def _records(doc, n, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, size=(n, WIDE_F)).astype(np.float32)
    fields = doc.active_fields
    return X, [dict(zip(fields, row.tolist())) for row in X]


def _assert_preds_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_empty == w.is_empty
        if not g.is_empty:
            assert g.score.value == pytest.approx(
                w.score.value, rel=RTOL, abs=ATOL)


class TestMeshCompile:
    @pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
    def test_wide_stage_is_tp_sharded(self, wide_doc, jwide_doc, shape):
        sm = compile_pmml(wide_doc, batch_size=64, mesh=tmesh(*shape))
        jsm = jcompile(jwide_doc, batch_size=64, mesh=jmesh(*shape))
        assert isinstance(sm, ShardedModel)
        # the wide LR's [10k] coefficient vector is model-axis sharded;
        # the narrow calibration/tree params replicate — the same leaves
        # the JAX rule picks
        assert sm.tp_sharded_leaves == jsm.tp_sharded_leaves
        assert any("num_coefs" in leaf for leaf in sm.tp_sharded_leaves)
        leaf = sm.params["model"]["s1"]["t0"]["num_coefs"]
        assert isinstance(leaf, TpLeaf)
        assert len(leaf.parts) == shape[1]
        assert leaf.bounds[-1][1] == WIDE_F

    @pytest.mark.parametrize("shape", SHAPES)
    def test_sharded_matches_jax_unsharded_and_oracle(
            self, wide_doc, jwide_doc, shape):
        sm = compile_pmml(wide_doc, batch_size=64, mesh=tmesh(*shape))
        jsm = jcompile(jwide_doc, batch_size=64, mesh=jmesh(*shape))
        cm = compile_pmml(wide_doc, batch_size=64, device="cpu")
        X, recs = _records(wide_doc, 64)
        M = np.zeros_like(X, bool)
        got = sm.predict(X, M)
        np.testing.assert_allclose(got.value.numpy(),
                                   np.asarray(jsm.predict(X, M).value),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(jsm.predict(X, M).valid))
        preds = sm.score_records(recs)
        _assert_preds_match(preds, cm.score_records(recs))
        _assert_preds_match(preds, jsm.score_records(recs))
        # oracle spot-diff (per-record python interpreter, so few lanes)
        for i in (0, 17, 63):
            o = evaluate(jwide_doc, recs[i])
            assert preds[i].score.value == pytest.approx(
                o.value, rel=2e-3, abs=1e-4)

    @pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
    def test_missing_and_invalid_lanes_survive_sharding(
            self, wide_doc, jwide_doc, shape):
        sm = compile_pmml(wide_doc, batch_size=64, mesh=tmesh(*shape))
        jsm = jcompile(jwide_doc, batch_size=64, mesh=jmesh(*shape))
        cm = compile_pmml(wide_doc, batch_size=64, device="cpu")
        _, recs = _records(wide_doc, 8)
        recs[1]["f17"] = None  # missing numeric → lane semantics
        recs[3] = {k: v for k, v in recs[3].items() if k != "f0"}
        got = sm.score_records(recs)
        _assert_preds_match(got, cm.score_records(recs))
        _assert_preds_match(got, jsm.score_records(recs))

    def test_pure_dp_mesh_has_no_tp_leaves(self, wide_doc):
        sm = compile_pmml(wide_doc, batch_size=64, mesh=tmesh(8, 1))
        assert sm.tp_sharded_leaves == ()

    def test_narrow_model_stays_replicated(self, tmp_path):
        path = gen_stacked(
            str(tmp_path), n_trees=5, depth=3, n_features=32, wide_lr=True
        )
        doc = parse_pmml_file(path)
        sm = compile_pmml(doc, batch_size=32, mesh=tmesh(4, 2))
        assert sm.tp_sharded_leaves == ()  # nothing crosses the threshold
        cm = compile_pmml(doc, batch_size=32, device="cpu")
        rng = np.random.default_rng(0)
        X = rng.normal(size=(32, 32)).astype(np.float32)
        recs = [dict(zip(doc.active_fields, r.tolist())) for r in X]
        for g, w in zip(sm.score_records(recs), cm.score_records(recs)):
            assert g.score.value == pytest.approx(w.score.value, rel=1e-6)

    def test_threshold_is_configurable(self, tmp_path):
        path = gen_stacked(
            str(tmp_path), n_trees=5, depth=3, n_features=64, wide_lr=True
        )
        sm = compile_pmml(
            parse_pmml_file(path), batch_size=32, mesh=tmesh(4, 2),
            config=CompileConfig(tp_wide_threshold=64),
        )
        jsm = jcompile(
            jparse_file(path), batch_size=32, mesh=jmesh(4, 2),
            config=JCompileConfig(tp_wide_threshold=64),
        )
        assert sm.tp_sharded_leaves == jsm.tp_sharded_leaves
        assert any("num_coefs" in leaf for leaf in sm.tp_sharded_leaves)

    def test_verification_replays_through_sharded_path(self):
        # <ModelVerification> must validate the computation that will
        # actually serve: the sharded one, not the unsharded base
        from flink_jpmml_tpu_torch.pmml import parse_pmml
        from test_verification import REG

        good = parse_pmml(REG.format(y1="-3.5", y2="-1.25"))
        sm = compile_pmml(good, batch_size=8, mesh=tmesh(4, 2))
        assert sm.has_verification and sm.verify() == []
        bad = parse_pmml(REG.format(y1="-3.5", y2="99.0"))
        sm_bad = compile_pmml(bad, batch_size=8, mesh=tmesh(4, 2))
        assert sm_bad.verify()  # mismatch reported, not swallowed

    def test_mesh_sharded_direct_on_compiled_model(self, wide_doc):
        # the two-step spelling (compile, then shard) is equivalent
        cm = compile_pmml(wide_doc, batch_size=32, device="cpu")
        sm = mesh_sharded(cm, tmesh(2, 4), wide_threshold=4096)
        _, recs = _records(wide_doc, 32, seed=9)
        _assert_preds_match(sm.score_records(recs), cm.score_records(recs))

    def test_categorical_wide_table_partials(self, tmp_path):
        # a wide table of categorical predictors: cat_codes / cat_coefs
        # split alike, one partial a slice
        n = 64
        fields = "".join(
            f'<DataField name="c{i}" optype="categorical" '
            f'dataType="string"><Value value="a"/><Value value="b"/>'
            f"</DataField>" for i in range(n))
        schema = "".join(f'<MiningField name="c{i}"/>' for i in range(n))
        preds = "".join(
            f'<CategoricalPredictor name="c{i}" value="{"ab"[i % 2]}" '
            f'coefficient="{0.01 * (i + 1):.2f}"/>' for i in range(n))
        xml = (
            '<PMML version="4.3"><DataDictionary>' + fields
            + '<DataField name="y" optype="continuous" dataType="double"/>'
            "</DataDictionary><RegressionModel functionName=\"regression\">"
            '<MiningSchema><MiningField name="y" usageType="target"/>'
            + schema + '</MiningSchema><RegressionTable intercept="0.5">'
            + preds + "</RegressionTable></RegressionModel></PMML>")
        from flink_jpmml_tpu.pmml import parse_pmml as jparse
        from flink_jpmml_tpu_torch.pmml import parse_pmml

        cfg = CompileConfig(tp_wide_threshold=64)
        sm = compile_pmml(parse_pmml(xml), batch_size=16, mesh=tmesh(2, 4),
                          config=cfg)
        jsm = jcompile(jparse(xml), batch_size=16, mesh=jmesh(2, 4),
                       config=JCompileConfig(tp_wide_threshold=64))
        assert sm.tp_sharded_leaves == jsm.tp_sharded_leaves
        assert {"['t0']['cat_codes']", "['t0']['cat_coefs']"} <= set(
            sm.tp_sharded_leaves)
        rng = np.random.default_rng(4)
        X = rng.integers(0, 2, size=(16, n)).astype(np.float32)
        M = rng.random(size=X.shape) < 0.1
        np.testing.assert_allclose(
            sm.predict(X, M).value.numpy(),
            np.asarray(jsm.predict(X, M).value), rtol=RTOL, atol=ATOL)

    def test_unsplittable_wide_leaf_is_refused(self, tmp_path):
        # a wide leaf whose consumer computes no per-slice partials in
        # the port raises and names the leaf — never replicated quietly
        from flink_jpmml_tpu_torch.assets_gen import gen_mlp

        doc = parse_pmml_file(gen_mlp(str(tmp_path)))
        with pytest.raises(NotPortedError, match=r"\['"):
            compile_pmml(doc, batch_size=8, mesh=tmesh(4, 2),
                         config=CompileConfig(tp_wide_threshold=2))
