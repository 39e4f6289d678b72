"""Mesh-aware compile in the port (BASELINE config 5) against the JAX
package, on the CPU: the twin of tests/test_mesh_compile.py.

``compile_pmml(..., mesh=)`` must feature-shard the stacked model's wide
linear stage over the ``model`` axis inside the compiled scorer, pick the
same leaves as the JAX rule, and agree with the JAX sharded model, the
unsharded port and the oracle. Every leaf the rule picks is split, in
every family: the contracting consumers (NN, GLM, SVM, GP) take one
partial a slice, the selecting ones (KNN, text) gather the slices, and
each agrees with the JAX sharded model at a lowered threshold. The JAX side runs on the 8-device virtual
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


# -- every wide leaf the JAX rule picks, in six families ----------------------


def _rbf_nn_xml(n_inputs=8, n_rbf=8):
    """A radial-basis hidden layer over ``n_inputs`` continuous inputs
    (one width, per-neuron altitudes) and a logistic output layer: its
    centres ``W[n_inputs, n_rbf]`` split over the model axis."""
    rng = np.random.default_rng(17)
    dd = "".join(f'<DataField name="x{i}" optype="continuous" '
                 f'dataType="double"/>' for i in range(n_inputs))
    ms = "".join(f'<MiningField name="x{i}"/>' for i in range(n_inputs))
    ins = "".join(
        f'<NeuralInput id="i{i}"><DerivedField optype="continuous" '
        f'dataType="double"><FieldRef field="x{i}"/></DerivedField>'
        f"</NeuralInput>" for i in range(n_inputs))
    rbf = "".join(
        f'<Neuron id="r{j}" bias="0" altitude="{1 + 0.1 * j:.1f}">' + "".join(
            f'<Con from="i{i}" weight="{rng.normal():.4f}"/>'
            for i in range(n_inputs)) + "</Neuron>" for j in range(n_rbf))
    out = "".join(
        f'<Neuron id="o{c}" bias="{0.1 * c:.1f}">' + "".join(
            f'<Con from="r{j}" weight="{rng.normal():.4f}"/>'
            for j in range(n_rbf)) + "</Neuron>" for c in range(2))
    outs = "".join(
        f'<NeuralOutput outputNeuron="o{c}"><DerivedField '
        f'optype="categorical" dataType="string"><NormDiscrete field="y" '
        f'value="k{c}"/></DerivedField></NeuralOutput>' for c in range(2))
    return (
        '<PMML version="4.3"><DataDictionary>' + dd
        + '<DataField name="y" optype="categorical" dataType="string">'
        '<Value value="k0"/><Value value="k1"/></DataField></DataDictionary>'
        '<NeuralNetwork functionName="classification" '
        'activationFunction="radialBasis" width="2.5" '
        'normalizationMethod="softmax"><MiningSchema>'
        '<MiningField name="y" usageType="target"/>' + ms
        + "</MiningSchema><NeuralInputs>" + ins + "</NeuralInputs>"
        "<NeuralLayer>" + rbf + "</NeuralLayer>"
        '<NeuralLayer activationFunction="logistic">' + out
        + "</NeuralLayer><NeuralOutputs>" + outs
        + "</NeuralOutputs></NeuralNetwork></PMML>")


def _tp_case_xml(case, tmp_path):
    import chip_smoke as cs

    if case == "mlp":
        from flink_jpmml_tpu_torch.assets_gen import gen_mlp

        with open(gen_mlp(str(tmp_path), n_inputs=16, hidden=(8,),
                          n_classes=3)) as f:
            return f.read()
    return {
        "rbf_nn": lambda: _rbf_nn_xml(),
        "glm": lambda: cs.glm_probit_xml(n_fields=13),
        "svm": lambda: cs.svm_xml(n_classes=3, n_vectors=64, n_fields=6),
        "svm_poly": lambda: cs.svm_xml("poly", n_vectors=64, n_fields=6),
        "gp": lambda: cs.gp_xml("ard", n_rows=64, n_fields=4),
        "gp_absexp": lambda: cs.gp_xml("absexp", n_rows=64, n_fields=4),
        "knn": lambda: cs.knn_xml(n_instances=64, n_fields=4),
        "knn_median": lambda: cs.knn_xml(n_instances=64, n_fields=4, k=4,
                                         scoring="median"),
        "text": lambda: cs.text_xml(n_terms=16, n_docs=32),
    }[case]()


# (case, lowered threshold, leaves that must be among those picked)
TP_CASES = [
    ("mlp", 8, {"['l0']['W']", "['l0']['b']", "['l1']['W']"}),
    ("rbf_nn", 8, {"['l0']['W']", "['l0']['b']"}),
    ("glm", 16, {"['beta']"}),
    ("svm", 64, {"['S']", "['A']"}),
    ("svm_poly", 64, {"['S']", "['A']"}),
    ("gp", 64, {"['alpha']", "['Zs']", "['Zs_sq']"}),
    ("gp_absexp", 4, {"['alpha']", "['Ztr']", "['inv_lam']"}),
    ("knn", 64, {"['S']", "['lab']"}),
    ("knn_median", 64, {"['S']", "['y']"}),
    ("text", 16, {"['W']", "['Wsq']", "['Wnorm']", "['idf']"}),
]


def _tp_rows(tm, n, seed, case):
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.5, size=(n, tm.field_space.arity))
    if case == "text":
        X = rng.poisson(1.0, size=X.shape)  # term counts
    M = rng.random(size=X.shape) < 0.05
    X = np.where(M, 0.0, X).astype(np.float32)
    return X, M


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
@pytest.mark.parametrize("case,threshold,picked", TP_CASES,
                         ids=[c for c, _, _ in TP_CASES])
def test_every_wide_leaf_is_split_like_the_jax_model(case, threshold,
                                                     picked, shape,
                                                     tmp_path):
    """The port picks the JAX rule's leaves, stores each one split, and
    scores like the JAX sharded model (values at rtol 1e-4 / atol 1e-5,
    labels and neighbour ids equal)."""
    from flink_jpmml_tpu.pmml import parse_pmml as jparse
    from flink_jpmml_tpu_torch.parallel.sharding import _leaves
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    xml = _tp_case_xml(case, tmp_path)
    sm = compile_pmml(parse_pmml(xml), batch_size=16, mesh=tmesh(*shape),
                      config=CompileConfig(tp_wide_threshold=threshold))
    jsm = jcompile(jparse(xml), batch_size=16, mesh=jmesh(*shape),
                   config=JCompileConfig(tp_wide_threshold=threshold))
    assert sm.tp_sharded_leaves == jsm.tp_sharded_leaves
    assert picked <= set(sm.tp_sharded_leaves)
    split = {"".join(f"['{k}']" for k in path)
             for path, _, _, leaf in _leaves(sm.params["model"])
             if isinstance(leaf, TpLeaf)}
    assert split == set(sm.tp_sharded_leaves)  # none replicated quietly
    X, M = _tp_rows(sm, 16, 5, case)
    got, want = sm.predict(X, M), jsm.predict(X, M)
    valid = np.asarray(want.valid)
    assert np.array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.value.numpy()[valid],
                               np.asarray(want.value)[valid],
                               rtol=RTOL, atol=ATOL)
    if want.probs is not None:
        gp, wp = got.probs.numpy()[valid], np.asarray(want.probs)[valid]
    if want.label_idx is not None:
        gl = got.label_idx.numpy()[valid]
        wl = np.asarray(want.label_idx)[valid]
        # labels equal, but where two candidates tie exactly the JAX
        # sharded model's partitioned sum may put the later one an ulp
        # ahead: there the port's pick must score as the JAX winner does
        # in the JAX model's own output
        off = np.flatnonzero(gl != wl)
        assert len(off) <= 1, off
        for r in off:
            np.testing.assert_allclose(wp[r, gl[r]], wp[r, wl[r]],
                                       rtol=RTOL, atol=0)
    if want.probs is not None:
        if case == "knn":  # class rows, then the ranked neighbour ids
            L = len(jsm.labels)
            assert np.array_equal(gp[:, L:], wp[:, L:])
            gp, wp = gp[:, :L], wp[:, :L]
        elif case == "knn_median":
            assert np.array_equal(gp, wp)
        np.testing.assert_allclose(gp, wp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["mlp", "svm", "knn"])
def test_one_by_one_mesh_splits_nothing(case, tmp_path):
    """At model width 1 the rule picks nothing: the 1×1 mesh runs the
    base's function on the base's params, the same bytes."""
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    xml = _tp_case_xml(case, tmp_path)
    cfg = CompileConfig(tp_wide_threshold=2)
    sm = compile_pmml(parse_pmml(xml), batch_size=16, config=cfg,
                      mesh=make_mesh(MeshConfig(data=1, model=1),
                                     devices=cpu_devices(1)))
    base = compile_pmml(parse_pmml(xml), batch_size=16, device="cpu",
                        config=cfg)
    assert sm.tp_sharded_leaves == () and not sm._gathered
    X, M = _tp_rows(sm, 16, 6, case)
    got, want = sm.predict(X, M), base.predict(X, M)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.numpy().tobytes() == w.numpy().tobytes()
