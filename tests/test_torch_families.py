"""The dense model families of the PyTorch port against the JAX package,
on the CPU: RegressionModel, NeuralNetwork, ClusteringModel and
GeneralRegressionModel.

Each case runs the same seeded inputs through three scorers:

- the JAX package's ``compile_pmml(...).predict`` and the port's
  (``device="cpu"``): validity equal, values and per-class rows within the
  repo's bar (rtol 1e-4 / atol 1e-5), labels exactly equal on valid lanes;
- the JAX package's oracle, ``pmml/interp.evaluate``, against the port's
  ``score_records`` at the golden suite's tolerance (rtol 2e-4, or the
  case's own where its golden test sets one), decoded outputs included.

The cases are those of tests/test_compile_golden.py (TestRegressionGolden,
TestNeuralGolden, TestClusteringGolden, TestLinkFunctions,
TestNeuralActivations, TestMissingValueWeights, TestEntityOutputs) and of
tests/test_glm_bayes.py's GLM classes, with lanes of missing cells. The
whole generated fixture set goes through both packages, and each family's
JAX parameters carry across with ``convert.model_params_from_jax``.
"""

import math

import numpy as np
import pytest
import torch

from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.compile import prepare as jprepare
from flink_jpmml_tpu.pmml import parse_pmml as jparse
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse_file
from flink_jpmml_tpu.pmml.interp import evaluate
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.convert import model_params_from_jax
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse
from flink_jpmml_tpu_torch.pmml import parse_pmml_file as tparse_file
from test_compile_golden import MVW_KMEANS, _random_records
from test_glm_bayes import COX, GLM, MULTINOMIAL, ORDINAL

RTOL, ATOL = 1e-4, 1e-5  # port vs JAX package
GOLDEN = (2e-4, 1e-5)  # port vs oracle (tests/test_compile_golden.py)


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


def compile_both(xml=None, path=None, batch=None):
    """→ (JAX doc, JAX model, port model) for one document."""
    if path is not None:
        jdoc, tdoc = jparse_file(str(path)), tparse_file(str(path))
    else:
        jdoc, tdoc = jparse(xml), tparse(xml)
    return (jdoc, jcompile(jdoc, batch_size=batch),
            compile_pmml(tdoc, batch_size=batch, device="cpu"))


def assert_predict_match(jm, tm, X, M):
    """The port's predict against the JAX package's on (X, M)."""
    jo, to = jm.predict(X, M), tm.predict(X, M)
    valid = np.asarray(jo.valid)
    np.testing.assert_array_equal(to.valid.numpy(), valid)
    np.testing.assert_allclose(to.value.numpy()[valid],
                               np.asarray(jo.value)[valid],
                               rtol=RTOL, atol=ATOL, equal_nan=True)
    assert (to.label_idx is None) == (jo.label_idx is None)
    if jo.label_idx is not None:
        np.testing.assert_array_equal(to.label_idx.numpy()[valid],
                                      np.asarray(jo.label_idx)[valid])
    assert (to.probs is None) == (jo.probs is None)
    if jo.probs is not None:
        np.testing.assert_allclose(to.probs.numpy()[valid],
                                   np.asarray(jo.probs)[valid],
                                   rtol=RTOL, atol=ATOL, equal_nan=True)
    return to


def _close(got, want, tol):
    rtol, atol = tol
    if isinstance(want, float) and isinstance(got, (float, int)):
        return got == pytest.approx(want, rel=rtol, abs=atol)
    return got == want


def assert_oracle_match(tm, jdoc, records, tol=GOLDEN):
    """The port's ``score_records`` against the oracle, outputs included."""
    preds = tm.score_records(records)
    assert len(preds) == len(records)
    for rec, p in zip(records, preds):
        o = evaluate(jdoc, rec)
        nan = isinstance(o.value, float) and math.isnan(o.value)
        if o.is_missing or nan:  # a NaN score decodes to an empty lane
            assert p.is_empty, (rec, p)
            continue
        assert not p.is_empty, (rec, o)
        if o.value is not None:
            assert _close(p.score.value, float(o.value), tol), (rec, p, o)
        if o.label is not None:
            assert p.target is not None and p.target.label == o.label, rec
            for k, v in o.probabilities.items():
                assert _close(p.target.probabilities[k], float(v), tol), (
                    rec, k)
        for k, v in (o.outputs or {}).items():
            got = (p.outputs or {}).get(k)
            want = float(v) if isinstance(v, (int, float)) else v
            assert _close(got, want, tol), (rec, k, got, v)
    return preds


def assert_decode_match(jm, tm, records):
    """``score_records`` of both packages: the same empties, labels and
    outputs, and values within the bar."""
    for jp, tp in zip(jm.score_records(records), tm.score_records(records)):
        assert jp.is_empty == tp.is_empty
        if jp.is_empty:
            continue
        assert tp.score.value == pytest.approx(jp.score.value, rel=RTOL,
                                               abs=ATOL)
        assert (jp.target is None) == (tp.target is None)
        if jp.target is not None:
            assert tp.target.label == jp.target.label
        assert set(jp.outputs or {}) == set(tp.outputs or {})
        for k, v in (jp.outputs or {}).items():
            assert _close(tp.outputs[k], v, (RTOL, ATOL)), k


def check(xml=None, path=None, records=(), tol=GOLDEN, seed=0, n=96,
          missing=0.2):
    """One case: oracle and decode parity on ``records``; predict parity
    on those records and on seeded N(0, 1.5) rows with ``missing`` cells."""
    jdoc, jm, tm = compile_both(xml, path)
    records = list(records)
    if records:
        assert_oracle_match(tm, jdoc, records, tol)
        assert_decode_match(jm, tm, records)
        X, M = jprepare.from_records(jm.field_space, records)
        assert_predict_match(jm, tm, X, M)
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.5, size=(n, jm.field_space.arity)).astype(np.float32)
    M = rng.random(size=X.shape) < missing
    X[M] = 0.0
    assert_predict_match(jm, tm, X, M)
    return jdoc, jm, tm


# ---------------------------------------------------------------------------
# RegressionModel (TestRegressionGolden, TestLinkFunctions)
# ---------------------------------------------------------------------------

CATEGORICAL = (
    '<PMML version="4.3"><DataDictionary>'
    '<DataField name="color" optype="categorical" dataType="string">'
    '<Value value="red"/><Value value="blue"/></DataField>'
    '<DataField name="x" optype="continuous" dataType="double"/>'
    "</DataDictionary>"
    '<RegressionModel functionName="regression">'
    '<MiningSchema><MiningField name="color"/><MiningField name="x"/>'
    "</MiningSchema>"
    '<RegressionTable intercept="1.0">'
    '<NumericPredictor name="x" coefficient="2.0"/>'
    '<CategoricalPredictor name="color" value="red" coefficient="5.0"/>'
    "</RegressionTable></RegressionModel></PMML>"
)

EXPONENT = (
    '<PMML version="4.3"><DataDictionary>'
    '<DataField name="x" optype="continuous" dataType="double"/>'
    "</DataDictionary>"
    '<RegressionModel functionName="regression" '
    'normalizationMethod="exp">'
    '<MiningSchema><MiningField name="x"/></MiningSchema>'
    '<RegressionTable intercept="0.5">'
    '<NumericPredictor name="x" coefficient="1.5" exponent="3"/>'
    "</RegressionTable></RegressionModel></PMML>"
)

LINK = """<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3">
  <Header/>
  <DataDictionary numberOfFields="2">
    <DataField name="a" optype="continuous" dataType="double"/>
    <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <RegressionModel functionName="regression" normalizationMethod="{nm}">
    <MiningSchema>
      <MiningField name="y" usageType="target"/>
      <MiningField name="a"/>
    </MiningSchema>
    <RegressionTable intercept="0.1">
      <NumericPredictor name="a" coefficient="0.8"/>
    </RegressionTable>
  </RegressionModel></PMML>"""

CLASSIFIER = """<PMML version="4.3"><DataDictionary>
  <DataField name="a" optype="continuous" dataType="double"/>
  <DataField name="b" optype="continuous" dataType="double"/>
  <DataField name="y" optype="categorical" dataType="string">
    {values}</DataField>
  </DataDictionary>
  <RegressionModel functionName="classification" normalizationMethod="{nm}">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="a"/><MiningField name="b"/></MiningSchema>
  {tables}
  </RegressionModel></PMML>"""


def _classifier(nm, n_tables):
    names = ["p", "q", "r"][:n_tables]
    tables = "".join(
        f'<RegressionTable intercept="{0.3 * i - 0.2}" targetCategory="{c}">'
        f'<NumericPredictor name="a" coefficient="{0.7 - 0.5 * i}"/>'
        f'<NumericPredictor name="b" coefficient="{0.4 * i + 0.1}"/>'
        "</RegressionTable>"
        for i, c in enumerate(names)
    )
    values = "".join(f'<Value value="{c}"/>' for c in names)
    return CLASSIFIER.format(nm=nm, tables=tables, values=values)


class TestRegression:
    def test_iris_lr(self, assets_dir):
        doc = jparse_file(str(assets_dir / "iris_lr.pmml"))
        recs = _random_records(doc.active_fields, 64,
                               np.random.default_rng(1), loc=4.0)
        check(path=assets_dir / "iris_lr.pmml", records=recs)

    def test_iris_lr_with_missing(self, assets_dir):
        doc = jparse_file(str(assets_dir / "iris_lr.pmml"))
        recs = _random_records(doc.active_fields, 64,
                               np.random.default_rng(2), missing_rate=0.3)
        check(path=assets_dir / "iris_lr.pmml", records=recs, seed=2)

    def test_categorical_predictor_with_codec(self):
        recs = [{"color": "red", "x": 1.0}, {"color": "blue", "x": 1.0},
                {"color": None, "x": 1.0},
                {"color": "green", "x": 1.0}]  # undeclared category
        check(CATEGORICAL, records=recs)

    def test_exponent(self):
        check(EXPONENT, records=[{"x": 0.7}, {"x": -1.2}, {"x": 2.0}])

    @pytest.mark.parametrize("nm", ["cauchit", "cloglog", "loglog", "probit",
                                    "exp", "logit", "softmax", "none"])
    def test_regression_normalizations(self, nm):
        recs = [{"a": a} for a in (-2.0, -0.3, 0.0, 0.7, 2.5)] + [{"a": None}]
        check(LINK.format(nm=nm), records=recs, tol=(1e-5, 1e-6))

    @pytest.mark.parametrize("nm,n_tables", [
        ("softmax", 3), ("simplemax", 3), ("logit", 2), ("logit", 3),
        ("none", 3),
    ])
    def test_classification_normalizations(self, nm, n_tables):
        rng = np.random.default_rng(4)
        recs = _random_records(("a", "b"), 40, rng, missing_rate=0.2)
        check(_classifier(nm, n_tables), records=recs, seed=4)


# ---------------------------------------------------------------------------
# NeuralNetwork (TestNeuralGolden, TestNeuralActivations)
# ---------------------------------------------------------------------------

DENORM_NN = (
    '<PMML version="4.3"><DataDictionary>'
    '<DataField name="a" optype="continuous" dataType="double"/>'
    "</DataDictionary>"
    '<NeuralNetwork functionName="regression" '
    'activationFunction="tanh">'
    '<MiningSchema><MiningField name="a"/></MiningSchema>'
    '<NeuralInputs><NeuralInput id="i0">'
    '<DerivedField optype="continuous" dataType="double">'
    '<NormContinuous field="a">'
    '<LinearNorm orig="0" norm="0"/><LinearNorm orig="10" norm="1"/>'
    "</NormContinuous></DerivedField></NeuralInput></NeuralInputs>"
    '<NeuralLayer><Neuron id="h" bias="0.1">'
    '<Con from="i0" weight="1.3"/></Neuron></NeuralLayer>'
    '<NeuralLayer activationFunction="identity">'
    '<Neuron id="o" bias="0.0"><Con from="h" weight="2.0"/></Neuron>'
    "</NeuralLayer>"
    '<NeuralOutputs><NeuralOutput outputNeuron="o">'
    '<DerivedField optype="continuous" dataType="double">'
    '<NormContinuous field="t">'
    '<LinearNorm orig="100" norm="0"/><LinearNorm orig="200" norm="1"/>'
    "</NormContinuous></DerivedField></NeuralOutput></NeuralOutputs>"
    "</NeuralNetwork></PMML>"
)

ACT_NN = """<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3">
  <Header/>
  <DataDictionary numberOfFields="2">
    <DataField name="a" optype="continuous" dataType="double"/>
    <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <NeuralNetwork functionName="regression" activationFunction="{act}">
    <MiningSchema>
      <MiningField name="y" usageType="target"/>
      <MiningField name="a"/>
    </MiningSchema>
    <NeuralInputs>
      <NeuralInput id="in0">
        <DerivedField optype="continuous" dataType="double">
          <FieldRef field="a"/>
        </DerivedField>
      </NeuralInput>
    </NeuralInputs>
    <NeuralLayer>
      <Neuron id="h0" bias="0.2">
        <Con from="in0" weight="1.3"/>
      </Neuron>
    </NeuralLayer>
    <NeuralLayer activationFunction="identity">
      <Neuron id="out0" bias="-0.1">
        <Con from="h0" weight="0.9"/>
      </Neuron>
    </NeuralLayer>
    <NeuralOutputs>
      <NeuralOutput outputNeuron="out0">
        <DerivedField optype="continuous" dataType="double">
          <FieldRef field="y"/>
        </DerivedField>
      </NeuralOutput>
    </NeuralOutputs>
  </NeuralNetwork></PMML>"""

# a radial-basis hidden layer (per-neuron width / altitude), a threshold
# layer and a simplemax output, over NormContinuous / NormDiscrete inputs
RBF_NN = """<PMML version="4.3"><DataDictionary>
  <DataField name="a" optype="continuous" dataType="double"/>
  <DataField name="b" optype="continuous" dataType="double"/>
  <DataField name="c" optype="categorical" dataType="string">
    <Value value="u"/><Value value="v"/></DataField>
  <DataField name="y" optype="categorical" dataType="string">
    <Value value="k0"/><Value value="k1"/></DataField>
  </DataDictionary>
  <NeuralNetwork functionName="classification"
      activationFunction="radialBasis" width="1.5"
      normalizationMethod="simplemax">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="a"/><MiningField name="b"/><MiningField name="c"/>
  </MiningSchema>
  <NeuralInputs>
    <NeuralInput id="i0"><DerivedField optype="continuous" dataType="double">
      <NormContinuous field="a" outliers="asExtremeValues">
        <LinearNorm orig="-2" norm="0"/><LinearNorm orig="0" norm="0.4"/>
        <LinearNorm orig="2" norm="1"/></NormContinuous>
    </DerivedField></NeuralInput>
    <NeuralInput id="i1"><DerivedField optype="continuous" dataType="double">
      <FieldRef field="b"/></DerivedField></NeuralInput>
    <NeuralInput id="i2"><DerivedField optype="continuous" dataType="double">
      <NormDiscrete field="c" value="v"/></DerivedField></NeuralInput>
  </NeuralInputs>
  <NeuralLayer>
    <Neuron id="r0" bias="0"><Con from="i0" weight="0.3"/>
      <Con from="i1" weight="-0.5"/><Con from="i2" weight="1.0"/></Neuron>
    <Neuron id="r1" bias="0" width="0.8" altitude="1.3">
      <Con from="i0" weight="0.9"/><Con from="i1" weight="0.2"/></Neuron>
    <Neuron id="r2" bias="0" altitude="0.7">
      <Con from="i1" weight="1.1"/><Con from="i2" weight="0.0"/></Neuron>
  </NeuralLayer>
  <NeuralLayer activationFunction="logistic">
    <Neuron id="o0" bias="0.1"><Con from="r0" weight="1.2"/>
      <Con from="r1" weight="-0.7"/><Con from="r2" weight="0.5"/></Neuron>
    <Neuron id="o1" bias="-0.2"><Con from="r0" weight="-0.4"/>
      <Con from="r1" weight="0.8"/><Con from="r2" weight="0.6"/></Neuron>
  </NeuralLayer>
  <NeuralOutputs>
    <NeuralOutput outputNeuron="o0"><DerivedField optype="categorical"
      dataType="string"><NormDiscrete field="y" value="k0"/></DerivedField>
    </NeuralOutput>
    <NeuralOutput outputNeuron="o1"><DerivedField optype="categorical"
      dataType="string"><NormDiscrete field="y" value="k1"/></DerivedField>
    </NeuralOutput>
  </NeuralOutputs>
  </NeuralNetwork></PMML>"""


class TestNeural:
    def test_mlp(self, assets_dir):
        doc = jparse_file(str(assets_dir / "mlp_small.pmml"))
        recs = _random_records(doc.active_fields, 64,
                               np.random.default_rng(8), scale=1.0)
        check(path=assets_dir / "mlp_small.pmml", records=recs, seed=8,
              missing=0.05)

    def test_mlp_missing_input_is_empty(self, assets_dir):
        doc = jparse_file(str(assets_dir / "mlp_small.pmml"))
        recs = [{f: (None if f == "x3" else 0.5) for f in doc.active_fields}]
        check(path=assets_dir / "mlp_small.pmml", records=recs)

    def test_regression_nn_with_denorm(self):
        check(DENORM_NN, records=[{"a": v} for v in (-3.0, 0.0, 5.0, 12.0)])

    def test_radial_basis_threshold_simplemax(self):
        rng = np.random.default_rng(6)
        recs = [
            {"a": float(a), "b": float(b), "c": str(rng.choice(["u", "v"]))}
            for a, b in rng.normal(0, 1.5, size=(40, 2))
        ] + [{"a": 1.0, "b": None, "c": "u"}, {"a": 3.5, "b": 0.2, "c": "v"}]
        check(RBF_NN, records=recs, missing=0.0)
        thr = RBF_NN.replace('activationFunction="logistic"',
                             'activationFunction="threshold" threshold="0.1"')
        check(thr, records=recs, missing=0.0)

    @pytest.mark.parametrize("name,spec", [
        ("arctan", lambda z: 2.0 * math.atan(z) / math.pi),
        ("Elliott", lambda z: z / (1.0 + abs(z))),
        ("logistic", lambda z: 1.0 / (1.0 + math.exp(-z))),
        ("tanh", math.tanh),
        ("rectifier", lambda z: max(0.0, z)),
    ])
    def test_spec_defined_activation_values(self, name, spec):
        from flink_jpmml_tpu_torch.compile.neural import _ACTIVATIONS

        for z in (-3.0, -0.7, 0.0, 0.4, 2.2):
            got = float(_ACTIVATIONS[name](torch.tensor(z)))
            assert got == pytest.approx(spec(z), abs=5e-5), name

    @pytest.mark.parametrize("act", [
        "arctan", "cosine", "sine", "square", "Gauss", "reciprocal",
        "exponential", "Elliott", "elliott", "tanh", "logistic",
        "rectifier", "identity",
    ])
    def test_extended_activations(self, act):
        recs = [{"a": a} for a in (-1.5, -0.2, 0.4, 1.1)]
        check(ACT_NN.format(act=act), records=recs, tol=(0.0, 5e-5))


# ---------------------------------------------------------------------------
# ClusteringModel (TestClusteringGolden, TestMissingValueWeights,
# TestEntityOutputs)
# ---------------------------------------------------------------------------

NO_WEIGHTS = MVW_KMEANS.replace(
    "<MissingValueWeights><Array n=\"3\" type=\"real\">1 2 1"
    "</Array>\n  </MissingValueWeights>", ""
)
ZERO_WEIGHT = MVW_KMEANS.replace(
    '<Array n="3" type="real">1 2 1</Array>',
    '<Array n="3" type="real">0 2 0</Array>',
)
ENTITY = MVW_KMEANS.replace(
    "</MiningSchema>",
    "</MiningSchema>"
    '<Output><OutputField name="cluster" feature="entityId"/>'
    '<OutputField name="second" feature="entityId" rank="2"/>'
    '<OutputField name="dist" feature="affinity"/>'
    '<OutputField name="d2" feature="affinity" value="c2"/></Output>',
)
SIMILARITY = """<PMML version="4.3"><DataDictionary>
  <DataField name="a" optype="continuous" dataType="double"/>
  <DataField name="b" optype="continuous" dataType="double"/>
  <DataField name="c" optype="continuous" dataType="double"/>
  <DataField name="d" optype="continuous" dataType="double"/>
  </DataDictionary>
  <ClusteringModel functionName="clustering" modelClass="centerBased"
      numberOfClusters="3">
  <MiningSchema><MiningField name="a"/><MiningField name="b"/>
    <MiningField name="c"/><MiningField name="d"/></MiningSchema>
  <Output><OutputField name="best" feature="entityId"/>
    <OutputField name="s" feature="affinity"/></Output>
  <ComparisonMeasure kind="similarity"><{metric}/></ComparisonMeasure>
  <ClusteringField field="a"/><ClusteringField field="b" fieldWeight="2"/>
  <ClusteringField field="c"/><ClusteringField field="d"/>
  <Cluster id="s1"><Array n="4" type="real">1 0 1 0</Array></Cluster>
  <Cluster id="s2"><Array n="4" type="real">0 1 1 1</Array></Cluster>
  <Cluster id="s3"><Array n="4" type="real">1 1 0 0</Array></Cluster>
  </ClusteringModel></PMML>"""


def _metric(xml, tag):
    return xml.replace("<squaredEuclidean/>", tag)


class TestClustering:
    def test_kmeans(self, assets_dir):
        doc = jparse_file(str(assets_dir / "kmeans.pmml"))
        recs = _random_records(doc.active_fields, 128,
                               np.random.default_rng(9), scale=3.0)
        _, jm, tm = check(path=assets_dir / "kmeans.pmml", records=recs,
                          seed=9)
        # the winning distance matches the oracle's
        from flink_jpmml_tpu_torch.compile import prepare

        D = tm.predict(*prepare.from_records(tm.field_space, recs)).probs
        for i, rec in enumerate(recs):
            o = evaluate(doc, rec)
            assert float(D[i].min()) == pytest.approx(
                o.probabilities[o.label], rel=1e-4)

    def test_kmeans_missing(self, assets_dir):
        doc = jparse_file(str(assets_dir / "kmeans.pmml"))
        recs = _random_records(doc.active_fields, 32,
                               np.random.default_rng(10), missing_rate=0.2)
        check(path=assets_dir / "kmeans.pmml", records=recs, seed=10)

    @pytest.mark.parametrize("xml", [MVW_KMEANS, NO_WEIGHTS, ZERO_WEIGHT],
                             ids=["weights", "no_weights", "zero_weight"])
    def test_missing_value_weights(self, xml):
        recs = [
            {"a": 1.0, "b": None, "c": 2.0}, {"a": 3.0, "b": 3.0, "c": 3.0},
            {"a": None, "b": None, "c": None}, {"a": 1.0, "b": 0.0, "c": 2.0},
            {"a": None, "b": 4.5, "c": None},
        ]
        check(xml, records=recs, tol=(1e-6, 1e-6), missing=0.3)

    def test_adjusted_distance_hand_values(self):
        _, _, tm = compile_both(MVW_KMEANS)
        p = tm.score_records([{"a": 1.0, "b": None, "c": 2.0}])[0]
        # b missing: terms over (a, c); adjust = (1+2+1)/(1+1) = 2
        assert p.target.label == "c1"
        assert p.target.probabilities["c1"] == pytest.approx(10.0, rel=1e-6)
        assert p.target.probabilities["c2"] == pytest.approx(26.0, rel=1e-6)

    def test_entity_id_and_affinity_outputs(self):
        recs = [{"a": 1.0, "b": 0.5, "c": 0.5}, {"a": 3.0, "b": 2.5, "c": 5.0},
                {"a": None, "b": 1.0, "c": 1.0}]
        _, _, tm = check(ENTITY, records=recs, tol=(1e-6, 1e-6))
        p = tm.score_records(recs[:1])[0]
        assert p.outputs["cluster"] == "c1" and p.outputs["second"] == "c2"
        assert p.outputs["dist"] == pytest.approx(1.5, rel=1e-6)
        hand = (1 - 4) ** 2 + (0.5 - 4) ** 2 + (0.5 - 4) ** 2
        assert p.outputs["d2"] == pytest.approx(hand, rel=1e-6)

    @pytest.mark.parametrize("tag", [
        "<euclidean/>", "<cityBlock/>", "<chebychev/>",
        '<minkowski p-parameter="3"/>',
    ])
    def test_distance_metrics(self, tag):
        recs = _random_records(("a", "b", "c"), 24, np.random.default_rng(3),
                               missing_rate=0.2)
        check(_metric(NO_WEIGHTS, tag), records=recs)
        check(_metric(MVW_KMEANS, tag), records=recs)

    def test_compare_functions(self):
        xml = NO_WEIGHTS.replace(
            '<ComparisonMeasure kind="distance">',
            '<ComparisonMeasure kind="distance" compareFunction="absDiff">',
        ).replace(
            '<ClusteringField field="b"/>',
            '<ClusteringField field="b" compareFunction="gaussSim" '
            'similarityScale="1.5"/>',
        ).replace(
            '<ClusteringField field="c"/>',
            '<ClusteringField field="c" compareFunction="delta"/>',
        )
        recs = [{"a": a, "b": b, "c": c} for a in (0.0, 2.0)
                for b in (0.0, 1.0, 4.0) for c in (0.0, 4.0)]
        check(xml, records=recs)

    @pytest.mark.parametrize("metric", ["simpleMatching", "jaccard",
                                        "tanimoto"])
    def test_binary_similarity(self, metric):
        rng = np.random.default_rng(12)
        recs = [dict(zip("abcd", map(float, row)))
                for row in rng.integers(0, 2, size=(32, 4))]
        check(SIMILARITY.format(metric=metric), records=recs, missing=0.0)


# ---------------------------------------------------------------------------
# GeneralRegressionModel (tests/test_glm_bayes.py)
# ---------------------------------------------------------------------------


def _glm_records(n, seed):
    rng = np.random.default_rng(seed)
    return [{"x1": float(a), "x2": float(b),
             "color": str(rng.choice(["red", "blue"]))}
            for a, b in rng.normal(0, 1, size=(n, 2))]


GLM_TOL = (2e-3, 4e-6)  # TestGeneralRegression's own bar


class TestGeneralRegression:
    def test_general_linear(self):
        recs = _glm_records(150, 0) + [
            {"x2": 1.0, "color": "red"}, {"x1": 1.0, "x2": 1.0}]
        check(GLM.format(model_type="generalLinear", link_attr=""),
              records=recs, tol=GLM_TOL, missing=0.1)

    @pytest.mark.parametrize("link", ["log", "logit", "cloglog", "probit",
                                      "cauchit", "loglog", "identity"])
    def test_generalized_links(self, link):
        check(GLM.format(model_type="generalizedLinear",
                         link_attr=f'linkFunction="{link}"'),
              records=_glm_records(150, 0), tol=GLM_TOL, missing=0.1)

    def test_power_link(self):
        xml = GLM.format(model_type="generalizedLinear",
                         link_attr='linkFunction="power" linkParameter="3"')
        check(xml, records=_glm_records(60, 1), tol=GLM_TOL, missing=0.1)

    def test_missing_predictor_is_empty_lane(self):
        _, _, tm = check(GLM.format(model_type="generalLinear", link_attr=""),
                         records=[{"x1": 1.0, "x2": 1.0, "color": "red"},
                                  {"x2": 1.0, "color": "red"},
                                  {"x1": 1.0, "x2": 1.0}])
        preds = tm.score_records([{"x1": 1.0, "x2": 1.0, "color": "red"},
                                  {"x2": 1.0, "color": "red"},
                                  {"x1": 1.0, "x2": 1.0}])
        assert [p.is_empty for p in preds] == [False, True, True]

    def test_duplicate_pcells_sum(self):
        xml = GLM.format(model_type="generalLinear", link_attr="").replace(
            '<PCell parameterName="p1" beta="2.0"/>',
            '<PCell parameterName="p1" beta="2.0"/>'
            '<PCell parameterName="p1" beta="3.0"/>',
        )
        _, _, tm = check(xml, records=_glm_records(20, 3), tol=GLM_TOL)
        p = tm.score_records([{"x1": 1.0, "x2": 0.0, "color": "blue"}])[0]
        assert p.score.value == pytest.approx(5.5)

    def test_negative_base_fractional_exponent_empties_the_lane(self):
        xml = GLM.format(model_type="generalLinear", link_attr="").replace(
            '<PPCell value="2" predictorName="x2" parameterName="p2"/>',
            '<PPCell value="0.5" predictorName="x2" parameterName="p2"/>',
        )
        check(xml, records=[{"x1": 1.0, "x2": -2.0, "color": "blue"},
                            {"x1": 1.0, "x2": 2.0, "color": "blue"}])

    def test_multinomial_logistic(self):
        recs = [{"x": float(v)} for v in
                np.random.default_rng(1).normal(0, 2, size=100)] + [{}]
        _, _, tm = check(MULTINOMIAL, records=recs, tol=(1e-4, 1e-6))
        x = 1.0
        za, zb = 0.2 + 1.5 * x, -0.3 - 0.8 * x
        s = math.exp(za) + math.exp(zb) + 1.0
        p = tm.score_records([{"x": x}])[0]
        assert p.target.label == "a"
        assert p.target.probabilities["a"] == pytest.approx(math.exp(za) / s,
                                                            rel=1e-5)

    @pytest.mark.parametrize("clink", ["logit", "probit", "cloglog"])
    def test_ordinal_multinomial(self, clink):
        recs = [{"x1": x} for x in (-2.0, -0.5, 0.0, 0.7, 3.0, None)]
        check(ORDINAL.format(clink=clink), records=recs, tol=(0.0, 2e-5))

    def test_cox_survival(self):
        recs = [{"age": age, "t": t}
                for t in (0.5, 1.0, 2.9, 3.0, 6.0, 7.5, 10.0, 10.5, None)
                for age in (30.0, 55.0, None)]
        check(COX, records=recs, tol=(1e-5, 1e-7))


# ---------------------------------------------------------------------------
# the whole generated fixture set, and the weight carry-over
# ---------------------------------------------------------------------------

POSITIVE = ("iris_lr", "mlp_small", "kmeans", "stacked", "gbm_small")
NEGATIVE = ("malformed", "unsupported_version", "no_model")


@pytest.mark.parametrize("name", POSITIVE)
def test_every_fixture_compiles_and_matches(assets_dir, name):
    path = assets_dir / f"{name}.pmml"
    jdoc, jm, tm = compile_both(path=path, batch=64)
    assert tm.labels == jm.labels
    assert tm.quantized_scorer() is None or name == "gbm_small"
    recs = _random_records(jdoc.active_fields, 64,
                           np.random.default_rng(21), missing_rate=0.1)
    X, M = jprepare.from_records(jm.field_space, recs)
    assert_predict_match(jm, tm, X, M)
    assert_decode_match(jm, tm, recs)
    assert_oracle_match(tm, jdoc, recs)


@pytest.mark.parametrize("name", NEGATIVE)
def test_negative_fixtures_raise_like_the_jax_package(assets_dir, name):
    path = str(assets_dir / f"{name}.pmml")
    with pytest.raises(Exception) as jexc:
        jcompile(jparse_file(path))
    with pytest.raises(Exception) as texc:
        compile_pmml(tparse_file(path), device="cpu")
    assert type(texc.value).__name__ == type(jexc.value).__name__


def _wide_lr(tmp_path):
    from flink_jpmml_tpu_torch.assets_gen import gen_stacked

    return gen_stacked(str(tmp_path), n_trees=6, depth=3, n_features=40,
                       wide_lr=True, name="wide.pmml")


CARRY = {
    "regression": lambda a, t: a / "iris_lr.pmml",
    "neural": lambda a, t: a / "mlp_small.pmml",
    "clustering": lambda a, t: a / "kmeans.pmml",
    "chain": lambda a, t: _wide_lr(t),
}


@pytest.mark.parametrize("family", sorted(CARRY) + ["glm", "glm_cox"])
def test_jax_weights_carry_over(assets_dir, tmp_path, family):
    """JAX ``compile_pmml(doc).params`` → ``model_params_from_jax`` → the
    port's own parameters: the same keys, shapes and dtypes, and outputs
    bit for bit equal to the port's own."""
    import jax

    if family == "glm":
        jdoc, jm, tm = compile_both(GLM.format(
            model_type="generalizedLinear", link_attr='linkFunction="probit"'))
    elif family == "glm_cox":
        jdoc, jm, tm = compile_both(COX)
    else:
        jdoc, jm, tm = compile_both(path=CARRY[family](assets_dir, tmp_path))
    carried = model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), device="cpu")
    own = tm.params["model"]
    flat_c = jax.tree_util.tree_flatten_with_path(carried)[0]
    flat_o = jax.tree_util.tree_flatten_with_path(own)[0]
    assert [k for k, _ in flat_c] == [k for k, _ in flat_o]
    for (k, c), (_, o) in zip(flat_c, flat_o):
        assert c.dtype == o.dtype and c.shape == o.shape, k
        assert torch.equal(c, o), k
    rng = np.random.default_rng(5)
    X = rng.normal(0, 1.5, size=(64, tm.field_space.arity)).astype(np.float32)
    M = rng.random(size=X.shape) < 0.1
    X[M] = 0.0
    want = tm.predict(X, M)
    tm.params["model"] = carried
    got = tm.predict(X, M)
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
