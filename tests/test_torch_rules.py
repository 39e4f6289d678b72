"""The rule-shaped families and segment selection of the PyTorch port
against the JAX package, on the CPU: Scorecard (with reason codes and
ComplexPartialScore), RuleSetModel (firstHit, weightedSum, weightedMax),
AnomalyDetectionModel (iforest and a pass-through), and MiningModel
``selectFirst`` / ``selectAll`` (with the per-segment map).

Each case runs the same records through the JAX package's
``compile_pmml(doc).predict`` and ``score_records`` and the port's
(``device="cpu"``): validity equal, values within rtol 1e-4 / atol 1e-5,
labels, empty lanes, reason-code lists and ``selectAll`` segment maps
exactly equal; and through the JAX oracle (``pmml/interp.evaluate``). The
cases are those of tests/test_scorecard_ruleset.py, tests/test_anomaly.py
and tests/test_trees_extended.py ``TestSelectAll``, plus ``chip_smoke``'s
generators at small sizes. The JAX parameters of every new family carry
across with ``convert.model_params_from_jax``.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_anomaly as ja
import test_scorecard_ruleset as js
import test_trees_extended as je
from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.compile import prepare as jprepare
from flink_jpmml_tpu.compile.anomaly import iforest_c as jiforest_c
from flink_jpmml_tpu.pmml import parse_pmml as jparse
from flink_jpmml_tpu.pmml.interp import evaluate
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.compile.anomaly import iforest_c
from flink_jpmml_tpu_torch.convert import model_params_from_jax
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse
from flink_jpmml_tpu_torch.utils.exceptions import (
    ModelCompilationException,
    NotPortedError,
)
from chip_smoke import _close_outputs
from test_torch_families import assert_predict_match
from test_torch_tree_shapes import seeded_rows

RTOL, ATOL = 1e-4, 1e-5  # port vs JAX package


def compile_both(xml):
    return jparse(xml), jcompile(jparse(xml)), compile_pmml(tparse(xml),
                                                            device="cpu")


def assert_records_match(jdoc, jm, tm, records, oracle=True):
    jp, tp = jm.score_records(records), tm.score_records(records)
    for rec, a, b in zip(records, jp, tp):
        assert a.is_empty == b.is_empty, (rec, a, b)
        if oracle:
            assert evaluate(jdoc, rec).is_missing == b.is_empty, rec
        if b.is_empty:
            continue
        assert _close_outputs(b.score.value, a.score.value), (rec, a, b)
        assert (a.target is None) == (b.target is None)
        if a.target is not None:
            assert a.target.label == b.target.label, rec
        assert _close_outputs(b.outputs or {}, a.outputs or {}), (rec, a, b)
    X, M = jprepare.from_records(jm.field_space, records)
    assert_predict_match(jm, tm, X, M)
    return tp


def records_of(fields, X, M):
    return [{f: float(v) for f, v, m in zip(fields, row, mrow) if not m}
            for row, mrow in zip(X.tolist(), M.tolist())]


def check(xml, records=(), n=128, seed=0, oracle=True):
    jdoc, jm, tm = compile_both(xml)
    F = jm.field_space.arity
    X, M = seeded_rows(F, n, seed)
    assert_predict_match(jm, tm, X, M)
    recs = list(records) + records_of(jm.field_space.fields, X[:32], M[:32])
    return jdoc, jm, tm, assert_records_match(jdoc, jm, tm, recs, oracle)


# ---------------------------------------------------------------------------
# Scorecard (tests/test_scorecard_ruleset.py TestScorecard, ...)
# ---------------------------------------------------------------------------

SC_RECORDS = [{"age": 25.0, "income": 5000.0}, {"age": 45.0, "income": 500.0},
              {"income": 5000.0}, {"age": 30.0}, {"age": 20.0,
                                                  "income": 500.0}, {}]

RAGGED_SC = """<PMML version="4.3"><DataDictionary>
  <DataField name="x" optype="continuous" dataType="double"/>
  <DataField name="y" optype="continuous" dataType="double"/>
  <DataField name="score" optype="continuous" dataType="double"/>
  </DataDictionary>
  <Scorecard functionName="regression" initialScore="0"
      useReasonCodes="false">
  <MiningSchema><MiningField name="score" usageType="target"/>
    <MiningField name="x"/><MiningField name="y"/></MiningSchema>
  <Characteristics>
    <Characteristic name="wide">
      <Attribute partialScore="1">
        <SimplePredicate field="x" operator="lessThan" value="0"/></Attribute>
      <Attribute partialScore="2">
        <SimplePredicate field="x" operator="lessThan" value="5"/></Attribute>
      <Attribute partialScore="3"><True/></Attribute>
    </Characteristic>
    <Characteristic name="narrow">
      <Attribute partialScore="10">
        <SimplePredicate field="y" operator="greaterThan" value="0"/>
      </Attribute>
    </Characteristic>
  </Characteristics></Scorecard></PMML>"""


class TestScorecard:
    def test_reason_codes_and_scores(self):
        _, _, tm, preds = check(js.SCORECARD, SC_RECORDS)
        p = tm.score_records([{"age": 45.0, "income": 5000.0}])[0]
        assert (p.outputs["rc1"], p.outputs["rc2"]) == ("AGE", "INC")
        p = tm.score_records([{"age": 20.0, "income": 500.0}])[0]
        assert (p.outputs["rc1"], p.outputs["rc2"]) == ("INC", "AGE_YOUNG")
        assert p.score.value == pytest.approx(145.0)

    def test_ragged_characteristics_unmatched_is_empty(self):
        # a padded attribute slot must never match
        _, _, tm, _ = check(RAGGED_SC, [{"x": 1.0, "y": 1.0},
                                        {"x": 1.0, "y": -1.0},
                                        {"x": 9.0, "y": 2.0}])
        preds = tm.score_records([{"x": 1.0, "y": -1.0}, {"x": 9.0, "y": 2}])
        assert preds[0].is_empty and preds[1].score.value == 13.0

    @pytest.mark.parametrize("variant", ["complex", "mixed", "ln_fallback"])
    def test_complex_partial_scores(self, variant):
        xml = js.COMPLEX_SC
        if variant == "mixed":
            xml = xml.replace(
                "<Attribute>\n        <SimplePredicate",
                '<Attribute partialScore="99">\n        <SimplePredicate', 1,
            ).replace(
                "<ComplexPartialScore>\n          <Apply function=\"*\">"
                "<Constant>0.1</Constant>\n            <FieldRef field=\"bal\"/>"
                "</Apply>\n        </ComplexPartialScore>\n      </Attribute>",
                "</Attribute>", 1)
            assert 'partialScore="99"' in xml
        elif variant == "ln_fallback":
            xml = xml.replace('operator="greaterOrEqual" value="0"',
                              'operator="greaterOrEqual" value="1000"')
        recs = [{"bal": b} for b in (0.0, 120.0, 7.5, -5.0, 20.0, 3000.0)]
        check(xml, recs + [{}])

    def test_missing_reason_metadata_raises_when_asked_for(self):
        xml = js.SCORECARD.replace(' reasonCode="INC"', "")
        with pytest.raises(ModelCompilationException, match="reasonCode"):
            compile_pmml(tparse(xml), device="cpu")
        # without a reasonCode output the scorecard still compiles
        xml = xml.replace('<OutputField name="rc1" feature="reasonCode" '
                          'rank="1"/>', "").replace(
            '<OutputField name="rc2" feature="reasonCode" rank="2"/>', "")
        check(xml, SC_RECORDS)

    def test_chip_smoke_scorecard(self):
        _, _, tm, preds = check(cs.scorecard_xml(), n=256, seed=3)
        assert all(len([k for k in p.outputs if k.startswith("rc")]) == 3
                   for p in preds if not p.is_empty)


# ---------------------------------------------------------------------------
# RuleSetModel (TestRuleSet)
# ---------------------------------------------------------------------------


class TestRuleSet:
    @pytest.mark.parametrize("criterion", ["firstHit", "weightedSum",
                                           "weightedMax"])
    def test_criteria(self, criterion):
        recs = [{"a": 2.0, "b": 1.0}, {"a": -1.0, "b": 1.0}, {},
                {"a": 0.5}, {"b": -1.0}]
        check(js.RULESET.format(criterion=criterion), recs)

    def test_no_default_goes_empty(self):
        xml = js.RULESET.format(criterion="firstHit").replace(
            ' defaultScore="mid" defaultConfidence="0.3"', "")
        _, _, tm, _ = check(xml, [{}])
        assert tm.score_records([{}])[0].is_empty

    @pytest.mark.parametrize("criterion", ["firstHit", "weightedSum",
                                           "weightedMax"])
    def test_chip_smoke_ruleset(self, criterion):
        check(cs.ruleset_xml(criterion, n_rules=50, n_fields=12), n=256,
              seed=5)

    def test_unknown_criterion_raises(self):
        xml = js.RULESET.format(criterion="weightedMin")
        with pytest.raises(ModelCompilationException, match="weightedMin"):
            compile_pmml(tparse(xml), device="cpu")


# ---------------------------------------------------------------------------
# AnomalyDetectionModel (tests/test_anomaly.py)
# ---------------------------------------------------------------------------


class TestAnomaly:
    def test_iforest_c_matches(self):
        for n in (2, 3, 256, 10_000):
            assert iforest_c(n) == jiforest_c(n)

    @pytest.mark.parametrize("algo", [
        'algorithmType="iforest" sampleDataSize="256"',
        'algorithmType="other"',
    ], ids=["iforest", "other"])
    def test_fixture(self, algo):
        recs = [{"x": x} for x in (5.0, 0.0, 2.7, 3.0, 2.5)] + [{}]
        check(ja._iforest_xml(algo), recs)

    def test_hand_computed(self):
        _, _, tm = compile_both(ja._iforest_xml())
        p = tm.score_records([{"x": 5.0}])[0]
        assert p.score.value == pytest.approx(2.0 ** (-2.5 / iforest_c(256)),
                                              rel=1e-5)

    def test_chip_smoke_iforest(self):
        check(cs.iforest_xml(n_trees=8, n_fields=6, sample=64, max_depth=6),
              n=256, seed=7)


# ---------------------------------------------------------------------------
# selectFirst / selectAll (TestSelectAll)
# ---------------------------------------------------------------------------


class TestSelect:
    def test_select_all_per_segment_map(self):
        cases = {1.0: {"lo": 1.5, "hi": None}, 3.0: {"lo": 1.5, "hi": 7.25},
                 9.0: {"lo": None, "hi": 7.25}}
        _, _, tm, _ = check(je.SELECT_ALL, [{"x": x} for x in cases] + [{}])
        for x, segs in cases.items():
            p = tm.score_records([{"x": x}])[0]
            assert p.outputs["segments"] == segs
            assert p.score.value == next(v for v in segs.values() if v)

    def test_select_all_none_active_is_empty(self):
        bad = je.SELECT_ALL.replace('value="5"', 'value="-99"').replace(
            'value="2"', 'value="100"')
        _, _, tm, _ = check(bad, [{"x": 0.0}])
        assert tm.score_records([{"x": 0.0}])[0].is_empty

    def test_select_all_rejects_classification_segments(self):
        xml = je.SELECT_ALL.replace('<TreeModel functionName="regression">',
                                    '<TreeModel functionName="classification">')
        with pytest.raises(ModelCompilationException, match="regression"):
            compile_pmml(tparse(xml), device="cpu")

    def test_select_first_gbm_segments(self, tmp_path):
        xml = cs.select_first_xml(str(tmp_path), n_trees=5, depth=3,
                                  n_fields=6)
        _, jm, tm, preds = check(xml, [{}], n=256, seed=2)
        X, M = seeded_rows(6, 256, 2)
        # a missing f0 matches no segment; every other record scores
        np.testing.assert_array_equal(tm.predict(X, M).valid.numpy(),
                                      ~M[:, 0])

    def test_select_first_classification(self):
        # two majority-vote forests gated on one field, one label space
        tree = ('<TreeModel functionName="classification"><MiningSchema>'
                '<MiningField name="a"/></MiningSchema><Node id="0"><True/>'
                '<Node id="1" score="{p}"><SimplePredicate field="a" '
                'operator="lessThan" value="{v}"/></Node>'
                '<Node id="2" score="{q}"><True/></Node></Node></TreeModel>')
        xml = ('<PMML version="4.3"><DataDictionary>'
               '<DataField name="a" optype="continuous" dataType="double"/>'
               '<DataField name="y" optype="categorical" dataType="string">'
               '<Value value="u"/><Value value="w"/></DataField>'
               '</DataDictionary><MiningModel functionName="classification">'
               '<MiningSchema><MiningField name="y" usageType="target"/>'
               '<MiningField name="a"/></MiningSchema>'
               '<Segmentation multipleModelMethod="selectFirst">'
               '<Segment><SimplePredicate field="a" operator="lessThan" '
               'value="0"/>' + tree.format(p="u", q="w", v=-1) + "</Segment>"
               "<Segment><True/>" + tree.format(p="u", q="w", v=1)
               + "</Segment></Segmentation></MiningModel></PMML>")
        check(xml, [{"a": v} for v in (-2.0, -0.5, 0.5, 2.0)] + [{}])
        # segments whose label lists differ are refused, as in JAX
        bad = xml.replace('score="u"><SimplePredicate field="a" '
                          'operator="lessThan" value="1"',
                          'score="z"><SimplePredicate field="a" '
                          'operator="lessThan" value="1"')
        assert bad != xml
        with pytest.raises(ModelCompilationException, match="label space"):
            compile_pmml(tparse(bad), device="cpu")


# ---------------------------------------------------------------------------
# dispatch and parameters
# ---------------------------------------------------------------------------

NAIVE_BAYES = """<PMML version="4.3"><DataDictionary>
  <DataField name="x" optype="categorical" dataType="string">
    <Value value="a"/><Value value="b"/></DataField>
  <DataField name="y" optype="categorical" dataType="string">
    <Value value="p"/><Value value="q"/></DataField></DataDictionary>
  <NaiveBayesModel functionName="classification" threshold="0.001">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="x"/></MiningSchema>
  <BayesInputs><BayesInput fieldName="x">
    <PairCounts value="a"><TargetValueCounts>
      <TargetValueCount value="p" count="3"/>
      <TargetValueCount value="q" count="1"/></TargetValueCounts></PairCounts>
    <PairCounts value="b"><TargetValueCounts>
      <TargetValueCount value="p" count="1"/>
      <TargetValueCount value="q" count="3"/></TargetValueCounts></PairCounts>
  </BayesInput></BayesInputs>
  <BayesOutput fieldName="y"><TargetValueCounts>
    <TargetValueCount value="p" count="4"/>
    <TargetValueCount value="q" count="4"/></TargetValueCounts></BayesOutput>
  </NaiveBayesModel></PMML>"""


def test_families_still_to_port_raise_not_ported(monkeypatch):
    # (the name predates the last families' port) NaiveBayes now
    # compiles and scores as the JAX package does; an IR class without a
    # lowering still raises NotPortedError and names itself
    from flink_jpmml_tpu_torch.compile import compiler

    recs = [{"x": "a"}, {"x": "b"}, {}]
    _, jm, tm = compile_both(NAIVE_BAYES)
    for a, b in zip(jm.score_records(recs), tm.score_records(recs)):
        assert a.target.label == b.target.label
        assert b.target.probabilities == pytest.approx(
            a.target.probabilities, rel=RTOL, abs=ATOL)
    monkeypatch.setattr(compiler, "_LOWERERS", tuple(
        (c, f) for c, f in compiler._LOWERERS if c.__name__ != "NaiveBayesIR"))
    with pytest.raises(NotPortedError, match="NaiveBayesIR"):
        compile_pmml(tparse(NAIVE_BAYES), device="cpu")


def _carry_docs(tmp_path):
    return {
        "node_hop": je._deep_tree_xml(depth=14),
        "node_hop_halt": cs.deep_rf_xml(
            n_trees=3, n_fields=4, max_leaves=20, seed=2).replace(
            'missingValueStrategy="defaultChild"',
            'missingValueStrategy="lastPrediction"'),
        "gtrees": cs.general_forest_xml(n_trees=3, n_continuous=5,
                                        n_categorical=2, max_leaves=16,
                                        max_depth=6, seed=4),
        "wtrees": cs.WEIGHTED_CONF,
        "scorecard": js.SCORECARD,
        "scorecard_complex": js.COMPLEX_SC,
        "ruleset": js.RULESET.format(criterion="weightedSum"),
        "anomaly": ja._iforest_xml(),
        "select_first": cs.select_first_xml(str(tmp_path), n_trees=3,
                                            depth=3, n_fields=5),
        "select_all": je.SELECT_ALL,
    }


@pytest.mark.parametrize("family", ["node_hop", "node_hop_halt", "gtrees",
                                    "wtrees", "scorecard",
                                    "scorecard_complex", "ruleset", "anomaly",
                                    "select_first", "select_all"])
def test_jax_params_carry_over(tmp_path, family):
    """JAX ``compile_pmml(doc).params`` → ``model_params_from_jax`` → the
    port's own parameters: the same keys, shapes and dtypes (the node
    tables' int32 indices too), and outputs equal to the port's own."""
    xml = _carry_docs(tmp_path)[family]
    _, jm, tm = compile_both(xml)
    carried = model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), device="cpu")
    own = tm.params["model"]
    flat_c = jax.tree_util.tree_flatten_with_path(carried)[0]
    flat_o = jax.tree_util.tree_flatten_with_path(own)[0]
    assert [k for k, _ in flat_c] == [k for k, _ in flat_o]
    for (k, c), (_, o) in zip(flat_c, flat_o):
        assert c.dtype == o.dtype and c.shape == o.shape, k
        torch.testing.assert_close(c, o, rtol=0, atol=0, equal_nan=True)
    X, M = seeded_rows(tm.field_space.arity, 96, 5)
    if family == "gtrees":  # categorical columns hold declared codes
        X[:, -2:] = np.random.default_rng(5).integers(0, 8, size=(96, 2))
        X[M] = 0.0
    want = tm.predict(X, M)
    tm.params["model"] = carried
    got = tm.predict(X, M)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert want.valid.any()
