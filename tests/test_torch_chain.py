"""The port's stacking and transformation planes against the JAX package,
on the CPU: expressions (``compile/exprs.py``) as TransformationDictionary
derived fields, the top-level ``<Output>`` (``pmml/outputs.py``), and
MiningModel ``modelChain`` (BASELINE config 5, ``stacked``), with the
harness of tests/test_torch_families.py: the JAX package's ``predict`` and
the port's on the same seeded inputs (rtol 1e-4 / atol 1e-5, labels
exact), and the port's ``score_records`` against the JAX oracle
(``pmml/interp.evaluate``) at the golden suite's tolerance. Also: the
port's ``assets_gen`` writes the JAX generator's bytes."""

import filecmp
import os

import numpy as np
import pytest

from flink_jpmml_tpu.compile import prepare as jprepare
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse_file
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException
from test_compile_golden import _random_records
from test_torch_families import (
    assert_decode_match,
    assert_predict_match,
    check,
    compile_both,
)
from test_transformations import _TREE_XML, _XML, DEFINE_FN, LOCAL_TX

FN_XML = """<PMML xmlns="http://www.dmg.org/PMML-4_4" version="4.4">
  <Header/>
  <DataDictionary numberOfFields="3">
    <DataField name="a" optype="continuous" dataType="double"/>
    <DataField name="b" optype="continuous" dataType="double"/>
    <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <TransformationDictionary>
    <DerivedField name="d" optype="continuous" dataType="double">
      {expr}
    </DerivedField>
  </TransformationDictionary>
  <RegressionModel functionName="regression">
    <MiningSchema>
      <MiningField name="y" usageType="target"/>
      <MiningField name="a"/>
      <MiningField name="b"/>
    </MiningSchema>
    <RegressionTable intercept="0.0">
      <NumericPredictor name="d" coefficient="1.0"/>
    </RegressionTable>
  </RegressionModel>
</PMML>"""

A = '<FieldRef field="a"/>'
AB = '<FieldRef field="a"/><FieldRef field="b"/>'


def apply(fn, args, extra=""):
    return FN_XML.format(expr=f'<Apply function="{fn}"{extra}>{args}</Apply>')


UNARY_RECS = [{"a": v, "b": 0.0} for v in
              (-2.5, -1.5, -1.0, -0.5, 0.0, 0.3, 0.5, 1.0, 1.5, 2.5)]
BINARY_RECS = [{"a": a, "b": b} for a in (-2.0, -0.5, 0.0, 1.0, 3.0, None)
               for b in (-1.5, 0.0, 0.5, 2.0, None)]
TOL = (2e-4, 2e-5)  # TestBuiltinFunctionLibrary's bar


# ---------------------------------------------------------------------------
# expressions, as derived fields (tests/test_transformations.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", [
    "round", "rint", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
    "tanh", "stdNormalCDF", "stdNormalPDF", "not", "exp", "abs", "floor",
    "ceil", "sqrt", "ln", "isMissing", "isNotMissing",
])
def test_unary_functions(fn):
    check(apply(fn, A), records=UNARY_RECS + [{"a": None, "b": 0.0}],
          tol=TOL)


@pytest.mark.parametrize("fn", ["asin", "acos", "log10", "ln1p",
                                "stdNormalIDF"])
def test_domain_errors_empty_the_lane(fn):
    recs = [{"a": v, "b": 0.0} for v in (-2.0, -1.0, 0.0, 1e-6, 0.5, 2.0)]
    check(apply(fn, A), records=recs, tol=(2e-4, 1e-3))


@pytest.mark.parametrize("fn", [
    "+", "-", "*", "/", "min", "max", "threshold", "equal",
    "notEqual", "lessThan", "lessOrEqual", "greaterThan", "greaterOrEqual",
    "and", "or", "modulo", "atan2", "hypot", "if",
])
def test_binary_functions(fn):
    check(apply(fn, AB), records=BINARY_RECS, tol=TOL)


def test_pow_of_a_negative_base():
    # in both packages a negative base to a fractional power is NaN (an
    # empty lane) and 0 to a negative power is inf; the JAX oracle's
    # python ** returns a complex number (and raises) on the first and
    # an empty lane on the second, so it is held to the other lanes
    def oracle_defined(r):
        a, b = r["a"], r["b"]
        if a is None or b is None:
            return True
        return b >= 0 if a == 0 else (a > 0 or float(b).is_integer())

    xml = apply("pow", AB)
    real = [r for r in BINARY_RECS if oracle_defined(r)]
    assert len(real) < len(BINARY_RECS)
    check(xml, records=real, tol=TOL)
    _, jm, tm = compile_both(xml)
    assert_decode_match(jm, tm, BINARY_RECS)
    assert_predict_match(jm, tm, *jprepare.from_records(jm.field_space,
                                                        BINARY_RECS))


def test_if_with_else_and_map_missing_to():
    args = ('<Apply function="greaterThan"><FieldRef field="a"/>'
            '<Constant>0</Constant></Apply>' + AB)
    check(apply("if", args), records=BINARY_RECS, tol=TOL)
    # mapMissingTo over a domain error (x / 0): the JAX package's compiled
    # path maps the lane to the constant, its oracle leaves it empty; the
    # port follows the compiled path
    _, jm, tm = compile_both(apply("/", AB, ' mapMissingTo="7"'))
    assert_decode_match(jm, tm, BINARY_RECS)
    assert_predict_match(jm, tm, *jprepare.from_records(jm.field_space,
                                                        BINARY_RECS))
    p = tm.score_records([{"a": -2.0, "b": 0.0}, {"a": None, "b": 1.0}])
    assert [q.score.value for q in p] == [7.0, 7.0]


def test_modulo_sign_follows_divisor_and_rounding():
    _, _, tm = compile_both(apply("modulo", AB))
    recs = [{"a": 7.0, "b": 3.0}, {"a": -7.0, "b": 3.0},
            {"a": 7.0, "b": -3.0}, {"a": -7.0, "b": -3.0},
            {"a": 1.0, "b": 0.0}]
    got = [None if p.is_empty else p.score.value
           for p in tm.score_records(recs)]
    assert got == [1.0, 2.0, -2.0, -1.0, None]
    _, _, tm = compile_both(apply("round", A))
    assert [p.score.value for p in tm.score_records(
        [{"a": 0.5}, {"a": 1.5}, {"a": -0.5}])] == [1.0, 2.0, 0.0]
    _, _, tm = compile_both(apply("rint", A))
    assert [p.score.value for p in tm.score_records(
        [{"a": 0.5}, {"a": 1.5}, {"a": 2.5}])] == [0.0, 2.0, 2.0]


@pytest.mark.parametrize("fn", ["and", "or"])
def test_kleene_dominators_beat_missing(fn):
    vals = (None, 0.0, 1.0)
    recs = [{"a": a, "b": b} for a in vals for b in vals]
    _, _, tm = check(apply(fn, AB), records=recs, tol=(0, 0))
    dom = 0.0 if fn == "and" else 1.0
    p = tm.score_records([{"a": dom, "b": None}])[0]
    assert not p.is_empty and p.score.value == dom
    # mapMissingTo fills only the lanes the dominator left undecided
    check(apply(fn, AB, ' mapMissingTo="5"'), records=recs, tol=(0, 0))


def test_kleene_boolean_chain():
    args = ('<Apply function="and"><Apply function="greaterThan">'
            '<FieldRef field="a"/><Constant>0</Constant></Apply>'
            '<Apply function="lessThan"><FieldRef field="b"/>'
            '<Constant>1</Constant></Apply></Apply>'
            '<Apply function="isMissing"><FieldRef field="a"/></Apply>')
    vals = (None, -1.0, 0.5, 2.0)
    check(apply("or", args),
          records=[{"a": a, "b": b} for a in vals for b in vals], tol=(0, 0))


@pytest.mark.parametrize("outliers", ["asIs", "asExtremeValues",
                                      "asMissingValues"])
@pytest.mark.parametrize("points", [2, 4])
def test_norm_continuous(outliers, points):
    norms = [(-2, 0), (2, 1)] if points == 2 else [
        (-2, 0), (-0.5, 0.1), (0.5, 0.8), (2, 1)]
    expr = (f'<NormContinuous field="a" outliers="{outliers}" '
            'mapMissingTo="-3">' + "".join(
                f'<LinearNorm orig="{o}" norm="{n}"/>' for o, n in norms)
            + "</NormContinuous>")
    recs = [{"a": v, "b": 0.0} for v in
            (-3.0, -2.0, -1.0, -0.5, 0.0, 0.7, 2.0, 3.5, None)]
    check(FN_XML.format(expr=expr), records=recs, tol=(1e-5, 1e-6))


def test_norm_discrete_constant_and_field_ref():
    xml = FN_XML.format(expr=(
        '<Apply function="+"><NormDiscrete field="a" value="1" '
        'mapMissingTo="0.5"/><Apply function="*"><Constant>2.5</Constant>'
        '<FieldRef field="b"/></Apply></Apply>'))
    recs = [{"a": a, "b": b} for a in (0.0, 1.0, None) for b in (0.5, None)]
    check(xml, records=recs, tol=(1e-6, 1e-6), missing=0.3)


@pytest.mark.parametrize("xml", [_XML, _TREE_XML, DEFINE_FN, LOCAL_TX],
                         ids=["chained", "tree", "define_function",
                              "local_transformations"])
def test_derived_field_documents(xml):
    jdoc, jm, tm = compile_both(xml)
    assert tm.active_fields == jm.active_fields
    rng = np.random.default_rng(0)
    recs = _random_records(jdoc.active_fields, 64, rng, missing_rate=0.2)
    check(xml, records=recs, tol=(1e-5, 1e-6))


def test_derived_field_shadowing_raises():
    xml = _XML.replace('<DerivedField name="ab_sum"',
                       '<DerivedField name="b"')
    with pytest.raises(ModelCompilationException, match="shadows"):
        compile_pmml(tparse(xml), device="cpu")


# ---------------------------------------------------------------------------
# top-level <Output> (pmml/outputs.py)
# ---------------------------------------------------------------------------

OUTPUTS = """
  <Output>
    <OutputField name="label" feature="predictedValue"/>
    <OutputField name="p_setosa" feature="probability" value="setosa"/>
    <OutputField name="p_win" feature="probability"/>
    <OutputField name="odds" feature="transformedValue">
      <Apply function="/"><FieldRef field="p_win"/>
        <Apply function="-"><Constant>1</Constant>
          <FieldRef field="p_win"/></Apply></Apply>
    </OutputField>
    <OutputField name="norm_odds" feature="transformedValue">
      <NormContinuous field="odds"><LinearNorm orig="0" norm="0"/>
        <LinearNorm orig="4" norm="1"/></NormContinuous>
    </OutputField>
  </Output>"""


def _with_outputs(path, outputs=OUTPUTS):
    with open(path) as f:
        xml = f.read()
    return xml.replace("</MiningSchema>", "</MiningSchema>" + outputs, 1)


def test_classification_outputs(assets_dir):
    xml = _with_outputs(assets_dir / "iris_lr.pmml")
    recs = _random_records(("sepal_length", "sepal_width", "petal_length",
                            "petal_width"), 48, np.random.default_rng(3),
                           loc=4.0, missing_rate=0.1)
    _, _, tm = check(xml, records=recs)
    p = next(p for p in tm.score_records(recs) if not p.is_empty)
    assert p.outputs["label"] == p.target.label
    assert p.outputs["p_win"] == p.target.probabilities[p.target.label]


def test_regression_outputs_and_targets(assets_dir):
    outputs = """<Output>
      <OutputField name="v" feature="predictedValue"/>
      <OutputField name="v2" feature="transformedValue">
        <Apply function="*"><FieldRef field="v"/><Constant>2</Constant>
        </Apply></OutputField>
      <OutputField name="none" feature="probability" value="x"/>
      <OutputField name="entity" feature="entityId"/>
      <OutputField name="aff" feature="affinity"/>
    </Output>"""
    xml = _with_outputs(assets_dir / "gbm_small.pmml", outputs)
    recs = _random_records([f"f{i}" for i in range(8)], 32,
                           np.random.default_rng(4), missing_rate=0.1)
    _, _, tm = check(xml, records=recs)
    assert tm.quantized_scorer() is None  # <Output> keeps the f32 path
    p = tm.score_records(recs[:1])[0]
    assert p.outputs["v2"] == pytest.approx(2 * p.outputs["v"])
    assert p.outputs["none"] is None and p.outputs["entity"] is None


@pytest.mark.parametrize("bad", [
    '<OutputField name="t" feature="transformedValue">'
    '<FieldRef field="sepal_length"/></OutputField>',
    '<OutputField name="t" feature="standardError"/>',
    '<OutputField name="t" feature="affinity" rank="2"/>',
])
def test_output_validation_like_the_jax_package(assets_dir, bad):
    from flink_jpmml_tpu.compile import compile_pmml as jcompile
    from flink_jpmml_tpu.pmml import parse_pmml as jparse

    xml = _with_outputs(assets_dir / "iris_lr.pmml", f"<Output>{bad}</Output>")
    with pytest.raises(Exception) as jexc:
        jcompile(jparse(xml))
    with pytest.raises(ModelCompilationException) as texc:
        compile_pmml(tparse(xml), device="cpu")
    assert type(texc.value).__name__ == type(jexc.value).__name__


# ---------------------------------------------------------------------------
# modelChain (TestChainGolden)
# ---------------------------------------------------------------------------


def test_stacked(assets_dir):
    doc = jparse_file(str(assets_dir / "stacked.pmml"))
    recs = _random_records(doc.active_fields, 128, np.random.default_rng(11))
    check(path=assets_dir / "stacked.pmml", records=recs, seed=11)


def test_stacked_with_missing(assets_dir):
    doc = jparse_file(str(assets_dir / "stacked.pmml"))
    recs = _random_records(doc.active_fields, 64, np.random.default_rng(12),
                           missing_rate=0.2)
    check(path=assets_dir / "stacked.pmml", records=recs, seed=12)


def test_stacked_wide_lr(tmp_path):
    from flink_jpmml_tpu_torch.assets_gen import gen_stacked

    path = gen_stacked(str(tmp_path), n_trees=6, depth=3, n_features=300,
                       wide_lr=True, name="wide.pmml")
    doc = jparse_file(path)
    recs = _random_records(doc.active_fields, 32, np.random.default_rng(13),
                           missing_rate=0.1)
    check(path=path, records=recs, seed=13, missing=0.05)


# a classification stage exporting its label (as a code) and a class
# probability, a middle stage guarded by a predicate on that label, and a
# final regression over all of them
CLS_CHAIN = """<PMML version="4.3"><DataDictionary>
  <DataField name="a" optype="continuous" dataType="double"/>
  <DataField name="b" optype="continuous" dataType="double"/>
  <DataField name="k" optype="categorical" dataType="string">
    <Value value="lo"/><Value value="hi"/></DataField>
  <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <MiningModel functionName="regression">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="a"/><MiningField name="b"/></MiningSchema>
  <Segmentation multipleModelMethod="modelChain">
    <Segment id="cls"><True/>
      <RegressionModel functionName="classification"
          normalizationMethod="softmax">
        <MiningSchema><MiningField name="k" usageType="target"/>
          <MiningField name="a"/><MiningField name="b"/></MiningSchema>
        <Output><OutputField name="klabel" feature="predictedValue"/>
          <OutputField name="p_hi" feature="probability" value="hi"/>
        </Output>
        <RegressionTable intercept="0.2" targetCategory="lo">
          <NumericPredictor name="a" coefficient="-0.9"/></RegressionTable>
        <RegressionTable intercept="-0.1" targetCategory="hi">
          <NumericPredictor name="a" coefficient="0.8"/>
          <NumericPredictor name="b" coefficient="0.3"/></RegressionTable>
      </RegressionModel></Segment>
    <Segment id="mid">
      <SimplePredicate field="klabel" operator="equal" value="hi"/>
      <RegressionModel functionName="regression">
        <MiningSchema><MiningField name="b"/></MiningSchema>
        <Output><OutputField name="m" feature="predictedValue"/></Output>
        <RegressionTable intercept="1.0">
          <NumericPredictor name="b" coefficient="2.0"/></RegressionTable>
      </RegressionModel></Segment>
    <Segment id="final"><True/>
      <RegressionModel functionName="regression"
          normalizationMethod="logit">
        <MiningSchema><MiningField name="p_hi"/><MiningField name="a"/>
        </MiningSchema>
        <RegressionTable intercept="-0.3">
          <NumericPredictor name="p_hi" coefficient="1.7"/>
          <NumericPredictor name="a" coefficient="0.4"/></RegressionTable>
      </RegressionModel></Segment>
  </Segmentation></MiningModel></PMML>"""


def test_classification_chain_with_segment_predicates():
    recs = _random_records(("a", "b"), 64, np.random.default_rng(14),
                           missing_rate=0.15)
    check(CLS_CHAIN, records=recs, seed=14)
    # a stage whose predicate is false does not poison the chain; an
    # active stage's missing result does
    final_uses_m = CLS_CHAIN.replace(
        '<MiningField name="p_hi"/><MiningField name="a"/>',
        '<MiningField name="p_hi"/><MiningField name="m"/>',
    ).replace('<NumericPredictor name="a" coefficient="0.4"/></Regression',
              '<NumericPredictor name="m" coefficient="0.4"/></Regression')
    check(final_uses_m, records=recs, seed=14)


def test_chain_refusals_like_the_jax_package():
    with pytest.raises(ModelCompilationException, match="final segment"):
        compile_pmml(tparse(CLS_CHAIN.replace(
            '<Segment id="final"><True/>',
            '<Segment id="final"><SimplePredicate field="a" '
            'operator="greaterThan" value="0"/>')), device="cpu")
    with pytest.raises(ModelCompilationException, match="shadows"):
        compile_pmml(tparse(CLS_CHAIN.replace(
            'name="m" feature="predictedValue"',
            'name="a" feature="predictedValue"')), device="cpu")


# ---------------------------------------------------------------------------
# the generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["generate_all", "stacked_wide_lr",
                                  "mlp_two_hidden", "kmeans_k7",
                                  "iris_seed3"])
def test_assets_gen_writes_the_jax_generators_bytes(tmp_path, case):
    from flink_jpmml_tpu import assets_gen as J
    from flink_jpmml_tpu_torch import assets_gen as T

    calls = {
        "generate_all": lambda g, d: g.generate_all(d),
        "stacked_wide_lr": lambda g, d: g.gen_stacked(
            d, n_trees=5, depth=3, n_features=120, wide_lr=True, seed=4),
        "mlp_two_hidden": lambda g, d: g.gen_mlp(
            d, n_inputs=12, hidden=(9, 5), n_classes=4, seed=2),
        "kmeans_k7": lambda g, d: g.gen_kmeans(d, k=7, n_features=6, seed=3),
        "iris_seed3": lambda g, d: g.gen_iris_lr(d, seed=3),
    }
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir(), b.mkdir()
    calls[case](J, str(a))
    calls[case](T, str(b))
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for n in names:
        assert filecmp.cmp(a / n, b / n, shallow=False), n


def test_native_ring_takes_a_stacked_record():
    # BASELINE config 5's records are 10,000 f32 fields: 40 KB each
    from flink_jpmml_tpu_torch.runtime.native import NativeRing

    rows = np.random.default_rng(15).normal(size=(6, 10_000)).astype(
        np.float32)
    ring = NativeRing(capacity=8, arity=10_000, batch_size=4)
    assert ring.push_block(rows, 100) == 6
    X, off = ring.drain(1000)
    assert X.shape == (4, 10_000) and off.tolist() == [100, 101, 102, 103]
    np.testing.assert_array_equal(X, rows[:4])
    X, off = ring.drain(1000)
    np.testing.assert_array_equal(X, rows[4:])
    ring.close()
