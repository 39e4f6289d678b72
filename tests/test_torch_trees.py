"""Dense f32 tree path of the PyTorch port against the JAX package:
``CompiledModel.predict`` of both on the same PMML and records (float32
sums in another order: the repo's bar, rtol 1e-4 / atol 1e-5)."""

import numpy as np
import pytest

from flink_jpmml_tpu.assets_gen import gen_iris_lr
from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.pmml import parse_pmml as jparse_str
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse_str
from flink_jpmml_tpu_torch.pmml import parse_pmml_file

RTOL, ATOL = 1e-4, 1e-5


def _xml(tmp_path, method="sum", weights=False, **kw):
    n = kw.setdefault("n_trees", 12)
    kw.setdefault("depth", 4)
    kw.setdefault("n_features", 6)
    with open(gen_gbm(str(tmp_path), **kw)) as f:
        xml = f.read()
    xml = xml.replace('multipleModelMethod="sum"',
                      f'multipleModelMethod="{method}"')
    if weights:
        for t in range(n):
            xml = xml.replace(f'<Segment id="{t}">',
                              f'<Segment id="{t}" weight="{0.5 + 0.1 * t}">')
    return xml


def _predict_both(xml, X, batch=None):
    M = np.isnan(X)
    Xf = np.nan_to_num(X, nan=0.0)
    t = compile_pmml(tparse_str(xml), batch_size=batch, device="cpu")
    j = jcompile(jparse_str(xml), batch_size=batch)
    return t, j, t.predict(Xf, M), j.predict(Xf, M)


@pytest.mark.parametrize("method,weights", [
    ("sum", False), ("average", False), ("weightedAverage", True),
    ("max", False), ("median", False),
])
def test_gbm_aggregates_match(tmp_path, method, weights):
    xml = _xml(tmp_path, method, weights)
    rng = np.random.default_rng(7)
    X = rng.normal(0, 1.5, size=(64, 6)).astype(np.float32)
    X[rng.random(size=X.shape) < 0.2] = np.nan
    _, _, to, jo = _predict_both(xml, X)
    np.testing.assert_allclose(to.value.numpy(), np.asarray(jo.value),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))


def test_full_width_gbm_and_decode(tmp_path):
    xml = _xml(tmp_path, n_trees=30, depth=6, n_features=32)
    rng = np.random.default_rng(8)
    X = rng.normal(0, 1.5, size=(48, 32)).astype(np.float32)
    X[rng.random(size=X.shape) < 0.2] = np.nan
    t, j, to, jo = _predict_both(xml, X, batch=48)
    np.testing.assert_allclose(to.value.numpy(), np.asarray(jo.value),
                               rtol=RTOL, atol=ATOL)
    tp, jp = t.decode(to, 48), j.decode(jo, 48)
    np.testing.assert_allclose([p.score.value for p in tp],
                               [p.score.value for p in jp],
                               rtol=RTOL, atol=ATOL)


def test_missing_value_replacement_and_single_tree(tmp_path):
    xml = _xml(tmp_path, n_trees=1, depth=3, n_features=4)
    xml = xml.replace('<MiningField name="f2" usageType="active" />',
                      '<MiningField name="f2" usageType="active" '
                      'missingValueReplacement="0.75" />', 1)
    assert "missingValueReplacement" in xml
    X = np.full((5, 4), np.nan, np.float32)
    X[1:] = np.random.default_rng(3).normal(size=(4, 4))
    _, _, to, jo = _predict_both(xml, X)
    np.testing.assert_allclose(to.value.numpy(), np.asarray(jo.value),
                               rtol=RTOL, atol=ATOL)


def test_vote_forest_dense_matches(tmp_path):
    from test_torch_qtrees import _forest_xml

    xml = _forest_xml("weightedMajorityVote", weighted=True)
    X = np.random.default_rng(2).normal(size=(50, 4)).astype(np.float32)
    X[::7, 1] = np.nan
    _, _, to, jo = _predict_both(xml, X)
    np.testing.assert_array_equal(to.label_idx.numpy(),
                                  np.asarray(jo.label_idx))
    np.testing.assert_allclose(to.probs.numpy(), np.asarray(jo.probs),
                               rtol=RTOL, atol=ATOL)


def test_other_families_raise_not_ported(tmp_path):
    # (the name predates the last families' port: every family the JAX
    # package lowers now compiles, so this holds them to it) NaiveBayes,
    # alone and as a segment of a selectFirst MiningModel, and selectFirst
    # over a RegressionModel match the JAX package
    from test_torch_rules import NAIVE_BAYES

    head, nb = NAIVE_BAYES.split("<NaiveBayesModel", 1)
    nb = nb.rsplit("</PMML>", 1)[0]
    nb_schema = nb[nb.index("<MiningSchema>"):nb.index("</MiningSchema>")]
    nested = (
        head + '<MiningModel functionName="classification">' + nb_schema
        + '</MiningSchema><Segmentation multipleModelMethod="selectFirst">'
        + "<Segment><True/><NaiveBayesModel" + nb + "</Segment>"
        + "</Segmentation></MiningModel></PMML>"
    )
    codes = np.asarray([[0.0], [1.0], [np.nan], [0.0]], np.float32)
    for doc in (NAIVE_BAYES, nested):
        _, _, to, jo = _predict_both(doc, codes)
        np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
        np.testing.assert_array_equal(to.label_idx.numpy(),
                                      np.asarray(jo.label_idx))
        np.testing.assert_allclose(to.probs.numpy(), np.asarray(jo.probs),
                                   rtol=RTOL, atol=ATOL)
        assert to.label_idx.tolist() == [0, 1, 0, 0]
    with open(gen_iris_lr(str(tmp_path))) as f:
        lr = f.read()
    head, model = lr.split("<RegressionModel", 1)
    model = model.rsplit("</PMML>", 1)[0]
    schema = model[model.index("<MiningSchema>"):model.index("</MiningSchema>")]
    xml = (
        head + '<MiningModel functionName="classification">'
        + schema + "</MiningSchema>"
        + '<Segmentation multipleModelMethod="selectFirst">'
        + "<Segment><True/><RegressionModel" + model + "</Segment>"
        + "</Segmentation></MiningModel></PMML>"
    )
    X = np.random.default_rng(4).normal(5.0, 1.5, size=(40, 4)).astype(
        np.float32)
    X[::6, 2] = np.nan
    _, _, to, jo = _predict_both(xml, X)
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    ok = np.asarray(jo.valid)
    np.testing.assert_array_equal(to.label_idx.numpy()[ok],
                                  np.asarray(jo.label_idx)[ok])
    np.testing.assert_allclose(to.probs.numpy()[ok], np.asarray(jo.probs)[ok],
                               rtol=RTOL, atol=ATOL)


def test_segment_predicates_take_the_generic_aggregate(tmp_path):
    # segments guarded by predicates leave the fused ensemble path:
    # lower_predicate + the per-segment aggregate (mining._lower_aggregate)
    xml = _xml(tmp_path, n_trees=6, depth=3, n_features=4)
    for t, pred in enumerate([
        '<SimplePredicate field="f0" operator="lessThan" value="0.3" />',
        '<SimplePredicate field="f1" operator="greaterOrEqual" value="-0.2" />',
        '<SimplePredicate field="f2" operator="isMissing" />',
        '<CompoundPredicate booleanOperator="or">'
        '<SimplePredicate field="f3" operator="lessOrEqual" value="0.0" />'
        '<SimplePredicate field="f0" operator="greaterThan" value="1.0" />'
        '</CompoundPredicate>',
        '<SimpleSetPredicate field="f1" booleanOperator="isNotIn">'
        '<Array type="real" n="2">0.5 1.5</Array></SimpleSetPredicate>',
    ]):
        seg = f'<Segment id="{t}">'
        i = xml.index(seg) + len(seg)
        j = xml.index("<True />", i)
        xml = xml[:j] + pred + xml[j + len("<True />"):]
    X = np.random.default_rng(5).normal(size=(80, 4)).astype(np.float32)
    X[::5, 2] = np.nan
    X[1::9, 0] = np.nan
    X[3, 1] = 0.5
    for method in ("sum", "average", "max", "median"):
        m = xml.replace('multipleModelMethod="sum"',
                        f'multipleModelMethod="{method}"')
        _, _, to, jo = _predict_both(m, X)
        np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
        ok = np.asarray(jo.valid)
        np.testing.assert_allclose(to.value.numpy()[ok],
                                   np.asarray(jo.value)[ok],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("treatment", [
    'invalidValueTreatment="returnInvalid"',
    'invalidValueTreatment="asMissing"',
    'invalidValueTreatment="asValue" invalidValueReplacement="0.1"',
])
def test_invalid_value_policy_matches(tmp_path, treatment):
    xml = _xml(tmp_path, n_trees=5, depth=3, n_features=4)
    field = '<DataField name="f1" optype="continuous" dataType="double" />'
    assert field in xml
    xml = xml.replace(field, field[:-3] + '><Interval closure="openClosed" '
                      'leftMargin="-1.0" rightMargin="1.5" /></DataField>', 1)
    mf = '<MiningField name="f1" usageType="active" />'
    xml = xml.replace(mf, mf[:-3] + f" {treatment} />", 1)
    X = np.random.default_rng(6).normal(0, 1.5, size=(64, 4)).astype(
        np.float32)
    X[0, 1], X[1, 1], X[2, 1] = -1.0, 1.5, np.nan
    _, _, to, jo = _predict_both(xml, X)
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    ok = np.asarray(jo.valid)
    assert 0 < ok.sum() < 64 or "returnInvalid" not in treatment
    np.testing.assert_allclose(to.value.numpy()[ok], np.asarray(jo.value)[ok],
                               rtol=RTOL, atol=ATOL)
