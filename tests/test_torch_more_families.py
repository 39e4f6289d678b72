"""The last nine model families of the PyTorch port against the JAX
package, on the CPU: NaiveBayes, SupportVectorMachine, NearestNeighbor
(with neighbour ids), BayesianNetwork, GaussianProcess, Baseline,
Association (with rule outputs), TextModel and TimeSeries, and the port's
copy of the oracle (``pmml/interp.py``).

Each case runs the same inputs through three scorers:

- the JAX package's ``compile_pmml(...).predict`` and the port's
  (``device="cpu"``) on seeded rows (N(0, 1.5), 20% missing cells,
  categorical columns holding declared codes and one undeclared code):
  validity equal, values and per-class rows within rtol 1e-4 / atol 1e-5,
  labels and KNN neighbour indices exactly equal on valid lanes;
- both packages' ``score_records`` on records: the same empties, labels,
  decoded outputs (rank-k ``entityId``, ``ruleValue`` and the
  association winner's rule metadata exactly equal);
- the JAX oracle (``pmml/interp.evaluate``) at the golden suite's
  tolerance, and the port's copy of it, which must return the same
  result as the JAX one on every record.

The cases are those of tests/test_glm_bayes.py (NAIVE_BAYES),
test_svm.py, test_knn.py, test_bayesnet.py, test_gp_baseline_assoc.py,
test_textmodel.py and test_timeseries.py, plus a KNN table with
duplicated rows (exact ties resolve to the lower training row, as
``lax.top_k`` does), even-k medians (``jnp.median`` averages the two
middle values), ``chip_smoke``'s generators at small sizes, the
test_interp.py cases on the port's oracle, and every new family's JAX
parameters carried across with ``convert.model_params_from_jax``.
"""

import dataclasses
import inspect
import re

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_bayesnet as jbn
import test_gp_baseline_assoc as jga
import test_interp as jint
import test_knn as jknn
import test_svm as jsvm
import test_textmodel as jtm
import test_timeseries as jts
from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.pmml import interp as jinterp
from flink_jpmml_tpu.pmml import parse_pmml as jparse
from flink_jpmml_tpu.pmml.interp import evaluate
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.convert import model_params_from_jax
from flink_jpmml_tpu_torch.pmml import interp as tinterp
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse
from flink_jpmml_tpu_torch.pmml import parse_pmml_file as tparse_file
from flink_jpmml_tpu_torch.pmml.interp import evaluate as tevaluate
from test_glm_bayes import NAIVE_BAYES
from test_torch_families import GOLDEN, assert_oracle_match, assert_predict_match
from test_torch_rules import assert_records_match

RTOL, ATOL = 1e-4, 1e-5  # port vs JAX package


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


def compile_both(xml):
    jdoc = jparse(xml)
    return jdoc, jcompile(jdoc), compile_pmml(tparse(xml), device="cpu")


def seeded_rows(tm, n, seed, missing=0.2, undeclared=True):
    """N(0, 1.5) rows with ``missing`` cells; a string-categorical column
    holds its declared codes (and, with ``undeclared``, one code past
    them)."""
    rng = np.random.default_rng(seed)
    fields = tm.field_space.fields
    X = rng.normal(0.0, 1.5, size=(n, len(fields))).astype(np.float32)
    for j, f in enumerate(fields):
        codec = tm.field_space.codecs.get(f)
        if codec:
            X[:, j] = rng.integers(0, len(codec) + int(undeclared), size=n)
    M = rng.random(size=X.shape) < missing
    X[M] = 0.0
    return X, M


def oracle_twins(jdoc, tdoc, records):
    """The port's oracle returns what the JAX package's returns."""
    for rec in records:
        assert repr(tevaluate(tdoc, rec)) == repr(evaluate(jdoc, rec)), rec


def check(xml, records=(), n=64, seed=0, missing=0.2, tol=GOLDEN,
          rows=None, n_records=24, oracle=True):
    """One case: seeded rows through both ``predict``s, then records (the
    given ones and some of the rows) through both ``score_records``, the
    oracle (unless ``oracle`` is False) and the port's oracle."""
    jdoc, jm, tm = compile_both(xml)
    X, M = seeded_rows(tm, n, seed, missing)
    if rows is not None:
        rows(X, np.random.default_rng(seed))
    to = assert_predict_match(jm, tm, X, M)
    if jm._neighbor_meta is not None:  # ranked neighbour indices: exact
        L = len(jm.labels)
        jo = jm.predict(X, M)
        valid = np.asarray(jo.valid)
        np.testing.assert_array_equal(to.probs.numpy()[valid, L:],
                                      np.asarray(jo.probs)[valid, L:])
    Xr, Mr = seeded_rows(tm, n_records, seed + 1, missing, undeclared=False)
    if rows is not None:
        rows(Xr, np.random.default_rng(seed + 1))
    Xr[Mr] = np.nan
    recs = list(records) + cs.records_of(tm, Xr)
    assert_records_match(jdoc, jm, tm, recs)
    if oracle:
        assert_oracle_match(tm, jdoc, recs, tol)
    oracle_twins(jdoc, tparse(xml), recs)
    return jdoc, jm, tm


def horizons(X, rng):
    X[:, 0] = rng.integers(-2, 70, size=X.shape[0]) + np.where(
        rng.random(X.shape[0]) < 0.3, 0.4, 0.0)


def counts(X, rng):
    X[:] = rng.poisson(1.0, size=X.shape)


# ---------------------------------------------------------------------------
# NaiveBayes (tests/test_glm_bayes.py TestNaiveBayes)
# ---------------------------------------------------------------------------

NB_RECORDS = [{"outlook": "sunny", "temp": 20.0}, {"outlook": "fog"},
              {"outlook": "rain", "temp": 31.5}, {"temp": 4.0}, {}]


@pytest.mark.parametrize("variant", ["fixture", "zero_count", "chip_smoke"])
def test_naive_bayes(variant):
    if variant == "chip_smoke":
        xml = cs.naive_bayes_xml(n_continuous=6, n_categorical=3,
                                 n_values=4)
        check(xml, n=128, seed=3)
        return
    xml = NAIVE_BAYES
    if variant == "zero_count":
        xml = xml.replace('value="no" count="1"', 'value="no" count="0"')
    _, _, tm = check(xml, NB_RECORDS, seed=2)
    # equal priors: the all-missing record ties, and the first label wins
    p = tm.score_records([{}])[0]
    assert p.target.label == "yes"
    assert p.target.probabilities["yes"] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# SVM (tests/test_svm.py)
# ---------------------------------------------------------------------------

_OVA = """
  <SupportVectorMachine targetCategory="A">
    <SupportVectors numberOfSupportVectors="1">
      <SupportVector vectorId="v1"/></SupportVectors>
    <Coefficients absoluteValue="0.0"><Coefficient value="1.0"/>
    </Coefficients></SupportVectorMachine>
  <SupportVectorMachine targetCategory="B">
    <SupportVectors numberOfSupportVectors="1">
      <SupportVector vectorId="v2"/></SupportVectors>
    <Coefficients absoluteValue="0.0"><Coefficient value="1.0"/>
    </Coefficients></SupportVectorMachine>"""

_SVR = """
  <SupportVectorMachine>
    <SupportVectors numberOfSupportVectors="3">
      <SupportVector vectorId="v1"/><SupportVector vectorId="v2"/>
      <SupportVector vectorId="v3"/></SupportVectors>
    <Coefficients absoluteValue="0.25">
      <Coefficient value="1.5"/><Coefficient value="-2.0"/>
      <Coefficient value="0.5"/></Coefficients>
  </SupportVectorMachine>"""


def _svm_docs():
    docs = {f"ovo_{k}": jsvm._svm_xml(v[0], jsvm._PAIR_MACHINES)
            for k, v in jsvm.KERNELS.items()}
    docs["ova"] = jsvm._svm_xml("<LinearKernelType/>", _OVA,
                                method="OneAgainstAll")
    docs["svr_rbf"] = jsvm._svm_xml('<RadialBasisKernelType gamma="0.3"/>',
                                    _SVR, function="regression")
    docs["threshold"] = jsvm._svm_xml(
        "<LinearKernelType/>", jsvm._PAIR_MACHINES.replace(
            'alternateTargetCategory="B">',
            'alternateTargetCategory="B" threshold="0.5">', 1),
        extra_attrs='threshold="0.1"')
    docs["chip_smoke_rbf"] = cs.svm_xml(n_classes=3, n_vectors=60,
                                        n_fields=6)
    docs["chip_smoke_poly"] = cs.svm_xml("poly", n_vectors=40, n_fields=6)
    return docs


@pytest.mark.parametrize("case", sorted(_svm_docs()))
def test_svm(case):
    check(_svm_docs()[case], [{"x1": 1.0}, {"x1": 0.4, "x2": -0.9}], n=96)


# ---------------------------------------------------------------------------
# KNN (tests/test_knn.py)
# ---------------------------------------------------------------------------

_REG = dict(function="regression", target="yv")
_JACCARD = ('<ComparisonMeasure kind="similarity"><jaccard/>'
            "</ComparisonMeasure>")


def _ids(xml, ranks=3):
    """``xml`` with rank-1..``ranks`` entityId outputs (TestInstanceIds)."""
    return jknn.TestInstanceIds()._with_output(xml, ranks)


def _knn_docs():
    ids_t = jknn.TestInstanceIds()
    return {
        "majority": jknn._knn_xml(),
        "weighted": jknn._knn_xml(
            attrs='categoricalScoringMethod="weightedMajorityVote"'),
        "average": jknn._knn_xml(**_REG),
        "weighted_average": jknn._knn_xml(
            attrs='continuousScoringMethod="weightedAverage"', **_REG),
        "median_k3": jknn._knn_xml(
            attrs='continuousScoringMethod="median"', **_REG),
        "median_k4": jknn._knn_xml(
            k=4, attrs='continuousScoringMethod="median"', **_REG),
        "median_k2": jknn._knn_xml(
            k=2, attrs='continuousScoringMethod="median"', **_REG),
        "k1": jknn._knn_xml(k=1),
        "minkowski": jknn._knn_xml(
            measure='<ComparisonMeasure kind="distance">'
                    '<minkowski p-parameter="3"/></ComparisonMeasure>'),
        "jaccard_votes": jknn._knn_xml(measure=_JACCARD),
        "jaccard_weighted_average": jknn._knn_xml(
            attrs='continuousScoringMethod="weightedAverage"',
            measure=_JACCARD, **_REG),
        "ids_classification": _ids(ids_t._xml_with_ids()),
        "ids_regression": _ids(ids_t._xml_with_ids(**_REG)),
        "ids_beyond_k": _ids(ids_t._xml_with_ids(), ranks=5),
        "chip_smoke_vote": cs.knn_xml(n_instances=300, n_fields=4,
                                      duplicated=0.2),
        "chip_smoke_median": cs.knn_xml(n_instances=300, n_fields=4, k=4,
                                        duplicated=0.2, scoring="median"),
    }


def _binary(X, rng):
    X[:] = rng.integers(0, 2, size=X.shape)


@pytest.mark.parametrize("case", sorted(_knn_docs()))
def test_knn(case):
    rows = _binary if "jaccard" in case else None
    check(_knn_docs()[case], [{"u": 0.1, "v": 0.1}, {"u": 1.0},
                              {"u": 0.5, "v": 0.5}], n=96, rows=rows)


def test_knn_nested_ids_in_select_first():
    inner = jknn.TestInstanceIds()._xml_with_ids()
    model = inner[inner.index("<NearestNeighborModel"):
                  inner.index("</NearestNeighborModel>")
                  + len("</NearestNeighborModel>")]
    xml = inner[: inner.index("<NearestNeighborModel")] + f"""
      <MiningModel functionName="classification">
      <MiningSchema><MiningField name="cls" usageType="target"/>
        <MiningField name="u"/><MiningField name="v"/></MiningSchema>
      <Output><OutputField name="nb1" feature="entityId" rank="1"/>
      </Output>
      <Segmentation multipleModelMethod="selectFirst">
        <Segment><True/>{model}</Segment>
      </Segmentation></MiningModel></PMML>"""
    _, _, tm = check(xml, [{"u": 0.1, "v": 0.1}])
    assert tm.score_records([{"u": 0.1, "v": 0.1}])[0].outputs == {
        "nb1": None}


def _tie_table(k):
    """The test_knn fixture with every training row written twice, the
    copy under another label: each query's distances tie in pairs."""
    labels = {"a": "c", "b": "a", "c": "b"}
    rows = "".join(
        f"<row><u>{u}</u><v>{v}</v><cls>{c}</cls><yv>{y}</yv>"
        f"<rid>r{i}</rid></row><row><u>{u}</u><v>{v}</v>"
        f"<cls>{labels[c]}</cls><yv>{y + 100}</yv><rid>d{i}</rid></row>"
        for i, (u, v, c, y) in enumerate(jknn.ROWS))
    xml = re.sub(r"<InlineTable>.*</InlineTable>",
                 f"<InlineTable>{rows}</InlineTable>",
                 jknn._knn_xml(k=k), flags=re.S)
    xml = xml.replace(
        "<InstanceFields>",
        '<InstanceFields><InstanceField field="rid" column="rid"/>').replace(
        "<NearestNeighborModel", '<NearestNeighborModel instanceIdVariable='
        '"rid"', 1)
    return jknn.TestInstanceIds()._with_output(xml, k)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_knn_exact_ties_take_the_lower_row(k):
    """Duplicated training rows tie exactly; ``lax.top_k`` keeps the lower
    row, and so must the port: the original (r*) before its copy (d*),
    whose label differs, so a wrong order changes labels and ids."""
    _, jm, tm = check(_tie_table(k), [{"u": 0.0, "v": 0.0},
                                      {"u": 2.5, "v": 2.5}])
    p = tm.score_records([{"u": 0.0, "v": 0.0}])[0]
    assert p.outputs["nb1"] == "r0" and p.target.label == "a"
    if k > 1:
        assert p.outputs["nb2"] == "d0"
    # a query equidistant from rows 0..3 and their copies: row order wins
    p = tm.score_records([{"u": 0.5, "v": 0.5}])[0]
    want = ("r0", "d0", "r1")[:k]
    assert tuple(p.outputs[f"nb{r}"] for r in range(1, k + 1)) == want
    X = np.asarray([[0.5, 0.5], [0.0, 0.0]], np.float32)
    M = np.zeros_like(X, bool)
    _, idx = jax.lax.top_k(-np.asarray([[(0.5 - u) ** 2 + (0.5 - v) ** 2
                                         for u, v, *_ in jknn.ROWS
                                         for _ in (0, 1)]], np.float32), k)
    out = tm.predict(X, M)
    np.testing.assert_array_equal(out.probs.numpy()[0, 3:],
                                  np.asarray(idx)[0])
    np.testing.assert_array_equal(out.probs.numpy(),
                                  np.asarray(jm.predict(X, M).probs))


@pytest.mark.parametrize("k", [2, 4, 6])
def test_knn_even_k_median_averages_the_middle_pair(k):
    xml = jknn._knn_xml(k=k, attrs='continuousScoringMethod="median"',
                        **_REG)
    jdoc, jm, tm = check(xml)
    got = tm.score_records([{"u": 0.0, "v": 0.0}])[0].score.value
    ys = sorted(sorted(jknn.ROWS, key=lambda r: r[0] ** 2 + r[1] ** 2)[i][3]
                for i in range(k))
    assert got == pytest.approx((ys[k // 2 - 1] + ys[k // 2]) / 2)
    assert got == pytest.approx(float(np.asarray(jax.numpy.median(
        np.asarray(ys, np.float32)))))


# ---------------------------------------------------------------------------
# BayesianNetwork (tests/test_bayesnet.py)
# ---------------------------------------------------------------------------

_BN_IMPOSSIBLE = jbn.BN.replace(
    '<ParentValue parent="sprinkler" value="off"/>\n        '
    '<ParentValue parent="rain" value="yes"/>\n        '
    '<ValueProbability value="wet" probability="0.8"/>\n        '
    '<ValueProbability value="dry" probability="0.2"/>',
    '<ParentValue parent="sprinkler" value="off"/>\n        '
    '<ParentValue parent="rain" value="yes"/>\n        '
    '<ValueProbability value="wet" probability="0.0"/>\n        '
    '<ValueProbability value="dry" probability="1.0"/>')


@pytest.mark.parametrize("case", ["fixture", "impossible", "chip_smoke"])
def test_bayesian_network(case):
    xml = {"fixture": jbn.BN, "impossible": _BN_IMPOSSIBLE,
           "chip_smoke": cs.bayesnet_xml(n_nodes=5, n_coparents=2)}[case]
    recs = [{"sprinkler": s, "grass": g} for s in ("on", "off")
            for g in ("wet", "dry")] + [{"sprinkler": None, "grass": "wet"},
                                        {"sprinkler": "sideways",
                                         "grass": "wet"}]
    _, _, tm = check(xml, recs if case != "chip_smoke" else (), n=96,
                     missing=0.05)
    if case == "fixture":
        p = tm.score_records([{"sprinkler": "off", "grass": "wet"}])[0]
        assert p.target.label == "yes"
        assert p.target.probabilities["no"] == 0.0


# ---------------------------------------------------------------------------
# GaussianProcess, Baseline, Association (tests/test_gp_baseline_assoc.py)
# ---------------------------------------------------------------------------

GP_KERNELS = {
    "radial_basis": '<RadialBasisKernel gamma="2.0" noiseVariance="0.1" '
                    'lambda="1.3"/>',
    "ard": '<ARDSquaredExponentialKernel gamma="1.5" noiseVariance="0.2">'
           '<Lambda><Array n="2" type="real">0.8 2.0</Array></Lambda>'
           "</ARDSquaredExponentialKernel>",
    "absolute": '<AbsoluteExponentialKernel gamma="1.0" noiseVariance="0.05">'
                '<Lambda><Array n="2" type="real">1.0 0.5</Array></Lambda>'
                "</AbsoluteExponentialKernel>",
    "generalized": '<GeneralizedExponentialKernel gamma="1.2" '
                   'noiseVariance="0.1" degree="1.5"><Lambda>'
                   '<Array n="2" type="real">1.1 0.9</Array></Lambda>'
                   "</GeneralizedExponentialKernel>",
}


@pytest.mark.parametrize("case", sorted(GP_KERNELS) + ["chip_smoke_ard",
                                                      "chip_smoke_absexp"])
def test_gaussian_process(case):
    if case.startswith("chip_smoke"):
        xml = cs.gp_xml(case.rsplit("_", 1)[1], n_rows=80, n_fields=4)
    else:
        xml = jga.GP.format(kernel=GP_KERNELS[case])
    check(xml, [{"x1": 0.3}, {"x1": 0.2, "x2": -0.4}], n=96, missing=0.1)


@pytest.mark.parametrize("dist", [
    '<GaussianDistribution mean="5.0" variance="4.0"/>',
    '<PoissonDistribution mean="9.0"/>',
    '<UniformDistribution lower="2.0" upper="8.0"/>',
    "chip_smoke",
])
def test_baseline(dist):
    xml = (cs.baseline_xml() if dist == "chip_smoke"
           else jga.BASELINE.format(dist=dist))
    check(xml, [{"x": v} for v in (0.0, 3.5, 5.0, 11.25, None)])


def _assoc_docs():
    out = {"default": jga.ASSOC}
    for criterion in ("rule", "recommendation"):
        out[criterion] = jga.ASSOC.replace(
            "</AssociationModel>",
            '<Output><OutputField name="rec" feature="ruleValue" '
            f'algorithm="{criterion}" ruleFeature="consequent"/>'
            "</Output></AssociationModel>")
    out["rule_values"] = jga.ASSOC.replace(
        "</AssociationModel>",
        "<Output>" + "".join(
            f'<OutputField name="{n}{r}" feature="ruleValue" '
            f'ruleFeature="{f}" rank="{r}"/>'
            for r in (1, 2, 3) for n, f in (
                ("rid", "ruleId"), ("sup", "support"), ("ante", "antecedent"),
                ("rl", "rule"), ("lift", "lift"), ("conf", "confidence")))
        + "</Output></AssociationModel>")
    out["chip_smoke"] = cs.assoc_xml(n_items=12, n_rules=40)
    return out


@pytest.mark.parametrize("case", sorted(_assoc_docs()))
def test_association(case):
    baskets = [jga._basket(**kw) for kw in (
        {"beer": 1}, {"beer": 1, "chips": 1}, {"wine": 1},
        {"beer": 1, "wine": 1}, {}, {"beer": 1, "chips": 1, "bread": 1})]
    baskets.append({"beer": 1.0, "chips": None, "wine": None, "bread": None})
    _, _, tm = check(_assoc_docs()[case],
                     baskets if case != "chip_smoke" else (), n=96)
    if case == "rule_values":
        p = tm.score_records([jga._basket(beer=1, chips=1)])[0]
        assert (p.outputs["rid1"], p.outputs["ante1"], p.outputs["rl1"]) == (
            "r2", "beer chips", "{beer chips}->{bread}")
    if case == "default":
        p = tm.score_records([jga._basket(beer=1, chips=1)])[0]
        assert p.target.label == "bread" and p.outputs["ruleId"] == "r2"


# ---------------------------------------------------------------------------
# TextModel (tests/test_textmodel.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    (None, None, None, None),
    ("binary", None, None, "cosine"),
    ("logarithmic", "inverseDocumentFrequency", None, "cosine"),
    ("augmentedNormalizedTermFrequency", None, "cosine", "cosine"),
    ("termFrequency", "inverseDocumentFrequency", "cosine", "euclidean"),
    "chip_smoke",
], ids=["defaults", "binary", "log_idf", "augmented_cosine",
        "tf_idf_euclidean", "chip_smoke"])
def test_text_model(args):
    xml = (cs.text_xml(n_terms=40, n_docs=30) if args == "chip_smoke"
           else jtm._xml(*args))
    check(xml, [{"ball": 4.0, "goal": None}], n=96, rows=counts)


# ---------------------------------------------------------------------------
# TimeSeries (tests/test_timeseries.py)
# ---------------------------------------------------------------------------

_ES = {
    "level": ("", ""), "additive": (jts.TREND_ADD, ""),
    "damped": (jts.TREND_DAMPED, ""),
    "additive_seasonal_add": (jts.TREND_ADD, jts.SEASONAL_ADD),
    "damped_seasonal_mul": (jts.TREND_DAMPED, jts.SEASONAL_MUL),
    "multiplicative": (jts.TREND_MUL, ""),
    "multiplicative_seasonal_add": (jts.TREND_MUL, jts.SEASONAL_ADD),
    "damped_mul_seasonal_mul": (jts.TREND_DAMPED_MUL, jts.SEASONAL_MUL),
}
_SARIMA_HIST = tuple(round(50 + 2 * t + 5 * np.sin(t * np.pi / 2) + v, 3)
                     for t, v in enumerate(np.random.default_rng(7).normal(
                         0, 0.5, size=24)))
_ARIMA = {
    "ar1": jts._arima_xml(jts._ns(1, 0, 0, ar=(0.6,)), jts.HIST8,
                          constant=0.5),
    "ma1": jts._arima_xml(jts._ns(0, 0, 1, ma=(0.4,), residuals=(0.1, 0.8)),
                          jts.HIST8, constant=2.0),
    "sarima": jts._arima_xml(
        jts._ns(2, 1, 1, ar=(0.45, -0.2), ma=(0.3,), residuals=(0.2, -0.1))
        + jts._sc(1, 1, 1, 4, sar=(0.35,), sma=(0.25,),
                  residuals=(0.1, -0.2, 0.15, 0.05, 0.2, -0.1)),
        _SARIMA_HIST, constant=0.1),
    "log": jts._arima_xml(jts._ns(1, 0, 0, ar=(0.9,)), jts.HIST8,
                          transformation="logarithmic"),
    "explosive": jts._arima_xml(jts._ns(1, 0, 0, ar=(1.5,)), jts.HIST8,
                                transformation="logarithmic"),
}


@pytest.mark.parametrize("case", sorted(_ES) + sorted(f"arima_{k}"
                                                      for k in _ARIMA)
                         + ["chip_smoke_arima", "chip_smoke_holt_winters"])
def test_time_series(case):
    if case == "chip_smoke_arima":
        xml = cs.arima_xml()
    elif case == "chip_smoke_holt_winters":
        xml = cs.holt_winters_xml()
    elif case.startswith("arima_"):
        xml = _ARIMA[case[6:]]
    else:
        trend, seasonal = _ES[case]
        xml = jts.TS.format(trend=trend, seasonal=seasonal)
    # the SARIMA's two implementations compose the differencing in
    # opposite orders (tests/test_timeseries.py holds them to 2e-4 / 1e-3)
    tol = (2e-4, 1e-3) if "arima" in case else GOLDEN
    # an explosive AR overflows float32 where the oracle's float64 does not
    # (both compiled paths give +inf): held to the JAX package's paths only
    explosive = case == "arima_explosive"
    _, _, tm = check(xml, [{"h": h} for h in (1, 2.4, 2.6, 0.0, -5.0, 13,
                                              None)],
                     rows=horizons, tol=tol, oracle=not explosive)
    if explosive:
        assert tm.score_records([{"h": 60}])[0].score.value == float("inf")


# ---------------------------------------------------------------------------
# the oracle: test_interp.py's cases on the port's copy
# ---------------------------------------------------------------------------


def _interp_cases():
    return [(cls.__name__, name)
            for cls in (jint.TestRegression, jint.TestTree, jint.TestMining,
                        jint.TestClustering, jint.TestNeuralNetwork)
            for name, _ in inspect.getmembers(cls, inspect.isfunction)
            if name.startswith("test_")]


@pytest.mark.parametrize("cls_name,method", _interp_cases())
def test_interp_cases_on_the_port_oracle(cls_name, method, monkeypatch,
                                         request):
    monkeypatch.setattr(jint, "parse_pmml", tparse)
    monkeypatch.setattr(jint, "parse_pmml_file", tparse_file)
    monkeypatch.setattr(jint, "evaluate", tevaluate)
    # two cases import the oracle's _eval_model inside the test body
    monkeypatch.setattr(jinterp, "_eval_model", tinterp._eval_model)
    fn = getattr(getattr(jint, cls_name)(), method)
    kwargs = {a: request.getfixturevalue(a)
              for a in inspect.signature(fn).parameters}
    fn(**kwargs)


# ---------------------------------------------------------------------------
# dispatch and parameters
# ---------------------------------------------------------------------------


def _carry_docs():
    return {
        "naive_bayes": NAIVE_BAYES,
        "svm": jsvm._svm_xml(jsvm.KERNELS["radialBasis"][0],
                             jsvm._PAIR_MACHINES),
        "knn_ids": _ids(jknn.TestInstanceIds()._xml_with_ids()),
        "knn_regression": jknn._knn_xml(**_REG),
        "bayesnet": jbn.BN,
        "gp_sq": jga.GP.format(kernel=GP_KERNELS["ard"]),
        "gp_cube": jga.GP.format(kernel=GP_KERNELS["absolute"]),
        "baseline": cs.baseline_xml(),
        "association": _assoc_docs()["rule_values"],
        "textmodel": jtm._xml(),
        "arima": _ARIMA["sarima"],
        "smoothing": jts.TS.format(trend=jts.TREND_DAMPED,
                                   seasonal=jts.SEASONAL_MUL),
    }


@pytest.mark.parametrize("family", sorted(_carry_docs()))
def test_jax_params_carry_over(family):
    """JAX ``compile_pmml(doc).params`` → ``model_params_from_jax`` → the
    port's own parameters: the same keys, shapes and dtypes (the KNN
    labels, the association's int32 ``order``, the f32 casts of the GP
    and SVM tables), and outputs equal to the port's own."""
    xml = _carry_docs()[family]
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
    X, M = seeded_rows(tm, 64, 5)
    want = tm.predict(X, M)
    tm.params["model"] = carried
    got = tm.predict(X, M)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_every_family_of_the_jax_package_has_a_lowering():
    from flink_jpmml_tpu_torch.compile.compiler import _LOWERERS
    from flink_jpmml_tpu_torch.pmml import ir

    lowered = {cls for cls, _ in _LOWERERS}
    models = {c for _, c in inspect.getmembers(ir, inspect.isclass)
              if c.__name__.endswith("IR") and dataclasses.is_dataclass(c)
              and "mining_schema" in {f.name for f in dataclasses.fields(c)}}
    assert models and models <= lowered, models - lowered
    assert _LOWERERS[-1][0] is ir.MiningModelIR


def test_time_series_huge_horizon_follows_the_jax_package():
    """Past 2**31 - 1 the JAX package's int32 cast of the horizon
    saturates, so its season index differs from its oracle's; the port
    follows the compiled path (ROADMAP Queue 3, not a port fault)."""
    xml = jts.TS.format(trend="", seasonal=jts.SEASONAL_ADD)
    _, jm, tm = compile_both(xml)
    X = np.asarray([[3e9], [2.0 ** 31 + 256], [1e12], [np.inf], [7.0]],
                   np.float32)
    M = np.zeros_like(X, bool)
    got = tm.predict(X, M).value.numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.predict(X, M).value))
    assert got[0] == np.float32(120.5 + 1.5)  # season (2**31 - 2) % 4 = 2
    assert evaluate(jparse(xml), {"h": 3e9}).value == 120.5 - 3.5
