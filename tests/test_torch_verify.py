"""ModelVerification replay and ``warmup`` of the PyTorch port against the
JAX package, on the CPU.

The documents of tests/test_verification.py (and a NaiveBayes document
whose embedded vectors come from the oracle) are compiled by both
packages; ``has_verification`` and ``verify()`` must agree exactly —
the same empty list on correct vectors, the same mismatch messages on
altered ones, the same tolerance warnings. The JAX tests load through
``api.ModelReader``, which the port does not have yet; here both sides
call ``compile_pmml(doc).verify()``.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import test_verification as jv
from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.pmml import parse_pmml as jparse
from flink_jpmml_tpu.pmml.interp import evaluate
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse
from test_glm_bayes import NAIVE_BAYES

P_POS = f"{1.0 / (1.0 + math.exp(-2.0)):.6f}"

# naive Bayes with embedded vectors: expectations from the oracle
NB_RECORDS = [("sunny", "20.0"), ("rain", "8.5"), ("", "30.0"), ("fog", "")]


def _nb_verified(alter=False):
    doc = jparse(NAIVE_BAYES)
    rows = []
    for i, (outlook, temp) in enumerate(NB_RECORDS):
        rec = {}
        if outlook:
            rec["outlook"] = outlook
        if temp:
            rec["temp"] = float(temp)
        o = evaluate(doc, rec)
        label = o.label if not (alter and i == 1) else (
            "no" if o.label == "yes" else "yes")
        rows.append(f"<row><outlook>{outlook}</outlook><temp>{temp}</temp>"
                    f"<play>{label}</play><p>{o.probabilities['yes']!r}</p>"
                    "</row>")
    block = (
        '<ModelVerification recordCount="4" fieldCount="4">'
        "<VerificationFields>"
        '<VerificationField field="outlook" column="outlook"/>'
        '<VerificationField field="temp" column="temp"/>'
        '<VerificationField field="play" column="play"/>'
        '<VerificationField field="probability(yes)" column="p" '
        'precision="1E-4"/></VerificationFields>'
        "<InlineTable>" + "".join(rows) + "</InlineTable>"
        "</ModelVerification>")
    return NAIVE_BAYES.replace("</NaiveBayesModel>",
                               block + "</NaiveBayesModel>")


DOCS = {
    "reg_correct": (jv.REG.format(y1="-3.5", y2="-1.25"), 0),
    "reg_wrong": (jv.REG.format(y1="-3.5", y2="7.0"), 1),
    "reg_precision_window": (jv.REG.format(y1="-3.4999998", y2="-1.25"), 0),
    "cls_correct": (jv.CLS.format(label="pos", p=P_POS), 0),
    "cls_wrong_label": (jv.CLS.format(label="neg", p=P_POS), 1),
    "cls_wrong_probability": (jv.CLS.format(label="pos", p="0.5"), 1),
    "unknown_column": (jv.REG.format(y1="-3.5", y2="-1.25").replace(
        'field="y" column="data:y"', 'field="zzz" column="data:y"'), 2),
    "numeric_looking_category": (jv.CAT, 0),
    "numeric_class_label": (jv.NUMLABEL, 0),
    "default_tolerances": (jv.REG.format(y1="-3.5", y2="-1.25").replace(
        ' precision="1E-5"', "").replace("-3.5</data:y>",
                                         "-3.50011</data:y>"), 0),
    "default_tolerances_wrong": (jv.REG.format(y1="-3.51", y2="-1.25")
                                 .replace(' precision="1E-5"', ""), 1),
    "naive_bayes": (_nb_verified(), 0),
    "naive_bayes_altered": (_nb_verified(alter=True), 1),
}


@pytest.mark.parametrize("case", sorted(DOCS))
def test_verify_matches_the_jax_package(case):
    xml, n_problems = DOCS[case]
    jm = jcompile(jparse(xml))
    tm = compile_pmml(tparse(xml), device="cpu")
    assert tm.has_verification and jm.has_verification
    got = tm.verify()
    assert got == jm.verify()
    assert len(got) == n_problems, got


def test_mismatch_names_the_row_and_field():
    tm = compile_pmml(tparse(jv.REG.format(y1="-3.5", y2="7.0")),
                      device="cpu")
    assert tm.verify() == ["row 1 field 'y': value = -1.25, expected 7.0"]
    tm = compile_pmml(tparse(jv.CLS.format(label="neg", p=P_POS)),
                      device="cpu")
    assert tm.verify() == ["row 0 field 'cls': label = 'pos', expected 'neg'"]


def test_below_floor_tolerance_warns_when_loosened():
    xml = jv.REG.replace('precision="1E-5"', 'precision="1E-8"').format(
        y1="-3.5", y2="-1.25")
    tm = compile_pmml(tparse(xml), device="cpu")
    with pytest.warns(UserWarning, match="noise floor"):
        assert tm.verify() == []
    tm = compile_pmml(tparse(jv.REG.format(y1="-3.5", y2="-1.25")),
                      device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tm.verify() == []


def test_without_verification():
    from test_torch_rules import NAIVE_BAYES as NB_PLAIN

    tm = compile_pmml(tparse(NB_PLAIN), device="cpu")
    assert not tm.has_verification and tm.verify() == []


@pytest.mark.parametrize("batch", [None, 8])
def test_warmup_runs_one_batch_and_returns_the_model(batch, monkeypatch):
    tm = compile_pmml(tparse(_nb_verified()), batch_size=batch, device="cpu")
    seen = []
    fn = tm._fn

    def spy(params, X, M):
        seen.append((tuple(X.shape), X.device.type))
        return fn(params, X, M)

    monkeypatch.setattr(tm, "_fn", spy)
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(a))
    assert tm.warmup() is tm
    assert seen == [((batch or 1, 2), "cpu")] and synced == []
    out = tm.predict(np.zeros((3, 2), np.float32), np.ones((3, 2), bool))
    assert out.valid.all()  # all missing: the priors score
