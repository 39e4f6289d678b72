"""Seeded random models and dirty records, and the lane-by-lane parity
assertion of the compiled model against the oracle.

A copy of the JAX repo's generators, building this package's
``pmml.ir`` (its IR classes carry the same names and fields as the JAX
package's). Each generator draws from the caller's
``numpy.random.Generator`` in exactly the order of its source, so the
same seed gives the same model in both packages
(tests/test_torch_fuzz.py compares canonical dumps of the two). Sources:

==========================  =============================================
here                        JAX repo
==========================  =============================================
``make_doc``                ``tests/test_fuzz.py:20 _doc``
``schema``                  ``tests/test_fuzz.py:36 _schema``
``rand_predicate``          ``tests/test_fuzz.py:44 _rand_predicate``
``rand_tree``               ``tests/test_fuzz.py:76 _rand_tree``
``rand_tree_model``         ``tests/test_fuzz.py:128 _rand_tree_model``
``rand_records``            ``tests/test_fuzz.py:146 _rand_records``
``rand_mining_model``       ``tests/test_fuzz.py:212`` (inline in
                            ``TestFuzzMining``), ``tools/fuzz_soak.py:41
                            _soak_mining``
``rand_regression_model``   ``tests/test_fuzz.py:254``
``rand_scorecard_model``    ``tests/test_fuzz.py:308`` (inline in
                            ``TestFuzzScorecard``), ``tools/fuzz_soak.py
                            :106 _soak_scorecard``
``rand_nn_model``           ``tests/test_fuzz.py:343 _rand_nn_model``
``rand_glm_model``          ``tests/test_fuzz.py:417 _rand_glm_model``
``rand_sarima_doc``,        ``tests/test_fuzz.py:462`` (inline in
``rand_sarima_records``     ``TestFuzzArima``), ``tools/fuzz_soak.py:140
                            _soak_sarima``
``arima_xml``, ``ns``,      ``tests/test_timeseries.py:189 _arima_xml``,
``sc``                      ``:210 _ns``, ``:234 _sc``
``assert_parity``           ``tests/test_fuzz.py:171 _assert_parity``
==========================  =============================================

What differs:

- The inline generators of the mining, scorecard and ARIMA tests are
  functions here (the model's draws, then the records' in a separate
  call, the order of the inline code).
- ``assert_parity`` compiles on the caller's ``device`` (the port has
  no default backend to fall back to), returns the largest absolute
  value error of the lanes it compared, and reads the oracle through
  this module's ``evaluate`` at call time. Its bar is the JAX one:
  values within rel 2e-4 / abs 2e-5 (``pytest.approx``'s rule, written
  out, since the package does not import pytest), empties equal, labels
  equal, and an oracle value beyond float32 range met by a same-signed
  inf or a magnitude over 3.3e38.
"""

from __future__ import annotations

import numpy as np

from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.pmml.interp import evaluate

FIELDS = ("f0", "f1", "f2")
CAT_VALUES = ("red", "green", "blue")
REL = 2e-4
ABS = 2e-5
F32_MAX = float(np.finfo(np.float32).max)


def make_doc(model):
    dd = ir.DataDictionary(fields=tuple(
        [ir.DataField(name=f, optype="continuous", dtype="double")
         for f in FIELDS]
        + [ir.DataField(name="color", optype="categorical", dtype="string",
                        values=CAT_VALUES)]
    ))
    return ir.PmmlDocument(
        version="4.3",
        header=ir.Header(),
        data_dictionary=dd,
        transformations=ir.TransformationDictionary(),
        model=model,
    )


def schema(target="y"):
    return ir.MiningSchema(fields=tuple(
        [ir.MiningField(name=target, usage_type="target")]
        + [ir.MiningField(name=f) for f in FIELDS]
        + [ir.MiningField(name="color")]
    ))


def rand_predicate(rng, depth=0):
    roll = rng.random()
    if roll < 0.45 or depth >= 2:
        op = rng.choice([
            "lessThan", "lessOrEqual", "greaterThan", "greaterOrEqual",
            "equal", "notEqual", "isMissing", "isNotMissing",
        ])
        field = str(rng.choice(FIELDS))
        value = f"{rng.normal(0, 1):.3f}"
        return ir.SimplePredicate(field=field, operator=str(op), value=value)
    if roll < 0.6:
        vals = tuple(
            str(v) for v in rng.choice(
                CAT_VALUES, size=rng.integers(1, 3), replace=False
            )
        )
        return ir.SimpleSetPredicate(
            field="color",
            boolean_operator=str(rng.choice(["isIn", "isNotIn"])),
            values=vals,
        )
    if roll < 0.7:
        return ir.TruePredicate()
    return ir.CompoundPredicate(
        boolean_operator=str(rng.choice(["and", "or", "xor"])),
        predicates=tuple(
            rand_predicate(rng, depth + 1)
            for _ in range(rng.integers(2, 4))
        ),
    )


def rand_tree(rng, classification, depth=0, max_depth=3):
    node_id = f"n{rng.integers(0, 1 << 30)}"
    rc = float(rng.integers(1, 100))
    if depth >= max_depth or rng.random() < 0.3:
        if classification:
            counts = rng.integers(1, 50, size=2)
            dist = tuple(
                ir.ScoreDistribution(value=v, record_count=float(c))
                for v, c in zip(("pos", "neg"), counts)
            )
            score = ("pos", "neg")[int(np.argmax(counts))]
            return ir.TreeNode(
                predicate=rand_predicate(rng, 1),
                score=score,
                node_id=node_id,
                record_count=rc,
                score_distribution=dist,
            )
        return ir.TreeNode(
            predicate=rand_predicate(rng, 1),
            score=f"{rng.normal(0, 5):.4f}",
            node_id=node_id,
            record_count=rc,
        )
    kids = tuple(
        rand_tree(rng, classification, depth + 1, max_depth)
        for _ in range(rng.integers(2, 4))
    )
    # defaultChild must reference a child id
    default_child = (
        kids[rng.integers(0, len(kids))].node_id
        if rng.random() < 0.8
        else None
    )
    return ir.TreeNode(
        predicate=ir.TruePredicate() if depth == 0 else rand_predicate(rng, 1),
        node_id=node_id,
        record_count=rc,
        default_child=default_child,
        children=kids,
        score=f"{rng.normal(0, 5):.4f}" if not classification else "pos",
        score_distribution=(
            (
                ir.ScoreDistribution(value="pos", record_count=3.0),
                ir.ScoreDistribution(value="neg", record_count=2.0),
            )
            if classification
            else ()
        ),
    )


def rand_tree_model(rng):
    classification = bool(rng.random() < 0.5)
    strategy = str(rng.choice([
        "none", "defaultChild", "lastPrediction", "nullPrediction",
        "weightedConfidence" if classification else "aggregateNodes",
    ]))
    return ir.TreeModelIR(
        function_name="classification" if classification else "regression",
        mining_schema=schema(),
        root=rand_tree(rng, classification),
        missing_value_strategy=strategy,
        no_true_child_strategy=str(rng.choice(
            ["returnNullPrediction", "returnLastPrediction"]
        )),
        split_characteristic="multiSplit",
    )


def rand_records(rng, n):
    recs = []
    for _ in range(n):
        rec = {}
        for f in FIELDS:
            roll = rng.random()
            if roll < 0.15:
                continue  # absent key
            if roll < 0.25:
                rec[f] = None
            elif roll < 0.3:
                rec[f] = float("nan")
            else:
                rec[f] = float(np.round(rng.normal(0, 1), 3))
        roll = rng.random()
        if roll < 0.2:
            pass  # color absent
        elif roll < 0.3:
            rec["color"] = "mauve"  # undeclared → invalid treatment
        else:
            rec["color"] = str(rng.choice(CAT_VALUES))
        recs.append(rec)
    return recs


def rand_mining_model(rng):
    n_seg = int(rng.integers(2, 5))
    segments = tuple(
        ir.Segment(
            predicate=(
                ir.TruePredicate()
                if rng.random() < 0.5
                else rand_predicate(rng, 1)
            ),
            model=ir.TreeModelIR(
                function_name="regression",
                mining_schema=schema(),
                root=rand_tree(rng, False, max_depth=2),
                missing_value_strategy=str(rng.choice(
                    ["none", "defaultChild", "nullPrediction"]
                )),
                split_characteristic="multiSplit",
            ),
            segment_id=f"s{i}",
            weight=float(np.round(rng.uniform(0.5, 2.0), 2)),
        )
        for i in range(n_seg)
    )
    method = str(rng.choice(
        ["sum", "average", "weightedAverage", "max", "median",
         "selectFirst"]
    ))
    return ir.MiningModelIR(
        function_name="regression",
        mining_schema=schema(),
        segmentation=ir.Segmentation(
            multiple_model_method=method, segments=segments
        ),
    )


def rand_regression_model(rng):
    classification = bool(rng.random() < 0.4)

    def table(target_category=None):
        nps = tuple(
            ir.NumericPredictor(
                name=str(f),
                coefficient=float(np.round(rng.normal(0, 2), 3)),
                exponent=int(rng.choice([1, 1, 1, 2])),
            )
            for f in rng.choice(FIELDS, size=rng.integers(1, 4),
                                replace=False)
        )
        cps = tuple(
            ir.CategoricalPredictor(
                name="color",
                value=str(v),
                coefficient=float(np.round(rng.normal(0, 1), 3)),
            )
            for v in rng.choice(CAT_VALUES, size=rng.integers(0, 3),
                                replace=False)
        )
        return ir.RegressionTable(
            intercept=float(np.round(rng.normal(0, 1), 3)),
            numeric_predictors=nps,
            categorical_predictors=cps,
            target_category=target_category,
        )

    if classification:
        tables = tuple(table(c) for c in ("pos", "neg"))
        return ir.RegressionModelIR(
            function_name="classification",
            mining_schema=schema(),
            tables=tables,
            normalization_method=str(rng.choice(
                ["softmax", "simplemax", "none"])),
        )
    return ir.RegressionModelIR(
        function_name="regression",
        mining_schema=schema(),
        tables=(table(),),
        normalization_method=str(rng.choice(["none", "logit", "exp"])),
    )


def rand_scorecard_model(rng):
    chars = []
    for ci in range(int(rng.integers(1, 4))):
        attrs = [
            ir.ScorecardAttribute(
                predicate=rand_predicate(rng, 1),
                partial_score=float(np.round(rng.normal(0, 20), 1)),
            )
            for _ in range(int(rng.integers(1, 4)))
        ]
        # catch-all keeps most lanes valid; drop it sometimes to
        # exercise the no-match -> empty contract
        if rng.random() < 0.8:
            attrs.append(ir.ScorecardAttribute(
                predicate=ir.TruePredicate(),
                partial_score=float(np.round(rng.normal(0, 5), 1)),
            ))
        chars.append(ir.Characteristic(
            name=f"ch{ci}", attributes=tuple(attrs)
        ))
    return ir.ScorecardIR(
        function_name="regression",
        mining_schema=schema(),
        characteristics=tuple(chars),
        initial_score=float(np.round(rng.normal(100, 20), 1)),
        use_reason_codes=False,
    )


def rand_nn_model(rng):
    """Random regression MLP: FieldRef inputs → 1-2 hidden layers →
    one output neuron mapped straight to the target."""
    acts = ["logistic", "tanh", "identity", "rectifier", "arctan",
            "cosine", "sine", "exponential", "reciprocal", "square"]
    inputs = tuple(
        ir.NeuralInput(
            neuron_id=f"in{i}",
            derived_field=ir.DerivedField(
                name=f"in{i}", optype="continuous", dtype="double",
                expression=ir.FieldRef(field=f),
            ),
        )
        for i, f in enumerate(FIELDS)
    )
    prev = [ni.neuron_id for ni in inputs]
    layers = []
    nid = 0
    for _ in range(int(rng.integers(1, 3))):
        width = int(rng.integers(2, 5))
        neurons = []
        for _ in range(width):
            neurons.append(ir.Neuron(
                neuron_id=f"h{nid}",
                bias=float(np.round(rng.normal(0, 0.5), 3)),
                weights=tuple(
                    (p, float(np.round(rng.normal(0, 1), 3)))
                    for p in prev
                ),
            ))
            nid += 1
        layers.append(ir.NeuralLayer(
            neurons=tuple(neurons),
            activation=str(rng.choice(acts)),
        ))
        prev = [n.neuron_id for n in neurons]
    out_neuron = ir.Neuron(
        neuron_id="out0",
        bias=float(np.round(rng.normal(0, 0.5), 3)),
        weights=tuple(
            (p, float(np.round(rng.normal(0, 1), 3))) for p in prev
        ),
    )
    layers.append(ir.NeuralLayer(
        neurons=(out_neuron,), activation="identity"
    ))
    outputs = (
        ir.NeuralOutput(
            output_neuron="out0",
            derived_field=ir.DerivedField(
                name="y", optype="continuous", dtype="double",
                expression=ir.FieldRef(field="y"),
            ),
        ),
    )
    return ir.NeuralNetworkIR(
        function_name="regression",
        mining_schema=schema(),
        activation_function="logistic",
        inputs=inputs,
        layers=tuple(layers),
        outputs=outputs,
    )


def rand_glm_model(rng):
    n_params = int(rng.integers(2, 5))
    params = tuple(f"p{i}" for i in range(n_params))
    pp = []
    for i, pname in enumerate(params[1:], 1):
        # each non-intercept parameter: 1-2 covariate cells and maybe a
        # factor indicator
        for f in rng.choice(FIELDS, size=rng.integers(1, 3), replace=False):
            pp.append(ir.PPCell(
                predictor=str(f), parameter=pname,
                value=str(int(rng.choice([1, 1, 2]))),
            ))
        if rng.random() < 0.4:
            pp.append(ir.PPCell(
                predictor="color", parameter=pname,
                value=str(rng.choice(CAT_VALUES)),
            ))
    p_cells = tuple(
        ir.PCell(parameter=p, beta=float(np.round(rng.normal(0, 1), 3)))
        for p in params
    )
    link = str(rng.choice(["identity", "log", "logit", "cloglog",
                           "probit", "cauchit"]))
    return ir.GeneralRegressionIR(
        function_name="regression",
        mining_schema=schema(),
        model_type="generalizedLinear",
        parameters=params,
        factors=("color",),
        covariates=FIELDS,
        pp_cells=tuple(pp),
        p_cells=p_cells,
        link_function=link,
    )


def arima_xml(body, history, constant=0.0, transformation="none",
              extra_attrs=""):
    tv = "".join(
        f'<TimeValue index="{i + 1}" value="{v}"/>'
        for i, v in enumerate(history)
    )
    return f"""<PMML version="4.4"><DataDictionary>
  <DataField name="h" optype="continuous" dataType="integer"/>
  <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <TimeSeriesModel functionName="timeSeries" bestFit="ARIMA">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="h"/></MiningSchema>
  <TimeSeries usage="original">{tv}</TimeSeries>
  <ARIMA constantTerm="{constant}" transformation="{transformation}"
      predictionMethod="conditionalLeastSquares"{extra_attrs}>
  {body}
  </ARIMA>
  </TimeSeriesModel></PMML>"""


def _arrays(ar, ma, residuals) -> list:
    parts = []
    if ar:
        parts.append(
            f'<AR><Array type="real" n="{len(ar)}">'
            + " ".join(map(str, ar)) + "</Array></AR>"
        )
    if ma or residuals:
        parts.append("<MA>")
        if ma:
            parts.append(
                f'<MACoefficients><Array type="real" n="{len(ma)}">'
                + " ".join(map(str, ma)) + "</Array></MACoefficients>"
            )
        if residuals:
            parts.append(
                f'<Residuals><Array type="real" n="{len(residuals)}">'
                + " ".join(map(str, residuals)) + "</Array></Residuals>"
            )
        parts.append("</MA>")
    return parts


def ns(p, d, q, ar=(), ma=(), residuals=()):
    return "".join(
        [f'<NonseasonalComponent p="{p}" d="{d}" q="{q}">']
        + _arrays(ar, ma, residuals) + ["</NonseasonalComponent>"])


def sc(P, D, Q, period, sar=(), sma=(), residuals=()):
    return "".join(
        [f'<SeasonalComponent P="{P}" D="{D}" Q="{Q}" period="{period}">']
        + _arrays(sar, sma, residuals) + ["</SeasonalComponent>"])


def rand_sarima_doc(rng):
    """Random SARIMA state through the full pipeline (XML → parser)."""
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    p = int(rng.integers(0, 3))
    d = int(rng.integers(0, 2))
    q = int(rng.integers(0, 3))
    s = int(rng.integers(2, 5)) if rng.random() < 0.6 else 0
    P = int(rng.integers(0, 2)) if s else 0
    D = int(rng.integers(0, 2)) if s else 0
    Q = int(rng.integers(0, 2)) if s else 0
    if s and not (P or D or Q):
        D = 1

    def coefs(n):
        return tuple(round(float(v), 3)
                     for v in rng.uniform(-0.65, 0.65, size=n))

    n_res = q + s * Q
    residuals = tuple(
        round(float(v), 3) for v in rng.normal(0, 0.4, size=n_res)
    )
    n_hist = d + s * D + (p + s * P) + int(rng.integers(8, 16))
    t = np.arange(n_hist)
    hist = tuple(
        round(float(v), 3)
        for v in 40
        + 0.8 * t
        + (4 * np.sin(2 * np.pi * t / s) if s else 0)
        + rng.normal(0, 1.0, size=n_hist)
    )
    transformation = str(
        rng.choice(("none", "none", "logarithmic", "squareroot"))
    )
    body = ns(p, d, q, ar=coefs(p), ma=coefs(q),
              residuals=residuals if n_res else ())
    if s:
        body += sc(P, D, Q, s, sar=coefs(P), sma=coefs(Q))
    return parse_pmml(arima_xml(
        body, hist,
        constant=round(float(rng.uniform(-0.5, 0.5)), 3),
        transformation=transformation,
    ))


def rand_sarima_records(rng, n=24):
    recs = []
    for _ in range(n):
        roll = rng.random()
        if roll < 0.1:
            recs.append({})
        elif roll < 0.2:
            recs.append({"h": None})
        elif roll < 0.3:
            recs.append({"h": float(rng.uniform(0.6, 20.0))})
        else:
            recs.append({"h": int(rng.integers(1, 31))})
    return recs


def close(actual: float, expected: float) -> bool:
    """``actual == pytest.approx(expected, rel=REL, abs=ABS)``."""
    if expected == actual:
        return True
    if np.isinf(expected) or np.isnan(expected) or np.isnan(actual):
        return False
    return abs(actual - expected) <= max(REL * abs(expected), ABS)


def assert_parity(doc, recs, where: str, device) -> float:
    """Compile ``doc`` on ``device``, score ``recs``, and hold every lane
    to the oracle (module docstring) → the largest absolute value error
    of the lanes compared (0.0 when none carried a value)."""
    from flink_jpmml_tpu_torch.compile import compile_pmml

    cm = compile_pmml(doc, device=device)
    preds = cm.score_records(recs)
    worst = 0.0
    for i, (rec, p) in enumerate(zip(recs, preds)):
        o = evaluate(doc, rec)
        ctx = f"{where} record {i}: {rec!r}"
        if o.is_missing:
            assert p.is_empty, f"{ctx}: oracle empty, compiled {p!r}"
            continue
        assert not p.is_empty, f"{ctx}: compiled empty, oracle {o!r}"
        if o.label is not None:
            assert p.target.label == o.label, (
                f"{ctx}: label {p.target.label!r} != {o.label!r}"
            )
        if o.value is not None:
            got = p.score.value
            if abs(o.value) > F32_MAX:
                # beyond float32 range: the compiled engine represents
                # it as same-signed inf (or the nearest huge finite
                # value when rounding kept it in range)
                assert (
                    np.isinf(got) or abs(got) > 3.3e38
                ) and np.sign(got) == np.sign(o.value), (
                    f"{ctx}: f32-overflow {got!r} vs {o.value!r}"
                )
                continue
            assert close(got, o.value), (
                f"{ctx}: value {got!r} != {o.value!r}"
            )
            worst = max(worst, abs(got - o.value))
    return worst
