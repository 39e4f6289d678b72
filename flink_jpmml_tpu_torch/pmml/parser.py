"""PMML 4.x XML → typed IR parser.

A copy of ``flink_jpmml_tpu/pmml/parser.py``, kept so that the PyTorch port imports
nothing of the JAX package; the two must parse and prepare alike
(tests/test_torch_frontend.py).

Replaces the reference's ``ModelReader``'s JAXB unmarshalling + version gate
(SURVEY.md §3 row B3: expected upstream ``…/api/reader/ModelReader.scala``
[UNVERIFIED]; supported versions 4.0–4.3-era per SURVEY.md §1 C1 — we gate
4.0–4.4). Namespace-agnostic: PMML documents declare per-version namespaces
(``http://www.dmg.org/PMML-4_2`` …); we strip them and dispatch on local
names, which is what makes one parser cover all 4.x minor versions.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Optional, Sequence, Tuple

from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import (
    ModelLoadingException,
    UnsupportedPmmlVersionException,
)

SUPPORTED_VERSIONS = ("4.0", "4.1", "4.2", "4.3", "4.4")

_MODEL_TAGS = (
    "TreeModel",
    "RegressionModel",
    "NeuralNetwork",
    "ClusteringModel",
    "Scorecard",
    "RuleSetModel",
    "GeneralRegressionModel",
    "NaiveBayesModel",
    "SupportVectorMachineModel",
    "NearestNeighborModel",
    "AnomalyDetectionModel",
    "GaussianProcessModel",
    "BaselineModel",
    "AssociationModel",
    "TimeSeriesModel",
    "BayesianNetworkModel",
    "TextModel",
    "MiningModel",
)


def _local(tag: str) -> str:
    """Strip ``{namespace}`` prefix from an element tag."""
    return tag.rsplit("}", 1)[-1]


def _children(elem: ET.Element, name: str) -> list[ET.Element]:
    return [c for c in elem if _local(c.tag) == name]


def _child(elem: ET.Element, name: str) -> Optional[ET.Element]:
    for c in elem:
        if _local(c.tag) == name:
            return c
    return None


def _req_child(elem: ET.Element, name: str) -> ET.Element:
    c = _child(elem, name)
    if c is None:
        raise ModelLoadingException(
            f"<{_local(elem.tag)}> is missing required child <{name}>"
        )
    return c


def _float(elem: ET.Element, attr: str, default: Optional[float] = None) -> float:
    raw = elem.get(attr)
    if raw is None:
        if default is None:
            raise ModelLoadingException(
                f"<{_local(elem.tag)}> is missing required attribute {attr!r}"
            )
        return default
    try:
        return float(raw)
    except ValueError as e:
        raise ModelLoadingException(
            f"<{_local(elem.tag)}> attribute {attr}={raw!r} is not a number"
        ) from e


def _opt_float(elem: ET.Element, attr: str) -> Optional[float]:
    """Optional numeric attribute: absent → None, present-but-garbage → raise."""
    if elem.get(attr) is None:
        return None
    return _float(elem, attr)


def _int(elem: ET.Element, attr: str, default: Optional[int] = None) -> int:
    """INT-NUMBER attribute: typed rejection for garbage, NaN/inf AND
    non-integer values (silently truncating "3.9" would score with a
    different k than a conforming evaluator)."""
    v = _float(elem, attr, None if default is None else float(default))
    import math as _math

    if not _math.isfinite(v) or v != int(v):
        raise ModelLoadingException(
            f"<{_local(elem.tag)}> attribute {attr}={elem.get(attr)!r} is "
            "not an integer"
        )
    return int(v)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def parse_pmml(xml_text: str) -> ir.PmmlDocument:
    """Parse a PMML document string into the typed IR (capability C1)."""
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError as e:
        raise ModelLoadingException(f"malformed PMML XML: {e}") from e
    if _local(root.tag) != "PMML":
        raise ModelLoadingException(
            f"root element is <{_local(root.tag)}>, expected <PMML>"
        )

    version = root.get("version", "")
    if version not in SUPPORTED_VERSIONS:
        raise UnsupportedPmmlVersionException(
            f"PMML version {version!r} is not supported "
            f"(supported: {', '.join(SUPPORTED_VERSIONS)})"
        )

    header = _parse_header(_child(root, "Header"))
    dd_elem = _req_child(root, "DataDictionary")
    data_dictionary = _parse_data_dictionary(dd_elem)
    transformations, user_fns = _parse_transformation_dictionary(
        _child(root, "TransformationDictionary")
    )

    model_elem = None
    for c in root:
        if _local(c.tag) in _MODEL_TAGS:
            model_elem = c
            break
    if model_elem is None:
        raise ModelLoadingException(
            f"no supported model element found (supported: {', '.join(_MODEL_TAGS)})"
        )

    model = _parse_model(model_elem)
    model = _resolve_glm_reference(model, data_dictionary)
    # the top-level model's LocalTransformations extend the
    # TransformationDictionary chain (TD fields first, so LT fields may
    # reference them; both may call TD-defined functions). Segment-
    # nested LocalTransformations are rejected in _parse_mining_model.
    lt = _child(model_elem, "LocalTransformations")
    if lt is not None:
        local_dfs = tuple(
            _expand_derived_field(_parse_derived_field(df), user_fns)
            for df in _children(lt, "DerivedField")
        )
        transformations = ir.TransformationDictionary(
            derived_fields=transformations.derived_fields + local_dfs
        )
    targets = _parse_targets(_child(model_elem, "Targets"))
    output_fields = _parse_output(_child(model_elem, "Output"))
    verification = _parse_model_verification(
        _child(model_elem, "ModelVerification")
    )
    return ir.PmmlDocument(
        version=version,
        header=header,
        data_dictionary=data_dictionary,
        transformations=transformations,
        model=model,
        targets=targets,
        output_fields=output_fields,
        verification=verification,
    )


def _resolve_glm_reference(model, dd: ir.DataDictionary):
    """multinomialLogistic without targetReferenceCategory: resolve it to
    the target DataField's last declared value (the R multinom
    convention) once at parse time, so the oracle and the lowering read
    the same resolved attribute. Recurses into MiningModel segments."""
    import dataclasses

    if isinstance(model, ir.MiningModelIR):
        seg = model.segmentation
        if seg is None:
            return model
        new_segs = tuple(
            dataclasses.replace(
                s, model=_resolve_glm_reference(s.model, dd)
            )
            for s in seg.segments
        )
        if all(a.model is b.model for a, b in zip(new_segs, seg.segments)):
            return model
        return dataclasses.replace(
            model,
            segmentation=dataclasses.replace(seg, segments=new_segs),
        )
    if not isinstance(model, ir.GeneralRegressionIR):
        return model
    if model.model_type == "ordinalMultinomial":
        # the cumulative-link model needs the target's ORDERED category
        # list; the declared DataField order carries the ordinality
        target = model.mining_schema.target_field
        if target is not None and target in dd:
            values = dd.field(target).values
            if len(values) >= 2:
                return dataclasses.replace(
                    model, target_categories=tuple(values)
                )
        raise ModelLoadingException(
            "ordinalMultinomial needs a target DataField with >= 2 "
            "declared values (their order defines the ordinal scale)"
        )
    if (
        model.model_type != "multinomialLogistic"
        or model.target_reference_category is not None
    ):
        return model
    target = model.mining_schema.target_field
    if target is not None and target in dd:
        values = dd.field(target).values
        if values:
            return dataclasses.replace(
                model, target_reference_category=values[-1]
            )
    raise ModelLoadingException(
        "multinomialLogistic needs targetReferenceCategory or a target "
        "DataField with declared values"
    )


def _parse_output(out_elem: Optional[ET.Element]) -> tuple:
    """Top-level <Output>: predictedValue / probability / transformedValue
    (whose expression child may reference previously declared output
    fields)."""
    if out_elem is None:
        return ()
    out = []
    for of in _children(out_elem, "OutputField"):
        feature = of.get("feature", "predictedValue")
        expr = None
        if feature == "transformedValue":
            for c in of:
                parsed = _try_parse_expression(c)
                if parsed is not None:
                    expr = parsed
                    break
            if expr is None:
                raise ModelLoadingException(
                    f"OutputField {of.get('name')!r}: transformedValue "
                    "needs an expression child"
                )
        out.append(
            ir.OutputField(
                name=of.get("name", ""),
                feature=feature,
                target_value=of.get("value"),
                expression=expr,
                rank=int(of.get("rank", 1)),
                rule_feature=(
                    of.get("ruleFeature", "consequent")
                    if feature == "ruleValue"
                    else None
                ),
            )
        )
    return tuple(out)


def _parse_model_verification(
    elem: Optional[ET.Element],
) -> Optional[ir.ModelVerification]:
    if elem is None:
        return None
    vf = _child(elem, "VerificationFields")
    if vf is None:
        raise ModelLoadingException(
            "ModelVerification has no VerificationFields"
        )
    fields = []
    for f in _children(vf, "VerificationField"):
        name = f.get("field")
        if not name:
            raise ModelLoadingException("VerificationField needs a field")
        fields.append(ir.VerificationField(
            field=name,
            # the column attribute may carry a namespace prefix
            # ("data:x1"); the row cells are matched by local name
            column=(f.get("column") or name).split(":")[-1],
            precision=_opt_float(f, "precision"),
            zero_threshold=_opt_float(f, "zeroThreshold"),
        ))
    if not fields:
        raise ModelLoadingException(
            "VerificationFields has no VerificationField entries"
        )
    table = _child(elem, "InlineTable")
    if table is None:
        raise ModelLoadingException(
            "ModelVerification needs an InlineTable"
        )
    records = tuple(
        tuple(
            (_local(c.tag), (c.text or "").strip()) for c in row
        )
        for row in _children(table, "row")
    )
    if not records:
        raise ModelLoadingException(
            "ModelVerification InlineTable has no rows"
        )
    return ir.ModelVerification(fields=tuple(fields), records=records)


def parse_pmml_file(path: str) -> ir.PmmlDocument:
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        raise ModelLoadingException(f"cannot read PMML at {path!r}: {e}") from e
    return parse_pmml(text)


# ---------------------------------------------------------------------------
# Dictionaries / schemas / transformations
# ---------------------------------------------------------------------------


def _parse_header(elem: Optional[ET.Element]) -> ir.Header:
    if elem is None:
        return ir.Header()
    app = _child(elem, "Application")
    return ir.Header(
        description=elem.get("description"),
        application=app.get("name") if app is not None else None,
    )


def _parse_data_dictionary(elem: ET.Element) -> ir.DataDictionary:
    fields = []
    for df in _children(elem, "DataField"):
        values = tuple(
            v.get("value", "") for v in _children(df, "Value")
            if v.get("property", "valid") == "valid"
        )
        intervals = []
        for iv in _children(df, "Interval"):
            left = iv.get("leftMargin")
            right = iv.get("rightMargin")
            intervals.append(
                ir.Interval(
                    closure=iv.get("closure", "closedClosed"),
                    left=float(left) if left is not None else None,
                    right=float(right) if right is not None else None,
                )
            )
        fields.append(
            ir.DataField(
                name=df.get("name", ""),
                optype=df.get("optype", "continuous"),
                dtype=df.get("dataType", "double"),
                values=values,
                intervals=tuple(intervals),
            )
        )
    return ir.DataDictionary(fields=tuple(fields))


def _parse_mining_schema(elem: ET.Element) -> ir.MiningSchema:
    ms = _req_child(elem, "MiningSchema")
    fields = []
    for mf in _children(ms, "MiningField"):
        fields.append(
            ir.MiningField(
                name=mf.get("name", ""),
                usage_type=mf.get("usageType", "active"),
                missing_value_replacement=mf.get("missingValueReplacement"),
                invalid_value_treatment=mf.get("invalidValueTreatment", "returnInvalid"),
                invalid_value_replacement=mf.get("invalidValueReplacement"),
            )
        )
    return ir.MiningSchema(fields=tuple(fields))


def _parse_transformation_dictionary(elem: Optional[ET.Element]):
    """→ (TransformationDictionary, user-function table for reuse by
    the model's LocalTransformations)."""
    if elem is None:
        return ir.TransformationDictionary(), {}
    # DefineFunctions expand at parse time: every Apply of a user
    # function inlines the (already-expanded) body with ParameterFields
    # substituted by the argument expressions — downstream (oracle and
    # lowering) only ever sees built-ins. Non-recursive by construction:
    # a body can only call functions defined before it.
    fns: dict = {}
    for df in _children(elem, "DefineFunction"):
        name = df.get("name")
        if not name:
            raise ModelLoadingException("DefineFunction needs a name")
        params = [
            pf.get("name", "")
            for pf in _children(df, "ParameterField")
        ]
        body = None
        for c in df:
            if _local(c.tag) == "ParameterField":
                continue
            body = _try_parse_expression(c)
            if body is not None:
                break
        if body is None:
            raise ModelLoadingException(
                f"DefineFunction {name!r} has no supported expression body"
            )
        fns[name] = (tuple(params), _expand_user_fns(body, fns))
    dfs = tuple(
        _expand_derived_field(_parse_derived_field(df), fns)
        for df in _children(elem, "DerivedField")
    )
    return ir.TransformationDictionary(derived_fields=dfs), fns


def _expand_derived_field(df: ir.DerivedField, fns: dict) -> ir.DerivedField:
    import dataclasses

    if not fns:
        return df
    return dataclasses.replace(
        df, expression=_expand_user_fns(df.expression, fns)
    )


def _expand_user_fns(expr: ir.Expression, fns: dict) -> ir.Expression:
    """Inline user-function Applies (bodies are pre-expanded)."""
    import dataclasses

    if isinstance(expr, ir.Apply):
        args = tuple(_expand_user_fns(a, fns) for a in expr.args)
        if expr.function in fns:
            params, body = fns[expr.function]
            if len(args) != len(params):
                raise ModelLoadingException(
                    f"function {expr.function!r} takes {len(params)} "
                    f"argument(s), got {len(args)}"
                )
            out = _substitute_params(body, dict(zip(params, args)))
            if expr.map_missing_to is not None:
                # the call site's mapMissingTo fires when the *function
                # result* is missing: wrap the inlined body in a no-op
                # Apply that carries it (never clobber the body's own)
                out = ir.Apply(
                    function="+",
                    args=(out, ir.Constant(0.0)),
                    map_missing_to=expr.map_missing_to,
                )
            return out
        return dataclasses.replace(expr, args=args)
    return expr


def _substitute_params(
    expr: ir.Expression, sub: dict
) -> ir.Expression:
    """ParameterField references (FieldRefs by name) → argument exprs."""
    import dataclasses

    if isinstance(expr, ir.FieldRef):
        return sub.get(expr.field, expr)
    if isinstance(expr, ir.Apply):
        return dataclasses.replace(
            expr,
            args=tuple(_substitute_params(a, sub) for a in expr.args),
        )
    if isinstance(expr, (ir.NormContinuous, ir.NormDiscrete)):
        if expr.field in sub:
            arg = sub[expr.field]
            if not isinstance(arg, ir.FieldRef):
                raise ModelLoadingException(
                    "a ParameterField used as a Norm* field must be "
                    "bound to a FieldRef argument"
                )
            return dataclasses.replace(expr, field=arg.field)
        return expr
    return expr


def _parse_derived_field(elem: ET.Element) -> ir.DerivedField:
    expr = None
    for c in elem:
        parsed = _try_parse_expression(c)
        if parsed is not None:
            expr = parsed
            break
    if expr is None:
        raise ModelLoadingException(
            f"DerivedField {elem.get('name')!r} has no supported expression"
        )
    return ir.DerivedField(
        name=elem.get("name", ""),
        optype=elem.get("optype", "continuous"),
        dtype=elem.get("dataType", "double"),
        expression=expr,
    )


def _try_parse_expression(elem: ET.Element) -> Optional[ir.Expression]:
    tag = _local(elem.tag)
    if tag == "FieldRef":
        return ir.FieldRef(field=elem.get("field", ""))
    if tag == "Constant":
        try:
            return ir.Constant(value=float(elem.text or "0"))
        except ValueError as e:
            raise ModelLoadingException(
                f"non-numeric <Constant>{elem.text}</Constant>"
            ) from e
    if tag == "NormContinuous":
        norms = tuple(
            ir.LinearNorm(orig=_float(n, "orig"), norm=_float(n, "norm"))
            for n in _children(elem, "LinearNorm")
        )
        if len(norms) < 2:
            raise ModelLoadingException(
                "NormContinuous requires at least two LinearNorm points"
            )
        return ir.NormContinuous(
            field=elem.get("field", ""),
            norms=norms,
            outliers=elem.get("outliers", "asIs"),
            map_missing_to=_opt_float(elem, "mapMissingTo"),
        )
    if tag == "NormDiscrete":
        return ir.NormDiscrete(
            field=elem.get("field", ""),
            value=elem.get("value", ""),
            map_missing_to=_opt_float(elem, "mapMissingTo"),
        )
    if tag == "Apply":
        args = []
        for c in elem:
            if _local(c.tag) == "Extension":
                continue
            parsed = _try_parse_expression(c)
            if parsed is None:
                raise ModelLoadingException(
                    f"unsupported expression <{_local(c.tag)}> inside <Apply "
                    f"function={elem.get('function')!r}>"
                )
            args.append(parsed)
        return ir.Apply(
            function=elem.get("function", ""),
            args=tuple(args),
            map_missing_to=_opt_float(elem, "mapMissingTo"),
        )
    return None


def _parse_targets(elem: Optional[ET.Element]) -> Tuple[ir.Target, ...]:
    if elem is None:
        return ()
    out = []
    for t in _children(elem, "Target"):
        out.append(
            ir.Target(
                field=t.get("field"),
                rescale_constant=_float(t, "rescaleConstant", 0.0),
                rescale_factor=_float(t, "rescaleFactor", 1.0),
                cast_integer=t.get("castInteger"),
            )
        )
    return tuple(out)


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------

_PREDICATE_TAGS = (
    "SimplePredicate",
    "SimpleSetPredicate",
    "CompoundPredicate",
    "True",
    "False",
)


def _parse_predicate(elem: ET.Element) -> ir.Predicate:
    tag = _local(elem.tag)
    if tag == "SimplePredicate":
        op = elem.get("operator", "")
        value = elem.get("value")
        if op not in (
            "equal",
            "notEqual",
            "lessThan",
            "lessOrEqual",
            "greaterThan",
            "greaterOrEqual",
            "isMissing",
            "isNotMissing",
        ):
            raise ModelLoadingException(f"unsupported SimplePredicate operator {op!r}")
        if op not in ("isMissing", "isNotMissing") and value is None:
            raise ModelLoadingException(
                f"SimplePredicate {op} on {elem.get('field')!r} has no value"
            )
        return ir.SimplePredicate(field=elem.get("field", ""), operator=op, value=value)
    if tag == "SimpleSetPredicate":
        arr = _req_child(elem, "Array")
        return ir.SimpleSetPredicate(
            field=elem.get("field", ""),
            boolean_operator=elem.get("booleanOperator", "isIn"),
            values=tuple(_parse_string_array(arr)),
        )
    if tag == "CompoundPredicate":
        preds = tuple(
            _parse_predicate(c) for c in elem if _local(c.tag) in _PREDICATE_TAGS
        )
        return ir.CompoundPredicate(
            boolean_operator=elem.get("booleanOperator", "and"), predicates=preds
        )
    if tag == "True":
        return ir.TruePredicate()
    if tag == "False":
        return ir.FalsePredicate()
    raise ModelLoadingException(f"unsupported predicate element <{tag}>")


def _find_predicate(elem: ET.Element) -> ir.Predicate:
    for c in elem:
        if _local(c.tag) in _PREDICATE_TAGS:
            return _parse_predicate(c)
    raise ModelLoadingException(f"<{_local(elem.tag)}> has no predicate child")


def _parse_string_array(arr: ET.Element) -> list[str]:
    """PMML <Array> holds space-separated tokens; quoted tokens may hold spaces."""
    text = (arr.text or "").strip()
    out: list[str] = []
    i = 0
    while i < len(text):
        if text[i].isspace():
            i += 1
            continue
        if text[i] == '"':
            j = i + 1
            buf = []
            while j < len(text) and text[j] != '"':
                if text[j] == "\\" and j + 1 < len(text) and text[j + 1] == '"':
                    buf.append('"')
                    j += 2
                    continue
                buf.append(text[j])
                j += 1
            out.append("".join(buf))
            i = j + 1
        else:
            j = i
            while j < len(text) and not text[j].isspace():
                j += 1
            out.append(text[i:j])
            i = j
    return out


def _parse_real_array(arr: ET.Element) -> Tuple[float, ...]:
    try:
        return tuple(float(tok) for tok in (arr.text or "").split())
    except ValueError as e:
        raise ModelLoadingException(f"non-numeric token in <Array>: {e}") from e


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def _parse_model(elem: ET.Element) -> ir.ModelIR:
    tag = _local(elem.tag)
    if tag == "TreeModel":
        return _parse_tree_model(elem)
    if tag == "RegressionModel":
        return _parse_regression_model(elem)
    if tag == "NeuralNetwork":
        return _parse_neural_network(elem)
    if tag == "ClusteringModel":
        return _parse_clustering_model(elem)
    if tag == "Scorecard":
        return _parse_scorecard(elem)
    if tag == "RuleSetModel":
        return _parse_ruleset_model(elem)
    if tag == "GeneralRegressionModel":
        return _parse_general_regression(elem)
    if tag == "NaiveBayesModel":
        return _parse_naive_bayes(elem)
    if tag == "SupportVectorMachineModel":
        return _parse_svm(elem)
    if tag == "NearestNeighborModel":
        return _parse_nearest_neighbor(elem)
    if tag == "AnomalyDetectionModel":
        return _parse_anomaly_detection(elem)
    if tag == "GaussianProcessModel":
        return _parse_gaussian_process(elem)
    if tag == "BaselineModel":
        return _parse_baseline(elem)
    if tag == "AssociationModel":
        return _parse_association(elem)
    if tag == "TimeSeriesModel":
        return _parse_time_series(elem)
    if tag == "BayesianNetworkModel":
        return _parse_bayesian_network(elem)
    if tag == "TextModel":
        return _parse_text_model(elem)
    if tag == "MiningModel":
        return _parse_mining_model(elem)
    raise ModelLoadingException(f"unsupported model element <{tag}>")


_TEXT_LOCAL = (
    "termFrequency", "binary", "logarithmic",
    "augmentedNormalizedTermFrequency",
)
_TEXT_GLOBAL = ("none", "inverseDocumentFrequency")


def _parse_text_model(elem: ET.Element) -> ir.TextModelIR:
    schema = _parse_mining_schema(elem)
    td = _child(elem, "TextDictionary")
    if td is None:
        raise ModelLoadingException("TextModel has no TextDictionary")
    arr = _child(td, "Array")
    if arr is None:
        raise ModelLoadingException("TextDictionary needs an Array of terms")
    terms = tuple(_parse_string_array(arr))
    if not terms:
        raise ModelLoadingException("TextDictionary is empty")
    corpus = _child(elem, "TextCorpus")
    if corpus is None:
        raise ModelLoadingException("TextModel has no TextCorpus")
    doc_ids = tuple(
        d.get("id") or d.get("name") or f"doc{i}"
        for i, d in enumerate(_children(corpus, "TextDocument"))
    )
    if not doc_ids:
        raise ModelLoadingException("TextCorpus has no TextDocument entries")
    if len(set(doc_ids)) != len(doc_ids):
        # duplicate ids would collapse in the oracle's per-id score map
        # while the compiled path keeps every row — reject up front
        raise ModelLoadingException("TextCorpus has duplicate document ids")
    dtm_elem = _child(elem, "DocumentTermMatrix")
    if dtm_elem is None:
        raise ModelLoadingException("TextModel has no DocumentTermMatrix")
    matrix = _child(dtm_elem, "Matrix")
    if matrix is None:
        raise ModelLoadingException("DocumentTermMatrix needs a Matrix")
    rows = tuple(
        _parse_real_array(a) for a in _children(matrix, "Array")
    )
    if len(rows) != len(doc_ids) or any(len(r) != len(terms) for r in rows):
        raise ModelLoadingException(
            f"DocumentTermMatrix shape {len(rows)}x"
            f"{len(rows[0]) if rows else 0} != documents x terms "
            f"{len(doc_ids)}x{len(terms)}"
        )
    local = "termFrequency"
    global_w = "none"
    doc_norm = "none"
    norm = _child(elem, "TextModelNormalization")
    if norm is not None:
        local = norm.get("localTermWeights", "termFrequency")
        global_w = norm.get("globalTermWeights", "none")
        doc_norm = norm.get("documentNormalization", "none")
        if local not in _TEXT_LOCAL:
            raise ModelLoadingException(
                f"unsupported localTermWeights {local!r}"
            )
        if global_w not in _TEXT_GLOBAL:
            raise ModelLoadingException(
                f"unsupported globalTermWeights {global_w!r}"
            )
        if doc_norm not in ("none", "cosine"):
            raise ModelLoadingException(
                f"unsupported documentNormalization {doc_norm!r}"
            )
    sim = "cosine"
    sim_elem = _child(elem, "TextModelSimilarity")
    if sim_elem is not None:
        sim = sim_elem.get("similarityType", "cosine")
        if sim not in ("cosine", "euclidean"):
            raise ModelLoadingException(
                f"unsupported similarityType {sim!r}"
            )
    # streaming contract: every term is an active field (term counts)
    missing = [t for t in terms if t not in schema.active_fields]
    if missing:
        raise ModelLoadingException(
            "TextModel terms must each be an active MiningField (term-"
            f"count contract); missing: {missing[:5]}"
        )
    return ir.TextModelIR(
        function_name=elem.get("functionName", "classification"),
        mining_schema=schema,
        terms=terms,
        doc_ids=doc_ids,
        dtm=rows,
        local_weight=local,
        global_weight=global_w,
        doc_normalization=doc_norm,
        similarity=sim,
        model_name=elem.get("modelName"),
    )


def _parse_bayesian_network(elem: ET.Element) -> ir.BayesianNetworkIR:
    schema = _parse_mining_schema(elem)
    target = schema.target_field
    if target is None:
        raise ModelLoadingException(
            "BayesianNetworkModel needs a target MiningField"
        )
    nodes_elem = _child(elem, "BayesianNetworkNodes")
    if nodes_elem is None:
        raise ModelLoadingException(
            "BayesianNetworkModel has no BayesianNetworkNodes"
        )
    nodes = []
    for ne in _children(nodes_elem, "DiscreteNode"):
        name = ne.get("name")
        if not name:
            raise ModelLoadingException("DiscreteNode needs a name")
        rows = []
        parents: Tuple[str, ...] = ()
        root_probs = []
        for c in ne:
            tag = _local(c.tag)
            if tag == "ValueProbability":  # root-node shorthand
                root_probs.append(
                    (c.get("value", ""), _float(c, "probability"))
                )
            elif tag == "DiscreteConditionalProbability":
                config = tuple(
                    (pv.get("parent", ""), pv.get("value", ""))
                    for pv in _children(c, "ParentValue")
                )
                row_parents = tuple(p for p, _ in config)
                if not parents:
                    parents = row_parents
                elif parents != row_parents:
                    raise ModelLoadingException(
                        f"DiscreteNode {name!r}: inconsistent ParentValue "
                        "ordering across rows"
                    )
                probs = tuple(
                    (vp.get("value", ""), _float(vp, "probability"))
                    for vp in _children(c, "ValueProbability")
                )
                rows.append((tuple(v for _, v in config), probs))
        if root_probs:
            if rows:
                raise ModelLoadingException(
                    f"DiscreteNode {name!r}: mixing root ValueProbability "
                    "with conditional rows"
                )
            rows = [((), tuple(root_probs))]
        if not rows:
            raise ModelLoadingException(
                f"DiscreteNode {name!r} has no probability rows"
            )
        values = tuple(v for v, _ in rows[0][1])
        if len(set(values)) != len(values) or not values:
            raise ModelLoadingException(
                f"DiscreteNode {name!r}: duplicate or empty value list"
            )
        cpt = []
        for config, probs in rows:
            if tuple(v for v, _ in probs) != values:
                raise ModelLoadingException(
                    f"DiscreteNode {name!r}: rows disagree on the value "
                    "list/order"
                )
            p = tuple(pr for _, pr in probs)
            if any(x < 0 for x in p):
                raise ModelLoadingException(
                    f"DiscreteNode {name!r}: negative probability"
                )
            cpt.append((config, p))
        nodes.append(ir.BnNode(
            name=name, values=values, parents=parents, cpt=tuple(cpt)
        ))
    if not nodes:
        raise ModelLoadingException("BayesianNetworkNodes has no nodes")
    by_name = {n.name: n for n in nodes}
    if target not in by_name:
        raise ModelLoadingException(
            f"target {target!r} is not a declared DiscreteNode"
        )
    for n in nodes:
        for p in n.parents:
            if p not in by_name:
                raise ModelLoadingException(
                    f"DiscreteNode {n.name!r}: unknown parent {p!r}"
                )
    # fully-observed contract: every non-target node is an active field
    observed = set(schema.active_fields)
    unobserved = [
        n.name for n in nodes if n.name != target and n.name not in observed
    ]
    if unobserved:
        raise ModelLoadingException(
            "BayesianNetworkModel requires every non-target node to be an "
            f"active MiningField (fully-observed contract); hidden: "
            f"{unobserved[:5]} — marginalizing hidden nodes is not "
            "supported"
        )
    return ir.BayesianNetworkIR(
        function_name=elem.get("functionName", "classification"),
        mining_schema=schema,
        nodes=tuple(nodes),
        target=target,
        model_name=elem.get("modelName"),
    )


def _parse_arima_poly(comp: ET.Element, tag_n: str, order: int, what: str):
    """<AR>/<MA> coefficient arrays of a (non)seasonal component →
    (coeffs tuple, residuals tuple | None)."""
    coeffs: Tuple[float, ...] = ()
    residuals = None
    if tag_n == "AR":
        node = _child(comp, "AR")
        if node is not None:
            arr = _child(node, "Array")
            if arr is None:
                raise ModelLoadingException(f"{what} AR needs an Array")
            coeffs = _parse_real_array(arr)
    else:
        node = _child(comp, "MA")
        if node is not None:
            mac = _child(node, "MACoefficients")
            if mac is not None:
                arr = _child(mac, "Array")
                if arr is None:
                    raise ModelLoadingException(
                        f"{what} MACoefficients needs an Array"
                    )
                coeffs = _parse_real_array(arr)
            res = _child(node, "Residuals")
            if res is not None:
                arr = _child(res, "Array")
                if arr is None:
                    raise ModelLoadingException(
                        f"{what} Residuals needs an Array"
                    )
                residuals = _parse_real_array(arr)
    if len(coeffs) != order:
        raise ModelLoadingException(
            f"{what} {tag_n} has {len(coeffs)} coefficients, order says "
            f"{order}"
        )
    return coeffs, residuals


def _parse_arima(elem: ET.Element, model_elem: ET.Element) -> ir.ArimaIR:
    """PMML 4.4 <ARIMA>: conditional-least-squares forecast state."""
    method = elem.get("predictionMethod", "conditionalLeastSquares")
    if method != "conditionalLeastSquares":
        raise ModelLoadingException(
            f"unsupported ARIMA predictionMethod {method!r} "
            "(supported: conditionalLeastSquares)"
        )
    if _child(elem, "DynamicRegressor") is not None:
        raise ModelLoadingException(
            "ARIMA DynamicRegressor terms are not supported"
        )
    transformation = elem.get("transformation", "none")
    if transformation not in ("none", "logarithmic", "squareroot"):
        raise ModelLoadingException(
            f"unsupported ARIMA transformation {transformation!r}"
        )
    constant = _float(elem, "constantTerm", 0.0)

    p = d = q = 0
    ar: Tuple[float, ...] = ()
    ma: Tuple[float, ...] = ()
    residuals: Tuple[float, ...] = ()
    ns = _child(elem, "NonseasonalComponent")
    if ns is not None:
        p, d, q = _int(ns, "p", 0), _int(ns, "d", 0), _int(ns, "q", 0)
        ar, _ = _parse_arima_poly(ns, "AR", p, "NonseasonalComponent")
        ma, res = _parse_arima_poly(ns, "MA", q, "NonseasonalComponent")
        if res is not None:
            residuals = res

    sp = sd = sq = 0
    period = 0
    sar: Tuple[float, ...] = ()
    sma: Tuple[float, ...] = ()
    sc = _child(elem, "SeasonalComponent")
    if sc is not None:
        sp, sd, sq = _int(sc, "P", 0), _int(sc, "D", 0), _int(sc, "Q", 0)
        period = _int(sc, "period")
        if period < 2:
            raise ModelLoadingException(
                f"SeasonalComponent period must be >= 2, got {period}"
            )
        sar, _ = _parse_arima_poly(sc, "AR", sp, "SeasonalComponent")
        sma, sres = _parse_arima_poly(sc, "MA", sq, "SeasonalComponent")
        if sres is not None:
            # there is ONE residual history; each component may carry a
            # trailing window of it sized to its own MA reach. Consistent
            # = the shorter array is a suffix of the longer; anything
            # else means the two windows disagree on shared positions,
            # and silently picking one would forecast from an arbitrary
            # history — fail loudly instead.
            short, long_ = sorted(
                (tuple(residuals), tuple(sres)), key=len
            )
            if residuals and short != long_[len(long_) - len(short):]:
                raise ModelLoadingException(
                    "NonseasonalComponent.MA and SeasonalComponent.MA "
                    "both carry <Residuals> that disagree on their "
                    f"overlap ({residuals!r} vs {sres!r}); the residual "
                    "history is ambiguous"
                )
            residuals = long_

    # the observed series rides the TimeSeriesModel's <TimeSeries>
    ts = _child(model_elem, "TimeSeries")
    history: Tuple[float, ...] = ()
    if ts is not None:
        vals = []
        for tv in ts:
            if _local(tv.tag) == "TimeValue":
                v = tv.get("value")
                if v is None:
                    raise ModelLoadingException("TimeValue needs a value")
                vals.append(float(v))
        history = tuple(vals)

    a = ir.ArimaIR(
        constant=constant,
        transformation=transformation,
        p=p, d=d, q=q, ar=ar, ma=ma, residuals=residuals,
        sp=sp, sd=sd, sq=sq, period=period, sar=sar, sma=sma,
        history=history,
    )
    _validate_arima(a)
    return a


def _validate_arima(a: "ir.ArimaIR") -> None:
    s = a.period
    max_ar = (a.p + s * a.sp) if (a.ar or a.sar) else 0
    max_ma = (a.q + s * a.sq) if (a.ma or a.sma) else 0
    n_w = len(a.history) - a.d - s * a.sd
    if max_ar > 0 or a.d > 0 or a.sd > 0:
        if not a.history:
            raise ModelLoadingException(
                "ARIMA with AR or differencing terms needs the observed "
                "series (<TimeSeries> with TimeValue elements)"
            )
        if n_w < max_ar:
            raise ModelLoadingException(
                f"ARIMA history too short: {len(a.history)} observations "
                f"leave {n_w} differenced values, AR terms need {max_ar}"
            )
    if max_ma > 0 and len(a.residuals) < max_ma:
        raise ModelLoadingException(
            f"ARIMA MA terms reach back {max_ma} steps but only "
            f"{len(a.residuals)} residuals are present"
        )
    if a.transformation == "logarithmic" and any(
        v <= 0.0 for v in a.history
    ):
        raise ModelLoadingException(
            "logarithmic ARIMA transformation needs a positive series"
        )
    if a.transformation == "squareroot" and any(
        v < 0.0 for v in a.history
    ):
        raise ModelLoadingException(
            "squareroot ARIMA transformation needs a non-negative series"
        )


def _parse_time_series(elem: ET.Element) -> ir.TimeSeriesIR:
    best_fit = elem.get("bestFit", "ExponentialSmoothing")
    if best_fit == "ARIMA":
        arima_el = _child(elem, "ARIMA")
        if arima_el is None:
            raise ModelLoadingException(
                "TimeSeriesModel bestFit=ARIMA has no ARIMA element"
            )
        schema = _parse_mining_schema(elem)
        if not schema.active_fields:
            raise ModelLoadingException(
                "TimeSeriesModel needs one active MiningField carrying "
                "the forecast horizon (integer >= 1)"
            )
        return ir.TimeSeriesIR(
            function_name=elem.get("functionName", "timeSeries"),
            mining_schema=schema,
            horizon_field=schema.active_fields[0],
            arima=_parse_arima(arima_el, elem),
            model_name=elem.get("modelName"),
        )
    if best_fit != "ExponentialSmoothing":
        raise ModelLoadingException(
            f"unsupported TimeSeriesModel bestFit {best_fit!r} "
            "(supported: ExponentialSmoothing, ARIMA)"
        )
    es = _child(elem, "ExponentialSmoothing")
    if es is None:
        raise ModelLoadingException(
            "TimeSeriesModel has no ExponentialSmoothing element"
        )
    lvl = _child(es, "Level")
    if lvl is None or lvl.get("smoothedValue") is None:
        raise ModelLoadingException("Level needs a smoothedValue")
    level = _float(lvl, "smoothedValue")
    trend = 0.0
    trend_type = "none"
    phi = 1.0
    tr = _child(es, "Trend_ExpoSmooth")
    if tr is not None:
        trend_type = tr.get("trend", "additive")
        if trend_type == "damped_trend":  # pre-round-4 alias of the
            trend_type = "damped_additive"  # spec's enumeration value
        if trend_type not in (
            "additive", "damped_additive",
            "multiplicative", "damped_multiplicative",
        ):
            raise ModelLoadingException(
                f"unsupported trend {trend_type!r} (supported: additive, "
                "damped_additive, multiplicative, damped_multiplicative)"
            )
        trend = _float(tr, "smoothedValue", 0.0)
        phi = _float(tr, "phi", 1.0)
        if trend_type.startswith("damped") and not 0.0 < phi < 1.0:
            raise ModelLoadingException(
                f"{trend_type} needs 0 < phi < 1, got {phi}"
            )
        if trend_type.endswith("multiplicative") and trend <= 0.0:
            raise ModelLoadingException(
                f"multiplicative trend needs smoothedValue > 0, got {trend}"
            )
    seasonal_type = "none"
    period = 0
    seasonal: Tuple[float, ...] = ()
    se = _child(es, "Seasonality_ExpoSmooth")
    if se is not None:
        seasonal_type = se.get("type", "additive")
        if seasonal_type not in ("additive", "multiplicative"):
            raise ModelLoadingException(
                f"unsupported seasonality type {seasonal_type!r}"
            )
        period = _int(se, "period")
        arr = _child(se, "Array")
        if arr is None:
            raise ModelLoadingException(
                "Seasonality_ExpoSmooth needs an Array of factors"
            )
        seasonal = _parse_real_array(arr)
        if period < 2:
            raise ModelLoadingException(
                f"seasonal period must be >= 2, got {period}"
            )
        if len(seasonal) != period:
            raise ModelLoadingException(
                f"seasonal Array length {len(seasonal)} != period {period}"
            )
    schema = _parse_mining_schema(elem)
    if not schema.active_fields:
        raise ModelLoadingException(
            "TimeSeriesModel needs one active MiningField carrying the "
            "forecast horizon (integer >= 1)"
        )
    return ir.TimeSeriesIR(
        function_name=elem.get("functionName", "timeSeries"),
        mining_schema=schema,
        smoothing=ir.ExponentialSmoothingIR(
            level=level,
            trend=trend,
            trend_type=trend_type,
            phi=phi,
            seasonal_type=seasonal_type,
            period=period,
            seasonal=seasonal,
        ),
        horizon_field=schema.active_fields[0],
        model_name=elem.get("modelName"),
    )


_GP_KERNELS = {
    "RadialBasisKernel": "radialBasis",
    "ARDSquaredExponentialKernel": "ARDSquaredExponential",
    "AbsoluteExponentialKernel": "absoluteExponential",
    "GeneralizedExponentialKernel": "generalizedExponential",
}


def _parse_gaussian_process(elem: ET.Element) -> ir.GaussianProcessIR:
    schema = _parse_mining_schema(elem)
    kernel = None
    for c in elem:
        kind = _GP_KERNELS.get(_local(c.tag))
        if kind is None:
            continue
        lambdas: Tuple[float, ...] = (1.0,)
        la = _child(c, "Lambda")
        if la is not None:
            arr = _child(la, "Array")
            if arr is None:
                raise ModelLoadingException("Lambda has no Array child")
            lambdas = _parse_real_array(arr)
        elif c.get("lambda") is not None:
            lambdas = (_float(c, "lambda"),)
        if any(v <= 0 for v in lambdas):
            raise ModelLoadingException("GP length-scales must be positive")
        if kind == "radialBasis" and len(lambdas) != 1:
            # the isotropic kernel has ONE length-scale (scalar ``lambda``
            # attribute); a per-dimension array is the ARD kernel's job —
            # accepting it here would score differently compiled vs oracle
            raise ModelLoadingException(
                "RadialBasisKernel takes a single lambda; use "
                "ARDSquaredExponentialKernel for per-dimension length-scales"
            )
        kernel = ir.GpKernel(
            kind=kind,
            gamma=_float(c, "gamma", 1.0),
            noise_variance=_float(c, "noiseVariance", 1.0),
            lambdas=lambdas,
            degree=_float(c, "degree", 1.0),
        )
        break
    if kernel is None:
        raise ModelLoadingException(
            "GaussianProcessModel has no supported kernel element "
            f"(supported: {', '.join(_GP_KERNELS)})"
        )
    if kernel.noise_variance < 0:
        raise ModelLoadingException("noiseVariance must be >= 0")
    target = schema.target_field
    if target is None:
        raise ModelLoadingException(
            "GaussianProcessModel needs a target MiningField"
        )
    inputs = schema.active_fields
    instances, raw_targets, _ = _parse_training_instances(
        _req_child(elem, "TrainingInstances"), inputs, target
    )
    try:
        targets = tuple(float(t) for t in raw_targets)
    except ValueError:
        raise ModelLoadingException(
            "non-numeric GP training target value"
        ) from None
    D = len(inputs)
    if len(kernel.lambdas) not in (1, D):
        raise ModelLoadingException(
            f"Lambda has {len(kernel.lambdas)} entries for {D} inputs"
        )
    return ir.GaussianProcessIR(
        function_name=elem.get("functionName", "regression"),
        mining_schema=schema,
        kernel=kernel,
        inputs=inputs,
        instances=tuple(instances),
        targets=tuple(targets),
        model_name=elem.get("modelName"),
    )


def _parse_baseline(elem: ET.Element) -> ir.BaselineIR:
    td = _child(elem, "TestDistributions")
    if td is None:
        raise ModelLoadingException("BaselineModel has no TestDistributions")
    stat = td.get("testStatistic", "zValue")
    if stat != "zValue":
        raise ModelLoadingException(
            f"unsupported testStatistic {stat!r} (supported: zValue; "
            "CUSUM/chiSquare are windowed/multi-record and don't fit the "
            "per-record streaming contract)"
        )
    base = _child(td, "Baseline")
    if base is None:
        raise ModelLoadingException("TestDistributions has no Baseline")
    dist = None
    for c in base:
        tag = _local(c.tag)
        if tag == "GaussianDistribution":
            variance = _float(c, "variance", 1.0)
            if variance <= 0:
                raise ModelLoadingException("variance must be positive")
            dist = ir.BaselineDistribution(
                kind="gaussian", mean=_float(c, "mean", 0.0),
                variance=variance,
            )
        elif tag == "PoissonDistribution":
            mean = _float(c, "mean")
            if mean <= 0:
                raise ModelLoadingException("Poisson mean must be positive")
            dist = ir.BaselineDistribution(
                kind="poisson", mean=mean, variance=mean
            )
        elif tag == "UniformDistribution":
            lower = _float(c, "lower", 0.0)
            upper = _float(c, "upper", 1.0)
            if upper <= lower:
                raise ModelLoadingException("uniform upper must be > lower")
            # zValue over a uniform baseline: mean (l+u)/2, var (u−l)²/12
            dist = ir.BaselineDistribution(
                kind="uniform",
                mean=(lower + upper) / 2.0,
                variance=(upper - lower) ** 2 / 12.0,
                lower=lower, upper=upper,
            )
        if dist is not None:
            break
    if dist is None:
        raise ModelLoadingException(
            "Baseline has no supported distribution (Gaussian, Poisson, "
            "Uniform)"
        )
    field = td.get("field")
    if not field:
        raise ModelLoadingException("TestDistributions needs a field")
    return ir.BaselineIR(
        function_name=elem.get("functionName", "regression"),
        mining_schema=_parse_mining_schema(elem),
        field=field,
        baseline=dist,
        test_statistic=stat,
        model_name=elem.get("modelName"),
    )


def _parse_association(elem: ET.Element) -> ir.AssociationIR:
    schema = _parse_mining_schema(elem)
    items: dict = {}  # item id → value
    for it in _children(elem, "Item"):
        iid = it.get("id")
        value = it.get("value")
        if iid is None or value is None:
            raise ModelLoadingException("Item needs id and value")
        items[iid] = value
    itemsets: dict = {}  # itemset id → tuple of item values
    for iset in _children(elem, "Itemset"):
        sid = iset.get("id")
        if sid is None:
            raise ModelLoadingException("Itemset needs an id")
        refs = []
        for ref in _children(iset, "ItemRef"):
            rid = ref.get("itemRef")
            if rid not in items:
                raise ModelLoadingException(
                    f"ItemRef {rid!r} has no matching Item"
                )
            refs.append(items[rid])
        itemsets[sid] = tuple(refs)
    rules = []
    for r in _children(elem, "AssociationRule"):
        ante = r.get("antecedent")
        cons = r.get("consequent")
        if ante not in itemsets or cons not in itemsets:
            raise ModelLoadingException(
                "AssociationRule antecedent/consequent must reference "
                "declared Itemsets"
            )
        if not itemsets[cons]:
            # oracle and compiled paths must agree the document is
            # invalid — rejecting here keeps them consistent
            raise ModelLoadingException(
                f"AssociationRule consequent {cons!r} is an empty Itemset"
            )
        rules.append(ir.AssociationRule(
            antecedent=itemsets[ante],
            consequent=itemsets[cons],
            support=_float(r, "support"),
            confidence=_float(r, "confidence"),
            lift=_opt_float(r, "lift"),
            rule_id=r.get("id"),
        ))
    if not rules:
        raise ModelLoadingException("AssociationModel has no rules")
    item_values = tuple(items[k] for k in items)
    # the streaming input contract: every item must be an active field
    # (multi-hot basket columns); a reference-style group-valued single
    # field cannot be fixed-width batched
    missing = [v for v in item_values if v not in schema.active_fields]
    if missing:
        raise ModelLoadingException(
            "AssociationModel items must each be an active MiningField "
            f"(multi-hot basket contract); missing: {missing[:5]}"
        )
    # the ranking criterion rides the model's <Output>: an OutputField's
    # ``algorithm`` attribute (JPMML convention), whose spec default —
    # also used when the document declares no Output at all — is
    # exclusiveRecommendation
    criterion = "exclusiveRecommendation"
    out = _child(elem, "Output")
    if out is not None:
        for of in _children(out, "OutputField"):
            algo = of.get("algorithm")
            if algo is None:
                continue
            if algo not in (
                "rule", "recommendation", "exclusiveRecommendation"
            ):
                raise ModelLoadingException(
                    f"unsupported association algorithm {algo!r}"
                )
            criterion = algo
            break
    return ir.AssociationIR(
        function_name=elem.get("functionName", "associationRules"),
        mining_schema=schema,
        items=item_values,
        rules=tuple(rules),
        criterion=criterion,
        model_name=elem.get("modelName"),
    )


def _parse_anomaly_detection(elem: ET.Element) -> ir.AnomalyDetectionIR:
    algo = elem.get("algorithmType", "other")
    if algo not in ("iforest", "ocsvm", "other"):
        raise ModelLoadingException(
            f"unsupported algorithmType {algo!r} (supported: iforest, "
            "ocsvm, other)"
        )
    inner_elem = None
    for c in elem:
        if _local(c.tag) in _MODEL_TAGS:
            inner_elem = c
            break
    if inner_elem is None:
        raise ModelLoadingException(
            "AnomalyDetectionModel has no embedded model"
        )
    if _child(inner_elem, "LocalTransformations") is not None:
        raise ModelLoadingException(
            "LocalTransformations inside an AnomalyDetectionModel's "
            "embedded model are not supported (use the "
            "TransformationDictionary)"
        )
    sds = (
        _int(elem, "sampleDataSize")
        if elem.get("sampleDataSize") is not None
        else None
    )
    if algo == "iforest":
        if sds is None:
            raise ModelLoadingException(
                "iforest AnomalyDetectionModel needs sampleDataSize"
            )
        if sds < 2:
            raise ModelLoadingException(
                f"sampleDataSize must be >= 2, got {sds}"
            )
    return ir.AnomalyDetectionIR(
        function_name=elem.get("functionName", "regression"),
        mining_schema=_parse_mining_schema(elem),
        algorithm_type=algo,
        inner=_parse_model(inner_elem),
        sample_data_size=sds,
        model_name=elem.get("modelName"),
    )


def _parse_comparison_measure(cm: ET.Element) -> ir.ComparisonMeasure:
    metric_elem = None
    for c in cm:
        if _local(c.tag) == "Extension":  # Extension* precedes the metric
            continue
        metric_elem = c
        break
    if metric_elem is None:
        raise ModelLoadingException("ComparisonMeasure has no metric child")
    distance_metrics = (
        "squaredEuclidean", "euclidean", "cityBlock", "chebychev",
        "minkowski",
    )
    similarity_metrics = (
        "simpleMatching", "jaccard", "tanimoto", "binarySimilarity",
    )
    tag = _local(metric_elem.tag)
    if tag in distance_metrics:
        kind = "distance"
    elif tag in similarity_metrics:
        kind = "similarity"
    else:
        raise ModelLoadingException(
            f"unsupported comparison metric <{tag}>"
        )
    declared = cm.get("kind")
    if declared is not None and declared != kind:
        raise ModelLoadingException(
            f"ComparisonMeasure kind {declared!r} does not match metric "
            f"<{tag}> ({kind})"
        )
    binary_params: Tuple[float, ...] = ()
    if tag == "binarySimilarity":
        binary_params = tuple(
            _float(metric_elem, f"{g}{ij}-parameter")
            for g in ("c", "d")
            for ij in ("00", "01", "10", "11")
        )
    return ir.ComparisonMeasure(
        kind=kind,
        metric=tag,
        compare_function=cm.get("compareFunction", "absDiff"),
        minkowski_p=_float(metric_elem, "p-parameter", 2.0),
        binary_params=binary_params,
    )


def _parse_training_instances(
    ti: ET.Element,
    feature_fields: Sequence[str],
    target_field: str,
    id_field: Optional[str] = None,
):
    """Shared TrainingInstances/InstanceFields/InlineTable walk (KNN, GP).

    → (feature rows as float tuples in ``feature_fields`` order, raw
    target strings[, raw id strings when ``id_field`` is given]). Every
    feature field, the target, and the id field must have an
    InstanceField column; only InlineTable bodies are supported."""
    ifields = {
        f.get("field", ""): f.get("column", f.get("field", ""))
        for f in _children(_req_child(ti, "InstanceFields"), "InstanceField")
    }
    for f in feature_fields:
        if f not in ifields:
            raise ModelLoadingException(
                f"field {f!r} has no InstanceField column"
            )
    if target_field not in ifields:
        raise ModelLoadingException(
            f"target {target_field!r} has no InstanceField column"
        )
    if id_field is not None and id_field not in ifields:
        raise ModelLoadingException(
            f"instanceIdVariable {id_field!r} has no InstanceField column"
        )
    table = _child(ti, "InlineTable")
    if table is None:
        raise ModelLoadingException(
            "only InlineTable TrainingInstances are supported"
        )
    instances = []
    targets = []
    ids = []
    for row in _children(table, "row"):
        cells = {_local(c.tag): (c.text or "").strip() for c in row}
        coords = []
        for f in feature_fields:
            col = ifields[f]
            if col not in cells:
                raise ModelLoadingException(
                    f"training row missing column {col!r}"
                )
            try:
                coords.append(float(cells[col]))
            except ValueError:
                raise ModelLoadingException(
                    f"non-numeric training value {cells[col]!r} in "
                    f"column {col!r}"
                ) from None
        tcol = ifields[target_field]
        if tcol not in cells:
            raise ModelLoadingException(
                f"training row missing target column {tcol!r}"
            )
        instances.append(tuple(coords))
        targets.append(cells[tcol])
        if id_field is not None:
            icol = ifields[id_field]
            if icol not in cells:
                raise ModelLoadingException(
                    f"training row missing id column {icol!r}"
                )
            ids.append(cells[icol])
    if not instances:
        raise ModelLoadingException("TrainingInstances has no rows")
    return tuple(instances), tuple(targets), tuple(ids)


def _parse_nearest_neighbor(elem: ET.Element) -> ir.NearestNeighborIR:
    schema = _parse_mining_schema(elem)
    measure = _parse_comparison_measure(_req_child(elem, "ComparisonMeasure"))
    inputs = tuple(
        ir.KnnInput(
            field=ki.get("field", ""),
            weight=_float(ki, "fieldWeight", 1.0),
            compare_function=ki.get("compareFunction"),
            similarity_scale=_opt_float(ki, "similarityScale"),
        )
        for ki in _children(_req_child(elem, "KNNInputs"), "KNNInput")
    )
    if not inputs:
        raise ModelLoadingException("KNNInputs has no KNNInput elements")
    target = schema.target_field
    if target is None:
        raise ModelLoadingException(
            "NearestNeighborModel needs a target MiningField"
        )
    id_var = elem.get("instanceIdVariable")
    instances, targets, instance_ids = _parse_training_instances(
        _req_child(elem, "TrainingInstances"),
        [ki.field for ki in inputs],
        target,
        id_field=id_var,
    )
    k = _int(elem, "numberOfNeighbors", 3)
    if not 1 <= k <= len(instances):
        raise ModelLoadingException(
            f"numberOfNeighbors {k} out of [1, {len(instances)}]"
        )
    return ir.NearestNeighborIR(
        function_name=elem.get("functionName", "classification"),
        mining_schema=schema,
        n_neighbors=k,
        measure=measure,
        inputs=inputs,
        instances=tuple(instances),
        targets=tuple(targets),
        continuous_scoring=elem.get(
            "continuousScoringMethod", "average"
        ),
        categorical_scoring=elem.get(
            "categoricalScoringMethod", "majorityVote"
        ),
        instance_id_variable=id_var,
        instance_ids=instance_ids,
        model_name=elem.get("modelName"),
    )


_SVM_KERNELS = {
    "LinearKernelType": "linear",
    "PolynomialKernelType": "polynomial",
    "RadialBasisKernelType": "radialBasis",
    "SigmoidKernelType": "sigmoid",
}


def _parse_svm(elem: ET.Element) -> ir.SvmModelIR:
    kernel = None
    for c in elem:
        kind = _SVM_KERNELS.get(_local(c.tag))
        if kind is not None:
            kernel = ir.SvmKernel(
                kind=kind,
                gamma=_float(c, "gamma", 1.0),
                coef0=_float(c, "coef0", 0.0),
                degree=_float(c, "degree", 1.0),
            )
            break
    if kernel is None:
        raise ModelLoadingException(
            "SupportVectorMachineModel has no kernel element"
        )
    vd = _req_child(elem, "VectorDictionary")
    vf = _req_child(vd, "VectorFields")
    fields = tuple(
        f.get("field", "")
        for f in vf
        if _local(f.tag) in ("FieldRef", "CategoricalPredictor")
    )
    if any(_local(f.tag) == "CategoricalPredictor" for f in vf):
        raise ModelLoadingException(
            "CategoricalPredictor vector fields are not supported"
        )
    D = len(fields)
    vectors = []
    for vi in _children(vd, "VectorInstance"):
        vid = vi.get("id", "")
        arr = _child(vi, "Array")
        if arr is not None:
            coords = _parse_real_array(arr)
        else:
            sp = _child(vi, "REAL-SparseArray")
            if sp is None:
                raise ModelLoadingException(
                    f"VectorInstance {vid!r} has neither Array nor "
                    "REAL-SparseArray"
                )
            dense = [0.0] * D
            idx_elem = _child(sp, "Indices")
            ent_elem = _child(sp, "REAL-Entries")
            idxs = (
                [int(t) for t in (idx_elem.text or "").split()]
                if idx_elem is not None
                else []
            )
            vals = (
                [float(t) for t in (ent_elem.text or "").split()]
                if ent_elem is not None
                else []
            )
            if len(idxs) != len(vals):
                raise ModelLoadingException(
                    f"VectorInstance {vid!r}: {len(idxs)} indices vs "
                    f"{len(vals)} entries"
                )
            for i, v in zip(idxs, vals):
                if not 1 <= i <= D:  # PMML sparse indices are 1-based
                    raise ModelLoadingException(
                        f"VectorInstance {vid!r}: index {i} out of "
                        f"[1, {D}]"
                    )
                dense[i - 1] = v
            coords = tuple(dense)
        if len(coords) != D:
            raise ModelLoadingException(
                f"VectorInstance {vid!r} has {len(coords)} coords, "
                f"expected {D}"
            )
        vectors.append((vid, coords))
    machines = []
    for svm in _children(elem, "SupportVectorMachine"):
        sv_elem = _req_child(svm, "SupportVectors")
        vector_ids = tuple(
            sv.get("vectorId", "")
            for sv in _children(sv_elem, "SupportVector")
        )
        co_elem = _req_child(svm, "Coefficients")
        coeffs = tuple(
            _float(co, "value", 0.0)
            for co in _children(co_elem, "Coefficient")
        )
        if len(coeffs) != len(vector_ids):
            raise ModelLoadingException(
                f"SupportVectorMachine: {len(coeffs)} coefficients vs "
                f"{len(vector_ids)} support vectors"
            )
        thr = _opt_float(svm, "threshold")
        machines.append(
            ir.SvmMachine(
                vector_ids=vector_ids,
                coefficients=coeffs,
                intercept=_float(co_elem, "absoluteValue", 0.0),
                target_category=svm.get("targetCategory"),
                alternate_target_category=svm.get(
                    "alternateTargetCategory"
                ),
                threshold=thr,
            )
        )
    if not machines:
        raise ModelLoadingException(
            "SupportVectorMachineModel has no SupportVectorMachine"
        )
    return ir.SvmModelIR(
        function_name=elem.get("functionName", "classification"),
        mining_schema=_parse_mining_schema(elem),
        kernel=kernel,
        vector_fields=fields,
        vectors=tuple(vectors),
        machines=tuple(machines),
        classification_method=elem.get(
            "classificationMethod", "OneAgainstOne"
        ),
        threshold=_float(elem, "threshold", 0.0),
        model_name=elem.get("modelName"),
    )


def _parse_general_regression(elem: ET.Element) -> ir.GeneralRegressionIR:
    params = tuple(
        p.get("name", "")
        for p in _children(_req_child(elem, "ParameterList"), "Parameter")
    )
    fl = _child(elem, "FactorList")
    factors = tuple(
        p.get("name", "") for p in _children(fl, "Predictor")
    ) if fl is not None else ()
    cl = _child(elem, "CovariateList")
    covariates = tuple(
        p.get("name", "") for p in _children(cl, "Predictor")
    ) if cl is not None else ()
    pp = _child(elem, "PPMatrix")
    pp_cells = tuple(
        ir.PPCell(
            predictor=c.get("predictorName", ""),
            parameter=c.get("parameterName", ""),
            value=c.get("value", "1"),
        )
        for c in _children(pp, "PPCell")
    ) if pp is not None else ()
    pm = _req_child(elem, "ParamMatrix")
    p_cells = []
    for c in _children(pm, "PCell"):
        beta = c.get("beta")
        if beta is None:
            # required attribute: a silently-zeroed coefficient is a
            # silently-wrong model
            raise ModelLoadingException(
                f"PCell for parameter {c.get('parameterName')!r} has no "
                "beta"
            )
        p_cells.append(
            ir.PCell(
                parameter=c.get("parameterName", ""),
                beta=float(beta),
                target_category=c.get("targetCategory"),
            )
        )
    p_cells = tuple(p_cells)
    lp = _opt_float(elem, "linkParameter")
    _cox = _parse_base_cum_hazard(elem)
    return ir.GeneralRegressionIR(
        function_name=elem.get("functionName", "regression"),
        mining_schema=_parse_mining_schema(elem),
        model_type=elem.get("modelType", "generalLinear"),
        parameters=params,
        factors=factors,
        covariates=covariates,
        pp_cells=pp_cells,
        p_cells=p_cells,
        link_function=elem.get("linkFunction"),
        link_power=lp,
        target_reference_category=elem.get("targetReferenceCategory"),
        cumulative_link=elem.get("cumulativeLinkFunction", "logit"),
        end_time_variable=elem.get("endTimeVariable"),
        baseline_cells=_cox[0],
        max_time=_cox[1],
        model_name=elem.get("modelName"),
    )


def _parse_base_cum_hazard(elem: ET.Element):
    """CoxRegression <BaseCumHazardTables>: flat BaselineCell rows →
    (((time, cumHazard), …) sorted by time, maxTime). Stratified tables
    (BaselineStratum / baselineStrataVariable) are rejected."""
    tables = _child(elem, "BaseCumHazardTables")
    if tables is None:
        return (), None
    if elem.get("baselineStrataVariable") or _child(
        tables, "BaselineStratum"
    ) is not None:
        raise ModelLoadingException(
            "stratified BaseCumHazardTables are not supported"
        )
    cells = []
    for c in _children(tables, "BaselineCell"):
        cells.append((_float(c, "time"), _float(c, "cumHazard")))
    if not cells:
        raise ModelLoadingException(
            "BaseCumHazardTables has no BaselineCell rows"
        )
    cells.sort(key=lambda t: t[0])
    return tuple(cells), _opt_float(tables, "maxTime")


def _parse_naive_bayes(elem: ET.Element) -> ir.NaiveBayesIR:
    inputs = []
    bi_elem = _req_child(elem, "BayesInputs")
    for bi in _children(bi_elem, "BayesInput"):
        field = bi.get("fieldName", "")
        stats = _child(bi, "TargetValueStats")
        if stats is not None:
            rows = []
            for tv in _children(stats, "TargetValueStat"):
                g = _child(tv, "GaussianDistribution")
                if g is None:
                    raise ModelLoadingException(
                        f"BayesInput {field!r}: only GaussianDistribution "
                        "TargetValueStats are supported"
                    )
                mean = g.get("mean")
                var = g.get("variance")
                if mean is None or var is None:
                    raise ModelLoadingException(
                        f"BayesInput {field!r}: GaussianDistribution "
                        "needs both mean and variance"
                    )
                rows.append((tv.get("value", ""), float(mean), float(var)))
            inputs.append(
                ir.BayesContinuousInput(field=field, stats=tuple(rows))
            )
            continue
        pairs = []
        for pv in _children(bi, "PairCounts"):
            tvc = _req_child(pv, "TargetValueCounts")
            counts = tuple(
                (c.get("value", ""), _float(c, "count", 0.0))
                for c in _children(tvc, "TargetValueCount")
            )
            pairs.append((pv.get("value", ""), counts))
        if not pairs:
            raise ModelLoadingException(
                f"BayesInput {field!r} has neither TargetValueStats nor "
                "PairCounts"
            )
        inputs.append(
            ir.BayesCategoricalInput(field=field, counts=tuple(pairs))
        )
    bo = _req_child(elem, "BayesOutput")
    tvc = _req_child(bo, "TargetValueCounts")
    target_counts = tuple(
        (c.get("value", ""), _float(c, "count", 0.0))
        for c in _children(tvc, "TargetValueCount")
    )
    if not target_counts:
        raise ModelLoadingException("BayesOutput has no TargetValueCounts")
    return ir.NaiveBayesIR(
        function_name=elem.get("functionName", "classification"),
        mining_schema=_parse_mining_schema(elem),
        inputs=tuple(inputs),
        target_counts=target_counts,
        threshold=_float(elem, "threshold", 0.0),
        model_name=elem.get("modelName"),
    )


def _parse_scorecard(elem: ET.Element) -> ir.ScorecardIR:
    chars_elem = _req_child(elem, "Characteristics")
    characteristics = []
    for ch in _children(chars_elem, "Characteristic"):
        attributes = []
        for at in _children(ch, "Attribute"):
            ps = at.get("partialScore")
            expr = None
            cps = _child(at, "ComplexPartialScore")
            if cps is not None:
                for c in cps:
                    expr = _try_parse_expression(c)
                    if expr is not None:
                        break
                if expr is None:
                    raise ModelLoadingException(
                        "ComplexPartialScore needs an expression child"
                    )
            if ps is None and expr is None:
                raise ModelLoadingException(
                    f"Attribute in characteristic {ch.get('name')!r} has "
                    "no partialScore or ComplexPartialScore"
                )
            attributes.append(
                ir.ScorecardAttribute(
                    predicate=_find_predicate(at),
                    partial_score=float(ps) if ps is not None else 0.0,
                    reason_code=at.get("reasonCode"),
                    partial_expr=expr,
                )
            )
        if not attributes:
            raise ModelLoadingException(
                f"Characteristic {ch.get('name')!r} has no Attributes"
            )
        bs = ch.get("baselineScore")
        characteristics.append(
            ir.Characteristic(
                name=ch.get("name"),
                attributes=tuple(attributes),
                reason_code=ch.get("reasonCode"),
                baseline_score=float(bs) if bs is not None else None,
            )
        )
    if not characteristics:
        raise ModelLoadingException("Scorecard has no Characteristics")
    bs = elem.get("baselineScore")
    return ir.ScorecardIR(
        function_name=elem.get("functionName", "regression"),
        mining_schema=_parse_mining_schema(elem),
        characteristics=tuple(characteristics),
        initial_score=float(elem.get("initialScore", 0.0)),
        use_reason_codes=elem.get("useReasonCodes", "true") == "true",
        reason_code_algorithm=elem.get(
            "reasonCodeAlgorithm", "pointsBelow"
        ),
        baseline_score=float(bs) if bs is not None else None,
        model_name=elem.get("modelName"),
    )


def _parse_ruleset_model(elem: ET.Element) -> ir.RuleSetIR:
    rs = _req_child(elem, "RuleSet")
    sel_elems = list(_children(rs, "RuleSelectionMethod"))
    if not sel_elems:
        raise ModelLoadingException("RuleSet has no RuleSelectionMethod")
    # the first listed criterion is the active one (PMML: evaluators use
    # the first they support; ours supports all three)
    selection = sel_elems[0].get("criterion", "firstHit")

    rules: list = []

    def walk(container: ET.Element, ancestors: tuple) -> None:
        """Flatten SimpleRule/CompoundRule nesting: a nested rule fires
        iff all ancestor CompoundRule predicates AND its own are true —
        expressed as an and-compound, preserving document (first-hit)
        order."""
        for c in container:
            tag = _local(c.tag)
            if tag == "SimpleRule":
                pred = _find_predicate(c)
                if ancestors:
                    pred = ir.CompoundPredicate(
                        boolean_operator="and",
                        predicates=ancestors + (pred,),
                    )
                score = c.get("score")
                if score is None:
                    raise ModelLoadingException("SimpleRule has no score")
                rules.append(
                    ir.SimpleRule(
                        predicate=pred,
                        score=score,
                        rule_id=c.get("id"),
                        weight=_float(c, "weight", 1.0),
                        confidence=_float(c, "confidence", 1.0),
                    )
                )
            elif tag == "CompoundRule":
                walk(c, ancestors + (_find_predicate(c),))

    walk(rs, ())
    if not rules:
        raise ModelLoadingException("RuleSet has no rules")
    return ir.RuleSetIR(
        function_name=elem.get("functionName", "classification"),
        mining_schema=_parse_mining_schema(elem),
        rules=tuple(rules),
        selection_method=selection,
        default_score=rs.get("defaultScore"),
        default_confidence=_float(rs, "defaultConfidence", 0.0),
        model_name=elem.get("modelName"),
    )


def _parse_tree_model(elem: ET.Element) -> ir.TreeModelIR:
    return ir.TreeModelIR(
        function_name=elem.get("functionName", "regression"),
        mining_schema=_parse_mining_schema(elem),
        root=_parse_tree_node(_req_child(elem, "Node")),
        missing_value_strategy=elem.get("missingValueStrategy", "none"),
        no_true_child_strategy=elem.get("noTrueChildStrategy", "returnNullPrediction"),
        split_characteristic=elem.get("splitCharacteristic", "binarySplit"),
        model_name=elem.get("modelName"),
    )


def _parse_tree_node(elem: ET.Element) -> ir.TreeNode:
    dists = tuple(
        ir.ScoreDistribution(
            value=sd.get("value", ""),
            record_count=_float(sd, "recordCount", 0.0),
            confidence=_opt_float(sd, "confidence"),
            probability=_opt_float(sd, "probability"),
        )
        for sd in _children(elem, "ScoreDistribution")
    )
    children = tuple(_parse_tree_node(c) for c in _children(elem, "Node"))
    return ir.TreeNode(
        predicate=_find_predicate(elem),
        score=elem.get("score"),
        node_id=elem.get("id"),
        record_count=_opt_float(elem, "recordCount"),
        default_child=elem.get("defaultChild"),
        children=children,
        score_distribution=dists,
    )


def _parse_regression_model(elem: ET.Element) -> ir.RegressionModelIR:
    tables = []
    for t in _children(elem, "RegressionTable"):
        nums = tuple(
            ir.NumericPredictor(
                name=p.get("name", ""),
                coefficient=_float(p, "coefficient"),
                exponent=_float(p, "exponent", 1.0),
            )
            for p in _children(t, "NumericPredictor")
        )
        cats = tuple(
            ir.CategoricalPredictor(
                name=p.get("name", ""),
                value=p.get("value", ""),
                coefficient=_float(p, "coefficient"),
            )
            for p in _children(t, "CategoricalPredictor")
        )
        tables.append(
            ir.RegressionTable(
                intercept=_float(t, "intercept", 0.0),
                target_category=t.get("targetCategory"),
                numeric_predictors=nums,
                categorical_predictors=cats,
            )
        )
    if not tables:
        raise ModelLoadingException("RegressionModel has no RegressionTable")
    return ir.RegressionModelIR(
        function_name=elem.get("functionName", "regression"),
        mining_schema=_parse_mining_schema(elem),
        normalization_method=elem.get("normalizationMethod", "none"),
        tables=tuple(tables),
        model_name=elem.get("modelName"),
    )


def _parse_neural_network(elem: ET.Element) -> ir.NeuralNetworkIR:
    inputs = []
    for ni in _children(_req_child(elem, "NeuralInputs"), "NeuralInput"):
        inputs.append(
            ir.NeuralInput(
                neuron_id=ni.get("id", ""),
                derived_field=_parse_derived_field(_req_child(ni, "DerivedField")),
            )
        )
    layers = []
    for nl in _children(elem, "NeuralLayer"):
        neurons = []
        for n in _children(nl, "Neuron"):
            weights = tuple(
                (c.get("from", ""), _float(c, "weight")) for c in _children(n, "Con")
            )
            neurons.append(
                ir.Neuron(
                    neuron_id=n.get("id", ""),
                    bias=_float(n, "bias", 0.0),
                    weights=weights,
                    width=(
                        float(n.get("width"))
                        if n.get("width") is not None
                        else None
                    ),
                    altitude=(
                        float(n.get("altitude"))
                        if n.get("altitude") is not None
                        else None
                    ),
                )
            )
        layers.append(
            ir.NeuralLayer(
                neurons=tuple(neurons),
                activation=nl.get("activationFunction"),
                normalization=nl.get("normalizationMethod"),
                threshold=(
                    float(nl.get("threshold"))
                    if nl.get("threshold") is not None
                    else None
                ),
                width=(
                    float(nl.get("width"))
                    if nl.get("width") is not None
                    else None
                ),
                altitude=(
                    float(nl.get("altitude"))
                    if nl.get("altitude") is not None
                    else None
                ),
            )
        )
    outputs = []
    no_elem = _child(elem, "NeuralOutputs")
    if no_elem is not None:
        for no in _children(no_elem, "NeuralOutput"):
            outputs.append(
                ir.NeuralOutput(
                    output_neuron=no.get("outputNeuron", ""),
                    derived_field=_parse_derived_field(_req_child(no, "DerivedField")),
                )
            )
    return ir.NeuralNetworkIR(
        function_name=elem.get("functionName", "regression"),
        mining_schema=_parse_mining_schema(elem),
        activation_function=elem.get("activationFunction", "logistic"),
        inputs=tuple(inputs),
        layers=tuple(layers),
        outputs=tuple(outputs),
        normalization_method=elem.get("normalizationMethod", "none"),
        model_name=elem.get("modelName"),
        threshold=float(elem.get("threshold", 0.0)),
        width=(
            float(elem.get("width"))
            if elem.get("width") is not None
            else None
        ),
        altitude=float(elem.get("altitude", 1.0)),
    )


def _parse_clustering_model(elem: ET.Element) -> ir.ClusteringModelIR:
    measure = _parse_comparison_measure(_req_child(elem, "ComparisonMeasure"))
    fields = tuple(
        ir.ClusteringField(
            field=cf.get("field", ""),
            weight=_float(cf, "fieldWeight", 1.0),
            compare_function=cf.get("compareFunction"),
            similarity_scale=_opt_float(cf, "similarityScale"),
        )
        for cf in _children(elem, "ClusteringField")
    )
    clusters = tuple(
        ir.Cluster(
            center=_parse_real_array(_req_child(cl, "Array")),
            name=cl.get("name"),
            cluster_id=cl.get("id"),
        )
        for cl in _children(elem, "Cluster")
    )
    if not clusters:
        raise ModelLoadingException("ClusteringModel has no Cluster elements")
    mvw: tuple = ()
    mvw_elem = _child(elem, "MissingValueWeights")
    if mvw_elem is not None:
        arr = _child(mvw_elem, "Array")
        if arr is None:
            raise ModelLoadingException(
                "MissingValueWeights needs an Array"
            )
        mvw = _parse_real_array(arr)
        if len(mvw) != len(fields):
            raise ModelLoadingException(
                f"MissingValueWeights length {len(mvw)} != clustering "
                f"fields {len(fields)}"
            )
        if any(q < 0 for q in mvw) or sum(mvw) <= 0:
            raise ModelLoadingException(
                "MissingValueWeights must be non-negative with a "
                "positive sum"
            )
    return ir.ClusteringModelIR(
        function_name=elem.get("functionName", "clustering"),
        mining_schema=_parse_mining_schema(elem),
        model_class=elem.get("modelClass", "centerBased"),
        measure=measure,
        clustering_fields=fields,
        clusters=clusters,
        missing_value_weights=mvw,
        model_name=elem.get("modelName"),
    )


def _parse_mining_model(elem: ET.Element) -> ir.MiningModelIR:
    seg_elem = _req_child(elem, "Segmentation")
    segments = []
    for s in _children(seg_elem, "Segment"):
        model_elem = None
        for c in s:
            if _local(c.tag) in _MODEL_TAGS:
                model_elem = c
                break
        if model_elem is None:
            raise ModelLoadingException(
                f"Segment {s.get('id')!r} has no supported embedded model"
            )
        if _child(model_elem, "LocalTransformations") is not None:
            raise ModelLoadingException(
                "LocalTransformations inside MiningModel segments are "
                "not supported (top-level model LocalTransformations "
                "and the TransformationDictionary are)"
            )
        out_fields = []
        out_elem = _child(model_elem, "Output")
        if out_elem is not None:
            for of in _children(out_elem, "OutputField"):
                out_fields.append(
                    ir.OutputField(
                        name=of.get("name", ""),
                        feature=of.get("feature", "predictedValue"),
                        target_value=of.get("value"),
                    )
                )
        segments.append(
            ir.Segment(
                predicate=_find_predicate(s),
                model=_parse_model(model_elem),
                segment_id=s.get("id"),
                weight=_float(s, "weight", 1.0),
                output_fields=tuple(out_fields),
            )
        )
    if not segments:
        raise ModelLoadingException("Segmentation has no Segment elements")
    return ir.MiningModelIR(
        function_name=elem.get("functionName", "regression"),
        mining_schema=_parse_mining_schema(elem),
        segmentation=ir.Segmentation(
            multiple_model_method=seg_elem.get("multipleModelMethod", "sum"),
            segments=tuple(segments),
        ),
        model_name=elem.get("modelName"),
    )
