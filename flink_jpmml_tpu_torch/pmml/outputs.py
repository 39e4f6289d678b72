"""Top-level <Output> post-processing for the port's decode path.

A copy of ``flink_jpmml_tpu/pmml/outputs.py`` (numpy-only there): the
feature set, ``validate_output_fields`` and ``compute_outputs`` are the
JAX package's, unchanged. Features: ``predictedValue`` (the label for
classification, the numeric value otherwise), ``probability`` (``value``
attribute picks the class; absent = the winning label's),
``transformedValue`` whose expression is evaluated over the *previously
declared output fields*, and the entity / reason-code / rule features.
As in the JAX package, ``compute_outputs`` evaluates a transformedValue
through the oracle's ``eval_expression``: the port's copy,
``pmml/interp.py``.
"""


from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

_FEATURES = (
    "predictedValue", "probability", "transformedValue", "reasonCode",
    "ruleValue", "entityId", "affinity",
)

# ruleFeature attribute → key in the winning-rule metadata mapping
_RULE_FEATURES = (
    "consequent", "antecedent", "rule", "ruleId",
    "confidence", "support", "lift",
)


def _expr_field_refs(expr: ir.Expression) -> set:
    refs = set()
    if isinstance(expr, ir.FieldRef):
        refs.add(expr.field)
    elif isinstance(expr, ir.Apply):
        for a in expr.args:
            refs |= _expr_field_refs(a)
    elif isinstance(expr, (ir.NormContinuous, ir.NormDiscrete)):
        refs.add(expr.field)
    return refs


def validate_output_fields(
    output_fields: Sequence[ir.OutputField],
) -> None:
    """Compile-time validation: known features; transformedValue
    expressions may reference only previously declared output fields."""
    seen: set = set()
    for of in output_fields:
        if of.feature not in _FEATURES:
            raise ModelCompilationException(
                f"unsupported OutputField feature {of.feature!r} "
                f"(supported: {', '.join(_FEATURES)})"
            )
        if of.feature == "affinity" and of.rank != 1:
            raise ModelCompilationException(
                f"OutputField {of.name!r}: rank-k affinity is not "
                "supported (rank must be 1)"
            )
        if of.feature == "entityId" and of.rank < 1:
            raise ModelCompilationException(
                f"OutputField {of.name!r}: entityId rank must be >= 1"
            )
        if of.feature == "ruleValue" and of.rule_feature not in _RULE_FEATURES:
            raise ModelCompilationException(
                f"unsupported ruleFeature {of.rule_feature!r} "
                f"(supported: {', '.join(_RULE_FEATURES)})"
            )
        if of.feature == "transformedValue":
            refs = _expr_field_refs(of.expression)
            unknown = refs - seen
            if unknown:
                raise ModelCompilationException(
                    f"OutputField {of.name!r}: transformedValue may only "
                    f"reference previously declared output fields; "
                    f"{sorted(unknown)} are not "
                    f"(inputs are not available at decode time)"
                )
        seen.add(of.name)


def compute_outputs(
    output_fields: Sequence[ir.OutputField],
    value: Optional[float],
    label: Optional[str],
    probabilities: Optional[Mapping[str, float]],
    reason_codes: Optional[Sequence[str]] = None,
    rule_ranking: Optional[Sequence[Mapping[str, object]]] = None,
    entity_scores: Optional[Mapping[str, float]] = None,
    entity_ranking: Optional[Sequence[str]] = None,
) -> Dict[str, object]:
    """One record's model result → its <Output> field values, in
    declaration order (later transformedValues see earlier outputs).
    ``reason_codes`` is the scorecard's ranked worst-first list (rank
    attribute is 1-based; out-of-range → None). ``rule_ranking`` is the
    association fired-rule metadata best-first; a ruleValue field's
    ``rank`` indexes it the same way. ``entity_scores`` is the
    per-entity comparison-score mapping for families that surface one
    (clustering distances/similarities); entityId/affinity read it and
    yield None elsewhere — a class-probability map is NOT a comparison
    score and must not leak through affinity. ``entity_ranking`` is the
    best-first entity-id list (clusters by score; KNN neighbors by
    nearness when the document declares instanceIdVariable): an
    entityId field's ``rank`` indexes it."""
    from flink_jpmml_tpu_torch.pmml.interp import eval_expression

    probs = probabilities or {}
    rcs = reason_codes or ()
    out: Dict[str, object] = {}
    for of in output_fields:
        if of.feature == "predictedValue":
            out[of.name] = label if label is not None else value
        elif of.feature == "probability":
            key = of.target_value if of.target_value is not None else label
            out[of.name] = probs.get(key) if key is not None else None
        elif of.feature == "entityId":
            # the rank-kth entity's identifier where the family surfaces
            # an entity ranking (clusters by score; KNN neighbors by
            # nearness); rank 1 without a ranking falls back to the
            # winner where entity scores exist
            if entity_ranking is not None:
                er = entity_ranking
                out[of.name] = (
                    er[of.rank - 1] if 0 < of.rank <= len(er) else None
                )
            elif of.rank == 1 and entity_scores is not None:
                out[of.name] = label
            else:
                out[of.name] = None
        elif of.feature == "affinity":
            # the requested entity's comparison score (the ``value``
            # attribute picks one; absent = the winner's)
            if entity_scores is None:
                out[of.name] = None
            else:
                key = (
                    of.target_value
                    if of.target_value is not None
                    else label
                )
                out[of.name] = (
                    entity_scores.get(key) if key is not None else None
                )
        elif of.feature == "reasonCode":
            out[of.name] = (
                rcs[of.rank - 1] if 0 < of.rank <= len(rcs) else None
            )
        elif of.feature == "ruleValue":
            rr = rule_ranking or ()
            out[of.name] = (
                rr[of.rank - 1].get(of.rule_feature)
                if 0 < of.rank <= len(rr)
                else None
            )
        else:  # transformedValue (validated)
            out[of.name] = eval_expression(of.expression, out)
    return out
