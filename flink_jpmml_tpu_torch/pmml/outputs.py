"""Top-level <Output> post-processing for the port's decode path.

A copy of ``flink_jpmml_tpu/pmml/outputs.py`` (numpy-only there): the
feature set, ``validate_output_fields`` and ``compute_outputs`` are the
JAX package's, unchanged. Features: ``predictedValue`` (the label for
classification, the numeric value otherwise), ``probability`` (``value``
attribute picks the class; absent = the winning label's),
``transformedValue`` whose expression is evaluated over the *previously
declared output fields*, and the entity / reason-code / rule features.

The one difference: ``compute_outputs`` evaluates a transformedValue
through the JAX package's oracle (``pmml/interp.eval_expression``), which
the port does not have. The expression evaluator it needs is copied here,
below the copy of ``outputs.py``: ``eval_expression`` and its helpers
(``_is_missing``, ``_as_float``, ``_values_equal``, ``_norm_continuous``,
``_apply_function``) from ``flink_jpmml_tpu/pmml/interp.py``, unchanged.
"""


from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Union

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


# ---------------------------------------------------------------------------
# transformedValue expressions (copied from flink_jpmml_tpu/pmml/interp.py)
# ---------------------------------------------------------------------------

Value = Union[float, str, None]
Record = Mapping[str, Value]


def _is_missing(v: Value) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _as_float(v: Value) -> Optional[float]:
    if _is_missing(v):
        return None
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return float(v)


def _values_equal(record_value: Value, pmml_value: str) -> bool:
    """PMML value comparison: numeric when both sides parse, else string."""
    if _is_missing(record_value):
        return False
    f = _as_float(record_value)
    try:
        pf = float(pmml_value)
    except ValueError:
        pf = None
    if f is not None and pf is not None:
        return f == pf
    return str(record_value) == pmml_value


def eval_expression(expr: ir.Expression, record: Record) -> Optional[float]:
    if isinstance(expr, ir.Constant):
        return expr.value
    if isinstance(expr, ir.FieldRef):
        return _as_float(record.get(expr.field))
    if isinstance(expr, ir.NormContinuous):
        x = _as_float(record.get(expr.field))
        if x is None:
            return expr.map_missing_to
        if expr.outliers == "asMissingValues" and not (
            expr.norms[0].orig <= x <= expr.norms[-1].orig
        ):
            return expr.map_missing_to
        return _norm_continuous(x, expr)
    if isinstance(expr, ir.NormDiscrete):
        v = record.get(expr.field)
        if _is_missing(v):
            return expr.map_missing_to
        return 1.0 if _values_equal(v, expr.value) else 0.0
    if isinstance(expr, ir.Apply):
        if expr.function in ("isMissing", "isNotMissing"):
            # the ONE function pair that consumes missing-ness itself:
            # the any-arg-missing shortcut below must not fire for it.
            # A bare FieldRef asks about record PRESENCE — a present
            # categorical string is NOT missing even though it does not
            # coerce to float (the compiled lane sees its codec code)
            arg = expr.args[0]
            if isinstance(arg, ir.FieldRef):
                missing = _is_missing(record.get(arg.field))
            else:
                missing = eval_expression(arg, record) is None
            want = expr.function == "isMissing"
            return 1.0 if missing == want else 0.0
        args = [eval_expression(a, record) for a in expr.args]
        if expr.function in ("and", "or"):
            # Kleene three-valued logic (JPMML BinaryBooleanFunction):
            # a definite dominator wins over a missing argument —
            # and(false, missing) = false, or(true, missing) = true;
            # undecided-with-missing stays missing (→ mapMissingTo)
            is_and = expr.function == "and"
            if is_and and any(a is not None and a == 0.0 for a in args):
                return 0.0
            if not is_and and any(a is not None and a != 0.0 for a in args):
                return 1.0
            if any(a is None for a in args):
                return expr.map_missing_to
            return 1.0 if is_and else 0.0
        if any(a is None for a in args):
            return expr.map_missing_to
        return _apply_function(expr.function, args)
    raise ModelCompilationException(f"unsupported expression {type(expr).__name__}")


def _norm_continuous(x: float, expr: ir.NormContinuous) -> float:
    ns = expr.norms
    if expr.outliers == "asExtremeValues":
        if x < ns[0].orig:
            return ns[0].norm
        if x > ns[-1].orig:
            return ns[-1].norm
    # piecewise-linear; extrapolate from the outermost segments (asIs)
    for a, b in zip(ns, ns[1:]):
        if x <= b.orig or b is ns[-1]:
            if b.orig == a.orig:
                return a.norm
            t = (x - a.orig) / (b.orig - a.orig)
            return a.norm + t * (b.norm - a.norm)
    return ns[-1].norm  # unreachable


def _apply_function(fn: str, args: List[float]) -> Optional[float]:
    try:
        if fn == "+":
            return args[0] + args[1]
        if fn == "-":
            return args[0] - args[1]
        if fn == "*":
            return args[0] * args[1]
        if fn == "/":
            return args[0] / args[1]
        if fn == "min":
            return min(args)
        if fn == "max":
            return max(args)
        if fn == "pow":
            return args[0] ** args[1]
        if fn == "exp":
            return math.exp(args[0])
        if fn == "ln":
            return math.log(args[0]) if args[0] > 0 else None
        if fn == "sqrt":
            return math.sqrt(args[0]) if args[0] >= 0 else None
        if fn == "abs":
            return abs(args[0])
        if fn == "floor":
            return math.floor(args[0])
        if fn == "ceil":
            return math.ceil(args[0])
        if fn == "threshold":
            return 1.0 if args[0] > args[1] else 0.0
        if fn == "if":
            return args[1] if args[0] != 0.0 else (args[2] if len(args) > 2 else None)
        # comparisons / booleans: results are PMML booleans as 1.0/0.0
        if fn == "equal":
            return 1.0 if args[0] == args[1] else 0.0
        if fn == "notEqual":
            return 1.0 if args[0] != args[1] else 0.0
        if fn == "lessThan":
            return 1.0 if args[0] < args[1] else 0.0
        if fn == "lessOrEqual":
            return 1.0 if args[0] <= args[1] else 0.0
        if fn == "greaterThan":
            return 1.0 if args[0] > args[1] else 0.0
        if fn == "greaterOrEqual":
            return 1.0 if args[0] >= args[1] else 0.0
        if fn == "and":
            return 1.0 if all(a != 0.0 for a in args) else 0.0
        if fn == "or":
            return 1.0 if any(a != 0.0 for a in args) else 0.0
        if fn == "not":
            return 1.0 if args[0] == 0.0 else 0.0
        # rounding / residues
        if fn == "round":  # PMML: half away from floor — 0.5 rounds UP
            return math.floor(args[0] + 0.5)
        if fn == "rint":  # IEEE half-to-even (python round() matches)
            return float(round(args[0]))
        if fn == "modulo":  # sign of the divisor (python % semantics)
            return args[0] % args[1] if args[1] != 0 else None
        # logs
        if fn == "log10":
            return math.log10(args[0]) if args[0] > 0 else None
        if fn == "ln1p":
            return math.log1p(args[0]) if args[0] > -1 else None
        if fn == "expm1":
            # overflow → inf, matching the compiled f32 path's totality
            # (the repo convention for monotone overflow; cf. ARIMA)
            try:
                return math.expm1(args[0])
            except OverflowError:
                return math.inf
        # trigonometry
        if fn == "sin":
            return math.sin(args[0])
        if fn == "cos":
            return math.cos(args[0])
        if fn == "tan":
            return math.tan(args[0])
        if fn == "asin":
            return math.asin(args[0]) if -1 <= args[0] <= 1 else None
        if fn == "acos":
            return math.acos(args[0]) if -1 <= args[0] <= 1 else None
        if fn == "atan":
            return math.atan(args[0])
        if fn == "atan2":
            return math.atan2(args[0], args[1])
        if fn == "sinh":
            try:
                return math.sinh(args[0])
            except OverflowError:
                return math.copysign(math.inf, args[0])
        if fn == "cosh":
            try:
                return math.cosh(args[0])
            except OverflowError:
                return math.inf
        if fn == "tanh":
            return math.tanh(args[0])
        if fn == "hypot":
            return math.hypot(args[0], args[1])
        # standard-normal family (PMML 4.4)
        if fn == "stdNormalCDF":
            return 0.5 * (1.0 + math.erf(args[0] / math.sqrt(2.0)))
        if fn == "stdNormalPDF":
            return math.exp(-0.5 * args[0] * args[0]) / math.sqrt(
                2.0 * math.pi
            )
        if fn == "stdNormalIDF":
            if not 0.0 < args[0] < 1.0:
                return None
            import statistics

            return statistics.NormalDist().inv_cdf(args[0])
    except (ValueError, ZeroDivisionError, OverflowError):
        return None
    raise ModelCompilationException(f"unsupported Apply function {fn!r}")
