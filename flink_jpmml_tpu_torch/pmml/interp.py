"""Reference interpreter: slow, per-record, exact PMML semantics.

This module is the framework's *semantic oracle*. The reference delegated
per-record evaluation to JPMML-Evaluator (SURVEY.md §2 layer EXT-B, JVM-only);
we cannot run a JVM here, so golden tests diff the fast JAX lowering
(:mod:`flink_jpmml_tpu.compile`) against this deliberately simple Python
interpreter instead (SURVEY.md §5 "golden outputs"). It is intentionally the
*opposite* of the TPU design — per-record, branchy, dict-based — so that a
bug in the vectorised lowering and a bug here are unlikely to coincide.

Missing-value semantics follow DMG PMML 4.x:
- predicates over missing fields evaluate to UNKNOWN (``None`` here);
- TreeModel ``missingValueStrategy`` ∈ {none, defaultChild, lastPrediction,
  nullPrediction} decides what UNKNOWN does during descent;
- RegressionModel: a missing *numeric* predictor makes the table value
  missing; a missing *categorical* predictor contributes 0;
- MiningModel: a missing segment result makes aggregate results missing
  (sum/average/weightedAverage), is excluded from votes, and propagates
  through modelChain.

A copy of ``flink_jpmml_tpu/pmml/interp.py`` (pure Python there too),
kept so that the PyTorch port imports nothing of the JAX package. The
code is unchanged; its lazy imports point at the port's ``outputs``,
``scorecard`` (``ReasonCodeMeta``), ``clustering`` (``similarity_params``,
``resolve_compare``) and ``anomaly`` (``iforest_c``), which carry the JAX
package's numpy code. ``compute_outputs`` in ``pmml/outputs.py``
evaluates ``transformedValue`` expressions through this module's
``eval_expression``, and the compiler reads ``rule_meta_dict`` for the
association rule outputs.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

Value = Union[float, str, None]
Record = Mapping[str, Value]


@dataclass
class EvalResult:
    """Interpreter output for one record.

    ``value``: numeric predicted value (regression score, winning-class
    probability is NOT here — see ``label``/``probabilities`` for
    classification; for clustering it is the winning cluster's *index*).
    ``None`` ⇔ the reference's ``EmptyScore``.
    """

    value: Optional[float] = None
    label: Optional[str] = None
    probabilities: Dict[str, float] = dc_field(default_factory=dict)
    outputs: Dict[str, object] = dc_field(default_factory=dict)
    reason_codes: Tuple[str, ...] = ()  # scorecard, ranked worst-first
    # association: fired rules' metadata best-first (rank-k ruleValue)
    rule_ranking: Tuple[Dict[str, object], ...] = ()
    # entity ids best-first (clusters by score; KNN neighbors by
    # nearness) — rank-k entityId outputs index it
    entity_ranking: Tuple[str, ...] = ()

    @property
    def is_missing(self) -> bool:
        return self.value is None and self.label is None


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


# ---------------------------------------------------------------------------
# Predicates → True / False / None (UNKNOWN)
# ---------------------------------------------------------------------------


def eval_predicate(pred: ir.Predicate, record: Record) -> Optional[bool]:
    if isinstance(pred, ir.TruePredicate):
        return True
    if isinstance(pred, ir.FalsePredicate):
        return False
    if isinstance(pred, ir.SimplePredicate):
        v = record.get(pred.field)
        if pred.operator == "isMissing":
            return _is_missing(v)
        if pred.operator == "isNotMissing":
            return not _is_missing(v)
        if _is_missing(v):
            return None
        if pred.operator == "equal":
            return _values_equal(v, pred.value)
        if pred.operator == "notEqual":
            return not _values_equal(v, pred.value)
        f = _as_float(v)
        t = _as_float(pred.value)
        if f is None or t is None:
            return None
        return {
            "lessThan": f < t,
            "lessOrEqual": f <= t,
            "greaterThan": f > t,
            "greaterOrEqual": f >= t,
        }[pred.operator]
    if isinstance(pred, ir.SimpleSetPredicate):
        v = record.get(pred.field)
        if _is_missing(v):
            return None
        member = any(_values_equal(v, s) for s in pred.values)
        return member if pred.boolean_operator == "isIn" else not member
    if isinstance(pred, ir.CompoundPredicate):
        results = [eval_predicate(p, record) for p in pred.predicates]
        op = pred.boolean_operator
        if op == "and":
            if any(r is False for r in results):
                return False
            return None if any(r is None for r in results) else True
        if op == "or":
            if any(r is True for r in results):
                return True
            return None if any(r is None for r in results) else False
        if op == "xor":
            if any(r is None for r in results):
                return None
            return sum(bool(r) for r in results) % 2 == 1
        if op == "surrogate":
            for r in results:
                if r is not None:
                    return r
            return None
        raise ModelCompilationException(f"unsupported CompoundPredicate {op!r}")
    raise ModelCompilationException(f"unsupported predicate {type(pred).__name__}")


# ---------------------------------------------------------------------------
# Expressions (DerivedField subset)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Model evaluation
# ---------------------------------------------------------------------------


def evaluate(doc: ir.PmmlDocument, record: Record) -> EvalResult:
    """Score one record through the document, applying DataDictionary value
    sanitization + mining-schema invalidValueTreatment, missing-value
    replacement and Targets rescaling — the oracle's public entry."""
    rec, invalid = _apply_invalid_treatment(
        doc.data_dictionary, doc.model.mining_schema, record
    )
    if invalid:
        # returnInvalid: the record's result is invalid — an EmptyScore
        # lane under the totality contract (C5), never an exception
        return EvalResult()
    rec = _apply_missing_replacement(doc.model.mining_schema, rec)
    rec = _apply_transformations(doc.transformations, rec)
    res = _eval_model(doc.model, rec)
    res = _apply_targets(doc.targets, res)
    if doc.output_fields and not res.is_missing:
        from flink_jpmml_tpu_torch.pmml.outputs import compute_outputs

        res.outputs = compute_outputs(
            doc.output_fields,
            res.value,
            res.label,
            res.probabilities,
            reason_codes=res.reason_codes,
            # association: the fired-rule ranking feeds ruleValue fields
            rule_ranking=res.rule_ranking,
            # clustering surfaces per-entity comparison scores (its
            # probabilities mapping holds distances/similarities)
            entity_scores=(
                res.probabilities
                if isinstance(doc.model, ir.ClusteringModelIR)
                else None
            ),
            entity_ranking=res.entity_ranking or None,
        )
    return res


def _apply_transformations(
    td: ir.TransformationDictionary, record: Record
) -> Record:
    """TransformationDictionary derived fields extend the record in
    declaration order (later fields may reference earlier ones); a failed
    expression leaves the derived field missing."""
    if not td.derived_fields:
        return record
    out = dict(record)
    for df in td.derived_fields:
        out[df.name] = eval_expression(df.expression, out)
    return out


def _apply_invalid_treatment(
    dd: ir.DataDictionary, schema: ir.MiningSchema, record: Record
) -> Tuple[Record, bool]:
    """DataDictionary validity + mining-schema ``invalidValueTreatment``.

    A value is *invalid* when the string categorical is undeclared (the
    DataField lists valid Values) or a continuous value falls outside the
    DataField's declared Intervals. Per the schema's treatment —
    ``returnInvalid`` (the spec default): the whole record's result is
    invalid; ``asMissing``: the cell becomes missing; ``asIs``: the raw
    value is kept (an undeclared category then simply matches no
    predicate); ``asValue``: the cell takes ``invalidValueReplacement``.
    Float inputs on declared string categoricals are the dense-vector
    convention (pre-encoded codes) and decode back; out-of-table codes
    are invalid too. → (possibly-rewritten record, record_is_invalid).
    """
    # scope: ACTIVE mining fields only — the compiled sanitize stage
    # operates on the active-field space, and a declared-but-inactive
    # column (extra data, the target) must never invalidate a record
    active = set(schema.active_fields)
    decl_cat = {
        f.name: f.values
        for f in dd.fields
        if f.name in active
        and f.is_categorical
        and f.dtype == "string"
        and f.values
    }
    decl_ivl = {
        f.name: f.intervals
        for f in dd.fields
        if f.name in active and f.intervals
    }
    if not decl_cat and not decl_ivl:
        return record, False
    treat = {
        f.name: (f.invalid_value_treatment, f.invalid_value_replacement)
        for f in schema.fields
    }
    out = dict(record)
    invalid_record = False
    for name in set(decl_cat) | set(decl_ivl):
        if name not in out:
            continue
        v = out[name]
        if _is_missing(v):
            continue
        is_invalid = False
        if name in decl_cat:
            values = decl_cat[name]
            if isinstance(v, str):
                is_invalid = v not in values
            elif not math.isfinite(v):
                is_invalid = True
            else:
                idx = int(v)
                if 0 <= idx < len(values) and idx == v:
                    out[name] = values[idx]
                    v = out[name]
                else:
                    is_invalid = True
        else:
            f = _as_float(v)
            if f is not None and not any(
                iv.contains(f) for iv in decl_ivl[name]
            ):
                is_invalid = True
        if not is_invalid:
            continue
        mode, repl = treat.get(name, ("returnInvalid", None))
        if mode == "asIs":
            continue  # keep the raw value
        if mode == "asMissing":
            out[name] = None
        elif mode == "asValue":
            out[name] = repl if repl is not None else None
        else:  # returnInvalid (spec default)
            invalid_record = True
    return out, invalid_record


def _apply_missing_replacement(schema: ir.MiningSchema, record: Record) -> Record:
    replacements = {
        f.name: f.missing_value_replacement
        for f in schema.fields
        if f.missing_value_replacement is not None
    }
    if not replacements:
        return record
    out = dict(record)
    for name, rep in replacements.items():
        if _is_missing(out.get(name)):
            out[name] = rep
    return out


def _apply_targets(targets: Tuple[ir.Target, ...], res: EvalResult) -> EvalResult:
    if not targets or res.value is None:
        return res
    t = targets[0]
    v = res.value * t.rescale_factor + t.rescale_constant
    if t.cast_integer == "round":
        v = float(round(v))
    elif t.cast_integer == "ceiling":
        v = float(math.ceil(v))
    elif t.cast_integer == "floor":
        v = float(math.floor(v))
    # rescale the value only — every other result facet (outputs,
    # reason codes, rule ranking) rides through unchanged
    return dataclasses.replace(res, value=v)


def _eval_model(model: ir.ModelIR, record: Record) -> EvalResult:
    if isinstance(model, ir.TreeModelIR):
        return _eval_tree(model, record)
    if isinstance(model, ir.RegressionModelIR):
        return _eval_regression(model, record)
    if isinstance(model, ir.NeuralNetworkIR):
        return _eval_neural_network(model, record)
    if isinstance(model, ir.ClusteringModelIR):
        return _eval_clustering(model, record)
    if isinstance(model, ir.ScorecardIR):
        return _eval_scorecard(model, record)
    if isinstance(model, ir.RuleSetIR):
        return _eval_ruleset(model, record)
    if isinstance(model, ir.GeneralRegressionIR):
        return _eval_general_regression(model, record)
    if isinstance(model, ir.NaiveBayesIR):
        return _eval_naive_bayes(model, record)
    if isinstance(model, ir.SvmModelIR):
        return _eval_svm(model, record)
    if isinstance(model, ir.NearestNeighborIR):
        return _eval_knn(model, record)
    if isinstance(model, ir.GaussianProcessIR):
        return _eval_gp(model, record)
    if isinstance(model, ir.TimeSeriesIR):
        return _eval_time_series(model, record)
    if isinstance(model, ir.BayesianNetworkIR):
        return _eval_bayesian_network(model, record)
    if isinstance(model, ir.TextModelIR):
        return _eval_text_model(model, record)
    if isinstance(model, ir.BaselineIR):
        return _eval_baseline(model, record)
    if isinstance(model, ir.AssociationIR):
        return _eval_association(model, record)
    if isinstance(model, ir.AnomalyDetectionIR):
        return _eval_anomaly(model, record)
    if isinstance(model, ir.MiningModelIR):
        return _eval_mining(model, record)
    raise ModelCompilationException(f"unsupported model {type(model).__name__}")


# --- Scorecard -------------------------------------------------------------


def _eval_scorecard(model: ir.ScorecardIR, record: Record) -> EvalResult:
    total = model.initial_score
    partials: List[float] = []
    attr_idx: List[int] = []
    for ch in model.characteristics:
        chosen = None
        for ai, at in enumerate(ch.attributes):
            if eval_predicate(at.predicate, record) is True:
                chosen = (ai, at)
                break
        if chosen is None:
            # no attribute matched: the result is invalid (totality C5)
            return EvalResult()
        if chosen[1].partial_expr is not None:
            ps = eval_expression(chosen[1].partial_expr, record)
            if ps is None:
                # ComplexPartialScore failed to compute on the chosen
                # attribute — the record's score is undefined
                return EvalResult()
        else:
            ps = chosen[1].partial_score
        partials.append(ps)
        attr_idx.append(chosen[0])
        total += ps
    res = EvalResult(value=total)
    if model.use_reason_codes:
        meta = _scorecard_reason_meta(model)
        if meta is not None:
            res.reason_codes = tuple(meta.rank(partials, attr_idx))
    return res


_reason_meta_cache: dict = {}  # id(model) -> (weakref, meta|None)


def _scorecard_reason_meta(model: ir.ScorecardIR):
    """Per-document ReasonCodeMeta, built once per model *instance* —
    identity-keyed with a weakref cleanup, so swapped-out served models
    are never pinned and no per-record re-hash of the IR tree happens.
    None when codes/baselines are incomplete; that is surfaced at
    compile time iff an Output actually requests reason codes."""
    import weakref

    from flink_jpmml_tpu_torch.compile.scorecard import ReasonCodeMeta

    key = id(model)
    hit = _reason_meta_cache.get(key)
    if hit is not None and hit[0]() is model:
        return hit[1]
    try:
        meta = ReasonCodeMeta(model)
    except ModelCompilationException:
        meta = None
    ref = weakref.ref(
        model, lambda _r, _k=key: _reason_meta_cache.pop(_k, None)
    )
    _reason_meta_cache[key] = (ref, meta)
    return meta


# --- RuleSet ---------------------------------------------------------------


def _eval_ruleset(model: ir.RuleSetIR, record: Record) -> EvalResult:
    fired = [
        r for r in model.rules
        if eval_predicate(r.predicate, record) is True
    ]
    if not fired:
        if model.default_score is None:
            return EvalResult()
        return EvalResult(
            value=model.default_confidence, label=model.default_score
        )
    m = model.selection_method
    if m == "firstHit":
        r = fired[0]
        return EvalResult(value=r.confidence, label=r.score)
    if m == "weightedMax":
        r = max(fired, key=lambda rr: rr.weight)  # ties: first wins
        return EvalResult(value=r.confidence, label=r.score)
    if m == "weightedSum":
        labels: List[str] = []
        for r in model.rules:
            if r.score not in labels:
                labels.append(r.score)
        totals = {s: 0.0 for s in labels}
        for r in fired:
            totals[r.score] += r.weight
        best = labels[0]
        for s in labels:  # first-appearance order breaks ties
            if totals[s] > totals[best]:
                best = s
        return EvalResult(value=totals[best] / len(fired), label=best)
    raise ModelCompilationException(
        f"unsupported RuleSelectionMethod {m!r}"
    )


# --- TreeModel -------------------------------------------------------------


def _node_result(node: ir.TreeNode, function_name: str) -> EvalResult:
    if function_name == "classification":
        probs: Dict[str, float] = {}
        total = sum(sd.record_count for sd in node.score_distribution)
        for sd in node.score_distribution:
            if sd.probability is not None:
                probs[sd.value] = sd.probability
            elif total > 0:
                probs[sd.value] = sd.record_count / total
        label = node.score
        if label is None and probs:
            label = max(probs, key=probs.get)
        value = probs.get(label) if label is not None and probs else None
        return EvalResult(value=value, label=label, probabilities=probs)
    v = _as_float(node.score) if node.score is not None else None
    return EvalResult(value=v)


_TREE_STRATEGIES = (
    "none", "defaultChild", "lastPrediction", "nullPrediction",
    "weightedConfidence", "aggregateNodes",
)


def _eval_tree_weighted(
    model: ir.TreeModelIR, record: Record
) -> EvalResult:
    """weightedConfidence / aggregateNodes: an UNKNOWN split routes into
    every viable child weighted by recordCount share; leaves aggregate
    weight-normalized (see compile/wtrees.py for the shared semantics)."""
    strategy = model.missing_value_strategy
    classification = model.function_name == "classification"
    if strategy == "weightedConfidence" and not classification:
        raise ModelCompilationException(
            "weightedConfidence applies to classification trees"
        )
    if strategy == "aggregateNodes" and classification:
        raise ModelCompilationException(
            "aggregateNodes applies to regression trees"
        )
    leaves: List[Tuple[float, ir.TreeNode]] = []

    def walk(n: ir.TreeNode, w: float) -> None:
        if n.is_leaf:
            leaves.append((w, n))
            return
        results = [
            (c, eval_predicate(c.predicate, record)) for c in n.children
        ]
        for c, r in results:
            if r is True:
                walk(c, w)
                return
        viable = [(c, r) for c, r in results if r is None]
        if not viable:
            return  # dead end: this weight is lost
        rcs = []
        for c, _ in viable:
            if c.record_count is None:
                raise ModelCompilationException(
                    f"{strategy} needs recordCount on every child node "
                    f"(missing on node {c.node_id!r})"
                )
            rcs.append(max(float(c.record_count), 0.0))
        tot = sum(rcs)
        if tot <= 0:
            return
        for (c, _), rc in zip(viable, rcs):
            walk(c, w * rc / tot)

    if eval_predicate(model.root.predicate, record) is not True:
        return EvalResult()
    walk(model.root, 1.0)
    total = sum(w for w, _ in leaves)
    if total <= 0:
        return EvalResult()
    if classification:
        agg: Dict[str, float] = {}
        for w, leaf in leaves:
            if not leaf.score_distribution:
                raise ModelCompilationException(
                    "weightedConfidence needs a ScoreDistribution on "
                    "every leaf"
                )
            t = sum(sd.record_count for sd in leaf.score_distribution)
            for sd in leaf.score_distribution:
                conf = (
                    sd.confidence
                    if sd.confidence is not None
                    else (sd.record_count / t if t > 0 else 0.0)
                )
                agg[sd.value] = agg.get(sd.value, 0.0) + w * conf
        # every leaf's score attribute joins the label space (it may
        # legally be absent from the distributions; its confidence is 0)
        for _, leaf in leaves:
            if leaf.score is not None:
                agg.setdefault(leaf.score, 0.0)
        probs = {k: v / total for k, v in agg.items()}
        # deterministic path (all weight on one leaf): the leaf's score
        # attribute wins — exactly like the non-weighted strategies; it
        # may legally disagree with the max confidence
        wbest, lbest = max(leaves, key=lambda t: t[0])
        if wbest >= total - 1e-12 and lbest.score is not None:
            label = lbest.score
        else:
            label = max(probs, key=lambda k: probs[k])
        return EvalResult(
            value=probs.get(label), label=label, probabilities=probs
        )
    s = 0.0
    for w, leaf in leaves:
        v = _as_float(leaf.score)
        if v is None:
            raise ModelCompilationException(
                "aggregateNodes needs a numeric score on every leaf"
            )
        s += w * v
    return EvalResult(value=s / total)


def _eval_tree(model: ir.TreeModelIR, record: Record) -> EvalResult:
    if model.missing_value_strategy not in _TREE_STRATEGIES:
        raise ModelCompilationException(
            f"unsupported missingValueStrategy {model.missing_value_strategy!r} "
            f"(supported: {', '.join(_TREE_STRATEGIES)})"
        )
    if model.missing_value_strategy in (
        "weightedConfidence", "aggregateNodes"
    ):
        return _eval_tree_weighted(model, record)
    node = model.root
    if eval_predicate(node.predicate, record) is not True:
        return EvalResult()
    last_scored = node if node.score is not None or node.score_distribution else None
    while not node.is_leaf:
        chosen: Optional[ir.TreeNode] = None
        unknown = False
        for child in node.children:
            r = eval_predicate(child.predicate, record)
            if r is True:
                chosen = child
                break
            if r is None:
                unknown = True
                if model.missing_value_strategy in ("defaultChild", "lastPrediction",
                                                    "nullPrediction"):
                    break
        if chosen is None:
            strat = model.missing_value_strategy
            if unknown and strat == "defaultChild":
                chosen = _default_child(node)
                if chosen is None:
                    return EvalResult()
            elif unknown and strat == "lastPrediction":
                return (
                    _node_result(last_scored, model.function_name)
                    if last_scored is not None
                    else EvalResult()
                )
            elif unknown and strat == "nullPrediction":
                return EvalResult()
            else:
                # no child matched (or strategy 'none' treats UNKNOWN as no-match)
                if model.no_true_child_strategy == "returnLastPrediction":
                    return (
                        _node_result(last_scored, model.function_name)
                        if last_scored is not None
                        else EvalResult()
                    )
                return EvalResult()
        node = chosen
        if node.score is not None or node.score_distribution:
            last_scored = node
    return _node_result(node, model.function_name)


def _default_child(node: ir.TreeNode) -> Optional[ir.TreeNode]:
    if node.default_child is None:
        return None
    for c in node.children:
        if c.node_id == node.default_child:
            return c
    return None


# --- RegressionModel -------------------------------------------------------


def _eval_table(table: ir.RegressionTable, record: Record) -> Optional[float]:
    y = table.intercept
    for p in table.numeric_predictors:
        x = _as_float(record.get(p.name))
        if x is None:
            return None  # missing numeric input ⇒ table value missing
        y += p.coefficient * (x ** p.exponent)
    for p in table.categorical_predictors:
        v = record.get(p.name)
        if _is_missing(v):
            continue  # missing categorical input contributes 0
        if _values_equal(v, p.value):
            y += p.coefficient
    return y


def _eval_regression(model: ir.RegressionModelIR, record: Record) -> EvalResult:
    raw = [_eval_table(t, record) for t in model.tables]
    nm = model.normalization_method
    if model.function_name == "regression":
        y = raw[0]
        if y is None:
            return EvalResult()
        if nm in ("none", "identity"):
            return EvalResult(value=y)
        if nm == "softmax" or nm == "logit":
            return EvalResult(value=1.0 / (1.0 + math.exp(-y)))
        if nm == "exp":
            return EvalResult(value=math.exp(y))
        if nm == "cauchit":
            return EvalResult(value=0.5 + math.atan(y) / math.pi)
        if nm == "cloglog":
            return EvalResult(value=1.0 - math.exp(-math.exp(y)))
        if nm == "loglog":
            return EvalResult(value=math.exp(-math.exp(-y)))
        if nm == "probit":
            return EvalResult(value=0.5 * (1.0 + math.erf(y / math.sqrt(2.0))))
        raise ModelCompilationException(f"unsupported normalization {nm!r}")

    # classification: one table per target category
    if any(y is None for y in raw):
        return EvalResult()
    cats = [t.target_category or str(i) for i, t in enumerate(model.tables)]
    if nm == "softmax":
        m = max(raw)
        exps = [math.exp(y - m) for y in raw]
        s = sum(exps)
        probs = {c: e / s for c, e in zip(cats, exps)}
    elif nm == "simplemax":
        s = sum(raw)
        probs = {c: y / s for c, y in zip(cats, raw)} if s != 0 else {}
    elif nm in ("none", "identity"):
        probs = {c: y for c, y in zip(cats, raw)}
    elif nm == "logit":
        if len(raw) == 2:
            p = 1.0 / (1.0 + math.exp(-raw[0]))
            probs = {cats[0]: p, cats[1]: 1.0 - p}
        else:
            probs = {c: 1.0 / (1.0 + math.exp(-y)) for c, y in zip(cats, raw)}
    else:
        raise ModelCompilationException(f"unsupported normalization {nm!r}")
    if not probs:
        return EvalResult()
    label = max(probs, key=probs.get)
    return EvalResult(value=probs[label], label=label, probabilities=probs)


# --- NeuralNetwork ---------------------------------------------------------

_ACTIVATIONS = {
    "logistic": lambda z: 1.0 / (1.0 + math.exp(-z)),
    "tanh": math.tanh,
    "identity": lambda z: z,
    "rectifier": lambda z: max(0.0, z),
    # PMML 4.x defines arctan as 2*arctan(Z)/pi (range (-1, 1))
    "arctan": lambda z: 2.0 * math.atan(z) / math.pi,
    "cosine": math.cos,
    "sine": math.sin,
    "square": lambda z: z * z,
    "Gauss": lambda z: math.exp(-z * z),
    "reciprocal": lambda z: 1.0 / z,
    "exponential": math.exp,
    "Elliott": lambda z: z / (1.0 + abs(z)),
    "elliott": lambda z: z / (1.0 + abs(z)),  # lenient-case alias
}


def _eval_neural_network(model: ir.NeuralNetworkIR, record: Record) -> EvalResult:
    acts: Dict[str, float] = {}
    for ni in model.inputs:
        v = eval_expression(ni.derived_field.expression, record)
        if v is None:
            return EvalResult()
        acts[ni.neuron_id] = v
    for layer in model.layers:
        fn_name = layer.activation or model.activation_function
        zs = {}
        if fn_name == "threshold":
            thr = (
                layer.threshold
                if layer.threshold is not None
                else model.threshold
            )
            for n in layer.neurons:
                z = n.bias + sum(acts[src] * w for src, w in n.weights)
                zs[n.neuron_id] = 1.0 if z > thr else 0.0
        elif fn_name == "radialBasis":
            for n in layer.neurons:
                width = (
                    n.width
                    if n.width is not None
                    else (
                        layer.width
                        if layer.width is not None
                        else model.width
                    )
                )
                if width is None or width <= 0:
                    raise ModelCompilationException(
                        f"radialBasis neuron {n.neuron_id!r} has no "
                        "positive width"
                    )
                alt = (
                    n.altitude
                    if n.altitude is not None
                    else (
                        layer.altitude
                        if layer.altitude is not None
                        else model.altitude
                    )
                )
                z = sum((w - acts[src]) ** 2 for src, w in n.weights)
                zs[n.neuron_id] = math.exp(
                    len(n.weights) * math.log(alt)
                    - z / (2.0 * width * width)
                )
        else:
            fn = _ACTIVATIONS.get(fn_name)
            if fn is None:
                raise ModelCompilationException(
                    f"unsupported activation {fn_name!r}"
                )
            for n in layer.neurons:
                z = n.bias + sum(acts[src] * w for src, w in n.weights)
                zs[n.neuron_id] = fn(z)
        norm = layer.normalization or (
            model.normalization_method if layer is model.layers[-1] else "none"
        )
        if norm == "softmax":
            m = max(zs.values())
            exps = {k: math.exp(v - m) for k, v in zs.items()}
            s = sum(exps.values())
            zs = {k: v / s for k, v in exps.items()}
        elif norm == "simplemax":
            s = sum(zs.values())
            if s != 0:
                zs = {k: v / s for k, v in zs.items()}
        acts.update(zs)

    if model.function_name == "classification":
        probs: Dict[str, float] = {}
        for no in model.outputs:
            expr = no.derived_field.expression
            if isinstance(expr, ir.NormDiscrete):
                probs[expr.value] = acts[no.output_neuron]
            else:
                raise ModelCompilationException(
                    "classification NeuralOutput must map via NormDiscrete"
                )
        if not probs:
            return EvalResult()
        label = max(probs, key=probs.get)
        return EvalResult(value=probs[label], label=label, probabilities=probs)

    # regression: single output neuron, optionally denormalized
    if not model.outputs:
        return EvalResult()
    no = model.outputs[0]
    y = acts[no.output_neuron]
    expr = no.derived_field.expression
    if isinstance(expr, ir.NormContinuous):
        y = _denorm_continuous(y, expr)
    elif not isinstance(expr, ir.FieldRef):
        raise ModelCompilationException(
            f"unsupported NeuralOutput expression {type(expr).__name__}"
        )
    return EvalResult(value=y)


def _denorm_continuous(y: float, expr: ir.NormContinuous) -> float:
    """NeuralOutput NormContinuous runs *backwards*: network output is in
    norm space, result in orig space."""
    ns = expr.norms
    for a, b in zip(ns, ns[1:]):
        if y <= b.norm or b is ns[-1]:
            if b.norm == a.norm:
                return a.orig
            t = (y - a.norm) / (b.norm - a.norm)
            return a.orig + t * (b.orig - a.orig)
    return ns[-1].orig


# --- ClusteringModel -------------------------------------------------------


def _binary_similarity(
    measure: ir.ComparisonMeasure,
    xs: List[float],
    zs,
    weights: List[float],
) -> float:
    """Shared binary-similarity math (see compile/clustering.py
    similarity_params): weighted contingency counts → ratio."""
    from flink_jpmml_tpu_torch.compile.clustering import similarity_params

    num, den = similarity_params(measure)
    a = b = c = d = 0.0
    for x, z, w in zip(xs, zs, weights):
        xb, zb = x > 0.5, z > 0.5
        if xb and zb:
            a += w
        elif xb:
            b += w
        elif zb:
            c += w
        else:
            d += w
    numer = num[0] * a + num[1] * b + num[2] * c + num[3] * d
    denom = den[0] * a + den[1] * b + den[2] * c + den[3] * d
    return numer / denom if denom > 0 else 0.0


def _eval_clustering(model: ir.ClusteringModelIR, record: Record) -> EvalResult:
    from flink_jpmml_tpu_torch.compile.clustering import resolve_compare

    xs: List[Optional[float]] = []
    weights: List[float] = []
    for cf in model.clustering_fields:
        xs.append(_as_float(record.get(cf.field)))
        weights.append(cf.weight)
    mvw = model.missing_value_weights
    adjust = 1.0
    if any(x is None for x in xs):
        # MissingValueWeights opts into adjustment: missing terms drop
        # out and sum metrics rescale by Σq / Σ_nonmissing q; without
        # the element (or under similarity) a missing field stays a
        # strict empty lane
        if not mvw or model.measure.kind == "similarity":
            return EvalResult()
        q_nonmiss = sum(q for q, x in zip(mvw, xs) if x is not None)
        if q_nonmiss <= 0:
            return EvalResult()  # no weighted evidence at all
        adjust = sum(mvw) / q_nonmiss
    if model.measure.kind == "similarity":
        sims = [
            _binary_similarity(model.measure, xs, cl.center, weights)
            for cl in model.clusters
        ]
        best_idx = max(range(len(sims)), key=lambda i: sims[i])
        labels = [
            cl.cluster_id or cl.name or str(i + 1)
            for i, cl in enumerate(model.clusters)
        ]
        res = EvalResult(
            value=float(best_idx), label=labels[best_idx],
            probabilities=dict(zip(labels, sims)),
        )
        res.entity_ranking = tuple(
            labels[i] for i in sorted(
                range(len(sims)), key=lambda i: (-sims[i], i)
            )
        )
        return res
    cmp_codes, gauss_s = resolve_compare(model)
    mink_p = float(model.measure.minkowski_p)
    best_idx, best_dist = -1, math.inf
    dists: List[float] = []
    for i, cl in enumerate(model.clusters):
        if len(cl.center) != len(xs):
            raise ModelCompilationException(
                f"cluster {i} center arity {len(cl.center)} != fields {len(xs)}"
            )
        cs = []
        for j, (x, z) in enumerate(zip(xs, cl.center)):
            if x is None:
                cs.append(None)  # dropped term (MissingValueWeights)
                continue
            code = int(cmp_codes[j])
            if code == 1:  # gaussSim: exp(−ln2·(x−z)²/s²)
                s = float(gauss_s[j])
                cs.append(math.exp(-math.log(2.0) * (x - z) ** 2 / (s * s)))
            elif code == 2:  # delta
                cs.append(0.0 if x == z else 1.0)
            elif code == 3:  # equal
                cs.append(1.0 if x == z else 0.0)
            else:  # absDiff
                cs.append(abs(x - z))
        terms = [
            (w, c) for w, c in zip(weights, cs) if c is not None
        ]
        m = model.measure.metric
        # spec aggregation: the field weight multiplies the *powered*
        # comparison (Σ w·c², not Σ (w·c)²); ``adjust`` rescales the
        # sums when missing terms dropped out (chebychev is a max)
        if m == "squaredEuclidean":
            d = adjust * sum(w * c * c for w, c in terms)
        elif m == "euclidean":
            d = math.sqrt(adjust * sum(w * c * c for w, c in terms))
        elif m == "cityBlock":
            d = adjust * sum(w * c for w, c in terms)
        elif m == "chebychev":
            d = max(w * c for w, c in terms)
        elif m == "minkowski":
            d = (
                adjust * sum(w * abs(c) ** mink_p for w, c in terms)
            ) ** (1.0 / mink_p)
        else:
            raise ModelCompilationException(f"unsupported metric {m!r}")
        dists.append(d)
        if d < best_dist:
            best_idx, best_dist = i, d
    labels = [
        cl.cluster_id or cl.name or str(i + 1)
        for i, cl in enumerate(model.clusters)
    ]
    # per-cluster distances keyed by cluster label — the same shape the
    # compiled decode exposes (target.probabilities), so top-level
    # <Output> probability fields agree between the two paths
    res = EvalResult(value=float(best_idx), label=labels[best_idx],
                     probabilities=dict(zip(labels, dists)))
    res.entity_ranking = tuple(
        labels[i] for i in sorted(
            range(len(dists)), key=lambda i: (dists[i], i)
        )
    )
    return res


# --- GeneralRegressionModel ------------------------------------------------


def _glm_inverse_link(name, eta, power=None):
    if name in (None, "identity"):
        return eta
    if name == "log":
        return math.exp(eta)
    if name == "logit":
        return 1.0 / (1.0 + math.exp(-eta))
    if name == "cloglog":
        return 1.0 - math.exp(-math.exp(eta))
    if name == "loglog":
        return math.exp(-math.exp(-eta))
    if name == "probit":
        return 0.5 * (1.0 + math.erf(eta / math.sqrt(2.0)))
    if name == "inverse":
        # η = 0 → signed infinity, matching the compiled 1/±0.0
        if eta == 0:
            return math.copysign(math.inf, eta)
        return 1.0 / eta
    if name == "cauchit":
        return 0.5 + math.atan(eta) / math.pi
    if name == "power":
        if power is None or power == 0:
            raise ModelCompilationException(
                "power link needs a non-zero linkParameter"
            )
        try:
            # math.pow, not **: a negative η with fractional 1/power must
            # be NaN like the compiled jnp.power, never complex
            return math.pow(eta, 1.0 / power)
        except (ValueError, OverflowError):
            return float("nan")
    raise ModelCompilationException(f"unsupported linkFunction {name!r}")


def _eval_general_regression(
    model: ir.GeneralRegressionIR, record: Record
) -> EvalResult:
    factor_set = set(model.factors)
    x: Dict[str, float] = {p: 1.0 for p in model.parameters}
    for cell in model.pp_cells:
        v = record.get(cell.predictor)
        if _is_missing(v):
            return EvalResult()  # GLMs have no missing-value routing
        if cell.predictor in factor_set:
            x[cell.parameter] *= (
                1.0 if _values_equal(v, cell.value) else 0.0
            )
        else:
            f = _as_float(v)
            if f is None:
                return EvalResult()
            try:
                expo = float(cell.value)
            except ValueError:
                raise ModelCompilationException(
                    f"covariate PPCell value {cell.value!r} is not a "
                    "number (exponent)"
                ) from None
            try:
                # math.pow (not **): a negative base with a fractional
                # exponent must become NaN like the compiled jnp.power,
                # never a complex number
                x[cell.parameter] *= math.pow(f, expo)
            except (ValueError, OverflowError):
                x[cell.parameter] *= float("nan")

    if model.model_type == "CoxRegression":
        if not model.baseline_cells or model.end_time_variable is None:
            raise ModelCompilationException(
                "CoxRegression needs endTimeVariable and "
                "BaseCumHazardTables"
            )
        t = _as_float(record.get(model.end_time_variable))
        if t is None:
            return EvalResult()
        if model.max_time is not None and t > model.max_time:
            # the fitted baseline covers [0, maxTime]; beyond it the
            # hazard is undefined — empty lane, not extrapolation
            return EvalResult()
        eta = 0.0
        for c in model.p_cells:
            if c.target_category is not None:
                raise ModelCompilationException(
                    "CoxRegression PCells take no targetCategory"
                )
            if c.parameter not in x:
                raise ModelCompilationException(
                    f"PCell references unknown parameter {c.parameter!r}"
                )
            eta += c.beta * x[c.parameter]
        # step lookup: largest baseline time <= t (before the first
        # event time the baseline hazard is 0); beyond maxTime the
        # hazard stays at the last cell (no extrapolation)
        h0 = 0.0
        for time_, haz in model.baseline_cells:
            if time_ <= t:
                h0 = haz
            else:
                break
        surv = math.exp(-h0 * math.exp(eta))
        return EvalResult(value=surv)

    if model.model_type == "ordinalMultinomial":
        cats_o = list(model.target_categories)
        if len(cats_o) < 2:
            raise ModelCompilationException(
                "ordinalMultinomial needs resolved target_categories "
                "(parse_pmml fills them from the target DataField)"
            )
        shared = 0.0
        thresh = {c: 0.0 for c in cats_o[:-1]}
        for c in model.p_cells:
            if c.parameter not in x:
                raise ModelCompilationException(
                    f"PCell references unknown parameter {c.parameter!r}"
                )
            if c.target_category is None:
                shared += c.beta * x[c.parameter]
            elif c.target_category in thresh:
                thresh[c.target_category] += c.beta * x[c.parameter]
            else:
                raise ModelCompilationException(
                    f"ordinalMultinomial PCell targets {c.target_category!r}"
                    " — the LAST category carries no threshold"
                )
        # cumulative link: P(y <= c_j) = g⁻¹(α_j + shared)
        cum = [
            _glm_inverse_link(
                model.cumulative_link, thresh[c] + shared, None
            )
            for c in cats_o[:-1]
        ]
        probs_l = [cum[0]]
        for j in range(1, len(cum)):
            probs_l.append(cum[j] - cum[j - 1])
        probs_l.append(1.0 - cum[-1])
        probs = dict(zip(cats_o, probs_l))
        label = max(cats_o, key=lambda c: probs[c])
        return EvalResult(
            value=probs[label], label=label, probabilities=probs
        )

    if model.model_type == "multinomialLogistic":
        cats: List[str] = []
        for c in model.p_cells:
            if c.target_category is not None and c.target_category not in cats:
                cats.append(c.target_category)
        ref = model.target_reference_category
        if ref is None:
            # parse_pmml resolves this for top-level models; only a
            # hand-built IR can reach here unresolved
            raise ModelCompilationException(
                "multinomialLogistic needs targetReferenceCategory"
            )
        if ref in cats:
            cats.remove(ref)
        etas = {c: 0.0 for c in cats}
        for c in model.p_cells:
            if c.parameter not in x:
                raise ModelCompilationException(
                    f"PCell references unknown parameter {c.parameter!r}"
                )
            if c.target_category in etas:
                etas[c.target_category] += c.beta * x[c.parameter]
        all_cats = cats + [ref]
        zs = [etas[c] for c in cats] + [0.0]
        mz = max(zs)
        es = [math.exp(z - mz) for z in zs]
        s = sum(es)
        probs = {c: e / s for c, e in zip(all_cats, es)}
        label = max(all_cats, key=lambda c: probs[c])
        return EvalResult(
            value=probs[label], label=label, probabilities=probs
        )

    eta = 0.0
    for c in model.p_cells:
        if c.target_category is not None:
            # same typed rejection as the lowering — summing per-category
            # betas into one eta would be a plausible-looking wrong score
            raise ModelCompilationException(
                f"modelType {model.model_type!r} with per-category "
                "PCells — use multinomialLogistic"
            )
        if c.parameter not in x:
            raise ModelCompilationException(
                f"PCell references unknown parameter {c.parameter!r}"
            )
        eta += c.beta * x[c.parameter]
    link = (
        model.link_function
        if model.model_type == "generalizedLinear"
        else "identity"
    )
    return EvalResult(
        value=_glm_inverse_link(link, eta, model.link_power)
    )


# --- NaiveBayes ------------------------------------------------------------


def _eval_naive_bayes(model: ir.NaiveBayesIR, record: Record) -> EvalResult:
    labels = [v for v, _ in model.target_counts]
    totals = {v: c for v, c in model.target_counts}
    if any(c <= 0 for c in totals.values()):
        # same typed validation as the lowering — never a raw math
        # domain error out of the oracle
        raise ModelCompilationException(
            "BayesOutput target counts must all be positive"
        )
    L = {t: math.log(totals[t]) for t in labels}
    thr = model.threshold
    for bi in model.inputs:
        v = record.get(bi.field)
        if _is_missing(v):
            continue  # missing inputs drop their term
        if isinstance(bi, ir.BayesCategoricalInput):
            row = None
            for value, counts in bi.counts:
                if _values_equal(v, value):
                    row = dict(counts)
                    break
            if row is None:
                continue  # unknown input value: term dropped
            for t in labels:
                p = row.get(t, 0.0) / totals[t]
                if p <= 0 and thr <= 0:
                    raise ModelCompilationException(
                        f"BayesInput {bi.field!r}: zero conditional "
                        "probability with no positive model threshold"
                    )
                L[t] += math.log(p if p > 0 else thr)
        else:
            f = _as_float(v)
            if f is None:
                continue
            stats = {tv: (m, var) for tv, m, var in bi.stats}
            for t in labels:
                if t not in stats:
                    continue
                m, var = stats[t]
                L[t] += -0.5 * math.log(2.0 * math.pi * var) - (
                    (f - m) ** 2 / (2.0 * var)
                )
    mz = max(L.values())
    es = {t: math.exp(L[t] - mz) for t in labels}
    s = sum(es.values())
    probs = {t: e / s for t, e in es.items()}
    label = max(labels, key=lambda t: probs[t])
    return EvalResult(value=probs[label], label=label, probabilities=probs)


# --- SupportVectorMachine --------------------------------------------------


def _svm_kernel_value(kernel: ir.SvmKernel, x: List[float], s) -> float:
    dot = sum(a * b for a, b in zip(x, s))
    if kernel.kind == "linear":
        return dot
    if kernel.kind == "polynomial":
        try:
            # math.pow: negative base with fractional degree must be NaN
            # like the compiled jnp.power, never complex
            return math.pow(kernel.gamma * dot + kernel.coef0, kernel.degree)
        except (ValueError, OverflowError):
            return float("nan")
    if kernel.kind == "sigmoid":
        return math.tanh(kernel.gamma * dot + kernel.coef0)
    if kernel.kind == "radialBasis":
        d2 = sum((a - b) ** 2 for a, b in zip(x, s))
        return math.exp(-kernel.gamma * d2)
    raise ModelCompilationException(
        f"unsupported SVM kernel {kernel.kind!r}"
    )


def _eval_svm(model: ir.SvmModelIR, record: Record) -> EvalResult:
    xs: List[float] = []
    for f in model.vector_fields:
        v = _as_float(record.get(f))
        if v is None:
            return EvalResult()  # SVMs have no missing-value routing
        xs.append(v)
    coords = {vid: c for vid, c in model.vectors}
    kv = {
        vid: _svm_kernel_value(model.kernel, xs, c)
        for vid, c in coords.items()
    }
    fs = []
    for m in model.machines:
        f = m.intercept
        for vid, alpha in zip(m.vector_ids, m.coefficients):
            if vid not in kv:
                raise ModelCompilationException(
                    f"SupportVector references unknown vectorId {vid!r}"
                )
            f += alpha * kv[vid]
        fs.append(f)

    if model.function_name != "classification":
        if len(model.machines) != 1:
            # same typed rejection as the lowering
            raise ModelCompilationException(
                f"regression SVM needs exactly one machine, got "
                f"{len(model.machines)}"
            )
        return EvalResult(value=fs[0])

    labels: List[str] = []
    for m in model.machines:
        for cat in (m.target_category, m.alternate_target_category):
            if cat is not None and cat not in labels:
                labels.append(cat)
    if model.classification_method == "OneAgainstOne":
        counts = {c: 0.0 for c in labels}
        for m, f in zip(model.machines, fs):
            if (
                m.target_category is None
                or m.alternate_target_category is None
            ):
                # same typed rejection as the lowering
                raise ModelCompilationException(
                    "OneAgainstOne machines need targetCategory and "
                    "alternateTargetCategory"
                )
            thr = m.threshold if m.threshold is not None else model.threshold
            # f < threshold votes targetCategory (module convention —
            # see compile/svm.py docstring)
            winner = (
                m.target_category
                if f < thr
                else m.alternate_target_category
            )
            counts[winner] += 1.0
        label = labels[0]
        for c in labels:  # document order breaks ties
            if counts[c] > counts[label]:
                label = c
        total = sum(counts.values())
        probs = {c: counts[c] / total for c in labels}
        return EvalResult(value=probs[label], label=label,
                          probabilities=probs)
    # OneAgainstAll: smallest decision value wins
    scores = {c: math.inf for c in labels}
    for m, f in zip(model.machines, fs):
        if m.target_category is None:
            raise ModelCompilationException(
                "OneAgainstAll machines need targetCategory"
            )
        scores[m.target_category] = min(scores[m.target_category], f)
    label = labels[0]
    for c in labels:
        if scores[c] < scores[label]:
            label = c
    return EvalResult(value=scores[label], label=label)


# --- NearestNeighbor -------------------------------------------------------


def _knn_field_compare(ki: ir.KnnInput, measure, x: float, s: float) -> float:
    """Pure-math per-field comparison — independent of the compiled
    distance code, like the clustering oracle, so compiled-vs-oracle
    parity still catches lowering bugs."""
    name = ki.compare_function or measure.compare_function
    if name == "gaussSim":
        sc = ki.similarity_scale
        if sc is None or sc <= 0:
            raise ModelCompilationException(
                f"gaussSim on field {ki.field!r} needs a positive "
                "similarityScale"
            )
        return math.exp(-math.log(2.0) * (x - s) ** 2 / (sc * sc))
    if name == "delta":
        return 0.0 if x == s else 1.0
    if name == "equal":
        return 1.0 if x == s else 0.0
    if name == "absDiff":
        return abs(x - s)
    raise ModelCompilationException(
        f"unsupported compareFunction {name!r} on field {ki.field!r}"
    )


def _eval_knn(model: ir.NearestNeighborIR, record: Record) -> EvalResult:
    similarity = model.measure.kind == "similarity"
    xs: List[float] = []
    for ki in model.inputs:
        v = _as_float(record.get(ki.field))
        if v is None:
            return EvalResult()  # no missing-value routing
        xs.append(v)
    metric = model.measure.metric
    mink_p = model.measure.minkowski_p
    if similarity:
        # binary-similarity neighbors: the k LARGEST similarities win
        ws = [ki.weight for ki in model.inputs]
        ds = [
            _binary_similarity(model.measure, xs, inst, ws)
            for inst in model.instances
        ]
        order = sorted(range(len(ds)), key=lambda i: (-ds[i], i))[
            : model.n_neighbors
        ]
        return _knn_aggregate(model, ds, order, similarity=True)
    if metric == "minkowski" and mink_p <= 0:
        # same typed rejection as the lowering (make_distance)
        raise ModelCompilationException(
            f"minkowski needs a positive p-parameter, got {mink_p}"
        )
    ds: List[float] = []
    for inst in model.instances:
        terms = [
            (ki.weight, _knn_field_compare(ki, model.measure, x, s))
            for ki, x, s in zip(model.inputs, xs, inst)
        ]
        if metric == "squaredEuclidean":
            d = sum(w * c * c for w, c in terms)
        elif metric == "euclidean":
            d = math.sqrt(sum(w * c * c for w, c in terms))
        elif metric == "cityBlock":
            d = sum(w * c for w, c in terms)
        elif metric == "chebychev":
            d = max(w * c for w, c in terms)
        elif metric == "minkowski":
            d = sum(w * abs(c) ** mink_p for w, c in terms) ** (1.0 / mink_p)
        else:
            raise ModelCompilationException(
                f"unsupported metric {metric!r}"
            )
        ds.append(d)
    order = sorted(range(len(ds)), key=lambda i: (ds[i], i))[
        : model.n_neighbors
    ]
    return _knn_aggregate(model, ds, order, similarity=False)


def _knn_aggregate(
    model: ir.NearestNeighborIR,
    ds: List[float],
    order: List[int],
    similarity: bool,
) -> EvalResult:
    """Top-k aggregation shared by the distance and similarity paths;
    "weighted" variants weight by 1/(d+eps) (distance) or the
    similarity itself."""
    eps = 1e-9

    def nb_weight(i: int) -> float:
        return ds[i] if similarity else 1.0 / (ds[i] + eps)

    ranking = (
        tuple(model.instance_ids[i] for i in order)
        if model.instance_ids
        else ()
    )

    if model.function_name == "classification":
        if model.categorical_scoring not in (
            "majorityVote", "weightedMajorityVote",
        ):
            raise ModelCompilationException(
                f"unsupported categoricalScoringMethod "
                f"{model.categorical_scoring!r}"
            )
        labels: List[str] = []
        for t in model.targets:
            if t not in labels:
                labels.append(t)
        weighted = model.categorical_scoring == "weightedMajorityVote"
        votes = {c: 0.0 for c in labels}
        for i in order:
            votes[model.targets[i]] += nb_weight(i) if weighted else 1.0
        label = labels[0]
        for c in labels:  # first-appearance order breaks ties
            if votes[c] > votes[label]:
                label = c
        total = sum(votes.values())
        probs = {c: votes[c] / max(total, eps) for c in labels}
        res = EvalResult(value=probs[label], label=label,
                         probabilities=probs)
        res.entity_ranking = ranking
        return res
    m = model.continuous_scoring
    if m not in ("average", "median", "weightedAverage"):
        raise ModelCompilationException(
            f"unsupported continuousScoringMethod {m!r}"
        )
    try:
        yk = [float(model.targets[i]) for i in order]
    except ValueError:
        # same typed rejection as the lowering
        raise ModelCompilationException(
            "regression KNN needs numeric training targets"
        ) from None
    if m == "average":
        value = sum(yk) / len(yk)
    elif m == "median":
        ys = sorted(yk)
        n = len(ys)
        value = (
            ys[n // 2] if n % 2 else 0.5 * (ys[n // 2 - 1] + ys[n // 2])
        )
    else:  # weightedAverage
        ws = [nb_weight(i) for i in order]
        tw = sum(ws)
        if tw <= 0:
            # similarity path: a record sharing no set bit with any
            # neighbor has all-zero weights — undefined average, empty
            return EvalResult()
        value = sum(y * w for y, w in zip(yk, ws)) / tw
    res = EvalResult(value=value)
    res.entity_ranking = ranking
    return res


# --- AnomalyDetection ------------------------------------------------------


def _gp_kernel_value(
    kernel: ir.GpKernel, x: List[float], z: Sequence[float]
) -> float:
    lam = list(kernel.lambdas)
    if len(lam) == 1:
        lam = lam * len(x)
    if kernel.kind == "radialBasis":
        s = sum((a - b) ** 2 for a, b in zip(x, z))
        return kernel.gamma * math.exp(-s / (2.0 * lam[0] ** 2))
    if kernel.kind == "ARDSquaredExponential":
        s = sum(((a - b) / l) ** 2 for a, b, l in zip(x, z, lam))
        return kernel.gamma * math.exp(-0.5 * s)
    if kernel.kind == "absoluteExponential":
        s = sum(abs(a - b) / l for a, b, l in zip(x, z, lam))
        return kernel.gamma * math.exp(-s)
    if kernel.kind == "generalizedExponential":
        s = sum(
            (abs(a - b) / l) ** kernel.degree for a, b, l in zip(x, z, lam)
        )
        return kernel.gamma * math.exp(-s)
    raise ModelCompilationException(f"unsupported GP kernel {kernel.kind!r}")


@functools.lru_cache(maxsize=64)
def _gp_alpha(model: ir.GaussianProcessIR) -> Tuple[float, ...]:
    """α = (K + σ²I)⁻¹ y, cached per (hashable, frozen) model — the solve
    is record-independent, exactly the quantity the lowering precomputes."""
    import numpy as _np

    X = _np.asarray(model.instances, _np.float64)
    y = _np.asarray(model.targets, _np.float64)
    N = X.shape[0]
    K = _np.empty((N, N), _np.float64)
    for i in range(N):
        for j in range(N):
            K[i, j] = _gp_kernel_value(model.kernel, list(X[i]), X[j])
    try:
        alpha = _np.linalg.solve(
            K + model.kernel.noise_variance * _np.eye(N), y
        )
    except _np.linalg.LinAlgError:
        # same typed rejection as the lowering (compile/gp.py)
        raise ModelCompilationException(
            "GP kernel matrix K + noiseVariance*I is singular; increase "
            "noiseVariance or deduplicate training instances"
        ) from None
    return tuple(float(a) for a in alpha)


def _eval_gp(model: ir.GaussianProcessIR, record: Record) -> EvalResult:
    xs: List[float] = []
    for f in model.inputs:
        v = _as_float(record.get(f))
        if v is None:
            return EvalResult()  # GP kernels have no missing-value routing
        xs.append(v)
    alpha = _gp_alpha(model)
    return EvalResult(value=sum(
        a * _gp_kernel_value(model.kernel, xs, z)
        for a, z in zip(alpha, model.instances)
    ))


def text_local_weight(v: List[float], kind: str) -> List[float]:
    """PMML TextModelNormalization local term weights, shared by the
    oracle and (semantically) the lowering's golden tests."""
    if kind == "termFrequency":
        return list(v)
    if kind == "binary":
        return [1.0 if x > 0 else 0.0 for x in v]
    if kind == "logarithmic":
        return [math.log10(1.0 + x) for x in v]
    # augmentedNormalizedTermFrequency
    m = max(v) if v else 0.0
    if m <= 0:
        return [0.0] * len(v)
    return [0.5 + 0.5 * x / m if x > 0 else 0.0 for x in v]


def _text_weight(vec, model: ir.TextModelIR, idf) -> List[float]:
    w = [
        a * b
        for a, b in zip(text_local_weight(vec, model.local_weight), idf)
    ]
    if model.doc_normalization == "cosine":
        n = math.sqrt(sum(x * x for x in w))
        if n > 0:
            w = [x / n for x in w]
    return w


@functools.lru_cache(maxsize=64)
def _text_corpus_weights(model: ir.TextModelIR):
    """(idf, weighted DTM rows) — model constants, computed once per
    (hashable, frozen) model rather than per record."""
    D = len(model.doc_ids)
    if model.global_weight == "inverseDocumentFrequency":
        idf = tuple(
            math.log10(D / dj) if dj else 0.0
            for dj in (
                sum(1 for row in model.dtm if row[j] > 0)
                for j in range(len(model.terms))
            )
        )
    else:
        idf = (1.0,) * len(model.terms)
    rows = tuple(
        tuple(_text_weight(list(row), model, idf)) for row in model.dtm
    )
    return idf, rows


def _eval_text_model(model: ir.TextModelIR, record: Record) -> EvalResult:
    q = []
    for t in model.terms:
        x = _as_float(record.get(t))
        q.append(x if x is not None and x > 0 else 0.0)  # missing = 0

    idf, doc_rows = _text_corpus_weights(model)
    qw = _text_weight(q, model, idf)
    nq = math.sqrt(sum(x * x for x in qw))
    scores = {}
    for did, dw in zip(model.doc_ids, doc_rows):
        if model.similarity == "cosine":
            nd = math.sqrt(sum(x * x for x in dw))
            dot = sum(a * b for a, b in zip(qw, dw))
            scores[did] = dot / (nq * nd) if nq > 0 and nd > 0 else 0.0
        else:  # euclidean distance
            scores[did] = math.sqrt(
                sum((a - b) ** 2 for a, b in zip(qw, dw))
            )
    pick = max if model.similarity == "cosine" else min
    win = pick(scores, key=scores.get)
    return EvalResult(
        value=scores[win], label=win, probabilities=scores
    )


def _eval_bayesian_network(
    model: ir.BayesianNetworkIR, record: Record
) -> EvalResult:
    by_name = {n.name: n for n in model.nodes}
    tnode = by_name[model.target]

    def observed(name: str) -> Optional[str]:
        v = record.get(name)
        if _is_missing(v):
            return None
        node = by_name[name]
        for val in node.values:
            if _values_equal(v, val):
                return val
        return None  # unknown category: unmatchable

    def row_probs(node: ir.BnNode, overrides: Dict[str, str]):
        """CPT row whose parent config matches the (observed/overridden)
        parent values; None when any parent is missing/unmatched."""
        want = []
        for p in node.parents:
            val = overrides.get(p) if p in overrides else observed(p)
            if val is None:
                return None
            want.append(val)
        for config, probs in node.cpt:
            if list(config) == want:
                return probs
        return None

    # state-independent lookups hoisted out of the per-state loop
    t_probs = row_probs(tnode, {})
    if t_probs is None:
        return EvalResult()
    children = [
        c
        for c in model.nodes
        if c.name != model.target and model.target in c.parents
    ]
    child_obs = {}
    for child in children:
        obs = observed(child.name)
        if obs is None:
            return EvalResult()
        child_obs[child.name] = child.values.index(obs)

    scores = []
    for si, state in enumerate(tnode.values):
        p = t_probs[si]
        for child in children:
            cprobs = row_probs(child, {model.target: state})
            if cprobs is None:
                return EvalResult()
            p *= cprobs[child_obs[child.name]]
        scores.append(p)
    total = sum(scores)
    if total <= 0:
        return EvalResult()
    probs_n = [s / total for s in scores]
    wi = max(range(len(probs_n)), key=lambda i: probs_n[i])
    return EvalResult(
        value=probs_n[wi],
        label=tnode.values[wi],
        probabilities=dict(zip(tnode.values, probs_n)),
    )


def _eval_arima(a: "ir.ArimaIR", h: int) -> float:
    """CLS forecast at horizon h — an independent per-record recursion.

    Deliberately composes the differencing the other way round from the
    compiled path's host precompute (regular (1−B)^d first, seasonal
    (1−B^s)^D second — the operators commute), so golden/fuzz parity
    between the two implementations checks the algebra, not one shared
    routine."""
    s = a.period
    z = [float(v) for v in a.history]
    if a.transformation == "logarithmic":
        z = [math.log(v) for v in z]
    elif a.transformation == "squareroot":
        z = [math.sqrt(v) for v in z]

    # regular differencing first, then seasonal
    rlevels = [z]
    for _ in range(a.d):
        prev = rlevels[-1]
        rlevels.append([prev[i + 1] - prev[i] for i in range(len(prev) - 1)])
    slevels = [rlevels[-1]]
    for _ in range(a.sd):
        prev = slevels[-1]
        slevels.append([prev[i + s] - prev[i] for i in range(len(prev) - s)])
    w = list(slevels[-1])

    # combined φ(B)Φ(B^s) / θ(B)Θ(B^s) subtracted-polynomial coefficients
    def poly(coef, scoef):
        out = {}
        for i, c in enumerate(coef, 1):
            out[i] = out.get(i, 0.0) + c
        for bigi, bigc in enumerate(scoef, 1):
            out[s * bigi] = out.get(s * bigi, 0.0) + bigc
            for i, c in enumerate(coef, 1):
                out[i + s * bigi] = out.get(i + s * bigi, 0.0) - c * bigc
        return out

    ar_c = poly(a.ar, a.sar)
    ma_c = poly(a.ma, a.sma)
    res = list(a.residuals)  # most recent last: res[-1] = a_T
    T = len(w)
    for k in range(1, h + 1):
        acc = a.constant
        for lag, c in ar_c.items():
            acc += c * w[T + k - 1 - lag]
        for lag, c in ma_c.items():
            if k - lag <= 0:
                acc -= c * res[len(res) - 1 + (k - lag)]
        w.append(acc)
    fore = w[T:]  # ŵ(1..h)

    # invert seasonal differencing, then regular (reverse of application)
    for i in range(a.sd, 0, -1):
        base = list(slevels[i - 1])
        for k in range(h):
            base.append(fore[k] + base[len(base) - s])
        fore = base[len(base) - h:]
    for i in range(a.d, 0, -1):
        run = rlevels[i - 1][-1]
        nxt = []
        for k in range(h):
            run = run + fore[k]
            nxt.append(run)
        fore = nxt

    y = fore[-1]
    if a.transformation == "logarithmic":
        # an exploding AR on the log scale must stay total: the compiled
        # path's table holds f32 inf there, so the oracle says inf too
        # rather than raising out of the hot path (C5)
        try:
            return math.exp(y)
        except OverflowError:
            return math.inf
    if a.transformation == "squareroot":
        return y * y  # float multiply overflows to inf, matching f32
    return y


def _eval_time_series(model: ir.TimeSeriesIR, record: Record) -> EvalResult:
    hv = _as_float(record.get(model.horizon_field))
    if hv is None:
        return EvalResult()
    h = max(int(round(hv)), 1)
    if model.arima is not None:
        return EvalResult(
            value=_eval_arima(model.arima, min(h, ir.ARIMA_H_MAX))
        )
    s = model.smoothing
    y = s.level
    if s.trend_type == "additive":
        y += h * s.trend
    elif s.trend_type == "damped_additive":
        # Σ_{i=1..h} φ^i = φ(1−φ^h)/(1−φ)
        y += s.trend * s.phi * (1.0 - s.phi ** h) / (1.0 - s.phi)
    elif s.trend_type == "multiplicative":
        # ** raises OverflowError where the compiled f32 path holds inf;
        # the hot path stays total either way (C5, cf. _eval_arima)
        try:
            y *= s.trend ** h
        except OverflowError:
            y = math.copysign(math.inf, y) if y else y
    elif s.trend_type == "damped_multiplicative":
        try:
            y *= s.trend ** (s.phi * (1.0 - s.phi ** h) / (1.0 - s.phi))
        except OverflowError:
            y = math.copysign(math.inf, y) if y else y
    if s.seasonal_type != "none":
        factor = s.seasonal[(h - 1) % s.period]
        y = y + factor if s.seasonal_type == "additive" else y * factor
    return EvalResult(value=y)


def _eval_baseline(model: ir.BaselineIR, record: Record) -> EvalResult:
    x = _as_float(record.get(model.field))
    if x is None:
        return EvalResult()
    b = model.baseline
    return EvalResult(value=(x - b.mean) / math.sqrt(b.variance))


def rule_meta_dict(r: ir.AssociationRule) -> Dict[str, object]:
    """One rule's metadata, keyed by ruleFeature name (pmml/outputs.py) —
    the single definition both the oracle and the compiled decode use."""
    return {
        "consequent": " ".join(r.consequent),
        "antecedent": " ".join(r.antecedent),
        "rule": f"{{{' '.join(r.antecedent)}}}->"
                f"{{{' '.join(r.consequent)}}}",
        "ruleId": r.rule_id,
        "confidence": r.confidence,
        "support": r.support,
        "lift": r.lift,
    }


def _eval_association(model: ir.AssociationIR, record: Record) -> EvalResult:
    basket = set()
    for item in model.items:
        v = _as_float(record.get(item))
        if v is not None and v > 0.5:
            basket.add(item)
    fired = []  # (sort key, rule)
    for i, r in enumerate(model.rules):
        if not set(r.antecedent) <= basket:
            continue
        cons_in = set(r.consequent) <= basket
        # JPMML-parity criteria: "rule" needs the whole rule in the
        # basket; "recommendation" only the antecedent;
        # "exclusiveRecommendation" (the spec default) additionally
        # requires the consequent NOT fully present yet
        if model.criterion == "rule" and not cons_in:
            continue
        if model.criterion == "exclusiveRecommendation" and cons_in:
            continue
        fired.append(((-r.confidence, -r.support, i), r))
    if not fired:
        return EvalResult()
    fired.sort(key=lambda t: t[0])
    best = fired[0][1]
    res = EvalResult(
        value=best.confidence, label=" ".join(best.consequent)
    )
    # winner metadata surfaced as-is when the document declares no
    # Output; the full ranking feeds rank-k ruleValue fields
    res.outputs = rule_meta_dict(best)
    res.rule_ranking = tuple(rule_meta_dict(r) for _, r in fired)
    return res


def _eval_anomaly(model: ir.AnomalyDetectionIR, record: Record) -> EvalResult:
    from flink_jpmml_tpu_torch.compile.anomaly import iforest_c

    res = _eval_model(model.inner, record)
    if model.algorithm_type != "iforest" or res.value is None:
        return res
    c = iforest_c(model.sample_data_size)
    return EvalResult(value=2.0 ** (-res.value / c))


# --- MiningModel -----------------------------------------------------------


def _eval_mining(model: ir.MiningModelIR, record: Record) -> EvalResult:
    method = model.segmentation.multiple_model_method
    segments = model.segmentation.segments

    if method == "modelChain":
        rec = dict(record)
        res = EvalResult()
        for seg in segments:
            if eval_predicate(seg.predicate, rec) is not True:
                continue
            res = _eval_model(seg.model, rec)
            for of in seg.output_fields:
                if of.feature == "predictedValue":
                    # classification segments export the *label*; numeric
                    # segments export the value (DMG: predictedValue is the
                    # target-space result)
                    rec[of.name] = res.label if res.label is not None else res.value
                elif of.feature == "probability" and of.target_value is not None:
                    rec[of.name] = res.probabilities.get(of.target_value)
                else:
                    raise ModelCompilationException(
                        f"unsupported OutputField feature {of.feature!r}"
                    )
            if res.is_missing:
                return EvalResult()
        # entity facets are top-level-model features (cf. selectFirst)
        res.entity_ranking = ()
        return res

    if method == "selectFirst":
        for seg in segments:
            if eval_predicate(seg.predicate, record) is True:
                res = _eval_model(seg.model, record)
                # entity facets (neighbor ids, cluster rankings) are
                # top-level-model features: the compiled ensemble path
                # cannot surface them, so neither does the oracle
                res.entity_ranking = ()
                return res
        return EvalResult()

    if method == "selectAll":
        # every active segment's result is surfaced (regression only:
        # a multi-label collection doesn't fit one Prediction); the
        # scalar value is the FIRST active segment's, the full mapping
        # rides ``outputs["segments"]`` — mirroring the compiled decode
        seg_values: Dict[str, object] = {}
        first = None
        for i, seg in enumerate(segments):
            if seg.model.function_name != "regression":
                raise ModelCompilationException(
                    "selectAll supports regression segments only"
                )
            sid = seg.segment_id or str(i)
            if eval_predicate(seg.predicate, record) is not True:
                seg_values[sid] = None
                continue
            r = _eval_model(seg.model, record)
            seg_values[sid] = r.value
            if first is None and r.value is not None:
                first = r.value
        if first is None:
            return EvalResult()
        res = EvalResult(value=first)
        res.outputs = {"segments": seg_values}
        return res

    # aggregate methods over active segments
    results: List[Tuple[float, EvalResult]] = []
    for seg in segments:
        if eval_predicate(seg.predicate, record) is not True:
            continue
        results.append((seg.weight, _eval_model(seg.model, record)))
    if not results:
        return EvalResult()

    if method in ("sum", "average", "weightedAverage", "max", "median"):
        vals = [(w, r.value) for w, r in results]
        if any(v is None for _, v in vals):
            return EvalResult()
        if method == "sum":
            return EvalResult(value=sum(v for _, v in vals))
        if method == "average":
            return EvalResult(value=sum(v for _, v in vals) / len(vals))
        if method == "weightedAverage":
            tw = sum(w for w, _ in vals)
            if tw == 0:
                return EvalResult()
            return EvalResult(value=sum(w * v for w, v in vals) / tw)
        if method == "max":
            return EvalResult(value=max(v for _, v in vals))
        svals = sorted(v for _, v in vals)
        mid = len(svals) // 2
        med = svals[mid] if len(svals) % 2 else (svals[mid - 1] + svals[mid]) / 2.0
        return EvalResult(value=med)

    if method in ("majorityVote", "weightedMajorityVote"):
        votes: Dict[str, float] = {}
        for w, r in results:
            if r.label is None:
                continue
            votes[r.label] = votes.get(r.label, 0.0) + (
                w if method == "weightedMajorityVote" else 1.0
            )
        if not votes:
            return EvalResult()
        total = sum(votes.values())
        probs = {k: v / total for k, v in votes.items()}
        label = max(votes, key=votes.get)
        return EvalResult(value=probs[label], label=label, probabilities=probs)

    raise ModelCompilationException(f"unsupported multipleModelMethod {method!r}")
