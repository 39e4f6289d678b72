"""ModelVerification replay: embedded test vectors vs the compiled model.

Reference parity: JPMML-Evaluator's ``Evaluator.verify()`` replays the
document's producer-embedded ``<ModelVerification>`` records and refuses
to serve on mismatch (SURVEY.md §1 C1/C2 — load-time validation of the
parse→compile path on the worker). Here :func:`run_verification` scores
the verification inputs through the jitted model and compares each
expectation column:

- the target field (or the literal ``predictedValue``): the predicted
  numeric value, or the predicted label when the expectation is not
  numeric;
- ``probability(<class>)``: that class's probability;
- a declared top-level OutputField name: the computed output.

Numeric comparisons follow the PMML contract: when ``|expected| <=
zeroThreshold`` the actual must also be within the threshold of zero,
otherwise the relative error must be within ``precision``.

A copy of ``flink_jpmml_tpu/compile/verify.py`` (pure Python there too),
kept so that the PyTorch port imports nothing of the JAX package. The code
is unchanged: it scores through the port's ``CompiledModel.score_records``
on the model's own device.
"""

from __future__ import annotations

import re
import warnings
from typing import List, Optional

from flink_jpmml_tpu_torch.pmml import ir

_PROB_RE = re.compile(r"^probability\((.+)\)$")


def _as_float(raw: str) -> Optional[float]:
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


# The replay target is the float32 compiled path while producers compute
# expectations in double precision; the spec defaults (precision 1e-6,
# zeroThreshold 1e-16) are tighter than f32 arithmetic can honor (a long
# ensemble sum accumulates ~1e-5 relative; f32 softmax turns an exact 0
# into ~1e-8). Policy: fields that OMIT the attributes get conservative
# f32-realistic defaults; explicitly-set producer values are honored
# down to the f32 NOISE FLOOR — a tighter-than-floor request (including
# a spelled-out spec default) clamps to the floor rather than refusing
# correct models for float32 rounding, while anything at or above the
# floor applies exactly as written.
_F32_PRECISION_DEFAULT = 1e-4
_F32_ZERO_DEFAULT = 1e-6
_F32_PRECISION_FLOOR = 1e-5
_F32_ZERO_FLOOR = 1e-7


def _num_close(got: float, exp: float, vf: ir.VerificationField) -> bool:
    zero = (
        max(vf.zero_threshold, _F32_ZERO_FLOOR)
        if vf.zero_threshold is not None
        else _F32_ZERO_DEFAULT
    )
    prec = (
        max(vf.precision, _F32_PRECISION_FLOOR)
        if vf.precision is not None
        else _F32_PRECISION_DEFAULT
    )
    if abs(exp) <= zero:
        return abs(got) <= zero
    return abs(got - exp) <= prec * abs(exp)


def run_verification(model, target_field: Optional[str]) -> List[str]:
    """→ mismatch descriptions (empty list = verified).

    ``model`` is a CompiledModel whose ``_verification`` holds the parsed
    element; ``target_field`` is the document's target name (expectation
    columns may use it instead of ``predictedValue``)."""
    v: Optional[ir.ModelVerification] = model._verification
    if v is None:
        return []
    active = set(model.active_fields)
    output_names = {of.name for of in model.output_fields}
    input_fields = [f for f in v.fields if f.field in active]
    expect_fields = [f for f in v.fields if f.field not in active]
    problems: List[str] = []
    if not expect_fields:
        return ["ModelVerification declares no expectation columns"]

    # JPMML honors declared tolerances verbatim and refuses to serve on any
    # mismatch; we clamp tighter-than-f32 requests to the noise floor instead
    # (policy above). Make that deviation observable: warn once per field
    # whose declared tolerance was loosened.
    for f in expect_fields:
        loosened = []
        if f.precision is not None and f.precision < _F32_PRECISION_FLOOR:
            loosened.append(
                f"precision {f.precision:g} → {_F32_PRECISION_FLOOR:g}"
            )
        if f.zero_threshold is not None and f.zero_threshold < _F32_ZERO_FLOOR:
            loosened.append(
                f"zeroThreshold {f.zero_threshold:g} → {_F32_ZERO_FLOOR:g}"
            )
        if loosened:
            warnings.warn(
                "ModelVerification field "
                f"{f.field!r}: declared tolerance below the float32 noise "
                f"floor was loosened ({'; '.join(loosened)}); JPMML would "
                "verify at the declared value",
                stacklevel=2,
            )

    codecs = model.field_space.codecs
    records = []
    for row in v.records:
        cells = dict(row)
        rec = {}
        for f in input_fields:
            raw = cells.get(f.column)
            if raw is None or raw == "":
                continue  # absent cell = missing input
            if f.field in codecs:
                # string-categorical: the raw cell must ride the codec —
                # float-coercing a numeric-looking category ("4") would
                # bypass it and mis-encode
                rec[f.field] = raw
            else:
                num = _as_float(raw)
                rec[f.field] = num if num is not None else raw
        records.append((rec, cells))

    preds = model.score_records([rec for rec, _ in records])
    for i, (pred, (_, cells)) in enumerate(zip(preds, records)):
        for f in expect_fields:
            raw = cells.get(f.column)
            if raw is None or raw == "":
                continue  # no expectation for this row
            where = f"row {i} field {f.field!r}"
            exp_num = _as_float(raw)
            m = _PROB_RE.match(f.field)
            if m is not None:
                label = m.group(1)
                probs = pred.target.probabilities if pred.target else None
                got = (probs or {}).get(label)
                if exp_num is None:
                    problems.append(f"{where}: non-numeric probability")
                elif got is None:
                    problems.append(
                        f"{where}: no probability for class {label!r}"
                    )
                elif not _num_close(got, exp_num, f):
                    problems.append(
                        f"{where}: probability({label}) = {got!r}, "
                        f"expected {exp_num!r}"
                    )
                continue
            if f.field in output_names:
                got = (pred.outputs or {}).get(f.field)
                got_num = _as_float(got) if isinstance(got, str) else (
                    float(got) if isinstance(got, (int, float)) else None
                )
                if exp_num is not None and got_num is not None:
                    if not _num_close(got_num, exp_num, f):
                        problems.append(
                            f"{where}: output = {got!r}, expected {raw!r}"
                        )
                elif str(got) != raw:
                    problems.append(
                        f"{where}: output = {got!r}, expected {raw!r}"
                    )
                continue
            if f.field == target_field or f.field == "predictedValue":
                if pred.is_empty:
                    problems.append(f"{where}: empty prediction")
                elif model.is_classification:
                    # predictedValue of a classification model is its
                    # LABEL — numeric-looking class names ("0"/"1")
                    # still compare as labels, never against the winning
                    # probability in score.value
                    label = pred.target.label if pred.target else None
                    if label != raw and not (
                        exp_num is not None
                        and _as_float(label) == exp_num
                    ):
                        problems.append(
                            f"{where}: label = {label!r}, expected {raw!r}"
                        )
                elif exp_num is None:
                    problems.append(
                        f"{where}: non-numeric expectation {raw!r} for a "
                        "regression target"
                    )
                elif not _num_close(pred.score.value, exp_num, f):
                    problems.append(
                        f"{where}: value = {pred.score.value!r}, "
                        f"expected {exp_num!r}"
                    )
                continue
            problems.append(
                f"{where}: not an input, the target, probability(...), "
                "or a declared OutputField"
            )
    return problems
