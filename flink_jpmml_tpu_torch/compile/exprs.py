"""Expression lowering: PMML DerivedField expressions → (value, missing) lanes.

The port of ``flink_jpmml_tpu/compile/exprs.py``: NeuralNetwork inputs and
TransformationDictionary derived fields. Every expression yields a value
lane f32[B] plus a missing lane bool[B]; ``mapMissingTo`` substitutes a
constant where the input is missing. The expressions are those of the JAX
package (Constant, FieldRef, NormContinuous with its outlier modes,
NormDiscrete, Apply); the IR has no Discretize or MapValues.

Semantics kept from the JAX package, where torch's names differ:

- ``modulo`` takes the divisor's sign (``jnp.mod``): ``torch.remainder``,
  not ``torch.fmod``;
- ``rint`` rounds half to even (``torch.round``); ``round`` is
  ``floor(x + 0.5)``;
- ``and`` / ``or`` are Kleene three-valued: a known dominator decides a
  lane even when another argument is missing;
- NormContinuous's clamped interpolation is ``jnp.interp``'s, written out
  (torch has no ``interp``): right-side search, the same degenerate-segment
  guard, the boundary values outside the range.

Deliberate difference: an unsupported Apply function raises
``ModelCompilationException`` when the expression is lowered; the JAX
package raises the same exception at the first trace.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import DeviceConst, LowerCtx
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

ExprFn = Callable[
    [torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]
]


def lower_expression(expr: ir.Expression, ctx: LowerCtx) -> ExprFn:
    if isinstance(expr, ir.Constant):
        v = float(np.float32(expr.value))

        def cfn(X, M):
            B = X.shape[0]
            return (
                torch.full((B,), v, dtype=torch.float32, device=X.device),
                torch.zeros((B,), dtype=torch.bool, device=X.device),
            )

        return cfn

    if isinstance(expr, ir.FieldRef):
        col = ctx.column(expr.field)

        def ffn(X, M):
            return X[:, col], M[:, col]

        return ffn

    if isinstance(expr, ir.NormContinuous):
        col = ctx.column(expr.field)
        origs = np.asarray([n.orig for n in expr.norms], np.float32)
        norms = np.asarray([n.norm for n in expr.norms], np.float32)
        outliers = expr.outliers
        mm = expr.map_missing_to
        piecewise = _piecewise(origs, norms, extrapolate=(outliers == "asIs"))
        lo, hi = float(origs[0]), float(origs[-1])

        def nfn(X, M):
            x = X[:, col]
            miss = M[:, col]
            # asIs extrapolates; asExtremeValues/asMissingValues clamp (the
            # latter then masks out-of-range lanes as missing)
            y = piecewise(x)
            if outliers == "asMissingValues":
                miss = miss | (x < lo) | (x > hi)
            return _with_map_missing(y, miss, mm)

        return nfn

    if isinstance(expr, ir.NormDiscrete):
        col = ctx.column(expr.field)
        code = float(np.float32(ctx.encode(expr.field, expr.value)))
        mm = expr.map_missing_to

        def dfn(X, M):
            ind = (X[:, col] == code).to(torch.float32)
            return _with_map_missing(ind, M[:, col], mm)

        return dfn

    if isinstance(expr, ir.Apply):
        arg_fns = [lower_expression(a, ctx) for a in expr.args]
        fn_name = expr.function
        mm = expr.map_missing_to

        if fn_name in ("isMissing", "isNotMissing"):
            # consumes missing-ness itself: the any-arg-missing
            # propagation below must not fire
            probe = arg_fns[0]
            want_missing = fn_name == "isMissing"

            def pfn(X, M):
                _, m = probe(X, M)
                y = (m if want_missing else ~m).to(torch.float32)
                return y, torch.zeros_like(m)

            return pfn

        if fn_name in ("and", "or"):
            # Kleene three-valued logic: and(false, missing) = false,
            # or(true, missing) = true; only an undecided lane with a
            # missing argument stays missing (then mapMissingTo applies)
            is_and = fn_name == "and"

            def kfn(X, M):
                vals, misses = zip(*(f(X, M) for f in arg_fns))
                dom = None  # lanes decided by a known dominator
                any_miss = None
                for v, m in zip(vals, misses):
                    known = ~m & ((v == 0.0) if is_and else (v != 0.0))
                    dom = known if dom is None else (dom | known)
                    any_miss = m if any_miss is None else (any_miss | m)
                if is_and:
                    y = (~dom).to(torch.float32)  # false iff any known false
                else:
                    y = dom.to(torch.float32)  # true iff any known true
                return _with_map_missing(y, any_miss & ~dom, mm)

            return kfn

        if fn_name not in _FUNCTIONS:
            raise ModelCompilationException(
                f"unsupported Apply function {fn_name!r}"
            )

        def afn(X, M):
            vals, misses = zip(*(f(X, M) for f in arg_fns))
            miss = misses[0]
            for m2 in misses[1:]:
                miss = miss | m2
            y, extra_missing = _apply(fn_name, vals)
            return _with_map_missing(y, miss | extra_missing, mm)

        return afn

    raise ModelCompilationException(
        f"unsupported expression {type(expr).__name__}"
    )


def _with_map_missing(y, miss, map_missing_to):
    if map_missing_to is not None:
        y = torch.where(miss, float(np.float32(map_missing_to)), y)
        miss = torch.zeros_like(miss)
    return y, miss


def _piecewise(origs: np.ndarray, norms: np.ndarray, extrapolate: bool):
    """Piecewise-linear map through (origs → norms) control points, as a
    function of x.

    ``extrapolate=True`` extends the outermost segments (PMML outliers=asIs);
    otherwise values clamp to the boundary norms (asExtremeValues).
    """
    if len(origs) == 2 and extrapolate:
        o0, n0 = origs[0], norms[0]
        slope = float((norms[1] - n0) / (origs[1] - o0))

        def line(x):
            return float(n0) + (x - float(o0)) * slope

        return line
    xp, fp = DeviceConst(origs), DeviceConst(norms)
    eps = float(np.spacing(np.finfo(np.float32).eps))
    lo_slope = hi_slope = None
    if extrapolate:
        lo_slope = float((norms[1] - norms[0]) / (origs[1] - origs[0]))
        hi_slope = float((norms[-1] - norms[-2]) / (origs[-1] - origs[-2]))
    o_lo, o_hi = float(origs[0]), float(origs[-1])
    n_lo, n_hi = float(norms[0]), float(norms[-1])

    def interp(x):
        # jnp.interp: the right-side insertion point, clipped to a segment
        xpd, fpd = xp.on(x.device), fp.on(x.device)
        i = torch.clamp(
            torch.searchsorted(xpd, x.contiguous(), right=True),
            1, len(origs) - 1,
        )
        df = fpd[i] - fpd[i - 1]
        dx = xpd[i] - xpd[i - 1]
        delta = x - xpd[i - 1]
        dx0 = torch.abs(dx) <= eps
        y = torch.where(
            dx0, fpd[i - 1],
            fpd[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df,
        )
        y = torch.where(x < o_lo, n_lo, y)
        y = torch.where(x > o_hi, n_hi, y)
        if extrapolate:
            y = torch.where(x < o_lo, n_lo + (x - o_lo) * lo_slope, y)
            y = torch.where(x > o_hi, n_hi + (x - o_hi) * hi_slope, y)
        return y

    return interp


def _f(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.float32)


_SQRT2 = float(np.sqrt(2.0))
_SQRT2PI = float(np.sqrt(2.0 * np.pi))

# fn(vals) -> value; the functions whose domain is the whole line
_TOTAL = {
    "+": lambda v: v[0] + v[1],
    "-": lambda v: v[0] - v[1],
    "*": lambda v: v[0] * v[1],
    "min": lambda v: torch.stack(v).min(dim=0).values,
    "max": lambda v: torch.stack(v).max(dim=0).values,
    "pow": lambda v: v[0] ** v[1],
    "exp": lambda v: torch.exp(v[0]),
    "abs": lambda v: torch.abs(v[0]),
    "floor": lambda v: torch.floor(v[0]),
    "ceil": lambda v: torch.ceil(v[0]),
    "threshold": lambda v: _f(v[0] > v[1]),
    # comparisons / booleans: results are PMML booleans as 1.0/0.0
    "equal": lambda v: _f(v[0] == v[1]),
    "notEqual": lambda v: _f(v[0] != v[1]),
    "lessThan": lambda v: _f(v[0] < v[1]),
    "lessOrEqual": lambda v: _f(v[0] <= v[1]),
    "greaterThan": lambda v: _f(v[0] > v[1]),
    "greaterOrEqual": lambda v: _f(v[0] >= v[1]),
    "not": lambda v: _f(v[0] == 0.0),
    # PMML round: 0.5 rounds UP (floor(x + 0.5)); rint: half to even
    "round": lambda v: torch.floor(v[0] + 0.5),
    "rint": lambda v: torch.round(v[0]),
    "expm1": lambda v: torch.expm1(v[0]),
    "sin": lambda v: torch.sin(v[0]),
    "cos": lambda v: torch.cos(v[0]),
    "tan": lambda v: torch.tan(v[0]),
    "atan": lambda v: torch.atan(v[0]),
    "atan2": lambda v: torch.atan2(v[0], v[1]),
    "sinh": lambda v: torch.sinh(v[0]),
    "cosh": lambda v: torch.cosh(v[0]),
    "tanh": lambda v: torch.tanh(v[0]),
    "hypot": lambda v: torch.hypot(v[0], v[1]),
    # standard-normal family (PMML 4.4)
    "stdNormalCDF": lambda v: 0.5 * (1.0 + torch.special.erf(v[0] / _SQRT2)),
    "stdNormalPDF": lambda v: torch.exp(-0.5 * v[0] * v[0]) / _SQRT2PI,
}

_PARTIAL = (
    "/", "ln", "sqrt", "if", "modulo", "log10", "ln1p", "asin", "acos",
    "stdNormalIDF",
)
_FUNCTIONS = frozenset(_TOTAL) | frozenset(_PARTIAL)


def _apply(fn: str, vals):
    """→ (value, extra_missing) for the supported built-in functions."""
    if fn in _TOTAL:
        return _TOTAL[fn](vals), torch.zeros_like(vals[0], dtype=torch.bool)
    x = vals[0]
    if fn == "/":
        bad = vals[1] == 0
        return torch.where(bad, 0.0, x / vals[1]), bad
    if fn == "ln":
        return (
            torch.where(x > 0, torch.log(torch.clamp(x, min=1e-38)), 0.0),
            x <= 0,
        )
    if fn == "sqrt":
        return torch.sqrt(torch.clamp(x, min=0.0)), x < 0
    if fn == "if":
        cond = x != 0.0
        if len(vals) > 2:
            return torch.where(cond, vals[1], vals[2]), torch.zeros_like(cond)
        return torch.where(cond, vals[1], 0.0), ~cond
    if fn == "modulo":  # the divisor's sign (jnp.mod / python %)
        bad = vals[1] == 0
        return torch.where(
            bad, 0.0, torch.remainder(x, torch.where(bad, 1.0, vals[1]))
        ), bad
    # sanitize only the BAD lanes (a clamp would distort valid inputs
    # near the domain edge at f32 resolution)
    if fn == "log10":
        bad = x <= 0
        return torch.where(bad, 0.0, torch.log10(torch.where(bad, 1.0, x))), bad
    if fn == "ln1p":
        bad = x <= -1
        return torch.where(bad, 0.0, torch.log1p(torch.where(bad, 0.0, x))), bad
    if fn == "asin":
        return torch.asin(torch.clamp(x, -1.0, 1.0)), torch.abs(x) > 1
    if fn == "acos":
        return torch.acos(torch.clamp(x, -1.0, 1.0)), torch.abs(x) > 1
    # stdNormalIDF
    bad = (x <= 0) | (x >= 1)
    return torch.where(
        bad, 0.0, torch.special.ndtri(torch.where(bad, 0.5, x))
    ), bad
