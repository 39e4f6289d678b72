"""GeneralRegressionModel → PyTorch: design matrix + β + inverse link.

The port of ``flink_jpmml_tpu/compile/glm.py``. Semantics:

    x_p = Π covariate^exponent × Π [factor == category]   (PPMatrix)
    η_t = Σ_p β_{t,p} · x_p                               (ParamMatrix)
    μ   = link⁻¹(η)        (generalizedLinear; identity otherwise)
    multinomialLogistic: softmax over per-category η with the reference
    category pinned at η = 0; ordinalMultinomial: cumulative link,
    class probabilities as successive differences; CoxRegression:
    S(t) = exp(−H₀(t)·exp(η)) over the baseline step function.

Parameters without PPCells are intercepts. A record missing ANY predictor
the PPMatrix references scores as an invalid lane.

The design matrix is a per-parameter product in PPCell order; η is one
``torch.matmul`` against the [P, T] β table (float32, TF32 off:
``utils/device.py``; the JAX package asks for ``Precision.HIGHEST``). The
computation stays float32, as there. Where torch's names differ: the
probit link's ``jax.scipy.stats.norm.cdf`` is ``torch.special.ndtr``, and
the Cox baseline lookup keeps ``jnp.searchsorted(side="right")`` as
``torch.searchsorted(right=True)``.

Deliberate difference: ``label_idx`` is int64.

On a mesh with a model axis (``parallel/sharding.mesh_sharded``) a β
table of at least the wide threshold's parameters is a ``common.TpLeaf``:
η is one partial product a slice of the design matrix's columns, added in
slice order (``common.tp_matmul``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import (
    DeviceConst,
    Lowered,
    LowerCtx,
    ModelOutput,
    tp_matmul,
)
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

_MODEL_TYPES = (
    "regression",
    "generalLinear",
    "generalizedLinear",
    "multinomialLogistic",
    "ordinalMultinomial",
    "CoxRegression",
)


def inverse_link(name, eta, power=None):
    """μ = link⁻¹(η)."""
    if name in (None, "identity"):
        return eta
    if name == "log":
        return torch.exp(eta)
    if name == "logit":
        return 1.0 / (1.0 + torch.exp(-eta))
    if name == "cloglog":
        return 1.0 - torch.exp(-torch.exp(eta))
    if name == "loglog":
        return torch.exp(-torch.exp(-eta))
    if name == "probit":
        return torch.special.ndtr(eta)
    if name == "inverse":
        return 1.0 / eta
    if name == "cauchit":
        return 0.5 + torch.atan(eta) / math.pi
    if name == "power":
        if power is None or power == 0:
            raise ModelCompilationException(
                "power link needs a non-zero linkParameter"
            )
        return torch.pow(eta, 1.0 / power)
    raise ModelCompilationException(f"unsupported linkFunction {name!r}")


def _resolve_categories(model: ir.GeneralRegressionIR, ctx: LowerCtx):
    """multinomialLogistic target categories (document order from the
    ParamMatrix) + the reference category pinned at η = 0. The parser
    resolves a missing targetReferenceCategory at load time, so here it is
    simply required."""
    cats: list = []
    for c in model.p_cells:
        if c.target_category is not None and c.target_category not in cats:
            cats.append(c.target_category)
    ref = model.target_reference_category
    if ref is None:
        raise ModelCompilationException(
            "multinomialLogistic needs targetReferenceCategory"
        )
    if ref in cats:
        cats.remove(ref)
    return cats, ref


def _check_param(c, pidx, what="PCell"):
    if c.parameter not in pidx:
        raise ModelCompilationException(
            f"{what} references unknown parameter {c.parameter!r}"
        )


def lower_general_regression(
    model: ir.GeneralRegressionIR, ctx: LowerCtx
) -> Lowered:
    if model.model_type not in _MODEL_TYPES:
        raise ModelCompilationException(
            f"unsupported GeneralRegressionModel modelType "
            f"{model.model_type!r} (supported: {', '.join(_MODEL_TYPES)})"
        )
    P = len(model.parameters)
    pidx = {p: i for i, p in enumerate(model.parameters)}
    factor_set = set(model.factors)
    # per-parameter cell programs in PPCell order, resolved at compile time:
    # ("cov", col, exponent) or ("fac", col, code)
    cells: list = [[] for _ in range(P)]
    used = np.zeros((ctx.n_fields,), bool)
    for cell in model.pp_cells:
        _check_param(cell, pidx, "PPCell")
        col = ctx.column(cell.predictor)
        used[col] = True
        if cell.predictor in factor_set:
            code = ctx.encode(cell.predictor, cell.value)
            cells[pidx[cell.parameter]].append(
                ("fac", col, float(np.float32(code)))
            )
        else:
            try:
                expo = float(cell.value)
            except ValueError:
                raise ModelCompilationException(
                    f"covariate PPCell value {cell.value!r} is not a "
                    "number (exponent)"
                ) from None
            cells[pidx[cell.parameter]].append(
                ("cov", col, float(np.float32(expo)))
            )

    multinomial = model.model_type == "multinomialLogistic"
    ordinal = model.model_type == "ordinalMultinomial"
    cox = model.model_type == "CoxRegression"
    if cox:
        if not model.baseline_cells or model.end_time_variable is None:
            raise ModelCompilationException(
                "CoxRegression needs endTimeVariable and "
                "BaseCumHazardTables"
            )
        cox_tcol = ctx.column(model.end_time_variable)
        used[cox_tcol] = True  # a missing end time empties the lane
    if ordinal:
        # cumulative-link model: per-category thresholds for the first
        # C−1 categories + shared slopes, P(y ≤ c_j) = g⁻¹(η_j)
        cats_o = list(model.target_categories)
        if len(cats_o) < 2:
            raise ModelCompilationException(
                "ordinalMultinomial needs resolved target_categories "
                "(parse_pmml fills them from the target DataField)"
            )
        labels = tuple(cats_o)
        beta = np.zeros((P, len(cats_o) - 1), np.float32)
        for c in model.p_cells:
            _check_param(c, pidx)
            if c.target_category is None:
                beta[pidx[c.parameter], :] += c.beta  # shared slope
            elif c.target_category in cats_o[:-1]:
                beta[
                    pidx[c.parameter], cats_o.index(c.target_category)
                ] += c.beta
            else:
                raise ModelCompilationException(
                    f"ordinalMultinomial PCell targets "
                    f"{c.target_category!r} — the LAST category carries "
                    "no threshold"
                )
    elif multinomial:
        cats, ref = _resolve_categories(model, ctx)
        labels = tuple(cats) + (ref,)
        beta = np.zeros((P, len(cats)), np.float32)
        for c in model.p_cells:
            _check_param(c, pidx)
            if c.target_category is None:
                raise ModelCompilationException(
                    "multinomialLogistic PCell without targetCategory"
                )
            if c.target_category == ref:
                continue  # reference η stays 0
            # += : duplicate PCells for one (parameter, category) sum
            beta[pidx[c.parameter], cats.index(c.target_category)] += c.beta
    else:
        labels = ()
        beta = np.zeros((P, 1), np.float32)
        for c in model.p_cells:
            _check_param(c, pidx)
            if c.target_category is not None:
                raise ModelCompilationException(
                    f"modelType {model.model_type!r} with per-category "
                    "PCells — use multinomialLogistic"
                )
            beta[pidx[c.parameter], 0] += c.beta  # duplicates sum
    link = (
        model.link_function
        if model.model_type == "generalizedLinear"
        else "identity"
    )
    inverse_link(link, torch.zeros(()), model.link_power)  # validate now
    if ordinal:
        inverse_link(model.cumulative_link, torch.zeros(()))
    params = {"beta": beta}
    if cox:
        # step function as a searchsorted index into [0, H₀(t₁)…H₀(t_K)]
        params["cox_times"] = np.asarray(
            [t for t, _ in model.baseline_cells], np.float32
        )
        params["cox_haz"] = np.asarray(
            [0.0] + [h for _, h in model.baseline_cells], np.float32
        )
    used_c = DeviceConst(used)
    max_time = (
        float(np.float32(model.max_time)) if model.max_time is not None
        else None
    )

    def design(X):
        B = X.shape[0]
        ones = torch.ones((B,), dtype=torch.float32, device=X.device)
        cols = []
        for prog in cells:
            x = ones
            for kind, col, arg in prog:
                if kind == "cov":
                    base = X[:, col]
                    x = x * (base if arg == 1.0 else torch.pow(base, arg))
                else:
                    x = x * (X[:, col] == arg).to(torch.float32)
            cols.append(x)
        return torch.stack(cols, dim=1)  # [B, P]

    def fn(p, X, M):
        B = X.shape[0]
        missing = (M & used_c.on(X.device)[None, :]).any(dim=1)
        eta = tp_matmul(design(X), p["beta"])  # [B, T or 1]
        if ordinal:
            cum = inverse_link(model.cumulative_link, eta)  # [B, J]
            probs = torch.cat(
                [cum[:, :1], cum[:, 1:] - cum[:, :-1], 1.0 - cum[:, -1:]],
                dim=1,
            )
            lab = torch.argmax(probs, dim=1)
            value = torch.gather(probs, 1, lab[:, None])[:, 0]
            return ModelOutput(
                value=value, valid=~missing, probs=probs, label_idx=lab
            )
        if multinomial:
            full = torch.cat(
                [eta, torch.zeros((B, 1), dtype=torch.float32,
                                  device=X.device)], dim=1
            )
            m = full.max(dim=1, keepdim=True).values
            e = torch.exp(full - m)
            probs = e / e.sum(dim=1, keepdim=True)
            lab = torch.argmax(probs, dim=1)
            value = torch.gather(probs, 1, lab[:, None])[:, 0]
            return ModelOutput(
                value=value, valid=~missing, probs=probs, label_idx=lab
            )
        if cox:
            # H₀(t): largest baseline time ≤ t (0 before the first)
            t = X[:, cox_tcol]
            idx = torch.searchsorted(p["cox_times"], t.contiguous(),
                                     right=True)
            h0 = p["cox_haz"][idx]
            surv = torch.exp(-h0 * torch.exp(eta[:, 0]))
            valid = ~missing
            if max_time is not None:
                # the fitted baseline covers [0, maxTime]; beyond it the
                # hazard is undefined — empty lane, not extrapolation
                valid = valid & (t <= max_time)
            return ModelOutput(value=surv, valid=valid)
        mu = inverse_link(link, eta[:, 0], model.link_power)
        return ModelOutput(value=mu, valid=~missing)

    return Lowered(fn=fn, params=params, labels=labels)
