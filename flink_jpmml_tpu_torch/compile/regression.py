"""RegressionModel → PyTorch: one matmul + link function.

The port of ``flink_jpmml_tpu/compile/regression.py`` (BASELINE config 1,
``iris_lr``, and the calibration stages of config 5's chain). Every table
is a gathered matmul over the batch, and the normalization link
(logit/softmax/…) is elementwise. The products are ``torch.matmul`` in
float32 with TF32 off (``utils/device.py``), where the JAX package asks for
``Precision.HIGHEST``.

Missing semantics (matching the JAX package): a missing *numeric*
predictor makes that table's value missing (lane invalid); a missing
*categorical* predictor contributes 0.

Deliberate differences: ``label_idx`` is int64 (torch's index dtype), not
int32; the column indices and exponents are device constants kept beside
the function (``common.DeviceConst``), as the JAX package closes over them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import (
    DeviceConst,
    Lowered,
    LowerCtx,
    ModelOutput,
)
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException


def _lower_table(table: ir.RegressionTable, ctx: LowerCtx):
    """One RegressionTable → (params, fn(params, X, M) -> (y, missing))."""
    num_cols = DeviceConst(
        [ctx.column(p.name) for p in table.numeric_predictors], np.int64
    )
    num_exps = np.asarray(
        [p.exponent for p in table.numeric_predictors], np.float32
    )
    all_exp_one = bool(np.all(num_exps == 1.0))
    exps = DeviceConst(num_exps)
    cat_cols = DeviceConst(
        [ctx.column(p.name) for p in table.categorical_predictors], np.int64
    )

    params = {
        "intercept": np.float32(table.intercept),
        "num_coefs": np.asarray(
            [p.coefficient for p in table.numeric_predictors], np.float32
        ),
        "cat_codes": np.asarray(
            [ctx.encode(p.name, p.value) for p in table.categorical_predictors],
            np.float32,
        ),
        "cat_coefs": np.asarray(
            [p.coefficient for p in table.categorical_predictors], np.float32
        ),
    }

    def fn(p: dict, X: torch.Tensor, M: torch.Tensor):
        B = X.shape[0]
        y = p["intercept"].expand(B)
        missing = torch.zeros((B,), dtype=torch.bool, device=X.device)
        if num_cols.array.size:
            nc = num_cols.on(X.device)
            xs = X[:, nc]  # [B, P]
            if not all_exp_one:
                xs = xs ** exps.on(X.device)
            y = y + torch.matmul(xs, p["num_coefs"])
            missing = missing | M[:, nc].any(dim=1)
        if cat_cols.array.size:
            cc = cat_cols.on(X.device)
            xc = X[:, cc]  # [B, Q]
            ind = (xc == p["cat_codes"][None, :]) & ~M[:, cc]
            y = y + torch.matmul(ind.to(torch.float32), p["cat_coefs"])
        return y, missing

    return params, fn


def lower_regression(model: ir.RegressionModelIR, ctx: LowerCtx) -> Lowered:
    nm = model.normalization_method
    lowered_tables = [_lower_table(t, ctx) for t in model.tables]
    params = {f"t{i}": p for i, (p, _) in enumerate(lowered_tables)}
    table_fns = [f for _, f in lowered_tables]

    if model.function_name == "regression":
        if nm not in ("none", "identity", "softmax", "logit", "exp",
                      "cauchit", "cloglog", "loglog", "probit"):
            raise ModelCompilationException(
                f"unsupported regression normalization {nm!r}"
            )
        t0 = table_fns[0]

        def fn(p, X, M):
            y, missing = t0(p["t0"], X, M)
            if nm in ("softmax", "logit"):
                # PMML: for regression, softmax == logit == sigmoid
                y = 1.0 / (1.0 + torch.exp(-y))
            elif nm == "exp":
                y = torch.exp(y)
            elif nm == "cauchit":
                y = 0.5 + torch.atan(y) / np.pi
            elif nm == "cloglog":
                y = 1.0 - torch.exp(-torch.exp(y))
            elif nm == "loglog":
                y = torch.exp(-torch.exp(-y))
            elif nm == "probit":
                y = 0.5 * (1.0 + torch.special.erf(y / np.sqrt(2.0)))
            return ModelOutput(value=y, valid=~missing)

        return Lowered(fn=fn, params=params)

    if model.function_name != "classification":
        raise ModelCompilationException(
            f"unsupported RegressionModel functionName {model.function_name!r}"
        )

    labels: Tuple[str, ...] = tuple(
        t.target_category or str(i) for i, t in enumerate(model.tables)
    )
    if nm not in ("none", "identity", "softmax", "simplemax", "logit"):
        raise ModelCompilationException(
            f"unsupported classification normalization {nm!r}"
        )
    two_tables = len(table_fns) == 2

    def cfn(p, X, M):
        ys, miss = zip(
            *(f(p[f"t{i}"], X, M) for i, f in enumerate(table_fns))
        )
        Y = torch.stack(ys, dim=1)  # [B, C]
        missing = torch.stack(miss, dim=1).any(dim=1)
        if nm == "softmax":
            probs = softmax(Y)
        elif nm == "simplemax":
            s = Y.sum(dim=1, keepdim=True)
            probs = torch.where(s == 0, torch.nan, Y / s)
        elif nm == "logit":
            if two_tables:
                pr = 1.0 / (1.0 + torch.exp(-Y[:, 0]))
                probs = torch.stack([pr, 1.0 - pr], dim=1)
            else:
                probs = 1.0 / (1.0 + torch.exp(-Y))
        else:
            probs = Y
        label_idx = torch.argmax(probs, dim=1)
        value = torch.gather(probs, 1, label_idx[:, None])[:, 0]
        valid = ~missing & ~torch.isnan(value)
        return ModelOutput(
            value=value, valid=valid, probs=probs, label_idx=label_idx
        )

    return Lowered(fn=cfn, params=params, labels=labels)


def softmax(Y: torch.Tensor) -> torch.Tensor:
    m = Y.max(dim=1, keepdim=True).values
    e = torch.exp(Y - m)
    return e / e.sum(dim=1, keepdim=True)
