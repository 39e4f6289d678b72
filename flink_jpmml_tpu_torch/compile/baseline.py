"""BaselineModel → PyTorch: per-record z-value against a parametric baseline.

The port of ``flink_jpmml_tpu/compile/baseline.py``. The ``zValue`` test
statistic is stateless per record:

    z = (x − μ₀) / σ₀

with (μ₀, σ₀²) from the declared baseline distribution — Gaussian
(mean, variance), Poisson (σ₀² = μ₀), or Uniform (μ₀ = (l+u)/2,
σ₀² = (u−l)²/12). Windowed statistics are rejected at parse time. A
missing test field scores as an empty lane.
"""

from __future__ import annotations

import math

import numpy as np

from flink_jpmml_tpu_torch.compile.common import Lowered, LowerCtx, ModelOutput
from flink_jpmml_tpu_torch.pmml import ir


def lower_baseline(model: ir.BaselineIR, ctx: LowerCtx) -> Lowered:
    col = ctx.column(model.field)
    params = {
        "mean": np.float32(model.baseline.mean),
        "inv_sd": np.float32(1.0 / math.sqrt(model.baseline.variance)),
    }

    def fn(p, X, M):
        return ModelOutput(
            value=(X[:, col] - p["mean"]) * p["inv_sd"], valid=~M[:, col]
        )

    return Lowered(fn=fn, params=params)
