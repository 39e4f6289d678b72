"""AnomalyDetectionModel (PMML 4.4) → PyTorch: inner model + normalization.

The port of ``flink_jpmml_tpu/compile/anomaly.py``: the sklearn
IsolationForest export (sklearn2pmml wraps the forest of path-length trees
in one). The inner model (any ported family; iforest uses a MiningModel
averaging per-tree path lengths) produces the raw score s; the wrapper
normalizes:

- ``iforest``: score = 2^(−s / c(n)), n = sampleDataSize and
  c(n) = 2·(ln(n−1) + γ) − 2·(n−1)/n (average unsuccessful-search depth
  of a BST; γ the Euler–Mascheroni constant) — higher means more
  anomalous, 0.5 is the "no structure" midpoint.
- ``ocsvm`` / ``other``: the inner value passes through unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import Lowered, LowerCtx
from flink_jpmml_tpu_torch.pmml import ir

_EULER_GAMMA = 0.5772156649015329


def iforest_c(n: int) -> float:
    """Average unsuccessful-search path length of a BST over n samples."""
    return 2.0 * (math.log(n - 1.0) + _EULER_GAMMA) - 2.0 * (n - 1.0) / n


def lower_anomaly(model: ir.AnomalyDetectionIR, ctx: LowerCtx) -> Lowered:
    from flink_jpmml_tpu_torch.compile.compiler import lower_model

    inner = lower_model(model.inner, ctx)
    if model.algorithm_type != "iforest":
        return inner  # ocsvm / other: raw inner value
    c = float(np.float32(iforest_c(model.sample_data_size)))

    def fn(p, X, M):
        out = inner.fn(p, X, M)
        return out._replace(value=torch.exp2(-out.value / c))

    return Lowered(fn=fn, params=inner.params, labels=inner.labels)
