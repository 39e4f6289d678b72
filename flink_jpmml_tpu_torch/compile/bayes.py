"""NaiveBayesModel → PyTorch: summed log-likelihood tables + argmax.

The port of ``flink_jpmml_tpu/compile/bayes.py``. Semantics (PMML 4.x):

    L(t) = log count(t) + Σ_i log P(x_i | t)

- categorical input: P = PairCounts count / BayesOutput target count;
  zero probabilities are replaced by the model ``threshold``;
- continuous input: Gaussian density from TargetValueStats
  (mean/variance per target value);
- a missing input (or an input value with no PairCounts row) drops its
  term — records with everything missing score the priors.

The winner is argmax L; per-class probabilities are the softmax over L.
Each categorical input is one log-probability table ``[V_i + 1, T]``
(last row = the out-of-table / missing zero row) gathered per record;
continuous inputs are closed-form log-density lanes.

The table packing is the JAX package's numpy code, copied. Deliberate
differences: the first matching code is found by ``torch.argmax`` over
uint8 (torch refuses bools; the first maximum in both), and
``label_idx`` is int64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import Lowered, LowerCtx, ModelOutput
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException


def lower_naive_bayes(model: ir.NaiveBayesIR, ctx: LowerCtx) -> Lowered:
    labels = tuple(v for v, _ in model.target_counts)
    T = len(labels)
    tpos = {v: i for i, v in enumerate(labels)}
    totals = np.asarray([c for _, c in model.target_counts], np.float64)
    if (totals <= 0).any():
        raise ModelCompilationException(
            "BayesOutput target counts must all be positive"
        )
    thr = model.threshold
    prior = np.log(totals)  # unnormalized: constants cancel in argmax

    cat_tables: list = []  # (col, codes f32[V], logp f32[V+1, T])
    cont_rows: list = []  # (col, mean[T], var[T], active[T])
    for bi in model.inputs:
        col = ctx.column(bi.field)
        if isinstance(bi, ir.BayesCategoricalInput):
            codes = []
            rows = []
            for value, counts in bi.counts:
                codes.append(ctx.encode(bi.field, value))
                row = np.zeros((T,), np.float64)
                for tv, cnt in counts:
                    if tv not in tpos:
                        raise ModelCompilationException(
                            f"BayesInput {bi.field!r}: PairCounts target "
                            f"{tv!r} not in BayesOutput"
                        )
                    row[tpos[tv]] = cnt
                p = row / totals
                if thr <= 0 and (p <= 0).any():
                    raise ModelCompilationException(
                        f"BayesInput {bi.field!r}: zero conditional "
                        "probability with no positive model threshold"
                    )
                # the threshold replaces ZERO probabilities only (spec)
                rows.append(np.log(np.where(p > 0, p, thr)))
            # sentinel last row: out-of-table / missing input drops the term
            logp = np.zeros((len(rows) + 1, T), np.float32)
            logp[: len(rows)] = np.asarray(rows, np.float32)
            cat_tables.append((col, np.asarray(codes, np.float32), logp))
        else:
            mean = np.zeros((T,), np.float32)
            var = np.ones((T,), np.float32)
            active = np.zeros((T,), np.float32)
            for tv, m_, v_ in bi.stats:
                if tv not in tpos:
                    raise ModelCompilationException(
                        f"BayesInput {bi.field!r}: stats target {tv!r} "
                        "not in BayesOutput"
                    )
                if v_ <= 0:
                    raise ModelCompilationException(
                        f"BayesInput {bi.field!r}: non-positive variance "
                        f"for target {tv!r}"
                    )
                mean[tpos[tv]] = m_
                var[tpos[tv]] = v_
                active[tpos[tv]] = 1.0
            cont_rows.append((col, mean, var, active))

    params = {
        "prior": prior.astype(np.float32),
        **{f"cat{i}_logp": t[2] for i, t in enumerate(cat_tables)},
        **{f"cat{i}_codes": t[1] for i, t in enumerate(cat_tables)},
    }
    for i, (col, mean, var, active) in enumerate(cont_rows):
        params[f"g{i}_mean"] = mean
        params[f"g{i}_var"] = var
        params[f"g{i}_act"] = active
    cat_cols = [col for col, _, _ in cat_tables]
    cont_cols = [col for col, _, _, _ in cont_rows]
    log2pi = float(math.log(2.0 * math.pi))

    def fn(p, X, M):
        B = X.shape[0]
        L = p["prior"][None, :].expand(B, T)
        for i, col in enumerate(cat_cols):
            codes = p[f"cat{i}_codes"]
            x = X[:, col]
            hit = x[:, None] == codes[None, :]  # [B, V]
            idx = torch.where(
                hit.any(dim=1) & ~M[:, col],
                torch.argmax(hit.to(torch.uint8), dim=1),
                codes.shape[0],  # sentinel zero row: missing / unknown
            )
            L = L + p[f"cat{i}_logp"][idx]
        for i, col in enumerate(cont_cols):
            mean = p[f"g{i}_mean"]
            var = p[f"g{i}_var"]
            x = X[:, col][:, None]
            logpdf = -0.5 * (log2pi + torch.log(var))[None, :] - (
                (x - mean[None, :]) ** 2 / (2.0 * var)[None, :]
            )
            drop = M[:, col][:, None] | (p[f"g{i}_act"][None, :] < 0.5)
            L = L + torch.where(drop, 0.0, logpdf)
        lab = torch.argmax(L, dim=1)
        e = torch.exp(L - L.max(dim=1, keepdim=True).values)
        probs = e / e.sum(dim=1, keepdim=True)
        value = probs.gather(1, lab[:, None])[:, 0]
        return ModelOutput(
            value=value,
            valid=torch.ones((B,), dtype=torch.bool, device=X.device),
            probs=probs,
            label_idx=lab,
        )

    return Lowered(fn=fn, params=params, labels=labels)
