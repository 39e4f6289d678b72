"""Scorecard → PyTorch: vectorized first-true attribute scan per
characteristic.

The port of ``flink_jpmml_tpu/compile/scorecard.py``. Score = initialScore
+ Σ over Characteristics of the partialScore of the first Attribute whose
predicate is TRUE (UNKNOWN doesn't match — scorecard documents bin missing
values with explicit isMissing attributes); a characteristic with no
matching attribute makes the record's result invalid (empty lane).

Every attribute predicate flattens through gtrees.py's predicate tables
into ``[C, A, K]`` arrays; one evaluation gives the ``[B, C, A]`` truth
cube, the first-true scan is an argmax (over uint8: torch refuses bools),
and the per-characteristic chosen partials land in
``ModelOutput.probs[:, :C]`` with the chosen attribute index in
``probs[:, C:]``. ``CompiledModel.decode`` ranks reason codes from them on
the host (``ReasonCodeMeta.rank``, a stable numpy sort; a copy of the JAX
class). The packer is the JAX package's numpy code, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import Lowered, LowerCtx, ModelOutput
from flink_jpmml_tpu_torch.compile.gtrees import (
    _C_OR,
    _combine,
    _flatten_predicate,
    _P_FALSE,
    _sub_pred_eval,
)
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException


class ReasonCodeMeta:
    """Static reason-code data the decode step needs: per-(c, a) codes,
    per-characteristic baselines, and the ranking algorithm."""

    def __init__(self, model: ir.ScorecardIR):
        self.algorithm = model.reason_code_algorithm
        if self.algorithm not in ("pointsBelow", "pointsAbove"):
            raise ModelCompilationException(
                f"unsupported reasonCodeAlgorithm {self.algorithm!r}"
            )
        self.codes = []  # [C][A] strings
        self.baselines = np.zeros((len(model.characteristics),), np.float32)
        for ci, ch in enumerate(model.characteristics):
            bs = (
                ch.baseline_score
                if ch.baseline_score is not None
                else model.baseline_score
            )
            if bs is None:
                raise ModelCompilationException(
                    f"useReasonCodes: characteristic {ch.name!r} has no "
                    "baselineScore (and the Scorecard declares none)"
                )
            self.baselines[ci] = bs
            row = []
            for at in ch.attributes:
                code = at.reason_code or ch.reason_code
                if code is None:
                    raise ModelCompilationException(
                        f"useReasonCodes: characteristic {ch.name!r} has "
                        "an attribute with no reasonCode (attribute or "
                        "characteristic level)"
                    )
                row.append(code)
            self.codes.append(row)

    def rank(self, partials: np.ndarray, attr_idx: np.ndarray) -> list:
        """One record's ([C] partials, [C] chosen attribute) → reason
        codes ranked worst-first per the algorithm (ties: document
        order, np.argsort stable)."""
        diff = (
            self.baselines - partials
            if self.algorithm == "pointsBelow"
            else partials - self.baselines
        )
        order = np.argsort(-diff, kind="stable")
        return [
            self.codes[c][int(attr_idx[c])] for c in order
        ]


def lower_scorecard(model: ir.ScorecardIR, ctx: LowerCtx) -> Lowered:
    C = len(model.characteristics)
    A = max(len(ch.attributes) for ch in model.characteristics)
    flat = [
        [_flatten_predicate(at.predicate, ctx) for at in ch.attributes]
        for ch in model.characteristics
    ]
    K = max(len(subs) for row in flat for _, subs in row)
    KS = max(
        (len(s[3]) for row in flat for _, subs in row for s in subs),
        default=0,
    )

    pcol = np.zeros((C, A, K), np.int32)
    pop = np.full((C, A, K), float(_P_FALSE), np.float32)
    pval = np.zeros((C, A, K), np.float32)
    pact = np.zeros((C, A, K), np.float32)
    pneg = np.zeros((C, A, K), np.float32)
    pterm = np.zeros((C, A, K), np.float32)
    # padded attribute slots (characteristics with fewer than A
    # attributes) must evaluate FALSE: an empty AND is vacuously TRUE in
    # the three-valued combiner, an empty OR is FALSE — pad with OR
    # (same convention as gtrees.pack_general)
    pcomb = np.full((C, A), float(_C_OR), np.float32)
    psets = np.full((C, A, K, KS), np.nan, np.float32) if KS else None
    partial = np.zeros((C, A), np.float32)

    # ComplexPartialScore slots: (ci, ai, lowered expression) — their
    # per-record values overwrite the static partial plane in fn
    expr_slots = []
    for ci, ch in enumerate(model.characteristics):
        for ai, at in enumerate(ch.attributes):
            comb, subs = flat[ci][ai]
            pcomb[ci, ai] = comb
            partial[ci, ai] = at.partial_score
            if at.partial_expr is not None:
                from flink_jpmml_tpu_torch.compile.exprs import lower_expression

                expr_slots.append(
                    (ci, ai, lower_expression(at.partial_expr, ctx))
                )
            for k, (c_, o_, v_, s_, n_, t_) in enumerate(subs):
                pcol[ci, ai, k] = c_
                pop[ci, ai, k] = o_
                pval[ci, ai, k] = v_
                pact[ci, ai, k] = 1.0
                pneg[ci, ai, k] = 1.0 if n_ else 0.0
                pterm[ci, ai, k] = t_
                if s_ and psets is not None:
                    psets[ci, ai, k, : len(s_)] = s_

    params = {
        "pcol": pcol, "pop": pop, "pval": pval, "pact": pact,
        "pneg": pneg, "pterm": pterm, "pcomb": pcomb,
        "partial": partial,
    }
    if psets is not None:
        params["psets"] = psets
    init = float(model.initial_score)

    def fn(p, X, M):
        B = X.shape[0]
        cols = p["pcol"].reshape(-1).long()  # [C*A*K]
        x = X[:, cols].reshape(B, C, A, K)
        m = M[:, cols].reshape(B, C, A, K)
        member = None
        if "psets" in p:
            member = (x[..., None] == p["psets"][None]).any(dim=-1)
        isT, isU = _sub_pred_eval(
            x, m, p["pop"][None], p["pval"][None], member, p["pneg"][None]
        )
        attrT, _attrU = _combine(
            p["pcomb"][None], isT, isU, p["pact"][None], p["pterm"][None]
        )  # [B, C, A]; UNKNOWN attributes simply don't match
        matched = attrT.any(dim=-1)  # [B, C]
        first = torch.argmax(attrT.to(torch.uint8), dim=-1)  # first True
        partial_dyn = p["partial"][None].expand(B, C, A)
        expr_bad = None  # [B, C, A] chosen-slot poison for failed exprs
        if expr_slots:
            partial_dyn = partial_dyn.clone()
            expr_bad = torch.zeros((B, C, A), dtype=torch.bool,
                                   device=X.device)
            for ci, ai, efn in expr_slots:
                v, miss = efn(X, M)
                partial_dyn[:, ci, ai] = torch.where(
                    miss, 0.0, v.to(torch.float32)
                )
                expr_bad[:, ci, ai] = miss
        chosen = torch.gather(partial_dyn, 2, first[..., None])[..., 0]  # [B, C]
        value = init + chosen.sum(dim=-1)
        valid = matched.all(dim=-1)
        if expr_bad is not None:
            # a chosen attribute whose ComplexPartialScore failed to
            # compute empties the lane (oracle parity)
            chosen_bad = torch.gather(expr_bad, 2, first[..., None])[..., 0]
            valid = valid & ~chosen_bad.any(dim=-1)
        # decode-side payload: per-characteristic partials + chosen
        # attribute index (for attribute-level reason codes)
        probs = torch.cat([chosen, first.to(torch.float32)], dim=1)  # [B, 2C]
        return ModelOutput(
            value=value.to(torch.float32),
            valid=valid,
            probs=probs,
            label_idx=None,
        )

    return Lowered(fn=fn, params=params, labels=())
