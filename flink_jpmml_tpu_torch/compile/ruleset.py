"""RuleSetModel → PyTorch: one truth cube over all (flattened) rules.

The port of ``flink_jpmml_tpu/compile/ruleset.py``. The parser flattens
CompoundRule nesting into first-hit-ordered SimpleRules whose predicates
AND their ancestors', so the lowering only sees a flat rule list.
Selection criteria:

- ``firstHit``: the first TRUE rule's score wins (document order);
  confidence = that rule's.
- ``weightedSum``: each TRUE rule adds its weight to its score's total;
  the score with the largest total wins (ties: first in rule order).
- ``weightedMax``: the TRUE rule with the largest weight wins.

No TRUE rule → ``defaultScore`` (with ``defaultConfidence``) when
declared, else the lane is invalid. UNKNOWN predicates don't fire.

The predicate machinery is gtrees.py's; the rule set evaluates as one
``[B, R]`` truth matrix. The packer is the JAX package's numpy code,
copied. The first TRUE rule is an argmax over uint8 (torch refuses
bools); both libraries return the first maximal index. The weightedSum
totals are a ``torch.einsum`` in float32 with TF32 off
(``utils/device.py``), the JAX code's ``precision=HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import Lowered, LowerCtx, ModelOutput
from flink_jpmml_tpu_torch.compile.gtrees import (
    _combine,
    _flatten_predicate,
    _P_FALSE,
    _sub_pred_eval,
)
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

_CRITERIA = ("firstHit", "weightedSum", "weightedMax")


def lower_ruleset(model: ir.RuleSetIR, ctx: LowerCtx) -> Lowered:
    if model.selection_method not in _CRITERIA:
        raise ModelCompilationException(
            f"unsupported RuleSelectionMethod {model.selection_method!r} "
            f"(supported: {', '.join(_CRITERIA)})"
        )
    R = len(model.rules)
    flat = [_flatten_predicate(r.predicate, ctx) for r in model.rules]
    K = max(len(subs) for _, subs in flat)
    KS = max((len(s[3]) for _, subs in flat for s in subs), default=0)

    pcol = np.zeros((R, K), np.int32)
    pop = np.full((R, K), float(_P_FALSE), np.float32)
    pval = np.zeros((R, K), np.float32)
    pact = np.zeros((R, K), np.float32)
    pneg = np.zeros((R, K), np.float32)
    pterm = np.zeros((R, K), np.float32)
    pcomb = np.zeros((R,), np.float32)
    psets = np.full((R, K, KS), np.nan, np.float32) if KS else None
    for ri, (comb, subs) in enumerate(flat):
        pcomb[ri] = comb
        for k, (c_, o_, v_, s_, n_, t_) in enumerate(subs):
            pcol[ri, k] = c_
            pop[ri, k] = o_
            pval[ri, k] = v_
            pact[ri, k] = 1.0
            pneg[ri, k] = 1.0 if n_ else 0.0
            pterm[ri, k] = t_
            if s_ and psets is not None:
                psets[ri, k, : len(s_)] = s_

    # label space: distinct rule scores in first-appearance order, plus
    # the default score (classification labels are strings; regression
    # RuleSets carry numeric strings — both decode through the label)
    labels: list = []
    for r in model.rules:
        if r.score not in labels:
            labels.append(r.score)
    has_default = model.default_score is not None
    if has_default and model.default_score not in labels:
        labels.append(model.default_score)
    L = len(labels)
    lab_of_rule = np.asarray(
        [labels.index(r.score) for r in model.rules], np.int32
    )
    default_idx = labels.index(model.default_score) if has_default else 0
    rule_onehot = np.zeros((R, L), np.float32)
    rule_onehot[np.arange(R), lab_of_rule] = 1.0
    weights = np.asarray([r.weight for r in model.rules], np.float32)
    confidences = np.asarray(
        [r.confidence for r in model.rules], np.float32
    )
    method = model.selection_method
    default_conf = float(model.default_confidence)

    params = {
        "pcol": pcol, "pop": pop, "pval": pval, "pact": pact,
        "pneg": pneg, "pterm": pterm, "pcomb": pcomb,
        "onehot": rule_onehot, "w": weights, "conf": confidences,
        "lab": lab_of_rule.astype(np.float32),
    }
    if psets is not None:
        params["psets"] = psets

    def fn(p, X, M):
        B = X.shape[0]
        cols = p["pcol"].reshape(-1).long()
        x = X[:, cols].reshape(B, R, K)
        m = M[:, cols].reshape(B, R, K)
        member = None
        if "psets" in p:
            member = (x[..., None] == p["psets"][None]).any(dim=-1)
        isT, isU = _sub_pred_eval(
            x, m, p["pop"][None], p["pval"][None], member, p["pneg"][None]
        )
        fired, _u = _combine(
            p["pcomb"][None], isT, isU, p["pact"][None], p["pterm"][None]
        )  # [B, R]
        any_fired = fired.any(dim=-1)
        firedf = fired.to(torch.float32)
        if method == "firstHit":
            first = torch.argmax(fired.to(torch.uint8), dim=-1)  # [B]
            lab = p["lab"][first].long()
            conf = p["conf"][first]
        elif method == "weightedSum":
            totals = torch.einsum(
                "br,rl->bl", firedf * p["w"][None, :], p["onehot"]
            )  # [B, L]
            lab = torch.argmax(totals, dim=-1)
            n_fired = firedf.sum(dim=-1)
            conf = torch.where(
                n_fired > 0,
                totals.max(dim=-1).values / torch.clamp(n_fired, min=1.0),
                0.0,
            )
        else:  # weightedMax
            wf = torch.where(fired, p["w"][None, :], -torch.inf)
            best = torch.argmax(wf, dim=-1)
            lab = p["lab"][best].long()
            conf = p["conf"][best]
        lab = torch.where(any_fired, lab, default_idx)
        conf = torch.where(any_fired, conf, default_conf)
        valid = any_fired | bool(has_default)
        return ModelOutput(
            value=conf.to(torch.float32),  # confidence, like JPMML
            valid=valid,
            probs=None,
            label_idx=lab,
        )

    return Lowered(fn=fn, params=params, labels=tuple(labels))
