"""AssociationModel → PyTorch: rule firing as one 0/1 matmul + ranked pick.

The port of ``flink_jpmml_tpu/compile/assoc.py``. The input contract is
the fixed-width framing of ``ir.AssociationIR``: one active MiningField
per declared item, value > 0.5 ⇔ the item is in the record's basket.

With basket matrix Xb ∈ {0,1}^[B, I] and antecedent matrix A ∈
{0,1}^[R, I], a rule fires iff Xb·Aᵀ equals the antecedent size — subset
testing as one ``torch.matmul`` (float32, TF32 off: ``utils/device.py``;
0/1 sums are exact). The ``rule`` and ``exclusiveRecommendation``
criteria need the consequent∩basket count, a second product against the
consequent matrix. Rules are ranked on the host by (confidence desc,
support desc, document order); the device picks the first fired rule in
that order with one argmax (over uint8: torch refuses bools; the first
maximum in both). Value = the winning rule's confidence, label = its
consequent; no rule fired ⇒ empty lane. ``probs`` carries the fired mask
in document order, which ``CompiledModel`` ranks for ``ruleValue``
outputs.

Deliberate differences: ``label_idx`` is int64; the item columns are a
device constant; the ``order`` table stays int32 in the parameters, as
in the JAX package, and is widened where it gathers.
"""

from __future__ import annotations

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


def rule_order(rules) -> list:
    """Rule indices by (confidence desc, support desc, document order)."""
    return sorted(
        range(len(rules)),
        key=lambda i: (-rules[i].confidence, -rules[i].support, i),
    )


def lower_association(model: ir.AssociationIR, ctx: LowerCtx) -> Lowered:
    items = model.items
    ipos = {v: i for i, v in enumerate(items)}
    cols = DeviceConst([ctx.column(v) for v in items], np.int64)
    R, I = len(model.rules), len(items)

    A = np.zeros((R, I), np.float32)  # antecedent membership
    Cq = np.zeros((R, I), np.float32)  # consequent membership
    conf = np.zeros((R,), np.float32)
    for ri, r in enumerate(model.rules):
        for v in r.antecedent:
            A[ri, ipos[v]] = 1.0
        for v in r.consequent:
            Cq[ri, ipos[v]] = 1.0
        conf[ri] = r.confidence
    ante_n = A.sum(axis=1)
    cons_n = Cq.sum(axis=1)
    if (cons_n == 0).any():
        raise ModelCompilationException(
            "AssociationRule with an empty consequent"
        )
    criterion = model.criterion
    if criterion not in ("rule", "recommendation", "exclusiveRecommendation"):
        raise ModelCompilationException(
            f"unsupported association criterion {criterion!r}"
        )

    params = {
        "A": A, "Cq": Cq,
        "ante_n": ante_n.astype(np.float32),
        "cons_n": cons_n.astype(np.float32),
        "conf": conf,
        "order": np.asarray(rule_order(model.rules), np.int32),
    }
    labels = tuple(" ".join(r.consequent) for r in model.rules)

    def fn(p, X, M):
        c = cols.on(X.device)
        # missing item columns read as "not in basket"
        Xb = ((X[:, c] > 0.5) & ~M[:, c]).to(torch.float32)
        in_ante = torch.matmul(Xb, p["A"].T)  # [B, R]
        fired = in_ante >= p["ante_n"][None, :] - 0.5
        if criterion != "recommendation":
            # "rule" = whole rule in the basket; "exclusiveRecommendation"
            # (spec default) = antecedent in, consequent NOT fully in yet
            in_cons = torch.matmul(Xb, p["Cq"].T)
            cons_in = in_cons >= p["cons_n"][None, :] - 0.5
            fired = fired & (cons_in if criterion == "rule" else ~cons_in)
        order = p["order"].to(torch.int64)
        fired_sorted = fired[:, order]
        first = torch.argmax(fired_sorted.to(torch.uint8), dim=1)
        rule_idx = order[first]
        return ModelOutput(
            value=p["conf"][rule_idx],
            valid=fired_sorted.any(dim=1),
            probs=fired.to(torch.float32),  # document order
            label_idx=rule_idx,
        )

    return Lowered(fn=fn, params=params, labels=labels)
