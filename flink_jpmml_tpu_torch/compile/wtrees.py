"""Weighted-path tree evaluation: missingValueStrategy weightedConfidence
(classification) and aggregateNodes (regression).

The port of ``flink_jpmml_tpu/compile/wtrees.py``. JPMML routes an UNKNOWN
split under these strategies into ALL viable children at once, weighting
each by its recordCount share, and aggregates the reached leaves. The
boolean path-matrix lowering cannot express fractional membership, so
these trees lower here: the tree unrolls when the function runs, and every
node's weight is

    w(child) = w(node) ·  [first-TRUE child]           when any child is TRUE
               w(node) ·  rc(child)/Σ rc(viable)       when none is TRUE but
                                                       some are UNKNOWN
               0                                       all children FALSE

with viable = not-FALSE children. Leaves aggregate weight-normalized:
classification sums per-leaf confidences (ScoreDistribution confidence
attribute, else recordCount proportions), regression sums leaf scores. A
record whose total reaching weight is zero — dead-end or root miss — is an
empty lane. Documents must carry recordCount on every child of a
splittable node (rejected at compile otherwise).

``_leaf_payload`` is the JAX package's numpy code, copied. The unroll is
O(nodes) eager torch ops a call (XLA fuses them in the JAX package); the
leaf aggregation is a ``torch.matmul`` in float32 with TF32 off
(``utils/device.py``), the JAX code's ``precision=HIGHEST``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import (
    Lowered,
    LowerCtx,
    ModelOutput,
    lower_predicate,
)
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException


def _leaf_payload(model: ir.TreeModelIR):
    """Collect leaves + per-leaf payloads; classification gets the label
    list and per-leaf confidence rows."""
    leaves: List[ir.TreeNode] = []

    def walk(n: ir.TreeNode):
        if n.is_leaf:
            leaves.append(n)
        for c in n.children:
            walk(c)

    walk(model.root)
    if model.function_name == "classification":
        labels: List[str] = []
        for leaf in leaves:
            if not leaf.score_distribution:
                raise ModelCompilationException(
                    "weightedConfidence needs a ScoreDistribution on "
                    "every leaf"
                )
            for sd in leaf.score_distribution:
                if sd.value not in labels:
                    labels.append(sd.value)
        for leaf in leaves:
            # a leaf's score attribute may legally be absent from every
            # distribution; it still names a class (confidence 0)
            if leaf.score is not None and leaf.score not in labels:
                labels.append(leaf.score)
        conf = np.zeros((len(leaves), len(labels)), np.float32)
        # the leaf's score attribute is the DETERMINISTIC-path winner
        # (it may legally disagree with the max confidence); −1 = no
        # score declared, fall back to the confidence argmax
        leaf_label = np.full((len(leaves),), -1, np.int32)
        for li, leaf in enumerate(leaves):
            tot = sum(sd.record_count for sd in leaf.score_distribution)
            for sd in leaf.score_distribution:
                c = (
                    sd.confidence
                    if sd.confidence is not None
                    else (sd.record_count / tot if tot > 0 else 0.0)
                )
                conf[li, labels.index(sd.value)] = c
            if leaf.score is not None and leaf.score in labels:
                leaf_label[li] = labels.index(leaf.score)
        return leaves, tuple(labels), (conf, leaf_label)
    vals = np.zeros((len(leaves),), np.float32)
    for li, leaf in enumerate(leaves):
        if leaf.score is None:
            raise ModelCompilationException(
                "aggregateNodes needs a score on every leaf"
            )
        try:
            vals[li] = float(leaf.score)
        except ValueError:
            raise ModelCompilationException(
                f"aggregateNodes leaf score {leaf.score!r} is not numeric"
            ) from None
    return leaves, (), vals


def lower_weighted_tree(model: ir.TreeModelIR, ctx: LowerCtx) -> Lowered:
    strategy = model.missing_value_strategy
    classification = model.function_name == "classification"
    if strategy == "weightedConfidence" and not classification:
        raise ModelCompilationException(
            "weightedConfidence applies to classification trees"
        )
    if strategy == "aggregateNodes" and classification:
        raise ModelCompilationException(
            "aggregateNodes applies to regression trees"
        )
    leaves, labels, payload = _leaf_payload(model)
    if classification:
        payload, leaf_label = payload
    leaf_index = {id(leaf): i for i, leaf in enumerate(leaves)}
    root_pred = lower_predicate(model.root.predicate, ctx)

    # node → lowered child predicates + recordCount shares, fixed at
    # compile; the per-record weight propagation runs at call time
    def prep(n: ir.TreeNode):
        preds = [lower_predicate(c.predicate, ctx) for c in n.children]
        rcs = []
        for c in n.children:
            if c.record_count is None:
                raise ModelCompilationException(
                    f"{strategy} needs recordCount on every child node "
                    f"(missing on node {c.node_id!r})"
                )
            rcs.append(max(float(c.record_count), 0.0))
        return preds, np.asarray(rcs, np.float32)

    prepped: Dict[int, Tuple] = {}

    def prewalk(n: ir.TreeNode):
        if not n.is_leaf:
            prepped[id(n)] = prep(n)
            for c in n.children:
                prewalk(c)

    prewalk(model.root)
    params: dict = {"payload": payload}
    if classification:
        params["leaf_label"] = leaf_label

    def fn(p, X, M):
        B = X.shape[0]
        L = len(leaves)
        zeros = torch.zeros((B,), dtype=torch.float32, device=X.device)
        leaf_w = [zeros] * L

        def walk(n: ir.TreeNode, w):
            if n.is_leaf:
                li = leaf_index[id(n)]
                leaf_w[li] = leaf_w[li] + w
                return
            preds, rcs = prepped[id(n)]
            outs = [pf(X, M) for pf in preds]
            trues = [o.is_true for o in outs]
            unknowns = [o.unknown for o in outs]
            any_true = trues[0]
            for t in trues[1:]:
                any_true = any_true | t
            # viable = not FALSE (true or unknown); the distribution
            # denominator is data-dependent: Σ rc over viable children
            viable = [t | u for t, u in zip(trues, unknowns)]
            denom = zeros
            for v, rc in zip(viable, rcs):
                denom = denom + v.to(torch.float32) * float(rc)
            seen_true = torch.zeros_like(any_true)
            for c, t, v, rc in zip(n.children, trues, viable, rcs):
                first_true = t & ~seen_true
                seen_true = seen_true | t
                frac = torch.where(
                    any_true,
                    first_true.to(torch.float32),
                    torch.where(
                        denom > 0,
                        v.to(torch.float32) * float(rc)
                        / torch.clamp(denom, min=1e-30),
                        0.0,
                    ),
                )
                walk(c, w * frac)

        root_ok = root_pred(X, M).is_true
        walk(model.root, root_ok.to(torch.float32))
        W = torch.stack(leaf_w, dim=1)  # [B, L]
        total = W.sum(dim=1)
        valid = total > 0
        tz = torch.clamp(total, min=1e-30)[:, None]
        if classification:
            probs = torch.matmul(W, p["payload"]) / tz  # [B, C]
            lab = torch.argmax(probs, dim=1)
            # deterministic path (all weight on one leaf): the leaf's
            # score attribute wins, exactly like the boolean-path
            # backends — it may legally disagree with the max confidence
            wmax_leaf = torch.argmax(W, dim=1)
            det = (
                torch.gather(W, 1, wmax_leaf[:, None])[:, 0] >= total - 1e-6
            )
            det_lab = p["leaf_label"].long()[wmax_leaf]
            lab = torch.where(det & (det_lab >= 0), det_lab, lab)
            value = torch.gather(probs, 1, lab[:, None])[:, 0]
            return ModelOutput(
                value=value, valid=valid, probs=probs, label_idx=lab
            )
        value = torch.matmul(W, p["payload"][:, None])[:, 0] / tz[:, 0]
        return ModelOutput(value=value, valid=valid)

    return Lowered(fn=fn, params=params, labels=labels)
