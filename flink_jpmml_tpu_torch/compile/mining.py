"""MiningModel → PyTorch: ensembles and stacking.

The port of ``flink_jpmml_tpu/compile/mining.py``: the aggregation
methods sum / average / weightedAverage / max / median, the vote methods,
``modelChain``, ``selectFirst`` and ``selectAll``:

1. **Fused tree-ensemble fast path**: every segment is a canonical
   TreeModel with a ``<True/>`` predicate (the GBM shape, BASELINE config
   2) → :func:`~flink_jpmml_tpu_torch.compile.trees.lower_tree_ensemble`
   packs all trees into one padded tensor family.
2. **modelChain** (BASELINE config 5): segments run in sequence, each
   exporting its ``predictedValue`` / ``probability`` output fields as new
   columns of the field space; a straight-line composition that extends
   ``X`` / ``M`` functionally. A missing result from an active segment
   poisons the chain's result.
3. **Generic aggregation**: segments with predicates (or non-tree
   segments) lower independently and combine per ``multipleModelMethod``
   with vectorized active-segment masks. A segment whose family is not
   ported raises :class:`NotPortedError` from ``lower_model``.
4. **selectFirst / selectAll**: every segment runs on every record; the
   first active segment's result is kept (selectFirst), or every active
   segment's value is carried in ``probs`` as ``[values ∥ active]``,
   which ``CompiledModel.decode`` turns into the per-segment map
   (selectAll).

The JAX package's ``mesh=`` sharding of the chain's wide stage is not
ported: a chain runs on one card.

Missing semantics match the JAX package: a missing result from any
*active* segment poisons aggregate results; inactive segments are
excluded; no active segment ⇒ missing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import (
    Lowered,
    LowerCtx,
    ModelOutput,
    lower_predicate,
)
from flink_jpmml_tpu_torch.compile.trees import lower_tree_ensemble
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

_AGG_METHODS = (
    "sum",
    "average",
    "weightedAverage",
    "max",
    "median",
    "majorityVote",
    "weightedMajorityVote",
)


def lower_mining(model: ir.MiningModelIR, ctx: LowerCtx) -> Lowered:
    method = model.segmentation.multiple_model_method
    segments = model.segmentation.segments

    if method == "modelChain":
        return _lower_chain(segments, ctx)
    if method == "selectFirst":
        return _lower_select_first(segments, ctx)
    if method == "selectAll":
        return _lower_select_all(segments, ctx)
    if method not in _AGG_METHODS:
        raise ModelCompilationException(
            f"unsupported multipleModelMethod {method!r}"
        )

    all_true = all(
        isinstance(s.predicate, ir.TruePredicate) for s in segments
    )
    all_trees = all(
        isinstance(s.model, ir.TreeModelIR)
        and s.model.missing_value_strategy
        not in ("weightedConfidence", "aggregateNodes")
        for s in segments
    )
    if all_true and all_trees:
        classification = segments[0].model.function_name == "classification"
        fused_ok = (
            method in ("majorityVote", "weightedMajorityVote")
            if classification
            else method in ("sum", "average", "weightedAverage", "max", "median")
        )
        if fused_ok:
            return lower_tree_ensemble(
                [s.model for s in segments],
                [s.weight for s in segments],
                method,
                ctx,
            )
    return _lower_aggregate(segments, method, ctx)


def _nested(ctx: LowerCtx) -> LowerCtx:
    return ctx if ctx.nested else dataclasses.replace(ctx, nested=True)


def _lower_segments(segments, ctx) -> List[Lowered]:
    from flink_jpmml_tpu_torch.compile.compiler import lower_model

    sub = _nested(ctx)
    return [lower_model(s.model, sub) for s in segments]


def _lower_chain(segments: Tuple[ir.Segment, ...], ctx: LowerCtx) -> Lowered:
    from flink_jpmml_tpu_torch.compile.compiler import lower_model

    if not isinstance(segments[-1].predicate, ir.TruePredicate):
        raise ModelCompilationException(
            "modelChain lowering requires the final segment's predicate to "
            "be <True/> (per-record final-segment selection is oracle-only)"
        )

    steps = []  # (pred_fn|None, lowered, [(out_name, feature, prob_col)])
    cur_ctx = ctx
    params = {}
    for i, seg in enumerate(segments):
        pred_fn = (
            None
            if isinstance(seg.predicate, ir.TruePredicate)
            else lower_predicate(seg.predicate, cur_ctx)
        )
        low = lower_model(seg.model, _nested(cur_ctx))
        params[f"s{i}"] = low.params
        outs = []
        new_names: List[str] = []
        new_codecs = {}
        for of in seg.output_fields:
            if of.feature == "predictedValue":
                outs.append((of.name, "predictedValue", None))
                if low.is_classification:
                    # downstream predicates compare against the label code
                    new_codecs[of.name] = {
                        lbl: float(j) for j, lbl in enumerate(low.labels)
                    }
            elif of.feature == "probability":
                if not low.is_classification or of.target_value is None:
                    raise ModelCompilationException(
                        f"OutputField {of.name!r}: probability feature needs "
                        "a classification segment and a target value"
                    )
                outs.append(
                    (of.name, "probability", low.labels.index(of.target_value))
                )
            else:
                raise ModelCompilationException(
                    f"unsupported OutputField feature {of.feature!r}"
                )
            new_names.append(of.name)
        steps.append((pred_fn, low, outs))
        if new_names:
            cur_ctx = cur_ctx.with_extra_fields(tuple(new_names), new_codecs)

    final_low = steps[-1][1]

    def fn(p, X, M):
        all_valid = None
        out = None
        for i, (pred_fn, low, outs) in enumerate(steps):
            active = _active(pred_fn, X, M)
            out = low.fn(p[f"s{i}"], X, M)
            ok_i = ~active | out.valid
            all_valid = ok_i if all_valid is None else (all_valid & ok_i)
            for name, feature, prob_col in outs:
                if feature == "predictedValue":
                    col = (
                        out.label_idx.to(torch.float32)
                        if low.is_classification
                        else out.value
                    )
                else:
                    col = out.probs[:, prob_col]
                ok = active & out.valid
                X = torch.cat([X, torch.where(ok, col, 0.0)[:, None]], dim=1)
                M = torch.cat([M, (~ok)[:, None]], dim=1)
        return out._replace(valid=out.valid & all_valid)

    return Lowered(fn=fn, params=params, labels=final_low.labels)


def _active(pred_fn, X, M):
    if pred_fn is None:
        return torch.ones((X.shape[0],), dtype=torch.bool, device=X.device)
    return pred_fn(X, M).is_true


def _lower_select_first(
    segments: Tuple[ir.Segment, ...], ctx: LowerCtx
) -> Lowered:
    lows = _lower_segments(segments, ctx)
    pred_fns = [lower_predicate(s.predicate, ctx) for s in segments]
    labels = lows[0].labels
    if any(l.labels != labels for l in lows):
        raise ModelCompilationException(
            "selectFirst lowering requires all segments to share one label "
            "space (or all be regression)"
        )
    params = {f"s{i}": l.params for i, l in enumerate(lows)}

    def fn(p, X, M):
        B = X.shape[0]
        outs = [l.fn(p[f"s{i}"], X, M) for i, l in enumerate(lows)]
        actives = [pf(X, M).is_true for pf in pred_fns]
        chosen = torch.full((B,), -1, dtype=torch.int64, device=X.device)
        for i in range(len(outs) - 1, -1, -1):
            chosen = torch.where(actives[i], i, chosen)
        value = torch.zeros((B,), dtype=torch.float32, device=X.device)
        valid = torch.zeros((B,), dtype=torch.bool, device=X.device)
        probs = None if not labels else torch.zeros_like(outs[0].probs)
        label_idx = (
            None if not labels
            else torch.zeros((B,), dtype=torch.int64, device=X.device)
        )
        for i, o in enumerate(outs):
            sel = chosen == i
            value = torch.where(sel, o.value, value)
            valid = torch.where(sel, o.valid, valid)
            if labels:
                probs = torch.where(sel[:, None], o.probs, probs)
                label_idx = torch.where(sel, o.label_idx, label_idx)
        return ModelOutput(
            value=value, valid=valid & (chosen >= 0), probs=probs,
            label_idx=label_idx,
        )

    return Lowered(fn=fn, params=params, labels=labels)


def _lower_select_all(
    segments: Tuple[ir.Segment, ...], ctx: LowerCtx
) -> Lowered:
    """Every active segment's value is surfaced: ``probs`` carries
    [values ∥ active-mask] as ``[B, 2S]``; the decode side
    (``CompiledModel._segment_ids``) turns it into the per-segment outputs
    mapping. Scalar ``value`` = first active segment's (oracle parity).
    Regression segments only — a multi-label collection doesn't fit one
    Prediction."""
    for s in segments:
        if s.model.function_name != "regression":
            raise ModelCompilationException(
                "selectAll supports regression segments only"
            )
    lows = _lower_segments(segments, ctx)
    if any(l.labels for l in lows):
        raise ModelCompilationException(
            "selectAll supports regression segments only"
        )
    pred_fns = [
        None
        if isinstance(s.predicate, ir.TruePredicate)
        else lower_predicate(s.predicate, ctx)
        for s in segments
    ]
    params = {f"s{i}": l.params for i, l in enumerate(lows)}

    def fn(p, X, M):
        values = []
        active = []
        for i, l in enumerate(lows):
            o = l.fn(p[f"s{i}"], X, M)
            a = o.valid & _active(pred_fns[i], X, M)
            values.append(torch.where(a, o.value, 0.0))
            active.append(a)
        V = torch.stack(values, dim=1)  # [B, S]
        A = torch.stack(active, dim=1)  # [B, S]
        # argmax over bools is refused: over uint8 it is the first True
        first = torch.argmax(A.to(torch.uint8), dim=1)
        value = torch.gather(V, 1, first[:, None])[:, 0]
        probs = torch.cat([V, A.to(torch.float32)], dim=1)  # [B, 2S]
        return ModelOutput(
            value=value, valid=A.any(dim=1), probs=probs, label_idx=None
        )

    return Lowered(fn=fn, params=params, labels=())


def _lower_aggregate(
    segments: Tuple[ir.Segment, ...], method: str, ctx: LowerCtx
) -> Lowered:
    lows = _lower_segments(segments, ctx)
    pred_fns = [
        None
        if isinstance(s.predicate, ir.TruePredicate)
        else lower_predicate(s.predicate, ctx)
        for s in segments
    ]
    weights = np.asarray([s.weight for s in segments], np.float32)
    params = {f"s{i}": l.params for i, l in enumerate(lows)}

    if method in ("majorityVote", "weightedMajorityVote"):
        if any(not l.is_classification for l in lows):
            raise ModelCompilationException(
                f"{method} requires classification segments"
            )
        global_labels: List[str] = []
        for l in lows:
            for lbl in l.labels:
                if lbl not in global_labels:
                    global_labels.append(lbl)
        maps = [
            np.asarray([global_labels.index(lbl) for lbl in l.labels], np.int64)
            for l in lows
        ]
        C = len(global_labels)

        def vfn(p, X, M):
            B = X.shape[0]
            votes = torch.zeros((B, C), dtype=torch.float32, device=X.device)
            for i, l in enumerate(lows):
                o = l.fn(p[f"s{i}"], X, M)
                active = _active(pred_fns[i], X, M)
                glb = torch.from_numpy(maps[i]).to(X.device)[o.label_idx]
                w = float(weights[i]) if method == "weightedMajorityVote" else 1.0
                onehot = torch.nn.functional.one_hot(glb, C).to(torch.float32)
                # invalid/inactive segments abstain; they do not poison
                votes = votes + torch.where(
                    (active & o.valid)[:, None], onehot * w, 0.0
                )
            total = votes.sum(dim=1, keepdim=True)
            probs = votes / torch.clamp(total, min=1e-30)
            label_idx = torch.argmax(votes, dim=1)
            value = torch.gather(probs, 1, label_idx[:, None])[:, 0]
            valid = total[:, 0] > 0
            return ModelOutput(
                value=value, valid=valid, probs=probs, label_idx=label_idx
            )

        return Lowered(fn=vfn, params=params, labels=tuple(global_labels))

    def afn(p, X, M):
        vals, valids, actives = [], [], []
        for i, l in enumerate(lows):
            o = l.fn(p[f"s{i}"], X, M)
            active = _active(pred_fns[i], X, M)
            vals.append(o.value)
            valids.append(~active | o.valid)
            actives.append(active)
        V = torch.stack(vals, dim=1)  # [B, N]
        A = torch.stack(actives, dim=1)
        ok = torch.stack(valids, dim=1)
        count = A.sum(dim=1)
        all_ok = ok.all(dim=1) & (count > 0)
        Af = A.to(torch.float32)
        if method == "sum":
            value = (V * Af).sum(dim=1)
        elif method == "average":
            value = (V * Af).sum(dim=1) / torch.clamp(count, min=1)
        elif method == "weightedAverage":
            w = torch.from_numpy(weights).to(V.device)
            wsum = Af @ w
            value = (V * Af * w[None, :]).sum(dim=1) / torch.where(
                wsum == 0, 1.0, wsum
            )
            all_ok = all_ok & (wsum != 0)
        elif method == "max":
            value = torch.where(A, V, -torch.inf).max(dim=1).values
        else:  # median over the ACTIVE subset: +inf pads sort last, then
            # index by the active count c (mean of ranks (c−1)//2, c//2)
            Vs = torch.sort(torch.where(A, V, torch.inf), dim=1).values
            c = count.long()
            lo = torch.clamp((c - 1) // 2, min=0)
            hi = torch.clamp(c // 2, min=0)
            vlo = torch.gather(Vs, 1, lo[:, None])[:, 0]
            vhi = torch.gather(Vs, 1, hi[:, None])[:, 0]
            value = 0.5 * (vlo + vhi)
        return ModelOutput(value=value, valid=all_ok)

    return Lowered(fn=afn, params=params)
