"""NearestNeighborModel → PyTorch: distance matrix + stable k-smallest.

The port of ``flink_jpmml_tpu/compile/knn.py``. The distance machinery is
the clustering module's (same compareFunctions, same spec weighting) over
the inline training table; the k nearest rows vote (classification:
majorityVote / weightedMajorityVote with 1/d weights) or average
(regression: average / median / weightedAverage). Weighted variants use
1/(d+ε) with ε=1e-9 against zero distances. A record missing any KNN
input is an invalid lane.

Ties, as in the JAX package and its oracle: ``lax.top_k`` prefers the
earlier training row on equal distances. ``torch.topk`` promises no order
among equal values on CUDA, so the neighbours are the first k of a
*stable* sort of each distance row (ascending; descending for a
similarity), which provably keeps the lower row. Vote ties break to the
first label (the first maximum).

Deliberate differences:

- The median of an even k averages the two middle values, as
  ``jnp.median`` does (``torch.median`` would return the lower one).
- The ``[B, N, D]`` distance cube is built for at most ``CUBE_ELEMS``
  elements at a time: the batch rows are taken in chunks inside the
  lowered function, so the card's peak stays bounded where XLA fuses the
  cube into its reduction. The element arithmetic is unchanged (no
  ``‖x‖² + ‖s‖² − 2xs`` rewrite, which would move near-ties), and the
  fields' terms are summed left to right (``make_distance(ordered=True)``),
  so the card and the CPU round every distance alike and rank the same
  neighbours.
- ``label_idx`` is int64; the ranked neighbour indices are appended to
  ``probs`` as float32, as in the JAX package, and decoded through the
  document's instance ids by ``CompiledModel`` (top-level models only).
"""

from __future__ import annotations

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.clustering import (
    make_distance,
    make_similarity,
    resolve_compare_fields,
)
from flink_jpmml_tpu_torch.compile.common import (
    DeviceConst,
    Lowered,
    LowerCtx,
    ModelOutput,
)
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

_EPS = 1e-9
# elements of the [rows, N, D] distance cube built at once (512 MiB of
# f32; eager torch holds about four such temporaries at its peak)
CUBE_ELEMS = 1 << 27


def chunk_rows(n_ref: int, width: int) -> int:
    """Batch rows whose ``[rows, n_ref, width]`` cube fits CUBE_ELEMS."""
    return max(1, CUBE_ELEMS // max(1, n_ref * width))


def lower_knn(model: ir.NearestNeighborIR, ctx: LowerCtx) -> Lowered:
    similarity = model.measure.kind == "similarity"
    cols = DeviceConst([ctx.column(i.field) for i in model.inputs], np.int64)
    weights = np.asarray([i.weight for i in model.inputs], np.float32)
    if similarity:
        # binary-similarity neighbours: the k LARGEST similarities win;
        # "weighted" variants weight by the similarity itself
        dist = make_similarity(model.measure, weights)
    else:
        cmp_codes, gauss_s = resolve_compare_fields(
            model.inputs, model.measure
        )
        dist = make_distance(model.measure, cmp_codes, gauss_s, weights,
                             ordered=True)
    S = np.asarray(model.instances, np.float32)  # [N, D]
    k = model.n_neighbors
    classification = model.function_name == "classification"

    if classification:
        if model.categorical_scoring not in (
            "majorityVote", "weightedMajorityVote",
        ):
            raise ModelCompilationException(
                f"unsupported categoricalScoringMethod "
                f"{model.categorical_scoring!r}"
            )
        labels: list = []
        for t in model.targets:
            if t not in labels:
                labels.append(t)
        lab_of = np.asarray(
            [labels.index(t) for t in model.targets], np.int32
        )
        weighted = model.categorical_scoring == "weightedMajorityVote"
    else:
        if model.continuous_scoring not in (
            "average", "median", "weightedAverage",
        ):
            raise ModelCompilationException(
                f"unsupported continuousScoringMethod "
                f"{model.continuous_scoring!r}"
            )
        labels = []
        try:
            yvals = np.asarray([float(t) for t in model.targets], np.float32)
        except ValueError:
            raise ModelCompilationException(
                "regression KNN needs numeric training targets"
            ) from None

    L = len(labels)
    # neighbour-index columns only surface for a TOP-LEVEL model: inside
    # MiningModel segments they would skew the ensemble's probs shapes
    surface_ids = bool(model.instance_ids) and not ctx.nested
    params = {"S": S}
    if classification:
        params["lab"] = lab_of.astype(np.float32)
    else:
        params["y"] = yvals
    rows = chunk_rows(*S.shape)

    def nearest(xs, ref):
        """→ (the k best scores [B, k], their training rows [B, k]),
        best first; equal scores keep the lower row."""
        parts = []
        for i in range(0, max(xs.shape[0], 1), rows):
            d = dist(xs[i:i + rows], ref)  # [rows, N]
            s, idx = torch.sort(d, dim=1, descending=similarity, stable=True)
            parts.append((s[:, :k], idx[:, :k]))
        if len(parts) == 1:
            return parts[0]
        return (torch.cat([s for s, _ in parts]),
                torch.cat([i for _, i in parts]))

    def fn(p, X, M):
        c = cols.on(X.device)
        missing = M[:, c].any(dim=1)
        dk, idx = nearest(X[:, c], p["S"])  # [B, k]
        ids = idx.to(torch.float32) if surface_ids else None
        if classification:
            labk = p["lab"][idx].to(torch.int64)  # [B, k]
            if not weighted:
                w = torch.ones_like(dk)
            elif similarity:
                w = dk
            else:
                w = 1.0 / (dk + _EPS)
            onehot = (
                labk[..., None]
                == torch.arange(L, device=X.device)[None, None, :]
            ).to(torch.float32)
            votes = (onehot * w[..., None]).sum(dim=1)  # [B, L]
            lab = torch.argmax(votes, dim=1)
            probs = votes / torch.clamp(
                votes.sum(dim=1, keepdim=True), min=_EPS
            )
            value = probs.gather(1, lab[:, None])[:, 0]
            if surface_ids:
                # the ranked neighbour indices, decoded through the
                # instance ids for rank-k entityId outputs
                probs = torch.cat([probs, ids], dim=1)  # [B, L + k]
            return ModelOutput(
                value=value, valid=~missing, probs=probs, label_idx=lab
            )
        yk = p["y"][idx]  # [B, k]
        valid = ~missing
        if model.continuous_scoring == "average":
            value = yk.mean(dim=1)
        elif model.continuous_scoring == "median":
            ys = torch.sort(yk, dim=1).values
            value = (
                ys[:, k // 2] if k % 2
                else (ys[:, k // 2 - 1] + ys[:, k // 2]) * 0.5
            )
        else:  # weightedAverage
            w = dk if similarity else 1.0 / (dk + _EPS)
            tw = w.sum(dim=1)
            value = (yk * w).sum(dim=1) / torch.clamp(tw, min=_EPS)
            if similarity:
                # all-zero similarity weights: an undefined average
                valid = valid & (tw > 0)
        return ModelOutput(value=value, valid=valid, probs=ids)

    return Lowered(fn=fn, params=params, labels=tuple(labels))
