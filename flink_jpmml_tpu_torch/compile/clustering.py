"""ClusteringModel → PyTorch: batched distance matrix + argmin.

The port of ``flink_jpmml_tpu/compile/clustering.py`` (BASELINE config 4,
``kmeans``). Per record, the comparison measure against every cluster
center; the whole batch's distance matrix is one broadcast reduction, and
``probs`` carries the per-cluster distances (or similarities). A binary
similarity is four masked ``torch.matmul`` products (float32, TF32 off:
``utils/device.py``), where the JAX package asks for ``Precision.HIGHEST``
so the contingency counts stay exact.

``resolve_compare_fields`` and ``similarity_params`` are the JAX package's
numpy code, copied. Deliberate differences: ``label_idx`` is int64; the
per-field weights and compare codes are device constants beside the
function (``common.DeviceConst``), as the JAX package closes over them.
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


# per-field comparison codes (spec: compareFunction on ComparisonMeasure,
# overridable per ClusteringField)
_CMP_CODES = {"absDiff": 0, "gaussSim": 1, "delta": 2, "equal": 3}


def resolve_compare_fields(fields, measure: ir.ComparisonMeasure):
    """→ (codes i32[D], gauss_s f32[D]) for any per-field sequence with
    ``field``/``compare_function``/``similarity_scale`` attributes
    (ClusteringField, KNNInput)."""
    D = len(fields)
    codes = np.zeros((D,), np.int32)
    scale = np.ones((D,), np.float32)
    for i, cf in enumerate(fields):
        name = cf.compare_function or measure.compare_function
        code = _CMP_CODES.get(name)
        if code is None:
            raise ModelCompilationException(
                f"unsupported compareFunction {name!r} on field "
                f"{cf.field!r} (supported: {', '.join(_CMP_CODES)})"
            )
        codes[i] = code
        if name == "gaussSim":
            if cf.similarity_scale is None or cf.similarity_scale <= 0:
                raise ModelCompilationException(
                    f"gaussSim on field {cf.field!r} needs a positive "
                    "similarityScale"
                )
            scale[i] = cf.similarity_scale
    return codes, scale


def resolve_compare(model: ir.ClusteringModelIR):
    return resolve_compare_fields(model.clustering_fields, model.measure)


def make_distance(
    measure: ir.ComparisonMeasure,
    cmp_codes: np.ndarray,
    gauss_s: np.ndarray,
    weights: np.ndarray,
    mv_q=None,
    ordered: bool = False,
):
    """→ f(xs [B,D], centers [K,D][, miss [B,D]]) -> distances [B,K]
    under the spec aggregation (the field weight multiplies the powered
    comparison). With ``mv_q`` (MissingValueWeights) and a ``miss`` mask,
    missing fields' terms drop out and sum-based metrics rescale by
    Σq / Σ_nonmissing q (chebychev is a max, not a sum — no rescale).
    ``ordered`` sums the fields' terms left to right, one elementwise add
    each, so every device rounds alike (a reduction kernel's order is its
    own): the nearest-neighbour ranking then agrees across devices."""
    metric = measure.metric
    mink_p = float(measure.minkowski_p)
    if metric == "minkowski" and mink_p <= 0:
        raise ModelCompilationException(
            f"minkowski needs a positive p-parameter, got {mink_p}"
        )
    if metric not in ("squaredEuclidean", "euclidean", "cityBlock",
                      "chebychev", "minkowski"):
        raise ModelCompilationException(f"unsupported metric {metric!r}")
    all_absdiff = bool((cmp_codes == 0).all())
    ln2 = float(np.log(2.0))
    q_total = float(np.sum(mv_q)) if mv_q is not None else 0.0
    codes = DeviceConst(cmp_codes)
    gs2 = DeviceConst(gauss_s * gauss_s)
    w_c = DeviceConst(weights)
    q_c = DeviceConst(mv_q) if mv_q is not None else None

    def dist(xs, centers, miss=None):
        dev = xs.device
        delta = xs[:, None, :] - centers[None, :, :]  # [B, K, D]
        if all_absdiff:
            c = torch.abs(delta)
        else:
            cc = codes.on(dev)
            ad = torch.abs(delta)
            eq = delta == 0.0
            gs = torch.exp(-ln2 * delta * delta / gs2.on(dev))
            c = torch.where(
                cc == 1, gs,
                torch.where(
                    cc == 2, torch.where(eq, 0.0, 1.0),
                    torch.where(cc == 3, torch.where(eq, 1.0, 0.0), ad),
                ),
            )
        w = w_c.on(dev)
        adjust = None
        if miss is not None:
            keep = (~miss).to(torch.float32)  # [B, D]
            c = c * keep[:, None, :]  # dropped terms contribute 0
            q_nonmiss = (keep * q_c.on(dev)[None, :]).sum(dim=-1)  # [B]
            adjust = (q_total / torch.clamp(q_nonmiss, min=1e-30))[:, None]

        def scaled(s):
            return s if adjust is None else s * adjust

        def total(t):
            if not ordered:
                return t.sum(dim=-1)
            acc = t[..., 0]
            for j in range(1, t.shape[-1]):
                acc = acc + t[..., j]
            return acc

        if metric == "squaredEuclidean":
            return scaled(total(w * c * c))
        if metric == "euclidean":
            return torch.sqrt(scaled(total(w * c * c)))
        if metric == "cityBlock":
            return scaled(total(w * c))
        if metric == "chebychev":
            return (w * c).max(dim=-1).values
        return torch.pow(  # minkowski
            scaled(total(w * torch.pow(torch.abs(c), mink_p))),
            1.0 / mink_p,
        )

    return dist


def similarity_params(measure: ir.ComparisonMeasure):
    """Binary-similarity (numerator, denominator) weights over the
    per-pair contingency counts (a = 1∧1, b = 1∧0, c = 0∧1, d = 0∧0):

        simpleMatching (a+d)/(a+b+c+d)   jaccard a/(a+b+c)
        tanimoto (a+d)/(a+2(b+c)+d)      binarySimilarity per c/d params
    """
    m = measure.metric
    if m == "simpleMatching":
        return (1, 0, 0, 1), (1, 1, 1, 1)
    if m == "jaccard":
        return (1, 0, 0, 0), (1, 1, 1, 0)
    if m == "tanimoto":
        return (1, 0, 0, 1), (1, 2, 2, 1)
    if m == "binarySimilarity":
        if len(measure.binary_params) != 8:
            raise ModelCompilationException(
                "binarySimilarity needs its eight c/d parameters"
            )
        c00, c01, c10, c11, d00, d01, d10, d11 = measure.binary_params
        # contingency order here is (a=11, b=10, c=01, d=00)
        return (c11, c10, c01, c00), (d11, d10, d01, d00)
    raise ModelCompilationException(
        f"unsupported similarity metric {m!r}"
    )


def make_similarity(measure: ir.ComparisonMeasure, weights: np.ndarray):
    """→ f(xs [B,D], refs [K,D]) -> similarities [B,K]. Fields are
    binary (value > 0.5 ⇔ set); field weights scale each pair's
    contribution to every count. Four masked matmuls."""
    num, den = similarity_params(measure)
    w_c = DeviceConst(weights)

    def sim(xs, refs):
        w = w_c.on(xs.device)[None, :]
        x = (xs > 0.5).to(torch.float32) * w
        xc = (xs <= 0.5).to(torch.float32) * w
        z = (refs > 0.5).to(torch.float32)
        zc = (refs <= 0.5).to(torch.float32)
        a = torch.matmul(x, z.T)  # both set
        b = torch.matmul(x, zc.T)  # record only
        c = torch.matmul(xc, z.T)  # reference only
        d = torch.matmul(xc, zc.T)  # neither
        numer = num[0] * a + num[1] * b + num[2] * c + num[3] * d
        denom = den[0] * a + den[1] * b + den[2] * c + den[3] * d
        return torch.where(
            denom > 0, numer / torch.clamp(denom, min=1e-30), 0.0
        )

    return sim


def lower_clustering(model: ir.ClusteringModelIR, ctx: LowerCtx) -> Lowered:
    if model.model_class != "centerBased":
        raise ModelCompilationException(
            f"unsupported ClusteringModel class {model.model_class!r}"
        )
    similarity = model.measure.kind == "similarity"
    # compare functions only shape the DISTANCE path; resolving them for
    # a similarity measure could spuriously reject models the reference
    # accepts
    cmp_codes = gauss_s = None
    if not similarity:
        cmp_codes, gauss_s = resolve_compare(model)
    cols = DeviceConst(
        [ctx.column(cf.field) for cf in model.clustering_fields], np.int64
    )
    centers = np.asarray([c.center for c in model.clusters], np.float32)  # [K,D]
    if centers.shape[1] != cols.array.size:
        raise ModelCompilationException(
            f"cluster center arity {centers.shape[1]} != clustering fields "
            f"{cols.array.size}"
        )
    weights = np.asarray(
        [cf.weight for cf in model.clustering_fields], np.float32
    )
    labels = tuple(
        c.cluster_id or c.name or str(i + 1) for i, c in enumerate(model.clusters)
    )
    params = {"centers": centers}
    mv_q = (
        np.asarray(model.missing_value_weights, np.float32)
        if model.missing_value_weights and not similarity
        else None
    )
    q_c = DeviceConst(mv_q) if mv_q is not None else None
    score = (
        make_similarity(model.measure, weights)
        if similarity
        else make_distance(
            model.measure, cmp_codes, gauss_s, weights, mv_q=mv_q
        )
    )

    def fn(p, X, M):
        c = cols.on(X.device)
        xs = X[:, c]  # [B, D]
        miss = M[:, c]
        if mv_q is not None:
            # opted-in adjustment: a lane is invalid only when NO
            # weighted evidence remains (all missing, or every
            # non-missing field carries weight 0)
            d = score(xs, p["centers"], miss)
            qn = ((~miss).to(torch.float32) * q_c.on(X.device)[None, :]).sum(dim=1)
            valid = qn > 0
        else:
            d = score(xs, p["centers"])
            valid = ~miss.any(dim=1)
        label_idx = (torch.argmax if similarity else torch.argmin)(d, dim=1)
        return ModelOutput(
            value=label_idx.to(torch.float32),
            valid=valid,
            probs=d,  # per-cluster distances/similarities
            label_idx=label_idx,
        )

    return Lowered(fn=fn, params=params, labels=labels)
