"""TextModel → PyTorch: weighted document similarity as one matmul.

The port of ``flink_jpmml_tpu/compile/textmodel.py``. The corpus
DocumentTermMatrix is weighted once at compile time (local × global term
weights + optional cosine normalization, float64 on the host:
``_weight_np`` is the JAX package's numpy code, copied); per batch the
query rows get the same weighting on the device and the similarity
against all documents is a single ``[B, T] @ [T, D]`` ``torch.matmul``
(cosine) or the ‖q−d‖² expansion (euclidean), float32 with TF32 off
(``utils/device.py``), where the JAX package asks for
``Precision.HIGHEST``.

Input contract (ir.TextModelIR): one active field per term carrying the
record's term count; missing cells read as 0, so lanes are always valid.

Deliberate differences: the term columns are a device constant, and
``label_idx`` is int64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import (
    DeviceConst,
    Lowered,
    LowerCtx,
    ModelOutput,
)
from flink_jpmml_tpu_torch.pmml import ir


def _weight_np(rows: np.ndarray, kind: str, idf: np.ndarray,
               doc_norm: str) -> np.ndarray:
    if kind == "binary":
        w = (rows > 0).astype(np.float64)
    elif kind == "logarithmic":
        w = np.log10(1.0 + np.maximum(rows, 0.0))
    elif kind == "augmentedNormalizedTermFrequency":
        m = rows.max(axis=1, keepdims=True)
        w = np.where(
            (rows > 0) & (m > 0), 0.5 + 0.5 * rows / np.maximum(m, 1e-30),
            0.0,
        )
    else:  # termFrequency
        w = np.maximum(rows, 0.0)
    w = w * idf[None, :]
    if doc_norm == "cosine":
        n = np.linalg.norm(w, axis=1, keepdims=True)
        w = np.where(n > 0, w / np.maximum(n, 1e-30), 0.0)
    return w


def lower_text_model(model: ir.TextModelIR, ctx: LowerCtx) -> Lowered:
    cols = DeviceConst([ctx.column(t) for t in model.terms], np.int64)
    dtm = np.asarray(model.dtm, np.float64)
    D, T = dtm.shape
    if model.global_weight == "inverseDocumentFrequency":
        dj = (dtm > 0).sum(axis=0)
        idf = np.where(dj > 0, np.log10(D / np.maximum(dj, 1)), 0.0)
    else:
        idf = np.ones((T,), np.float64)
    W = _weight_np(dtm, model.local_weight, idf, model.doc_normalization)

    params = {
        "W": W.astype(np.float32),  # [D, T] weighted corpus
        "Wsq": (W ** 2).sum(axis=1).astype(np.float32),  # [D]
        "Wnorm": np.linalg.norm(W, axis=1).astype(np.float32),
        "idf": idf.astype(np.float32),
    }
    local = model.local_weight
    doc_norm = model.doc_normalization
    similarity = model.similarity
    log10 = float(math.log(10.0))

    def fn(p, X, M):
        c = cols.on(X.device)
        q = torch.where(M[:, c], 0.0, torch.clamp(X[:, c], min=0.0))
        if local == "binary":
            w = (q > 0).to(torch.float32)
        elif local == "logarithmic":
            w = torch.log(1.0 + q) / log10
        elif local == "augmentedNormalizedTermFrequency":
            m = q.max(dim=1, keepdim=True).values
            w = torch.where(
                (q > 0) & (m > 0),
                0.5 + 0.5 * q / torch.clamp(m, min=1e-30), 0.0,
            )
        else:
            w = q
        w = w * p["idf"][None, :]
        if doc_norm == "cosine":
            n = torch.linalg.vector_norm(w, dim=1, keepdim=True)
            w = torch.where(n > 0, w / torch.clamp(n, min=1e-30), 0.0)
        dots = torch.matmul(w, p["W"].T)  # [B, D]
        if similarity == "cosine":
            qn = torch.linalg.vector_norm(w, dim=1, keepdim=True)
            denom = qn * p["Wnorm"][None, :]
            scores = torch.where(
                denom > 0, dots / torch.clamp(denom, min=1e-30), 0.0
            )
            win = torch.argmax(scores, dim=1)
        else:  # euclidean: ‖q−d‖² = ‖q‖² + ‖d‖² − 2 q·d
            d2 = (
                (w ** 2).sum(dim=1, keepdim=True)
                + p["Wsq"][None, :]
                - 2.0 * dots
            )
            scores = torch.sqrt(torch.clamp(d2, min=0.0))
            win = torch.argmin(scores, dim=1)
        return ModelOutput(
            value=scores.gather(1, win[:, None])[:, 0],
            valid=torch.ones((X.shape[0],), dtype=torch.bool,
                             device=X.device),
            probs=scores,
            label_idx=win,
        )

    return Lowered(fn=fn, params=params, labels=model.doc_ids)
