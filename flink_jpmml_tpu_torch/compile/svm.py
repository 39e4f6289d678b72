"""SupportVectorMachineModel → PyTorch: one kernel matmul + coefficient matmul.

The port of ``flink_jpmml_tpu/compile/svm.py``. The kernel matrix
K(X, SV) ``[B, N]`` is one (or, for RBF, one plus two row norms)
``torch.matmul`` against the ``[N, D]`` support-vector table, and every
machine's decision function contracts through one ``[N, M]`` coefficient
matrix:

    f_m(x) = Σ_i α_{m,i} · K(sv_i, x) + b_m        (K over all N vectors)

Kernels: linear ⟨x,s⟩; polynomial (γ⟨x,s⟩+c₀)^d; radialBasis
exp(−γ‖x−s‖²) through the ``x² − 2⟨x,s⟩ + s²`` expansion; sigmoid
tanh(γ⟨x,s⟩+c₀). The products are float32 with TF32 off
(``utils/device.py``), where the JAX package asks for
``Precision.HIGHEST``.

Decisions, as in the JAX package and its oracle: regression takes the
single machine's f(x); OneAgainstOne machines vote ``targetCategory``
when ``f(x) < threshold`` else ``alternateTargetCategory``, most votes
win and ties break to the first label (the first maximum); OneAgainstAll
takes the smallest decision value. A record missing any vector field is
an invalid lane.

Deliberate differences: the vote one-hots are built once on the host in
numpy (the JAX package scatters them with ``.at[].set`` on every call)
and kept on the device beside the column indices, thresholds and label
maps (``common.DeviceConst``); ``label_idx`` is int64.
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


def kernel_fn(kernel: ir.SvmKernel):
    """→ f(X [B,D], S [N,D]) -> [B,N]."""
    kind = kernel.kind
    g = float(kernel.gamma)
    c0 = float(kernel.coef0)
    d = float(kernel.degree)

    def lin(X, S):
        return torch.matmul(X, S.T)

    if kind == "linear":
        return lin
    if kind == "polynomial":
        return lambda X, S: torch.pow(g * lin(X, S) + c0, d)
    if kind == "sigmoid":
        return lambda X, S: torch.tanh(g * lin(X, S) + c0)
    if kind == "radialBasis":
        def rbf(X, S):
            x2 = (X * X).sum(dim=1, keepdim=True)
            s2 = (S * S).sum(dim=1)[None, :]
            return torch.exp(-g * (x2 - 2.0 * lin(X, S) + s2))
        return rbf
    raise ModelCompilationException(f"unsupported SVM kernel {kind!r}")


def _onehot(idx: np.ndarray, L: int) -> np.ndarray:
    out = np.zeros((idx.shape[0], L), np.float32)
    out[np.arange(idx.shape[0]), idx] = 1.0
    return out


def lower_svm(model: ir.SvmModelIR, ctx: LowerCtx) -> Lowered:
    cols_np = np.asarray([ctx.column(f) for f in model.vector_fields], np.int64)
    vid_index = {vid: i for i, (vid, _) in enumerate(model.vectors)}
    S = np.asarray([c for _, c in model.vectors], np.float32)  # [N, D]
    N = S.shape[0]
    M = len(model.machines)
    A = np.zeros((N, M), np.float32)
    b = np.zeros((M,), np.float32)
    thr = np.full((M,), float(model.threshold), np.float32)
    for mi, m in enumerate(model.machines):
        b[mi] = m.intercept
        if m.threshold is not None:
            thr[mi] = m.threshold
        for vid, alpha in zip(m.vector_ids, m.coefficients):
            if vid not in vid_index:
                raise ModelCompilationException(
                    f"SupportVector references unknown vectorId {vid!r}"
                )
            A[vid_index[vid], mi] += alpha

    kfn = kernel_fn(model.kernel)
    classification = model.function_name == "classification"
    one_v_one = False
    if classification:
        labels: list = []
        for m in model.machines:
            for cat in (m.target_category, m.alternate_target_category):
                if cat is not None and cat not in labels:
                    labels.append(cat)
        if not labels:
            raise ModelCompilationException(
                "classification SVM machines declare no target categories"
            )
        one_v_one = model.classification_method == "OneAgainstOne"
        tgt = np.zeros((M,), np.int64)
        alt = np.zeros((M,), np.int64)
        for mi, m in enumerate(model.machines):
            if one_v_one and (
                m.target_category is None
                or m.alternate_target_category is None
            ):
                raise ModelCompilationException(
                    "OneAgainstOne machines need targetCategory and "
                    "alternateTargetCategory"
                )
            if not one_v_one and m.target_category is None:
                raise ModelCompilationException(
                    "OneAgainstAll machines need targetCategory"
                )
            tgt[mi] = labels.index(m.target_category)
            if one_v_one:
                alt[mi] = labels.index(m.alternate_target_category)
        onehot_t = DeviceConst(_onehot(tgt, len(labels)))
        onehot_a = DeviceConst(_onehot(alt, len(labels)))
    else:
        labels = []
        if M != 1:
            raise ModelCompilationException(
                f"regression SVM needs exactly one machine, got {M}"
            )

    params = {"S": S, "A": A, "b": b}
    cols = DeviceConst(cols_np)
    thr_c = DeviceConst(thr)
    big = float(np.finfo(np.float32).max)

    def fn(p, X, M_):
        dev = X.device
        c = cols.on(dev)
        missing = M_[:, c].any(dim=1)
        K = kfn(X[:, c], p["S"])  # [B, N]
        f = torch.matmul(K, p["A"]) + p["b"][None, :]  # [B, M]
        if not classification:
            return ModelOutput(value=f[:, 0], valid=~missing)
        if one_v_one:
            votes_t = (f < thr_c.on(dev)[None, :]).to(torch.float32)
            counts = torch.matmul(votes_t, onehot_t.on(dev)) + torch.matmul(
                1.0 - votes_t, onehot_a.on(dev)
            )  # [B, L]
            lab = torch.argmax(counts, dim=1)
            probs = counts / torch.clamp(
                counts.sum(dim=1, keepdim=True), min=1.0
            )
            value = probs.gather(1, lab[:, None])[:, 0]
        else:
            # OneAgainstAll: smallest decision value wins
            scores = torch.where(
                onehot_t.on(dev)[None] > 0.5, f[:, :, None], big
            ).min(dim=1).values  # [B, L]
            lab = torch.argmin(scores, dim=1)
            probs = None
            value = scores.gather(1, lab[:, None])[:, 0]
        return ModelOutput(
            value=value, valid=~missing, probs=probs, label_idx=lab
        )

    return Lowered(fn=fn, params=params, labels=tuple(labels))
