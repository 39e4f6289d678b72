"""GaussianProcessModel → PyTorch: precomputed GP weights + kernel matmul.

The port of ``flink_jpmml_tpu/compile/gp.py``. GP regression over stored
training data:

    μ(x) = k(x, X)ᵀ (K + σ²I)⁻¹ y

The regularized solve runs once at compile time on the host (float64,
numpy: ``_kernel_matrix_np`` and ``gp_prescale`` are the JAX package's
code, copied). The hot path is a kernel-row evaluation plus one matvec
against the precomputed α. For the squared-exponential family the row is
``torch.matmul`` products over the ‖x−z‖² expansion x² + z² − 2xz with
its ``max(d², 0)`` guard (float32, TF32 off: ``utils/device.py``, where
the JAX package asks for ``Precision.HIGHEST``); the absolute and
generalized exponential kernels build the ``[B, N, D]`` cube.

Kernels (PMML 4.3 element → math):
- RadialBasisKernel:            k = γ·exp(−‖x−z‖² / (2λ²))
- ARDSquaredExponentialKernel:  k = γ·exp(−½ Σ ((xᵢ−zᵢ)/λᵢ)²)
- AbsoluteExponentialKernel:    k = γ·exp(−Σ |xᵢ−zᵢ|/λᵢ)
- GeneralizedExponentialKernel: k = γ·exp(−Σ (|xᵢ−zᵢ|/λᵢ)^degree)

A record missing any kernel input scores as an empty lane.

Deliberate differences: the cube is built for at most
``knn.CUBE_ELEMS`` elements at a time (batch rows in chunks inside the
lowered function), so the card's peak stays bounded where XLA fuses it
into its reduction; the column indices are device constants.

On a mesh with a model axis (``parallel/sharding.mesh_sharded``) at least
the wide threshold's training rows are held as ``common.TpLeaf`` split
alike with α: each slice's kernel row contracts with its slice of α, and
the partials add in slice order.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import (
    DeviceConst,
    Lowered,
    LowerCtx,
    ModelOutput,
    TpLeaf,
)
from flink_jpmml_tpu_torch.compile.knn import chunk_rows
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException


def _kernel_matrix_np(
    kernel: ir.GpKernel, A: np.ndarray, B: np.ndarray
) -> np.ndarray:
    """Dense k(A, B) in float64 for the compile-time solve."""
    lam = np.asarray(kernel.lambdas, np.float64)
    if lam.shape[0] == 1:
        lam = np.full((A.shape[1],), lam[0])
    diff = A[:, None, :] - B[None, :, :]
    if kernel.kind == "radialBasis":
        s = (diff ** 2).sum(-1) / (2.0 * kernel.lambdas[0] ** 2)
    elif kernel.kind == "ARDSquaredExponential":
        s = 0.5 * ((diff / lam) ** 2).sum(-1)
    elif kernel.kind == "absoluteExponential":
        s = (np.abs(diff) / lam).sum(-1)
    elif kernel.kind == "generalizedExponential":
        s = ((np.abs(diff) / lam) ** kernel.degree).sum(-1)
    else:
        raise ModelCompilationException(
            f"unsupported GP kernel {kernel.kind!r}"
        )
    return kernel.gamma * np.exp(-s)


def gp_prescale(model: ir.GaussianProcessIR):
    """Compile-time GP state:
    → (alpha f64[N], lam f32[D], Zs f32[N,D], Zs_sq f32[N], sq_family).
    The regularized solve runs in float64 with the typed singular-matrix
    rejection."""
    Xtr = np.asarray(model.instances, np.float64)
    y = np.asarray(model.targets, np.float64)
    N, D = Xtr.shape
    K = _kernel_matrix_np(model.kernel, Xtr, Xtr)
    reg = K + model.kernel.noise_variance * np.eye(N)
    try:
        alpha = np.linalg.solve(reg, y)
    except np.linalg.LinAlgError:
        raise ModelCompilationException(
            "GP kernel matrix K + noiseVariance*I is singular; increase "
            "noiseVariance or deduplicate training instances"
        ) from None
    lam = np.asarray(model.kernel.lambdas, np.float32)
    if lam.shape[0] == 1:
        lam = np.full((D,), lam[0], np.float32)
    sq_family = model.kernel.kind in (
        "radialBasis", "ARDSquaredExponential"
    )
    Zs = Zs_sq = None
    if sq_family:
        Zs = (Xtr / lam.astype(np.float64)).astype(np.float32)
        Zs_sq = (Zs ** 2).sum(-1).astype(np.float32)
    return alpha, lam, Zs, Zs_sq, sq_family


def lower_gp(model: ir.GaussianProcessIR, ctx: LowerCtx) -> Lowered:
    if model.function_name != "regression":
        raise ModelCompilationException(
            "GaussianProcessModel supports functionName=regression only"
        )
    cols = DeviceConst([ctx.column(f) for f in model.inputs], np.int64)
    kern = model.kernel
    alpha, lam, Zs, Zs_sq, sq_family = gp_prescale(model)

    params = {
        "alpha": alpha.astype(np.float32),
        "inv_lam": (1.0 / lam).astype(np.float32),
    }
    if sq_family:
        # pre-scaled training rows: d² = ‖xs‖² + ‖zs‖² − 2·xs·zsᵀ
        params["Zs"] = Zs
        params["Zs_sq"] = Zs_sq
    else:
        params["Ztr"] = np.asarray(model.instances, np.float32)

    gamma = float(kern.gamma)
    degree = float(kern.degree)
    generalized = kern.kind == "generalizedExponential"
    rows = chunk_rows(*np.shape(model.instances))

    def cube_kernel(Xi, Z, inv_lam):
        """γ·exp(−Σ (|x−z|/λ)^(1|degree)) over [rows, N, D] chunks."""
        parts = []
        for i in range(0, max(Xi.shape[0], 1), rows):
            diff = torch.abs(
                Xi[i:i + rows, None, :] - Z[None, :, :]
            ) * inv_lam[None, None, :]
            if generalized:
                diff = diff ** degree
            parts.append(gamma * torch.exp(-diff.sum(dim=-1)))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def sq_kernel(xs, Zs, Zs_sq):
        """γ·exp(−½ max(‖xs‖² + ‖zs‖² − 2·xs·zsᵀ, 0)) → [B, N]."""
        d2 = (
            (xs ** 2).sum(dim=1, keepdim=True)
            + Zs_sq[None, :]
            - 2.0 * torch.matmul(xs, Zs.T)
        )
        d2 = torch.clamp(d2, min=0.0)  # catastrophic-cancellation guard
        return gamma * torch.exp(-0.5 * d2)

    def fn(p, X, M):
        c = cols.on(X.device)
        Xi = X[:, c]  # [B, D]
        valid = ~M[:, c].any(dim=1)
        alpha = p["alpha"]
        if isinstance(alpha, TpLeaf):
            # training rows split alike with α: one partial a slice
            if sq_family:
                xs = Xi * p["inv_lam"][None, :]
                value = p["Zs"].partial_sum(
                    lambda lo, hi, z, zsq, a: torch.matmul(
                        sq_kernel(xs.to(z.device), z, zsq), a[:, None]),
                    X.device, p["Zs_sq"], alpha)
            else:
                value = p["Ztr"].partial_sum(
                    lambda lo, hi, z, a: torch.matmul(
                        cube_kernel(Xi.to(z.device), z,
                                    p["inv_lam"].to(z.device)), a[:, None]),
                    X.device, alpha)
            return ModelOutput(value=value[:, 0], valid=valid)
        if sq_family:
            xs = Xi * p["inv_lam"][None, :]
            k_star = sq_kernel(xs, p["Zs"], p["Zs_sq"])
        else:
            k_star = cube_kernel(Xi, p["Ztr"], p["inv_lam"])
        value = torch.matmul(k_star, alpha[:, None])[:, 0]
        return ModelOutput(value=value, valid=valid)

    return Lowered(fn=fn, params=params)
