"""Carry a model's parameters across from the JAX package.

``model_params_from_jax`` takes ``np.asarray`` of every leaf of the JAX
package's ``compile_pmml(doc).params`` — the f32 dense path's parameter
tree: ``t{i}`` tables of a RegressionModel, ``l{i}`` layers of a
NeuralNetwork, ``centers`` of a ClusteringModel, ``beta`` (and the Cox
baseline) of a GeneralRegressionModel, the packed tree tables (path
matrices; the node-hop tables, whose ``col`` / ``left`` / ``right`` are
int32; the general scan's ``[T, N, C, K(, KS)]`` and root tables), the
weighted walk's ``payload`` / ``leaf_label``, the scorecard's and the
ruleset's predicate tables, the tables of the last nine families
(NaiveBayes ``prior`` / ``cat{i}_*`` / ``g{i}_*``; SVM ``S`` / ``A`` /
``b``; KNN ``S`` with ``lab`` (f32 label indices) or ``y``; the
BayesianNetwork's CPT match tables; GaussianProcess ``alpha`` (the host
float64 solve, cast to f32) with ``Zs`` / ``Zs_sq`` or ``Ztr``; Baseline
``mean`` / ``inv_sd``; Association ``A`` / ``Cq`` / ``conf`` and the int32
``order``; TextModel ``W`` / ``Wsq`` / ``Wnorm`` / ``idf``; TimeSeries
``path`` or the smoothing state), and the ``s{i}`` segments of a
MiningModel (selectFirst, selectAll and AnomalyDetection's inner model
included), nested as deep as the document — and returns the same tree of tensors on
the requested device: the port's ``CompiledModel.params["model"]`` for the
same document. Keys, shapes and dtypes carry over unchanged (a bf16 leaf,
which the JAX package keeps only on a TPU, widens to f32 exactly); the
port widens int32 indices to int64 where it gathers, not in the tree.

``quantized_params_from_jax`` takes the JAX scorer's packed tables as
numpy arrays — the XLA-backend params ``feat``, ``qthr``, ``dleft``,
``P_i8``, ``count_i8``, then ``vhi`` / ``vlo`` for a regression forest or
``phi`` / ``plo`` / ``lab`` for a classification forest, and the wire's
``cuts`` / ``repl`` / ``has_repl`` — and returns the port's tables on the
requested device: the same keys as ``QuantizedScorer.params`` of a scorer
the port builds from the same PMML, plus the wire as ``cuts`` (f32[F, K],
+inf padded), ``n_cuts`` (i64[F]), ``repl`` and ``has_repl``.

The Hopper kernel's tables (``qtrees_cuda.TABLE_KEYS``, packed from
``vhi`` / ``vlo`` or from ``phi`` / ``plo``) come along when the shapes fit
the kernel (uint8 wire, S ≤ 64, F ≤ 256, C ≤ ``MAX_CLASSES``).
The tables do not carry the aggregate, so whether a scorer takes the
kernel also depends on it: the port's own scorer packs them only for a
linear regression aggregate or a majorityVote / weightedMajorityVote
forest.

It imports nothing of the JAX package: the caller hands over numpy
arrays (``np.asarray`` of the JAX arrays; bf16 arrives as ml_dtypes'
bfloat16, whose bits are reinterpreted, not rounded again).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile import qtrees_cuda
from flink_jpmml_tpu_torch.utils.device import resolve_device


def _bf16(a) -> torch.Tensor:
    """A numpy bf16 array (ml_dtypes) or f32 array → torch.bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(a, copy=True).view(np.int16)
        ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def model_params_from_jax(np_params, device=None):
    """``np.asarray`` of each leaf of JAX ``compile_pmml(doc).params`` →
    the port's ``params["model"]`` for the same document, on ``device``
    (default: the CUDA card)."""
    dev = resolve_device(device)

    def carry(tree):
        if isinstance(tree, dict):
            return {k: carry(v) for k, v in tree.items()}
        a = np.array(tree, copy=True)  # JAX buffers view read-only
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(a).to(dev)

    return carry(np_params)


def quantized_params_from_jax(
    np_params: Dict[str, Union[np.ndarray, Sequence[np.ndarray]]],
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    # np.array copies: arrays viewed from JAX buffers are read-only
    feat = np.array(np_params["feat"], np.int64)
    qthr = np.array(np_params["qthr"])
    dleft = np.array(np_params["dleft"], bool)
    P = np.array(np_params["P_i8"], np.int8)
    count = np.array(np_params["count_i8"], np.int8)
    out: Dict[str, torch.Tensor] = {
        "feat": torch.from_numpy(feat),
        "qthr": torch.from_numpy(qthr.astype(np.int64)),
        "dleft": torch.from_numpy(dleft),
        "P_i8": torch.from_numpy(P),
        "count_i8": torch.from_numpy(count),
    }
    classification = "phi" in np_params
    if classification:
        out["phi"] = _bf16(np_params["phi"])
        out["plo"] = _bf16(np_params["plo"])
        out["lab"] = torch.from_numpy(np.array(np_params["lab"], np.float32))
    else:
        out["vhi"] = _bf16(np_params["vhi"])
        out["vlo"] = _bf16(np_params["vlo"])
    cuts = [np.asarray(c, np.float32) for c in np_params["cuts"]]
    F = len(cuts)
    width = max((len(c) for c in cuts), default=0)
    padded = np.full((F, max(width, 1)), np.inf, np.float32)
    for j, c in enumerate(cuts):
        padded[j, : len(c)] = c
    out["cuts"] = torch.from_numpy(padded)
    out["n_cuts"] = torch.tensor([len(c) for c in cuts], dtype=torch.int64)
    out["repl"] = torch.from_numpy(np.array(np_params["repl"], np.float32))
    out["has_repl"] = torch.from_numpy(np.array(np_params["has_repl"], bool))
    hi, lo = ("phi", "plo") if classification else ("vhi", "vlo")
    if (
        qthr.dtype == np.uint8
        and feat.shape[1] <= qtrees_cuda.MAX_SPLITS
        and 0 < F <= qtrees_cuda.MAX_FIELDS
        and (not classification
             or out["phi"].shape[2] <= qtrees_cuda.MAX_CLASSES)
    ):
        tables = qtrees_cuda.pack_tables(
            feat, qthr, dleft, P, count, out[hi], out[lo], n_fields=F
        )
        out.update({k: torch.from_numpy(v) for k, v in tables.items()})
    return {k: v.to(dev) for k, v in out.items()}
