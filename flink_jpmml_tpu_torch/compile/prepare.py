"""Host-side input preparation: records/vectors → (X, M) batches.

A copy of ``flink_jpmml_tpu/compile/prepare.py``, kept so that the PyTorch port imports
nothing of the JAX package; the two must parse and prepare alike
(tests/test_torch_frontend.py).

Reference parity (capability C4, SURVEY.md §3 row B2 ``VectorConverter``
[UNVERIFIED]): FlinkML ``DenseVector``s zip positionally with the model's
active fields; ``SparseVector`` gaps become missing values; arity is
validated against the mining schema; ``replaceNan`` optionally substitutes a
default for NaNs *before* missing-value handling.

All of this runs on the host once per micro-batch (cheap, NumPy-vectorized),
so the device graph stays purely numeric.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from flink_jpmml_tpu_torch.utils.exceptions import InputValidationException

Value = Union[float, str, None]


@dataclass(frozen=True)
class FieldSpace:
    """The compiled model's input contract: ordered fields + codecs."""

    fields: Tuple[str, ...]
    codecs: Mapping[str, Mapping[str, float]]

    @property
    def arity(self) -> int:
        return len(self.fields)

    def encode_cell(self, field: str, v: Value) -> float:
        """One raw value → float code; NaN encodes 'missing', +inf marks
        an *invalid* (undeclared) category — the compiled sanitize stage
        applies the mining schema's invalidValueTreatment to it
        (compiler.full_fn; spec default returnInvalid)."""
        if v is None:
            return math.nan
        if isinstance(v, str):
            codec = self.codecs.get(field)
            if codec is not None:
                # undeclared category → invalid marker; no numeric
                # fallback (it would alias a numeric-looking string onto
                # a code)
                return codec.get(v, math.inf)
            try:
                return float(v)
            except ValueError:
                return math.nan
        return float(v)


def from_records(
    space: FieldSpace, records: Sequence[Mapping[str, Value]]
) -> Tuple[np.ndarray, np.ndarray]:
    """Dict records → (X, M). Unknown keys are ignored; absent keys are
    missing (mirrors the oracle's ``record.get``)."""
    B, F = len(records), space.arity
    X = np.full((B, F), np.nan, np.float32)
    for b, rec in enumerate(records):
        for j, name in enumerate(space.fields):
            if name in rec:
                X[b, j] = space.encode_cell(name, rec[name])
    M = np.isnan(X)
    return np.where(M, 0.0, X).astype(np.float32), M


def from_dense(
    space: FieldSpace,
    vectors: np.ndarray,
    replace_nan: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense vectors [B, F] → (X, M); arity must equal the active fields.

    Reference parity: dense vectors zip with active fields in order; arity
    mismatch is an InputValidationException (→ empty predictions at the API
    layer, SURVEY.md §4.1 validateInput).
    """
    vectors = np.asarray(vectors, np.float32)
    if vectors.ndim != 2:
        raise InputValidationException(
            f"dense batch must be rank-2 [batch, fields], got shape "
            f"{vectors.shape}"
        )
    if vectors.shape[1] != space.arity:
        raise InputValidationException(
            f"input arity {vectors.shape[1]} != model active fields "
            f"{space.arity} ({', '.join(space.fields)})"
        )
    if replace_nan is not None:
        vectors = np.where(np.isnan(vectors), np.float32(replace_nan), vectors)
    M = np.isnan(vectors)
    return np.where(M, 0.0, vectors).astype(np.float32), M


def from_sparse(
    space: FieldSpace,
    indices: Sequence[Sequence[int]],
    values: Sequence[Sequence[float]],
    replace_nan: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse per-record (indices, values) → (X, M); absent indices are
    missing (reference: sparse gaps = missing values)."""
    B, F = len(indices), space.arity
    X = np.full((B, F), np.nan, np.float32)
    for b, (idx, val) in enumerate(zip(indices, values)):
        if len(idx) != len(val):
            raise InputValidationException(
                f"record {b}: {len(idx)} indices but {len(val)} values"
            )
        for i, v in zip(idx, val):
            if not 0 <= i < F:
                raise InputValidationException(
                    f"record {b}: sparse index {i} out of range [0, {F})"
                )
            X[b, i] = v
    if replace_nan is not None:
        X = np.where(np.isnan(X), np.float32(replace_nan), X)
    M = np.isnan(X)
    return np.where(M, 0.0, X).astype(np.float32), M


def pad_batch(
    X: np.ndarray, M: np.ndarray, batch_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a partial batch to the compiled batch shape (static shapes; SURVEY.md §8 step 3 'pad the tail').

    Returns (X_pad, M_pad, lane_mask) where lane_mask marks real records.
    """
    n = X.shape[0]
    if n > batch_size:
        raise InputValidationException(
            f"batch of {n} exceeds compiled batch size {batch_size}"
        )
    lane = np.zeros(batch_size, bool)
    lane[:n] = True
    if n == batch_size:
        return X, M, lane
    Xp = np.zeros((batch_size, X.shape[1]), np.float32)
    Mp = np.ones((batch_size, X.shape[1]), bool)  # padding lanes are missing
    Xp[:n] = X
    Mp[:n] = M
    return Xp, Mp, lane
