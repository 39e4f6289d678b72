"""Prediction ADT: the total (exception-free) scoring output type.

A copy of ``flink_jpmml_tpu/models/prediction.py``, kept so that the PyTorch port imports
nothing of the JAX package; the two must parse and prepare alike
(tests/test_torch_frontend.py).

Reference parity: ``Prediction`` / sealed ``Score`` / ``EmptyScore`` in the
reference's ``…/models/prediction.scala`` (SURVEY.md §3 row B4 [UNVERIFIED]).
The reference wraps every evaluation in a ``Try`` and collapses failures into
``Prediction(EmptyScore)`` so dirty data never kills the stream (capability
C5). Here the same totality is achieved *as data*: the compiled model
emits a per-record validity mask alongside scores, and the host-side decode
step materialises invalid lanes as ``EmptyScore``. No exception ever crosses
the device boundary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Union


@dataclass(frozen=True)
class Score:
    """A successful scoring result: a concrete target value."""

    value: float

    def is_empty(self) -> bool:
        return False

    def get_or_else(self, default: float) -> float:
        return self.value


@dataclass(frozen=True)
class EmptyScore:
    """A failed scoring result (invalid input, preparation error, …).

    Singleton-ish by convention: compare with ``is_empty()`` rather than
    identity.
    """

    def is_empty(self) -> bool:
        return True

    def get_or_else(self, default: float) -> float:
        return default


ScoreLike = Union[Score, EmptyScore]


@dataclass(frozen=True)
class Target:
    """Decoded target for classification-style models.

    ``label`` is the predicted category (as a string, matching PMML
    DataDictionary values); ``probabilities`` optionally maps every class
    label to its probability.
    """

    label: Optional[str] = None
    probabilities: Mapping[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class Prediction:
    """The unit of output of every evaluation.

    ``score`` is total: either a :class:`Score` or :class:`EmptyScore`.
    ``target`` carries the decoded class label / per-class probabilities for
    classification models (``None`` for pure regression / clustering outputs
    where ``score`` already says everything). ``outputs`` carries the
    document's top-level <Output> field values when it declares any
    (pmml/outputs.py), ``None`` otherwise.
    """

    score: ScoreLike
    target: Optional[Target] = None
    outputs: Optional[Mapping[str, Any]] = None

    @property
    def is_empty(self) -> bool:
        return self.score.is_empty()

    @staticmethod
    def empty() -> "Prediction":
        return Prediction(score=EmptyScore())

    @staticmethod
    def of(value: float) -> "Prediction":
        """Lift a raw value; NaN collapses to :class:`EmptyScore` (totality)."""
        if value is None or _is_nan(value):
            return Prediction.empty()
        return Prediction(score=Score(float(value)))


def _is_nan(v: Any) -> bool:
    # math.isnan accepts any real number (incl. numpy scalars off the device);
    # non-numeric values are not NaN.
    try:
        return math.isnan(v)
    except TypeError:
        return False


def decode_batch(
    values: Sequence[float],
    valid: Sequence[bool],
    labels: Optional[Sequence[Optional[str]]] = None,
    probabilities: Optional[Sequence[Mapping[str, float]]] = None,
) -> list[Prediction]:
    """Materialise device output lanes into :class:`Prediction` objects.

    ``values``/``valid`` come straight off the device (host-transferred);
    invalid lanes become ``Prediction(EmptyScore)`` — the masked-lane
    equivalent of the reference's ``Try``→``EmptyScore`` collapse.
    """
    n = len(values)
    if len(valid) != n:
        raise ValueError(f"values/valid length mismatch: {n} vs {len(valid)}")
    for opt, tag in ((labels, "labels"), (probabilities, "probabilities")):
        if opt is not None and len(opt) != n:
            raise ValueError(f"{tag} length mismatch: {n} vs {len(opt)}")
    out: list[Prediction] = []
    for i in range(n):
        v, ok = values[i], valid[i]
        if not ok or _is_nan(v):
            out.append(Prediction.empty())
            continue
        target: Optional[Target] = None
        if labels is not None and labels[i] is not None:
            probs = probabilities[i] if probabilities is not None else None
            target = Target(
                label=labels[i],
                probabilities=dict(probs) if probs else {},
            )
        out.append(Prediction(score=Score(float(v)), target=target))
    return out
