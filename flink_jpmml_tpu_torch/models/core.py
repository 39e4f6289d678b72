"""Model identity: name + version, and served-model metadata.

The port's copy of ``flink_jpmml_tpu/models/core.py``, unchanged.

Reference parity: ``ModelId`` / ``ModelInfo`` in the reference's
``…/models/core/`` (SURVEY.md §3 row C2 [UNVERIFIED]). ``ModelId`` is the key
of the dynamic-serving registry; ``ModelInfo`` records where the model's PMML
lives (the *path*, never the document itself — capability C2: only paths
travel through the system).
"""

from __future__ import annotations

from dataclasses import dataclass

_SEP = "_"


@dataclass(frozen=True, order=True)
class ModelId:
    name: str
    version: int

    def __post_init__(self) -> None:
        if not self.name or _SEP in self.name:
            raise ValueError(
                f"model name must be non-empty and must not contain {_SEP!r}: "
                f"{self.name!r}"
            )
        if self.version < 0:
            raise ValueError(f"model version must be >= 0: {self.version}")

    def key(self) -> str:
        return f"{self.name}{_SEP}{self.version}"

    @staticmethod
    def from_key(key: str) -> "ModelId":
        name, _, version = key.rpartition(_SEP)
        return ModelId(name=name, version=int(version))


@dataclass(frozen=True)
class ModelInfo:
    """Registry value: the filesystem path of a served model's PMML document."""

    path: str
