"""Runtime configuration (SURVEY.md §6 "Config / flag system").

A copy of ``flink_jpmml_tpu/utils/config.py``; the port reads
``CompileConfig.max_dense_depth`` and ``BatchConfig`` and keeps the rest
so that configs are interchangeable between the two packages.

The reference had no config system beyond constructor args; ours needs one
because the TPU runtime has real knobs: mesh shape, micro-batch size and
deadline, compile dtype. Small frozen dataclasses + an env/CLI override hook;
no external config framework.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class BatchConfig:
    """Fill-or-deadline micro-batching knobs (SURVEY.md §8 step 3).

    A batch ships when it reaches ``size`` records OR ``deadline_us``
    microseconds have elapsed since its first record, whichever happens first.
    The tail is padded to ``size`` (static shapes).
    """

    size: int = 4096
    deadline_us: int = 2000
    queue_capacity: int = 65536

    def __post_init__(self) -> None:
        if self.size <= 0:
            raise ValueError(f"batch size must be > 0: {self.size}")
        if self.deadline_us <= 0:
            raise ValueError(f"deadline must be > 0: {self.deadline_us}")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape: ``data`` (batch DP) × ``model`` (feature sharding).

    ``axes == (data, model)``; ``data * model`` must divide the number of
    visible devices (or equal it when ``exact``). The default is pure DP —
    the reference's only parallelism is data parallelism (SURVEY.md §3 P1).
    """

    data: int = 1
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")

    def __post_init__(self) -> None:
        if self.data <= 0 or self.model <= 0:
            raise ValueError(
                f"mesh axes must be > 0: data={self.data} model={self.model}"
            )


@dataclass(frozen=True)
class CompileConfig:
    """Lowering knobs for the PMML compiler."""

    # Matmul accumulation dtype for indicator/einsum paths. bfloat16 keeps the
    # MXU fed; comparisons and thresholds always stay float32 for exactness.
    matmul_dtype: str = "bfloat16"
    # Hard cap on supported tree depth for the padded-dense lowering; deeper
    # trees fall back to the iterative gather traversal.
    max_dense_depth: int = 10
    # donate input batch buffers to the jitted call; off by default because
    # score outputs rarely alias input shapes (XLA would warn and ignore it)
    donate_batches: bool = False
    # mesh-aware compile (BASELINE config 5): a param tensor whose leading
    # dimension is at least this wide is sharded over the mesh's ``model``
    # axis (1-D feature TP); narrower params replicate. 4096 ≈ where a
    # weight shard still tiles the MXU after an 8-way split.
    tp_wide_threshold: int = 4096

    def __post_init__(self) -> None:
        if self.matmul_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"matmul_dtype must be bfloat16 or float32: "
                f"{self.matmul_dtype!r}"
            )
        if self.max_dense_depth <= 0:
            raise ValueError(
                f"max_dense_depth must be > 0: {self.max_dense_depth}"
            )
        if self.tp_wide_threshold <= 0:
            raise ValueError(
                f"tp_wide_threshold must be > 0: {self.tp_wide_threshold}"
            )


@dataclass(frozen=True)
class RuntimeConfig:
    batch: BatchConfig = field(default_factory=BatchConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    compile: CompileConfig = field(default_factory=CompileConfig)
    checkpoint_dir: Optional[str] = None
    checkpoint_interval_s: float = 30.0
    metrics_log_interval_s: float = 10.0


_ENV_PREFIX = "FJT_"


def from_env(base: Optional[RuntimeConfig] = None) -> RuntimeConfig:
    """Apply ``FJT_*`` environment overrides to a config.

    Supported: FJT_BATCH_SIZE, FJT_BATCH_DEADLINE_US, FJT_MESH_DATA,
    FJT_MESH_MODEL, FJT_MATMUL_DTYPE, FJT_CHECKPOINT_DIR.
    """
    cfg = base or RuntimeConfig()
    batch = cfg.batch
    mesh = cfg.mesh
    comp = cfg.compile

    def _int(name: str, cur: int) -> int:
        raw = os.environ.get(_ENV_PREFIX + name)
        return int(raw) if raw else cur

    def _str(name: str, cur):
        # set-but-empty (common in CI/k8s templating) keeps the default,
        # same as the int vars
        raw = os.environ.get(_ENV_PREFIX + name)
        return raw if raw else cur

    batch = dataclasses.replace(
        batch,
        size=_int("BATCH_SIZE", batch.size),
        deadline_us=_int("BATCH_DEADLINE_US", batch.deadline_us),
    )
    mesh = dataclasses.replace(
        mesh,
        data=_int("MESH_DATA", mesh.data),
        model=_int("MESH_MODEL", mesh.model),
    )
    comp = dataclasses.replace(
        comp,
        matmul_dtype=_str("MATMUL_DTYPE", comp.matmul_dtype),
    )
    return dataclasses.replace(
        cfg,
        batch=batch,
        mesh=mesh,
        compile=comp,
        checkpoint_dir=_str("CHECKPOINT_DIR", cfg.checkpoint_dir),
    )
