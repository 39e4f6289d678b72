"""Multi-host scaffolding: process group init + global batch assembly.

The port of ``flink_jpmml_tpu/parallel/distributed.py``, on
``torch.distributed``. Reference parity (SURVEY.md §3 row D1): the
reference rode Flink's runtime — Akka/Pekko RPC control plane + Netty
data plane; the JAX package rides ``jax.distributed`` and the
collectives XLA emits. The port's substrate is a ``torch.distributed``
process group: gloo on the CPU, NCCL on the card.

Single-process (tests, one-host runs) everything degrades to no-ops.
Multi-host flow per host:

    init_distributed("host:port", num_processes, process_id)
    mesh = make_mesh()                      # this host's cards
    gb = global_batch(mesh, X_local, M_local)

Each host ingests and hash-partitions its own records
(:mod:`flink_jpmml_tpu_torch.parallel.partitioner`), builds the
process-local slice of the global micro-batch, and ``global_batch``
places it on the local mesh's data devices and reports where it sits in
the global batch, without any host gathering the world.

What differs from the JAX module: nothing here builds a global array —
PyTorch has none — so :func:`global_batch` returns a
:class:`GlobalBatch` (the local slice split over the local data rows,
the global row count, and the slice's first global row, in process
order). ``init_distributed`` with no arguments joins only when the
launcher's environment says so (``WORLD_SIZE`` > 1 with
``MASTER_ADDR``, as ``torchrun`` sets them), where JAX auto-detects TPU
pod metadata.

Liveness: pair the group with :mod:`flink_jpmml_tpu_torch.parallel.health`
— workers run a ``HealthReporter`` against the job's
``HealthCoordinator``, so a hung or killed host is declared dead within
its timeout.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from flink_jpmml_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, physical
from flink_jpmml_tpu_torch.utils.exceptions import InputValidationException

_initialized = False


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-host process group (idempotent).

    Explicit coordinates (``"host:port"`` of process 0's rendezvous)
    initialize directly. With no arguments, a launcher's environment
    (``WORLD_SIZE`` > 1 and ``MASTER_ADDR``) initializes from it; a plain
    single-process environment is a no-op returning False, so the same
    code path runs one-host. The group runs NCCL with a card and gloo
    without one."""
    import torch.distributed as dist

    global _initialized
    if _initialized:
        return True
    backend = _backend()
    if coordinator_address is None and num_processes is None:
        if (int(os.environ.get("WORLD_SIZE", "1")) <= 1
                or "MASTER_ADDR" not in os.environ):
            return False
        dist.init_process_group(backend, init_method="env://")
        _initialized = True
        return True
    if num_processes == 1:
        return False
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    _initialized = True
    return True


@dataclass
class GlobalBatch:
    """This process's slice of a global micro-batch, placed on the local
    mesh: ``X`` / ``M`` hold one shard a local data row (on the row's
    first device), ``global_rows`` the rows of all processes together and
    ``offset`` the slice's first global row (process order)."""

    X: List[torch.Tensor]
    M: List[torch.Tensor]
    global_rows: int
    offset: int

    @property
    def shape(self):
        return (self.global_rows,) + tuple(self.X[0].shape[1:])


def global_batch(mesh: Mesh, X_local: np.ndarray, M_local: np.ndarray
                 ) -> GlobalBatch:
    """Per-host local batch slices → this host's placed shards of one
    global batch. The local slice splits into the mesh's data rows (it
    must divide by the data axis); the global row count and this slice's
    offset come from an all-reduce of every process's local count when a
    process group is up, else the local slice is the whole batch. Host memory
    never holds the global batch."""
    n_data = mesh.shape[DATA_AXIS]
    n_local = int(X_local.shape[0])
    if n_local % n_data != 0:
        raise InputValidationException(
            f"local batch {n_local} must divide by the data-axis size "
            f"{n_data} (pad the micro-batch)")
    X = torch.from_numpy(np.ascontiguousarray(X_local, np.float32))
    M = torch.from_numpy(np.ascontiguousarray(M_local, bool))
    devs = [physical(mesh.devices[r, 0]) for r in range(n_data)]
    xs = [x.to(d) for x, d in zip(X.chunk(n_data), devs)]
    ms = [m.to(d) for m, d in zip(M.chunk(n_data), devs)]
    total, offset = n_local, 0
    if _initialized:
        import torch.distributed as dist

        dev = mesh.primary if dist.get_backend() == "nccl" else "cpu"
        counts = torch.zeros(dist.get_world_size(), dtype=torch.int64,
                             device=dev)
        counts[dist.get_rank()] = n_local
        dist.all_reduce(counts)
        counts = counts.cpu().tolist()
        total = int(sum(counts))
        offset = int(sum(counts[: dist.get_rank()]))
    return GlobalBatch(xs, ms, total, offset)
