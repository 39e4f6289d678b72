"""Key-stable chip assignment: which chip owns which keys/partitions.

A copy of ``flink_jpmml_tpu/parallel/assignment.py`` with the import
lines renamed. What differs: a chip's id is its ``torch.device.index``
(``parallel/mesh.device_id``) where the JAX module reads ``Device.id``;
a mesh's ``shape`` is the port ``Mesh``'s ``{"data": d, "model": m}``.

The mesh hot path splits ingest across chips — each
data-axis row of the mesh drains its own kafka partitions — and the
rollout plane splits canary traffic per key. Both splits must be
STABLE under a degraded-mesh resize: when ``ShardedModel
.without_devices`` drops a chip, only the dead chip's partitions and
keys may move (its work re-homes onto survivors); every healthy chip
keeps exactly what it had, so per-key ordering, per-chip checkpoints,
and canary fractions survive the rebuild untouched.

Plain ``stable_hash(key) % n`` (what :class:`~flink_jpmml_tpu_torch.parallel
.partitioner.HashPartitioner` does for a FIXED lane count) reshuffles
nearly everything when n changes; :func:`~flink_jpmml_tpu_torch.parallel
.partitioner.rendezvous_pick` (highest-random-weight hashing over the
same ``stable_hash``) gives the minimal-movement property with no
coordination and no state — every process derives the identical
assignment from the chip-id set alone.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from flink_jpmml_tpu_torch.parallel.mesh import DATA_AXIS, device_id
from flink_jpmml_tpu_torch.parallel.partitioner import rendezvous_pick
from flink_jpmml_tpu_torch.utils.exceptions import FlinkJpmmlTpuError


class ChipAssignment:
    """Rendezvous-hashed ownership of partitions and record keys by chip.

    ``chips`` are opaque ids (device ids for a real mesh, ints for
    tests); ``partitions`` is the kafka partition set being divided.
    The assignment is a pure function of (chips, partitions) — no
    state to checkpoint, identical on every host."""

    def __init__(self, chips: Sequence[Any], partitions: Sequence[int] = ()):
        chips = tuple(chips)
        if not chips:
            raise FlinkJpmmlTpuError("ChipAssignment needs >= 1 chip")
        if len(set(chips)) != len(chips):
            raise FlinkJpmmlTpuError(f"duplicate chip ids: {chips!r}")
        self._chips = chips
        self._partitions = tuple(int(p) for p in partitions)
        self._part_owner: Dict[int, Any] = {
            p: rendezvous_pick(("part", p), chips) for p in self._partitions
        }

    @classmethod
    def for_mesh(cls, mesh, partitions: Sequence[int] = ()) -> "ChipAssignment":
        """One lane per DATA-axis row of ``mesh`` (the unit a chip loss
        removes — ``degraded_mesh`` preserves the model axis and trims
        whole rows). A row's id is its first device's id, so after
        ``without_devices`` the surviving rows keep their ids and the
        rendezvous weights — and therefore their keys — are unchanged."""
        grid = mesh.devices
        rows = grid.reshape(mesh.shape[DATA_AXIS], -1)
        chips = tuple(device_id(row[0]) for row in rows)
        return cls(chips, partitions)

    @property
    def chips(self) -> Tuple[Any, ...]:
        return self._chips

    @property
    def partitions(self) -> Tuple[int, ...]:
        return self._partitions

    def chip_for_key(self, key: Any) -> Any:
        """The chip that owns record ``key`` (rendezvous over chips)."""
        return rendezvous_pick(key, self._chips)

    def chip_for_partition(self, partition: int) -> Any:
        return self._part_owner[int(partition)]

    def partitions_for(self, chip: Any) -> Tuple[int, ...]:
        """The kafka partitions ``chip`` drains (source order preserved)."""
        return tuple(
            p for p in self._partitions if self._part_owner[p] == chip
        )

    def without(self, lost) -> "ChipAssignment":
        """The assignment minus ``lost`` chips (ids or devices). Only
        the lost chips' partitions/keys re-home — the rendezvous
        property every caller relies on."""
        lost_ids = {device_id(d) for d in lost}
        survivors = [c for c in self._chips if c not in lost_ids]
        if not survivors:
            raise FlinkJpmmlTpuError(
                "chip assignment unsurvivable: every chip lost"
            )
        return ChipAssignment(survivors, self._partitions)

    def split(self, records: Sequence[Any], key_fn=lambda r: r) -> Dict[Any, list]:
        """Group ``records`` by owning chip (intra-chip order kept)."""
        out: Dict[Any, list] = {c: [] for c in self._chips}
        for r in records:
            out[self.chip_for_key(key_fn(r))].append(r)
        return out

    def state(self) -> dict:
        """Checkpoint-shaped snapshot (derivable, carried for
        observability: what the operator sees in the drill artifact)."""
        return {
            "chips": [str(c) for c in self._chips],
            "partitions": {
                str(p): str(self._part_owner[p]) for p in self._partitions
            },
        }


def mesh_in_flight(mesh, base_depth: int) -> int:
    """Mesh-aware in-flight window depth: a data-parallel dispatch
    keeps at least one launch in flight per pipeline stage AND enough
    to cover the mesh's data rows (each launch spans the mesh, so depth
    need not scale linearly — capped at 8, the max_dispatch_chunks
    shape). Single-chip (data=1) returns ``base_depth`` unchanged: the
    no-mesh fast path must not change geometry."""
    if mesh is None:
        return base_depth
    data = mesh.shape.get(DATA_AXIS, 1)
    if data <= 1:
        return base_depth
    return max(base_depth, min(8, data))


def assignment_for(
    mesh, partitions: Sequence[int] = ()
) -> Optional[ChipAssignment]:
    """→ :class:`ChipAssignment` for ``mesh`` (None mesh → None)."""
    if mesh is None:
        return None
    return ChipAssignment.for_mesh(mesh, partitions)
