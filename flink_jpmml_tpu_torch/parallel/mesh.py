"""Device mesh construction (SURVEY.md §8 step 4).

The port of ``flink_jpmml_tpu/parallel/mesh.py``. The reference's only
parallelism is Flink data parallelism — N operator subtasks with
replicated models (SURVEY.md §3 P1). The JAX package's equivalent is a
``jax.sharding.Mesh``; the port keeps a small :class:`Mesh` of its own
with the same two named axes:

- ``data``:  batch sharding (DP) — each data row scores a slice of the
  micro-batch with replicated params; the padding batcher guarantees the
  batch divides evenly.
- ``model``: feature sharding (1-D TP) for wide linear models (BASELINE
  config 5's 10k-dim sparse scorer) — wide weight rows split across the
  row's devices, the partial products added in slice order.

``data × model`` must cover the devices exactly; the default is all-DP.

What differs from the JAX module:

- ``Mesh.devices`` is a numpy object array of ``torch.device`` shaped
  ``[data, model]`` and ``Mesh.shape`` the mapping ``{"data": d,
  "model": m}``, as ``jax.sharding.Mesh.shape`` reads; a device's id is
  its ``torch.device.index`` (:func:`device_id`) where JAX reads
  ``Device.id``.
- ``make_mesh()`` with no ``devices`` takes every ``cuda:i``; without a
  card it raises :class:`DeviceUnavailableError` and never falls back to
  the CPU. A CPU mesh comes only from an explicit list of
  ``torch.device("cpu", i)``: those logical devices all map to the one
  physical CPU (:func:`physical`), as the JAX test suite's 8-device
  virtual CPU mesh maps to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from flink_jpmml_tpu_torch.utils.config import MeshConfig
from flink_jpmml_tpu_torch.utils.device import pin_float32_precision
from flink_jpmml_tpu_torch.utils.exceptions import (
    DeviceUnavailableError,
    FlinkJpmmlTpuError,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def device_id(d):
    """A device's id (``torch.device.index``); anything else (the plain
    ints tests use for chips) is its own id."""
    return d.index if isinstance(d, torch.device) else d


def physical(d: torch.device) -> torch.device:
    """The physical device a mesh device runs on: ``cuda:i`` itself, and
    the one CPU for every logical ``cpu:i``."""
    return torch.device("cpu") if d.type == "cpu" else d


class Mesh:
    """A ``data × model`` grid of ``torch.device`` (module docstring).
    Hashable by its devices and axis names, so compile caches can key on
    it as the JAX reader keys on ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names=(DATA_AXIS, MODEL_AXIS)):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(devices[idx])
        if grid.ndim != 2:
            raise FlinkJpmmlTpuError(
                f"mesh devices must be a [data, model] grid: {grid.shape}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))
        self._key = (self.axis_names, grid.shape,
                     tuple(str(d) for d in grid.flat))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def primary(self) -> torch.device:
        """The physical device of the mesh's first device: where a sharded
        model's inputs arrive and its gathered outputs land."""
        return physical(self.devices[0, 0])

    def row(self, r: int) -> list:
        """The devices of data row ``r`` (its model-axis slice)."""
        return list(self.devices[r])

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other._key == self._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _as_devices(devices) -> list:
    devs = [torch.device(d) for d in devices]
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"mesh device {d} requested but CUDA is not available")
        if d.index is None:
            raise FlinkJpmmlTpuError(
                f"mesh device {d} needs an index (torch.device"
                f"({d.type!r}, i)): a chip's id is its index")
    if len({str(d) for d in devs}) != len(devs):
        raise FlinkJpmmlTpuError(f"duplicate mesh devices: {devs}")
    return devs


def make_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    allow_subset: bool = False,
) -> Mesh:
    """Build the ``data × model`` mesh.

    ``data * model`` must equal the device count exactly — silently idling
    devices is a throughput bug, not a convenience; pass ``allow_subset=True``
    (or an explicit ``devices`` slice) to opt into a partial mesh. With no
    ``devices`` the mesh spans every CUDA card, and raises
    :class:`DeviceUnavailableError` without one."""
    pin_float32_precision()
    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "no CUDA device is present; pass devices=[torch.device("
                "'cpu', i), ...] for a CPU mesh")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = _as_devices(devices)
    if config is None:
        # all-DP over every visible device
        config = MeshConfig(data=len(devs), model=1)
    need = config.data * config.model
    if need > len(devs):
        raise FlinkJpmmlTpuError(
            f"mesh {config.data}x{config.model} needs {need} devices, "
            f"only {len(devs)} visible"
        )
    if need < len(devs) and not allow_subset:
        raise FlinkJpmmlTpuError(
            f"mesh {config.data}x{config.model} covers {need} of "
            f"{len(devs)} devices — the rest would sit idle; pass "
            "allow_subset=True (or an explicit devices list) if intentional"
        )
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return Mesh(grid.reshape(config.data, config.model),
                axis_names=(DATA_AXIS, MODEL_AXIS))


def cpu_devices(n: int = 8) -> list:
    """``n`` logical CPU devices, ``cpu:0`` … ``cpu:n-1`` — the port's
    counterpart of the JAX suite's virtual CPU devices."""
    return [torch.device("cpu", i) for i in range(n)]
