"""Per-chip mesh telemetry: the observability half of multichip serving.

A copy of ``flink_jpmml_tpu/obs/mesh.py`` with the import lines renamed.
What differs: a chip's id is its ``torch.device.index``
(``parallel/mesh.device_id``) where the JAX module reads ``Device.id``.
``fjt-top --mesh`` (the port's ``cli.py``) renders :func:`summary`.

DrJAX's map/reduce framing (PAPERS.md) is the discipline here: every
per-chip series is either a counter (fleet merge: SUM — per-chip record
counts add across workers exactly) or a gauge with an explicit worst-of
rule, so the supervisor's fleet ``/metrics`` view stays merge-exact at
any mesh width. The catalogue rows live in docs/operations.md; the
merge rules in utils/metrics.py.

Series (chip = the data-row id from parallel/assignment.ChipAssignment):

- ``mesh_chip_records{chip="*"}`` counter — records scored by the chip
  (a data-parallel dispatch splits the batch evenly across rows);
- ``mesh_chip_inflight{chip="*"}`` gauge — the in-flight window depth
  the chip is riding (fleet SUM: total outstanding work);
- ``mesh_chip_state{chip="*"}`` gauge — 0 healthy / 2 lost (fleet
  worst-of, like ``failover_state``);
- ``mesh_data_width`` gauge — surviving data-axis width (fleet MIN:
  the most-degraded worker is the one to look at);
- ``mesh_rebuilds`` counter — degraded-mesh rebuilds performed
  (runtime/block.py's KIND_LOST rung).

``fjt-top --mesh`` renders :func:`summary` over a metrics struct.
"""

from __future__ import annotations

import re
import time
from typing import Dict, Optional

STATE_HEALTHY = 0.0
STATE_LOST = 2.0


class MeshTelemetry:
    """Per-chip accounting for one mesh-sharded serving pipeline.

    ``note_batch`` is called once per completed BATCH from the score
    loop's completion path — the per-chip split is arithmetic (a
    data-parallel dispatch spans every surviving chip equally), never
    a per-record loop. ``note_rebuild`` re-derives the live chip set
    after a degraded-mesh rebuild and flags the dead chips."""

    def __init__(self, metrics, model):
        self._metrics = metrics
        self._started = time.monotonic()
        self._width_gauge = metrics.gauge("mesh_data_width")
        self._rec_counters: Dict[object, object] = {}
        self._inflight_gauges: Dict[object, object] = {}
        self._state_gauges: Dict[object, object] = {}
        self._live: tuple = ()
        self._rebind(model)

    def _chip_ids(self, model) -> tuple:
        assignment = getattr(model, "assignment", None)
        if assignment is not None:
            return tuple(assignment.chips)
        # no kafka assignment attached: derive row ids from the mesh
        # the same way ChipAssignment.for_mesh does (first device of
        # each data row), so the labels agree once one is attached
        from flink_jpmml_tpu_torch.parallel.mesh import DATA_AXIS, device_id

        rows = model.mesh.devices.reshape(
            model.mesh.shape[DATA_AXIS], -1
        )
        return tuple(device_id(r[0]) for r in rows)

    def _series_for(self, chip):
        if chip not in self._rec_counters:
            m = self._metrics
            self._rec_counters[chip] = m.counter(
                f'mesh_chip_records{{chip="{chip}"}}'
            )
            self._inflight_gauges[chip] = m.gauge(
                f'mesh_chip_inflight{{chip="{chip}"}}'
            )
            self._state_gauges[chip] = m.gauge(
                f'mesh_chip_state{{chip="{chip}"}}'
            )

    def _rebind(self, model) -> None:
        self._live = self._chip_ids(model)
        for chip in self._live:
            self._series_for(chip)
            self._state_gauges[chip].set(STATE_HEALTHY)
        self._width_gauge.set(float(len(self._live)))

    # -- hot path ----------------------------------------------------------

    def note_batch(self, n: int, inflight: int) -> None:
        width = len(self._live)
        if not width:
            return
        share = n / width
        for chip in self._live:
            self._rec_counters[chip].inc(share)
            self._inflight_gauges[chip].set(float(inflight))

    # -- rebuild path ------------------------------------------------------

    def note_rebuild(self, rebuilt, lost) -> None:
        from flink_jpmml_tpu_torch.parallel.mesh import device_id

        lost_ids = {device_id(d) for d in lost}
        for chip in self._live:
            if chip in lost_ids:
                self._state_gauges[chip].set(STATE_LOST)
                self._inflight_gauges[chip].set(0.0)
        self._rebind(rebuilt)

    def snapshot(self) -> dict:
        """Bench-artifact shape: per-chip records plus the live set."""
        return {
            "chips": [str(c) for c in self._live],
            "records": {
                str(c): self._rec_counters[c].get()
                for c in self._rec_counters
            },
            "data_width": len(self._live),
        }


def telemetry_for(metrics, model) -> Optional[MeshTelemetry]:
    """→ a :class:`MeshTelemetry` when ``model`` is mesh-sharded with
    ≥2 data rows, else None — a single-chip pipeline must not pay the
    per-batch split (the perf-smoke ≤2µs tripwire's contract)."""
    if metrics is None or not hasattr(model, "batch_divisor"):
        return None
    if int(getattr(model, "batch_divisor", 1)) <= 1:
        return None
    return MeshTelemetry(metrics, model)


_CHIP_RE = {
    "records": re.compile(r'^mesh_chip_records\{chip="([^"]+)"\}$'),
    "inflight": re.compile(r'^mesh_chip_inflight\{chip="([^"]+)"\}$'),
    "state": re.compile(r'^mesh_chip_state\{chip="([^"]+)"\}$'),
}


def state_name(v: float) -> str:
    return "lost" if float(v) >= STATE_LOST else "healthy"


def summary(struct: dict) -> Optional[dict]:
    """Mesh summary from a metrics struct (``fjt-top --mesh``, bench
    artifacts): per-chip records / rec-per-s / in-flight depth / health
    state, the surviving data width, and the rebuild count. None when
    the struct carries no mesh telemetry at all."""
    gauges = struct.get("gauges") or {}
    counters = struct.get("counters") or {}
    uptime = float(struct.get("uptime_s") or 0.0)

    chips: Dict[str, dict] = {}

    def chip(label: str) -> dict:
        return chips.setdefault(
            label, {"records": 0.0, "inflight": 0.0, "state": "healthy"}
        )

    for name, v in counters.items():
        m = _CHIP_RE["records"].match(name)
        if m:
            chip(m.group(1))["records"] = float(v)
    for name, v in gauges.items():
        val = v.get("value") if isinstance(v, dict) else v
        if val is None:
            continue
        m = _CHIP_RE["inflight"].match(name)
        if m:
            chip(m.group(1))["inflight"] = float(val)
            continue
        m = _CHIP_RE["state"].match(name)
        if m:
            chip(m.group(1))["state"] = state_name(float(val))
    if not chips:
        return None
    if uptime > 0:
        for c in chips.values():
            c["rec_per_s"] = c["records"] / uptime
    out: dict = {"chips": dict(sorted(chips.items()))}
    width = gauges.get("mesh_data_width")
    if isinstance(width, dict) and width.get("value") is not None:
        out["data_width"] = float(width["value"])
    rebuilds = counters.get("mesh_rebuilds")
    if rebuilds:
        out["rebuilds"] = float(rebuilds)
    lost = gauges.get("mesh_lost_devices")
    if isinstance(lost, dict) and lost.get("value"):
        out["lost_devices"] = float(lost["value"])
    return out
