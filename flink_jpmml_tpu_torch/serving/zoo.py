"""Multi-tenant zoo manager: pack residency, warm pool, fairness.

The port of ``flink_jpmml_tpu/serving/zoo.py``, with the import lines
renamed and one difference: a planned group whose members the packed
launch cannot take together (``packs.build_pack`` raises ValueError,
``qtrees_cuda.packed_shape``) is refused once — its tenants are re-planned
as solos and the group is never built again for this plan — where the
JAX manager has no such case. A pack's cold start is its first dispatch
(the port compiles no program per pack: the walk kernel is built once per
process).

Multi-tenant zoo manager: pack residency, warm pool, fairness.

The paper's serving shape is a ZOO — many small per-segment PMML
models behind one streaming job — and the cross-model packer
(compile/packs.py) collapses their dispatches so the chip stops
idling between tiny launches. This module is the serving-side owner
of that machinery, the zoo's device-memory manager:

- **Membership & plan.** Tenants (served model keys) observed on the
  scoring path register here with their quantized scorers; whenever
  the membership multiset changes, the adopted packing partition is
  re-resolved through ``autotune.ensure_pack_plan`` — cached per
  model-SET hash, so a tenant add/remove invalidates the stale winner
  by construction instead of serving it.
- **Residency (LRU).** Built packs are device-resident state: each
  holds a staged input buffer plus pinned member tables
  (``PackedScorer.resident_bytes``). ``FJT_ZOO_BYTES`` caps the total;
  admission beyond the cap evicts the least-recently-dispatched pack
  (``zoo_evictions``) into the warm pool.
- **Warm pool.** A bounded FIFO of evicted-but-still-compiled packs.
  Re-admission from the pool skips the XLA compile entirely
  (``warm_pool_hits``); a true cold build pays it under the
  ``cold_start_s`` histogram (``warm_pool_misses``), and a build over
  ``FJT_ZOO_COLD_START_BUDGET_S`` files a ``zoo_cold_start_over_budget``
  flight event — the memory manager's SLO signal.
- **Fairness.** ``FJT_TENANT_QUOTA_FRAC`` generalizes the admission controller's
  lanes to per-tenant quotas: one tenant may take at most that
  fraction of a micro-batch's slot rows; the excess is shed
  (``tenant_shed_records{model=*}``) so a hot tenant cannot starve its
  packmates. Enforced by the scorer BEFORE packing (a shed row never
  stages).

The scorer (serving/scorer.py) calls :meth:`batch_plan` once per
micro-batch with the batch's eligible tenant groups and launches one
dispatch per returned pack unit; occupancy/waste gauges and the
eviction/cold-start counters all book here.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from flink_jpmml_tpu_torch.obs import recorder as flight

_ZOO_BYTES_ENV = "FJT_ZOO_BYTES"
_ZOO_BYTES_DEFAULT = 256 * 1024 * 1024
_WARM_POOL_ENV = "FJT_ZOO_WARM_POOL"
_WARM_POOL_DEFAULT = 8
_COLD_BUDGET_ENV = "FJT_ZOO_COLD_START_BUDGET_S"
_QUOTA_ENV = "FJT_TENANT_QUOTA_FRAC"


def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class PackUnit:
    """One pack dispatch of a micro-batch: the compiled pack plus the
    slot assignment for the tenants PRESENT in this batch (absent
    members score their all-zero slots — visible as occupancy, never
    as output)."""

    __slots__ = ("pack", "slots")

    def __init__(self, pack, slots: List[Tuple[int, str]]):
        self.pack = pack
        self.slots = slots  # [(slot index, tenant key)]


class ZooManager:
    """Serving-side owner of cross-model packs for one scorer."""

    def __init__(self, metrics=None):
        from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.bytes_cap = _env_int(_ZOO_BYTES_ENV, _ZOO_BYTES_DEFAULT)
        self.warm_pool_size = max(0, _env_int(_WARM_POOL_ENV,
                                              _WARM_POOL_DEFAULT))
        self.cold_budget_s = _env_float(_COLD_BUDGET_ENV, None)
        self.quota_frac = _env_float(_QUOTA_ENV, None)
        # tenant key -> its quantized scorer (pack-eligible by the
        # scorer's pre-filter); the membership multiset the plan hangs on
        self._members: Dict[str, object] = {}
        self._member_ids: Dict[str, str] = {}  # key -> plan member id
        self._plan_groups: Dict[str, Tuple[str, ...]] = {}  # key -> group
        self._plan_dirty = True
        # resident packs, LRU order (group key tuple -> PackedScorer)
        self._resident: "OrderedDict[Tuple[str, ...], object]" = OrderedDict()
        self._resident_bytes = 0
        # evicted-but-compiled packs, FIFO bounded
        self._warm_pool: "OrderedDict[Tuple[str, ...], object]" = OrderedDict()
        # per-tenant dispatch accounting for the fjt-top --zoo panel
        self._c_evict = self.metrics.counter("zoo_evictions")
        self._c_hits = self.metrics.counter("warm_pool_hits")
        self._c_miss = self.metrics.counter("warm_pool_misses")
        self._c_disp = self.metrics.counter("pack_dispatches")
        self._h_cold = self.metrics.histogram("cold_start_s")
        self._g_occ = self.metrics.gauge("pack_occupancy")
        self._g_waste = self.metrics.gauge("pack_pad_waste")
        self._g_bytes = self.metrics.gauge("zoo_resident_bytes")
        # registered-tenant count: the cardinality-governor's scale
        # signal (how far over FJT_METRICS_MAX_SERIES the per-tenant
        # families would grow ungoverned) — MAX across the fleet,
        # workers serve the same zoo
        self._g_tenants = self.metrics.gauge("zoo_tenants")

    # -- membership --------------------------------------------------------

    def observe(self, key: str, q) -> None:
        """Track one tenant seen on the scoring path. A changed scorer
        for a known key (version swap → different model hash) dirties
        the plan exactly like a new tenant."""
        prev = self._members.get(key)
        if prev is q:
            return
        self._members[key] = q
        self._member_ids[key] = f"{q.model_hash}:{key}"
        self._plan_dirty = True
        self._g_tenants.set(float(len(self._members)))

    def sync(self, live_keys) -> None:
        """Drop tenants no longer served (a Del control message): their
        packs' plan membership changes, so the stale partition — and any
        resident pack holding the dead tenant's tables — retires."""
        dead = [k for k in self._members if k not in live_keys]
        for k in dead:
            del self._members[k]
            del self._member_ids[k]
        if dead:
            self._plan_dirty = True
            self._g_tenants.set(float(len(self._members)))

    def tenant_count(self) -> int:
        return len(self._members)

    def quota_rows(self, batch_size: int) -> Optional[int]:
        """Per-tenant row cap per micro-batch under the fairness quota;
        None when the quota is off."""
        if not self.quota_frac or self.quota_frac <= 0:
            return None
        if self.quota_frac >= 1.0:
            return None
        return max(1, int(self.quota_frac * batch_size))

    # -- the plan ----------------------------------------------------------

    def _replan(self) -> None:
        from flink_jpmml_tpu_torch.compile import autotune, costmodel

        metas = {
            self._member_ids[k]: costmodel.scorer_meta(q)
            for k, q in self._members.items()
        }
        plan = autotune.ensure_pack_plan(metas)
        id_to_key = {v: k for k, v in self._member_ids.items()}
        self._plan_groups = {}
        for g in plan.groups:
            keys = tuple(sorted(
                id_to_key[mid] for mid in g if mid in id_to_key
            ))
            for k in keys:
                self._plan_groups[k] = keys
        self._plan_dirty = False
        # resident packs whose membership no longer matches any planned
        # group are stale state: retire them to the warm pool (their
        # members may re-pack differently next dispatch)
        planned = set(self._plan_groups.values())
        for gk in [g for g in self._resident if g not in planned]:
            self._retire(gk)

    # -- residency ---------------------------------------------------------

    def _retire(self, gk: Tuple[str, ...]) -> None:
        pack = self._resident.pop(gk, None)
        if pack is None:
            return
        self._resident_bytes -= pack.resident_bytes
        self._c_evict.inc()
        if self.warm_pool_size > 0:
            self._warm_pool[gk] = pack
            while len(self._warm_pool) > self.warm_pool_size:
                self._warm_pool.popitem(last=False)
        self._g_bytes.set(float(self._resident_bytes))

    def _admit(self, gk: Tuple[str, ...], pack) -> None:
        self._resident[gk] = pack
        self._resident_bytes += pack.resident_bytes
        # LRU eviction under the byte cap: never evict the pack being
        # admitted (a cap smaller than one pack still serves, just
        # thrashes visibly)
        while self._resident_bytes > self.bytes_cap and len(self._resident) > 1:
            victim = next(iter(self._resident))
            if victim == gk:
                break
            self._retire(victim)
        self._g_bytes.set(float(self._resident_bytes))

    def _pack_for(self, gk: Tuple[str, ...], qs: Dict[str, object]):
        """Resident-else-warm-pool-else-build → the compiled pack for
        one planned group (cold-start accounting lives here)."""
        pack = self._resident.get(gk)
        if pack is not None:
            self._resident.move_to_end(gk)
            return pack
        pack = self._warm_pool.pop(gk, None)
        if pack is not None:
            self._c_hits.inc()
            self._admit(gk, pack)
            return pack
        from flink_jpmml_tpu_torch.compile import packs

        self._c_miss.inc()
        t0 = time.monotonic()
        pack = packs.build_pack([qs[k] for k in gk], list(gk))
        pack.warmup()  # the first packed dispatch is the cold-start cost
        dt = time.monotonic() - t0
        self._h_cold.observe(dt)
        if self.cold_budget_s is not None and dt > self.cold_budget_s:
            flight.record(
                "zoo_cold_start_over_budget",
                group=len(gk), cold_start_s=round(dt, 4),
                budget_s=self.cold_budget_s,
            )
        self._admit(gk, pack)
        return pack

    # -- per-batch planning ------------------------------------------------

    def batch_plan(self, present: Dict[str, object]) -> List[PackUnit]:
        """One micro-batch's pack dispatches.

        ``present`` maps tenant key → quantized scorer for the batch's
        pack-eligible groups. Tenants whose planned group has a single
        present member stay on the solo path (a 1-slot pack dispatch
        saves nothing); groups with ≥ 2 present members return as
        :class:`PackUnit`\\ s, each one device dispatch."""
        for k, q in present.items():
            self.observe(k, q)
        if self._plan_dirty:
            self._replan()
        by_group: Dict[Tuple[str, ...], List[str]] = {}
        for k in present:
            gk = self._plan_groups.get(k)
            if gk is not None and len(gk) > 1:
                by_group.setdefault(gk, []).append(k)
        units: List[PackUnit] = []
        for gk, keys in by_group.items():
            if len(keys) < 2:
                continue  # solo dispatch beats a 1-slot pack launch
            qs = {k: self._members[k] for k in gk}
            try:
                pack = self._pack_for(gk, qs)
            except ValueError as e:
                # a mix the packed launch cannot take: its tenants serve
                # solo until the next re-plan
                for k in gk:
                    self._plan_groups[k] = (k,)
                flight.record("zoo_pack_refused", group=len(gk),
                              error=str(e))
                continue
            slot_of = {k: i for i, k in enumerate(gk)}
            units.append(
                PackUnit(pack, [(slot_of[k], k) for k in sorted(keys)])
            )
        return units

    def book_dispatch(self, unit: PackUnit, rows_staged: int) -> None:
        """Per-dispatch accounting: occupancy (real rows over total
        slot rows, fleet-merged MIN — the worst pack is the signal) and
        pad waste (MAX — the worst buffer)."""
        self._c_disp.inc()
        total = unit.pack.n_members * unit.pack.B
        self._g_occ.set(rows_staged / total if total else 0.0)
        self._g_waste.set(unit.pack.pad_waste())

    # -- views (fjt-top --zoo) --------------------------------------------

    def snapshot(self) -> dict:
        return {
            "tenants": len(self._members),
            "resident_packs": len(self._resident),
            "resident_bytes": self._resident_bytes,
            "warm_pool": len(self._warm_pool),
            "groups": {
                ",".join(gk): list(gk) for gk in self._resident
            },
        }
