"""Keyed per-record session state, device-resident and dispatch-fused.

The port of ``flink_jpmml_tpu/runtime/state.py``. The host mirror (slot
routing, renormalization bookkeeping, snapshots, sidecars, payloads,
``split_output`` / ``record_derived``) is the JAX module's, copied. What
differs:

- **The values** are one ``torch.float32[rows, 8]`` tensor on the table's
  device (``device=``; None, the default, is the card, and without one
  the constructor raises ``DeviceUnavailableError``; the CPU only when
  asked). The fused step is ``compile/statekernel.py``.
- **Out of place, committed at dispatch.** Each state step writes a new
  tensor (the port never donates), and :meth:`KeyedStateTable.commit`
  adopts it when the dispatch is queued, as the JAX ``commit`` does: the
  next dispatch's step reads it on the same CUDA stream, after it. The
  same ``assign_slots`` call advanced ``applied_hi`` and the host mirror
  for that batch, so the committed tensor, ``applied_hi`` and the mirror
  always describe the same batch, the last one dispatched. A snapshot
  waits on the event recorded behind that tensor's step before it reads
  it; no step ever writes into a tensor that a snapshot may be reading,
  so a snapshot never holds a batch that ``applied_hi`` does not count
  (an in-place update racing a snapshot's copy with two batches in
  flight would).
- **The mesh** (``shard`` / ``migrate``, ``parallel/mesh.Mesh``). On a
  mesh whose data rows sit on one physical device (a card's 1×1 mesh,
  the logical ``cpu:i`` meshes) the table stays one tensor with the same
  bytes, on that device. Across several cards the value rows are placed
  in data-axis row blocks (:class:`RowBlocks`, one block a data row's
  first device) and the state step reads and writes each block on its
  own device (``compile/statekernel.py``). ``migrate`` re-places every
  row from the host copy over the surviving rows, so no key loses its
  vector.
- **Routing by aligned blocks** (:meth:`KeyedStateTable.route`). The
  block pipeline aggregates a backed-up ring into multi-batch dispatches,
  and a kill or a delay changes that grouping between two lives of one
  stream. ``assign_slots`` settles the claims of one call's new keys in
  rounds over the call's sorted key hashes, and stamps the LRU clock once
  a call, so two keys that share a home slot could land in swapped slots,
  and an eviction pick another victim, when they first arrive in one
  dispatch in one life and in two in another. ``route`` calls
  ``assign_slots`` once per aligned block of ``block`` stream offsets
  (``offset // block``), each call its own LRU stamp, as if each block
  were a dispatch; where a later block of the dispatch claims a slot anew
  (an eviction), the records that an earlier block of it routed to that
  slot ride the scratch slot, since the claim would have wiped their
  folds. So the slots, and with the in-order fold of
  ``compile/statekernel.py`` the table's bytes, do not depend on the
  grouping. The JAX pipeline routes once per dispatch; the two agree
  wherever a dispatch is one block.

Keyed per-record session state, device-resident and dispatch-fused.

ROADMAP item 3: real per-user serving (sessionization, decayed
counters, frequency capping) needs temporal context per key, and a
host-side dict lookup per record would crater the ~1M rec/s hot path
by orders of magnitude. The state plane keeps the per-key state vector
in ONE device buffer and fuses lookup → derive-features → score →
state-update into the existing scoring dispatch
(compile/statekernel.py): zero per-record host round-trips, one
dispatch per batch, O(1) memory per key.

Division of labor — host routes, device accumulates:

- **Host mirror (this module).** Slot assignment is open addressing
  over a fixed-capacity table, keyed by the SAME ``stable_hash`` the
  rollout split and lane routing use (``partitioner.stable_hash_vec``
  is its bit-identical vectorized twin), so canary/shard routing and
  state routing agree on every key by construction. The key → slot
  map (hashes, occupancy, LRU touch) lives in host numpy — it is
  metadata exactly like the ring's offsets — and ``assign_slots``
  resolves a whole batch with vectorized probing: dedupe the batch's
  keys, probe a bounded linear window, claim empties, evict the
  least-recently-touched slot when the window is full. No device
  round trip is involved in routing.
- **Device values.** The table's VALUES — one fixed-width f32 vector
  per slot (counts, sums, decayed counters in product form, last-seen
  stride, min/max) — live in a single ``[rows, STATE_WIDTH]`` device
  buffer that only the fused kernel reads or writes, via gather +
  scatter-add/min/max over the batch's slot vector (O(batch), never
  O(capacity)). The buffer is DONATED to each dispatch, so the update
  is in-place: steady-state state memory is one buffer, not one per
  in-flight batch.

Decayed counters ride in **product form**: a record at stride
``t = offset // stride`` contributes ``λ^(epoch - t)`` (≥ 1) to the
decayed count column, and the decayed value *as of* stride ``t`` is
``column · λ^(t - epoch)`` — a pure scatter-ADD per record, so updates
are order-independent and replay-exact, with a rare O(capacity)
renormalization sweep when the exponent range grows (``maybe_renorm``)
instead of an O(capacity) decay multiply per batch. Time is a pure
function of the record OFFSET, never of wall clock or batch shape, so
a checkpoint-restored replay derives byte-identical state.

Exactly-once state under at-least-once delivery: the snapshot records
``applied_hi`` (the highest offset folded into the table). On restore,
replayed records below it route to the scratch slot (read zeros, write
nothing) — state updates apply exactly once per offset even though the
sink may see the records twice. Shed batches never dispatch; DLQ'd /
recovery-path records score through the stateless entries — neither
ever mutates the table (the never-delivered contract extended
to state).

Snapshots ride the checkpoints' atomic-writer discipline: values + host mirror
in one ``.npz`` sidecar beside the checkpoints (tmp → fsync →
``os.replace`` → dir fsync), referenced by name from the checkpoint
JSON; the record path inlines a base64 payload for small tables. The
last snapshot is also kept in memory: a dispatch error with a donated
state buffer poisons the buffer, and ``rollback()`` restores the
snapshot (bounded, counted loss — ``state_rollbacks``) so the ladder
can keep serving statelessly.

Sharding: rows are padded to a multiple of 256 and the buffer shards
over the mesh data axis (``NamedSharding``). Slot = hash % capacity
never changes, so a degraded-mesh rebuild (``migrate``) only re-places
rows across the survivors — every key keeps its slot and its state.
"""

from __future__ import annotations

import base64
import contextlib
import io
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np

import torch

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.parallel.partitioner import (
    stable_hash,
    stable_hash_vec,
)
from flink_jpmml_tpu_torch.utils.device import resolve_device
from flink_jpmml_tpu_torch.utils.exceptions import InputValidationException
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

# one fixed-width state vector per key; the column layout is the
# kernel ABI (compile/statekernel.py) and the snapshot format
STATE_WIDTH = 8
COL_COUNT = 0      # records seen (scatter-add 1)
COL_SUM = 1        # sum of scores
COL_SQSUM = 2      # sum of score^2
COL_DCOUNT = 3     # decayed count, product form (scatter-add λ^-rel)
COL_DSUM = 4       # decayed score sum, product form
COL_LAST_T = 5     # last-seen stride relative to epoch (scatter-max)
COL_MIN = 6        # min score (+inf until first)
COL_MAX = 7        # max score (-inf until first)

# names of the DERIVED feature vector the fused kernel returns per
# record (the drift plane baselines these — state corruption is a
# drift alarm on the derived stream)
DERIVED_FIELDS = (
    "state_count", "state_mean", "state_var", "state_decayed_count",
    "state_decayed_mean", "state_gap", "state_min", "state_max",
)

# sharding-friendly row padding: rows % 256 == 0 keeps the buffer
# divisible by any data-axis width the meshes use (and any degraded
# rebuild of them), so migrate() never has to reshape
_ROW_PAD = 256

_SNAPSHOT_VERSION = 1
_SNAPSHOT_KEEP = 3  # sidecar retention (the checkpoint writer keeps 3)
# payload-inline ceiling for the record path's checkpoint JSON: beyond
# this the table must snapshot to a sidecar file
_INLINE_CAP = 1 << 16


@dataclass(frozen=True)
class StateSpec:
    """Configuration of one keyed state table.

    ``key_col`` is the raw-batch column carrying the key on the block
    path (values are int-valued f32 — user/session ids); ``key_fn``
    extracts the key from a record on the record path (default: the
    ``key_field`` entry of a dict record). ``decay`` is the per-stride
    retention λ of the decayed counters — a record ``stride`` strides
    old weighs ``decay**strides``; one stride is ``stride`` record
    offsets, so decay half-lives are offset-denominated and replay
    deterministically."""

    capacity: int
    key_col: int = 0
    key_field: str = "key"
    key_fn: Optional[Callable[[Any], Any]] = None
    probe: int = 8
    decay: float = 0.999
    stride: int = 256

    def __post_init__(self):
        if self.capacity < 2:
            raise InputValidationException(
                f"state capacity must be >= 2: {self.capacity}"
            )
        if not (0.0 < self.decay < 1.0):
            raise InputValidationException(
                f"state decay must be in (0, 1): {self.decay}"
            )
        if self.probe < 1 or self.stride < 1:
            raise InputValidationException(
                "state probe and stride must be >= 1"
            )


_CAPACITY_ENV = "FJT_STATE_CAPACITY"
_PROBE_ENV = "FJT_STATE_PROBE"
_DECAY_ENV = "FJT_STATE_DECAY"
_STRIDE_ENV = "FJT_STATE_STRIDE"


def spec_from_env(capacity: int = 1 << 20, **overrides) -> StateSpec:
    """Build a :class:`StateSpec` from the ``FJT_STATE_*`` environment
    (bench/perf-smoke/fuzz sizing knobs; malformed values fall back to
    the defaults — tooling must not die on a typo'd env). Keyword
    overrides win over both."""

    def _env(name, cast, default):
        raw = os.environ.get(name)
        if raw:
            try:
                return cast(raw)
            except ValueError:
                pass
        return default

    kw = {
        "capacity": _env(_CAPACITY_ENV, int, capacity),
        "probe": _env(_PROBE_ENV, int, 8),
        "decay": _env(_DECAY_ENV, float, 0.999),
        "stride": _env(_STRIDE_ENV, int, 256),
    }
    kw.update(overrides)
    return StateSpec(**kw)


class KeyedStateTable:
    """Open-addressed device-resident per-key state (module docstring).

    One instance per pipeline; the score thread owns every call —
    single-threaded by the same contract as the ring."""

    def __init__(self, spec: StateSpec,
                 metrics: Optional[MetricsRegistry] = None,
                 device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.capacity = int(spec.capacity)
        self.rows = -(-(self.capacity + 1) // _ROW_PAD) * _ROW_PAD
        self.scratch = self.capacity  # the bypass/padding slot
        # renorm trigger: keep λ^rel comfortably inside f32 —
        # exp(30) ≈ 1e13 of headroom against ~1e38
        self._renorm_every = max(
            16, min(4096, int(30.0 / -math.log(spec.decay)))
        )
        self.metrics = metrics or MetricsRegistry()
        m = self.metrics
        self._c_records = m.counter("state_records")
        self._c_hits = m.counter("state_hits")
        self._c_inserts = m.counter("state_inserts")
        self._c_evictions = m.counter("state_evictions")
        self._c_collisions = m.counter("state_collisions")
        self._c_overflow = m.counter("state_overflow")
        self._c_bypass = m.counter("state_bypass_records")
        self._c_rollbacks = m.counter("state_rollbacks")
        self._g_resident = m.gauge("state_resident_keys")
        self._g_occupancy = m.gauge("state_occupancy_frac")
        self._g_hit_ratio = m.gauge("state_hit_ratio")
        # host mirror (routing metadata; never shipped per batch)
        self._keys = np.zeros(self.capacity, np.uint32)
        self._occ = np.zeros(self.capacity, bool)
        self._touch = np.zeros(self.capacity, np.int64)
        self._seq = 0
        self.resident = 0
        self.epoch = 0          # decay epoch, in strides
        self.applied_hi = 0     # exactly-once high-water (offsets)
        self.skip_until = 0     # restore sets: replayed offsets below
        # bypass the table (their updates already applied pre-crash)
        # device values; ``_ready`` is the event behind the step that
        # wrote them (None: nothing in flight)
        self.values = torch.zeros((self.rows, STATE_WIDTH),
                                  dtype=torch.float32, device=self.device)
        self._ready = _event_behind(self.values)
        # the mesh the value rows are placed over (None: one device)
        self._mesh = None
        self._bypass_depth = 0
        # in-memory rollback point (init = empty table)
        self._snap: Dict[str, Any] = self._host_snapshot()
        # drift shims per model label (one handle set per model+table)
        self._shims: Dict[str, Any] = {}

    # -- bypass ------------------------------------------------------------

    @property
    def bypassed(self) -> bool:
        """Is the table inside a stateless-scoring window (recovery
        redispatch, poison bisection)? Armed call sites check this and
        score through the stateless entries instead."""
        return self._bypass_depth > 0

    @contextlib.contextmanager
    def bypass(self):
        """Scope a stateless-scoring window: dispatches inside never
        touch the table (the recovery ladder and poison bisection both
        replay records — their scores must not double-apply state)."""
        self._bypass_depth += 1
        try:
            yield
        finally:
            self._bypass_depth -= 1

    # -- routing -----------------------------------------------------------

    def hash_keys(self, keys: np.ndarray) -> np.ndarray:
        """int64 keys → uint32 stable hashes (the lane-routing hash)."""
        return stable_hash_vec(np.asarray(keys, np.int64))

    def hash_records(self, records) -> np.ndarray:
        """Record-path twin: ``spec.key_fn`` (or the ``key_field`` of
        dict records) per record → uint32 stable hashes."""
        fn = self.spec.key_fn
        if fn is None:
            f = self.spec.key_field
            fn = lambda r: r.get(f, 0) if isinstance(r, dict) else r
        out = np.empty(len(records), np.uint32)
        for i, r in enumerate(records):
            out[i] = stable_hash(fn(r)) & 0xFFFFFFFF
        return out

    def extract_keys(self, X: np.ndarray) -> np.ndarray:
        """Block-path key column of a raw f32 batch → int64 keys."""
        col = np.asarray(X)[:, self.spec.key_col]
        return col.astype(np.int64)

    def route(self, khash: np.ndarray, offsets, block: Optional[int]):
        """:meth:`assign_slots` once per aligned block of ``block`` stream
        offsets (``offset // block``) of one dispatch → the same
        ``(slots, reset, rel, w)`` for the whole dispatch, in which a
        record whose slot a later block claims anew is bypassed (scratch
        slot, zero weight). ``offsets`` None, or ``block`` None or < 1,
        route the dispatch in one call."""
        offs = None if offsets is None else np.asarray(offsets, np.int64)
        if offs is None or not block or block < 1 or offs.size <= 1:
            return self.assign_slots(khash, offs)
        cut = np.flatnonzero(np.diff(offs // int(block)) != 0) + 1
        if not cut.size:
            return self.assign_slots(khash, offs)
        khash = np.asarray(khash, np.uint32)
        parts = [self.assign_slots(k, o) for k, o in
                 zip(np.split(khash, cut), np.split(offs, cut))]
        slots, reset, rel, w = (np.concatenate(c) for c in zip(*parts))
        # the last block of the dispatch that claimed each claimed slot;
        # a record of an earlier block on that slot is superseded
        blk = np.repeat(np.arange(len(parts)), np.diff(np.r_[0, cut,
                                                               offs.size]))
        claimed = reset & (slots != self.scratch)
        if claimed.any():
            u, inv = np.unique(slots[claimed], return_inverse=True)
            last = np.full(u.size, -1)
            np.maximum.at(last, inv, blk[claimed])
            at = np.minimum(np.searchsorted(u, slots), u.size - 1)
            gone = (u[at] == slots) & (blk < last[at])
            if gone.any():
                slots[gone] = self.scratch
                reset[gone] = False
                rel[gone] = 0.0
                w[gone] = 0.0
        return slots, reset, rel, w

    def assign_slots(self, khash: np.ndarray, offsets=None):
        """Resolve one batch of key hashes to table slots (host-side,
        vectorized — the only per-batch routing cost).

        → ``(slots int32[B], reset bool[B], rel f32[B], w f32[B])``:
        ``slots`` are value-buffer rows (``scratch`` for bypassed
        records), ``reset`` marks slots whose key is fresh this batch
        (the kernel re-initializes them before the gather), ``rel`` is
        the record's decay stride relative to the epoch and ``w`` its
        product-form weight λ^-rel. Replayed offsets below
        ``skip_until`` bypass (exactly-once state)."""
        khash = np.asarray(khash, np.uint32)
        B = khash.shape[0]
        self._seq += 1
        seq = self._seq
        if offsets is None:
            offs = np.arange(self.applied_hi, self.applied_hi + B,
                             dtype=np.int64)
        else:
            offs = np.asarray(offsets, np.int64)
        apply = offs >= self.skip_until
        n_bypass = int(B - apply.sum())
        rel_t = (offs // self.spec.stride) - self.epoch
        slots = np.full(B, self.scratch, np.int32)
        reset = np.zeros(B, bool)
        if apply.any():
            uk, inv = np.unique(khash[apply], return_inverse=True)
            nu = uk.shape[0]
            base = uk.astype(np.int64) % self.capacity
            slot_u = np.full(nu, -1, np.int64)
            reset_u = np.zeros(nu, bool)
            keys_h, occ, touch = self._keys, self._occ, self._touch
            collided = 0
            for p in range(self.spec.probe):
                pending = slot_u < 0
                if not pending.any():
                    break
                cand = (base + p) % self.capacity
                hit = pending & occ[cand] & (keys_h[cand] == uk)
                slot_u[hit] = cand[hit]
                # stamp at hit/claim time, not batch end: the evict
                # round must see THIS batch's slots as untouchable
                touch[cand[hit]] = seq
                pending &= ~hit
                empty = pending & ~occ[cand]
                idx = np.flatnonzero(empty)
                if idx.size:
                    # one claimant per empty slot per round (np.unique
                    # keeps the first); losers keep probing
                    _, first = np.unique(cand[idx], return_index=True)
                    win = idx[first]
                    c = cand[win]
                    slot_u[win] = c
                    occ[c] = True
                    keys_h[c] = uk[win]
                    touch[c] = seq
                    reset_u[win] = True
                    self.resident += win.size
                    self._c_inserts.inc(win.size)
                if p == 0:
                    # catalogue semantic: home slot held by a DIFFERENT
                    # key — a fresh key claiming its empty home slot is
                    # not a collision, so count after the claim round
                    collided = int((slot_u < 0).sum())
            pend = np.flatnonzero(slot_u < 0)
            if pend.size:
                # probe window exhausted: evict the least-recently-
                # touched slot in each key's window — but never one
                # touched THIS batch (another key just landed there);
                # keys that lose the eviction race overflow to scratch
                W = (base[pend, None]
                     + np.arange(self.spec.probe)[None, :]) % self.capacity
                t = touch[W]
                vic = W[np.arange(pend.size), np.argmin(t, axis=1)]
                fresh_vic = touch[vic] < seq
                _, first = np.unique(vic, return_index=True)
                winner = np.zeros(pend.size, bool)
                winner[first] = True
                winner &= fresh_vic
                win = pend[winner]
                c = vic[winner]
                if win.size:
                    keys_h[c] = uk[win]
                    touch[c] = seq
                    slot_u[win] = c
                    reset_u[win] = True
                    self._c_evictions.inc(win.size)
                lost = int(pend.size - win.size)
                if lost:
                    self._c_overflow.inc(lost)
            assigned = slot_u >= 0
            slot_r = np.where(assigned, slot_u, np.int64(self.scratch))
            slots[apply] = slot_r[inv].astype(np.int32)
            reset[apply] = reset_u[inv]
            hits = int(
                (apply & (slots != self.scratch) & ~reset).sum()
            )
            self._c_hits.inc(hits)
            self._c_collisions.inc(collided)
            hi = int(offs[apply].max()) + 1
            if hi > self.applied_hi:
                self.applied_hi = hi
        self._c_records.inc(B)
        if n_bypass:
            self._c_bypass.inc(n_bypass)
        self._g_resident.set(float(self.resident))
        self._g_occupancy.set(self.resident / float(self.capacity))
        rec = self._c_records.value
        self._g_hit_ratio.set(
            self._c_hits.value / rec if rec else 0.0
        )
        rel = np.where(apply, rel_t, 0).astype(np.float32)
        w = np.power(
            np.float32(self.spec.decay), -rel, dtype=np.float32
        )
        w = np.where(apply, w, np.float32(0.0)).astype(np.float32)
        return slots, reset, rel, w

    def maybe_renorm(self, first_off: int) -> None:
        """Advance the decay epoch when the product-form exponents
        approach f32 range: multiply the decayed columns by λ^Δ and
        shift the last-seen strides by Δ (one O(capacity) device op,
        once per ``renorm_every`` strides — never per batch)."""
        t_first = int(first_off) // self.spec.stride
        delta = t_first - self.epoch
        if delta < self._renorm_every:
            return
        mul = np.ones(STATE_WIDTH, np.float32)
        mul[COL_DCOUNT] = mul[COL_DSUM] = np.float32(
            self.spec.decay
        ) ** np.float32(delta)
        add = np.zeros(STATE_WIDTH, np.float32)
        add[COL_LAST_T] = -np.float32(delta)
        from flink_jpmml_tpu_torch.compile import statekernel

        self.wait_ready()
        self.values = statekernel.renorm(self.values, mul, add)
        self._ready = _event_behind(self.values)
        self.epoch = t_first
        flight.record(
            "state_renorm", epoch=self.epoch, delta=delta,
        )

    # -- dispatch plumbing -------------------------------------------------

    def commit(self, new_values) -> None:
        """Adopt the fused dispatch's updated state tensor (a new one:
        the step writes out of place). It may still be computing — the
        next dispatch's step reads it after it on the same stream, and a
        snapshot waits on the event recorded here."""
        self.values = new_values
        self._ready = _event_behind(new_values)

    def rollback(self) -> None:
        """Restore the last snapshot after a dispatch error poisoned
        the donated state buffer (bounded loss back to the snapshot;
        subsequent records re-enter cleanly)."""
        self._c_rollbacks.inc()
        snap = self._snap
        self._keys = snap["keys"].copy()
        self._occ = snap["occ"].copy()
        self._touch = snap["touch"].copy()
        self.resident = int(snap["resident"])
        self.epoch = int(snap["epoch"])
        self.applied_hi = int(snap["applied_hi"])
        self.skip_until = max(self.skip_until, self.applied_hi)
        self._set_values(snap["values"])
        flight.record(
            "state_rollback", applied_hi=self.applied_hi,
            resident=self.resident,
        )

    # -- sharding / migration ---------------------------------------------

    def shard(self, mesh) -> None:
        """Place the value rows over the mesh data axis (module
        docstring); ``mesh=None`` is a no-op."""
        if mesh is None:
            return
        host = self.host_values()
        self._mesh = mesh
        self._set_values(host)

    def migrate(self, new_mesh) -> None:
        """Degraded-rebuild hook: re-place every row across the surviving
        chips from the host copy (the old placement may reference lost
        devices). Slot = hash % capacity is mesh-independent, so chip
        loss moves state WITH its keys — no key loses its state
        vector."""
        if new_mesh is None:
            return
        from flink_jpmml_tpu_torch.parallel.mesh import DATA_AXIS

        self.shard(new_mesh)
        flight.record(
            "state_migrate",
            data=int(new_mesh.shape.get(DATA_AXIS, 1)),
            resident=self.resident,
        )

    def _block_devices(self):
        """The data rows' first devices, one a block, when the mesh's data
        rows span more than one physical device; else None (one tensor)."""
        if self._mesh is None:
            return None
        from flink_jpmml_tpu_torch.parallel.mesh import DATA_AXIS, physical

        devs = [physical(self._mesh.devices[r, 0])
                for r in range(self._mesh.shape[DATA_AXIS])]
        if len(set(devs)) > 1:
            return devs
        self.device = devs[0]
        return None

    def _set_values(self, host: np.ndarray) -> None:
        """Host f32 rows → the values on the table's device, or in row
        blocks over the mesh's data devices."""
        host = np.ascontiguousarray(host, np.float32)
        devs = self._block_devices()
        if devs is None:
            self.values = torch.from_numpy(host).to(self.device)
        else:
            self.values = RowBlocks.place(host, devs)
        self._ready = _event_behind(self.values)

    def wait_ready(self) -> None:
        """Order the current streams after the work that wrote the values
        (they may have been written on another stream: the constructor's,
        a restore's); no host wait, and a no-op on the CPU."""
        for dev, ev in self._ready or ():
            torch.cuda.current_stream(dev).wait_event(ev)

    def host_values(self) -> np.ndarray:
        """The committed values on the host, after the step that wrote
        them has finished."""
        for _, ev in self._ready or ():
            ev.synchronize()
        if isinstance(self.values, RowBlocks):
            return self.values.host()
        return self.values.detach().cpu().numpy()

    # -- snapshots ---------------------------------------------------------

    def _host_snapshot(self) -> Dict[str, Any]:
        return {
            "version": _SNAPSHOT_VERSION,
            "capacity": self.capacity,
            "keys": self._keys.copy(),
            "occ": self._occ.copy(),
            "touch": self._touch.copy(),
            "resident": self.resident,
            "epoch": self.epoch,
            "applied_hi": self.applied_hi,
            "seq": self._seq,
            "values": self.host_values().copy(),
        }

    def snapshot(self) -> Dict[str, Any]:
        """Materialize a consistent host snapshot (blocks on in-flight
        device updates — called on the score thread between batches)
        and pin it as the in-memory rollback point."""
        snap = self._host_snapshot()
        self._snap = snap
        return snap

    def save_sidecar(self, directory: str) -> Optional[str]:
        """Write the snapshot beside the checkpoints with the atomic-
        writer discipline (tmp → fsync → replace → dir fsync) →
        sidecar filename, or None when the write failed (checkpointing
        must degrade, not kill serving)."""
        snap = self.snapshot()
        name = f"state-{snap['applied_hi']:020d}.npz"
        path = os.path.join(directory, name)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            os.makedirs(directory, exist_ok=True)
            with open(tmp, "wb") as f:
                np.savez(f, **_npz_payload(snap))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            dfd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        self._gc_sidecars(directory, keep=name)
        return name

    @staticmethod
    def _gc_sidecars(directory: str, keep: str) -> None:
        try:
            snaps = sorted(
                f for f in os.listdir(directory)
                if f.startswith("state-") and f.endswith(".npz")
            )
        except OSError:
            return
        for f in snaps[:-_SNAPSHOT_KEEP]:
            if f != keep:
                try:
                    os.unlink(os.path.join(directory, f))
                except OSError:
                    pass

    def restore_sidecar(self, directory: str, name: str) -> bool:
        path = os.path.join(directory, name)
        try:
            with np.load(path) as z:
                snap = _from_npz(z)
        except (OSError, ValueError, KeyError):
            flight.record("state_restore_missing", file=name)
            return False
        return self._adopt_snapshot(snap)

    def to_payload(self) -> Dict[str, Any]:
        """Inline base64 snapshot for the record path's checkpoint
        JSON (small tables only — the block path uses sidecar files)."""
        if self.capacity > _INLINE_CAP:
            raise InputValidationException(
                f"state capacity {self.capacity} too large to inline "
                f"in a checkpoint (cap {_INLINE_CAP}); use a sidecar"
            )
        buf = io.BytesIO()
        np.savez(buf, **_npz_payload(self.snapshot()))
        return {
            "version": _SNAPSHOT_VERSION,
            "npz_b64": base64.b64encode(buf.getvalue()).decode("ascii"),
        }

    def from_payload(self, payload: Dict[str, Any]) -> bool:
        raw = payload.get("npz_b64")
        if not raw:
            return False
        try:
            with np.load(io.BytesIO(base64.b64decode(raw))) as z:
                snap = _from_npz(z)
        except (ValueError, KeyError):
            return False
        return self._adopt_snapshot(snap)

    def _adopt_snapshot(self, snap: Dict[str, Any]) -> bool:
        """→ False when the snapshot is refused (geometry mismatch):
        the caller must know the table stayed as it was — a True from
        a restore that silently no-opped would let replay double-fold
        decisions ride an empty table unnoticed."""
        if int(snap["capacity"]) != self.capacity:
            flight.record(
                "state_restore_mismatch",
                snapshot=int(snap["capacity"]), table=self.capacity,
            )
            return False
        self._keys = snap["keys"].astype(np.uint32)
        self._occ = snap["occ"].astype(bool)
        self._touch = snap["touch"].astype(np.int64)
        self.resident = int(snap["resident"])
        self.epoch = int(snap["epoch"])
        self._seq = int(snap.get("seq", 0))
        self.applied_hi = int(snap["applied_hi"])
        # exactly-once: replayed offsets below the snapshot's
        # high-water were already folded in — bypass them
        self.skip_until = self.applied_hi
        values = snap["values"].astype(np.float32)
        if values.shape != (self.rows, STATE_WIDTH):
            # snapshot from a different row padding: re-pad
            v = np.zeros((self.rows, STATE_WIDTH), np.float32)
            n = min(values.shape[0], self.rows)
            v[:n] = values[:n]
            values = v
        self._set_values(values)
        self._snap = self._host_snapshot()
        self._g_resident.set(float(self.resident))
        self._g_occupancy.set(self.resident / float(self.capacity))
        flight.record(
            "state_restore", applied_hi=self.applied_hi,
            resident=self.resident,
        )
        return True

    # -- drift on derived features ----------------------------------------

    def drift_shim(self, model_hash: Optional[str]):
        """A ``record_features``-compatible handle for the DERIVED
        feature stream: ``<model_hash>#state`` shares the model's
        content addressing, so a recompile keeps the same baseline
        and state corruption surfaces as feature drift."""
        label = f"{model_hash or 'state'}#state"
        shim = self._shims.get(label)
        if shim is None:
            shim = _DriftShim(label)
            self._shims[label] = shim
        return shim


class _DerivedWire:
    """Minimal wire facade over the derived feature vector: names for
    the drift handles, cut-less domains (derived features have no
    threshold tables — out-of-domain never fires)."""

    fields = DERIVED_FIELDS
    cuts = [[] for _ in DERIVED_FIELDS]


class _DriftShim:
    __slots__ = ("model_hash", "wire")

    def __init__(self, label: str):
        self.model_hash = label
        self.wire = _DerivedWire()


class RowBlocks:
    """The value rows in data-axis row blocks: block ``b`` holds rows
    ``bounds[b]`` on its data row's first device (the last block may be
    shorter, so any data width divides)."""

    __slots__ = ("bounds", "blocks")

    def __init__(self, bounds, blocks):
        self.bounds = tuple(bounds)
        self.blocks = list(blocks)

    @classmethod
    def place(cls, host: np.ndarray, devices) -> "RowBlocks":
        step = -(-host.shape[0] // len(devices))
        bounds = [(min(b * step, host.shape[0]),
                   min((b + 1) * step, host.shape[0]))
                  for b in range(len(devices))]
        return cls(bounds, [torch.from_numpy(host[lo:hi]).to(d)
                            for (lo, hi), d in zip(bounds, devices)])

    @property
    def shape(self):
        return (self.bounds[-1][1], STATE_WIDTH)

    def host(self) -> np.ndarray:
        return np.concatenate(
            [b.detach().cpu().numpy() for b in self.blocks])


def _event_behind(values):
    """(device, event) pairs recorded on each CUDA device's current stream
    behind the work that writes ``values`` (None on the CPU, where that
    work is done)."""
    tensors = values.blocks if isinstance(values, RowBlocks) else [values]
    evs = []
    for t in tensors:
        if t.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            evs.append((t.device, ev))
    return evs or None


def _npz_payload(snap: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {
        "version": np.int64(snap["version"]),
        "capacity": np.int64(snap["capacity"]),
        "keys": snap["keys"],
        "occ": snap["occ"],
        "touch": snap["touch"],
        "resident": np.int64(snap["resident"]),
        "epoch": np.int64(snap["epoch"]),
        "applied_hi": np.int64(snap["applied_hi"]),
        "seq": np.int64(snap["seq"]),
        "values": snap["values"],
    }


def _from_npz(z) -> Dict[str, Any]:
    return {
        "version": int(z["version"]),
        "capacity": int(z["capacity"]),
        "keys": z["keys"],
        "occ": z["occ"],
        "touch": z["touch"],
        "resident": int(z["resident"]),
        "epoch": int(z["epoch"]),
        "applied_hi": int(z["applied_hi"]),
        "seq": int(z["seq"]),
        "values": z["values"],
    }


def is_state_output(out) -> bool:
    """Is ``out`` a fused-state dispatch result ``(score_out,
    derived)``? Unambiguous: a regression score is 1-D, a
    classification output is a 3-tuple — never a 2-tuple whose second
    element is a ``[B, STATE_WIDTH]`` matrix."""
    return (
        type(out) is tuple
        and len(out) == 2
        and getattr(out[1], "ndim", 0) == 2
        and out[1].shape[-1] == STATE_WIDTH
        and (type(out[0]) is tuple or getattr(out[0], "ndim", 0) == 1)
    )


def split_output(out):
    """→ ``(score_out, derived_or_None)``."""
    if is_state_output(out):
        return out[0], out[1]
    return out, None


def record_derived(dplane, table: KeyedStateTable,
                   model_hash: Optional[str], derived, n: int) -> None:
    """Feed one batch's derived session features to the drift plane
    (sampled + budgeted inside ``record_features`` — the D2H fetch
    happens only for claimed batches)."""
    if dplane is None or derived is None or not n:
        return
    shim = table.drift_shim(model_hash)
    if isinstance(derived, torch.Tensor):
        derived = derived.detach().cpu().numpy()
    try:
        dplane.record_features(shim, np.asarray(derived)[:n], None)
    except Exception:
        pass  # observability must never kill delivery
