"""Cross-model packing: one device dispatch scoring a batch that spans N
tenants' models (the multi-tenant zoo fast path).

The port of ``flink_jpmml_tpu/compile/packs.py``. The knobs
(``FJT_PACK_MAX``, ``FJT_PACK_MEMBER_BYTES``), ``param_bytes``,
``model_set_hash``, the packed input buffer and ``assemble`` are the JAX
module's. What differs is which members ride a pack and how they score:

- **Eligible members.** The JAX package packs only ``"xla"`` members: a
  Pallas member bakes its own grid into its program. The port packs both
  of its backends. ``"cuda"`` members (and ``"cuda_plain"`` on the CPU)
  score in ONE launch of the walk kernel over all of them
  (``qtrees_cuda.leaf_rows_packed``: a block of the grid is a (member,
  row block) pair, and each block walks its member's own table over the
  same tree order as the member's solo launch), then each member's own
  epilogue (Targets, or the vote argmax). ``"torch"`` members (uint16
  wires, max / median aggregates, the rest) score through their own
  ``qfn`` on their own slot, in the same dispatch, on the same stream —
  as every JAX member does. A ``wirepack`` layout still makes a member
  ineligible (its staged wire is not rank codes).
- **Byte identity with solo dispatch.** Every member's output equals its
  solo ``predict_wire`` byte for byte: a ``"cuda"`` member's sums do not
  depend on the launch shape or on the other members, and a ``"torch"``
  member runs the same ops at the same shapes on the same operands. This
  holds against the port's own solo dispatch; against the JAX package a
  member is held at the rank wire's tolerance (the kernel sums trees in
  another order than the XLA ``qfn``).
- **No fall-back.** A pack never scores its ``"cuda"`` members with
  launches of their own. A mix the packed launch cannot take (its
  shared-memory need at the smallest block over the block's limit,
  ``qtrees_cuda.packed_shape``) raises at build, and the zoo serves that
  group solo.

Design, as in the JAX module: one staged array ``Xp[N, B, F_max]`` in the
widest member wire dtype; slot ``i`` holds tenant ``i``'s rank-encoded
rows, zero-padded as the solo path pads them; a uint8 member's codes
widen exactly into a uint16 buffer and narrow back exactly (codes and the
sentinel 255 fit a byte). Member tables are shared with the solo scorers;
a pack adds only its staging and the launch. Which models share a buffer
is the layout decision of ``autotune.ensure_pack_plan`` (cached per
model-set hash), and ``serving/zoo.py`` owns pack residency.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile import qtrees_cuda
from flink_jpmml_tpu_torch.obs import profiler as prof_mod

# hard cap on members per pack regardless of what a plan says
_PACK_MAX_ENV = "FJT_PACK_MAX"
_PACK_MAX_DEFAULT = 16
# per-member param-bytes ceiling for pack eligibility: packing exists for
# SMALL models (launch-bound); a flagship 500-tree GBM fills the card on
# its own and serves better solo
_PACK_MEMBER_BYTES_ENV = "FJT_PACK_MEMBER_BYTES"
_PACK_MEMBER_BYTES_DEFAULT = 8 * 1024 * 1024
# the port's two backends that a pack can score (cuda_plain: the
# kernel's plain version on the CPU)
_PACKABLE = frozenset(("cuda", "cuda_plain", "torch"))


def pack_max() -> int:
    try:
        return max(2, int(os.environ.get(_PACK_MAX_ENV)
                          or _PACK_MAX_DEFAULT))
    except ValueError:
        return _PACK_MAX_DEFAULT


def member_bytes_cap() -> int:
    try:
        return int(os.environ.get(_PACK_MEMBER_BYTES_ENV)
                   or _PACK_MEMBER_BYTES_DEFAULT)
    except ValueError:
        return _PACK_MEMBER_BYTES_DEFAULT


def param_bytes(scorer) -> int:
    """Size of a scorer's param tables (the zoo manager's residency
    accounting unit). Memoized on the scorer."""
    cached = getattr(scorer, "_param_bytes", None)
    if cached is not None:
        return cached
    total = 0
    try:
        for v in scorer.params.values():
            nb = getattr(v, "nbytes", None)
            if nb is not None:
                total += int(nb)
    except Exception:
        pass
    try:
        scorer._param_bytes = total
    except Exception:
        pass
    return total


def pack_eligible(scorer) -> bool:
    """Can this scorer ride a cross-model pack? A ``"cuda"`` /
    ``"cuda_plain"`` / ``"torch"`` rank-wire scorer with its pack info,
    the reference (unpacked) wire, a fixed batch and tables under
    ``FJT_PACK_MEMBER_BYTES``. Fused-encode members qualify: the pack
    always host-encodes (the byte-parity oracle)."""
    if scorer is None:
        return False
    cap = member_bytes_cap()
    memo = getattr(scorer, "_pack_memo", None)
    if memo is not None and memo[0] == cap:
        return memo[1]
    ok = (
        bool(getattr(scorer, "_pack_info", None))
        and getattr(scorer, "backend", "") in _PACKABLE
        and getattr(scorer, "_wire_pack", None) is None
        and scorer.batch_size is not None
        and param_bytes(scorer) <= cap
    )
    try:
        scorer._pack_memo = (cap, ok)
    except Exception:
        pass
    return ok


def model_set_hash(hashes: Sequence[str]) -> str:
    """Stable identity of a model MULTISET (tenants may share one
    document): the autotune pack-plan cache key half. Sorted so tenant
    arrival order cannot split the cache; a tenant add/remove changes the
    hash and therefore invalidates the adopted layout."""
    h = hashlib.sha256()
    for mh in sorted(str(x) for x in hashes):
        h.update(mh.encode())
        h.update(b"|")
    return h.hexdigest()[:16]


class PackedScorer:
    """One packed dispatch over a fixed member list.

    ``members`` are live ``QuantizedScorer``\\ s on one device sharing one
    compile batch size ``B``; ``keys`` are the tenants' serving labels.
    The packed input is ``Xp[N, B, F_max]`` in :attr:`in_dtype`;
    :meth:`assemble` routes per-member encoded rows into their slots and
    :meth:`dispatch` scores them all: one launch of the walk kernel for
    the ``"cuda"`` members, each ``"torch"`` member's ``qfn``. Member
    ``i``'s output is byte-identical to its solo ``predict_wire`` on the
    same rows (module docstring)."""

    def __init__(self, members: Sequence, keys: Sequence[str]):
        if not members:
            raise ValueError("empty pack")
        self.members = list(members)
        self.keys = [str(k) for k in keys]
        sizes = {m.batch_size for m in self.members}
        if len(sizes) != 1 or None in sizes:
            raise ValueError(f"pack members disagree on batch size: {sizes}")
        devices = {m.device for m in self.members}
        if len(devices) != 1:
            raise ValueError(f"pack members on several devices: {devices}")
        self.device = next(iter(devices))
        self.B = int(next(iter(sizes)))
        infos = [m._pack_info for m in self.members]
        if any(not i for i in infos):
            raise ValueError("pack member without _pack_info")
        self._infos = infos
        self.F_max = max(int(i["fields"]) for i in infos)
        self.in_dtype = (
            np.uint16 if any(i["dtype"] is np.uint16 for i in infos)
            else np.uint8
        )
        self._params = tuple(m.params for m in self.members)
        # the identity the sampled profiler and the cost ledger book a
        # packed launch under
        self.model_hash = "pack-" + model_set_hash(
            [m.model_hash for m in self.members])
        self.backend = "packed"
        self._cuda = [j for j, i in enumerate(infos) if i["route"] == "cuda"]
        self._torch = [j for j, i in enumerate(infos) if i["route"] != "cuda"]
        # the kernel members' tables and launch shapes, as they stand now
        self._tables = [infos[j]["tables"] for j in self._cuda]
        self._fields = [int(infos[j]["fields"]) for j in self._cuda]
        self._launches = [infos[j]["launch"] for j in self._cuda]
        self._fk = max(self._fields, default=0)
        # the packed buffer is the kernel's codes as it stands
        self._whole = (not self._torch and self.in_dtype is np.uint8
                       and self._fk == self.F_max)
        if self._cuda:
            # refuses a mix the packed launch cannot take (ValueError):
            # one whose smallest block's shared memory is over the limit,
            # whatever rows a dispatch brings
            qtrees_cuda.packed_shape([
                (f, t["walk"].shape[0], t["walk"].shape[1], *ln)
                for f, t, ln in zip(self._fields, self._tables,
                                    self._launches)],
                [self.B] * len(self._cuda),
                max(t["rows"].shape[2] for t in self._tables))

    @property
    def n_members(self) -> int:
        return len(self.members)

    @property
    def buffer_bytes(self) -> int:
        """Bytes of one staged packed input buffer."""
        return (
            self.n_members * self.B * self.F_max
            * np.dtype(self.in_dtype).itemsize
        )

    @property
    def resident_bytes(self) -> int:
        """Residency accounting for the zoo manager: the staging buffer
        plus the member tables this pack keeps referenced."""
        return self.buffer_bytes + sum(
            param_bytes(m) for m in self.members
        )

    def pad_waste(self) -> float:
        """Fraction of the shared input buffer that is padding."""
        used = sum(
            self.B * int(i["fields"]) * np.dtype(i["dtype"]).itemsize
            for i in self._infos
        )
        total = self.buffer_bytes
        return 1.0 - used / total if total else 0.0

    def new_buffer(self) -> np.ndarray:
        return np.zeros(
            (self.n_members, self.B, self.F_max), self.in_dtype
        )

    def assemble(
        self,
        rows: Dict[int, np.ndarray],
        out: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, int]:
        """Route per-member encoded rows into their slots.

        ``rows[i]`` is member ``i``'s rank-encoded batch (its OWN wire
        dtype, ≤ B rows); absent members keep an all-zero slot. →
        ``(Xp, n_rows_total)``."""
        Xp = out if out is not None else self.new_buffer()
        total = 0
        for i, Xq in rows.items():
            n = Xq.shape[0]
            if n > self.B:
                raise ValueError(
                    f"member {i} rows {n} exceed pack slot {self.B}"
                )
            Xp[i, :n, : Xq.shape[1]] = Xq  # exact widening cast
            total += n
        return Xp, total

    def dispatch(self, Xp, rows: Optional[Sequence[int]] = None):
        """One dispatch for all members → tuple of member outputs, each
        exactly what the member's solo ``predict_wire`` returns for its
        slot. ``Xp`` is the packed buffer (numpy, or a tensor already on
        the pack's device); on the card the work queues on the current
        stream. ``rows`` (None: B each) are the live rows a member has:
        a ``"cuda"`` member scores only those (its output has that many
        rows; a member with none is not walked), a ``"torch"`` member
        always its whole slot, as its solo dispatch does."""
        if isinstance(Xp, np.ndarray):
            Xp = torch.from_numpy(np.ascontiguousarray(Xp))
        Xp = Xp.to(self.device)
        rows = [self.B] * self.n_members if rows is None else list(rows)
        outs: List[object] = [None] * self.n_members
        # a sampled dispatch's region: the packed launch and every
        # member's epilogue and qfn, on codes on the device
        prof_mod.mark_start(self.device)
        with torch.no_grad():
            if self._cuda:
                if self._whole:
                    codes = Xp  # every slot a kernel member's, uint8
                else:
                    # the kernel members' slots, narrowed to their widest
                    # fields; a uint16 buffer narrows exactly (codes ≤ 255)
                    codes = torch.stack([
                        Xp[j, :, : self._fk].to(torch.uint8)
                        for j in self._cuda])
                sums = qtrees_cuda.leaf_rows_packed(
                    codes.contiguous(), [rows[j] for j in self._cuda],
                    self._tables, self._fields, self._launches)
                for j, s in zip(self._cuda, sums):
                    outs[j] = self._infos[j]["epilogue"](s)
            for j in self._torch:
                info = self._infos[j]
                f = int(info["fields"])
                Xi = Xp[j, :, :f].to(_TORCH_DTYPE[np.dtype(info["dtype"])])
                outs[j] = info["qfn"](self._params[j], Xi)
        prof_mod.mark_stop(self.device)
        return tuple(outs)

    def dispatch_state(self, Xp, table, slots, rel, w, reset,
                       member: int = 0):
        """State-armed dispatch: every member scores exactly as
        :meth:`dispatch` and the designated ``member``'s value stream
        folds through the keyed state table → ``(outs, derived, S')``; the
        caller commits ``S'`` (``statekernel.packed_entry``)."""
        from flink_jpmml_tpu_torch.compile import statekernel

        return statekernel.packed_entry(self, member)(
            Xp, table, slots, rel, w, reset)

    def warmup(self) -> float:
        """The pack's cold-start cost: one dispatch of an all-zero buffer
        (on the card it builds the kernel library on first use) →
        seconds spent."""
        t0 = time.monotonic()
        self.dispatch(self.new_buffer())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic() - t0


_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.uint16): torch.uint16}


def build_pack(members: Sequence, keys: Sequence[str]) -> PackedScorer:
    """Validated constructor: every member must be :func:`pack_eligible`
    and the pack no larger than :func:`pack_max`; a mix the packed launch
    cannot take raises ValueError too."""
    for m in members:
        if not pack_eligible(m):
            raise ValueError(
                "pack member not eligible for cross-model packing"
            )
    if len(members) > pack_max():
        raise ValueError(
            f"pack size {len(members)} exceeds FJT_PACK_MAX={pack_max()}"
        )
    return PackedScorer(members, keys)
