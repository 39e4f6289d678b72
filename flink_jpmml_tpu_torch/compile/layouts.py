"""Kernel layout catalogue for the quantized tree fast path.

The port of ``flink_jpmml_tpu/compile/layouts.py``. The numpy code is a
copy with the import lines renamed (``bfs_split_order``,
``apply_split_order``, ``bfs_order``, ``WirePack``, ``plan_wire_pack``,
``pack_partitions``, ``pack_pad_waste``); ``WirePack.unpack_stage`` is
plain torch on the scorer's device instead of an XLA stage. The
catalogue follows the port's backends, not the Pallas tiles:

- **``cuda``** (``qtrees_leaf_rows``, ``csrc/qtrees_ensemble.cu``):
  layouts ``ref`` and ``bfs``. ``bfs`` renumbers the nodes inside each
  tree's slice of the ``walk`` table (``qtrees_cuda._pack_walk``) in
  breadth-first order: the root is node 1, the splits of each level
  follow, and the leaves follow in the order the walk reaches them, their
  rows permuted with them. The walk reaches the same leaf with the same
  row, so the sums are bit-identical; what changes is where a warp's
  lanes find the top levels of a tree in shared memory. The other axis of
  the search is the kernel's launch shape, ``(threads, chunk_bytes)``:
  threads per block and the bytes of tree tables per shared-memory
  buffer (``qtrees_cuda.launch_shape``). ``mega`` has no CUDA variant:
  the kernel already loops over chunks of trees inside one launch, which
  is what the Pallas megakernel fuses.
- **``torch``** (the twin of the XLA ``qfn``: uint16 wires and the other
  aggregates): the JAX package's XLA layouts ``ref``, ``bfs``,
  ``wirepack`` and ``bfs_wirepack``, which permute the split tables and
  pack the wire exactly as there.

``cuda_plain`` (the ``cuda`` tables scored by the kernel's plain version
on the CPU) takes the ``cuda`` catalogue, so a search runs the same code
on the CPU as on the card; the plain version reads no launch shape.

``SPACE_TAG`` versions the port's search space; it is not the JAX
package's tag, so a config either package cached never reads as the
other's. A stale tag reads as no entry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# bump whenever the candidate space changes shape (a new layout, a new
# launch-shape axis, changed packing semantics): stale cached winners
# must re-search
SPACE_TAG = "torch-space-v1:walk-layouts+launch-shapes"

_TORCH_LAYOUTS = ("ref", "bfs", "wirepack", "bfs_wirepack")
_CUDA_LAYOUTS = ("ref", "bfs")
CUDA_BACKENDS = ("cuda", "cuda_plain")

_FLAGS = {
    "ref": frozenset(),
    "bfs": frozenset(("bfs",)),
    "wirepack": frozenset(("wirepack",)),
    "bfs_wirepack": frozenset(("bfs", "wirepack")),
}


def flags(layout: Optional[str]) -> Optional[frozenset]:
    """Layout id → its feature-flag set; None for an unknown id (a
    cache entry from a different build — callers treat it as
    ineligible, never raise)."""
    return _FLAGS.get(layout or "ref")


def cuda_layouts() -> Tuple[str, ...]:
    return _CUDA_LAYOUTS


def torch_layouts(wire) -> Tuple[str, ...]:
    """Torch-backend layout ids eligible for this wire (wirepack variants
    only when the wire actually has mixed-width columns to pack)."""
    if plan_wire_pack(wire) is None:
        return ("ref", "bfs")
    return _TORCH_LAYOUTS


# ---------------------------------------------------------------------------
# Breadth-first SoA split ordering (the torch backend's tables)
# ---------------------------------------------------------------------------


def bfs_split_order(P: np.ndarray) -> np.ndarray:
    """→ per-tree split permutation ``perm[T, S]`` in breadth-first
    order, derived from the path matrix alone.

    A split's *reach* — how many leaf paths run through it, i.e. its
    count of non-zero rows in ``P[t, s, :]`` — halves per level in a
    binary tree, so a stable descending-reach sort IS level order:
    root first, then depth-1, … with padded all-zero slots (reach 0)
    sinking to the tail. Stability keeps sibling order deterministic."""
    reach = (np.asarray(P) != 0).sum(axis=2)  # [T, S]
    # stable sort on negated reach: ties keep original slot order
    return np.argsort(-reach, axis=1, kind="stable").astype(np.int64)


def apply_split_order(
    perm: np.ndarray,
    feat: np.ndarray,
    qthr: np.ndarray,
    dleft: np.ndarray,
    P: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Permute the four per-split SoA tables consistently along S.

    The split-indicator contraction reduces over S, so the scores are
    bit-identical for ANY consistent permutation (the path sums are small
    integers, exact in f32)."""
    return {
        "feat": np.ascontiguousarray(np.take_along_axis(feat, perm, axis=1)),
        "qthr": np.ascontiguousarray(np.take_along_axis(qthr, perm, axis=1)),
        "dleft": np.ascontiguousarray(
            np.take_along_axis(dleft, perm, axis=1)
        ),
        "P": np.ascontiguousarray(
            np.take_along_axis(P, perm[:, :, None], axis=1)
        ),
    }


def bfs_order(children: Sequence[Sequence[int]]) -> List[int]:
    """Breadth-first visit order over a node table (``children[i]`` =
    child indices of node ``i``; node 0 is the root). Every node is
    reachable from the root by construction in the callers; the root
    keeps index 0 so evaluators that start at 0 are untouched."""
    order: List[int] = []
    seen = [False] * len(children)
    queue = [0]
    seen[0] = True
    while queue:
        nxt: List[int] = []
        for i in queue:
            order.append(i)
            for c in children[i]:
                if not seen[c]:
                    seen[c] = True
                    nxt.append(c)
        queue = nxt
    # defensive: unreachable rows (impossible from the flatteners, but
    # a renumbering must be a permutation regardless) go to the tail
    order.extend(i for i, s in enumerate(seen) if not s)
    return order


# ---------------------------------------------------------------------------
# Breadth-first node order inside the walk table (the cuda backend)
# ---------------------------------------------------------------------------


def bfs_walk(walk: np.ndarray, n_splits: int, n_leaves: int,
             n_classes: int) -> np.ndarray:
    """The ``walk`` table of ``qtrees_cuda.pack_tables`` with each tree's
    nodes renumbered breadth-first → a new i64[T, W] table.

    Per tree: the splits the walk can reach take nodes 1, 2, … in the
    order a breadth-first visit from the root meets them (left child
    first), the leaves take nodes ``1 + S``, ``2 + S``, … in the same
    visit order, and each leaf's f32 row moves with it; unreached (padded)
    slots stay zero words after them. Node words keep their format
    (``feat | qthr << 8 | dleft << 16 | left << 32 | right << 40``, a leaf
    naming itself as both children) and the header its depth, so the
    kernel and its wrapper read the table unchanged, and every record
    reaches a leaf holding the same row as before."""
    walk = np.asarray(walk, np.int64)
    T, W = walk.shape
    S, L, C = int(n_splits), int(n_leaves), int(n_classes)
    leaf_base = 1 + S
    row_word = 1 + S + L
    rows = walk[:, row_word:].copy().view(np.float32)  # [T, 2 (W - row_word)]
    out = np.zeros_like(walk)
    out_rows = np.zeros_like(rows)
    for t in range(T):
        words = walk[t]
        root = int(words[0] & 0xFF)
        new_num = {}
        splits: List[int] = []
        leaves: List[int] = []
        queue = [root]
        while queue:
            nxt: List[int] = []
            for node in queue:
                if node >= leaf_base:
                    new_num[node] = leaf_base + len(leaves)
                    leaves.append(node)
                    continue
                new_num[node] = 1 + len(splits)
                splits.append(node)
                w = int(words[node])
                for child in ((w >> 32) & 0xFF, (w >> 40) & 0xFF):
                    if child not in new_num and child not in nxt:
                        nxt.append(child)
            queue = nxt
        if len(splits) > S or len(leaves) > L:
            raise ValueError(f"tree {t}: the walk reaches more nodes than "
                             "the table has slots")
        out[t, 0] = (words[0] & ~np.int64(0xFF)) | new_num[root]
        for node in splits:
            w = int(words[node])
            left, right = (w >> 32) & 0xFF, (w >> 40) & 0xFF
            out[t, new_num[node]] = (
                (w & 0xFFFFFFFF) | new_num[left] << 32 | new_num[right] << 40)
        for node in leaves:
            n = new_num[node]
            out[t, n] = n << 32 | n << 40
            old, new = node - leaf_base, n - leaf_base
            out_rows[t, new * C:(new + 1) * C] = rows[t, old * C:(old + 1) * C]
    out[:, row_word:] = out_rows.view(np.int64)
    return out


# ---------------------------------------------------------------------------
# uint8/uint16 threshold-rank wire packing
# ---------------------------------------------------------------------------


class WirePack:
    """Per-feature rank packing plan for a uint16 wire.

    Columns whose cut table fits uint8 ship one byte (with 255 as the
    packed missing marker, widened back to the uint16 sentinel on
    device); the rest ship two little-endian bytes. ``pack`` is the
    host side; ``unpack_stage`` is the torch stage that restores the
    ranks on the scorer's device; ``unpack_host`` is the numpy oracle the
    byte-parity tests pin the stage against."""

    def __init__(self, widths: np.ndarray, sentinel: int):
        self.widths = np.asarray(widths, np.int64)  # [F] ∈ {1, 2}
        self.sentinel = int(sentinel)
        offs = np.zeros((len(self.widths) + 1,), np.int64)
        np.cumsum(self.widths, out=offs[1:])
        self.offsets = offs[:-1]
        self.width = int(offs[-1])  # packed bytes per record
        # gather plans for the unpack stage: lo byte per feature, hi
        # byte (multiplied by 0 for uint8 columns so the gather stays
        # in bounds without a second codepath)
        self._lo_idx = self.offsets.astype(np.int32)
        hi = np.where(self.widths == 2, self.offsets + 1, self.offsets)
        self._hi_idx = hi.astype(np.int32)
        self._hi_mult = np.where(self.widths == 2, 256, 0).astype(np.int32)
        self._u8_col = (self.widths == 1)
        self._device_plans = {}

    @property
    def bytes_per_record(self) -> int:
        return self.width

    def pack(self, codes: np.ndarray) -> np.ndarray:
        """uint16 rank codes [B, F] → packed uint8 [B, W]."""
        codes = np.asarray(codes)
        B = codes.shape[0]
        out = np.empty((B, self.width), np.uint8)
        for j, (w, off) in enumerate(zip(self.widths, self.offsets)):
            v = codes[:, j].astype(np.uint32)
            if w == 1:
                # ranks ≤ 254 by plan; only the sentinel exceeds uint8
                out[:, off] = np.where(
                    v == self.sentinel, 255, v
                ).astype(np.uint8)
            else:
                out[:, off] = (v & 0xFF).astype(np.uint8)
                out[:, off + 1] = (v >> 8).astype(np.uint8)
        return out

    def unpack_host(self, packed: np.ndarray) -> np.ndarray:
        """Numpy oracle of :meth:`unpack_stage` → int32 ranks [B, F]."""
        packed = np.asarray(packed, np.uint8)
        lo = packed[:, self._lo_idx].astype(np.int32)
        hi = packed[:, self._hi_idx].astype(np.int32) * self._hi_mult
        r = lo + hi
        return np.where(self._u8_col[None, :] & (r == 255), self.sentinel, r)

    def unpack_stage(self):
        """→ fn(packed uint8 tensor [B, W]) → int32 ranks [B, F] on the
        packed tensor's device, bit-exact with :meth:`unpack_host`. The
        index plans move to a device once, at its first batch."""
        import torch

        def unpack(packed):
            plan = self._device_plans.get(packed.device)
            if plan is None:
                plan = self._device_plans[packed.device] = tuple(
                    torch.from_numpy(a).to(packed.device) for a in (
                        self._lo_idx.astype(np.int64),
                        self._hi_idx.astype(np.int64),
                        self._hi_mult, self._u8_col))
            lo_idx, hi_idx, hi_mult, u8_col = plan
            lo = packed[:, lo_idx].to(torch.int32)
            hi = packed[:, hi_idx].to(torch.int32) * hi_mult
            r = lo + hi
            return torch.where(u8_col[None, :] & (r == 255),
                               torch.tensor(self.sentinel, dtype=torch.int32,
                                            device=r.device), r)

        return unpack


def plan_wire_pack(wire) -> Optional[WirePack]:
    """→ the packing plan for a :class:`~flink_jpmml_tpu_torch.compile
    .qtrees.QuantizedWire`, or None when packing cannot help: a uint8
    wire is already minimal, and a uint16 wire where every feature
    needs two bytes has nothing to shrink."""
    if np.dtype(wire.dtype).itemsize == 1:
        return None
    widths = np.asarray(
        [1 if len(c) <= 254 else 2 for c in wire.cuts], np.int64
    )
    if not (widths == 1).any():
        return None
    return WirePack(widths, wire.sentinel)


# ---------------------------------------------------------------------------
# Cross-model packing partitions (the multi-tenant zoo layout axis)
# ---------------------------------------------------------------------------

# versions the PACK candidate space independently of the per-model
# variant space: adding a partition family must invalidate adopted pack
# plans without forcing every per-model winner to re-search (SPACE_TAG
# stays put)
PACK_SPACE_TAG = "packspace-v1"

# candidate pack widths for the bucketed-greedy family; each is capped
# by PACK_MAX at enumeration time
_PACK_WIDTHS = (4, 8, 16)
# members a pack may hold: the JAX package's ``packs.pack_max()`` at its
# default (its ``FJT_PACK_MAX`` knob is not ported; the port's packs come
# with the multi-tenant slice)
PACK_MAX = 16


def pack_partitions(
    metas: Dict[str, Dict[str, float]]
) -> List[Tuple[Tuple[str, ...], ...]]:
    """Enumerate candidate packing partitions of a model set.

    ``metas`` maps model_hash → packed-shape summary
    (``QuantizedScorer._meta``). A partition is a tuple of groups, each
    group a tuple of model hashes sharing one packed buffer (singleton
    group = solo dispatch). The family is deliberately small — this is
    a ranked search, not exhaustive set partitioning (Bell numbers):

    - **solo** — every model alone (the packing-off baseline; always
      candidate 0 so an empty cost model still has a safe winner),
    - **bucketed-greedy(k)** for k in 4/8/16 — models sorted by
      (wire dtype rank, classification, field count, hash) so lookalike
      shapes land in the same bucket (minimal padded waste), chunked
      into groups of ≤ k,
    - **single-bucket** — one pack per ``PACK_MAX`` chunk over the whole
      sorted set (maximal launch amortization, maximal padding).

    Deterministic: same meta set → same candidate list, so the adopted
    plan is stable under re-search."""
    hashes = sorted(metas)
    if not hashes:
        return []
    solo = tuple((h,) for h in hashes)
    if len(hashes) == 1:
        return [solo]

    def shape_key(h):
        # param shape (trees × leaves) ranks BEFORE the wire shape: the
        # packed kernel pads every member to the group max on both axes,
        # and the T·L contraction — not the input buffer — dominates the
        # padded compute, so compute-identical models must neighbour
        m = metas[h] or {}
        return (
            float(m.get("dtype_rank", 1.0)),
            float(m.get("classification", 0.0)),
            float(m.get("trees", 0.0)),
            float(m.get("leaves", 0.0)),
            float(m.get("splits", 0.0)),
            float(m.get("fields", 0.0)),
            h,
        )

    ordered = sorted(hashes, key=shape_key)
    cap = PACK_MAX
    cands: List[Tuple[Tuple[str, ...], ...]] = [solo]
    seen = {solo}
    for k in tuple(w for w in _PACK_WIDTHS if w <= cap) + (cap,):
        part = tuple(
            tuple(ordered[i: i + k]) for i in range(0, len(ordered), k)
        )
        if part not in seen:
            seen.add(part)
            cands.append(part)
    return cands


def pack_pad_waste(
    metas: Dict[str, Dict[str, float]],
    partition: Sequence[Sequence[str]],
) -> float:
    """Fraction of the partition's padded work that is padding (one of
    the two ranking axes; the batch dimension divides out so this is
    batch-free). Counts BOTH padded axes: the input buffer
    (fields × dtype) and the param contraction (trees × leaves) — the
    latter is where an over-mixed pack actually burns device time."""
    used = 0.0
    total = 0.0
    for group in partition:
        ms = [metas.get(h) or {} for h in group]
        rank = max(float(m.get("dtype_rank", 1.0)) for m in ms)
        f_max = max(float(m.get("fields", 0.0)) for m in ms)
        t_max = max(float(m.get("trees", 0.0)) for m in ms)
        l_max = max(float(m.get("leaves", 0.0)) for m in ms)
        total += len(ms) * (f_max * rank + t_max * l_max)
        used += sum(
            float(m.get("fields", 0.0))
            * float(m.get("dtype_rank", 1.0))
            + float(m.get("trees", 0.0)) * float(m.get("leaves", 0.0))
            for m in ms
        )
    return 1.0 - used / total if total > 0 else 0.0


def variant_id(
    backend: str, layout: str, threads: Optional[int],
    chunk_bytes: Optional[int],
) -> str:
    """Canonical ledger/rates key for one search candidate: a ``cuda``
    candidate by its launch shape (``cuda_auto`` for the kernel's own
    choice, else ``cuda_t<threads>_c<chunk_bytes>``), with ``_<layout>``
    past ``ref``; a ``torch`` candidate by its layout."""
    if backend in CUDA_BACKENDS:
        name = ("cuda_auto" if not threads and not chunk_bytes
                else f"cuda_t{threads or 0}_c{chunk_bytes or 0}")
        return name if layout in (None, "ref") else f"{name}_{layout}"
    return f"torch_{layout or 'ref'}"
