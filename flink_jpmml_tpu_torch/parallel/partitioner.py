"""Keyed routing: host-side hash partitioning of records to worker lanes.

The port's copy of ``flink_jpmml_tpu/parallel/partitioner.py``
(numpy-only), unchanged but for this paragraph. The keyed state table
(``runtime/state.py``) routes slots by :func:`stable_hash_vec`, the
bit-identical vectorized twin of :func:`stable_hash`, so a key lands in
the same slot in both packages.

Reference parity (SURVEY.md §3 P2): Flink's ``keyBy`` hash-partitions the
stream over the network so all records with one key land on one subtask.
Our records don't cross a network for in-slice scaling (the mesh scores a
global batch), but keyed routing is still load-bearing for:

- multi-host ingestion: records hash to (host, pipeline) lanes over DCN;
- per-key ordering: all records of a key flow through one lane in order;
- the dynamic scorer's model routing (a special case with key = model id).

The hash is deterministic across processes and runs (stable across restarts
— required for resume parity), unlike Python's seeded ``hash()``.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, List, Sequence

import numpy as np

KeyFn = Callable[[Any], Any]


def stable_hash(key: Any) -> int:
    """Deterministic 32-bit hash of a key (str/bytes/int/float/tuple)."""
    if isinstance(key, bool):
        data = b"b1" if key else b"b0"
    elif isinstance(key, int):
        # arbitrary-precision: length-prefix the minimal two's-complement
        # encoding (UUID-sized ints must not overflow a fixed width)
        nbytes = (key.bit_length() + 8) // 8 or 1
        data = b"i" + key.to_bytes(nbytes, "little", signed=True)
    elif isinstance(key, float):
        import struct

        data = struct.pack("<d", key)
    elif isinstance(key, bytes):
        data = key
    elif isinstance(key, tuple):
        h = 0x12345678
        for part in key:
            h = zlib.crc32(stable_hash(part).to_bytes(4, "little"), h)
        return h
    else:
        data = str(key).encode("utf-8")
    return zlib.crc32(data)


# table-driven CRC32 (the zlib polynomial, reflected): one 256-entry
# uint32 table lets stable_hash_vec fold whole key COLUMNS per lookup
# instead of hashing records one python call at a time — the keyed
# state plane (runtime/state.py) hashes every record of every batch
def _crc32_table() -> np.ndarray:
    table = np.empty(256, np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = np.where(
                c & np.uint32(1),
                np.uint32(0xEDB88320) ^ (c >> np.uint32(1)),
                c >> np.uint32(1),
            )
        table[i] = c
    return table


_CRC32_TABLE = _crc32_table()


def stable_hash_vec(keys) -> np.ndarray:
    """Vectorized :func:`stable_hash` for int64 keys → uint32 hashes.

    Bit-identical to ``stable_hash(int(k))`` for every int64 ``k``
    (pinned in tests): the same ``b"i"`` + minimal-width little-endian
    two's-complement encoding, the same CRC32 — so state-table slot
    routing (runtime/state.py) and the rollout split / lane routing
    that ride the scalar hash agree on every key by construction."""
    k = np.asarray(keys, np.int64)
    out = np.empty(k.shape, np.uint32)
    ku = k.astype(np.uint64)
    # scalar width = abs(key).bit_length()//8 + 1: b bytes iff
    # abs(key) < 2^(8b-1), smallest such b (NOT the minimal signed
    # width — Python widens the negative boundary values, e.g. -128
    # rides 2 bytes — and the vec twin must match byte for byte).
    # int64 magnitude in uint64 space so -2^63 doesn't overflow; it is
    # the one key needing 9 bytes (its sign-extension byte is 0xFF).
    mag = np.where(k < 0, (~ku) + np.uint64(1), ku)
    nbytes = np.full(k.shape, 9, np.int8)
    for b in range(8, 0, -1):
        lim = np.uint64(1) << np.uint64(8 * b - 1)
        nbytes = np.where(mag < lim, np.int8(b), nbytes)
    tbl = _CRC32_TABLE
    for b in np.unique(nbytes):
        m = nbytes == b
        crc = np.full(int(m.sum()), 0xFFFFFFFF, np.uint32)
        # prefix byte b"i", then the low `b` bytes little-endian (the
        # int64 two's-complement low bytes ARE the signed encoding
        # once the formula says the value rides b bytes)
        crc = tbl[(crc ^ np.uint32(ord("i"))) & np.uint32(0xFF)] ^ (
            crc >> np.uint32(8)
        )
        grp = ku[m]
        for shift in range(min(int(b), 8)):
            byte = ((grp >> np.uint64(8 * shift)) & np.uint64(0xFF)).astype(
                np.uint32
            )
            crc = tbl[(crc ^ byte) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
        if b == 9:  # sign-extension byte of the 9-byte negatives
            crc = tbl[(crc ^ np.uint32(0xFF)) & np.uint32(0xFF)] ^ (
                crc >> np.uint32(8)
            )
        out[m] = crc ^ np.uint32(0xFFFFFFFF)
    return out


def rendezvous_pick(key: Any, lanes: Sequence[Any]) -> Any:
    """Highest-random-weight (rendezvous) choice of one lane for ``key``.

    Unlike ``stable_hash(key) % n``, removing a lane moves ONLY the keys
    that mapped to the removed lane — every other key keeps its lane.
    That is exactly the degraded-mesh contract: a chip loss re-homes the
    dead chip's keys/partitions onto survivors without reshuffling the
    healthy chips' work (per-key ordering and canary splits stay put).
    Deterministic across processes (rides :func:`stable_hash`); ties
    break on the lane value itself so every host agrees."""
    if not lanes:
        raise ValueError("rendezvous_pick needs at least one lane")
    best = None
    best_w = -1
    for lane in lanes:
        w = stable_hash((key, lane))
        if w > best_w or (w == best_w and str(lane) < str(best)):
            best, best_w = lane, w
    return best


class HashPartitioner:
    """Assigns records to ``n_lanes`` by stable key hash (Flink keyBy
    parity). ``partition`` returns per-record lane ids; ``split`` groups a
    batch into per-lane lists preserving intra-lane order."""

    def __init__(self, n_lanes: int, key_fn: KeyFn = lambda r: r):
        if n_lanes <= 0:
            raise ValueError(f"n_lanes must be > 0: {n_lanes}")
        self._n = n_lanes
        self._key_fn = key_fn

    @property
    def n_lanes(self) -> int:
        return self._n

    def lane(self, record: Any) -> int:
        return stable_hash(self._key_fn(record)) % self._n

    def partition(self, records: Sequence[Any]) -> List[int]:
        return [self.lane(r) for r in records]

    def split(self, records: Sequence[Any]) -> List[List[Any]]:
        lanes: List[List[Any]] = [[] for _ in range(self._n)]
        for r in records:
            lanes[self.lane(r)].append(r)
        return lanes
