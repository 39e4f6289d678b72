"""Kafka wire-protocol streaming: real binary-protocol consumer + broker.

The port's copy of ``flink_jpmml_tpu/runtime/kafka.py``, with the import
lines renamed and its notes on the project's history cut. Where it
differs: ``chip_block_sources`` waits for the mesh. ``KafkaRecordSource``
(and the record-path helpers only it calls: ``_fetch``, ``_pump``,
``_fetch_part``) feeds the record engine (``runtime/engine.py``) without
the journey ingest hop of its decode. The C++ tiers go through the port's
``runtime/native.py``, which has no fall-back: a failed g++ build raises
``NativeBuildError`` out of ``KafkaBlockSource.poll`` and
``MiniKafkaBroker.append_rows``. ``kafka_decode_fixed`` returning None
still means "this record set is not fixed-length" and hands the record
set to the vectorized decoder, as in the JAX package. ``append_rows``
takes the Python encoder only when ``timestamp_ms`` is given, decided
before the call (the port's ``kafka_encode_fixed`` raises where the JAX
one returns None). The ``dlq=`` argument stays, duck-typed; without a
DLQ, decode errors raise as in the JAX package. Also left out until the
serving/recovery and journey-tracing slices, since nothing in the port
reaches them: the Produce API (``KafkaClient.produce`` and the broker's
Produce handler, which exist for the DLQ redrive), record headers on the
producer side (``encode_record_batch(headers=)``, ``append(headers=)``),
the header-aware decode ``decode_record_batches_h``, the traceparent walk
``record_batch_traceparents`` and the sources' journey hops. The decoders
still skip the headers of a record that carries some. Left out as well,
since no port path or test drives them: ``KafkaClient.fetch`` (the
value-list fetch; the sources use ``fetch_raw``), and the broker's
keyed producer (``append_rows_keyed``) and log compaction (``compact``).

BASELINE config 2 puts the north-star GBM on a "Kafka tabular stream"; the
reference rode Flink's Kafka connector (SURVEY.md §2 EXT-A). This
module is wire-compatible with it: a consumer
speaking the actual Kafka binary protocol — ApiVersions v0, Metadata v1,
ListOffsets v1, Fetch v4 with magic-v2 record batches (CRC32C, zigzag
varints) — behind the same ``Source``/``BlockSource`` interfaces, plus an
in-process ``MiniKafkaBroker`` serving the identical protocol for tests
and kill/resume drills (the same pattern the FJT1 server plays for the
bespoke protocol).

Offset domain: Kafka partition offsets ARE record indices, so the engine
convention (offset k = "k records consumed" = next record index) maps
1:1 — ``seek(k)`` fetches from Kafka offset ``k`` with no bridging
arithmetic, and the offset checkpointed after scoring record ``i`` is
``i + 1`` (see runtime/net.py's domain note; both sources share it).

Scope: consumption without consumer groups — the framework's keyed
partitioner (parallel/partitioner.py) routes records to workers, so
group coordination (JoinGroup/SyncGroup/OffsetCommit) is not needed;
checkpoints own the offsets (capability C7), which is also the
exactly-once-correct place for them. Multi-partition topics are
consumed via ``partitions=[...]`` in one of two interleave modes (see
``_KafkaSourceBase``): the default ``"auto"`` tolerates what real
brokers serve — keyed producers, uneven partition fill, compaction
gaps — and checkpoints a per-partition OFFSET VECTOR through the
engine's ``checkpoint_state``/``restore_state`` hooks; ``"strict"`` is
the round-robin-bijection fast path whose single scalar offset encodes
every cursor and reconstructs the producer's global order (requires a
round-robin producer and gapless partitions).

All integers big-endian per the Kafka protocol; record-batch varints are
protobuf zigzag.
"""

from __future__ import annotations

import collections
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_jpmml_tpu_torch.obs import attr
from flink_jpmml_tpu_torch.obs import freshness as fresh_mod
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.obs.trace import context_for
from flink_jpmml_tpu_torch.runtime import faults
from flink_jpmml_tpu_torch.runtime.block import BlockSource
from flink_jpmml_tpu_torch.runtime.sources import Polled, Source
from flink_jpmml_tpu_torch.utils.retry import Backoff

API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_VERSIONS = 18

_I8 = struct.Struct(">b")
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")
_U32 = struct.Struct(">I")

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — record-batch checksum. Table-driven; the table is
# built once at import.
# ---------------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE: List[int] = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


class _Crc32cVec:
    """Vectorized CRC32C over GF(2) — the checksum half of the numpy
    batch decoder (:func:`decode_record_batches_rows_vec`).

    CRC is bit-linear: with ``F(s, M)`` the raw table fold of message
    ``M`` from state ``s``, ``F(s, M) = F(0, M) ^ Z_len(M)(s)`` where
    ``Z_k`` is the linear "advance past k zero bytes" operator, and
    ``F(0, A||B) = Z_len(B)(F(0, A)) ^ F(0, B)`` (the ``crc32_combine``
    identity). So the serial byte loop decomposes into (1) per-8-byte-
    word raw CRCs — eight table gathers over the whole buffer at once —
    and (2) a log-depth tree of pairwise combines, each level one
    fixed-shift operator applied via four byte-indexed lookup tables.
    Leading zero bytes are no-ops from state 0, so the word array is
    zero-PADDED AT THE FRONT to a power of two and every tree level
    stays uniform. Operators and their tables are cached per level
    (they depend only on the shift length); the ≤7 tail bytes and the
    init/final conditioning fold in scalar.
    """

    def __init__(self) -> None:
        self.T = np.array(_CRC32C_TABLE, np.uint32)
        # word tables: W[j][b] = F(0, byte b followed by (7-j) zeros)
        W = [self.T] * 8
        for j in range(6, -1, -1):
            p = W[j + 1]
            W[j] = (p >> np.uint32(8)) ^ self.T[p & np.uint32(0xFF)]
        self.W = W
        # squaring chain: _sq[m] = columns of Z1^(2^m) (Z1 = one zero
        # byte); column i is the operator's image of bit i. Built
        # EAGERLY and in full (2^35-byte messages dwarf any fetch):
        # the engine is shared process-wide across decode sidecars and
        # broker handler threads, and a lazily-extended list raced —
        # interleaved append/read inserted duplicate entries whose
        # wrong operators then got baked into the level-table cache,
        # permanently mis-CRCing every batch after a cold concurrent
        # start. Frozen-at-init data needs no locks.
        basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
        sqs = [(basis >> np.uint32(8)) ^ self.T[basis & np.uint32(0xFF)]]
        for _ in range(34):
            sqs.append(self._mat_mul(sqs[-1], sqs[-1]))
        self._sqs = tuple(sqs)
        # level-table cache: misses recompute from the frozen chain, so
        # a concurrent double-compute stores equal values (benign)
        self._lvl_tables: Dict[int, list] = {}

    @staticmethod
    def _mat_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
        out = np.zeros(32, np.uint32)
        for i in range(32):
            out ^= np.where(
                (B >> np.uint32(i)) & np.uint32(1), A[i], np.uint32(0)
            )
        return out

    def _sq(self, m: int) -> np.ndarray:
        return self._sqs[m]

    def _shift_scalar(self, x: int, n_bytes: int) -> int:
        """Z_{n_bytes}(x) for one state (binary decomposition)."""
        m = 0
        while n_bytes:
            if n_bytes & 1:
                cols = self._sq(m)
                acc = 0
                for i in range(32):
                    if (x >> i) & 1:
                        acc ^= int(cols[i])
                x = acc
            n_bytes >>= 1
            m += 1
        return x

    def _level(self, k: int) -> list:
        """Byte-lookup tables for Z_{8·2^k} (= Z1^(2^(3+k)))."""
        tbls = self._lvl_tables.get(k)
        if tbls is None:
            cols = self._sq(3 + k)
            idx = np.arange(256, dtype=np.uint32)
            tbls = []
            for p in range(4):
                t = np.zeros(256, np.uint32)
                for j in range(8):
                    t ^= np.where(
                        (idx >> np.uint32(j)) & np.uint32(1),
                        cols[8 * p + j], np.uint32(0),
                    )
                tbls.append(t)
            self._lvl_tables[k] = tbls
        return tbls

    def crc(self, data) -> int:
        a = np.frombuffer(data, np.uint8)
        n = a.shape[0]
        if n < 64:  # the numpy setup outweighs tiny bodies
            return crc32c(bytes(data))
        nw = n >> 3
        words = a[: nw * 8].reshape(nw, 8)
        c = self.W[0][words[:, 0]]
        for j in range(1, 8):
            c ^= self.W[j][words[:, j]]
        pad = (1 << (nw - 1).bit_length()) - nw
        if pad:
            c = np.concatenate([np.zeros(pad, np.uint32), c])
        k = 0
        while c.shape[0] > 1:
            t0, t1, t2, t3 = self._level(k)
            left, right = c[0::2], c[1::2]
            c = (
                t0[left & np.uint32(0xFF)]
                ^ t1[(left >> np.uint32(8)) & np.uint32(0xFF)]
                ^ t2[(left >> np.uint32(16)) & np.uint32(0xFF)]
                ^ t3[(left >> np.uint32(24)) & np.uint32(0xFF)]
                ^ right
            )
            k += 1
        raw = int(c[0])
        for b in a[nw * 8 :]:  # ≤ 7 tail bytes
            raw = (raw >> 8) ^ _CRC32C_TABLE[(raw ^ int(b)) & 0xFF]
        return raw ^ self._shift_scalar(0xFFFFFFFF, n) ^ 0xFFFFFFFF


_CRC_VEC: Optional[_Crc32cVec] = None


def crc32c_vec(data) -> int:
    """CRC32C via the vectorized engine (lazily built; parity with
    :func:`crc32c` is pinned by tests/test_prefetch.py)."""
    global _CRC_VEC
    if _CRC_VEC is None:
        _CRC_VEC = _Crc32cVec()
    return _CRC_VEC.crc(data)


# ---------------------------------------------------------------------------
# Zigzag varints (record encoding)
# ---------------------------------------------------------------------------


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_varint(out: bytearray, n: int) -> None:
    v = _zigzag(n) & 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(acc), pos
        shift += 7


# ---------------------------------------------------------------------------
# Primitive readers/writers (big-endian, Kafka classic encoding)
# ---------------------------------------------------------------------------


class _Writer:
    def __init__(self) -> None:
        self.b = bytearray()

    def i8(self, v: int) -> "_Writer":
        self.b += _I8.pack(v)
        return self

    def i16(self, v: int) -> "_Writer":
        self.b += _I16.pack(v)
        return self

    def i32(self, v: int) -> "_Writer":
        self.b += _I32.pack(v)
        return self

    def i64(self, v: int) -> "_Writer":
        self.b += _I64.pack(v)
        return self

    def string(self, s: Optional[str]) -> "_Writer":
        if s is None:
            return self.i16(-1)
        raw = s.encode()
        self.i16(len(raw))
        self.b += raw
        return self

    def bytes_(self, raw: Optional[bytes]) -> "_Writer":
        if raw is None:
            return self.i32(-1)
        self.i32(len(raw))
        self.b += raw
        return self

    def raw(self, raw: bytes) -> "_Writer":
        self.b += raw
        return self


class _Reader:
    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def i8(self) -> int:
        (v,) = _I8.unpack_from(self.buf, self.pos)
        self.pos += 1
        return v

    def i16(self) -> int:
        (v,) = _I16.unpack_from(self.buf, self.pos)
        self.pos += 2
        return v

    def i32(self) -> int:
        (v,) = _I32.unpack_from(self.buf, self.pos)
        self.pos += 4
        return v

    def i64(self) -> int:
        (v,) = _I64.unpack_from(self.buf, self.pos)
        self.pos += 8
        return v

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        s = self.buf[self.pos : self.pos + n].decode()
        self.pos += n
        return s

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        raw = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return raw

    def bytes_view(self) -> Optional[memoryview]:
        """Like :meth:`bytes_` but ZERO-COPY: a memoryview into the
        response payload (which the view keeps alive). The fetch path
        hands these straight to the record-batch decoders, so a 4MB
        record set is never duplicated between socket and decode."""
        n = self.i32()
        if n < 0:
            return None
        raw = memoryview(self.buf)[self.pos : self.pos + n]
        self.pos += n
        return raw


# ---------------------------------------------------------------------------
# Record batches (magic v2)
# ---------------------------------------------------------------------------


def encode_record_batch(
    base_offset: int,
    values: Sequence[bytes],
    timestamp_ms: int = 0,
) -> bytes:
    """values → one magic-2 record batch (null keys, no headers)."""
    recs = bytearray()
    for i, v in enumerate(values):
        body = bytearray()
        body += _I8.pack(0)  # record attributes
        write_varint(body, 0)  # timestamp delta
        write_varint(body, i)  # offset delta
        write_varint(body, -1)  # null key
        write_varint(body, len(v))
        body += v
        write_varint(body, 0)  # headers count
        rec = bytearray()
        write_varint(rec, len(body))
        rec += body
        recs += rec

    n = len(values)
    # the crc covers everything AFTER the crc field
    post = _Writer()
    post.i16(0)  # attributes: no compression, CreateTime
    post.i32(n - 1)  # last offset delta
    post.i64(timestamp_ms)  # first timestamp
    post.i64(timestamp_ms)  # max timestamp
    post.i64(-1)  # producer id
    post.i16(-1)  # producer epoch
    post.i32(-1)  # base sequence
    post.i32(n)
    post.raw(bytes(recs))
    crc = crc32c_vec(bytes(post.b))

    w = _Writer()
    w.i64(base_offset)
    w.i32(4 + 1 + 4 + len(post.b))  # batch length (after this field)
    w.i32(-1)  # partition leader epoch
    w.i8(2)  # magic
    w.raw(_U32.pack(crc))
    w.raw(bytes(post.b))
    return bytes(w.b)


def decode_record_batches(buf) -> List[Tuple[int, bytes]]:
    """record-set bytes (or memoryview — the zero-copy fetch path) →
    [(absolute offset, value)] across all batches.

    Tolerates a trailing partial batch (Kafka may truncate at max_bytes)."""
    out: List[Tuple[int, bytes]] = []
    mv = memoryview(buf)  # batch bodies slice zero-copy below
    pos = 0
    while pos + 12 <= len(buf):
        (base_offset,) = _I64.unpack_from(buf, pos)
        (batch_len,) = _I32.unpack_from(buf, pos + 8)
        end = pos + 12 + batch_len
        # 49 = minimum v2 batch body (partitionLeaderEpoch..records count);
        # anything shorter cannot hold the magic/CRC we read below, so treat
        # it as a truncated trailing batch rather than indexing past it.
        if batch_len < 49 or end > len(buf):
            break  # partial trailing batch
        magic = buf[pos + 16]
        if magic != 2:
            raise ValueError(f"unsupported record-batch magic {magic}")
        (crc_stored,) = _U32.unpack_from(buf, pos + 17)
        body = mv[pos + 21 : end]
        if crc32c_vec(body) != crc_stored:
            raise ValueError("record batch CRC32C mismatch")
        r = _Reader(body)
        r.i16()  # attributes (compression unsupported: we never emit it)
        r.i32()  # last offset delta
        r.i64()  # first ts
        r.i64()  # max ts
        r.i64()  # producer id
        r.i16()  # producer epoch
        r.i32()  # base sequence
        count = r.i32()
        p = r.pos
        for _ in range(count):
            rec_len, p = read_varint(body, p)
            rec_end = p + rec_len
            p += 1  # record attributes
            _, p = read_varint(body, p)  # timestamp delta
            off_delta, p = read_varint(body, p)
            klen, p = read_varint(body, p)
            if klen > 0:
                p += klen
            vlen, p = read_varint(body, p)
            value = body[p : p + vlen] if vlen >= 0 else b""
            out.append((base_offset + off_delta, bytes(value)))
            p = rec_end
        pos = end
    return out


def decode_record_batches_rows(
    buf, n_cols: int
) -> Tuple[np.ndarray, np.ndarray]:
    """record-set bytes → (offsets int64 [n], rows f32 [n, n_cols]) for
    the tabular contract (every value one packed f32-LE feature row).

    Three tiers: the C++ decoder (native.kafka_decode_fixed; a failed
    build raises ``NativeBuildError``), which returns None for a record
    set that is not fixed-length — the vectorized numpy decoder
    (:func:`decode_record_batches_rows_vec` — one pass building the
    record offset table, then bulk gather) then decides — and the
    per-record Python walk (:func:`decode_record_batches_rows_py`, the
    parity oracle the other two are byte-pinned against, and the
    vectorized decoder's own branch for non-canonical layouts). ``buf`` may be ``bytes`` or a ``memoryview`` (the
    zero-copy fetch path hands views of the response payload straight
    through). CRC and framing errors raise ValueError identically on
    every tier."""
    from flink_jpmml_tpu_torch.runtime import native

    dec = native.kafka_decode_fixed(buf, 4 * n_cols)
    if dec is not None:
        offs, vals = dec
        return offs, vals.view(np.float32)
    return decode_record_batches_rows_vec(buf, n_cols)


def decode_record_batches_rows_py(
    buf, n_cols: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The per-record Python walk — the PARITY ORACLE for the native
    and vectorized decoders (tools/decode_bench.py races all three;
    tests pin byte equality)."""
    recs = decode_record_batches(buf)
    offs = np.fromiter(
        (o for o, _ in recs), np.int64, count=len(recs)
    )
    rows = np.empty((len(recs), n_cols), np.float32)
    for i, (_, value) in enumerate(recs):
        if len(value) != 4 * n_cols:
            # exact-length contract, matching the C++ decoder (which
            # refuses non-fixed record sets): np.frombuffer(count=)
            # would silently TRUNCATE an over-long value into a
            # plausible-looking row — the worst kind of poison
            raise ValueError(
                f"record value length {len(value)} != {4 * n_cols} "
                f"(n_cols={n_cols})"
            )
        rows[i] = np.frombuffer(value, np.float32, count=n_cols)
    return offs, rows


def _vint_len_vec(u: np.ndarray) -> np.ndarray:
    """Varint byte length of (already-zigzagged) non-negative values."""
    w = np.ones_like(u)
    for k in (7, 14, 21, 28):
        w += u >= (1 << k)
    return w


def _vint_bytes(u: int) -> bytes:
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _vint_check(
    a: np.ndarray, pos: np.ndarray, u: np.ndarray, w: np.ndarray
) -> bool:
    """Do the bytes at ``pos`` encode varints of (zigzagged) ``u``
    with widths ``w``? Vectorized over records, one gather per byte
    position (width ≤ 2 in practice: off_delta < SEG_RECORDS)."""
    for j in range(int(w.max())):
        m = w > j
        exp = (u >> (7 * j)) & 0x7F
        exp = np.where(w > j + 1, exp | 0x80, exp)
        if not (a[pos[m] + j] == exp[m]).all():
            return False
    return True


def _vec_batch_rows(
    a: np.ndarray, rstart: int, rend: int, count: int, V: int
):
    """One batch's records region → uint8 rows [count, V], or None when
    the region is not the canonical tabular layout (then the Python
    walk decides — it handles headers, keys, gaps, and raises on
    wrong-length values).

    Canonical layout (what both our encoders and real round-robin
    producers of fixed-width values emit): per record ``varint(len)``,
    attributes 0, timestamp delta 0, offset delta == record index, null
    key, value length V, zero headers. Every field position is then
    CLOSED-FORM in the record index, so the decode is: build the offset
    table arithmetically, VERIFY the assumed framing bytes with a
    handful of vectorized gathers, and bulk-gather the values."""
    if count <= 0:
        return None
    d = np.arange(count, dtype=np.int64)
    w_od = _vint_len_vec(2 * d)
    vl_bytes = _vint_bytes(2 * V)  # zigzag(V), V ≥ 0
    w_vl = len(vl_bytes)
    body_len = 4 + w_od + w_vl + V
    u_rl = 2 * body_len
    w_rl = _vint_len_vec(u_rl)
    tot = w_rl + body_len
    starts = rstart + np.concatenate(
        ([0], np.cumsum(tot[:-1]))
    )
    if int(starts[-1] + tot[-1]) != rend:
        return None
    p = starts + w_rl
    pk = p + 2 + w_od
    if not (
        _vint_check(a, starts, u_rl, w_rl)  # record length
        and bool((a[p] == 0).all())  # record attributes
        and bool((a[p + 1] == 0).all())  # timestamp delta 0
        and _vint_check(a, p + 2, 2 * d, w_od)  # offset delta == index
        and bool((a[pk] == 1).all())  # null key (zigzag −1)
        and bool((a[starts + tot - 1] == 0).all())  # zero headers
    ):
        return None
    for j, bv in enumerate(vl_bytes):  # value length == V, all records
        if not (a[pk + 1 + j] == bv).all():
            return None
    vpos = pk + 1 + w_vl
    return a[vpos[:, None] + np.arange(V)]


def decode_record_batches_rows_vec(
    buf, n_cols: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The vectorized numpy decoder: record-set bytes → (offsets int64,
    rows f32 [n, n_cols]) in bulk array passes — the offset table
    first, then one fancy-index gather per batch slicing every value
    out of the buffer at once — with the CRC check riding the
    word-parallel engine (:class:`_Crc32cVec`). Anything off the
    canonical fixed-width layout (record headers — a traceparent
    redrive —, key'd records, offset-delta gaps, wrong-length values)
    falls back to :func:`decode_record_batches_rows_py` for the whole
    record set, which decodes-or-raises with oracle semantics. CRC,
    magic, and framing errors raise ValueError exactly like the oracle."""
    a = np.frombuffer(buf, np.uint8)
    ln = a.shape[0]
    out_offs: List[np.ndarray] = []
    out_rows: List[np.ndarray] = []
    V = 4 * n_cols
    pos = 0
    while pos + 12 <= ln:
        (base_offset,) = _I64.unpack_from(buf, pos)
        (batch_len,) = _I32.unpack_from(buf, pos + 8)
        end = pos + 12 + batch_len
        if batch_len < 49 or end > ln:
            break  # partial trailing batch
        magic = a[pos + 16]
        if magic != 2:
            raise ValueError(f"unsupported record-batch magic {magic}")
        (crc_stored,) = _U32.unpack_from(buf, pos + 17)
        if crc32c_vec(a[pos + 21 : end]) != crc_stored:
            raise ValueError("record batch CRC32C mismatch")
        (count,) = _I32.unpack_from(buf, pos + 21 + 36)
        rows = _vec_batch_rows(a, pos + 21 + 40, end, int(count), V)
        if rows is None:
            return decode_record_batches_rows_py(buf, n_cols)
        out_offs.append(base_offset + np.arange(count, dtype=np.int64))
        out_rows.append(rows)
        pos = end
    if not out_offs:
        return np.empty((0,), np.int64), np.empty((0, n_cols), np.float32)
    offs = np.concatenate(out_offs)
    rows = np.concatenate(out_rows).view(np.float32)
    return offs, rows


def record_batch_time_range(buf: bytes):
    """record-set bytes → (min_event_ts_s, max_event_ts_s) across all
    whole batches, from the magic-v2 batch headers' first/max timestamp
    fields — a header-only walk (no varint/CRC work), cheap enough to
    run per fetch on the hot path. → None when no batch carries a
    positive timestamp (the native encoder stamps 0 = "no event time";
    a 1970 watermark would poison every staleness histogram)."""
    lo = hi = None
    pos = 0
    while pos + 12 <= len(buf):
        (batch_len,) = _I32.unpack_from(buf, pos + 8)
        end = pos + 12 + batch_len
        if batch_len < 49 or end > len(buf):
            break  # truncated trailing batch (cf. decode_record_batches)
        # header layout after the CRC (pos+21): attributes i16, last
        # offset delta i32, first timestamp i64, max timestamp i64
        (first_ms,) = _I64.unpack_from(buf, pos + 27)
        (max_ms,) = _I64.unpack_from(buf, pos + 35)
        if max_ms > 0:
            f = (first_ms if first_ms > 0 else max_ms) / 1000.0
            m = max_ms / 1000.0
            lo = f if lo is None else min(lo, f)
            hi = m if hi is None else max(hi, m)
        pos = end
    return None if hi is None else (lo, hi)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class KafkaProtocolError(RuntimeError):
    pass


class KafkaPartitionError(KafkaProtocolError):
    """UNKNOWN_TOPIC_OR_PARTITION (err 3): a misconfiguration, not a
    transient wire failure — sources re-raise it instead of entering
    the reconnect-and-retry loop (fail fast, don't poll a phantom
    partition forever)."""


class KafkaClient:
    """Minimal single-connection Kafka client (consumer side).

    Speaks classic (non-flexible) request versions so the framing works
    against any broker from 0.11 on: ApiVersions v0, Metadata v1,
    ListOffsets v1, Fetch v4.
    """

    def __init__(
        self,
        host: str,
        port: int,
        client_id: str = "fjt-consumer",
        timeout_s: float = 10.0,
    ):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._corr = 0

    # -- connection management ------------------------------------------

    def connect(self) -> None:
        self.close()
        s = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        )
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _request(self, api_key: int, api_version: int, body: bytes) -> _Reader:
        if self._sock is None:
            self.connect()
        self._corr += 1
        hdr = _Writer()
        hdr.i16(api_key).i16(api_version).i32(self._corr).string(
            self.client_id
        )
        msg = bytes(hdr.b) + body
        self._sock.sendall(_I32.pack(len(msg)) + msg)
        raw = self._recv_exact(4)
        (size,) = _I32.unpack(raw)
        payload = self._recv_exact(size)
        r = _Reader(payload)
        corr = r.i32()
        if corr != self._corr:
            raise KafkaProtocolError(
                f"correlation id mismatch: {corr} != {self._corr}"
            )
        return r

    def _recv_exact(self, n: int) -> bytearray:
        # recv_into a preallocated buffer: no per-chunk bytes objects,
        # no append-resize churn, and no final whole-payload copy — the
        # returned bytearray IS what the fetch path's memoryews slice
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            r = self._sock.recv_into(view[got:])
            if not r:
                raise ConnectionError("kafka connection closed")
            got += r
        return buf

    # -- protocol calls --------------------------------------------------

    def api_versions(self) -> Dict[int, Tuple[int, int]]:
        r = self._request(API_VERSIONS, 0, b"")
        err = r.i16()
        if err:
            raise KafkaProtocolError(f"ApiVersions error {err}")
        out = {}
        for _ in range(r.i32()):
            k, lo, hi = r.i16(), r.i16(), r.i16()
            out[k] = (lo, hi)
        return out

    def metadata(self, topic: str):
        """→ (brokers {node: (host, port)}, partitions {index: leader})."""
        w = _Writer()
        w.i32(1).string(topic)
        r = self._request(API_METADATA, 1, bytes(w.b))
        brokers = {}
        for _ in range(r.i32()):
            node = r.i32()
            host = r.string()
            port = r.i32()
            r.string()  # rack
            brokers[node] = (host, port)
        r.i32()  # controller id
        partitions = {}
        for _ in range(r.i32()):
            terr = r.i16()
            name = r.string()
            r.i8()  # is_internal
            nparts = r.i32()
            for _ in range(nparts):
                perr = r.i16()
                idx = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):
                    r.i32()  # replicas
                for _ in range(r.i32()):
                    r.i32()  # isr
                if name == topic and not perr:
                    partitions[idx] = leader
            if name == topic and terr:
                raise KafkaProtocolError(
                    f"Metadata error {terr} for topic {topic!r}"
                )
        return brokers, partitions

    def list_offset(
        self, topic: str, partition: int, timestamp: int
    ) -> int:
        """timestamp −2 = earliest, −1 = latest → partition offset."""
        w = _Writer()
        w.i32(-1)  # replica id
        w.i32(1).string(topic).i32(1).i32(partition).i64(timestamp)
        r = self._request(API_LIST_OFFSETS, 1, bytes(w.b))
        for _ in range(r.i32()):
            r.string()  # topic
            for _ in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                if err == 3:
                    raise KafkaPartitionError(
                        f"ListOffsets error 3 (unknown partition "
                        f"{partition} of topic {topic!r})"
                    )
                if err:
                    raise KafkaProtocolError(f"ListOffsets error {err}")
                r.i64()  # timestamp
                return r.i64()
        raise KafkaProtocolError("empty ListOffsets response")

    def fetch_raw(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_wait_ms: int = 100,
        min_bytes: int = 1,
        max_bytes: int = 4 << 20,
    ) -> Tuple[int, "bytes | memoryview"]:
        """→ (high watermark, raw record-set bytes). The record set may
        contain whole batches starting before the requested offset —
        decoders filter, exactly like a real consumer.

        ZERO-COPY: the record set is a ``memoryview`` into the response
        payload (the single-partition response shape this client always
        requests), so the bytes travel socket → decoder with no
        intermediate copy; only a multi-chunk response (never produced
        by our requests) pays a join."""
        w = _Writer()
        w.i32(-1)  # replica id
        w.i32(max_wait_ms)
        w.i32(min_bytes)
        w.i32(max_bytes)
        w.i8(0)  # isolation level: read_uncommitted
        w.i32(1).string(topic)
        w.i32(1).i32(partition).i64(offset).i32(max_bytes)
        r = self._request(API_FETCH, 4, bytes(w.b))
        r.i32()  # throttle time
        high_watermark = 0
        chunks: List[memoryview] = []
        for _ in range(r.i32()):
            r.string()  # topic
            for _ in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                high_watermark = r.i64()
                r.i64()  # last stable offset
                for _ in range(r.i32()):  # aborted transactions
                    r.i64()
                    r.i64()
                chunk = r.bytes_view()
                if chunk is not None and len(chunk):
                    chunks.append(chunk)
                if err == 3:
                    raise KafkaPartitionError(
                        f"Fetch error 3 (unknown partition {partition} "
                        f"of topic {topic!r})"
                    )
                if err:
                    raise KafkaProtocolError(f"Fetch error {err}")
        if not chunks:
            return high_watermark, b""
        if len(chunks) == 1:
            return high_watermark, chunks[0]
        return high_watermark, b"".join(chunks)



# ---------------------------------------------------------------------------
# Sources (engine-facing)
# ---------------------------------------------------------------------------


class _KafkaSourceBase:
    """Shared fetch/reconnect/seek plumbing for both source shapes.

    Single-partition (default): engine offsets ARE Kafka offsets (the
    1:1 domain of the module header).

    Multi-partition (``partitions=[...]``), two interleave modes:

    - ``interleave="auto"`` (default): records are consumed from
      whichever partition has data, in round-robin *preference* but
      never stalling on an empty partition; per-partition cursors
      advance to the offsets actually observed, so keyed producers
      (uneven fill) and compacted logs (offset gaps) — what real
      brokers serve — both work. Resume state is a checkpointed
      per-partition OFFSET VECTOR: the source snapshots its cursor
      vector at every emission boundary, the engine checkpoint embeds
      the newest snapshot ≤ the committed offset
      (``checkpoint_state``), and ``restore_state`` resumes every
      partition from it exactly. A commit landing mid-emission resumes
      from the preceding boundary — strictly less replay than one
      batch, within the C7 at-least-once contract.
    - ``interleave="strict"``: the round-robin bijection fast path —
      global record index g maps to partition ``partitions[g % P]`` at
      partition offset ``g // P``, so the engine's single scalar offset
      encodes every cursor and ``seek(k)`` is exact at ANY k. Requires
      a round-robin producer and gapless partitions (the tabular-stream
      layout); a partition-offset gap raises ``KafkaProtocolError``
      rather than silently mis-aligning lanes. Also reconstructs the
      producer's global record order, which auto mode (arrival order)
      cannot."""

    def __init__(
        self,
        host: str,
        port: int,
        topic: str,
        partition: int = 0,
        partitions: Optional[Sequence[int]] = None,
        start_offset: int = 0,
        max_wait_ms: int = 50,
        reconnect_backoff_s: float = 0.05,
        interleave: str = "auto",
        metrics=None,
        max_bytes: int = 4 << 20,
        dlq=None,
    ):
        self._client = KafkaClient(host, port)
        # dead-letter queue (runtime/dlq.py): when installed, a record
        # whose VALUE doesn't decode is counted per partition
        # (decode_errors), quarantined with its raw bytes, and skipped —
        # one poisoned producer message stops killing the consumer.
        # Without one, decode errors raise exactly as before.
        self._dlq = dlq
        self._decode_err_counters: Dict[object, object] = {}
        self._last_decode_event = 0.0
        # observability (optional MetricsRegistry): fetch-RPC latency as
        # a mergeable histogram, and per-partition consumer lag gauges —
        # kafka_lag{partition="p"} = broker high-water mark minus this
        # consumer's fetch cursor at fetch time, the classic "how far
        # behind is this worker" signal the fleet /metrics view scrapes
        self._metrics = metrics
        self._fetch_hist = (
            metrics.histogram("kafka_fetch_s") if metrics is not None
            else None
        )
        # resolved once, like _fetch_hist: the per-registry lookup is a
        # lock + WeakKeyDictionary hit, too much for the per-fetch path
        self._ledger = attr.ledger_for(metrics)
        # event-time freshness (obs/freshness.py): the tracker is the
        # per-REGISTRY singleton — the pipeline sharing this registry
        # consumes at its sink the stamps this source writes at fetch —
        # while the lag forecaster is per-SOURCE (partition keys are
        # ours alone): produced/consumed rates, drain ETA, and the
        # kafka_lag age-stamping that keeps a stalled partition honest
        self._freshness = fresh_mod.freshness_for(metrics)
        self._forecaster = (
            fresh_mod.LagForecaster(metrics) if metrics is not None
            else None
        )
        # event-time range of the most recent successful fetch (set in
        # _fetch_raw_part, read by the poll paths when they
        # know which global offsets the decoded rows landed on)
        self._last_trange = None
        self._lag_gauges: Dict[int, object] = {}
        self._topic = topic
        self._parts = (
            tuple(partitions) if partitions is not None else (partition,)
        )
        if len(set(self._parts)) != len(self._parts) or not self._parts:
            raise ValueError(f"bad partition set {self._parts!r}")
        if interleave not in ("auto", "strict"):
            raise ValueError(f"bad interleave mode {interleave!r}")
        self._partition = self._parts[0]
        self._strict = interleave == "strict"
        if (
            len(self._parts) > 1
            and not self._strict
            and start_offset != 0
        ):
            # a scalar start offset has no meaning without the strict
            # bijection: silently accepting it would relabel records
            # (global indices shifted by start_offset) without skipping
            # anything
            raise ValueError(
                "start_offset requires interleave='strict' on a "
                "multi-partition source; auto mode resumes through "
                "restore_state (per-partition offset vector)"
            )
        self._next = start_offset  # next Kafka offset (single-partition)
        self._g = start_offset  # next global record index (multi)
        self._bufs: Dict[int, "collections.deque"] = {
            p: collections.deque() for p in self._parts
        }
        # vector mode: per-partition next-offset cursors + emission-
        # boundary snapshots (global_end, cursor vector) for checkpoint.
        # _snap_mu guards snaps/floor: the ingest thread appends while
        # the score thread's checkpoint_state prunes (block.py runs
        # poll and _ckpt_state on different threads)
        self._cursors: Dict[int, int] = {p: 0 for p in self._parts}
        self._rr = 0  # round-robin preference pointer (auto mode)
        self._snap_mu = threading.Lock()
        self._snaps: "collections.deque" = collections.deque()
        self._snap_floor = (start_offset, dict(self._cursors))
        self._max_wait_ms = max_wait_ms
        # the fetch.max.bytes analogue: bounds how much backlog ONE
        # fetch RPC can slurp — load drills cap it so broker-side lag
        # stays observable instead of teleporting into host memory
        self._max_bytes = int(max_bytes)
        # capped exponential backoff with full jitter (utils/retry.py):
        # the constructor's reconnect_backoff_s is the base delay;
        # consecutive failures back off to the cap so N consumers of a dead broker don't storm it in
        # lockstep the instant it heals, and the current delay rides
        # the reconnect_backoff_s gauge (fleet merge: worst-of)
        self._backoff = Backoff(
            "kafka", base_s=reconnect_backoff_s, metrics=metrics
        )
        self._eos = False

    def _reconnect(self) -> None:
        # reconnect-at-offset: exactly the consumer resume model —
        # nothing is lost or duplicated because the cursors only
        # advance on successfully decoded records
        flight.record(
            "kafka_reconnect", topic=self._topic,
            partitions=list(self._parts),
            attempt=self._backoff.attempts + 1,
        )
        self._client.close()
        self._backoff.sleep()
        try:
            self._client.connect()
        except OSError:
            pass

    def _observe_fetch(self, part: int, offset: int, hw: int,
                       t0: float) -> None:
        if self._metrics is None:
            return
        dt = time.monotonic() - t0
        self._fetch_hist.observe(dt)
        # the attribution plane's fetch column (obs/attr.py): kafka
        # fetch RPC time per fetch, merged fleet-wide like every stage
        if self._ledger is not None:
            self._ledger.observe("fetch", dt)
        g = self._lag_gauges.get(part)
        if g is None:
            g = self._metrics.gauge(f'kafka_lag{{partition="{part}"}}')
            self._lag_gauges[part] = g
        g.set(max(hw - offset, 0))
        if self._forecaster is not None:
            # produced (broker high watermark) vs consumed (our cursor):
            # the sliding-window drain-ETA/trend estimator, plus the
            # age-stamp sweep that keeps EVERY partition's lag reading
            # honest while this one fetches
            self._forecaster.observe(part, hw, offset)

    def _fetch_part(
        self, part: int, offset: int, max_wait_ms: Optional[int] = None
    ) -> List[Tuple[int, bytes]]:
        t0 = time.monotonic()
        try:
            # fault hooks INSIDE the try: an injected broker death rides
            # the same except → reconnect/backoff path a real one does,
            # and an injected slow fetch lands in the fetch histogram
            faults.fire("kafka_fetch")
            hw, record_set = self._client.fetch_raw(
                self._topic, part, offset,
                max_wait_ms=(
                    self._max_wait_ms if max_wait_ms is None else max_wait_ms
                ),
                max_bytes=self._max_bytes,
            )
        except KafkaPartitionError:
            raise  # misconfiguration: fail fast, don't reconnect-loop
        except (OSError, ConnectionError, KafkaProtocolError):
            self._reconnect()
            self._sweep_lag_age()
            return []
        self._backoff.reset()  # a successful fetch closes the streak
        self._note_event_times(part, record_set)
        self._observe_fetch(part, offset, hw, t0)
        return [
            rec
            for rec in decode_record_batches(record_set)
            if rec[0] >= offset
        ]

    def _fetch_raw_part(
        self, part: int, offset: int, max_wait_ms: Optional[int] = None
    ) -> bytes:
        t0 = time.monotonic()
        try:
            # fault hooks INSIDE the try: an injected broker death rides
            # the same except → reconnect/backoff path a real one does,
            # and an injected slow fetch lands in the fetch histogram
            faults.fire("kafka_fetch")
            hw, raw = self._client.fetch_raw(
                self._topic, part, offset,
                max_wait_ms=(
                    self._max_wait_ms if max_wait_ms is None else max_wait_ms
                ),
                max_bytes=self._max_bytes,
            )
        except KafkaPartitionError:
            raise  # misconfiguration: fail fast, don't reconnect-loop
        except (OSError, ConnectionError, KafkaProtocolError):
            self._reconnect()
            self._sweep_lag_age()
            return b""
        self._backoff.reset()
        self._note_event_times(part, raw)
        self._observe_fetch(part, offset, hw, t0)
        return raw

    def _note_decode_error(self, part, off: int, value: bytes, exc) -> None:
        """One undecodable record value: count it per partition, park
        the raw bytes in the DLQ (when installed), rate-limit one
        flight event — the caller skips the record and advances its
        cursor past it (never silently, never fatally)."""
        label = part if part is not None else "na"
        c = self._decode_err_counters.get(label)
        if c is None and self._metrics is not None:
            c = self._metrics.counter(f'decode_errors{{partition="{label}"}}')
            self._decode_err_counters[label] = c
        if c is not None:
            c.inc()
        # the record's deterministic trace context rides the flight
        # event and the DLQ envelope
        rctx = context_for(off)
        now = time.monotonic()
        if now - self._last_decode_event >= 1.0:
            self._last_decode_event = now
            flight.record(
                "decode_error", topic=self._topic, partition=part,
                offset=off, size=len(value), error=repr(exc),
                trace_id=rctx.trace_id,
            )
        if self._dlq is not None:
            self._dlq.quarantine(
                value, offset=off, reason="decode",
                partition=part if isinstance(part, int) else None,
                error=exc, topic=self._topic,
                trace_id=rctx.trace_id, span_id=rctx.span_id,
            )

    def _sweep_lag_age(self) -> None:
        """A dead broker must not freeze ``kafka_lag_age_s`` at its last
        fresh-looking value: the poll loop keeps sweeping through the
        reconnect path even when every fetch fails, so the
        staleness crossing (and its ``kafka_lag_stale``
        flight event) still fires. Rate-limited inside sweep()."""
        if self._forecaster is not None:
            self._forecaster.sweep()

    def _note_event_times(self, part: int, record_set: bytes) -> None:
        """Advance the partition's event-time watermark from the fetched
        batches' header timestamps and remember the range for the poll
        path's ingest stamp (a header-only walk; skipped entirely when
        no registry is attached)."""
        if self._freshness is None or not record_set:
            self._last_trange = None
            return
        tr = record_batch_time_range(record_set)
        self._last_trange = tr
        if tr is not None:
            self._freshness.observe_source(part, tr[0], tr[1])

    _TRANGE_LAST = object()  # "use the last fetch's range" default

    def _stamp_ingest(
        self, first_off: int, n: int, trange=_TRANGE_LAST
    ) -> None:
        """Offset-keyed ingest stamp for the sink's staleness books
        (block sources only: record offsets there are the global domain
        the pipeline's sink commits in). ``trange`` overrides the last
        fetch's range for paths that buffer rows across fetches (the
        strict interleave merges per-slot ranges); an EXPLICIT ``None``
        means the emitted rows carried no event times at all — it must
        not fall back to another partition's fetch range, or unstamped
        rows would be booked with foreign event times."""
        if trange is self._TRANGE_LAST:
            trange = self._last_trange
        if self._freshness is not None and trange is not None:
            self._freshness.stamp_ingest(first_off, n, trange[0], trange[1])

    def _fetch(self) -> List[Tuple[int, bytes]]:
        """Single-partition fetch from the legacy Kafka-offset cursor."""
        recs = self._fetch_part(self._partition, self._next)
        if recs:
            self._next = recs[-1][0] + 1
        return recs

    def _pump(self, want: int) -> List[Tuple[int, bytes]]:
        """→ up to ``want`` (global_index, value) pairs in strict
        round-robin order across the configured partitions. Stops early
        when the next-in-turn partition has nothing fetchable yet (the
        interleave never skips ahead — that would break the bijection)."""
        P = len(self._parts)
        out: List[Tuple[int, bytes]] = []
        while len(out) < want:
            part = self._parts[self._g % P]
            po = self._g // P
            buf = self._bufs[part]
            while buf and buf[0][0] < po:
                buf.popleft()
            if not buf:
                recs = self._fetch_part(part, po)
                if not recs:
                    break
                buf.extend(recs)
                continue
            off, value = buf.popleft()
            if off != po:
                raise KafkaProtocolError(
                    f"partition {part} offset gap ({po} -> {off}) breaks "
                    "the round-robin interleave contract"
                )
            out.append((self._g, value))
            self._g += 1
        return out

    @property
    def _multi(self) -> bool:
        return len(self._parts) > 1

    @property
    def partitions(self) -> Tuple[int, ...]:
        """The partition set this source drains — the mesh ingest
        split (parallel/assignment.ChipAssignment) reads it to attach
        per-chip partition ownership."""
        return self._parts

    @property
    def _vector_mode(self) -> bool:
        return self._multi and not self._strict

    def _snap(self) -> None:
        """Record an emission-boundary cursor snapshot (vector mode)."""
        with self._snap_mu:
            self._snaps.append((self._g, dict(self._cursors)))
            # bound memory when nothing ever checkpoints by THINNING —
            # dropping intermediate boundaries only coarsens resume
            # granularity (more replay). The floor must NEVER advance
            # here: every retained-or-dropped entry has g > any
            # committed offset the score thread could have pruned to,
            # and a floor past committed would SKIP records on restore.
            if len(self._snaps) > 65536:
                self._snaps = collections.deque(
                    v for i, v in enumerate(self._snaps)
                    if i % 2 == 1
                )

    def checkpoint_state(self, committed: int) -> Optional[dict]:
        """Engine hook: JSON state for an exact multi-partition resume —
        the newest cursor-vector snapshot at or before ``committed``
        (None = the scalar offset fully encodes resume: single-partition
        or strict mode)."""
        if not self._vector_mode:
            return None
        with self._snap_mu:
            while self._snaps and self._snaps[0][0] <= committed:
                self._snap_floor = self._snaps.popleft()
            g, cursors = self._snap_floor
        return {
            "offset": g,
            "cursors": {str(p): off for p, off in cursors.items()},
        }

    def restore_state(self, state: dict) -> int:
        """Engine hook: resume from a checkpointed cursor vector →
        the effective committed offset (≤ what was requested when the
        commit landed mid-emission)."""
        if not self._vector_mode:
            # an auto-era checkpoint restored into a strict source:
            # the bijection would silently misread the arrival-order
            # global offset — refuse rather than mis-align lanes
            raise KafkaProtocolError(
                "checkpoint carries a per-partition cursor vector "
                "(written by interleave='auto') but this source is "
                "strict/single-partition; construct it with "
                "interleave='auto' to resume (migration notes: "
                "docs/migration.md, 'Kafka multi-partition interleave "
                "and checkpoint migration')"
            )
        cursors = {
            int(p): int(off) for p, off in state["cursors"].items()
        }
        if set(cursors) != set(self._parts):
            raise KafkaProtocolError(
                f"checkpoint cursors {sorted(cursors)} do not match the "
                f"configured partitions {sorted(self._parts)}"
            )
        g = int(state["offset"])
        with self._snap_mu:
            self._cursors = cursors
            self._g = g
            self._snaps.clear()
            self._snap_floor = (g, dict(cursors))
        self._clear_buffers()
        if self._freshness is not None:
            self._freshness.reset_stamps()
        if self._forecaster is not None:
            self._forecaster.reset()
        return g

    def _clear_buffers(self) -> None:
        for buf in self._bufs.values():
            buf.clear()

    def seek(self, offset: int) -> None:
        # engine offset k ("k records consumed") == next Kafka offset
        # (single-partition) / next global index (multi-strict): no +1
        # bridging anywhere (cf. net.py header)
        if self._vector_mode and offset != self._snap_floor[0]:
            raise KafkaProtocolError(
                f"vector-mode seek({offset}) without cursor state: "
                "multi-partition auto interleave resumes through "
                "restore_state (checkpointed per-partition offsets); "
                "arbitrary scalar seeks only exist in strict mode. "
                "Restoring a legacy scalar-only checkpoint (written by "
                "the pre-vector strict bijection)? Construct the "
                "source with interleave='strict' (migration notes: "
                "docs/migration.md, 'Kafka multi-partition interleave "
                "and checkpoint migration')."
            )
        self._next = offset
        self._g = offset
        self._clear_buffers()
        # the offset domain restarted (resume, or a cycling bench's
        # wrap-to-0): pending ingest stamps would mis-key against the
        # new offsets, and the forecaster's consume rate would read the
        # cursor jump as a giant negative delta
        if self._freshness is not None:
            self._freshness.reset_stamps()
        if self._forecaster is not None:
            self._forecaster.reset()

    def close(self) -> None:
        self._client.close()

    @property
    def exhausted(self) -> bool:
        return self._eos


class KafkaRecordSource(_KafkaSourceBase, Source):
    """Record-object source: each Kafka message value is one JSON record
    (or raw bytes via ``decoder``)."""

    # network source with real fetch latency: the pipelines wrap it in
    # a prefetch sidecar (runtime/prefetch.py) unless disabled
    prefetchable = True

    def __init__(self, *args, decoder=None, **kw):
        super().__init__(*args, **kw)
        import json

        self._decode = decoder or (lambda v: json.loads(v))
        self._pending: List[Tuple[int, bytes]] = []
        # vector mode: globally-indexed records buffered between polls
        self._pending_global: "collections.deque" = collections.deque()

    def _pump_auto(self, want: int) -> List[Tuple[int, bytes]]:
        """Vector-mode pump: runs from whichever partition has data
        (round-robin preference); cursors track observed offsets, gaps
        included; one snapshot per fetched run. Dry partitions are
        probed with ``max_wait_ms=0``; one long-poll only when the
        whole sweep is dry (cf. ``_poll_multi_auto``)."""
        out: List[Tuple[int, bytes]] = []
        P = len(self._parts)
        while len(out) < want:
            if self._pending_global:
                out.append(self._pending_global.popleft())
                continue
            fetched = False
            for attempt in (0, 1):
                for i in range(P):
                    idx = (self._rr + i) % P
                    part = self._parts[idx]
                    cur = self._cursors[part]
                    recs = [
                        (o, v)
                        for o, v in self._fetch_part(
                            part, cur,
                            max_wait_ms=0 if attempt == 0 else None,
                        )
                        if o >= cur
                    ]
                    if not recs:
                        if attempt:
                            break  # one long-poll per dry sweep
                        continue
                    g0 = self._g
                    self._pending_global.extend(
                        (g0 + j, v) for j, (_, v) in enumerate(recs)
                    )
                    self._g = g0 + len(recs)
                    self._cursors[part] = recs[-1][0] + 1
                    self._rr = (idx + 1) % P
                    self._snap()
                    fetched = True
                    break
                if fetched:
                    break
            if not fetched:
                break
        return out

    def _decode_polled(self, pairs, part) -> Polled:
        """(offset, value) pairs → (offset+1, record), quarantining +
        skipping values the decoder rejects (counted per partition,
        raw bytes to the DLQ when installed). With neither metrics nor
        a DLQ the historical raise stands — an invisible skip would be
        silent data loss."""
        out = []
        for off, value in pairs:
            try:
                rec = self._decode(value)
            except Exception as e:
                if self._dlq is None and self._metrics is None:
                    raise
                self._note_decode_error(part, off, value, e)
                continue
            out.append((off + 1, rec))
        return out

    def poll(self, max_n: int) -> Polled:
        if self._vector_mode:
            return self._decode_polled(self._pump_auto(max_n), None)
        if self._multi:
            return self._decode_polled(self._pump(max_n), None)
        # a fetch may return more than max_n records; the surplus stays
        # buffered so nothing fetched is ever dropped (the fetch cursor
        # has already moved past it)
        if len(self._pending) < max_n:
            self._pending.extend(self._fetch())
        take, self._pending = (
            self._pending[:max_n],
            self._pending[max_n:],
        )
        return self._decode_polled(take, self._partition)

    def _clear_buffers(self) -> None:
        self._pending.clear()
        self._pending_global.clear()
        super()._clear_buffers()

    def seek(self, offset: int) -> None:
        self._pending.clear()
        super().seek(offset)


class KafkaBlockSource(_KafkaSourceBase, BlockSource):
    """Block source: each Kafka message value is one packed f32-LE feature
    row; a fetch's worth of consecutive rows forms one [n, F] block.
    Single- and multi-partition polls both ride the C++ record-batch
    decoder; the multi-partition interleave is array-strided, not
    per-record.

    ``metrics`` (optional, a ``MetricsRegistry``) accounts wire-decode
    time into a ``kafka_decode_s`` counter — the consumer-thread half
    of the stream's host budget, reported next to the score loop's
    ``encode_s`` so the bench's ``kafka_mode`` can say where consumer
    CPU goes (``decode_ms``) — plus the base class's fetch-latency
    histogram and per-partition ``kafka_lag`` gauges."""

    # network source with real fetch latency: the pipelines wrap it in
    # a prefetch sidecar (runtime/prefetch.py) unless disabled
    prefetchable = True

    def __init__(self, *args, n_cols: int, metrics=None, **kw):
        super().__init__(*args, metrics=metrics, **kw)
        self._cols = n_cols
        self._decode_s = (
            metrics.counter("kafka_decode_s") if metrics is not None else None
        )
        # per-slot decoded row buffers: slot → [rows...] contiguous from
        # that slot's next needed partition offset (multi-partition only)
        self._rbufs: Dict[int, np.ndarray] = {}
        # slot → (min_ts, max_ts) of the fetches its buffered rows came
        # from — batch granularity, so the emitted interleave's ingest
        # stamp stays an upper bound on staleness
        self._rbuf_tranges: Dict[int, tuple] = {}

    def _decode_rows(self, raw: bytes, part):
        """→ (offsets int64, rows f32, bad_hi): the decoded fixed-width
        rows plus the highest offset of any record whose VALUE was the
        wrong length (None when all decoded). Bad records are counted
        (``decode_errors{partition=*}``) and routed to the DLQ when one
        is installed; the callers advance their cursors past ``bad_hi``
        so a poisoned producer message is consumed exactly once, not
        refetched forever. With neither metrics nor DLQ attached the
        historical ValueError propagates (a skip nobody can see would
        be silent data loss); the strict interleave also re-raises —
        its round-robin bijection cannot tolerate a dropped lane."""
        t0 = time.monotonic() if self._decode_s is not None else None
        try:
            try:
                offs, rows = decode_record_batches_rows(raw, self._cols)
                return offs, rows, None
            except ValueError:
                if self._strict and self._multi:
                    raise
                if self._dlq is None and self._metrics is None:
                    raise
                return self._decode_rows_lenient(raw, part)
        finally:
            if t0 is not None:
                dt = time.monotonic() - t0
                self._decode_s.inc(dt)
                if self._ledger is not None:
                    self._ledger.observe("decode", dt)

    def _decode_rows_lenient(self, raw: bytes, part):
        """Per-record decode isolating wrong-length values (CRC and
        framing errors re-raise from ``decode_record_batches`` — a
        corrupt record SET is transport damage, not a poison value)."""
        recs = decode_record_batches(raw)
        want = 4 * self._cols
        offs: List[int] = []
        rows: List[np.ndarray] = []
        bad_hi = None
        for off, value in recs:
            if len(value) == want:
                offs.append(off)
                rows.append(np.frombuffer(value, np.float32))
            else:
                self._note_decode_error(
                    part, off, value,
                    ValueError(
                        f"value length {len(value)} != {want} "
                        f"(n_cols={self._cols})"
                    ),
                )
                bad_hi = off if bad_hi is None else max(bad_hi, off)
        if not offs:
            return (
                np.empty((0,), np.int64),
                np.empty((0, self._cols), np.float32),
                bad_hi,
            )
        return np.asarray(offs, np.int64), np.vstack(rows), bad_hi

    def _poll_multi(self) -> Optional[Tuple[int, np.ndarray]]:
        """Strict round-robin interleave, vectorized: global index
        g ↦ (slot g % P, partition offset g // P). Each slot keeps a
        contiguous decoded-row buffer; emission takes min-available full
        strides and interleaves with P slice-assigns."""
        P = len(self._parts)
        g0 = self._g
        limits = []
        for s, part in enumerate(self._parts):
            off_s = (s - g0) % P  # first emission index landing on slot s
            po0 = (g0 + off_s) // P  # that record's partition offset
            buf = self._rbufs.get(s)
            if buf is None or buf.shape[0] == 0:
                raw = self._fetch_raw_part(part, po0)
                if raw:
                    offs, rows, _ = self._decode_rows(raw, part)
                    k = int(np.searchsorted(offs, po0))
                    offs, rows = offs[k:], rows[k:]
                    if offs.shape[0]:
                        if offs[0] != po0 or (np.diff(offs) != 1).any():
                            raise KafkaProtocolError(
                                f"partition {part} offset gap at {po0} "
                                "breaks the round-robin interleave contract"
                            )
                        buf = rows
                        self._rbufs[s] = buf
                        if self._last_trange is not None:
                            self._rbuf_tranges[s] = self._last_trange
                        else:
                            self._rbuf_tranges.pop(s, None)
            avail = 0 if buf is None else buf.shape[0]
            limits.append(off_s + avail * P)
        m = min(limits)
        if m <= 0:
            return None
        out = np.empty((m, self._cols), np.float32)
        trange = None
        for s in range(P):
            off_s = (s - g0) % P
            c = len(range(off_s, m, P))
            if c:
                buf = self._rbufs[s]
                out[off_s:m:P] = buf[:c]
                self._rbufs[s] = buf[c:]
                tr = self._rbuf_tranges.get(s)
                if tr is not None:
                    trange = tr if trange is None else (
                        min(trange[0], tr[0]), max(trange[1], tr[1])
                    )
        self._g = g0 + m
        # the interleaved run spans every consumed slot's fetch range
        self._stamp_ingest(g0, m, trange=trange)
        return g0, out

    def _poll_multi_auto(self) -> Optional[Tuple[int, np.ndarray]]:
        """Vector-mode poll: take the next available run from whichever
        partition has data (round-robin preference, never stalling on an
        empty one). Cursors advance to the offsets actually observed —
        offset gaps (compaction) are data, not errors — and every
        emission appends a cursor-vector snapshot for checkpointing.

        Empty partitions are probed with ``max_wait_ms=0`` — a serial
        sweep must not pay the broker's long-poll per dry partition
        (with one hot partition of P, that would cap the poll rate at
        ~1/((P-1)·max_wait) regardless of throughput); only when the
        WHOLE sweep is dry does one bounded long-poll keep the idle-
        stream blocking semantics."""
        P = len(self._parts)
        for attempt in (0, 1):
            for i in range(P):
                idx = (self._rr + i) % P
                part = self._parts[idx]
                raw = self._fetch_raw_part(
                    part,
                    self._cursors[part],
                    max_wait_ms=0 if attempt == 0 else None,
                )
                if not raw:
                    if attempt:
                        break  # one long-poll per dry sweep, not P
                    continue
                offs, rows, bad_hi = self._decode_rows(raw, part)
                k = int(np.searchsorted(offs, self._cursors[part]))
                offs, rows = offs[k:], rows[k:]
                if offs.shape[0] == 0:
                    if (
                        bad_hi is not None
                        and bad_hi >= self._cursors[part]
                    ):
                        # an all-poison fetch: advance past it, or the
                        # next poll refetches and re-quarantines forever
                        self._cursors[part] = bad_hi + 1
                        self._snap()
                    if attempt:
                        break
                    continue
                g0 = self._g
                self._g = g0 + rows.shape[0]
                self._cursors[part] = int(offs[-1]) + 1
                if bad_hi is not None:
                    # trailing poison records consumed by this fetch:
                    # the cursor moves past them exactly once
                    self._cursors[part] = max(
                        self._cursors[part], bad_hi + 1
                    )
                self._rr = (idx + 1) % P
                self._snap()
                # one fetch == one emitted run here, so the fetch's
                # event-time range stamps these global offsets exactly
                self._stamp_ingest(g0, rows.shape[0])
                return g0, rows
        return None

    def _clear_buffers(self) -> None:
        self._rbufs.clear()
        self._rbuf_tranges.clear()
        super()._clear_buffers()

    def seek(self, offset: int) -> None:
        self._rbufs.clear()
        self._rbuf_tranges.clear()
        super().seek(offset)

    def poll(self) -> Optional[Tuple[int, np.ndarray]]:
        if self._vector_mode:
            return self._poll_multi_auto()
        if self._multi:
            return self._poll_multi()
        raw = self._fetch_raw_part(self._partition, self._next)
        if not raw:
            return None
        offs, rows, bad_hi = self._decode_rows(raw, self._partition)
        # a fetch returns whole batches: drop records below the cursor
        k = int(np.searchsorted(offs, self._next))
        offs, rows = offs[k:], rows[k:]
        if offs.shape[0] == 0:
            if bad_hi is not None and bad_hi >= self._next:
                # an all-poison fetch: advance past it, or the next
                # poll refetches and re-quarantines forever
                self._next = bad_hi + 1
            return None
        first = int(offs[0])
        gaps = np.nonzero(np.diff(offs) != 1)[0]
        if gaps.size:
            # a gap means a compacted/partial topic (or a quarantined
            # poison value) — not the tabular stream contract; resync
            # the block at the gap
            stop = int(gaps[0]) + 1
            self._next = int(offs[stop])
            rows = rows[:stop]
        else:
            self._next = int(offs[-1]) + 1
            if bad_hi is not None:
                # trailing poison records: consumed exactly once
                self._next = max(self._next, bad_hi + 1)
        # the fetch's batch-header time range bounds these rows' event
        # times (batch granularity: the cursor filter above may narrow
        # the rows, never widen them — staleness stays an upper bound)
        self._stamp_ingest(first, rows.shape[0])
        return first, rows


# ---------------------------------------------------------------------------
# MiniKafkaBroker (tests / drills)
# ---------------------------------------------------------------------------


class MiniKafkaBroker:
    """In-process single-topic single-partition broker speaking the same
    wire protocol the client consumes: ApiVersions v0, Metadata v1,
    ListOffsets v1, Fetch v0–v4, Produce ignored. The FJT1-server role
    (runtime/net.py BlockFrameServer), but Kafka-framed — tests and
    kill/resume drills run against real protocol bytes."""

    def __init__(self, topic: str = "records", host: str = "127.0.0.1",
                 port: int = 0, n_partitions: int = 1):
        self.topic = topic
        self.n_partitions = n_partitions
        # per-partition parallel (offsets, values) lists — offsets are
        # explicit (not list indices) so a compacted log can hold real
        # gaps, like a real broker's; _next[p] = next offset to assign
        self._offs: List[List[int]] = [[] for _ in range(n_partitions)]
        self._vals: List[List[bytes]] = [[] for _ in range(n_partitions)]
        self._next: List[int] = [0] * n_partitions
        # per-partition encoded segments (base_offset, end_offset, batch
        # bytes): like a real broker's log, the wire format is the
        # storage format — appends encode once, fetches serve cached
        # bytes (re-encoding per fetch would make the test broker the
        # loopback bottleneck)
        self._segs: List[List[Tuple[int, int, bytes]]] = [
            [] for _ in range(n_partitions)
        ]
        self._mu = threading.Condition()
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._closing = False
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conns_mu = threading.Lock()
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    # -- producer side (in-process) --------------------------------------

    _SEG_RECORDS = 512  # records per stored batch segment

    def append(self, *values: bytes, partition: int = 0,
               timestamp_ms: Optional[int] = None) -> int:
        """→ offset of the first appended value (in ``partition``).
        ``timestamp_ms`` stamps the batch headers (CreateTime) — the
        event time the freshness plane's watermarks read; the default
        0 means "no event time" (consumers skip it)."""
        ts = 0 if timestamp_ms is None else int(timestamp_ms)
        with self._mu:
            first = self._next[partition]
            self._offs[partition].extend(
                range(first, first + len(values))
            )
            self._vals[partition].extend(values)
            self._next[partition] = first + len(values)
            segs = self._segs[partition]
            for i in range(0, len(values), self._SEG_RECORDS):
                chunk = values[i : i + self._SEG_RECORDS]
                segs.append((
                    first + i,
                    first + i + len(chunk),
                    encode_record_batch(
                        first + i, list(chunk), timestamp_ms=ts
                    ),
                ))
            self._mu.notify_all()
            return first

    def append_rows(self, rows: np.ndarray, partition: int = 0,
                    timestamp_ms: Optional[int] = None) -> int:
        """Fixed-width producer fast path: segments encode through the
        C++ batch encoder (byte-identical output; a failed build raises
        ``NativeBuildError``), so a
        million-row log appends in tenths of a second instead of tens.
        ``timestamp_ms`` stamps the batch headers with an event time —
        the native encoder writes timestamp 0, so a stamped append
        takes the Python encoder (the load generators that stamp append
        in paced chunks, where the Python path keeps up)."""
        from flink_jpmml_tpu_torch.runtime import native

        rows = np.ascontiguousarray(rows, np.float32)
        if rows.shape[0] == 0:  # round-robin slices can be empty
            with self._mu:
                return self._next[partition]
        raw = rows.view(np.uint8).reshape(rows.shape[0], -1)
        with self._mu:
            first = self._next[partition]
            segs = self._segs[partition]
            for i in range(0, rows.shape[0], self._SEG_RECORDS):
                chunk = raw[i : i + self._SEG_RECORDS]
                base = first + i
                if timestamp_ms is None:
                    blob = native.kafka_encode_fixed(chunk, base)
                else:
                    blob = encode_record_batch(
                        base,
                        [chunk[j].tobytes() for j in range(chunk.shape[0])],
                        timestamp_ms=int(timestamp_ms),
                    )
                segs.append((base, base + chunk.shape[0], blob))
            self._offs[partition].extend(
                range(first, first + rows.shape[0])
            )
            self._vals[partition].extend(
                raw[i].tobytes() for i in range(raw.shape[0])
            )
            self._next[partition] = first + rows.shape[0]
            self._mu.notify_all()
            return first

    def append_rows_round_robin(
        self, rows: np.ndarray, timestamp_ms: Optional[int] = None
    ) -> None:
        """Row i → partition i % n_partitions (the producer layout the
        multi-partition sources' strict interleave consumes). Chunked
        producers must pass chunks whose length divides by n_partitions,
        or the round-robin phase restarts mid-stream."""
        rows = np.ascontiguousarray(rows, np.float32)
        for p in range(self.n_partitions):
            self.append_rows(
                rows[p :: self.n_partitions], partition=p,
                timestamp_ms=timestamp_ms,
            )

    @property
    def high_watermark(self) -> int:
        """Total records across ALL partitions — so produced-vs-consumed
        waits stay correct on a multi-partition broker (per-partition
        watermarks ride the Fetch/ListOffsets responses)."""
        with self._mu:
            return sum(len(v) for v in self._vals)

    def close(self) -> None:
        self._closing = True
        # unblock a parked accept() BEFORE closing the listener: on
        # Linux, close() does not interrupt a thread blocked in
        # accept(), and the in-flight syscall keeps the kernel LISTEN
        # entry alive — a same-port restart then fails EADDRINUSE until
        # some client happens to connect (the serial consumers always
        # did, by reconnecting; a prefetch sidecar sitting in backoff
        # does not). One self-connect completes the accept so the loop
        # observes _closing and releases the last reference.
        try:
            poke = socket.create_connection(
                (self.host, self.port), timeout=0.5
            )
            poke.close()
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        # close accepted connections too: a serve thread parked in recv
        # would otherwise hold the port in ESTABLISHED/CLOSE_WAIT and
        # make an immediate same-port restart fail with EADDRINUSE
        # (SO_REUSEADDR only forgives TIME_WAIT)
        with self._conns_mu:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        with self._mu:
            self._mu.notify_all()

    # -- server side ------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            # register BEFORE spawning, and re-check _closing after: a
            # close() racing this accept must still find (or beat) the
            # connection in _conns so no socket outlives the broker
            with self._conns_mu:
                self._conns.append(conn)
            if self._closing:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            t = threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._closing:
                hdr = self._recv_exact(conn, 4)
                if hdr is None:
                    return
                (size,) = _I32.unpack(hdr)
                payload = self._recv_exact(conn, size)
                if payload is None:
                    return
                r = _Reader(payload)
                api_key = r.i16()
                api_version = r.i16()
                corr = r.i32()
                r.string()  # client id
                body = self._dispatch(api_key, api_version, r)
                if body is None:
                    return
                msg = _I32.pack(corr) + body
                conn.sendall(_I32.pack(len(msg)) + msg)
        except (OSError, ConnectionError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            # drop the registry entry: a long-lived broker must not
            # accumulate closed sockets across normal disconnects
            with self._conns_mu:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        from flink_jpmml_tpu_torch.utils.netio import recv_exact

        return recv_exact(conn, n)

    def _dispatch(self, api_key: int, v: int, r: _Reader) -> Optional[bytes]:
        if api_key == API_VERSIONS:
            w = _Writer()
            w.i16(0).i32(5)
            # Advertise exactly the versions _dispatch answers in: the
            # Fetch/ListOffsets/Metadata responses below are fixed v4/v1/v1
            # shapes, so offering lower versions would let a client pick one
            # and mis-parse the reply.
            for k, lo, hi in (
                (API_FETCH, 4, 4),
                (API_LIST_OFFSETS, 1, 1),
                (API_METADATA, 1, 1),
                (API_VERSIONS, 0, 0),
            ):
                w.i16(k).i16(lo).i16(hi)
            return bytes(w.b)
        if api_key == API_METADATA:
            for _ in range(max(r.i32(), 0)):
                r.string()
            w = _Writer()
            w.i32(1)  # brokers
            w.i32(0).string(self.host).i32(self.port).string(None)
            w.i32(0)  # controller id
            w.i32(1)  # topics
            w.i16(0).string(self.topic).i8(0)
            w.i32(self.n_partitions)
            for idx in range(self.n_partitions):
                w.i16(0).i32(idx).i32(0)  # err, index, leader
                w.i32(1).i32(0)  # replicas
                w.i32(1).i32(0)  # isr
            return bytes(w.b)
        if api_key == API_LIST_OFFSETS:
            r.i32()  # replica id
            r.i32()  # topic count (1)
            r.string()
            r.i32()  # partition count (1)
            part = r.i32()
            ts = r.i64()
            with self._mu:
                ok_part = 0 <= part < len(self._offs)
                if ts == -2:  # earliest surviving offset
                    offs = self._offs[part] if ok_part else []
                    off = offs[0] if offs else (
                        self._next[part] if ok_part else 0
                    )
                else:  # latest = next offset to be assigned
                    off = self._next[part] if ok_part else 0
            w = _Writer()
            w.i32(1).string(self.topic)
            # err 3 = UNKNOWN_TOPIC_OR_PARTITION: a misconfigured
            # consumer must fail fast, not poll an empty phantom log
            w.i32(1).i32(part).i16(0 if ok_part else 3).i64(-1).i64(off)
            return bytes(w.b)
        if api_key == API_FETCH:
            r.i32()  # replica id
            max_wait_ms = r.i32()
            r.i32()  # min bytes
            if v >= 3:
                r.i32()  # max bytes
            if v >= 4:
                r.i8()  # isolation level
            r.i32()  # topic count
            r.string()
            r.i32()  # partition count
            part = r.i32()
            fetch_offset = r.i64()
            part_max_bytes = r.i32()
            deadline = time.monotonic() + max_wait_ms / 1000.0
            with self._mu:
                ok_part = 0 <= part < len(self._offs)
                segs = self._segs[part] if ok_part else []
                while (
                    ok_part
                    and self._next[part] <= fetch_offset
                    and not self._closing
                    and time.monotonic() < deadline
                ):
                    self._mu.wait(
                        max(deadline - time.monotonic(), 0.001)
                    )
                hw = self._next[part] if ok_part else 0
                parts: List[bytes] = []
                if fetch_offset < hw:
                    # serve the cached encoded segments (a real broker's
                    # fetch is sendfile over stored batches); whole
                    # batches may start before fetch_offset — consumers
                    # filter. At least one segment always ships so the
                    # fetch makes progress; an oversized head segment
                    # falls back to a bounded re-encode.
                    import bisect

                    j = bisect.bisect_right(
                        segs, fetch_offset, key=lambda s: s[0]
                    ) - 1
                    if j < 0:
                        j = 0
                    while (
                        j < len(segs) and segs[j][1] <= fetch_offset
                    ):
                        j += 1
                    size = 0
                    while j < len(segs):
                        _, _, blob = segs[j]
                        if parts and size + len(blob) > part_max_bytes:
                            break
                        if not parts and len(blob) > part_max_bytes:
                            offs_l = self._offs[part]
                            k = bisect.bisect_left(offs_l, fetch_offset)
                            values = []
                            size2 = 0
                            base = None
                            while k < len(offs_l):
                                o, val = offs_l[k], self._vals[part][k]
                                if base is None:
                                    base = o
                                elif o != base + len(values):
                                    break  # re-encode one contiguous run
                                size2 += len(val) + 32
                                if values and size2 > part_max_bytes:
                                    break
                                values.append(val)
                                k += 1
                            parts = [
                                encode_record_batch(base, values)
                            ] if values else []
                            break
                        parts.append(blob)
                        size += len(blob)
                        j += 1
            record_set = b"".join(parts)
            w = _Writer()
            w.i32(0)  # throttle
            w.i32(1).string(self.topic)
            w.i32(1)
            # err 3 = UNKNOWN_TOPIC_OR_PARTITION for an out-of-range
            # partition index (a real broker fails the fetch; an empty
            # err-0 log would mask the misconfiguration forever)
            w.i32(part).i16(0 if ok_part else 3).i64(hw)
            w.i64(hw)  # last stable offset
            w.i32(0)  # aborted txns
            w.bytes_(record_set)
            return bytes(w.b)
        # unknown api: close the connection (real brokers error; fine here)
        return None
