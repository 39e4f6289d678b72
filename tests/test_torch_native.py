"""The port's C++ host data plane (``flink_jpmml_tpu_torch/runtime/native.py``
over its copy of ``fjt_native.cpp``) against the JAX package's
``flink_jpmml_tpu.runtime.native`` and against the plain versions:

- the bucketizer, byte for byte, on uint8 and uint16 wires, down the
  ragged and the lockstep branch, over NaN, an explicit mask,
  ``missingValueReplacement``, ±inf, exact cut values and ±0.0
  (``chip_smoke.edge_cells``), at several batch lengths and thread counts;
- the ring (the JAX package's four ring behaviours,
  tests/test_native_block.py, on ``NativeRing``), and four more: a wrap,
  a block larger than the ring drained while it is pushed, two producers
  whose blocks stay whole, and a block that fits drainable only whole
  (the block pipeline's dispatches, and the overload drill's latency
  samples in ``chip_smoke.py``, are aligned to blocks by it);
- the fixed-width Kafka codec, byte for byte;
- no fall-back: a plane that cannot be built raises ``NativeBuildError``
  where the JAX package would drop to the Python ring or to numpy;
- the shared build helper: a library is named for its source and flags.
"""

import ctypes
import threading
import time

import numpy as np
import pytest

from chip_smoke import edge_cells, skewed_sizes, synthetic_wire
from flink_jpmml_tpu.compile.qtrees import QuantizedWire as JaxWire
from flink_jpmml_tpu.runtime import kafka as jkafka
from flink_jpmml_tpu.runtime import native as jnative
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime import native
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, FiniteBlockSource
from flink_jpmml_tpu_torch.utils import build
from flink_jpmml_tpu_torch.utils.exceptions import NativeBuildError

# cut-table sizes per field: balanced tables take the lockstep branch, one
# long table among short ones the ragged branch; empty tables in each
WIRES = {
    "u8_lockstep": ([250, 200, 180, 230, 0, 160, 240], np.uint8, "lockstep"),
    "u8_ragged": (skewed_sizes(7, 200), np.uint8, "ragged"),
    "u16_lockstep": ([900, 600, 1000, 0, 700, 850, 500], np.uint16,
                     "lockstep"),
    "u16_ragged": (skewed_sizes(7, 3000), np.uint16, "ragged"),
}


def _wires(kind):
    """(the port's wire, the JAX package's wire over the same tables)."""
    sizes, dtype, _ = WIRES[kind]
    w = synthetic_wire(11, sizes, dtype)
    jw = JaxWire(fields=w.fields, cuts=w.cuts, dtype=w.dtype,
                 sentinel=w.sentinel, repl=w.repl, has_repl=w.has_repl)
    return w, jw


def _cells(wire, n, seed):
    rng = np.random.default_rng(seed)
    X = edge_cells(rng, wire.cuts, n)
    M = rng.random(size=X.shape) < 0.1
    return X, M


@pytest.mark.parametrize("kind", sorted(WIRES))
def test_branch_and_tables_match_the_jax_package(kind):
    w, jw = _wires(kind)
    padded, L = w._pow2_tables()
    jpadded, jL = jw._pow2_tables()
    assert (padded is None) == (WIRES[kind][2] == "ragged")
    assert L == jL and (padded is None) == (jpadded is None)
    if padded is not None:
        np.testing.assert_array_equal(padded, jpadded)
    for a, b in zip(w._flat_tables(), jw._flat_tables()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_threads", [1, 0])
@pytest.mark.parametrize("n", [0, 1, 4095, 4097, 70_001])
@pytest.mark.parametrize("kind", sorted(WIRES))
def test_bucketizer_byte_identical(kind, n, n_threads):
    w, _ = _wires(kind)
    X, M = _cells(w, n, seed=n + 7)
    has_repl = w.has_repl.astype(np.uint8)
    padded, L = w._pow2_tables()
    for mask in (None, M):
        if padded is not None:
            args = (X, padded, L, w.repl, has_repl, w.dtype)
            got = native.bucketize_pow2(*args, mask=mask, n_threads=n_threads)
            jax_got = jnative.bucketize_pow2(*args, mask=mask,
                                             n_threads=n_threads)
        else:
            flat, offs = w._flat_tables()
            args = (X, flat, offs, w.repl, has_repl, w.dtype)
            got = native.bucketize(*args, mask=mask, n_threads=n_threads)
            jax_got = jnative.bucketize(*args, mask=mask, n_threads=n_threads)
        ref = w.encode_reference(X, mask)
        assert jax_got is not None, jnative.build_error()
        assert got.dtype == ref.dtype == jax_got.dtype == w.dtype
        assert got.shape == (n, len(w.cuts))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, jax_got)


@pytest.mark.parametrize("kind", sorted(WIRES))
def test_wire_encode_matches_the_jax_package(kind):
    w, jw = _wires(kind)
    X, M = _cells(w, 9_001, seed=3)
    for mask in (None, M):
        got = w.encode(X, mask)
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, jw.encode(X, mask))
        np.testing.assert_array_equal(got, w.encode_reference(X, mask))
    # the cells the encode must get right are there
    assert np.isnan(X).any() and np.isposinf(X).any() and np.isneginf(X).any()
    assert (np.signbit(X) & (X == 0)).any()
    assert any(np.isin(X[:, j], c).any() for j, c in enumerate(w.cuts))


def test_bucketizer_rejects_bad_tables():
    w, _ = _wires("u8_ragged")
    flat, offs = w._flat_tables()
    X = np.zeros((4, len(w.cuts)), np.float32)
    with pytest.raises(ValueError):
        native.bucketize(X, flat, offs[:-1], w.repl, w.has_repl, np.uint8)
    with pytest.raises(ValueError):
        native.bucketize_pow2(X, np.zeros((len(w.cuts), 3), np.float32), 3,
                              w.repl, w.has_repl, np.uint8)
    with pytest.raises(ValueError):
        native.bucketize(X, flat, offs, w.repl, w.has_repl, np.int32)


# -- the ring: the JAX package's four behaviours -----------------------------


def test_ring_roundtrip_order_and_offsets():
    ring = native.NativeRing(capacity=1024, arity=4, batch_size=256)
    blk = np.arange(32, dtype=np.float32).reshape(8, 4)
    assert ring.push_block(blk, first_offset=100) == 8
    out, offs = ring.drain(deadline_us=1000)
    np.testing.assert_array_equal(out, blk)
    assert offs.tolist() == list(range(100, 108))


def test_ring_fill_or_deadline():
    ring = native.NativeRing(capacity=1024, arity=2, batch_size=64)
    ring.push_block(np.ones((10, 2), np.float32), 0)
    t0 = time.monotonic()
    out, _ = ring.drain(deadline_us=30_000)
    assert out.shape[0] == 10  # partial batch after the deadline
    assert time.monotonic() - t0 < 1.0


def test_ring_backpressure_blocks_producer():
    ring = native.NativeRing(capacity=8, arity=1, batch_size=8)
    assert ring.push_block(np.ones((8, 1), np.float32), 0) == 8
    # ring full: a timed push returns short
    assert ring.push_block(np.ones((4, 1), np.float32), 8,
                           timeout_us=50_000) == 0
    ring.drain(deadline_us=100)
    assert ring.push_block(np.ones((4, 1), np.float32), 8,
                           timeout_us=50_000) == 4


def test_ring_threaded_producer_consumer_conserves_records():
    ring = native.NativeRing(capacity=4096, arity=3, batch_size=512)
    N, BLK = 100_000, 1000

    def produce():
        sent = 0
        while sent < N:
            blk = np.full((BLK, 3), sent, np.float32)
            got = 0
            while got < BLK:
                got += ring.push_block(blk[got:], sent + got,
                                       timeout_us=1_000_000)
            sent += BLK
        ring.close()

    t = threading.Thread(target=produce)
    t.start()
    offsets_seen = []
    while True:
        out, offs = ring.drain(deadline_us=2000)
        if out.shape[0] == 0:
            break
        # every record carries the offset its block started at
        np.testing.assert_array_equal(out[:, 0], offs - offs % BLK)
        offsets_seen.append(offs.copy())
    t.join(timeout=60)
    assert not t.is_alive()
    all_offs = np.concatenate(offsets_seen)
    assert np.array_equal(np.sort(all_offs), np.arange(N, dtype=np.uint64))


def test_ring_wraps_in_order():
    ring = native.NativeRing(capacity=10, arity=3, batch_size=10)
    data = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    assert ring.push_block(data[:7], 0) == 7
    out, offs = ring.drain(deadline_us=100)
    got, got_offs = [out.copy()], [offs.copy()]
    assert ring.push_block(data[7:], 7) == 6  # slots 7..9, then 0..2
    assert len(ring) == 6
    out, offs = ring.drain(deadline_us=100)
    got.append(out.copy())
    got_offs.append(offs.copy())
    np.testing.assert_array_equal(np.concatenate(got), data)
    assert np.concatenate(got_offs).tolist() == list(range(13))
    assert len(ring) == 0


def test_ring_block_larger_than_the_ring_drains_in_order():
    # the block goes in as several takes, each as much as there is room
    # for, and the consumer drains while it is still being pushed
    N = 1_000_003
    ring = native.NativeRing(capacity=300_000, arity=1, batch_size=65_536)
    data = np.arange(N, dtype=np.float32).reshape(N, 1)
    pushed = []

    def produce():
        got = 0
        while got < N:
            got += ring.push_block(data[got:], 5 + got, timeout_us=1_000_000)
        pushed.append(got)
        ring.close()

    t = threading.Thread(target=produce)
    t.start()
    outs, offs_seen = [], []
    while True:
        out, offs = ring.drain(deadline_us=2000)
        if out.shape[0] == 0:
            break
        outs.append(out.copy())
        offs_seen.append(offs.copy())
    t.join(timeout=60)
    assert not t.is_alive() and pushed == [N]
    np.testing.assert_array_equal(np.concatenate(outs), data)
    assert np.array_equal(np.concatenate(offs_seen),
                          np.arange(5, N + 5, dtype=np.uint64))


def test_ring_two_producers_keep_each_block_whole():
    # room for every block, so no block is split by backpressure (a
    # producer that finds less room than its block pushes what fits)
    BLK, PER = 100, 200
    ring = native.NativeRing(capacity=2 * PER * BLK, arity=2, batch_size=256)

    def produce(p):
        for b in range(PER):
            first = (p * PER + b) * BLK
            blk = np.full((BLK, 2), first, np.float32)
            got = 0
            while got < BLK:
                got += ring.push_block(blk[got:], first + got,
                                       timeout_us=1_000_000)

    ts = [threading.Thread(target=produce, args=(p,)) for p in range(2)]
    for t in ts:
        t.start()
    outs, offs_seen = [], []
    while sum(o.shape[0] for o in outs) < 2 * PER * BLK:
        out, offs = ring.drain(deadline_us=2000, idle_timeout_us=5_000_000)
        assert out.shape[0] > 0
        outs.append(out.copy())
        offs_seen.append(offs.copy())
    for t in ts:
        t.join(timeout=60)
    vals = np.concatenate(outs)[:, 0].astype(np.uint64)
    offs = np.concatenate(offs_seen)
    # every record carries its block's first offset, each block's records
    # arrive together and in order, and every block arrives once
    np.testing.assert_array_equal(vals, offs - offs % BLK)
    starts = np.flatnonzero(offs % BLK == 0)
    assert np.array_equal(starts, np.arange(0, 2 * PER * BLK, BLK))
    for s in starts:
        assert np.array_equal(offs[s:s + BLK], offs[s] + np.arange(BLK))
    assert np.array_equal(np.sort(offs),
                          np.arange(2 * PER * BLK, dtype=np.uint64))


def test_a_block_that_fits_is_drained_whole():
    # a drain never sees part of a block that fits (the JAX ring's
    # visibility): each drain returns whole blocks, as a dispatch of the
    # block pipeline aggregates them
    BLK = 65_536
    ring = native.NativeRing(capacity=4 * BLK, arity=8, batch_size=BLK)
    data = np.random.default_rng(0).random((BLK, 8), dtype=np.float32)

    def produce():
        for b in range(40):
            ring.push_block(data, b * BLK)
        ring.close()

    t = threading.Thread(target=produce)
    t.start()
    n = 0
    while True:
        out, offs = ring.drain(deadline_us=0)
        if out.shape[0] == 0:
            break
        assert out.shape[0] == BLK and offs[0] == n
        np.testing.assert_array_equal(out, data)
        n += BLK
    t.join(timeout=60)
    assert n == 40 * BLK


def test_close_wakes_a_blocked_producer():
    ring = native.NativeRing(capacity=4, arity=1, batch_size=4)
    ring.push_block(np.ones((4, 1), np.float32), 0)
    pushed = []
    t = threading.Thread(target=lambda: pushed.append(
        ring.push_block(np.ones((3, 1), np.float32), 4)))  # waits forever
    t.start()
    time.sleep(0.05)
    assert t.is_alive() and ring.closed is False
    ring.close()
    t.join(timeout=10)
    assert not t.is_alive() and pushed == [0] and ring.closed


# -- the Kafka codec --------------------------------------------------------

@pytest.mark.parametrize("n,value_len,base", [
    (1, 1, 0), (3, 16, 5), (1000, 128, 1 << 40),
])
def test_kafka_codec_byte_identical(n, value_len, base):
    values = np.random.default_rng(n).integers(
        0, 256, size=(n, value_len)).astype(np.uint8)
    buf = native.kafka_encode_fixed(values, base)
    assert buf == jnative.kafka_encode_fixed(values, base)
    assert buf == jkafka.encode_record_batch(base, [v.tobytes() for v in values])
    offs, got = native.kafka_decode_fixed(buf, value_len)
    joffs, jgot = jnative.kafka_decode_fixed(buf, value_len)
    np.testing.assert_array_equal(offs, np.arange(base, base + n))
    np.testing.assert_array_equal(got, values)
    np.testing.assert_array_equal(offs, joffs)
    np.testing.assert_array_equal(got, jgot)


def test_kafka_decode_refuses_what_the_jax_package_refuses():
    mixed = jkafka.encode_record_batch(0, [b"abcd", b"ef"])
    assert native.kafka_decode_fixed(mixed, 4) is None
    assert jnative.kafka_decode_fixed(mixed, 4) is None
    buf = bytearray(native.kafka_encode_fixed(np.ones((4, 8), np.uint8), 0))
    buf[-1] ^= 0xFF  # the CRC covers the records
    with pytest.raises(ValueError, match="CRC32C"):
        native.kafka_decode_fixed(bytes(buf), 8)


# -- no fall-back -----------------------------------------------------------

def _broken_loader():
    raise NativeBuildError("g++ failed (1):\nfjt_native.cpp: error: injected")


def test_a_failed_build_raises_everywhere(monkeypatch, tmp_path):
    doc = parse_pmml_file(gen_gbm(str(tmp_path), n_trees=3, depth=2,
                                  n_features=4))
    cm = compile_pmml(doc, batch_size=8, device="cpu")
    wire = cm.quantized_scorer().wire
    X = np.zeros((8, 4), np.float32)
    monkeypatch.setattr(native, "load", _broken_loader)
    with pytest.raises(NativeBuildError, match="injected"):
        native.NativeRing(16, 4, 8)
    with pytest.raises(NativeBuildError, match="injected"):
        BlockPipeline(FiniteBlockSource(X, 8), cm, lambda *a: None)
    with pytest.raises(NativeBuildError, match="injected"):
        wire.encode(X)
    # the numpy encode runs only where a caller asks for it
    assert wire.encode_reference(X).shape == (8, 4)


def test_g_plus_plus_errors_reach_the_caller(monkeypatch, tmp_path):
    src = tmp_path / "fjt_native.cpp"
    src.write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(NativeBuildError, match="g\\+\\+ failed") as err:
        native.load()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


# -- the shared build helper -------------------------------------------------

def test_library_name_follows_source_and_flags(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    base = build.lib_path(tmp_path, "liba", src, ("-O3",))
    assert base == build.lib_path(tmp_path, "liba", src, ("-O3",))
    assert base != build.lib_path(tmp_path, "liba", src, ("-O2",))
    src.write_text("int f() { return 2; }\n")
    assert base != build.lib_path(tmp_path, "liba", src, ("-O3",))


def test_build_shared_builds_once_and_installs_whole(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text('extern "C" int f() { return 7; }\n')
    flags = ("-O2", "-shared", "-fPIC")
    path = build.lib_path(tmp_path / "out", "liba", src, flags)
    assert isinstance(
        build.build_shared("g++", flags, src, path, NativeBuildError), str)
    assert build.build_shared("g++", flags, src, path, NativeBuildError) is None
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    assert ctypes.CDLL(str(path)).f() == 7


def test_a_missing_compiler_raises_the_callers_error(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f();\n")
    with pytest.raises(NativeBuildError, match="invocation failed"):
        build.build_shared(str(tmp_path / "no-such-g++"), (), src,
                           tmp_path / "a.so", NativeBuildError)
