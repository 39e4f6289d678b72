"""The port's Kafka ingest (``flink_jpmml_tpu_torch/runtime/kafka.py``)
against the JAX package's on the CPU: the magic-v2 codec byte for byte,
the three row decoders and their errors, the wire protocol across the two
packages' clients and brokers, the block source's ``(first_offset,
block)`` sequence on 1 and 3 partitions across a seek, the ``kafka_lag``
gauges, and the reconnect after an injected broker death.

Every broker listens on loopback port 0 and every broker, client and
source is closed in a ``finally``, so the file runs under xdist.
"""

import time

import numpy as np
import pytest

from flink_jpmml_tpu.runtime import faults as jfaults
from flink_jpmml_tpu.runtime import kafka as jk
from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JRegistry
from flink_jpmml_tpu_torch.runtime import faults as tfaults
from flink_jpmml_tpu_torch.runtime import kafka as tk
from flink_jpmml_tpu_torch.runtime import native as tnative
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

F = 8  # feature columns of the tabular stream


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("FJT_FLIGHT_DIR", str(tmp_path / "flight"))


def _rows(seed: int, n: int, cols: int = F) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.5, size=(n, cols)).astype(np.float32)
    X[rng.random(size=X.shape) < 0.2] = np.nan
    return X


def _values(X: np.ndarray) -> list:
    return [X[i].tobytes() for i in range(X.shape[0])]


# -- the codec --------------------------------------------------------------


@pytest.mark.parametrize("timestamp_ms", [0, 1_700_000_000_123])
@pytest.mark.parametrize("n", [1, 37, 600])
def test_encode_record_batch_is_byte_identical(timestamp_ms, n):
    vals = _values(_rows(n, n))
    got = tk.encode_record_batch(5, vals, timestamp_ms=timestamp_ms)
    assert got == jk.encode_record_batch(5, vals, timestamp_ms=timestamp_ms)


@pytest.mark.parametrize("size", [0, 7, 63, 64, 65, 1000, 4099])
def test_crc32c_and_its_vectorized_engine_agree(size):
    data = np.random.default_rng(size).integers(
        0, 256, size=size, dtype=np.uint8).tobytes()
    want = jk.crc32c(data)
    assert tk.crc32c(data) == want
    assert tk.crc32c_vec(data) == want
    assert jk.crc32c_vec(data) == want


def _record_set(name: str) -> bytes:
    """Record-set bytes of the shapes the decoders branch on."""
    X = _rows(1, 1500)
    if name in ("native", "truncated"):
        raw = X.view(np.uint8).reshape(X.shape[0], -1)
        buf = b"".join(tnative.kafka_encode_fixed(raw[i:i + 512], i)
                       for i in range(0, X.shape[0], 512))
        # a partial trailing batch is dropped by every decoder
        return buf[:-100] if name == "truncated" else buf
    if name == "python":
        return b"".join(
            tk.encode_record_batch(i, _values(X[i:i + 400]), timestamp_ms=42)
            for i in range(0, X.shape[0], 400))
    if name == "headers":
        # the port produces no headers; the JAX encoder makes a record
        # that carries one, which every decoder must skip
        hdrs = [None] * 50
        hdrs[3] = [("traceparent", b"00-1-2-01")]
        return jk.encode_record_batch(0, _values(X[:50]), headers=hdrs)
    return b""


@pytest.mark.parametrize(
    "name", ["native", "python", "headers", "truncated", "empty"])
def test_row_decoders_agree_across_tiers_and_packages(name):
    buf = _record_set(name)
    want_offs, want_rows = jk.decode_record_batches_rows_py(buf, F)
    for dec in (tk.decode_record_batches_rows, tk.decode_record_batches_rows_vec,
                tk.decode_record_batches_rows_py, jk.decode_record_batches_rows,
                jk.decode_record_batches_rows_vec):
        offs, rows = dec(buf, F)
        assert offs.dtype == np.int64 and rows.dtype == np.float32
        assert offs.tobytes() == want_offs.tobytes(), dec
        assert rows.tobytes() == want_rows.tobytes(), dec
    assert tk.record_batch_time_range(buf) == jk.record_batch_time_range(buf)
    assert tk.decode_record_batches(buf) == jk.decode_record_batches(buf)


@pytest.mark.parametrize("name", ["crc", "wrong_length"])
def test_row_decoders_raise_the_same_error(name):
    X = _rows(2, 100)
    if name == "crc":
        buf = bytearray(tk.encode_record_batch(0, _values(X)))
        buf[-5] ^= 0xFF  # inside the records: the stored CRC no longer holds
        buf = bytes(buf)
    else:
        buf = tk.encode_record_batch(
            0, _values(X[:10]) + [b"\x00" * (4 * F + 4)])
    with pytest.raises(ValueError) as want:
        jk.decode_record_batches_rows_py(buf, F)
    for dec in (tk.decode_record_batches_rows, tk.decode_record_batches_rows_vec,
                tk.decode_record_batches_rows_py, jk.decode_record_batches_rows,
                jk.decode_record_batches_rows_vec):
        with pytest.raises(ValueError) as got:
            dec(buf, F)
        assert str(got.value) == str(want.value), dec


# -- the wire protocol across the packages -----------------------------------


def _client_view(client_cls, broker, n_rows):
    c = client_cls(broker.host, broker.port)
    try:
        meta = c.metadata(broker.topic)
        offsets = [(c.list_offset(broker.topic, p, -2),
                    c.list_offset(broker.topic, p, -1))
                   for p in range(broker.n_partitions)]
        rows, pos = [], 0
        while pos < n_rows:
            hw, raw = c.fetch_raw(broker.topic, 0, pos, max_wait_ms=10,
                                  max_bytes=20_000)
            offs, blk = jk.decode_record_batches_rows_py(bytes(raw), F)
            keep = offs >= pos
            rows.append((offs[keep], blk[keep]))
            pos = int(offs[-1]) + 1
        return meta, offsets, hw, rows
    finally:
        c.close()


@pytest.mark.parametrize("broker_pkg", ["jax", "port"])
def test_clients_and_brokers_interoperate(broker_pkg):
    X = _rows(3, 3000)
    broker = (jk if broker_pkg == "jax" else tk).MiniKafkaBroker(
        topic="t", n_partitions=2)
    try:
        broker.append_rows(X)
        broker.append_rows(X[:10], partition=1)
        port_view = _client_view(tk.KafkaClient, broker, X.shape[0])
        jax_view = _client_view(jk.KafkaClient, broker, X.shape[0])
    finally:
        broker.close()
    for view in (port_view, jax_view):
        (brokers, parts), offsets, hw, rows = view
        assert parts == {0: 0, 1: 0} and len(brokers) == 1
        assert offsets == [(0, 3000), (0, 10)] and hw == 3000
        offs = np.concatenate([o for o, _ in rows])
        assert offs.tobytes() == np.arange(3000, dtype=np.int64).tobytes()
        assert np.concatenate([b for _, b in rows]).tobytes() == X.tobytes()
    assert port_view[0] == jax_view[0]
    assert port_view[1] == jax_view[1]


def test_brokers_serve_the_same_bytes():
    X = _rows(4, 2000)
    tb, jb = tk.MiniKafkaBroker(topic="t"), jk.MiniKafkaBroker(topic="t")
    c1 = tk.KafkaClient(tb.host, tb.port)
    c2 = tk.KafkaClient(jb.host, jb.port)
    try:
        tb.append_rows(X)
        jb.append_rows(X)
        for off in (0, 511, 512, 1999):
            a = c1.fetch_raw("t", 0, off, max_bytes=100_000)
            b = c2.fetch_raw("t", 0, off, max_bytes=100_000)
            assert a[0] == b[0] and bytes(a[1]) == bytes(b[1])
    finally:
        c1.close()
        c2.close()
        tb.close()
        jb.close()


# -- the block source ---------------------------------------------------------


def _read(src, want, timeout=30.0):
    got, pos = [], 0
    deadline = time.monotonic() + timeout
    while pos < want and time.monotonic() < deadline:
        polled = src.poll()
        if polled is None:
            continue
        got.append((polled[0], polled[1].tobytes()))
        pos += polled[1].shape[0]
    assert pos == want
    return got


def _source_run(pkg, broker, parts, metrics):
    """Poll the whole log, seek, poll again → (first_offset, block bytes)
    sequence and the ``kafka_lag`` gauges."""
    kw = dict(n_cols=F, max_wait_ms=5, max_bytes=9_000, metrics=metrics)
    if parts > 1:
        kw["partitions"] = list(range(parts))
    src = pkg.KafkaBlockSource(broker.host, broker.port, "t", **kw)
    try:
        seq = _read(src, 1800)
        if parts == 1:
            src.seek(700)
            seq += _read(src, 1100)
        else:
            # auto interleave: seek back to the snapshot floor; the
            # per-partition cursors stay, so new rows are what comes next
            src.seek(0)
            broker.append_rows_round_robin(_rows(6, 300))
            seq += _read(src, 300)
    finally:
        src.close()
    snap = metrics.struct_snapshot()["gauges"]
    lag = {k: v["value"] for k, v in snap.items() if k.startswith("kafka_lag{")}
    return seq, lag


@pytest.mark.parametrize("parts", [1, 3])
def test_block_source_sequences_match_the_jax_source(parts):
    X = _rows(5, 1800)
    seqs, lags = [], []
    for pkg, reg in ((jk, JRegistry()), (tk, TRegistry())):
        broker = tk.MiniKafkaBroker(topic="t", n_partitions=parts)
        try:
            if parts == 1:
                broker.append_rows(X)
            else:
                broker.append_rows_round_robin(X)
            seq, lag = _source_run(pkg, broker, parts, reg)
        finally:
            broker.close()
        seqs.append(seq)
        lags.append(lag)
    assert len(seqs[0]) > 3  # many small fetches, not one
    assert seqs[0] == seqs[1]
    assert lags[0] == lags[1] and len(lags[0]) == parts


@pytest.mark.parametrize("pkg,faults_mod", [(jk, jfaults), (tk, tfaults)],
                         ids=["jax", "port"])
def test_injected_broker_death_rides_the_reconnect(pkg, faults_mod):
    X = _rows(7, 900)
    broker = pkg.MiniKafkaBroker(topic="t")
    reg = (JRegistry if pkg is jk else TRegistry)()
    src = pkg.KafkaBlockSource(broker.host, broker.port, "t", n_cols=F,
                               max_wait_ms=5, metrics=reg,
                               reconnect_backoff_s=0.001)
    try:
        broker.append_rows(X)
        fault = faults_mod.inject("broker_death", n=3)
        dead = [src.poll() for _ in range(3)]
        assert dead == [None, None, None]
        assert fault.fires == 3 and faults_mod.stats() == {"broker_death": 3}
        assert reg.gauge("reconnect_backoff_s").get() > 0
        got = _read(src, 900)
        assert got[0][0] == 0  # resumed at the cursor
        assert b"".join(b for _, b in got) == X.tobytes()
        assert reg.gauge("reconnect_backoff_s").get() == 0
    finally:
        faults_mod.clear()
        src.close()
        broker.close()


def test_chip_smoke_kafka_wire_phase_on_a_small_log():
    # the card run's wire phase is host code: rehearse it on a short log
    from chip_smoke import features, kafka_wire

    rows = features(np.random.default_rng(0), 30_000, F)
    broker, line = kafka_wire(rows)
    try:
        assert broker.high_watermark == 30_000
    finally:
        broker.close()
    assert line["read_back_identical"] and line["tiers_identical"]
    assert line["python_check_rows"] == 20_480 and line["fetches"] >= 1
    assert line["cpp_decode_ms"] > 0 and line["value_bytes"] == rows.nbytes


# -- the producer side: record headers and Produce v3 ------------------------


def _header_cases():
    rng = np.random.default_rng(21)
    vals = [rng.integers(0, 256, size=int(k), dtype=np.uint8).tobytes()
            for k in rng.integers(0, 40, size=6)]
    tp = b"00-" + b"ab" * 16 + b"-" + b"cd" * 8 + b"-01"
    binary = rng.integers(0, 256, size=300, dtype=np.uint8).tobytes()
    return {
        "none": (vals, None),
        "all_none": (vals, [None] * 6),
        "empty_lists": (vals, [[] for _ in range(6)]),
        "mixed": (vals, [None, [("traceparent", tp)], [],
                         [("traceparent", tp), ("other", b"\x00\x01")],
                         None, [("k", b"")]]),
        "several_keys": (vals, [[(f"key{j}", bytes([i, j]) * (j + 1))
                                 for j in range(i + 1)] for i in range(6)]),
        "binary_values": (vals, [[(b"raw-key", binary[i * 50:(i + 1) * 50]),
                                  ("été", binary[:i])]
                                 for i in range(6)]),
    }


@pytest.mark.parametrize("timestamp_ms", [0, 1_700_000_000_123])
@pytest.mark.parametrize("case", sorted(_header_cases()))
def test_encode_record_batch_with_headers_is_byte_identical(case,
                                                            timestamp_ms):
    vals, hdrs = _header_cases()[case]
    got = tk.encode_record_batch(7, vals, timestamp_ms=timestamp_ms,
                                 headers=hdrs)
    assert got == jk.encode_record_batch(7, vals, timestamp_ms=timestamp_ms,
                                         headers=hdrs)
    assert tk.decode_record_batches_h(got) == jk.decode_record_batches_h(got)


def test_produce_roundtrip():
    broker = tk.MiniKafkaBroker(topic="t")
    try:
        c = tk.KafkaClient(broker.host, broker.port)
        try:
            assert c.produce("t", 0, [b"abc", b"def"]) == 0
            assert c.produce("t", 0, [b"ghi"]) == 2
            hw, recs = c.fetch("t", 0, 0)
            assert hw == 3
            assert [v for _, v in recs] == [b"abc", b"def", b"ghi"]
            assert c.fetch("t", 0, 1)[1] == [(1, b"def"), (2, b"ghi")]
            assert c.api_versions()[tk.API_PRODUCE] == (3, 3)
        finally:
            c.close()
    finally:
        broker.close()


def test_broker_produce_fetch_preserves_headers():
    from flink_jpmml_tpu_torch.obs import trace as ttrace

    broker = tk.MiniKafkaBroker(topic="t")
    try:
        client = tk.KafkaClient(broker.host, broker.port)
        try:
            tp = ttrace.context_for(3).to_traceparent().encode()
            base = client.produce("t", 0, [b"v0", b"v1"],
                                  headers=[None, [("traceparent", tp)]])
            assert base == 0
            _, raw = client.fetch_raw("t", 0, 0)
            got = tk.decode_record_batches_h(raw)
            assert [(o, v) for o, v, _ in got] == [(0, b"v0"), (1, b"v1")]
            assert got[0][2] is None
            assert got[1][2] == [("traceparent", tp)]
            assert tk.record_batch_traceparents(raw) == {1: tp.decode()}
        finally:
            client.close()
    finally:
        broker.close()


def test_append_with_headers_checks_their_count():
    broker = tk.MiniKafkaBroker(topic="t")
    try:
        with pytest.raises(ValueError, match="2 header lists for 1 values"):
            broker.append(b"x", headers=[None, None])
        assert broker.high_watermark == 0
    finally:
        broker.close()


@pytest.mark.parametrize("client_pkg,broker_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_produce_interoperates_across_packages(client_pkg, broker_pkg):
    """A port client producing into a JAX broker, and the reverse: the
    base offsets, the fetched values and the stored headers (and the
    bytes a fetch serves) are the same as the same package's pair."""
    ck = jk if client_pkg == "jax" else tk
    bk = jk if broker_pkg == "jax" else tk
    X = _rows(9, 40)
    tp = b"00-" + b"12" * 16 + b"-" + b"34" * 8 + b"-01"
    hdrs = [[("traceparent", tp)] if i % 3 == 0 else None
            for i in range(20)]
    views = []
    for producer, broker_mod in ((ck, bk), (bk, bk)):
        broker = broker_mod.MiniKafkaBroker(topic="t")
        try:
            broker.append_rows(X[:5])
            c = producer.KafkaClient(broker.host, broker.port)
            try:
                bases = [c.produce("t", 0, _values(X[5:25]), headers=hdrs),
                         c.produce("t", 0, _values(X[25:]),
                                   timestamp_ms=1_700_000_000_000)]
                hw, recs = c.fetch("t", 0, 3)
                _, raw = c.fetch_raw("t", 0, 0)
            finally:
                c.close()
        finally:
            broker.close()
        views.append((bases, hw, recs, bytes(raw)))
    assert views[0] == views[1]
    bases, hw, recs, raw = views[0]
    assert bases == [5, 25] and hw == 40
    assert [v for _, v in recs] == _values(X[3:])
    got = jk.decode_record_batches_h(raw)
    assert [h for _, _, h in got[5:25]] == hdrs
    assert jk.record_batch_time_range(raw)[1] == 1_700_000_000.0


# -- keyed and compacted topics (the JAX tests/test_kafka.py TestVectorOffsets
# and tests/test_trace.py test_compaction_keeps_headers, on the port) -------


def _keyed_gapped_broker(data, n_partitions=3):
    """Keyed producer over ``n_partitions`` + compaction gaps in every
    partition → (port broker, surviving row multiset)."""
    broker = tk.MiniKafkaBroker(topic="vec", n_partitions=n_partitions)
    keys = [f"user-{i % 17}" for i in range(data.shape[0])]
    broker.append_rows_keyed(data, keys)
    # compact away a slice of each partition's middle (real gaps)
    with broker._mu:
        sizes = [len(v) for v in broker._vals]
    for p in range(n_partitions):
        broker.compact(p, list(range(5, min(25, sizes[p]))))
    with broker._mu:
        survivors = [v for p in range(n_partitions) for v in broker._vals[p]]
    return broker, survivors


def _vec_source(broker, parts=(0, 1, 2)):
    return tk.KafkaBlockSource(broker.host, broker.port, "vec",
                               partitions=list(parts), n_cols=4,
                               max_wait_ms=20)


def test_keyed_uneven_fill_consumes_everything():
    data = np.random.default_rng(3).normal(size=(300, 4)).astype(np.float32)
    broker = tk.MiniKafkaBroker(topic="vec", n_partitions=3)
    try:
        broker.append_rows_keyed(data, [f"k{i % 11}" for i in range(300)])
        with broker._mu:
            sizes = [len(v) for v in broker._vals]
        assert sum(sizes) == 300 and len(set(sizes)) > 1  # uneven fill
        src = _vec_source(broker)
        rows, pos = [], 0
        deadline = time.monotonic() + 15.0
        while len(rows) < 300 and time.monotonic() < deadline:
            polled = src.poll()
            if polled is None:
                continue
            off, blk = polled
            assert off == pos  # global indices stay contiguous
            pos += blk.shape[0]
            rows.extend(blk[i].tobytes() for i in range(blk.shape[0]))
        src.close()
    finally:
        broker.close()
    # every produced row consumed exactly once (content multiset)
    assert sorted(rows) == sorted(data[i].tobytes() for i in range(300))


def test_compaction_gaps_are_data_not_errors():
    data = np.random.default_rng(4).normal(size=(240, 4)).astype(np.float32)
    broker, survivors = _keyed_gapped_broker(data)
    try:
        assert len(survivors) == 240 - 60
        src = _vec_source(broker)
        rows = []
        deadline = time.monotonic() + 15.0
        while len(rows) < len(survivors) and time.monotonic() < deadline:
            polled = src.poll()
            if polled is None:
                continue
            _, blk = polled
            rows.extend(blk[i].tobytes() for i in range(blk.shape[0]))
        src.close()
    finally:
        broker.close()
    assert sorted(rows) == sorted(survivors)


def test_vector_state_resume_is_content_exact():
    """checkpoint_state/restore_state round trip: rows below the resume
    boundary never refetch; the union of pre-boundary and post-restore
    emissions is EXACTLY the surviving log."""
    data = np.random.default_rng(5).normal(size=(240, 4)).astype(np.float32)
    broker, survivors = _keyed_gapped_broker(data)
    try:
        src = _vec_source(broker)
        run1 = []  # (global_idx, row bytes)
        deadline = time.monotonic() + 15.0
        while len(run1) < len(survivors) // 2:
            assert time.monotonic() < deadline
            polled = src.poll()
            if polled is None:
                continue
            off, blk = polled
            run1.extend((off + i, blk[i].tobytes())
                        for i in range(blk.shape[0]))
        committed = len(run1) - 3  # a commit mid-emission
        state = src.checkpoint_state(committed)
        assert state is not None and state["offset"] <= committed
        src.close()

        src2 = _vec_source(broker)
        resume = src2.restore_state(state)
        assert resume == state["offset"]
        run2 = []
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            polled = src2.poll()
            if polled is None:
                if len(run2) + resume >= len(survivors):
                    break
                continue
            off, blk = polled
            assert off == resume + len(run2)  # contiguous from k'
            run2.extend(blk[i].tobytes() for i in range(blk.shape[0]))
        src2.close()
    finally:
        broker.close()
    kept = [row for g, row in run1 if g < resume]
    assert sorted(kept + run2) == sorted(survivors), (
        len(kept), len(run2), len(survivors), resume)


def test_source_fails_fast_on_unknown_partition():
    # err 3 must propagate THROUGH the source's reconnect shield: the
    # fetch loop swallows KafkaProtocolError and retries, which would
    # turn a misconfigured partition list into an endless silent poll
    broker = tk.MiniKafkaBroker(topic="vec", n_partitions=2)
    try:
        broker.append(b"\x00" * 16, partition=0)
        src = _vec_source(broker, parts=(0, 7))
        with pytest.raises(tk.KafkaPartitionError, match="partition 7"):
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                src.poll()
        src.close()
    finally:
        broker.close()


def test_compaction_keeps_headers():
    broker = tk.MiniKafkaBroker(topic="t")
    try:
        hx = [("traceparent",
               b"00-" + b"a" * 32 + b"-" + b"b" * 16 + b"-01")]
        broker.append(b"x", b"y", b"z", headers=[None, hx, None])
        broker.compact(0, [0])
        client = tk.KafkaClient(broker.host, broker.port)
        try:
            _, raw = client.fetch_raw("t", 0, 0)
        finally:
            client.close()
    finally:
        broker.close()
    got = tk.decode_record_batches_h(raw)
    assert [(o, v) for o, v, _ in got] == [(1, b"y"), (2, b"z")]
    assert got[0][2] == hx and got[1][2] is None


def test_keyed_compacted_partitions_hold_the_jax_brokers_bytes():
    """The port broker and the JAX broker, fed the same rows and keys and
    compacted alike (a run from each partition's middle, plus every
    seventh offset), hold the same offsets, values, headers and encoded
    segments per partition: a key lands in the same partition in both
    packages, and compaction keeps the same surviving offsets."""
    X = _rows(21, 280, cols=4)
    keys = [f"user-{i % 23}" for i in range(X.shape[0])]
    held = {}
    for name, mod in (("port", tk), ("jax", jk)):
        broker = mod.MiniKafkaBroker(topic="vec", n_partitions=3)
        try:
            broker.append_rows_keyed(X, keys)
            with broker._mu:
                sizes = [len(v) for v in broker._vals]
            for p in range(3):
                mid = sizes[p] // 2
                broker.compact(p, list(range(mid - 10, mid + 10))
                               + list(range(0, sizes[p], 7)))
            with broker._mu:
                held[name] = [(list(broker._offs[p]), list(broker._vals[p]),
                               list(broker._hdrs[p]), list(broker._segs[p]))
                              for p in range(3)]
        finally:
            broker.close()
    assert held["port"] == held["jax"]
    offs = [o for o, _, _, _ in held["port"]]
    assert all(np.diff(o).max() > 1 for o in offs)  # real gaps
    assert sum(len(o) for o in offs) < X.shape[0]
