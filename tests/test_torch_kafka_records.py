"""The port's Kafka record path on the CPU against the JAX package's:
``KafkaRecordSource`` (one JSON record a message, or raw bytes through
``decoder=``) on one and three partitions, its decode-error skip, the
record half of the prefetch sidecar (``PrefetchedRecordSource``: order,
re-chunking, seek, error propagation) and the record engine fed from a
broker, with the sidecar on and off.

Each JAX source reads a JAX ``MiniKafkaBroker`` and each port source a
port broker holding the same messages; every broker listens on loopback
port 0 and is closed in a ``finally``. Scores are compared in order at
rtol 1e-4 / atol 1e-5."""

import json
import time

import pytest

from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse
from flink_jpmml_tpu.runtime import kafka as jk
from flink_jpmml_tpu.runtime import prefetch as jp
from flink_jpmml_tpu.runtime.engine import Pipeline as JPipeline
from flink_jpmml_tpu.runtime.engine import StaticScorer as JStatic
from flink_jpmml_tpu.runtime.sinks import CollectSink as JCollect
from flink_jpmml_tpu.utils.config import BatchConfig as JBatch
from flink_jpmml_tpu.utils.config import RuntimeConfig as JConfig
from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JRegistry
from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.runtime import kafka as tk
from flink_jpmml_tpu_torch.runtime import prefetch as tp
from flink_jpmml_tpu_torch.runtime.engine import Pipeline, StaticScorer
from flink_jpmml_tpu_torch.runtime.sinks import CollectSink
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry as TRegistry
from test_torch_stream import assert_same, dict_records, vectors

B = 32
PKGS = [pytest.param((jk, JRegistry), id="jax"),
        pytest.param((tk, TRegistry), id="port")]


@pytest.fixture(scope="module")
def gbm(tmp_path_factory):
    return gen_gbm(str(tmp_path_factory.mktemp("kr")), n_trees=20, depth=4,
                   n_features=6)


def _records(n=150, seed=1):
    X = vectors(n, 6, seed=seed)
    return dict_records(X, [f"f{j}" for j in range(6)])


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pred()


@pytest.mark.parametrize("prefetch", [None, False], ids=["sidecar", "serial"])
def test_json_records_through_pipeline(gbm, prefetch):
    """tests/test_kafka.py:268 on both packages: JSON records from a broker
    through the record engine; the port's through ``StreamEnvironment``
    (``from_source``), the JAX one's through its ``Pipeline``."""
    recs = _records()
    jbroker, tbroker = jk.MiniKafkaBroker(topic="recs"), tk.MiniKafkaBroker(
        topic="recs")
    pipes = []
    try:
        for b in (jbroker, tbroker):
            b.append(*(json.dumps(r).encode() for r in recs))
        jsink = JCollect()
        jpipe = JPipeline(
            jk.KafkaRecordSource(jbroker.host, jbroker.port, "recs",
                                 max_wait_ms=20),
            JStatic(jcompile(jparse(gbm), batch_size=B)), jsink,
            JConfig(batch=JBatch(size=B, deadline_us=2000)),
            prefetch=prefetch)
        cfg = RuntimeConfig(batch=BatchConfig(size=B, deadline_us=2000))
        env = StreamEnvironment(cfg, device="cpu")
        tsrc = tk.KafkaRecordSource(tbroker.host, tbroker.port, "recs",
                                    max_wait_ms=20, metrics=env.metrics)
        if prefetch is None:
            # the stream API: the engine wraps the prefetchable source
            tsink = env.from_source(tsrc).evaluate(ModelReader(gbm)).collect()
            tpipe = env._pipelines[0]
        else:
            tsink = CollectSink()
            tpipe = env.register(Pipeline(
                tsrc, StaticScorer(ModelReader(gbm).load(
                    batch_size=B, device="cpu")), tsink, cfg,
                metrics=env.metrics, prefetch=prefetch))
        assert isinstance(tpipe._source, tp.PrefetchedRecordSource) == (
            prefetch is None)
        pipes = [jpipe, tpipe]
        jpipe.start()
        env.start()
        # every record submitted; the last batch stays in the engine's
        # window until another batch or stop() (both packages), and
        # stop() finishes the window
        _wait(lambda: all(
            p.metrics.counter("batch_fill_records").get() == 150
            for p in pipes))
    finally:
        for p in pipes:
            p.stop()
            p.join(timeout=30.0)
        jbroker.close()
        tbroker.close()
    assert len(tsink.items) == 150
    assert_same(tsink.items, jsink.items)
    snap = env.metrics.snapshot()
    assert snap["records_out"] == 150
    assert snap["kafka_fetch_s_p50"] > 0
    if prefetch is None:
        assert snap["prefetch_records"] == 150


@pytest.mark.parametrize("pkg", PKGS)
def test_multi_partition_record_source(pkg):
    """tests/test_kafka.py:475: strict interleave restores the global order
    and 1-based engine offsets; auto mode delivers every record."""
    kafka, _ = pkg
    broker = kafka.MiniKafkaBroker(topic="mpr", n_partitions=3)
    try:
        for i in range(30):
            broker.append(json.dumps({"i": i}).encode(), partition=i % 3)
        for mode in ("strict", "auto"):
            src = kafka.KafkaRecordSource(
                broker.host, broker.port, "mpr", partitions=[0, 1, 2],
                max_wait_ms=20, interleave=mode)
            got = []
            deadline = time.monotonic() + 15.0
            while len(got) < 30 and time.monotonic() < deadline:
                got.extend(src.poll(max_n=7))
            src.close()
            assert [o for o, _ in got] == list(range(1, 31))
            if mode == "strict":
                assert [r["i"] for _, r in got] == list(range(30))
            else:
                assert sorted(r["i"] for _, r in got) == list(range(30))
    finally:
        broker.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_record_source_skips_bad_json(pkg):
    """tests/test_kafka.py:1432, without the DLQ (not ported): with a
    metrics registry an undecodable value is counted per partition and
    skipped; with neither metrics nor a DLQ it raises."""
    kafka, Registry = pkg
    broker = kafka.MiniKafkaBroker(topic="r")
    try:
        broker.append(json.dumps({"a": 1}).encode(), b"not json {{",
                      json.dumps({"a": 2}).encode())
        m = Registry()
        src = kafka.KafkaRecordSource(broker.host, broker.port, "r",
                                      metrics=m, max_wait_ms=10)
        try:
            recs = src.poll(10)
        finally:
            src.close()
        assert [r for _, r in recs] == [{"a": 1}, {"a": 2}]
        assert [o for o, _ in recs] == [1, 3]
        assert m.struct_snapshot()["counters"][
            'decode_errors{partition="0"}'] == 1
        src = kafka.KafkaRecordSource(broker.host, broker.port, "r",
                                      max_wait_ms=10)
        try:
            with pytest.raises(ValueError):
                src.poll(10)
        finally:
            src.close()
    finally:
        broker.close()


def test_decoder_and_seek_match_the_jax_source():
    """``decoder=`` takes the raw bytes; ``seek`` re-reads from a record
    offset; a fetch larger than ``max_n`` keeps its surplus buffered."""
    out = []
    for kafka, _ in (p.values[0] for p in PKGS):
        broker = kafka.MiniKafkaBroker(topic="d")
        try:
            broker.append(*(b"v%d" % i for i in range(40)))
            src = kafka.KafkaRecordSource(broker.host, broker.port, "d",
                                          max_wait_ms=10, decoder=bytes)
            try:
                first = src.poll(15)
                src.seek(30)
                tail = []
                deadline = time.monotonic() + 10.0
                while len(tail) < 10 and time.monotonic() < deadline:
                    tail.extend(src.poll(4))
            finally:
                src.close()
        finally:
            broker.close()
        out.append((first, tail))
    assert out[1] == out[0]
    first, tail = out[1]
    assert first == [(i + 1, b"v%d" % i) for i in range(15)]
    assert tail == [(i + 1, b"v%d" % i) for i in range(30, 40)]


# -- the record half of the prefetch sidecar (tests/test_prefetch.py) -------


class ScriptedRecords:
    """A finite record source of ``n`` ints in chunks; ``fail_at`` makes
    that poll raise once."""

    prefetchable = True

    def __init__(self, n=200, fail_at=None):
        self._n = n
        self._pos = 0
        self._fail_at = fail_at
        self.polls = 0

    def poll(self, max_n):
        self.polls += 1
        if self._fail_at is not None and self.polls == self._fail_at:
            self._fail_at = None
            raise RuntimeError("inner source broke")
        take = range(self._pos, min(self._pos + max_n, self._n))
        self._pos += len(take)
        return [(i + 1, i) for i in take]

    def seek(self, offset):
        self._pos = offset

    @property
    def exhausted(self):
        return self._pos >= self._n

    def close(self):
        pass


def _drain_records(src, n, max_n=64, timeout=10.0):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        out.extend(src.poll(max_n))
    return out


@pytest.mark.parametrize("mod", [jp, tp], ids=["jax", "port"])
def test_record_sidecar_rechunks_in_order(mod):
    src = mod.maybe_wrap_records(ScriptedRecords())
    assert isinstance(src, mod.PrefetchedRecordSource)
    assert mod.maybe_wrap_records(src) is src  # no double wrap
    try:
        got = _drain_records(src, 200, max_n=27)
    finally:
        src.stop_prefetch()
    assert got == [(i + 1, i) for i in range(200)]
    assert src.exhausted


@pytest.mark.parametrize("mod", [jp, tp], ids=["jax", "port"])
def test_record_sidecar_seek_discards(mod):
    src = mod.PrefetchedRecordSource(ScriptedRecords(), depth=4, chunk=10)
    try:
        first = _drain_records(src, 5, max_n=5)
        deadline = time.monotonic() + 5
        while len(src._q) < 4 and time.monotonic() < deadline:
            time.sleep(0.001)  # the sidecar ran ahead
        src.seek(150)
        got = _drain_records(src, 50, max_n=7)
    finally:
        src.stop_prefetch()
    assert first == [(i + 1, i) for i in range(5)]
    assert got == [(i + 1, i) for i in range(150, 200)]


@pytest.mark.parametrize("mod", [jp, tp], ids=["jax", "port"])
def test_record_sidecar_error_propagates(mod):
    src = mod.PrefetchedRecordSource(ScriptedRecords(fail_at=3), depth=2,
                                     chunk=10)
    got = []
    try:
        with pytest.raises(RuntimeError, match="inner source broke"):
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                got.extend(src.poll(10))
        src.seek(190)
        after = _drain_records(src, 10, max_n=10)
    finally:
        src.stop_prefetch()
    assert got == [(i + 1, i) for i in range(20)]
    assert after == [(i + 1, i) for i in range(190, 200)]


def test_record_wrap_policy(monkeypatch):
    class Plain:
        pass

    assert tp.maybe_wrap_records(Plain(), enable=None).__class__ is Plain
    monkeypatch.setenv(tp.ENV_DISABLE, "1")
    s = ScriptedRecords()
    assert tp.maybe_wrap_records(s, enable=True) is s
    assert jp.maybe_wrap_records(s, enable=True) is s
