"""Card-only tests of the PyTorch port: the Hopper kernel (ensemble sum
and vote shares) against its plain version, on the fixtures and on the
seeded ragged and caterpillar forests of ``chip_smoke.py``, the device
encode stage against the host encode, and the block pipeline on a CUDA
device, host-encoded and fused, and fed from a Kafka broker on loopback
through the prefetch sidecar, and the staging that ships only a
dispatch's live rows; and the dense families (regression, MLP, k-means,
the stacked chain, a probit GLM) and every tree shape (node hop, halts,
the general scan, the weighted walk, scorecard, ruleset, iforest,
selectFirst / selectAll) and the last nine families (NaiveBayes, SVM,
KNN with its exact ties, BayesianNetwork, GaussianProcess, Baseline,
Association, TextModel, TimeSeries) on the card against the CPU port,
with TF32 off; and the record API (``StreamEnvironment.evaluate`` over
the record engine) and the dynamic scorer on the card against the CPU
port, with the kernel launched once a dispatch; and a real out-of-memory
error, which the device-fault ladder reads as ``device_oom`` and which
leaves the card scoring; and the serving edge on the card: a shed batch
or event launches no kernel and reaches no sink, the batcher observes
completions that include the card's time, the span file holds a pair of
spans a dispatch, and a TCP-fed pipeline scores as the CPU port; and the
kernel search: every launch shape and walk layout of its space bit-equal
to the default launch, and a pipeline's sampled device profile; and the
drift plane armed on the fused path (byte-equal outputs) and a shadow
rollout through the dynamic scorer (two launches a batch). They
skip where there is no card. This file
imports neither jax nor the JAX package, so it runs on a machine that has
only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Run so, without the repo's conftest, it keeps every cache it writes (the
autotune cache, and the kernel cost ledger beside it) in a temporary
directory all the same.
"""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

from chip_smoke import caterpillar_forest, ragged_forest, random_codes
from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_vote_forest
from flink_jpmml_tpu_torch.compile import compile_pmml, qtrees_cuda
from flink_jpmml_tpu_torch.obs import attr
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, FiniteBlockSource
from flink_jpmml_tpu_torch.runtime.kafka import KafkaBlockSource, MiniKafkaBroker
from flink_jpmml_tpu_torch.runtime.pipeline import HostStaging
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

pytestmark = pytest.mark.cuda
os.environ.setdefault("FJT_AUTOTUNE_CACHE", os.path.join(
    tempfile.mkdtemp(prefix="fjt-card-tests-"), "autotune.json"))
RTOL, ATOL = 1e-4, 1e-5  # the repo's rank-wire bar


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with nvcc")
    return torch.device("cuda")


def _X(rng, n, F, missing=0.2):
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    X[rng.random(size=X.shape) < missing] = np.nan
    return X


def _gbm(tmp_path, batch, device=None, **kw):
    doc = parse_pmml_file(gen_gbm(str(tmp_path), **kw))
    return compile_pmml(doc, batch_size=batch, device=device)


def test_kernel_matches_plain_on_the_card(card, tmp_path):
    q = _gbm(tmp_path, 256, n_trees=19, depth=6, n_features=32).quantized_scorer()
    assert q.backend == "cuda" and q.device.type == "cuda"
    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    for n in (1, 127, 1000):
        codes = torch.from_numpy(q.wire.encode(_X(np.random.default_rng(n),
                                                  n, 32))).to(card)
        before = qtrees_cuda.leaf_rows.launches
        got = qtrees_cuda.leaf_rows(codes, tables, 32)
        ref = qtrees_cuda.leaf_rows_reference(codes, tables)
        torch.cuda.synchronize()
        assert qtrees_cuda.leaf_rows.launches == before + 1
        assert got.shape == (n, 1)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


def test_padded_leaves_never_hit_on_the_card(card):
    feat = np.zeros((1, 1), np.int64)
    vals = torch.tensor([[1.0, 2.0, 100.0]], dtype=torch.bfloat16)
    tables = {k: torch.from_numpy(v).to(card)
              for k, v in qtrees_cuda.pack_tables(
                  feat, np.array([[3]], np.uint8), np.array([[False]]),
                  np.array([[[1, -1, 0]]], np.int8), np.array([[1, 1, -5]]),
                  vals, torch.zeros_like(vals), 1).items()}
    codes = torch.tensor([[0], [3], [4], [255]], dtype=torch.uint8,
                         device=card)
    assert qtrees_cuda.leaf_rows(codes, tables, 1).tolist() == [
        [1.0], [1.0], [2.0], [2.0]]


def test_wrapper_rejects_tables_off_the_card(card, tmp_path):
    q = _gbm(tmp_path, 64, device="cpu", n_trees=5, depth=3,
             n_features=4).quantized_scorer()
    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    with pytest.raises(ValueError, match="contiguous on cuda"):
        qtrees_cuda.leaf_rows(
            torch.zeros(4, 4, dtype=torch.uint8, device=card), tables, 4
        )


def test_narrower_batch_raises_on_the_card(card, tmp_path):
    q = _gbm(tmp_path, 64, n_trees=5, depth=3, n_features=4).quantized_scorer()
    before = qtrees_cuda.leaf_rows.launches
    with pytest.raises(ValueError, match="packed for 4"):
        q.predict_wire(np.zeros((64, 3), np.uint8))
    assert qtrees_cuda.leaf_rows.launches == before


def test_block_pipeline_on_the_card_matches_the_cpu_port(card, tmp_path):
    kw = dict(n_trees=40, depth=6, n_features=32)
    cm = _gbm(tmp_path, 512, **kw)
    X = _X(np.random.default_rng(3), 5000, 32)
    got = []
    pipe = BlockPipeline(
        FiniteBlockSource(X, 1500), cm,
        lambda out, n, off: got.append((off, n, np.asarray(out)[:n].copy())),
        RuntimeConfig(batch=BatchConfig(size=512, deadline_us=2000)),
    )
    assert pipe.backend == "rank_wire_cuda"
    pipe.run_until_exhausted(timeout=120)
    expect = 0
    for off, n, _ in got:
        assert off == expect
        expect += n
    assert expect == 5000
    q_cpu = _gbm(tmp_path, 512, device="cpu", **kw).quantized_scorer()
    ref = q_cpu.predict_wire(q_cpu.wire.encode(X)).numpy()[:5000]
    np.testing.assert_allclose(np.concatenate([v for _, _, v in got]), ref,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", [None, "host"], ids=["default", "host"])
def test_block_pipeline_placements_on_the_card_match_the_cpu_port(
        card, tmp_path, mode):
    # on the card a model with a device stage is fused unless asked for
    # the host encode
    kw = dict(n_trees=40, depth=6, n_features=32)
    cm = _gbm(tmp_path, 512, **kw)
    cm.quantized_scorer().encode_mode = mode
    placement = mode or "fused"
    X = _X(np.random.default_rng(4), 5000, 32)
    got = []
    pipe = BlockPipeline(
        FiniteBlockSource(X, 1500), cm,
        lambda out, n, off: got.append((off, n, np.asarray(out)[:n].copy())),
        RuntimeConfig(batch=BatchConfig(size=512, deadline_us=2000)),
    )
    assert pipe.backend == "rank_wire_cuda"
    pipe.run_until_exhausted(timeout=120)
    assert [off for off, _, _ in got] == list(
        np.cumsum([0] + [n for _, n, _ in got])[:-1])
    snap = pipe.metrics.snapshot()
    assert snap[f"encode_{placement}"] == snap["dispatches"]
    assert snap["h2d_bytes"] == 5000 * (4 if placement == "fused" else 1) * 32
    q_cpu = _gbm(tmp_path, 512, device="cpu", **kw).quantized_scorer()
    ref = q_cpu.predict_wire(q_cpu.wire.encode(X)).numpy()[:5000]
    np.testing.assert_allclose(np.concatenate([v for _, _, v in got]), ref,
                               rtol=RTOL, atol=ATOL)


def test_kafka_fed_fused_pipeline_on_the_card_matches_the_cpu_port(
        card, tmp_path):
    kw = dict(n_trees=40, depth=6, n_features=32)
    cm = _gbm(tmp_path, 512, **kw)
    assert cm.quantized_scorer().encode_placement == "fused"
    X = _X(np.random.default_rng(5), 20_000, 32)
    got = {}
    broker = MiniKafkaBroker(topic="t")
    src = None
    try:
        broker.append_rows(X)
        reg = MetricsRegistry()  # shared by the source and the pipeline
        src = KafkaBlockSource(broker.host, broker.port, "t", n_cols=32,
                               max_wait_ms=5, metrics=reg)
        pipe = BlockPipeline(
            src, cm,
            lambda out, n, off: got.setdefault(off, np.asarray(out)[:n].copy()),
            RuntimeConfig(batch=BatchConfig(size=512, deadline_us=2000)),
            metrics=reg,
        )
        pipe.start()
        deadline = time.monotonic() + 120
        while (pipe.committed_offset < 20_000 and pipe.error is None
               and time.monotonic() < deadline):
            time.sleep(0.005)
        pipe.stop()
        pipe.join(timeout=30)
    finally:
        if src is not None:
            src.close()
        broker.close()
    assert pipe.committed_offset == 20_000
    assert type(pipe._source).__name__ == "PrefetchedBlockSource"
    offs = sorted(got)
    assert offs == list(np.cumsum([0] + [got[o].shape[0] for o in offs])[:-1])
    snap = pipe.metrics.snapshot()
    assert snap["encode_fused"] == snap["dispatches"]
    assert snap["h2d_bytes"] == 20_000 * 128  # live rows only
    assert {"fetch", "decode", "prefetch_wait", "encode", "h2d",
            "sink"} <= set(attr.summary(pipe.metrics))
    q_cpu = _gbm(tmp_path, 512, device="cpu", **kw).quantized_scorer()
    ref = q_cpu.predict_wire(q_cpu.wire.encode(X)).numpy()[:20_000]
    np.testing.assert_allclose(np.concatenate([got[o] for o in offs]), ref,
                               rtol=RTOL, atol=ATOL)


def test_staging_ships_live_rows_and_zeroes_the_rest(card):
    # varying drains through one rotation: each device tensor holds the
    # payload and then zero rows up to ``rows``, whatever a reused pinned
    # buffer held before
    staging = HostStaging(card, slots=2)
    rng = np.random.default_rng(6)
    for n, rows in ((700, 1024), (1024, 1024), (5, 512), (900, 1024),
                    (3, 3)):
        X = rng.normal(size=(n, 32)).astype(np.float32)
        dev = staging.stage(X, rows)
        torch.cuda.synchronize()
        assert dev.device.type == "cuda" and dev.shape == (rows, 32)
        np.testing.assert_array_equal(dev[:n].cpu().numpy(), X)
        assert not dev[n:].any()


@pytest.mark.parametrize("kw", [
    dict(n_trees=40, depth=6, n_features=32),
    dict(n_trees=300, depth=5, n_features=4, hist_bins=None),  # uint16
], ids=["uint8", "uint16"])
def test_encode_stage_on_the_card_is_byte_identical(card, tmp_path, kw):
    from chip_smoke import edge_cells

    q = _gbm(tmp_path, 256, **kw).quantized_scorer()
    X = edge_cells(np.random.default_rng(5), q.wire.cuts, 3001)
    got = q.encode_device(X)
    assert got.device.type == "cuda"
    host = q.wire.encode(X)
    assert got.cpu().numpy().dtype == host.dtype
    np.testing.assert_array_equal(got.cpu().numpy(), host)
    # a uint16 batch staged on the card goes through the torch twin
    q_cpu = _gbm(tmp_path, 256, device="cpu", **kw).quantized_scorer()
    ref = q_cpu.predict_wire(host).numpy()
    np.testing.assert_allclose(q.predict_wire(host).cpu().numpy(), ref,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(q.predict_fused(X).cpu().numpy()[:3001],
                               ref[:3001], rtol=RTOL, atol=ATOL)


def _votes(tmp_path, batch, device=None, **kw):
    doc = parse_pmml_file(gen_vote_forest(str(tmp_path), **kw))
    return compile_pmml(doc, batch_size=batch, device=device)


def _vote_tables(q):
    return {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}


@pytest.mark.parametrize("n_trees,weighted", [(19, False), (500, True)])
def test_vote_kernel_equals_plain_on_the_card(card, tmp_path, n_trees,
                                              weighted):
    # bit for bit: the kernel and its plain version add the same class rows
    # in the same ascending tree order
    q = _votes(tmp_path, 1024, n_trees=n_trees, depth=6, n_features=32,
               n_classes=3, weighted=weighted).quantized_scorer()
    assert q.backend == "cuda" and q.is_classification
    codes = torch.from_numpy(q.wire.encode(
        _X(np.random.default_rng(n_trees), 4096, 32))).to(card)
    before = qtrees_cuda.leaf_rows.launches
    got = qtrees_cuda.leaf_rows(codes, _vote_tables(q), 32)
    ref = qtrees_cuda.leaf_rows_reference(codes, _vote_tables(q))
    torch.cuda.synchronize()
    assert qtrees_cuda.leaf_rows.launches == before + 1
    assert got.shape == (4096, 3)
    assert torch.equal(got, ref)


def test_vote_kernel_ragged_batch_on_the_card(card, tmp_path):
    q = _votes(tmp_path, 256, n_trees=40, depth=5, n_features=32,
               n_classes=10).quantized_scorer()
    for n in (1, 127, 1001):
        codes = torch.from_numpy(q.wire.encode(
            _X(np.random.default_rng(n), n, 32))).to(card)
        got = qtrees_cuda.leaf_rows(codes, _vote_tables(q), 32)
        ref = qtrees_cuda.leaf_rows_reference(codes, _vote_tables(q))
        torch.cuda.synchronize()
        assert got.shape == (n, 10)
        assert torch.equal(got, ref)


def test_vote_pipeline_on_the_card_matches_the_cpu_port(card, tmp_path):
    kw = dict(n_trees=40, depth=6, n_features=32, n_classes=3)
    cm = _votes(tmp_path, 512, **kw)
    X = _X(np.random.default_rng(4), 5000, 32)
    got = []
    pipe = BlockPipeline(
        FiniteBlockSource(X, 1500), cm,
        lambda out, n, off: got.append(
            (off, n, [np.asarray(o)[:n].copy() for o in out])),
        RuntimeConfig(batch=BatchConfig(size=512, deadline_us=2000)),
    )
    assert pipe.backend == "rank_wire_cuda"
    pipe.run_until_exhausted(timeout=120)
    expect = 0
    for off, n, _ in got:
        assert off == expect
        expect += n
    assert expect == 5000
    q_cpu = _votes(tmp_path, 512, device="cpu", **kw).quantized_scorer()
    ref = [o.numpy()[:5000] for o in q_cpu.predict_wire(q_cpu.wire.encode(X))]
    for i in range(3):  # value, shares, label: the same arithmetic
        np.testing.assert_array_equal(
            np.concatenate([parts[i] for _, _, parts in got]), ref[i])


WALK_CASES = {
    "ragged_c1": lambda: ragged_forest(11, 60, 32, 1),
    "ragged_c3": lambda: ragged_forest(12, 60, 32, 3),
    "caterpillar_c1": lambda: caterpillar_forest(13, 32, 1),
    "caterpillar_c16": lambda: caterpillar_forest(14, 32, 16),
    # 256 fields at C = 16: the staged codes and two table chunks fit the
    # shared-memory target only at 64 threads a block (256 records)
    "ragged_f256_c16": lambda: ragged_forest(17, 60, 256, 16),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_walk_kernel_equals_plain_on_the_card(card, case):
    # ragged depths, single-leaf trees, padded slots, the 65th leaf, the
    # widest codes; batch lengths around a block's 1,024 records (256
    # threads x 4 records at 32 fields) put the ragged tail's masked
    # records through the barriers
    inputs = WALK_CASES[case]()
    tables = {k: torch.from_numpy(v).to(card)
              for k, v in qtrees_cuda.pack_tables(**inputs).items()}
    C = tables["rows"].shape[2]
    F = inputs["n_fields"]
    for n in (1, 1023, 1025, 5000):
        codes = torch.from_numpy(random_codes(n, n, F, 0.2)).to(card)
        before = qtrees_cuda.leaf_rows.launches
        got = qtrees_cuda.leaf_rows(codes, tables, F)
        ref = qtrees_cuda.leaf_rows_reference(codes, tables)
        torch.cuda.synchronize()
        assert qtrees_cuda.leaf_rows.launches == before + 1
        assert got.shape == (n, C)
        assert torch.equal(got, ref), (case, n)


def test_walk_kernel_on_an_unaligned_codes_width(card):
    # 7 fields: the codes are staged byte by byte, not word by word
    inputs = ragged_forest(15, 30, 7, 3)
    tables = {k: torch.from_numpy(v).to(card)
              for k, v in qtrees_cuda.pack_tables(**inputs).items()}
    codes = torch.from_numpy(random_codes(16, 3001, 7, 0.2)).to(card)
    got = qtrees_cuda.leaf_rows(codes, tables, 7)
    assert torch.equal(got, qtrees_cuda.leaf_rows_reference(codes, tables))


def test_walk_kernel_needs_only_the_walk_table_on_the_card(card):
    # the mask tables stay on the host: the wrapper reads their shapes only
    host = {k: torch.from_numpy(v)
            for k, v in qtrees_cuda.pack_tables(
                **ragged_forest(18, 30, 32, 3)).items()}
    codes = torch.from_numpy(random_codes(19, 2049, 32, 0.2))
    tables = dict(host, walk=host["walk"].to(card))
    got = qtrees_cuda.leaf_rows(codes.to(card), tables, 32)
    assert torch.equal(got.cpu(), qtrees_cuda.leaf_rows(codes, host, 32))


def test_ptxas_reports_no_spills(card):
    qtrees_cuda.build()
    report = qtrees_cuda.ptxas_report()
    # one instance per class bucket (1, 4, 16) of each kernel: the solo
    # walk and the packed walk
    names = sorted(k["kernel"] for k in report)
    assert len(report) == 6, names
    assert sum("walk_packed_kernel" in n for n in names) == 3, names
    for kernel in report:
        assert kernel["spill_stores"] == 0 and kernel["spill_loads"] == 0, \
            kernel


# -- the dense families on the card (f32 backend, no kernel) -----------------


def _family_doc(tmp_path, family):
    from chip_smoke import ENTITY_OUTPUTS, glm_probit_xml
    from flink_jpmml_tpu_torch import assets_gen as ag
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    d = str(tmp_path)
    if family == "glm_probit":
        return parse_pmml(glm_probit_xml())
    if family == "kmeans":
        with open(ag.gen_kmeans(d)) as f:
            return parse_pmml(f.read().replace(
                "</MiningSchema>", "</MiningSchema>" + ENTITY_OUTPUTS, 1))
    path = {
        "iris_lr": lambda: ag.gen_iris_lr(d),
        "mlp": lambda: ag.gen_mlp(d, n_inputs=784, hidden=(256,),
                                  n_classes=10, name="mlp.pmml"),
        "stacked": lambda: ag.gen_stacked(d, n_trees=12, depth=4,
                                          n_features=10_000, wide_lr=True),
    }[family]()
    return parse_pmml_file(path)


def _assert_outputs_close(got, ref):
    valid = ref.valid.numpy()
    np.testing.assert_array_equal(got.valid.cpu().numpy(), valid)
    for g, r in ((got.value, ref.value), (got.probs, ref.probs)):
        assert (g is None) == (r is None)
        if r is not None:
            np.testing.assert_allclose(g.cpu().numpy()[valid],
                                       r.numpy()[valid], rtol=RTOL, atol=ATOL)
    if ref.label_idx is not None:
        np.testing.assert_array_equal(got.label_idx.cpu().numpy()[valid],
                                      ref.label_idx.numpy()[valid])


@pytest.mark.parametrize("family", ["iris_lr", "mlp", "kmeans", "stacked",
                                    "glm_probit"])
def test_dense_family_on_the_card_matches_the_cpu_port(card, tmp_path,
                                                       family):
    """Card vs CPU port at the repo's bar, with TF32 off: the 784-wide MLP,
    the 10,000-wide linear stage and the clustering products are float32
    matmuls whose operands TF32 would round to a 10-bit mantissa."""
    doc = _family_doc(tmp_path, family)
    cm = compile_pmml(doc, batch_size=512)  # default device: the card
    assert cm.device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    cpu = compile_pmml(doc, batch_size=512, device="cpu")
    F = cm.field_space.arity
    rng = np.random.default_rng(7)
    X = rng.normal(0.0, 1.5, size=(1200, F)).astype(np.float32)
    miss = rng.random(size=X.shape) < 0.2
    if F > 16:  # a missing input empties the lane: keep most rows whole
        miss &= rng.random(size=(1200, 1)) < 0.2
    X[miss] = np.nan
    M = np.isnan(X)
    Xz = np.where(M, 0.0, X).astype(np.float32)
    _assert_outputs_close(cm.predict(Xz, M), cpu.predict(Xz, M))
    got = []
    pipe = BlockPipeline(
        FiniteBlockSource(X, 500), cm,
        lambda out, n, off: got.append((off, n, out)),
        RuntimeConfig(batch=BatchConfig(size=512, deadline_us=2000)),
    )
    assert pipe.backend == "f32" and cm.quantized_scorer() is None
    pipe.run_until_exhausted(timeout=120)
    assert sum(n for _, n, _ in got) == 1200
    for off, n, out in got:
        Xs, Ms = Xz[off:off + n], M[off:off + n]
        ref = cpu.predict(Xs, Ms)
        _assert_outputs_close(
            type(out)(*(None if t is None else t[:n] for t in out)), ref)
    if family == "kmeans":
        recs = [{f: float(v) for f, v in zip(cm.field_space.fields, row)
                 if not np.isnan(v)} for row in X[:16]]
        for g, r in zip(cm.score_records(recs), cpu.score_records(recs)):
            assert g.is_empty == r.is_empty
            assert (g.outputs or {}).get("cluster") == (
                r.outputs or {}).get("cluster")


# -- every tree shape on the card (f32 backend, no kernel) -------------------


def _shape_doc(tmp_path, shape):
    import chip_smoke as cs
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    deep = dict(n_trees=6, n_fields=8, max_leaves=60, max_depth=16)
    xml = {
        "node_hop": lambda: cs.deep_rf_xml(**deep),
        "node_hop_halt": lambda: cs.deep_rf_xml(**deep).replace(
            'missingValueStrategy="defaultChild"',
            'missingValueStrategy="lastPrediction"'),
        "gtrees": lambda: cs.general_forest_xml(
            n_trees=6, n_continuous=8, n_categorical=2, max_leaves=30,
            max_depth=8),
        "wtrees_weighted_confidence": lambda: cs.WEIGHTED_CONF,
        "wtrees_aggregate_nodes": lambda: cs.AGG_NODES,
        "scorecard": cs.scorecard_xml,
        "ruleset_firstHit": lambda: cs.ruleset_xml("firstHit"),
        "ruleset_weightedSum": lambda: cs.ruleset_xml("weightedSum"),
        "ruleset_weightedMax": lambda: cs.ruleset_xml("weightedMax"),
        "iforest": lambda: cs.iforest_xml(n_trees=10, n_fields=8),
        "select_first": lambda: cs.select_first_xml(
            str(tmp_path), n_trees=10, depth=4, n_fields=8),
        "select_all": lambda: cs.SELECT_ALL,
    }[shape]()
    return parse_pmml(xml)


@pytest.mark.parametrize("shape", [
    "node_hop", "node_hop_halt", "gtrees", "wtrees_weighted_confidence",
    "wtrees_aggregate_nodes", "scorecard", "ruleset_firstHit",
    "ruleset_weightedSum", "ruleset_weightedMax", "iforest", "select_first",
    "select_all"])
def test_tree_shape_on_the_card_matches_the_cpu_port(card, tmp_path, shape):
    """Card vs CPU port at the repo's bar on each new backend: the node-hop
    and general-scan gathers (an out-of-range index would trip a device
    assert), the weighted walk's and the ruleset's float32 products (TF32
    off), reason codes and the selectAll map through ``score_records``."""
    from chip_smoke import check_decoded

    doc = _shape_doc(tmp_path, shape)
    cm = compile_pmml(doc, batch_size=1024)  # default device: the card
    assert cm.device.type == "cuda" and cm.quantized_scorer() is None
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu = compile_pmml(doc, batch_size=1024, device="cpu")
    F = cm.field_space.arity
    rng = np.random.default_rng(11)
    X = rng.normal(0.0, 1.5, size=(1024, F)).astype(np.float32)
    if shape == "gtrees":  # categorical columns hold declared codes
        X[:, -2:] = rng.integers(0, 8, size=(1024, 2))
    X[rng.random(size=X.shape) < 0.2] = np.nan
    M = np.isnan(X)
    Xz = np.where(M, 0.0, X).astype(np.float32)
    _assert_outputs_close(cm.predict(Xz, M), cpu.predict(Xz, M))
    torch.cuda.synchronize()  # a device assert surfaces here, not later
    check_decoded(cm, cpu, X[:64], shape)


# -- the last nine families on the card (f32 backend, no kernel) ------------


def _more_doc(family):
    import chip_smoke as cs
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    xml = {
        "naive_bayes": lambda: cs.naive_bayes_xml(n_continuous=12,
                                                  n_categorical=4),
        "svm": lambda: cs.svm_xml(n_vectors=400, n_fields=16),
        "knn": lambda: cs.knn_xml(n_instances=2000, n_fields=8),
        "bayesnet": cs.bayesnet_xml,
        "gp": lambda: cs.gp_xml("absexp", n_rows=300, n_fields=6),
        "baseline": cs.baseline_xml,
        "assoc": lambda: cs.assoc_xml(n_items=60, n_rules=200),
        "textmodel": lambda: cs.text_xml(n_terms=200, n_docs=300),
        "timeseries": cs.holt_winters_xml,
    }[family]()
    return parse_pmml(xml)


@pytest.mark.parametrize("family", [
    "naive_bayes", "svm", "knn", "bayesnet", "gp", "baseline", "assoc",
    "textmodel", "timeseries"])
def test_more_family_on_the_card_matches_the_cpu_port(card, family):
    """Card vs CPU port at the repo's bar, with TF32 off (the SVM, GP,
    BayesianNetwork, association and text products are float32 matmuls),
    the KNN neighbour ids and the fired-rule mask exactly, and the decoded
    outputs (rank-k entityId, ruleValue) through ``score_records``."""
    from chip_smoke import check_decoded, exact_columns, more_family_rows

    doc = _more_doc(family)
    cm = compile_pmml(doc, batch_size=1024).warmup()  # default: the card
    assert cm.device.type == "cuda" and cm.quantized_scorer() is None
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu = compile_pmml(doc, batch_size=1024, device="cpu")
    kind = {"assoc": "basket", "timeseries": "horizon"}.get(family, "normal")
    missing = 0.2 if family in ("naive_bayes", "assoc", "textmodel") else 0.0
    X = more_family_rows(cm, np.random.default_rng(12), 1024, kind, missing)
    M = np.isnan(X)
    Xz = np.where(M, 0.0, X).astype(np.float32)
    got, ref = cm.predict(Xz, M), cpu.predict(Xz, M)
    torch.cuda.synchronize()  # a device assert surfaces here, not later
    _assert_outputs_close(got, ref)
    ex = exact_columns(cm)
    if ex >= 0:
        valid = ref.valid.numpy()
        np.testing.assert_array_equal(got.probs.cpu().numpy()[valid, ex:],
                                      ref.probs.numpy()[valid, ex:])
    check_decoded(cm, cpu, X[:256], family)


def test_knn_exact_ties_on_the_card_take_the_lower_row(card):
    """Half the training rows are copies of earlier rows, each under a
    label of its own, and the queries sit on training rows: distances tie
    exactly. ``lax.top_k``'s rule (the JAX package's) keeps the lower row
    among equals; ``torch.topk`` promises no order on CUDA, so the port's
    stable sort must give the same ranking as the rule from float64
    distances, where only copies tie."""
    import chip_smoke as cs
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    xml = cs.knn_xml(n_instances=3000, n_fields=4, k=5, duplicated=0.5)
    doc = parse_pmml(xml)
    cm = compile_pmml(doc, batch_size=512)
    cpu = compile_pmml(doc, batch_size=512, device="cpu")
    S = np.asarray(doc.model.instances, np.float32)
    rng = np.random.default_rng(13)
    X = np.concatenate([S[rng.integers(0, len(S), 256)],
                        rng.normal(0.0, 1.5, size=(256, 4))]).astype(
        np.float32)
    M = np.zeros_like(X, bool)
    got, ref = cm.predict(X, M), cpu.predict(X, M)
    ids = got.probs.cpu().numpy()[:, 3:].astype(np.int64)
    np.testing.assert_array_equal(ids, ref.probs.numpy()[:, 3:])
    np.testing.assert_array_equal(got.label_idx.cpu().numpy(),
                                  ref.label_idx.numpy())
    d = ((X.astype(np.float64)[:, None, :] - S[None].astype(np.float64))
         ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(ids, want)
    assert (d[np.arange(len(X)), want[:, 0]] == 0).sum() >= 256
    assert (np.diff(d[np.arange(len(X))[:, None], want], axis=1)
            == 0).any(axis=1).sum() > 100  # exact ties inside the top 5


def test_svm_rbf_on_the_card_needs_tf32_off(card):
    """An RBF regression SVM over 32 fields, queried near its support
    vectors: the kernel's cross term ⟨x, s⟩ is a float32 matmul whose
    operands TF32 would round to a 10-bit mantissa, moving ‖x − s‖² by
    ~1e-2 and exp(−γ‖x − s‖²) (γ = 0.25) by ~0.3%, thirty times the bar.
    With the port's precision the card matches a float64 reference; with
    TF32 switched on the same call does not."""
    import chip_smoke as cs
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    xml = cs.svm_xml("poly", n_vectors=500, n_fields=32).replace(
        '<PolynomialKernelType gamma="0.03125" coef0="1" degree="3"/>',
        '<RadialBasisKernelType gamma="0.25"/>')
    assert "RadialBasisKernelType" in xml
    doc = parse_pmml(xml)
    cm = compile_pmml(doc, batch_size=2048)
    S = np.asarray([v for _, v in doc.model.vectors], np.float64)
    rng = np.random.default_rng(14)
    X = (S[rng.integers(0, len(S), 2048)]
         + rng.normal(0.0, 0.1, size=(2048, 32))).astype(np.float32)
    M = np.zeros_like(X, bool)
    (m,) = doc.model.machines
    alpha = np.asarray(m.coefficients, np.float64)
    d2 = ((X.astype(np.float64)[:, None, :] - S[None]) ** 2).sum(-1)
    want = np.exp(-0.25 * d2) @ alpha + m.intercept
    got = cm.predict(X, M).value.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = cm.predict(X, M).value.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert not np.allclose(tf32, want, rtol=RTOL, atol=ATOL)


def _preds(items):
    return (np.array([np.nan if p.is_empty else p.score.value
                      for p in items]),
            [p.target.label if p.target is not None else None
             for p in items])


def test_record_api_on_the_card_matches_the_cpu_port(card, tmp_path):
    path = gen_gbm(str(tmp_path), n_trees=19, depth=6, n_features=32)
    X = _X(np.random.default_rng(0), 1000, 32)
    cfg = RuntimeConfig(batch=BatchConfig(size=256, deadline_us=2000))
    out = {}
    for dev in (None, "cpu"):
        env = StreamEnvironment(cfg, device=dev)
        sink = env.from_collection(list(X)).evaluate(
            ModelReader(path)).collect()
        before = qtrees_cuda.leaf_rows.launches
        env.execute(timeout=120.0)
        out[dev] = _preds(sink.items)
        launches = qtrees_cuda.leaf_rows.launches - before
        snap = env.metrics.snapshot()
        # one launch a dispatch on the card, none on the CPU
        assert launches == (snap["batches"] if dev is None else 0)
        assert snap["scorer_backend_rank_wire_" + (
            "cuda" if dev is None else "cuda_plain")] == 1
    np.testing.assert_allclose(out[None][0], out["cpu"][0], rtol=RTOL,
                               atol=ATOL)


def test_dynamic_scorer_on_the_card_matches_the_cpu_port(card, tmp_path):
    from flink_jpmml_tpu_torch.models.control import AddMessage, DelMessage
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving import DynamicScorer

    d = str(tmp_path)
    gbm = gen_gbm(d, n_trees=19, depth=6, n_features=32)
    votes = gen_vote_forest(d, n_trees=19, depth=6, n_features=32)
    X = _X(np.random.default_rng(1), 600, 32)
    names = np.random.default_rng(2).integers(3, size=600)
    events = [(("gbm", "votes", "ghost")[k], x) for k, x in zip(names, X)]
    out = {}
    for dev in (None, "cpu"):
        ctrl = ControlSource()
        scorer = DynamicScorer(ctrl, batch_size=256, device=dev)
        ctrl.push(AddMessage("gbm", 1, gbm, 1.0))
        ctrl.push(AddMessage("votes", 1, votes, 1.5))
        scorer._drain_control()
        for name in ("gbm", "votes"):
            assert scorer.registry.model(ModelId(name, 1)) is not None
        before = qtrees_cuda.leaf_rows.launches
        by_c = dict(qtrees_cuda.leaf_rows.launches_by_classes)
        d0 = scorer.metrics.counter("dispatches").get()
        got = scorer.finish(scorer.submit(events))
        dispatches = scorer.metrics.counter("dispatches").get() - d0
        assert dispatches == 2  # one a served model
        assert qtrees_cuda.leaf_rows.launches - before == (
            dispatches if dev is None else 0)
        # one launch at C = 1 (the GBM) and one at C = 3 (the votes)
        grew = {c: k - by_c.get(c, 0) for c, k in
                qtrees_cuda.leaf_rows.launches_by_classes.items()}
        assert {c: k for c, k in grew.items() if k} == (
            {1: 1, 3: 1} if dev is None else {})
        ctrl.push(DelMessage("gbm", 1, 2.0))
        gone = scorer.finish(scorer.submit(events[:50]))
        assert all(p.is_empty for p, e in gone if e[0] != "votes")
        out[dev] = _preds([p for p, _ in got])
    (cv, cl), (pv, pl) = out[None], out["cpu"]
    np.testing.assert_array_equal(np.isnan(cv), names == 2)
    np.testing.assert_allclose(cv, pv, rtol=RTOL, atol=ATOL)
    assert cl == pl


def test_drift_armed_on_the_fused_path_is_byte_equal_on_the_card(
        card, tmp_path):
    from flink_jpmml_tpu_torch.obs import drift
    from flink_jpmml_tpu_torch.runtime.engine import new_staging
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized

    q = _gbm(tmp_path, 1024, n_trees=19, depth=6,
             n_features=32).quantized_scorer()
    assert q.encode_placement == "fused"  # the card's own choice
    cold, hot = MetricsRegistry(), MetricsRegistry()
    drift.install(hot, interval_s=0.0, budget_frac=0)
    staging = new_staging(q.device)
    rng = np.random.default_rng(5)
    host = MetricsRegistry()
    host_plane = drift.install(host, interval_s=0.0, budget_frac=0)
    for n in (1024, 3000):  # the second is not whole compile batches
        X = _X(rng, n, 32)
        plain = dispatch_quantized(q, X, metrics=cold,
                                   staging=staging).result().clone()
        armed = dispatch_quantized(q, X, metrics=hot,
                                   staging=staging).result()
        assert plain.numpy().tobytes() == armed.numpy().tobytes()
        host_plane.record_features(q, X)
    # the sampled rows are the caller's, not the staged or padded ones
    assert hot.struct_snapshot()["sketches"] == host.struct_snapshot()[
        "sketches"]
    assert len(host.sketches()) == 32
    assert "sketches" not in cold.struct_snapshot()


def test_shadow_rollout_launches_the_kernel_twice_on_the_card(
        card, tmp_path):
    import shutil

    from flink_jpmml_tpu_torch.models.control import (
        AddMessage,
        RolloutMessage,
    )
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving import DynamicScorer

    d = str(tmp_path)
    gbm = gen_gbm(d, n_trees=19, depth=6, n_features=32)
    v2 = os.path.join(d, "v2.pmml")
    shutil.copyfile(gbm, v2)
    X = _X(np.random.default_rng(6), 512, 32)
    events = [("gbm", x) for x in X]
    ctrl = ControlSource()
    sc = DynamicScorer(ctrl, batch_size=256, auto_rollout=False)
    ctrl.push(AddMessage("gbm", 1, gbm, 1.0))
    sc._drain_control()
    assert sc.registry.model(ModelId("gbm", 1)).device.type == "cuda"
    ctrl.push(RolloutMessage("gbm", 2, "shadow", time.time(), path=v2))
    sc._drain_control()
    deadline = time.monotonic() + 120.0
    while sc.registry.model_if_warm(ModelId("gbm", 2)) is None:
        assert time.monotonic() < deadline, "candidate never warmed"
        time.sleep(0.02)
    before = qtrees_cuda.leaf_rows.launches
    got = sc.finish(sc.submit(events))
    assert qtrees_cuda.leaf_rows.launches - before == 2  # served + mirror
    c = sc.metrics.struct_snapshot()["counters"]
    assert c['rollout_shadow_compared{model="gbm"}'] == 512
    assert c.get('rollout_shadow_disagree{model="gbm"}', 0) == 0
    assert c.get('rollout_candidate_records{model="gbm"}', 0) == 0
    assert len(got) == 512
    # both roles timed on the card's clock: a kernel's worth, not host time
    h = sc.metrics.struct_snapshot()["histograms"]
    for role in ("candidate", "incumbent"):
        assert h[f'rollout_{role}_latency_s{{model="gbm"}}']["n"] == 1
    ref = compile_pmml(parse_pmml_file(gbm), batch_size=256,
                       device="cpu").quantized_scorer()
    want = ref.predict_padded(*ref.pad_wire(ref.wire.encode(X))).numpy()
    vals = np.array([p.score.value for p, _ in got])
    np.testing.assert_allclose(vals, want[:512], rtol=RTOL, atol=ATOL)


def test_real_oom_classifies_as_device_oom_and_the_card_survives(
        card, tmp_path):
    """A real ``torch.cuda.OutOfMemoryError`` (more than the card holds)
    is a ``device_oom`` to the ladder, and the CUDA context survives it:
    the kernel scores the same records the same way after it."""
    from flink_jpmml_tpu_torch.runtime import devfault

    cm = _gbm(tmp_path, 256, n_trees=19, depth=6, n_features=32)
    q = cm.quantized_scorer()
    X = _X(np.random.default_rng(9), 256, 32)
    before = q.predict_padded(*q.pad_wire(q.wire.encode(X))).cpu()
    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        torch.empty((1 << 46,), dtype=torch.uint8, device=card)
    assert devfault.classify(err.value) == devfault.KIND_OOM
    torch.cuda.empty_cache()
    after = q.predict_padded(*q.pad_wire(q.wire.encode(X))).cpu()
    torch.cuda.synchronize()
    assert torch.equal(before, after)


# -- the serving edge -------------------------------------------------------------


def _shed_controller(metrics, level, lanes=("block",)):
    from flink_jpmml_tpu_torch.serving.overload import AdmissionController

    adm = AdmissionController(metrics, lanes=lanes, on_threshold=0.85,
                              off_threshold=0.55, pressure_fn=lambda: 0.7)
    adm._level = level  # held: the pressure sits inside the band
    return adm


def test_block_shed_launches_nothing_on_the_card(card, tmp_path):
    cm = _gbm(tmp_path, 256, n_trees=19, depth=6, n_features=32)
    X = _X(np.random.default_rng(3), 16 * 256, 32)
    m = MetricsRegistry()
    sunk = []
    pipe = BlockPipeline(
        FiniteBlockSource(X, 256), cm, lambda o, n, f: sunk.append((f, n)),
        RuntimeConfig(batch=BatchConfig(size=256, deadline_us=2000)),
        metrics=m, max_dispatch_chunks=1, admission=_shed_controller(m, 1))
    before = qtrees_cuda.leaf_rows.launches
    pipe.run_until_exhausted(timeout=120)
    snap = m.snapshot()
    assert sunk == [] and pipe.committed_offset == 16 * 256
    assert snap['shed_records{lane="block"}'] == 16 * 256
    assert snap.get("dispatches", 0) == 0
    assert qtrees_cuda.leaf_rows.launches == before


def test_batcher_sees_the_cards_time(card, tmp_path):
    from flink_jpmml_tpu_torch.serving.overload import AdaptiveBatcher

    cm = _gbm(tmp_path, 4096, n_trees=500, depth=6, n_features=32)
    X = _X(np.random.default_rng(4), 16 * 4096, 32)
    m = MetricsRegistry()
    b = AdaptiveBatcher(m, deadline_s=1.0, path=str(tmp_path / "cap.json"))
    pipe = BlockPipeline(
        FiniteBlockSource(X, 4096), cm, lambda *a: None,
        RuntimeConfig(batch=BatchConfig(size=4096, deadline_us=2000)),
        metrics=m, max_dispatch_chunks=4, batcher=b)
    pipe.run_until_exhausted(timeout=120)
    c0, c1 = b.coefficients()
    # a 500-tree walk costs the card well over a nanosecond a record; an
    # observation taken before the event wait would read near zero
    assert c1 > 1e-9 and b.state()["samples"] == m.snapshot()["dispatches"]


def test_dynamic_scorer_shed_launches_nothing_on_the_card(card, tmp_path):
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    path = gen_gbm(str(tmp_path), n_trees=19, depth=6, n_features=32)
    m = MetricsRegistry()
    ctrl = ControlSource()
    sc = DynamicScorer(control=ctrl, batch_size=256, metrics=m,
                       admission=_shed_controller(
                           m, 1, ("low", "normal", "high")))
    ctrl.push(AddMessage("gbm", 1, path, 1.0))
    sc.finish(sc.submit([]))
    sc.registry.model(sc.registry.resolve("gbm", 1))
    X = _X(np.random.default_rng(5), 64, 32, missing=0.0)
    ev = [{"_model": "gbm", "_lane": lane,
           **{f"f{j}": float(v) for j, v in enumerate(x)}}
          for lane, x in zip(["low"] * 32 + ["high"] * 32, X)]
    before = qtrees_cuda.leaf_rows.launches
    out = sc.finish(sc.submit(ev[:32]))  # every event shed
    assert all(p.is_empty for p, _ in out)
    assert qtrees_cuda.leaf_rows.launches == before
    out = sc.finish(sc.submit(ev))
    assert qtrees_cuda.leaf_rows.launches == before + 1
    assert [p.is_empty for p, _ in out] == [True] * 32 + [False] * 32


def test_span_pair_a_dispatch_on_the_card(card, tmp_path, monkeypatch):
    import json

    from flink_jpmml_tpu_torch.obs import spans

    monkeypatch.setattr(spans, "_writer", None)
    monkeypatch.setattr(spans, "_writer_dir", None)
    monkeypatch.setenv("FJT_TRACE_DIR", str(tmp_path / "spans"))
    cm = _gbm(tmp_path, 256, n_trees=19, depth=6, n_features=32)
    m = MetricsRegistry()
    pipe = BlockPipeline(
        FiniteBlockSource(_X(np.random.default_rng(6), 8 * 256, 32), 256),
        cm, lambda *a: None,
        RuntimeConfig(batch=BatchConfig(size=256, deadline_us=2000)),
        metrics=m, max_dispatch_chunks=1)
    pipe.run_until_exhausted(timeout=120)
    w = spans.writer()
    w.close()
    evs = json.loads(open(w.path).read().rstrip().rstrip(",") + "]")
    names = [e["name"] for e in evs]
    d = m.snapshot()["dispatches"]
    assert names.count("h2d_dispatch") == names.count("readback") == d


def test_tcp_fed_pipeline_on_the_card_matches_the_cpu_port(card, tmp_path):
    from flink_jpmml_tpu_torch.runtime.net import (
        BlockFrameServer,
        TcpBlockSource,
    )

    cm = _gbm(tmp_path, 1024, n_trees=19, depth=6, n_features=32)
    cm_cpu = _gbm(tmp_path, 1024, device="cpu", n_trees=19, depth=6,
                  n_features=32)
    X = _X(np.random.default_rng(7), 8 * 1024, 32)
    got = {}
    srv = BlockFrameServer(X, block_size=1024)
    src = TcpBlockSource("127.0.0.1", srv.port, arity=32)
    try:
        pipe = BlockPipeline(
            src, cm, lambda o, n, f: got.__setitem__(
                f, np.asarray(o)[:n].copy()),
            RuntimeConfig(batch=BatchConfig(size=1024, deadline_us=2000)))
        pipe.run_until_exhausted(timeout=120)
    finally:
        src.close()
        srv.stop()
    q_cpu = cm_cpu.quantized_scorer()
    ref = np.asarray(q_cpu.predict_padded(*q_cpu.pad_wire(
        q_cpu.wire.encode(X))))[:X.shape[0]]
    out = np.concatenate([got[k] for k in sorted(got)])
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_every_search_candidate_equals_the_default_on_the_card(
        card, tmp_path, monkeypatch):
    """Each launch shape and walk layout of the kernel search's space,
    built and launched: bit-equal to today's launch and to the plain
    version; a shape the card cannot take is refused before a launch."""
    from flink_jpmml_tpu_torch.compile import autotune

    monkeypatch.setenv("FJT_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    for path in (gen_gbm(str(tmp_path), n_trees=60, depth=6, n_features=32,
                         name="g.pmml"),
                 gen_vote_forest(str(tmp_path), n_trees=40, depth=5,
                                 n_features=32, n_classes=3, name="v.pmml")):
        q = compile_pmml(parse_pmml_file(path), batch_size=4096
                         ).quantized_scorer()
        assert q.backend == "cuda"
        codes = torch.from_numpy(q.wire.encode(
            _X(np.random.default_rng(8), 20_003, 32))).to(card)
        tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
        today = qtrees_cuda.leaf_rows(codes, tables, 32)
        plain = qtrees_cuda.leaf_rows_reference(codes, tables)
        assert torch.equal(today, plain)
        cands = autotune.candidate_space(q)
        assert len(cands) > 2
        for c in cands:
            built = q.build_variant(c["layout"], c["threads"],
                                    c["chunk_bytes"])
            got = qtrees_cuda.leaf_rows(
                codes, {k: built["params"][k]
                        for k in qtrees_cuda.TABLE_KEYS}, 32,
                c["threads"], c["chunk_bytes"])
            assert torch.equal(got, today), c
        with pytest.raises(ValueError):
            qtrees_cuda.leaf_rows(codes, tables, 32, threads=96 + 1)


def test_profiled_pipeline_on_the_card(card, tmp_path, monkeypatch):
    """A block pipeline with the profiler sampling: device samples from
    the event pair, the device stage, and the walk's path steps against
    the H100 row. A sample times the scorer's function on codes already
    on the card, as the kernel search does: it reads within the drift
    band of that call timed alone."""
    from flink_jpmml_tpu_torch.obs import profiler

    monkeypatch.setenv("FJT_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("FJT_PROF_SAMPLE", "1e-6")
    cm = compile_pmml(parse_pmml_file(gen_gbm(
        str(tmp_path), n_trees=100, depth=6, n_features=32)),
        batch_size=16384)
    q = cm.quantized_scorer()
    X = _X(np.random.default_rng(9), 8 * 16384, 32)
    m = MetricsRegistry()
    prof = profiler.profiler_for(m)  # the pipeline's own profiler
    samples = []
    record = prof.record_sample

    def keep(device_s, profile, overhead_s=None):
        samples.append(device_s / profile["records"])
        record(device_s, profile, overhead_s)

    monkeypatch.setattr(prof, "record_sample", keep)
    got = []
    pipe = BlockPipeline(
        FiniteBlockSource(X, block_size=16384), cm,
        lambda out, n, off: got.append(n),
        RuntimeConfig(batch=BatchConfig(size=16384, deadline_us=2000)),
        metrics=m)
    pipe.run_until_exhausted(timeout=120)
    assert sum(got) == X.shape[0]
    snap = m.struct_snapshot()
    assert snap["counters"]["device_samples"] >= 1
    assert snap["gauges"]["flops_per_record"]["value"] == \
        q._meta["path_steps"]
    assert snap["gauges"]["device_mfu"]["value"] > 0
    dev = snap["histograms"][attr.stage_metric_name("device")]
    assert dev["n"] >= 1 and dev["sum"] > 0
    assert profiler.chip_peaks(torch.cuda.get_device_name(0),
                               strict=True) is not None
    codes = torch.from_numpy(q.wire.encode(X[:16384])).to(card)
    alone = []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        q._fn(q.params, codes)
        t1.record()
        t1.synchronize()
        alone.append(t0.elapsed_time(t1) * 1e6 / 16384)  # ns a record
    sampled = 1e9 * float(np.median(samples))
    band = profiler._PRED_BAND
    assert min(alone) / band <= sampled <= min(alone) * band, (sampled,
                                                               alone)


# -- multi-tenant and stateful scoring on the card --------------------------


def _pack_members(tmp_path, card, specs, rows, seed=3):
    """(tables on the card, codes u8[B, F] on the card) a member."""
    rng = np.random.default_rng(seed)
    members = []
    for i, kw in enumerate(specs):
        gen = gen_vote_forest if kw.pop("votes", False) else gen_gbm
        doc = parse_pmml_file(gen(str(tmp_path), name=f"m{i}.pmml", **kw))
        q = compile_pmml(doc, batch_size=max(rows)).quantized_scorer()
        assert q.backend == "cuda"
        tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
        codes = torch.from_numpy(q.wire.encode(
            _X(rng, max(rows), len(q.wire.fields)))).to(card)
        members.append((tables, codes))
    return members


@pytest.mark.parametrize("rows", [(256, 256, 256), (1, 0, 255), (1024, 7, 300)])
def test_packed_launch_equals_solo_launches_on_the_card(card, tmp_path, rows):
    members = _pack_members(tmp_path, card, [
        dict(n_trees=6, depth=3, n_features=4, seed=100),
        dict(n_trees=8, depth=3, n_features=4, n_classes=3, seed=5,
             votes=True),
        dict(n_trees=19, depth=6, n_features=32, seed=11),
    ], rows)
    F = max(c.shape[1] for _, c in members)
    codes = torch.zeros((3, max(rows), F), dtype=torch.uint8, device=card)
    for m, (_, c) in enumerate(members):
        codes[m, :, : c.shape[1]] = c
    tables = [t for t, _ in members]
    fields = [c.shape[1] for _, c in members]
    n0 = qtrees_cuda.leaf_rows_packed.launches
    got = qtrees_cuda.leaf_rows_packed(codes, list(rows), tables, fields)
    assert qtrees_cuda.leaf_rows_packed.launches == n0 + 1
    ref = qtrees_cuda.leaf_rows_packed_reference(codes, list(rows), tables,
                                                 fields)
    for m, (t, c) in enumerate(members):
        assert torch.equal(got[m], ref[m])
        if rows[m]:
            solo = qtrees_cuda.leaf_rows(c[: rows[m]].contiguous(), t,
                                         c.shape[1])
            assert torch.equal(got[m], solo)


def test_pack_and_zoo_on_the_card_equal_solo(card, tmp_path):
    from flink_jpmml_tpu_torch.compile import packs
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    paths = [gen_gbm(str(tmp_path), n_trees=6 + d, depth=3, n_features=4,
                     seed=100 + d, name=f"z{d}.pmml") for d in range(4)]

    def scorer(zoo):
        ctrl = ControlSource()
        sc = DynamicScorer(control=ctrl, batch_size=64, zoo=zoo)
        for d, p in enumerate(paths):
            ctrl.push(AddMessage(f"t{d}", 1, p, timestamp=1.0))
        sc._drain_control()
        for d in range(len(paths)):
            while sc.registry.model_if_warm(ModelId(f"t{d}", 1)) is None:
                time.sleep(0.01)
        return sc

    rng = np.random.default_rng(9)
    events = [(f"t{i % 4}", {f"f{j}": float(v) for j, v in
                              enumerate(rng.normal(size=4))})
              for i in range(256)]
    zoo, solo = scorer(True), scorer(False)
    n0 = qtrees_cuda.leaf_rows_packed.launches
    got = [p.score.value for p, _ in zoo.finish(zoo.submit(events))]
    want = [p.score.value for p, _ in solo.finish(solo.submit(events))]
    assert got == want
    assert qtrees_cuda.leaf_rows_packed.launches > n0
    qs = [zoo.registry.model_if_warm(ModelId(f"t{d}", 1)).quantized_scorer()
          for d in range(4)]
    assert all(packs.pack_eligible(q) for q in qs)


def test_state_step_on_the_card_is_deterministic_and_the_cpu_one(card):
    from flink_jpmml_tpu_torch.compile import statekernel

    rng = np.random.default_rng(4)
    S = np.zeros((4096, 8), np.float32)
    n = 8192
    slots = (rng.zipf(1.2, n) % 4095).astype(np.int32)  # heavy repeats
    reset = np.zeros(n, bool)
    rel = rng.integers(0, 5, n).astype(np.float32)
    w = np.power(np.float32(0.99), -rel).astype(np.float32)
    score = rng.normal(0, 2, n).astype(np.float32)
    outs = [statekernel._state_step(torch.from_numpy(S).to(card), score,
                                    slots, rel, w, reset, 4095, 0.99)
            for _ in range(3)]
    tables = [o[1].cpu().numpy().tobytes() for o in outs]
    assert tables[0] == tables[1] == tables[2]
    cd, cS = statekernel._state_step(torch.from_numpy(S), score, slots, rel,
                                     w, reset, 4095, 0.99)
    gS = outs[0][1].cpu().numpy()
    assert np.array_equal(gS[:, [0, 5, 6, 7]], cS.numpy()[:, [0, 5, 6, 7]])
    np.testing.assert_allclose(gS, cS.numpy(), rtol=1e-5, atol=1e-6)


def _one_by_one():
    from flink_jpmml_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()  # every card, all-DP: one card is the 1×1 mesh
    if mesh.size != 1:
        pytest.skip("the 1×1 card mesh needs exactly one card")
    return mesh


def test_one_by_one_mesh_pipeline_equals_the_unsharded_model(card, tmp_path):
    """BlockPipeline(mesh=) on the card's 1×1 mesh runs the same ops on
    the same batches as the unsharded model: equal outputs."""
    from flink_jpmml_tpu_torch.assets_gen import gen_stacked

    mesh = _one_by_one()
    assert mesh.shape == {"data": 1, "model": 1}
    doc = parse_pmml_file(gen_stacked(str(tmp_path), n_trees=10, depth=3,
                                      n_features=512, wide_lr=True))
    cm = compile_pmml(doc, batch_size=256)
    X = _X(np.random.default_rng(8), 1024, 512, missing=0.0)
    heads = {}
    for key, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        got = {}
        pipe = BlockPipeline(
            FiniteBlockSource(X, 256), cm,
            lambda out, n, off, got=got: got.setdefault(
                off, out.value[:n].clone()),
            RuntimeConfig(batch=BatchConfig(size=256, deadline_us=2000)),
            max_dispatch_chunks=1, **kw)
        assert pipe.backend == "f32" and pipe.device.type == "cuda"
        pipe.run_until_exhausted(timeout=120)
        heads[key] = torch.cat([got[k] for k in sorted(got)])
    assert heads["mesh"].shape == (1024,)
    assert torch.equal(heads["mesh"], heads["plain"])


def test_tp_linear_scorer_on_the_card_equals_the_plain_product(card):
    from flink_jpmml_tpu_torch.parallel.sharding import TpLinearScorer

    mesh = _one_by_one()
    rng = np.random.default_rng(9)
    W = rng.normal(0, 0.1, size=(4096, 3)).astype(np.float32)
    b = rng.normal(0, 0.1, size=3).astype(np.float32)
    X = rng.normal(size=(512, 4096)).astype(np.float32)
    got = TpLinearScorer(mesh=mesh, W=W, b=b, link="identity").predict(X)
    assert got.device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    want = torch.from_numpy(X).to(card) @ torch.from_numpy(W).to(card)
    want = want + torch.from_numpy(b).to(card)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.cpu().numpy(),
                               X.astype(np.float64) @ W + b,
                               rtol=2e-5, atol=1e-5)


def _cards(n_min=2):
    n = torch.cuda.device_count()
    if n < n_min:
        pytest.skip(f"needs {n_min} or more cards (a machine has {n})")
    return n


def _wide_stacked(tmp_path, F=512):
    from flink_jpmml_tpu_torch.assets_gen import gen_stacked

    return parse_pmml_file(gen_stacked(str(tmp_path), n_trees=10, depth=3,
                                       n_features=F, wide_lr=True))


def test_multi_card_mesh_scores_as_one_card(card, tmp_path):
    """DP rows on their own cards and the wide stage's TP slices across
    cards: every mesh shape of the machine's cards against the unsharded
    model on one card."""
    from flink_jpmml_tpu_torch.parallel.mesh import make_mesh
    from flink_jpmml_tpu_torch.utils.config import CompileConfig, MeshConfig

    n = _cards()
    doc = _wide_stacked(tmp_path)
    cfg = CompileConfig(tp_wide_threshold=64)
    cm = compile_pmml(doc, batch_size=256, config=cfg)
    X = _X(np.random.default_rng(12), 256, 512, missing=0.02)
    M = np.isnan(X)
    X = np.where(M, 0.0, X).astype(np.float32)
    want = cm.predict(X, M)
    for data, model in ((n, 1), (n // 2, 2), (1, n)):
        sm = compile_pmml(doc, batch_size=256, config=cfg,
                          mesh=make_mesh(MeshConfig(data, model),
                                         allow_subset=True))
        assert bool(sm.tp_sharded_leaves) == (model > 1)
        if model > 1:
            leaf = sm._row_params[-1]["model"]["s1"]["t0"]["num_coefs"]
            assert len({p.device for p in leaf.parts}) == model
        got = sm.predict(X, M)
        assert got.value.device == want.value.device
        assert torch.equal(got.valid, want.valid)
        np.testing.assert_allclose(got.value.cpu().numpy(),
                                   want.value.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_multi_card_chip_loss_rebuilds_over_the_survivors(card, tmp_path,
                                                          monkeypatch):
    """Chip loss on an all-DP mesh of the machine's cards: the pipeline
    retires the last card, redispatches, and delivers every record once,
    each score the one-card model's."""
    from flink_jpmml_tpu_torch.parallel.mesh import make_mesh
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager

    n = _cards()
    monkeypatch.setenv("FJT_RETRY_BASE_S", "0.005")
    cm = _gbm(tmp_path, 256 * n, n_trees=20, depth=4, n_features=8)
    X = _X(np.random.default_rng(13), 16 * 256 * n, 8)
    got = []
    metrics = MetricsRegistry()
    faults.clear()
    faults.inject("chip_loss", n=1)
    try:
        pipe = BlockPipeline(
            FiniteBlockSource(X, 256 * n), cm,
            lambda out, k, off: got.append((off, k, out.value[:k].clone())),
            RuntimeConfig(batch=BatchConfig(size=256 * n, deadline_us=5000),
                          checkpoint_interval_s=0.05),
            metrics=metrics,
            checkpoint=CheckpointManager(str(tmp_path / "ck")),
            max_dispatch_chunks=1, mesh=make_mesh())
        pipe.run_until_exhausted(timeout=120)
    finally:
        faults.clear()
    cover = np.zeros(len(X), np.int64)
    for off, k, _ in got:
        cover[off:off + k] += 1
    assert (cover == 1).all()
    snap = metrics.struct_snapshot()
    assert snap["counters"]["mesh_rebuilds"] == 1
    assert snap["gauges"]["mesh_data_width"]["value"] == n - 1
    M = np.isnan(X)
    ref = cm.predict(np.where(M, 0.0, X).astype(np.float32),
                     M).value.cpu().numpy()
    for off, k, vals in got:
        np.testing.assert_allclose(vals.numpy(), ref[off:off + k],
                                   rtol=RTOL, atol=ATOL)


def test_multi_card_state_blocks_step_to_one_card_bytes(card):
    """A state table over an all-DP mesh of the machine's cards holds its
    rows in one block a card; a stream through it gives the one-card
    table's bytes, and so does a migrate over the survivors."""
    from flink_jpmml_tpu_torch.compile import statekernel
    from flink_jpmml_tpu_torch.parallel.mesh import make_mesh
    from flink_jpmml_tpu_torch.parallel.sharding import degraded_mesh
    from flink_jpmml_tpu_torch.runtime.state import (
        KeyedStateTable,
        RowBlocks,
        StateSpec,
    )

    n = _cards()
    spec = StateSpec(capacity=1 << 16)
    one = KeyedStateTable(spec)
    mesh = make_mesh()
    blk = KeyedStateTable(spec)
    blk.shard(mesh)
    assert isinstance(blk.values, RowBlocks)
    assert len({b.device for b in blk.values.blocks}) == n

    def stream(t, seed, batches):
        rng = np.random.default_rng(seed)
        for b in range(batches):
            keys = rng.zipf(1.1, 4096) % (1 << 18)
            offs = np.arange(b * 4096, (b + 1) * 4096)
            slots, reset, rel, w = t.assign_slots(t.hash_keys(keys), offs)
            score = torch.from_numpy(
                rng.normal(size=4096).astype(np.float32)).to(card)
            _, derived, S2 = statekernel.step_after(score, t, slots, rel, w,
                                                    reset)
            t.commit(S2)
            yield derived

    for d1, d2 in zip(stream(one, 3, 8), stream(blk, 3, 8)):
        assert torch.equal(d1.cpu(), d2.cpu())
    assert one.host_values().tobytes() == blk.host_values().tobytes()
    blk.migrate(degraded_mesh(mesh, [n - 1]))
    assert len(blk.values.blocks) == n - 1
    for d1, d2 in zip(stream(one, 4, 4), stream(blk, 4, 4)):
        assert torch.equal(d1.cpu(), d2.cpu())
    assert one.host_values().tobytes() == blk.host_values().tobytes()
