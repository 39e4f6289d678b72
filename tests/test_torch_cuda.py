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
with TF32 off.
They skip where there is no card. This file
imports neither jax nor the JAX package, so it runs on a machine that has
only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from chip_smoke import caterpillar_forest, ragged_forest, random_codes
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
    assert len(report) == 3  # one instance per class bucket: 1, 4, 16
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
