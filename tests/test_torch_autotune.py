"""The port's kernel search and autotune cache
(``flink_jpmml_tpu_torch/compile/autotune.py``) on the CPU.

Mirrors the JAX package's ``tests/test_autotune.py`` and the search cases
of ``tests/test_costmodel.py`` over the port's space: the ``cuda``
backends' launch shapes × walk layouts (scored here through the kernel's
plain version, ``cuda_plain``) and the torch twin's layouts. A sweep
times at most top-K, feeds the ledger, holds every timed candidate
bit-equal to the built default and raises on one that is not; the winner
persists in the port's cache and a fresh build adopts it without a
sweep; a stale tag, a corrupt file or ``FJT_AUTOTUNE_DISABLE`` read as no
entry. ``leaf_rows`` refuses a launch shape the card cannot take, by the
.cu source's own limits."""

import json
import re

import numpy as np
import pytest
import torch

from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_vote_forest
from flink_jpmml_tpu_torch.compile import autotune, costmodel, layouts
from flink_jpmml_tpu_torch.compile import qtrees_cuda
from flink_jpmml_tpu_torch.compile.qtrees import build_quantized_scorer
from flink_jpmml_tpu_torch.obs import attr, profiler
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.pmml import parse_pmml, parse_pmml_file
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
from test_layouts import stump_forest_xml


@pytest.fixture
def doc(tmp_path):
    return parse_pmml_file(gen_gbm(str(tmp_path), n_trees=10, depth=3,
                                   n_features=4))


def _X(n=64, f=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.5, size=(n, f)).astype(np.float32)
    X[rng.random(size=X.shape) < 0.2] = np.nan
    return X


def _build(doc, **kw):
    return build_quantized_scorer(doc, batch_size=64, device="cpu", **kw)


def _scores(q, X):
    out = q.predict_wire(q.wire.encode(X))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) \
        else out.numpy()


class TestLaunchShape:
    def test_constants_are_the_cuda_sources(self):
        src = qtrees_cuda.SOURCE.read_text()

        def const(name):
            m = re.search(rf"constexpr int {name} = ([0-9 *]+);", src)
            return eval(m.group(1))  # noqa: S307 - digits and '*' only

        assert const("kMaxThreads") == qtrees_cuda.MAX_THREADS
        assert const("kRecordsPerThread") == qtrees_cuda.RECORDS_PER_THREAD
        # the default shape's budgets live only in launch_shape
        assert "kChunkBytes" not in src and "kSmemTarget" not in src
        assert const("kSmemMax") == qtrees_cuda.SMEM_MAX
        assert const("kBarBytes") == qtrees_cuda.BAR_BYTES

    def test_default_is_todays_choice(self):
        # the main path's 500 depth-6 trees over 32 fields
        W = qtrees_cuda.walk_words(63, 64, 1)
        assert qtrees_cuda.launch_shape(32, 500, W) == (256, 19, 85520)
        assert qtrees_cuda.launch_shape(32, 500, W, 256, 24576) == \
            (256, 19, 85520)
        W3 = qtrees_cuda.walk_words(63, 64, 3)
        assert qtrees_cuda.launch_shape(32, 500, W3)[:2] == (256, 13)

    @pytest.mark.parametrize("threads,chunk", [
        (48, None), (0, None), (-32, None), (512, None), (288, None),
        (256, 98304 + 16384), (None, 0)])
    def test_leaf_rows_refuses_a_bad_shape(self, doc, threads, chunk):
        q = _build(doc)
        codes = torch.from_numpy(q.wire.encode(_X()))
        tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
        W = tables["walk"].shape[1]
        if chunk is not None and chunk > 98304:
            # over the block's shared memory only with many trees a chunk
            with pytest.raises(ValueError, match="shared memory"):
                qtrees_cuda.launch_shape(32, 500, qtrees_cuda.walk_words(
                    63, 64, 1), threads, chunk)
            return
        with pytest.raises(ValueError):
            qtrees_cuda.leaf_rows(codes, tables, 4, threads, chunk)
        with pytest.raises(ValueError):
            qtrees_cuda.launch_shape(4, 10, W, threads, chunk)

    def test_a_good_shape_scores_as_the_default(self, doc):
        q = _build(doc)
        codes = torch.from_numpy(q.wire.encode(_X()))
        tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
        ref = qtrees_cuda.leaf_rows(codes, tables, 4)
        for th, cb in ((32, 1), (64, 12288), (256, 98304)):
            assert torch.equal(qtrees_cuda.leaf_rows(codes, tables, 4, th, cb),
                               ref)


class TestSpace:
    def test_cuda_space(self, doc):
        q = _build(doc)
        cands = autotune.candidate_space(q)
        assert cands[0] == {"layout": "ref", "threads": None,
                            "chunk_bytes": None}
        names = [autotune._cand_name(q, c) for c in cands]
        assert len(set(names)) == len(names)
        assert {c["layout"] for c in cands} == {"ref", "bfs"}
        assert "cuda_auto_bfs" in names
        for c in cands:
            # every candidate is a shape the card can take
            autotune._resolved_shape(q, c["threads"], c["chunk_bytes"])

    def test_legacy_space_is_ref_shapes(self, doc, monkeypatch):
        q = _build(doc)
        cands = autotune.candidate_space(q, legacy=True)
        assert {c["layout"] for c in cands} == {"ref"} and len(cands) > 1

    def test_torch_twin_space(self):
        q = build_quantized_scorer(parse_pmml(stump_forest_xml()),
                                   batch_size=32, device="cpu")
        names = [autotune._cand_name(q, c)
                 for c in autotune.candidate_space(q)]
        assert names == ["torch_ref", "torch_bfs", "torch_wirepack",
                         "torch_bfs_wirepack"]


class TestSweep:
    def test_sweep_measures_encodes_and_bounds_timing(self, doc):
        q = _build(doc)
        ref = _scores(q, _X(seed=3))
        cfg = autotune.sweep(q, _X(), repeats=1, top_k=3)
        s = cfg.search
        assert s["mode"] == "bootstrap" and s["space"] == layouts.SPACE_TAG
        assert s["timed"] <= 3 < s["candidates_total"]
        assert "encode_host" in cfg.rates and "encode_fused" in cfg.rates
        assert cfg.encode in ("host", "fused") and q.encode_mode == cfg.encode
        assert "cuda_auto" in cfg.rates  # the default is always timed
        assert len(costmodel.training_rows()) >= s["timed"]
        assert q._rebuild is None  # released once tuned
        assert q.launch == (cfg.threads, cfg.chunk_bytes)
        np.testing.assert_array_equal(_scores(q, _X(seed=3)), ref)

    def test_sample_tiled_to_whole_batches(self, doc):
        q = _build(doc)
        cfg = autotune.sweep(q, _X(n=100), repeats=1, top_k=1)
        assert cfg.search["rows"] == 128

    def test_second_search_is_learned(self, doc):
        autotune.sweep(_build(doc), _X(), repeats=1, top_k=8)
        cfg2 = autotune.sweep(_build(doc), _X(), repeats=1, top_k=3)
        assert cfg2.search["mode"] == "learned"
        assert cfg2.search["timed"] <= 3
        assert len(cfg2.search["predicted"]) == \
            cfg2.search["candidates_total"]
        assert "cuda_auto" in cfg2.rates

    def test_learned_across_models(self, tmp_path, doc):
        autotune.sweep(_build(doc), _X(), repeats=1, top_k=8)
        vdoc = parse_pmml_file(gen_vote_forest(
            str(tmp_path), n_trees=8, depth=3, n_features=4, n_classes=3,
            seed=1))
        q = _build(vdoc)
        ref = _scores(q, _X(seed=4))
        cfg = autotune.sweep(q, _X(), repeats=1)
        assert cfg.search["mode"] == "learned"
        for a, b in zip(_scores(q, _X(seed=4)), ref):
            np.testing.assert_array_equal(a, b)

    def test_disable_env_is_the_legacy_space(self, doc, monkeypatch):
        monkeypatch.setenv("FJT_KERNEL_SEARCH_DISABLE", "1")
        cfg = autotune.sweep(_build(doc), _X(), repeats=1, top_k=50)
        assert cfg.search["mode"] == "legacy" and cfg.layout == "ref"
        assert all(not k.endswith("_bfs") for k in cfg.rates)

    def test_topk_env(self, doc, monkeypatch):
        monkeypatch.setenv("FJT_SEARCH_TOPK", "2")
        cfg = autotune.sweep(_build(doc), _X(), repeats=1)
        assert cfg.search["top_k"] == 2 and cfg.search["timed"] == 2

    def test_a_variant_that_disagrees_raises(self, doc):
        q = _build(doc)
        rebuild = q._rebuild

        def broken(layout="ref", threads=None, chunk_bytes=None):
            built = rebuild(layout, threads, chunk_bytes)
            fn = built["fn"]
            built["fn"] = lambda pp, Xq: fn(pp, Xq) + 1.0
            return built

        q._rebuild = broken
        with pytest.raises(autotune.VariantMismatchError):
            autotune.sweep(q, _X(), repeats=1, top_k=2)

    def test_a_failed_build_raises(self, doc):
        q = _build(doc)

        def failing(*a):
            raise RuntimeError("nvcc said no")

        q._rebuild = failing
        with pytest.raises(RuntimeError, match="nvcc said no"):
            autotune.sweep(q, _X(), repeats=1, top_k=2)

    def test_torch_twin_search_covers_layouts(self):
        doc = parse_pmml(stump_forest_xml())
        q = build_quantized_scorer(doc, batch_size=32, device="cpu")
        X = _X(n=32, f=2, seed=5)
        ref = _scores(q, X)
        cfg = autotune.sweep(q, X, repeats=1, top_k=4)
        assert cfg.search["timed"] == 4
        assert {k for k in cfg.rates if k.startswith("torch_")} == {
            "torch_ref", "torch_bfs", "torch_wirepack", "torch_bfs_wirepack"}
        np.testing.assert_array_equal(_scores(q, X), ref)


class TestCache:
    def test_ensure_tuned_persists_and_next_build_adopts(self, doc,
                                                         monkeypatch):
        q = _build(doc)
        cfg = autotune.ensure_tuned(q, _X(), repeats=1, top_k=4)
        assert cfg.source == "sweep"
        calls = []
        monkeypatch.setattr(autotune, "sweep",
                            lambda *a, **k: calls.append(1))
        q2 = _build(doc)  # consults the cache at build: no sweep
        assert not calls
        assert q2.tuned is not None and q2.tuned.source == "cache"
        assert (q2.layout, q2.launch, q2.encode_mode) == (
            cfg.layout, (cfg.threads, cfg.chunk_bytes), cfg.encode)
        assert q2._rebuild is None
        np.testing.assert_array_equal(_scores(q2, _X(seed=7)),
                                      _scores(_build(doc, ), _X(seed=7)))
        assert autotune.ensure_tuned(_build(doc), _X()).source == "cache"
        assert not calls

    def test_an_adopted_bfs_shape_serves_and_profiles(self, doc):
        q = _build(doc)
        key = autotune.backend_key(q)
        autotune.store(q.model_hash, key, autotune.TunedConfig(
            encode="fused", layout="bfs", threads=64, chunk_bytes=12288,
            predicted_s_per_record=2e-6, source="sweep"))
        q2 = _build(doc)
        assert (q2.layout, q2.launch) == ("bfs", (64, 12288))
        assert q2.encode_placement == "fused"
        p = attr.dispatch_profile(q2, 64)
        assert p["variant"] == "cuda_t64_c12288_bfs"
        assert p["predicted_s_per_record"] == 2e-6
        assert p["features"]["layout_bfs"] == 1.0
        np.testing.assert_array_equal(_scores(q2, _X(seed=8)),
                                      _scores(q, _X(seed=8)))

    def test_a_variant_this_build_cannot_take_degrades(self, doc):
        q = _build(doc)
        autotune.apply(q, autotune.TunedConfig(
            layout="wirepack", predicted_s_per_record=1e-6, source="sweep"))
        assert q.layout == "ref" and q._pred_s_per_record is None
        assert attr.dispatch_profile(q, 64)["variant"] == "cuda_auto"

    def test_disable_env_bypasses_the_cache(self, doc, monkeypatch):
        q = _build(doc)
        autotune.store(q.model_hash, autotune.backend_key(q),
                       autotune.TunedConfig(layout="bfs", source="sweep"))
        monkeypatch.setenv("FJT_AUTOTUNE_DISABLE", "1")
        q2 = _build(doc)
        assert q2.tuned is None and q2.layout == "ref"
        assert q2.encode_mode is None

    def test_keys_hold_the_device_and_backend(self, doc):
        q = _build(doc)
        assert autotune.backend_key(q) == "cpu:cpu:cuda_plain"
        qt = build_quantized_scorer(parse_pmml(stump_forest_xml()),
                                    batch_size=32, device="cpu")
        assert autotune.backend_key(qt) == "cpu:cpu:torch"
        autotune.store(q.model_hash, "cuda:NVIDIA_H100_80GB_HBM3:cuda",
                       autotune.TunedConfig(layout="bfs"))
        assert _build(doc).tuned is None  # the card's entry is not the CPU's

    def test_stale_tag_and_untagged_entries_read_as_none(self, doc):
        q = _build(doc)
        key = autotune.backend_key(q)
        cfg = autotune.TunedConfig(encode="fused", source="sweep")
        cfg.space = "torch-space-v0"
        autotune.store(q.model_hash, key, cfg)
        assert autotune.lookup(q.model_hash, key) is None
        path = autotune.cache_path()
        path.write_text(json.dumps({"version": 1, "entries": {
            f"{q.model_hash}|{key}": {"encode": "fused", "threads": 64}}}))
        assert autotune.lookup(q.model_hash, key) is None
        autotune.store(q.model_hash, key, autotune.TunedConfig())
        assert autotune.lookup(q.model_hash, key).space == layouts.SPACE_TAG

    @pytest.mark.parametrize("content", [
        "{not json", json.dumps({"entries": 3}), json.dumps([1, 2])])
    def test_corrupt_file_reads_empty_and_retunes(self, doc, content):
        path = autotune.cache_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(content)
        q = _build(doc)
        assert q.tuned is None
        cfg = autotune.ensure_tuned(q, _X(), repeats=1, top_k=1)
        assert cfg.source == "sweep"
        assert autotune.lookup(q.model_hash, autotune.backend_key(q))

    def test_garbage_entry_values_tolerated(self, doc):
        q = _build(doc)
        key = autotune.backend_key(q)
        path = autotune.cache_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"version": 1, "entries": {
            f"{q.model_hash}|{key}": {
                "encode": "warp", "layout": 7, "rates": {"a": "x", "b": 2},
                "space": layouts.SPACE_TAG, "search": "no"}}}))
        cfg = autotune.lookup(q.model_hash, key)
        assert (cfg.encode, cfg.layout, cfg.rates, cfg.search) == (
            "host", "ref", {"b": 2.0}, None)

    def test_stale_fused_degrades_to_host(self, doc):
        q = _build(doc)
        q._encode_stage = None
        autotune.apply(q, autotune.TunedConfig(encode="fused"))
        assert q.encode_mode == "host" and q.encode_placement == "host"

    def test_clear_scoped_and_full(self, doc):
        q = _build(doc)
        key = autotune.backend_key(q)
        autotune.store(q.model_hash, key, autotune.TunedConfig())
        autotune.store("other", key, autotune.TunedConfig())
        autotune.clear(q.model_hash)
        assert autotune.lookup(q.model_hash, key) is None
        assert autotune.lookup("other", key) is not None
        autotune.clear()
        assert not autotune.cache_path().exists()


class TestDriftBand:
    def _profile(self, q, predicted):
        p = attr.dispatch_profile(q, 64)
        p["predicted_s_per_record"] = predicted
        return p

    def _prof(self, tmp_path):
        m = MetricsRegistry()
        return m, profiler.DeviceProfiler(
            m, interval_s=0.0, cost_ledger=profiler.KernelCostLedger(
                path=str(tmp_path / "kc.json")))

    def test_sustained_drift_reopens_the_search(self, doc, tmp_path):
        q = _build(doc)
        key = autotune.backend_key(q)
        autotune.store(q.model_hash, key, autotune.TunedConfig())
        m, prof = self._prof(tmp_path)
        gen0 = costmodel.generation()
        for _ in range(3):
            prof.record_sample(64e-6, self._profile(q, 1e-8))
        assert costmodel.generation() == gen0 + 1
        assert autotune.lookup(q.model_hash, key) is None
        assert m.struct_snapshot()["gauges"]["kernel_pred_error"][
            "value"] > 0
        kinds = [e.get("kind") for e in flight.events()]
        assert "kernel_search_stale" in kinds and "costmodel_stale" in kinds

    def test_in_band_and_one_shot(self, doc, tmp_path):
        q = _build(doc)
        key = autotune.backend_key(q)
        autotune.store(q.model_hash, key, autotune.TunedConfig())
        m, prof = self._prof(tmp_path)
        gen0 = costmodel.generation()
        for _ in range(10):
            prof.record_sample(64e-6, self._profile(q, 1.2e-6))
        assert costmodel.generation() == gen0
        assert autotune.lookup(q.model_hash, key) is not None
        for _ in range(12):
            prof.record_sample(64e-6, self._profile(q, 1e-8))
        assert costmodel.generation() == gen0 + 1
        for _ in range(3):
            prof.record_sample(64e-6, self._profile(q, 2e-8))
        assert costmodel.generation() == gen0 + 2

    def test_no_prediction_no_gauge(self, doc, tmp_path):
        m, prof = self._prof(tmp_path)
        prof.record_sample(64e-6, attr.dispatch_profile(_build(doc), 64))
        assert "kernel_pred_error" not in m.struct_snapshot()["gauges"]
