"""The port's cost model (``flink_jpmml_tpu_torch/compile/costmodel.py``)
and kernel cost ledger against the JAX package's, on the CPU.

The same (features, cost) rows, made from a numpy seed, must give the same
ridge coefficients (rtol 1e-12), predictions and ranking; the same model
metas must give the same pack prices and the same ``PackPlan``. The
port's files live in its own cache, never in the JAX package's: the fit
and the ledger are platform-scoped, and a corrupt file reads as none."""

import json
import math
import os

import numpy as np
import pytest

from flink_jpmml_tpu.compile import autotune as jautotune
from flink_jpmml_tpu.compile import costmodel as jcostmodel
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import autotune, costmodel, qtrees_cuda
from flink_jpmml_tpu_torch.compile.qtrees import build_quantized_scorer
from flink_jpmml_tpu_torch.obs import profiler
from flink_jpmml_tpu_torch.pmml import parse_pmml_file


def _planted_rows(n=40, seed=0, width=3):
    """Synthetic (features, y) with y = exp(w · x) for seeded weights."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=width)
    rows = []
    for _ in range(n):
        x = rng.normal(size=width)
        rows.append(({f"f{i}": float(x[i]) for i in range(width)},
                     math.exp(float(w @ x))))
    return rows


@pytest.fixture
def scorer(tmp_path):
    doc = parse_pmml_file(gen_gbm(str(tmp_path), n_trees=10, depth=3,
                                  n_features=4))
    return build_quantized_scorer(doc, batch_size=64, device="cpu")


class TestCostModelMatchesJax:
    @pytest.mark.parametrize("seed,width,l2", [
        (0, 3, 1e-2), (1, 6, 1e-6), (2, 12, 1e-2)])
    def test_same_coefficients_predictions_and_rank(self, seed, width, l2):
        rows = _planted_rows(40, seed, width)
        m = costmodel.CostModel.fit(rows, l2=l2)
        jm = jcostmodel.CostModel.fit(rows, l2=l2)
        assert m.names == jm.names
        np.testing.assert_allclose(m.weights, jm.weights, rtol=1e-12)
        np.testing.assert_allclose(m.mean, jm.mean, rtol=1e-12)
        np.testing.assert_allclose(m.std, jm.std, rtol=1e-12)
        assert m.bias == pytest.approx(jm.bias, rel=1e-12)
        assert m.stats["rows"] == jm.stats["rows"] == 40
        assert m.stats["mae_log"] == jm.stats["mae_log"]
        assert m.stats["r2"] == jm.stats["r2"]
        cands = {f"c{i}": f for i, (f, _) in enumerate(
            _planted_rows(8, seed + 100, width))}
        assert [n for n, _ in m.rank(cands)] == \
            [n for n, _ in jm.rank(cands)]
        for f in cands.values():
            assert m.predict(f) == pytest.approx(jm.predict(f), rel=1e-12)

    def test_recovers_a_planted_law(self):
        rows = _planted_rows(48)  # one law: fit 40, hold out 8
        m = costmodel.CostModel.fit(rows[:40], l2=1e-6)
        assert m.stats["r2"] > 0.99
        for f, y in rows[40:]:
            assert 0.8 < m.predict(f) / y < 1.25

    def test_garbage_rows_skipped_alike(self):
        rows = _planted_rows(10) + [
            ({}, 1.0), (None, 1.0), ({"f0": 1.0}, -1.0),
            ({"f0": 1.0}, float("nan")), ({"f0": 1.0}, "wat"),
        ]
        assert costmodel.CostModel.fit(rows).stats["rows"] == \
            jcostmodel.CostModel.fit(rows).stats["rows"] == 10
        assert costmodel.CostModel.fit([({}, 1.0)]) is None

    def test_persistence_roundtrip_corruption_and_platform(self, tmp_path):
        path = str(tmp_path / "cm.json")
        m = costmodel.CostModel.fit(_planted_rows())
        costmodel.save(m, path, platform="cuda:NVIDIA_H100_80GB_HBM3")
        f = {"f0": 0.3, "f1": -0.2, "f2": 0.1}
        assert costmodel.load(path).predict(f) == pytest.approx(m.predict(f))
        assert costmodel.load(
            path, platform="cuda:NVIDIA_H100_80GB_HBM3") is not None
        # a fit from the card never ranks a CPU search, nor the reverse
        assert costmodel.load(path, platform="cpu:cpu") is None
        with open(path, "w") as fh:
            fh.write("\x00not json{{{")
        assert costmodel.load(path) is None


class TestVariantFeatures:
    def test_cover_the_cuda_search_axes(self, scorer):
        meta = costmodel.scorer_meta(scorer)
        f = costmodel.variant_features(meta, "cuda", "bfs", 128, 12288)
        W = qtrees_cuda.walk_words(int(meta["splits"]), int(meta["leaves"]),
                                   1)
        th, trees, _ = qtrees_cuda.launch_shape(4, 10, W, 128, 12288)
        assert f["log2_threads"] == math.log2(th) == 7.0
        assert f["log2_chunk_trees"] == pytest.approx(math.log2(trees))
        assert f["layout_bfs"] == 1.0 and f["layout_wirepack"] == 0.0
        assert f["log2_trees"] == pytest.approx(math.log2(10))
        assert f["depth"] == pytest.approx(math.log2(meta["splits"] + 1))
        assert f["classes"] == 1.0 and f["backend_cuda"] == 1.0
        assert f["log2_fields"] == 2.0
        # the kernel's own choice reads as the explicit shape it resolves to
        auto = costmodel.variant_features(meta, "cuda", "ref", None, None)
        th0, trees0, _ = qtrees_cuda.launch_shape(4, 10, W)
        same = costmodel.variant_features(meta, "cuda", "ref", th0,
                                          trees0 * W * 8)
        assert auto == same

    def test_torch_twin_has_no_launch_shape(self, scorer):
        f = costmodel.variant_features(costmodel.scorer_meta(scorer),
                                       "torch", "bfs_wirepack", None, None,
                                       wire_bytes=3.0)
        assert f["backend_cuda"] == 0.0 and f["log2_threads"] == 0.0
        assert f["layout_bfs"] == f["layout_wirepack"] == 1.0
        assert f["log2_wire_bytes"] == pytest.approx(math.log2(3.0))


class TestLedger:
    def test_rows_carry_features_platform_and_residual(self, tmp_path):
        path = str(tmp_path / "kc.json")
        led = profiler.KernelCostLedger(path=path, flush_interval_s=0.0)
        led.update("m1", "cuda", 0.5, 1000, 100.0, 36.0,
                   variant="cuda_t128_c12288_bfs", features={"depth": 3.0},
                   predicted=4e-4, platform="cuda:NVIDIA_H100_80GB_HBM3")
        (key, e), = profiler.read_ledger(path).items()
        assert key == "m1|cuda|cuda_t128_c12288_bfs"
        assert e["features"] == {"depth": 3.0}
        assert e["platform"] == "cuda:NVIDIA_H100_80GB_HBM3"
        assert e["pred_err"] == pytest.approx(0.25)

    def test_writers_merge_and_newest_wins(self, tmp_path):
        path = str(tmp_path / "kc.json")
        a = profiler.KernelCostLedger(path=path, flush_interval_s=math.inf)
        b = profiler.KernelCostLedger(path=path, flush_interval_s=math.inf)
        a.update("m1", "cuda", 0.5, 1000, None, None, variant="v1")
        b.update("m2", "torch", 0.2, 1000, None, None, variant="v2")
        a.flush()
        b.flush()
        assert set(profiler.read_ledger(path)) == {"m1|cuda|v1",
                                                   "m2|torch|v2"}
        a.update("m", "cuda", 0.4, 1000, None, None)
        a.flush()
        b.update("m", "cuda", 0.1, 1000, None, None)
        b.flush()
        a.update("m", "cuda", 0.4, 1000, None, None)
        with a._mu:
            a._entries["m|cuda"]["ts"] -= 3600.0
            a._dirty = True
        a.flush()
        e = profiler.read_ledger(path)["m|cuda"]
        assert e["device_s_per_record"] == pytest.approx(1e-4)

    def test_corrupt_ledger_reads_empty_then_rewrites(self, tmp_path):
        path = str(tmp_path / "kc.json")
        with open(path, "w") as f:
            f.write("{broken")
        assert profiler.read_ledger(path) == {}
        led = profiler.KernelCostLedger(path=path, flush_interval_s=0.0)
        led.update("m", "cuda", 0.1, 100, None, None)
        assert json.load(open(path))["entries"]

    def test_fit_from_ledger_is_the_jax_fit_of_its_rows(self, tmp_path):
        path = str(tmp_path / "kc.json")
        led = profiler.KernelCostLedger(path=path, flush_interval_s=math.inf)
        rng = np.random.default_rng(3)
        rows = []
        for i in range(10):
            a, b = (float(x) for x in rng.normal(size=2))
            y = math.exp(a - 0.5 * b) * 1e-6
            rows.append(({"a": a, "b": b}, y))
            led.update("m", "cuda", y * 1000, 1000, None, None,
                       variant=f"v{i}", features={"a": a, "b": b},
                       platform="cpu:cpu")
        led.update("legacy", "cuda", 0.1, 100, None, None)  # no features
        led.update("card", "cuda", 0.1, 100, None, None, variant="x",
                   features={"a": 1.0}, platform="cuda:other")
        led.flush()
        m = costmodel.fit_from_ledger(path=path, min_rows=5,
                                      platform="cpu:cpu")
        jm = jcostmodel.CostModel.fit(rows)
        assert m.stats["rows"] == 10
        np.testing.assert_allclose(m.weights, jm.weights, rtol=1e-12)
        assert costmodel.fit_from_ledger(path=path, min_rows=11,
                                         platform="cpu:cpu") is None


class TestPackPricing:
    def _metas(self, seed, n):
        rng = np.random.default_rng(seed)
        return {f"h{seed}_{i}": {
            "trees": float(rng.integers(5, 80)),
            "splits": float(rng.integers(3, 63)),
            "leaves": float(rng.integers(4, 64)),
            "fields": float(rng.integers(2, 40)),
            "batch": float(rng.choice([256, 1024])),
            "dtype_rank": float(rng.choice([1, 2])),
            "classification": float(rng.integers(0, 2)),
        } for i in range(n)}

    def test_overhead_knob(self, monkeypatch):
        assert costmodel.pack_dispatch_overhead_s() == 5e-4
        monkeypatch.setenv("FJT_PACK_DISPATCH_OVERHEAD_S", "2e-3")
        assert costmodel.pack_dispatch_overhead_s() == 2e-3
        assert jcostmodel.pack_dispatch_overhead_s() == 2e-3
        monkeypatch.setenv("FJT_PACK_DISPATCH_OVERHEAD_S", "-1")
        assert costmodel.pack_dispatch_overhead_s() == 5e-4

    @pytest.mark.parametrize("seed,n", [(0, 3), (1, 9), (2, 20)])
    def test_same_prices_and_plan_as_jax(self, seed, n, tmp_path,
                                         monkeypatch):
        from flink_jpmml_tpu.compile import layouts as jlayouts
        from flink_jpmml_tpu_torch.compile import layouts

        metas = self._metas(seed, n)
        for part in layouts.pack_partitions(metas):
            assert costmodel.pack_partition_cost(metas, part) == \
                pytest.approx(jcostmodel.pack_partition_cost(metas, part),
                              rel=1e-12)
        assert layouts.pack_partitions(metas) == \
            jlayouts.pack_partitions(metas)
        # each package's own cache, both empty: no fit, the proxy prices
        monkeypatch.setenv("FJT_AUTOTUNE_CACHE",
                           str(tmp_path / "port" / "autotune.json"))
        plan = autotune.ensure_pack_plan(metas)
        monkeypatch.setenv("FJT_AUTOTUNE_CACHE",
                           str(tmp_path / "jax" / "autotune.json"))
        jplan = jautotune.ensure_pack_plan(metas, plat="cpu:")
        assert plan.groups == jplan.groups
        assert plan.set_hash == jplan.set_hash
        assert plan.waste == pytest.approx(jplan.waste, rel=1e-12)
        assert plan.pred_s_per_record == pytest.approx(
            jplan.pred_s_per_record, rel=1e-12)
        # the port's plan is cached in the port's file, and found again
        monkeypatch.setenv("FJT_AUTOTUNE_CACHE",
                           str(tmp_path / "port" / "autotune.json"))
        again = autotune.ensure_pack_plan(metas)
        assert again.source == "cache" and again.groups == plan.groups

    def test_pack_plan_cache_contracts(self, monkeypatch):
        metas = self._metas(7, 4)
        plan = autotune.ensure_pack_plan(metas)
        assert autotune.lookup_pack_plan(plan.set_hash) is not None
        monkeypatch.setenv("FJT_AUTOTUNE_DISABLE", "1")
        assert autotune.lookup_pack_plan(plan.set_hash) is None
        monkeypatch.delenv("FJT_AUTOTUNE_DISABLE")
        stale = autotune.PackPlan.from_dict({**plan.as_dict(),
                                             "space": "packspace-v0"})
        autotune.store_pack_plan(stale)
        assert autotune.lookup_pack_plan(plan.set_hash) is None
        assert autotune.PackPlan.from_dict({"groups": 3}) is None


def test_files_live_in_the_port_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("FJT_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    base = os.path.join(str(tmp_path), ".cache", "flink_jpmml_tpu_torch")
    assert str(autotune.cache_path()) == os.path.join(base,
                                                      "autotune-cpu.json")
    assert costmodel.model_path() == os.path.join(base, "cost_model-cpu.json")
    assert profiler.cost_ledger_path() == os.path.join(
        base, "kernel_costs-cpu.json")
    led = profiler.KernelCostLedger(flush_interval_s=0.0)
    led.update("m", "cuda", 0.1, 100, None, None)
    costmodel.save(costmodel.CostModel.fit(_planted_rows()))
    assert sorted(os.listdir(base)) == [
        "cost_model-cpu.json", "kernel_costs-cpu.json",
        "kernel_costs-cpu.json.lock"]
    assert not os.path.exists(os.path.join(str(tmp_path), ".cache",
                                           "flink_jpmml_tpu"))
