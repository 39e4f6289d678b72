"""The PyTorch port stands alone: it imports neither jax nor anything of
the JAX package, and its entry points default to the CUDA card — raising
a typed error, never carrying on on the CPU, when there is none."""

import pathlib
import subprocess
import sys

import pytest
import torch

from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.compile import qtrees as tq
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, FiniteBlockSource
from flink_jpmml_tpu_torch.utils.exceptions import DeviceUnavailableError

ROOT = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import flink_jpmml_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "flink_jpmml_tpu")
    or m.startswith(("jax.", "jaxlib", "flink_jpmml_tpu."))
)
assert not bad, bad
print(len(names), " ".join(names))
"""

# the host planes of the Kafka slice, each a copy of a numpy-only module
# of the JAX package whose import there pulls in jax
KAFKA_SLICE = {
    "obs.attr", "obs.freshness", "obs.pressure", "obs.recorder",
    "obs.trace", "runtime.faults", "runtime.kafka", "runtime.prefetch",
    "utils.netio", "utils.retry",
}

# the dense families (regression, neural, clustering, GLM, the chain)
DENSE_SLICE = {
    "compile.regression", "compile.exprs", "compile.neural",
    "compile.clustering", "compile.glm", "pmml.outputs",
}

# the tree shapes and rule families (node hop in compile.trees)
TREE_SHAPES_SLICE = {
    "compile.gtrees", "compile.wtrees", "compile.scorecard",
    "compile.ruleset", "compile.anomaly",
}

# the last nine families, the oracle and ModelVerification replay
MORE_FAMILIES_SLICE = {
    "compile.bayes", "compile.svm", "compile.knn", "compile.bayesnet",
    "compile.gp", "compile.baseline", "compile.assoc", "compile.textmodel",
    "compile.timeseries", "compile.verify", "pmml.interp",
}


def test_every_port_module_imports_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    count, names = res.stdout.split(maxsplit=1)
    assert int(count) >= 58  # every module ported so far
    names = set(names.split())
    for slice_ in (KAFKA_SLICE, DENSE_SLICE, TREE_SHAPES_SLICE,
                   MORE_FAMILIES_SLICE):
        assert {f"flink_jpmml_tpu_torch.{m}" for m in slice_} <= names
    assert {f"flink_jpmml_tpu_torch.{m}" for m in DENSE_SLICE} <= names


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def gbm_doc(tmp_path):
    return parse_pmml_file(gen_gbm(str(tmp_path), n_trees=3, depth=2,
                                   n_features=4))


def test_entry_points_default_to_the_card(no_card, gbm_doc):
    with pytest.raises(DeviceUnavailableError):
        compile_pmml(gbm_doc)
    with pytest.raises(DeviceUnavailableError):
        compile_pmml(gbm_doc, device="cuda")
    with pytest.raises(DeviceUnavailableError):
        tq.build_quantized_scorer(gbm_doc)


def test_dense_families_default_to_the_card(no_card, tmp_path):
    from flink_jpmml_tpu_torch.assets_gen import gen_iris_lr, gen_kmeans
    from flink_jpmml_tpu_torch.convert import model_params_from_jax

    for gen in (gen_iris_lr, gen_kmeans):
        doc = parse_pmml_file(gen(str(tmp_path)))
        with pytest.raises(DeviceUnavailableError):
            compile_pmml(doc, batch_size=8)
        cm = compile_pmml(doc, batch_size=8, device="cpu")
        assert cm.quantized_scorer() is None
        pipe = BlockPipeline(
            FiniteBlockSource(torch.zeros(4, 4).numpy(), 4), cm,
            lambda out, n, off: None)
        assert pipe.device.type == "cpu" and pipe.backend == "f32"
    with pytest.raises(DeviceUnavailableError):
        model_params_from_jax({"centers": torch.zeros(2, 4).numpy()})


def test_tree_shapes_default_to_the_card(no_card):
    import chip_smoke as cs
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    for xml in (cs.deep_rf_xml(n_trees=2, n_fields=3, max_leaves=16),
                cs.scorecard_xml(n_chars=2, n_attrs=3),
                cs.ruleset_xml("firstHit", n_rules=4, n_fields=3),
                cs.WEIGHTED_CONF, cs.SELECT_ALL,
                cs.iforest_xml(n_trees=2, n_fields=3, sample=8)):
        doc = parse_pmml(xml)
        with pytest.raises(DeviceUnavailableError):
            compile_pmml(doc)
        assert compile_pmml(doc, device="cpu").device.type == "cpu"


def test_more_families_default_to_the_card(no_card):
    import chip_smoke as cs
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    for xml in (cs.naive_bayes_xml(n_continuous=2, n_categorical=1,
                                   n_values=2),
                cs.svm_xml(n_vectors=8, n_fields=3),
                cs.knn_xml(n_instances=20, n_fields=3),
                cs.bayesnet_xml(n_nodes=3, n_coparents=1),
                cs.gp_xml(n_rows=10, n_fields=2), cs.baseline_xml(),
                cs.assoc_xml(n_items=6, n_rules=5),
                cs.text_xml(n_terms=8, n_docs=5), cs.arima_xml(),
                cs.holt_winters_xml()):
        doc = parse_pmml(xml)
        with pytest.raises(DeviceUnavailableError):
            compile_pmml(doc)
        assert compile_pmml(doc, device="cpu").device.type == "cpu"


def test_cpu_only_on_request(no_card, gbm_doc):
    cm = compile_pmml(gbm_doc, batch_size=8, device="cpu")
    assert cm.device.type == "cpu"
    q = cm.quantized_scorer()
    assert q.device.type == "cpu" and q.backend == "cuda_plain"
    assert all(t.device.type == "cpu" for t in q.params.values())
    pipe = BlockPipeline(FiniteBlockSource(torch.zeros(4, 4).numpy(), 4),
                         cm, lambda out, n, off: None)
    assert pipe.device.type == "cpu" and pipe.backend == "rank_wire_cuda_plain"
    assert pipe.metrics.snapshot()["scorer_backend_rank_wire_cuda_plain"] == 1


def test_float32_matmul_precision_pinned(gbm_doc):
    torch.set_float32_matmul_precision("high")
    try:
        compile_pmml(gbm_doc, device="cpu")
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")


def test_rank_wire_build_failure_is_not_swallowed(gbm_doc, monkeypatch):
    # the JAX package's quantized_scorer() turns any failure into a
    # warning and the f32 path; the port must raise instead
    def boom(*a, **k):
        raise RuntimeError("kernel tables refused")

    monkeypatch.setattr(tq, "build_quantized_scorer", boom)
    cm = compile_pmml(gbm_doc, device="cpu")
    with pytest.raises(RuntimeError, match="kernel tables refused"):
        cm.quantized_scorer()
