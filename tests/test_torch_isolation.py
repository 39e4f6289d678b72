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

# the record API and dynamic serving
API_SLICE = {
    "api", "api.reader", "api.stream", "serving", "serving.managers",
    "serving.registry", "serving.scorer", "models.core", "models.control",
    "rollout.state", "runtime.engine", "runtime.sources", "runtime.sinks",
    "runtime.queues", "utils.profiling",
}


# recovery on both hot paths
RECOVERY_SLICE = {
    "utils.diskio", "utils.retry", "runtime.checkpoint", "runtime.dlq",
    "runtime.devfault", "runtime.faults", "serving.failover",
    "serving.block",
}

# the serving edge: overload control, SLO burn rate, span files, journeys,
# the framed-TCP feed and remote model paths
EDGE_SLICE = {
    "obs.slo", "serving.overload", "obs.spans", "obs.trace", "runtime.net",
    "api.remote", "utils.cache",
}
# the kernel search: layouts, the cost model, autotune and the profiler
TUNING_SLICE = {
    "compile.layouts", "compile.costmodel", "compile.autotune",
    "obs.profiler",
}
# multi-tenant and stateful scoring: the keyed state table and its step,
# cross-model packs, the zoo manager and the partitioner they route by
ZOO_STATE_SLICE = {
    "parallel.partitioner", "runtime.state", "compile.statekernel",
    "compile.packs", "serving.zoo",
}
# the parallel plane: the mesh, sharded models, chip assignment, the
# process group, worker health, per-chip telemetry and the canary split
PARALLEL_SLICE = {
    "parallel.mesh", "parallel.sharding", "parallel.assignment",
    "parallel.distributed", "parallel.health", "obs.mesh", "rollout.split",
}
# the data-drift plane and the guardrail controller of staged rollouts
DRIFT_ROLLOUT_SLICE = {"obs.drift", "rollout.controller"}


def test_every_port_module_imports_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    count, names = res.stdout.split(maxsplit=1)
    assert int(count) >= 105  # every module ported so far
    names = set(names.split())
    for slice_ in (KAFKA_SLICE, DENSE_SLICE, TREE_SHAPES_SLICE,
                   MORE_FAMILIES_SLICE, API_SLICE, RECOVERY_SLICE,
                   EDGE_SLICE, TUNING_SLICE, ZOO_STATE_SLICE,
                   PARALLEL_SLICE, DRIFT_ROLLOUT_SLICE):
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


def test_mesh_defaults_to_the_card(no_card, gbm_doc):
    from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices, make_mesh

    # no card and no devices: a mesh raises, it never spans the CPU
    with pytest.raises(DeviceUnavailableError):
        make_mesh()
    with pytest.raises(DeviceUnavailableError):
        make_mesh(devices=["cuda:0"])
    # a mesh over the card compiles there, or raises without one
    import numpy as np

    from flink_jpmml_tpu_torch.parallel.mesh import Mesh

    card = np.empty((1, 1), dtype=object)
    card[0, 0] = torch.device("cuda", 0)
    with pytest.raises(DeviceUnavailableError):
        compile_pmml(gbm_doc, batch_size=8, mesh=Mesh(card))
    # a CPU mesh only from an explicit list of cpu:i devices
    mesh = make_mesh(devices=cpu_devices(2))
    sm = compile_pmml(gbm_doc, batch_size=8, mesh=mesh)
    assert sm.device.type == "cpu" and sm.quantized_scorer() is None
    pipe = BlockPipeline(FiniteBlockSource(torch.zeros(4, 4).numpy(), 4),
                         compile_pmml(gbm_doc, batch_size=8, device="cpu"),
                         lambda out, n, off: None, mesh=mesh)
    assert pipe.device.type == "cpu" and pipe.backend == "f32"


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


def test_record_api_defaults_to_the_card(no_card, tmp_path):
    from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving import DynamicScorer, ModelRegistry

    path = gen_gbm(str(tmp_path), n_trees=3, depth=2, n_features=4)
    with pytest.raises(DeviceUnavailableError):
        StreamEnvironment().from_collection([[0.0] * 4]).evaluate(
            ModelReader(path))
    with pytest.raises(DeviceUnavailableError):
        ModelReader(path).load()
    with pytest.raises(DeviceUnavailableError):
        ModelRegistry().apply(AddMessage("m", 1, path, 1.0))
    with pytest.raises(DeviceUnavailableError):
        DynamicScorer(ControlSource(), batch_size=8)
    # the CPU only on request, for every entry point
    env = StreamEnvironment(device="cpu")
    sink = env.from_collection([[0.0] * 4]).evaluate(
        ModelReader(path)).collect()
    env.execute(timeout=30.0)
    assert len(sink.items) == 1 and not sink.items[0].is_empty
    assert ModelReader(path).load(device="cpu").device.type == "cpu"
    reg = ModelRegistry(device="cpu")
    reg.apply(AddMessage("m", 1, path, 1.0))
    from flink_jpmml_tpu_torch.models.core import ModelId

    assert reg.model(ModelId("m", 1)).device.type == "cpu"
    scorer = DynamicScorer(ControlSource(), batch_size=8, device="cpu")
    assert scorer.device.type == "cpu"
