"""Dynamic serving × mesh in the port, on the CPU: the twin of
tests/test_serving_mesh.py.

The registry / block serving plane produces and swaps mesh-sharded models
when a mesh is configured — warm = parse + mesh-aware compile in the
background, swap between batches exactly like single-device serving. The
port's meshes are logical ``cpu:i`` devices; the served heads are held to
the JAX sharded model on the 8-device virtual CPU mesh.
"""

import pathlib
import threading
import time

import numpy as np
import pytest

from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse_file
from flink_jpmml_tpu.utils.config import CompileConfig as JCompileConfig
from flink_jpmml_tpu.utils.config import MeshConfig as JMeshConfig
from flink_jpmml_tpu_torch.assets_gen import gen_stacked
from flink_jpmml_tpu_torch.models.control import AddMessage
from flink_jpmml_tpu_torch.models.core import ModelId
from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices, make_mesh
from flink_jpmml_tpu_torch.parallel.sharding import ShardedModel
from flink_jpmml_tpu_torch.runtime import faults
from flink_jpmml_tpu_torch.runtime.block import CyclingBlockSource
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
from flink_jpmml_tpu_torch.runtime.sources import ControlSource
from flink_jpmml_tpu_torch.serving.block import DynamicBlockPipeline
from flink_jpmml_tpu_torch.serving.registry import ModelRegistry
from flink_jpmml_tpu_torch.utils.config import (
    BatchConfig,
    CompileConfig,
    MeshConfig,
    RuntimeConfig,
)
from flink_jpmml_tpu_torch.utils.exceptions import InputValidationException

F = 256  # wide enough to TP-shard under a lowered threshold
B = 32
CFG = CompileConfig(tp_wide_threshold=64)


def tmesh(data=4, model=2):
    return make_mesh(MeshConfig(data=data, model=model),
                     devices=cpu_devices(8))


def _stacked(tmp_path, sub, n_trees):
    d = pathlib.Path(tmp_path, sub)
    d.mkdir(parents=True, exist_ok=True)
    return gen_stacked(
        str(d), n_trees=n_trees, depth=3, n_features=F, wide_lr=True
    )


class _Sink:
    def __init__(self):
        self.rows = []
        self._lock = threading.Lock()

    def __call__(self, out, n, first_off, decode):
        with self._lock:
            self.rows.append((first_off, n, decode.model_key, out))

    def total(self):
        with self._lock:
            return sum(r[1] for r in self.rows)


def _wait(cond, timeout=60.0, msg="condition never held"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(msg)


class TestRegistryMesh:
    def test_warm_produces_sharded_model(self, tmp_path):
        reg = ModelRegistry(batch_size=B, compile_config=CFG, mesh=tmesh(),
                            async_warmup=False)
        path = _stacked(tmp_path, "v1", 3)
        reg.apply(AddMessage("m", 1, path, timestamp=1.0))
        model = reg.model(ModelId("m", 1))
        assert isinstance(model, ShardedModel)
        assert model.tp_sharded_leaves  # the wide LR stage is TP-sharded
        jsm = jcompile(jparse_file(path), batch_size=B,
                       mesh=jmake_mesh(JMeshConfig(4, 2)),
                       config=JCompileConfig(tp_wide_threshold=64))
        assert model.tp_sharded_leaves == jsm.tp_sharded_leaves

    def test_restore_warms_sharded(self, tmp_path):
        path = _stacked(tmp_path, "v1", 3)
        reg = ModelRegistry(batch_size=B, compile_config=CFG, mesh=tmesh())
        reg.apply(AddMessage("m", 1, path, timestamp=1.0))
        reg2 = ModelRegistry(batch_size=B, compile_config=CFG, mesh=tmesh())
        reg2.restore(reg.state())
        _wait(lambda: reg2.model_if_warm(ModelId("m", 1)) is not None,
              msg="restored registry never warmed")
        assert isinstance(reg2.model_if_warm(ModelId("m", 1)), ShardedModel)

    def test_adopt_rebuilt_replaces_the_served_instance(self, tmp_path):
        reg = ModelRegistry(batch_size=B, compile_config=CFG, mesh=tmesh(),
                            async_warmup=False)
        reg.apply(AddMessage("m", 1, _stacked(tmp_path, "v1", 3), 1.0))
        model = reg.model(ModelId("m", 1))
        rebuilt = model.without_devices([7])
        reg.adopt_rebuilt("m_1", rebuilt)
        assert reg.model(ModelId("m", 1)) is rebuilt
        reg.adopt_rebuilt("not a key", rebuilt)  # ignored


def _pipe(data, ctrl, sink, mesh, ckdir=None, **kw):
    return DynamicBlockPipeline(
        CyclingBlockSource(data, block_size=64),
        ctrl, sink, name="m", arity=F, batch_size=B,
        config=RuntimeConfig(batch=BatchConfig(size=B, deadline_us=2000),
                             checkpoint_interval_s=0.05),
        compile_config=CFG, mesh=mesh,
        checkpoint=CheckpointManager(ckdir) if ckdir else None, **kw)


class TestDynamicBlockMesh:
    def test_swap_drill_on_mesh(self, tmp_path):
        """Add v1 → serve sharded → Add v2 → background mesh-compile →
        swap between batches; offsets contiguous; both versions score
        through ShardedModel, their heads held to the JAX sharded
        model's."""
        v1 = _stacked(tmp_path, "v1", 3)
        v2 = _stacked(tmp_path, "v2", 8)
        rng = np.random.default_rng(0)
        data = rng.normal(0, 1.0, size=(1024, F)).astype(np.float32)
        ctrl = ControlSource()
        sink = _Sink()
        pipe = _pipe(data, ctrl, sink, tmesh())
        ctrl.push(AddMessage("m", 1, v1, timestamp=1.0))
        pipe.start()
        try:
            _wait(lambda: sink.total() > 0, msg="v1 never served")
            assert pipe.serving_key == "m_1"
            cur = pipe._current.model
            assert isinstance(cur, ShardedModel) and cur.tp_sharded_leaves
            assert pipe.backend == "f32"  # rank wire is single-device
            assert cur.dispatch_state == {"in_flight": 4}
            assert cur.assignment.chips == (0, 2, 4, 6)
            ctrl.push(AddMessage("m", 2, v2, timestamp=2.0))
            _wait(lambda: pipe.serving_key == "m_2",
                  msg="v2 never swapped in")
            assert isinstance(pipe._current.model, ShardedModel)
            _wait(lambda: sink.total() > 256)
        finally:
            pipe.stop()
            pipe.join(timeout=30.0)
        expect = 0
        for first, n, _, _ in sink.rows:
            assert first == expect
            expect = first + n
        assert {k for _, _, k, _ in sink.rows} >= {"m_1", "m_2"}
        jm = jmake_mesh(JMeshConfig(4, 2))
        jcfg = JCompileConfig(tp_wide_threshold=64)
        jsm = {k: jcompile(jparse_file(p), batch_size=B, mesh=jm,
                           config=jcfg) for k, p in (("m_1", v1),
                                                     ("m_2", v2))}
        for first, n, key, out in sink.rows[:8] + sink.rows[-4:]:
            rows = np.arange(first, first + n) % len(data)
            X = data[rows]
            want = np.asarray(jsm[key].predict(
                np.pad(X, ((0, (-n) % B), (0, 0))),
                np.zeros((n + (-n) % B, F), bool)).value)[:n]
            np.testing.assert_allclose(out.value.numpy()[:n], want,
                                       rtol=1e-4, atol=1e-5)

    def test_checkpoint_restore_under_mesh(self, tmp_path):
        """Kill/restart with a mesh configured: the restored pipeline
        re-warms its served models as ShardedModels and resumes at the
        committed offset."""
        v1 = _stacked(tmp_path, "v1", 3)
        rng = np.random.default_rng(1)
        data = rng.normal(0, 1.0, size=(2048, F)).astype(np.float32)
        ckdir = str(tmp_path / "ck")
        ctrl = ControlSource()
        pipe = _pipe(data, ctrl, _Sink(), tmesh(), ckdir)
        ctrl.push(AddMessage("m", 1, v1, timestamp=1.0))
        pipe.start()
        _wait(lambda: pipe.committed_offset > 64)
        pipe.stop()
        pipe.join(timeout=30.0)
        committed = pipe.committed_offset
        assert committed > 0

        sink2 = _Sink()
        pipe2 = _pipe(data, ControlSource(), sink2, tmesh(), ckdir)
        assert pipe2.restore()
        assert pipe2.committed_offset == committed
        pipe2.start()
        try:
            _wait(lambda: sink2.total() > 0, msg="restored never served")
            assert isinstance(pipe2._current.model, ShardedModel)
            assert sink2.rows[0][0] == committed  # resumes exactly
        finally:
            pipe2.stop()
            pipe2.join(timeout=30.0)

    def test_indivisible_batch_rejected(self):
        with pytest.raises(InputValidationException, match="divide"):
            DynamicBlockPipeline(
                CyclingBlockSource(np.zeros((64, F), np.float32),
                                   block_size=64),
                ControlSource(), lambda *a: None, name="m", arity=F,
                batch_size=30, mesh=tmesh(),
            )

    def test_chip_loss_rebuild_is_adopted_by_the_registry(
            self, tmp_path, monkeypatch):
        """The ladder's rebuild on the dynamic path: the registry's served
        instance follows it (``_adopt_rebuilt``), so the next latest-wins
        pass keeps the degraded mesh; offsets stay contiguous and no
        record is delivered twice."""
        monkeypatch.setenv("FJT_RETRY_BASE_S", "0.005")
        faults.clear()
        v1 = _stacked(tmp_path, "v1", 3)
        rng = np.random.default_rng(2)
        data = rng.normal(0, 1.0, size=(1024, F)).astype(np.float32)
        ctrl = ControlSource()
        sink = _Sink()
        pipe = _pipe(data, ctrl, sink, tmesh(), str(tmp_path / "ck"))
        ctrl.push(AddMessage("m", 1, v1, timestamp=1.0))
        pipe.start()
        try:
            _wait(lambda: sink.total() > 0, msg="v1 never served")
            faults.inject("chip_loss", n=1)
            _wait(lambda: pipe.metrics.struct_snapshot()["counters"].get(
                "mesh_rebuilds", 0) == 1, msg="no rebuild")
            _wait(lambda: sink.total() > 512)
            served = pipe.registry.model(ModelId("m", 1))
            assert served is pipe._current.model
            assert served.batch_divisor == 3
        finally:
            faults.clear()
            pipe.stop()
            pipe.join(timeout=30.0)
        expect = 0
        for first, n, _, _ in sink.rows:
            assert first == expect
            expect = first + n
