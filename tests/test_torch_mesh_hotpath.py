"""Multichip hot-path serving in the port, on the CPU: the twin of
tests/test_mesh_hotpath.py.

The contracts under test, each against the JAX package where it has an
output to compare:

- key-stable splits (parallel/assignment.py): rendezvous-hashed chip
  ownership of kafka partitions and record keys moves ONLY the dead
  chip's work across a degraded-mesh resize;
- canary splits across shards (rollout/split.py): ``assign_candidate`` is
  a pure function of the key;
- ``ShardedModel.without_devices`` carries the dispatcher/window state and
  the partition assignment through the rebuild, and keeps the model-axis
  split;
- chip loss on the mesh hot path (runtime/block.py's ``chip_loss`` rung):
  on a 4×2 mesh the pipeline rebuilds over the survivors in place — every
  record delivered exactly once, an empty DLQ, per-chip telemetry
  flagging the dead row; on a single device and on a 1×1 mesh it
  escalates with the raise;
- the keyed state table's ``shard`` / ``migrate`` keep every key's vector,
  and a table held in row blocks steps to the one-tensor step's bytes.

The port's meshes are logical ``torch.device("cpu", i)`` devices; the JAX
side runs on the 8-device virtual CPU mesh.
"""

import time

import numpy as np
import pytest
import torch

from flink_jpmml_tpu.parallel.assignment import ChipAssignment as JChips
from flink_jpmml_tpu.parallel.assignment import assignment_for as jfor
from flink_jpmml_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_jpmml_tpu.rollout import split as jsplit
from flink_jpmml_tpu.utils.config import MeshConfig as JMeshConfig
from flink_jpmml_tpu_torch.parallel.assignment import (
    ChipAssignment,
    assignment_for,
    mesh_in_flight,
)
from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices, make_mesh
from flink_jpmml_tpu_torch.parallel.partitioner import HashPartitioner
from flink_jpmml_tpu_torch.rollout import split as rsplit
from flink_jpmml_tpu_torch.runtime import faults
from flink_jpmml_tpu_torch.utils.config import MeshConfig
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

B = 32
F = 5


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def gbm_path(tmp_path_factory):
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm

    tmp = tmp_path_factory.mktemp("torch-mesh-hotpath-gbm")
    return gen_gbm(str(tmp), n_trees=4, depth=3, n_features=F)


@pytest.fixture(scope="module")
def gbm(gbm_path):
    from flink_jpmml_tpu_torch.compile import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    return compile_pmml(parse_pmml_file(gbm_path), batch_size=B,
                        device="cpu")


def _data(n, seed=0, cols=F):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1.0, size=(n, cols)).astype(np.float32)


def _mesh(data, model):
    return make_mesh(MeshConfig(data=data, model=model),
                     devices=cpu_devices(data * model))


KEYS = [f"user-{i}" for i in range(2000)]


# ---------------------------------------------------------------------------
# key-stable splits across a degraded-mesh resize
# ---------------------------------------------------------------------------


class TestKeyStability:
    def test_owners_equal_the_jax_assignment(self):
        a = ChipAssignment((0, 1, 2, 3), partitions=range(16))
        j = JChips((0, 1, 2, 3), partitions=range(16))
        assert [a.chip_for_key(k) for k in KEYS] == [
            j.chip_for_key(k) for k in KEYS]
        assert [a.chip_for_partition(p) for p in range(16)] == [
            j.chip_for_partition(p) for p in range(16)]
        assert a.state() == j.state()

    def test_healthy_chips_keep_their_keys(self):
        a = ChipAssignment((0, 1, 2, 3))
        before = {k: a.chip_for_key(k) for k in KEYS}
        shrunk = a.without([2])
        for k, chip in before.items():
            if chip == 2:
                assert shrunk.chip_for_key(k) in (0, 1, 3)
            else:
                assert shrunk.chip_for_key(k) == chip

    def test_healthy_chips_keep_their_partitions(self):
        a = ChipAssignment((0, 1, 2, 3), partitions=range(16))
        shrunk = a.without([1])
        for p in range(16):
            owner = a.chip_for_partition(p)
            if owner != 1:
                assert shrunk.chip_for_partition(p) == owner
        orphans = a.partitions_for(1)
        assert orphans
        for p in orphans:
            assert shrunk.chip_for_partition(p) in (0, 2, 3)

    def test_producer_lane_to_chip_end_to_end(self):
        n_parts = 16
        hp = HashPartitioner(n_parts)
        a = ChipAssignment((0, 1, 2, 3), partitions=range(n_parts))
        shrunk = a.without([3])
        for k in KEYS:
            part = hp.lane(k)
            before = a.chip_for_partition(part)
            if before != 3:
                assert shrunk.chip_for_partition(part) == before

    def test_split_groups_by_owner(self):
        a = ChipAssignment((0, 1, 2, 3))
        groups = a.split(KEYS)
        assert sorted(sum(groups.values(), [])) == sorted(KEYS)
        for chip, members in groups.items():
            for k in members:
                assert a.chip_for_key(k) == chip

    @pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
    def test_mesh_row_ids_survive_resize(self, shape):
        """for_mesh labels lanes by each data row's FIRST device index,
        as the JAX assignment labels them by device id."""
        mesh = _mesh(*shape)
        a = assignment_for(mesh, partitions=range(8))
        j = jfor(jmake_mesh(JMeshConfig(*shape)), partitions=range(8))
        assert a.chips == j.chips
        assert a.state() == j.state()
        lost_row = list(mesh.devices.reshape(shape[0], -1)[-1])
        shrunk = a.without(lost_row)
        assert shrunk.chips == tuple(
            c for c in a.chips if c not in {d.index for d in lost_row})

    def test_in_flight_geometry(self):
        mesh = _mesh(4, 2)
        assert mesh_in_flight(None, 2) == 2
        assert mesh_in_flight(mesh, 2) == 4
        assert mesh_in_flight(mesh, 6) == 6
        assert mesh_in_flight(_mesh(1, 1), 2) == 2


# ---------------------------------------------------------------------------
# canary fractions per shard
# ---------------------------------------------------------------------------


class TestCanaryAcrossShards:
    def test_assignment_equals_the_jax_split(self):
        for frac in (0.05, 0.2, 0.5):
            assert [rsplit.assign_candidate("m", 2, frac, k)
                    for k in KEYS[:500]] == [
                jsplit.assign_candidate("m", 2, frac, k)
                for k in KEYS[:500]]

    def test_fraction_preserved_per_shard(self):
        fraction = 0.2
        a = ChipAssignment((0, 1, 2, 3))
        flags = {
            k: rsplit.assign_candidate("m", 2, fraction, k) for k in KEYS
        }
        global_frac = sum(flags.values()) / len(KEYS)
        assert abs(global_frac - fraction) < 0.05
        for chip, members in a.split(KEYS).items():
            assert len(members) > 100
            frac = sum(flags[k] for k in members) / len(members)
            assert abs(frac - global_frac) < 0.07

    def test_resize_never_flips_a_canary_side(self):
        fraction = 0.3
        a = ChipAssignment((0, 1, 2, 3))
        shrunk = a.without([0])
        canary = {
            k for k in KEYS if rsplit.assign_candidate("m", 2, fraction, k)
        }
        before = {chip: {k for k in ks if k in canary}
                  for chip, ks in a.split(KEYS).items()}
        after = {chip: {k for k in ks if k in canary}
                 for chip, ks in shrunk.split(KEYS).items()}
        for chip in (1, 2, 3):
            assert before[chip] <= after[chip]
            assert after[chip] - before[chip] <= before[0]


# ---------------------------------------------------------------------------
# without_devices carries serving state
# ---------------------------------------------------------------------------


class TestRebuildCarry:
    def test_dispatch_state_and_assignment_carry(self, gbm):
        from flink_jpmml_tpu_torch.parallel.sharding import mesh_sharded

        mesh = _mesh(4, 2)
        sm = mesh_sharded(gbm, mesh)
        sm.with_dispatch_state(in_flight=4)
        sm.assignment = assignment_for(mesh, partitions=range(8))
        lost = list(mesh.devices.reshape(4, -1)[-1])
        rebuilt = sm.without_devices(lost)
        assert rebuilt.dispatch_state == sm.dispatch_state
        assert rebuilt.dispatch_state is not sm.dispatch_state
        assert rebuilt.assignment.chips == sm.assignment.without(
            lost).chips
        assert rebuilt.assignment.partitions == sm.assignment.partitions
        assert rebuilt.in_flight_depth(2) == 4
        assert rebuilt.batch_divisor == 3
        assert rebuilt.mesh.shape == {"data": 3, "model": 2}

    def test_degraded_mesh_keeps_the_model_axis_and_its_split(self, tmp_path):
        from flink_jpmml_tpu.parallel.sharding import (
            degraded_mesh as jdegraded,
        )
        from flink_jpmml_tpu_torch.assets_gen import gen_stacked
        from flink_jpmml_tpu_torch.compile import compile_pmml
        from flink_jpmml_tpu_torch.parallel.sharding import degraded_mesh
        from flink_jpmml_tpu_torch.pmml import parse_pmml_file
        from flink_jpmml_tpu_torch.utils.config import CompileConfig
        from flink_jpmml_tpu_torch.utils.exceptions import FlinkJpmmlTpuError

        mesh = _mesh(4, 2)
        jm = jmake_mesh(JMeshConfig(4, 2))
        for lost in ([1], [0, 7], [2, 3, 4]):
            got = degraded_mesh(mesh, lost)
            want = jdegraded(jm, lost)
            assert [d.index for d in got.devices.flat] == [
                d.id for d in want.devices.flat]
            assert got.shape == dict(want.shape)
        with pytest.raises(FlinkJpmmlTpuError, match="unsurvivable"):
            degraded_mesh(mesh, list(range(7)))
        path = gen_stacked(str(tmp_path), n_trees=3, depth=3, n_features=64,
                           wide_lr=True)
        cm = compile_pmml(parse_pmml_file(path), batch_size=B, device="cpu",
                          mesh=mesh,
                          config=CompileConfig(tp_wide_threshold=64))
        assert cm.tp_sharded_leaves
        rebuilt = cm.without_devices([1])
        assert rebuilt.tp_sharded_leaves == cm.tp_sharded_leaves
        X = _data(B * 3, cols=64)
        M = np.zeros_like(X, bool)
        np.testing.assert_allclose(rebuilt.predict(X, M).value.numpy(),
                                   cm.base.predict(X, M).value.numpy(),
                                   rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# chip loss on the mesh hot path
# ---------------------------------------------------------------------------


def _pipe(gbm, data, emitted, metrics, tmp_path, mesh=None):
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    return BlockPipeline(
        FiniteBlockSource(data, B), gbm,
        lambda o, n, f: emitted.append((f, n, o)),
        RuntimeConfig(batch=BatchConfig(size=B, deadline_us=500),
                      checkpoint_interval_s=0.05),
        metrics=metrics,
        # the checkpoint wires the DLQ beside it, which arms the failover
        # plane — the production shape of the ladder
        checkpoint=CheckpointManager(str(tmp_path / "ck")),
        max_dispatch_chunks=1,
        mesh=mesh,
    )


class TestMeshChipLoss:
    def test_pipeline_survives_chip_loss(self, gbm, tmp_path, monkeypatch):
        from flink_jpmml_tpu_torch.obs import mesh as mesh_obs
        from flink_jpmml_tpu_torch.runtime.dlq import DeadLetterQueue

        monkeypatch.setenv("FJT_RETRY_BASE_S", "0.005")
        N = 640
        X = _data(N)
        emitted = []
        m = MetricsRegistry()
        faults.inject("chip_loss", n=1)
        pipe = _pipe(gbm, X, emitted, m, tmp_path, mesh=_mesh(4, 2))
        assert pipe.backend == "f32"
        pipe.run_until_exhausted(timeout=120)
        cov = np.zeros(N, np.int64)
        for off, n, _ in emitted:
            cov[off: off + n] += 1
        assert (cov == 1).all()
        assert list(
            DeadLetterQueue(str(tmp_path / "ck" / "dlq")).offsets()) == []
        # every delivered score equals the unsharded port's
        ref = gbm.predict(X, np.zeros_like(X, bool)).value.numpy()
        for off, n, out in emitted:
            np.testing.assert_allclose(out.value.numpy()[:n],
                                       ref[off: off + n], rtol=1e-4,
                                       atol=1e-5)
        snap = m.struct_snapshot()
        c, g = snap["counters"], snap["gauges"]
        assert c.get("mesh_rebuilds", 0) == 1
        assert g["mesh_data_width"]["value"] == 3.0
        assert g["mesh_lost_devices"]["value"] == 2.0  # one 4x2 row
        s = mesh_obs.summary(snap)
        assert s is not None and s["data_width"] == 3.0
        lost = [chip for chip, v in s["chips"].items()
                if v["state"] == "lost"]
        assert lost == ["6"]  # the last row, first device cpu:6
        assert pipe._bound.model.batch_divisor == 3

    def test_single_chip_still_escalates(self, gbm, tmp_path, monkeypatch):
        """Off the mesh: a single-device model's chip loss raises."""
        monkeypatch.setenv("FJT_RETRY_BASE_S", "0.005")
        faults.inject("chip_loss", n=1)
        pipe = _pipe(gbm, _data(320), [], MetricsRegistry(), tmp_path)
        with pytest.raises(faults.InjectedChipLoss):
            pipe.run_until_exhausted(timeout=60)

    def test_one_by_one_mesh_escalates_without_duplicates(
            self, gbm, tmp_path, monkeypatch):
        """One data row left: nothing to shrink onto, so the 1×1 mesh
        keeps the single-chip contract — the raise, no rebuild, and no
        record delivered twice."""
        monkeypatch.setenv("FJT_RETRY_BASE_S", "0.005")
        emitted = []
        m = MetricsRegistry()
        faults.inject("chip_loss", n=1)
        pipe = _pipe(gbm, _data(320), emitted, m, tmp_path,
                     mesh=_mesh(1, 1))
        with pytest.raises(faults.InjectedChipLoss):
            pipe.run_until_exhausted(timeout=60)
        assert m.struct_snapshot()["counters"].get("mesh_rebuilds", 0) == 0
        offs = [off + i for off, n, _ in emitted for i in range(n)]
        assert len(offs) == len(set(offs))


# ---------------------------------------------------------------------------
# keyed state over the mesh
# ---------------------------------------------------------------------------


def _stream(table, n_batches, seed, step):
    """Drive ``n_batches`` of 64 keyed records through ``table``'s routing
    and the state step (``step``: the port's ``statekernel.step_after``)."""
    rng = np.random.default_rng(seed)
    for b in range(n_batches):
        keys = rng.integers(0, 200, size=64)
        offs = np.arange(b * 64, (b + 1) * 64)
        slots, reset, rel, w = table.assign_slots(table.hash_keys(keys),
                                                  offs)
        score = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        _, derived, S2 = step(score, table, slots, rel, w, reset)
        table.commit(S2)
        yield derived


class TestStateOverTheMesh:
    def test_shard_and_migrate_keep_every_key(self):
        from flink_jpmml_tpu.runtime import state as jstate
        from flink_jpmml_tpu_torch.compile import statekernel
        from flink_jpmml_tpu_torch.parallel.sharding import degraded_mesh
        from flink_jpmml_tpu_torch.runtime.state import (
            KeyedStateTable,
            StateSpec,
        )

        t = KeyedStateTable(StateSpec(capacity=256), device="cpu")
        list(_stream(t, 8, 1, statekernel.step_after))
        before = t.host_values().copy()
        mesh = _mesh(4, 2)
        t.shard(mesh)
        np.testing.assert_array_equal(t.host_values(), before)
        # two rows lost: 512 value rows still split evenly, as the JAX
        # placement needs
        t.migrate(degraded_mesh(mesh, [4, 5, 6, 7]))
        np.testing.assert_array_equal(t.host_values(), before)
        # the JAX table: the same re-placement keeps the same rows
        j = jstate.KeyedStateTable(jstate.StateSpec(capacity=256))
        j.values = before.copy()
        jm = jmake_mesh(JMeshConfig(4, 2))
        j.shard(jm)
        from flink_jpmml_tpu.parallel.sharding import (
            degraded_mesh as jdegraded,
        )

        j.migrate(jdegraded(jm, [4, 5, 6, 7]))
        np.testing.assert_array_equal(np.asarray(j.values), before)

    def test_row_blocks_step_to_the_one_tensor_bytes(self, monkeypatch):
        """Across several physical devices the rows live in data-axis
        blocks and each block steps on its own device; made to take that
        path on the CPU (every logical device counted as its own), the
        table, the derived features and a migrate over the survivors give
        the one-tensor table's bytes."""
        from flink_jpmml_tpu_torch.compile import statekernel
        from flink_jpmml_tpu_torch.parallel import mesh as mesh_mod
        from flink_jpmml_tpu_torch.parallel.sharding import degraded_mesh
        from flink_jpmml_tpu_torch.runtime.state import (
            KeyedStateTable,
            RowBlocks,
            StateSpec,
        )

        spec = StateSpec(capacity=700, stride=16, decay=0.9)
        one = KeyedStateTable(spec, device="cpu")
        blk = KeyedStateTable(spec, device="cpu")
        monkeypatch.setattr(mesh_mod, "physical", lambda d: d)
        mesh = _mesh(3, 1)
        blk.shard(mesh)
        assert isinstance(blk.values, RowBlocks)
        assert len(blk.values.blocks) == 3
        for d1, d2 in zip(_stream(one, 6, 2, statekernel.step_after),
                          _stream(blk, 6, 2, statekernel.step_after)):
            assert torch.equal(d1, d2)
        np.testing.assert_array_equal(blk.host_values(), one.host_values())
        blk.migrate(degraded_mesh(mesh, [2]))
        assert len(blk.values.blocks) == 2
        np.testing.assert_array_equal(blk.host_values(), one.host_values())
        for d1, d2 in zip(_stream(one, 4, 3, statekernel.step_after),
                          _stream(blk, 4, 3, statekernel.step_after)):
            assert torch.equal(d1, d2)
        np.testing.assert_array_equal(blk.host_values(), one.host_values())
        # renormalization and rollback go block by block too
        one.maybe_renorm(10_000)
        blk.maybe_renorm(10_000)
        np.testing.assert_array_equal(blk.host_values(), one.host_values())
        blk.rollback()
        assert isinstance(blk.values, RowBlocks)


# ---------------------------------------------------------------------------
# the mesh ingest split: one Kafka source a chip, one sidecar each
# ---------------------------------------------------------------------------


def test_chip_block_sources_drain_their_own_partitions():
    from flink_jpmml_tpu_torch.runtime import kafka, prefetch

    n_parts = 8
    broker = kafka.MiniKafkaBroker(topic="mesh", n_partitions=n_parts)
    sources = {}
    try:
        for p in range(n_parts):
            broker.append_rows(np.full((4, F), float(p), np.float32),
                               partition=p)
        assignment = ChipAssignment.for_mesh(_mesh(4, 2),
                                             partitions=range(n_parts))
        sources = kafka.chip_block_sources(
            assignment, broker.host, broker.port, "mesh", n_cols=F)
        assert set(sources) <= set(assignment.chips)
        assert sorted(p for c in sources
                      for p in assignment.partitions_for(c)) == list(
            range(n_parts))
        for chip, src in sources.items():
            parts = assignment.partitions_for(chip)
            seen = set()
            deadline = time.monotonic() + 10.0
            while len(seen) < len(parts) and time.monotonic() < deadline:
                got = src.poll()
                if got is not None:
                    seen |= set(np.unique(got[1][:, 0]).astype(int))
            assert seen == set(parts)  # its partitions, no other
        wrapped = prefetch.maybe_wrap_chips(sources, enable=True)
        assert set(wrapped) == set(sources)
        for chip, w in wrapped.items():
            assert w._THREAD_NAME == f"fjt-prefetch-blk-c{chip}"
    finally:
        for src in sources.values():
            src.close()
        broker.close()
