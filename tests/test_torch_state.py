"""The keyed state plane of the port (runtime/state.py, compile/
statekernel.py, parallel/partitioner.py) held to the JAX package's on the
CPU: slot routing, the fused state step, snapshots, the state-armed
record and block paths with checkpoint and restore, and the
never-delivered contract.

Tolerances: the state step is byte-equal to the JAX step on the same
scores, repeated keys included (statekernel.py's header: the port folds a
slot's records into its row in record order, as the JAX scatter does), and
its table bytes do not depend on how a stream is cut into batches. Where
the two packages' scores differ (the kernel's tree order against the XLA
qfn), the score-derived columns are held at the rank wire's rtol 1e-4 /
atol 1e-5."""

import numpy as np
import pytest
import torch

from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.compile import statekernel as jsk
from flink_jpmml_tpu.parallel import partitioner as jpart
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse
from flink_jpmml_tpu.runtime import state as jstate
from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JRegistry
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.compile import statekernel as tsk
from flink_jpmml_tpu_torch.parallel import partitioner as tpart
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime import state as tstate
from flink_jpmml_tpu_torch.runtime.state import (
    COL_COUNT,
    COL_DCOUNT,
    COL_DSUM,
    COL_LAST_T,
    COL_MAX,
    COL_MIN,
    COL_SQSUM,
    COL_SUM,
    KeyedStateTable,
    StateSpec,
)
from flink_jpmml_tpu_torch.utils.exceptions import NotPortedError
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

SUMMED = [COL_SUM, COL_SQSUM, COL_DCOUNT, COL_DSUM]
EXACT = [COL_COUNT, COL_LAST_T, COL_MIN, COL_MAX]
B = 32


def _twins(capacity=64, probe=4, **kw):
    """(port table on the CPU, JAX table) with one spec."""
    tm, jm = MetricsRegistry(), JRegistry()
    t = KeyedStateTable(StateSpec(capacity=capacity, probe=probe, **kw),
                        metrics=tm, device="cpu")
    j = jstate.KeyedStateTable(
        jstate.StateSpec(capacity=capacity, probe=probe, **kw), metrics=jm)
    return t, j, tm, jm


def _counters(reg):
    c = reg.struct_snapshot()["counters"]
    return {k: v for k, v in c.items() if k.startswith("state_")}


# -- the partitioner copy ------------------------------------------------------


def test_stable_hashes_equal_the_jax_partitioner():
    keys = np.array([-(2**63), -(2**40), -129, -128, -1, 0, 1, 127, 128,
                     2**31, 2**40, 2**63 - 1], np.int64)
    assert np.array_equal(tpart.stable_hash_vec(keys),
                          jpart.stable_hash_vec(keys))
    for k in (7, "user-3", b"x", 1.5, ("a", 2), True):
        assert tpart.stable_hash(k) == jpart.stable_hash(k)
    lanes = ["c0", "c1", "c2"]
    assert [tpart.rendezvous_pick(k, lanes) for k in range(50)] == \
        [jpart.rendezvous_pick(k, lanes) for k in range(50)]
    assert tpart.HashPartitioner(5).partition(list(range(40))) == \
        jpart.HashPartitioner(5).partition(list(range(40)))


def test_parallel_package_pulls_in_no_mesh_code():
    # the parallel slice lifted this cut: the package now re-exports what
    # the JAX package's does, the partitioner's hash unchanged among them
    import flink_jpmml_tpu_torch.parallel as par
    from flink_jpmml_tpu_torch.parallel import mesh as tmesh

    assert par.stable_hash is tpart.stable_hash
    assert par.make_mesh is tmesh.make_mesh


# -- slot routing ---------------------------------------------------------------


def _key_stream(seed, n_batches, n_keys, zipf=None):
    rng = np.random.default_rng(seed)
    if zipf:
        ks = rng.zipf(zipf, size=n_batches * B) % n_keys
    else:
        ks = rng.integers(0, n_keys, size=n_batches * B)
    return ks.astype(np.int64).reshape(n_batches, B)


@pytest.mark.parametrize("capacity,probe,n_keys,zipf", [
    (64, 4, 40, None),      # hits and inserts, a few probe collisions
    (64, 2, 300, None),     # window full: LRU eviction and overflow
    (256, 8, 300, 1.3),     # skewed keys, repeats within a batch
    (16, 1, 200, None),     # a one-slot window: overflow to scratch
])
def test_assign_slots_equal_the_jax_table(capacity, probe, n_keys, zipf):
    t, j, tm, jm = _twins(capacity, probe, stride=16)
    stream = _key_stream(capacity + n_keys, 12, n_keys, zipf)
    for b, ks in enumerate(stream):
        offs = np.arange(b * B, (b + 1) * B)
        got = t.assign_slots(t.hash_keys(ks), offs)
        ref = j.assign_slots(j.hash_keys(ks), offs)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r)
    assert np.array_equal(t._keys, j._keys)
    assert np.array_equal(t._occ, j._occ)
    assert np.array_equal(t._touch, j._touch)
    assert (t.resident, t.applied_hi) == (j.resident, j.applied_hi)
    assert _counters(tm) == _counters(jm)


def test_replay_below_skip_until_bypasses_like_the_jax_table():
    t, j, tm, jm = _twins()
    ks = np.array([1, 2, 3, 2])
    for tab in (t, j):
        tab.assign_slots(tab.hash_keys(ks), np.arange(4))
        tab.skip_until = 4
    for tab in (t, j):
        s, r, rel, w = tab.assign_slots(tab.hash_keys(ks), np.arange(2, 6))
        assert (s[:2] == tab.scratch).all() and (w[:2] == 0).all()
        assert (s[2:] != tab.scratch).all() and (w[2:] > 0).all()
    assert _counters(tm) == _counters(jm)
    assert t.applied_hi == j.applied_hi == 6


def test_mesh_hooks_stay_cut():
    # lifted by the parallel slice: on a mesh whose data rows share one
    # physical device the table stays one tensor with the same bytes
    from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices, make_mesh
    from flink_jpmml_tpu_torch.parallel.sharding import degraded_mesh
    from flink_jpmml_tpu_torch.utils.config import MeshConfig

    t = KeyedStateTable(StateSpec(capacity=8), device="cpu")
    t.shard(None)
    t.migrate(None)
    t.values = torch.arange(t.rows * 8, dtype=torch.float32).reshape(-1, 8)
    before = t.host_values().copy()
    mesh = make_mesh(MeshConfig(data=4, model=2), devices=cpu_devices(8))
    t.shard(mesh)
    assert isinstance(t.values, torch.Tensor)
    np.testing.assert_array_equal(t.host_values(), before)
    t.migrate(degraded_mesh(mesh, list(mesh.devices[-1])))
    np.testing.assert_array_equal(t.host_values(), before)


# -- the state step ------------------------------------------------------------


def _step_inputs(seed, rows, n, repeats, reset_frac=0.3):
    rng = np.random.default_rng(seed)
    S = np.zeros((rows, 8), np.float32)
    live = rows - 1
    S[:live, COL_COUNT] = rng.integers(0, 5, live)
    seen = S[:live, COL_COUNT] > 0
    S[:live, COL_SUM] = rng.normal(0, 3, live) * seen
    S[:live, COL_SQSUM] = np.abs(rng.normal(0, 9, live)) * seen
    S[:live, COL_DCOUNT] = S[:live, COL_COUNT] * 0.9
    S[:live, COL_DSUM] = S[:live, COL_SUM] * 0.9
    S[:live, COL_LAST_T] = rng.integers(0, 4, live) * seen
    S[:live, COL_MIN] = np.where(seen, rng.normal(-1, 1, live), np.inf)
    S[:live, COL_MAX] = np.where(seen, rng.normal(1, 1, live), -np.inf)
    scratch = rows - 1
    if repeats:
        slots = rng.integers(0, 12, n)
    else:
        slots = rng.permutation(live)[:n]
    slots = slots.astype(np.int32)
    slots[rng.random(n) < 0.1] = scratch  # bypassed / pad rows
    reset = (rng.random(n) < reset_frac) & (slots != scratch)
    if repeats:
        # a fresh slot is fresh for every record of the batch on it
        fresh = np.unique(slots[reset])
        reset = np.isin(slots, fresh) & (slots != scratch)
    rel = rng.integers(0, 6, n).astype(np.float32)
    w = np.where(slots == scratch, 0.0,
                 np.power(np.float32(0.99), -rel)).astype(np.float32)
    score = rng.normal(0, 2, n).astype(np.float32)
    return S, score, slots, rel, w, reset, scratch


def _jax_step(S, score, slots, rel, w, reset, scratch):
    import jax.numpy as jnp

    jd, jS = jsk._state_step(jnp.asarray(S), jnp.asarray(score),
                             jnp.asarray(slots), jnp.asarray(rel),
                             jnp.asarray(w), jnp.asarray(reset), scratch,
                             0.99)
    return np.asarray(jd), np.asarray(jS)


def _assert_step_equals_the_jax_step(S, score, slots, rel, w, reset,
                                     scratch):
    jd, jS = _jax_step(S, score, slots, rel, w, reset, scratch)
    td, tS = tsk._state_step(torch.from_numpy(S), score, slots, rel, w,
                             reset, scratch, 0.99)
    td, tS = td.numpy(), tS.numpy()
    assert tS.shape == jS.shape and td.shape == jd.shape
    assert not tS[scratch].any()
    assert tS.tobytes() == jS.tobytes()
    # derived features of records whose slot was unseen: exactly zeros
    pre_count = np.where(reset, 0.0, S[slots, COL_COUNT])
    unseen = pre_count == 0
    assert not td[unseen].any()
    assert td.tobytes() == jd.tobytes()


@pytest.mark.parametrize("repeats", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_step_equals_the_jax_step(seed, repeats):
    _assert_step_equals_the_jax_step(*_step_inputs(
        seed, rows=64, n=40 if not repeats else 96, repeats=repeats))


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_state_step_folds_a_key_repeated_many_times_like_the_jax_step(
        seed, n):
    """Every key of the batch repeats many times (12 keys over 64 or 256
    records): each slot's records fold into its row in record order."""
    S, score, slots, rel, w, reset, scratch = _step_inputs(
        seed, rows=64, n=n, repeats=True)
    assert np.bincount(slots[slots != scratch]).max() > 2
    _assert_step_equals_the_jax_step(S, score, slots, rel, w, reset,
                                     scratch)


def _keyed_stream(seed, n, rows, n_keys):
    """A keyed stream of ``n`` records over ``n_keys`` slots of a
    ``rows``-row table (the last row the scratch slot), skewed so that a
    few keys repeat within every batch, with per-record strides and
    decay weights; one record in ten bypasses."""
    rng = np.random.default_rng(seed)
    scratch = rows - 1
    keys = np.minimum(rng.zipf(1.3, n) - 1, n_keys - 1).astype(np.int32)
    keys[rng.random(n) < 0.1] = scratch
    rel = np.sort(rng.integers(0, 40, n)).astype(np.float32)
    w = np.where(keys == scratch, 0.0,
                 np.power(np.float32(0.99), -rel)).astype(np.float32)
    score = rng.normal(0, 2, n).astype(np.float32)
    return score, keys, rel, w, scratch


def _step_grouped(step, S, score, slots, rel, w, scratch, batch):
    """Step the stream in batches of ``batch`` records: a slot is fresh
    (reset) in the batch that first holds it."""
    seen = np.zeros(S.shape[0], bool)
    for lo in range(0, len(slots), batch):
        sl = slots[lo:lo + batch]
        reset = ~seen[sl] & (sl != scratch)
        seen[sl] = True
        _, S = step(S, score[lo:lo + batch], sl, rel[lo:lo + batch],
                    w[lo:lo + batch], reset)
    return S


def test_state_table_bytes_do_not_depend_on_the_dispatch_grouping():
    """One keyed stream (numpy seed 11) stepped in 32-record batches and
    in 128-record batches gives the same table bytes in the port, equal
    to the JAX step fed either grouping (the block pipeline aggregates a
    backed-up ring into multi-batch dispatches, and a replay after a
    kill may group the same records otherwise)."""
    rows = 64
    score, slots, rel, w, scratch = _keyed_stream(11, 512, rows, 20)
    S0 = np.zeros((rows, 8), np.float32)

    def tstep(S, *a):
        return tsk._state_step(torch.as_tensor(S), *a, scratch, 0.99)

    def jstep(S, *a):
        return _jax_step(np.asarray(S), *a, scratch)

    got = {}
    for name, step in (("port", tstep), ("jax", jstep)):
        for batch in (32, 128):
            S = _step_grouped(step, S0, score, slots, rel, w, scratch,
                              batch)
            got[name, batch] = np.asarray(S).tobytes()
    assert got["port", 32] == got["port", 128]
    assert got["port", 32] == got["jax", 32] == got["jax", 128]


def test_routing_does_not_depend_on_the_dispatch_grouping():
    """The soak's keyed stream (numpy seed 100000: 256 keys over 2048
    records, some sharing a home slot) routed in 32-record dispatches and
    in seeded random groupings of 1, 2, 4 or 8 such batches a dispatch:
    ``route`` (one ``assign_slots`` an aligned 32-record block) gives
    every record the same slot and fresh mark, and leaves the same host
    mirror."""
    from flink_jpmml_tpu_torch.parallel.partitioner import stable_hash_vec

    rng = np.random.default_rng(100000)
    rng.normal(0.0, 1.0, size=(2048, 5))
    kh = stable_hash_vec(rng.integers(0, 256, size=2048)).astype(np.uint32)
    uk = np.unique(kh)
    assert len(np.unique(uk % 2048)) < len(uk)  # home-slot collisions

    def run(groups):
        t = KeyedStateTable(StateSpec(capacity=2048, key_col=0),
                            device="cpu")
        lo, out = 0, []
        for g in groups:
            out.append(t.route(kh[lo:lo + g], np.arange(lo, lo + g), 32))
            lo += g
        routed = [np.concatenate(c) for c in zip(*out)]
        return routed, (t._keys.tobytes(), t._occ.tobytes())

    want, mirror = run([32] * 64)
    pick = np.random.default_rng(2)
    for _ in range(8):
        groups, left = [], 64
        while left:
            k = min(int(pick.choice([1, 2, 4, 8])), left)
            groups.append(32 * k)
            left -= k
        got, got_mirror = run(groups)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert got_mirror == mirror


def test_state_step_is_the_same_bytes_on_every_run():
    S, score, slots, rel, w, reset, scratch = _step_inputs(
        7, rows=64, n=256, repeats=True)
    runs = [tsk._state_step(torch.from_numpy(S), score, slots, rel, w,
                            reset, scratch, 0.99)[1].numpy().tobytes()
            for _ in range(3)]
    assert runs[0] == runs[1] == runs[2]


def test_renorm_equals_the_jax_renorm():
    S = np.random.default_rng(3).normal(0, 1, (16, 8)).astype(np.float32)
    mul = np.ones(8, np.float32)
    mul[COL_DCOUNT] = mul[COL_DSUM] = np.float32(0.5)
    add = np.zeros(8, np.float32)
    add[COL_LAST_T] = -7.0
    got = tsk.renorm(torch.from_numpy(S), mul, add).numpy()
    assert got.tobytes() == np.asarray(jsk.renorm(S, mul, add)).tobytes()


# -- the armed dispatch --------------------------------------------------------


@pytest.fixture(scope="module")
def gbm(tmp_path_factory):
    path = gen_gbm(str(tmp_path_factory.mktemp("state_gbm")), n_trees=5,
                   depth=3, n_features=4)
    return (compile_pmml(parse_pmml_file(path), batch_size=B, device="cpu"),
            jcompile(jparse(path), batch_size=B))


def _batches(n_batches, keys, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, size=(n_batches * B, 4)).astype(np.float32)
    X[:, 0] = rng.integers(0, keys, size=n_batches * B).astype(np.float32)
    return [(X[i * B:(i + 1) * B], np.arange(i * B, (i + 1) * B))
            for i in range(n_batches)]


def test_armed_scores_equal_stateless_and_the_table_the_jax_one(gbm):
    from flink_jpmml_tpu.runtime.pipeline import dispatch_quantized as jdq
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized

    cm, jcm = gbm
    q, jq = cm.quantized_scorer(), jcm.quantized_scorer()
    t, j, tm, jm = _twins(capacity=64, stride=8)
    for X, offs in _batches(4, keys=20):
        plain = dispatch_quantized(q, X).result()
        res = dispatch_quantized(q, X, state=t, offsets=offs).result()
        assert tstate.is_state_output(res)
        out, derived = tstate.split_output(res)
        assert out.numpy().tobytes() == plain.numpy().tobytes()
        assert derived.shape == (B, len(tstate.DERIVED_FIELDS))
        jdq(jq, X, state=j, offsets=offs)
    jv, tv = np.asarray(j.values), t.host_values()
    assert np.array_equal(t._keys, j._keys) and np.array_equal(t._occ, j._occ)
    assert np.array_equal(tv[:, [COL_COUNT, COL_LAST_T]],
                          jv[:, [COL_COUNT, COL_LAST_T]])
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)
    assert not tv[t.scratch].any()
    assert _counters(tm) == _counters(jm)


def test_padded_rows_ride_the_scratch_slot(gbm):
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized

    cm, _ = gbm
    q = cm.quantized_scorer()
    t = KeyedStateTable(StateSpec(capacity=32), device="cpu")
    X, offs = _batches(1, keys=5)[0]
    res = dispatch_quantized(q, X[:13], state=t, offsets=offs[:13]).result()
    out, derived = tstate.split_output(res)
    assert out.shape[0] == derived.shape[0] == B  # aligned to the batch
    v = t.host_values()
    assert v[:, COL_COUNT].sum() == 13 and not v[t.scratch].any()


def test_renorm_runs_in_the_armed_path_like_the_jax_one(gbm):
    from flink_jpmml_tpu.runtime.pipeline import dispatch_quantized as jdq
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized

    cm, jcm = gbm
    q, jq = cm.quantized_scorer(), jcm.quantized_scorer()
    # decay 0.5: renormalize every 16 strides of 1 offset
    t, j, _, _ = _twins(capacity=64, decay=0.5, stride=1)
    for X, offs in _batches(3, keys=6, seed=4):
        dispatch_quantized(q, X, state=t, offsets=offs)
        jdq(jq, X, state=j, offsets=offs)
    assert t.epoch == j.epoch > 0
    np.testing.assert_allclose(t.host_values(), np.asarray(j.values),
                               rtol=1e-4, atol=1e-5)


# -- snapshots -----------------------------------------------------------------


def _folded(gbm, capacity=64):
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized

    q = gbm[0].quantized_scorer()
    t = KeyedStateTable(StateSpec(capacity=capacity), device="cpu")
    for X, offs in _batches(2, keys=12, seed=9):
        dispatch_quantized(q, X, state=t, offsets=offs)
    return t


def test_payload_round_trip_is_byte_exact(gbm):
    t = _folded(gbm)
    t2 = KeyedStateTable(StateSpec(capacity=64), device="cpu")
    assert t2.from_payload(t.to_payload())
    assert t2.host_values().tobytes() == t.host_values().tobytes()
    for a in ("_keys", "_occ", "_touch"):
        assert np.array_equal(getattr(t2, a), getattr(t, a))
    assert (t2.resident, t2._seq) == (t.resident, t._seq)
    assert t2.skip_until == t.applied_hi == 64


def test_payload_reads_in_the_jax_table_and_back(gbm):
    t = _folded(gbm)
    j = jstate.KeyedStateTable(jstate.StateSpec(capacity=64))
    assert j.from_payload(t.to_payload())
    assert np.asarray(j.values).tobytes() == t.host_values().tobytes()
    t2 = KeyedStateTable(StateSpec(capacity=64), device="cpu")
    assert t2.from_payload(j.to_payload())
    assert t2.host_values().tobytes() == t.host_values().tobytes()


def test_sidecar_round_trip_is_byte_exact(gbm, tmp_path):
    t = _folded(gbm)
    name = t.save_sidecar(str(tmp_path))
    assert name is not None and (tmp_path / name).exists()
    t2 = KeyedStateTable(StateSpec(capacity=64), device="cpu")
    assert t2.restore_sidecar(str(tmp_path), name)
    assert t2.host_values().tobytes() == t.host_values().tobytes()
    assert t2.skip_until == t.applied_hi
    j = jstate.KeyedStateTable(jstate.StateSpec(capacity=64))
    assert j.restore_sidecar(str(tmp_path), name)
    assert np.asarray(j.values).tobytes() == t.host_values().tobytes()


def test_capacity_mismatch_is_refused(gbm, tmp_path):
    t = _folded(gbm)
    t2 = KeyedStateTable(StateSpec(capacity=128), device="cpu")
    assert not t2.from_payload(t.to_payload())
    assert not t2.restore_sidecar(str(tmp_path), t.save_sidecar(
        str(tmp_path)))
    assert t2.resident == 0 and not t2.host_values().any()


def test_rollback_restores_the_last_snapshot(gbm):
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized

    q = gbm[0].quantized_scorer()
    t = _folded(gbm)
    snap = t.snapshot()
    X, offs = _batches(3, keys=12, seed=9)[2]
    dispatch_quantized(q, X, state=t, offsets=offs)
    assert t.host_values().tobytes() != snap["values"].tobytes()
    t.rollback()
    assert t.host_values().tobytes() == snap["values"].tobytes()
    assert t.skip_until == t.applied_hi == 64


# -- the record path -----------------------------------------------------------


def _dict_records(n, keys, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 4)).astype(np.float32)
    fields = [f"f{i}" for i in range(4)]
    return [dict(zip(fields, map(float, row)), key=int(k))
            for row, k in zip(X, rng.integers(0, keys, n))]


def test_stateful_record_pipeline_equals_the_jax_one(gbm, tmp_path):
    from flink_jpmml_tpu.runtime.engine import Pipeline as JPipeline
    from flink_jpmml_tpu.runtime.engine import StaticScorer as JStatic
    from flink_jpmml_tpu.runtime.sinks import CollectSink as JSink
    from flink_jpmml_tpu.runtime.sources import InMemorySource as JSource
    from flink_jpmml_tpu.utils.config import BatchConfig as JBatch
    from flink_jpmml_tpu.utils.config import RuntimeConfig as JConfig
    from flink_jpmml_tpu_torch.runtime.engine import Pipeline, StaticScorer
    from flink_jpmml_tpu_torch.runtime.sinks import CollectSink
    from flink_jpmml_tpu_torch.runtime.sources import InMemorySource
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    cm, jcm = gbm
    if "f0" not in cm.field_space.fields:
        pytest.skip("fixture fields are not f0..f3")
    recs = _dict_records(5 * B, keys=9)
    tables = []
    for Pipe, Static, Src, Snk, Cfg, Bat, Reg, model, spec in (
        (Pipeline, StaticScorer, InMemorySource, CollectSink, RuntimeConfig,
         BatchConfig, MetricsRegistry, cm, StateSpec(capacity=64)),
        (JPipeline, JStatic, JSource, JSink, JConfig, JBatch, JRegistry, jcm,
         jstate.StateSpec(capacity=64)),
    ):
        reg = Reg()
        scorer = Static(model, state=spec)
        sink = Snk()
        pipe = Pipe(Src(recs), scorer, sink,
                    Cfg(batch=Bat(size=B, deadline_us=2000)), metrics=reg,
                    tenant="zoo@1")
        pipe.run_until_exhausted(timeout=60.0)
        assert len(sink.items) == len(recs)
        c = reg.struct_snapshot()["counters"]
        assert c['tenant_records{model="zoo@1"}'] == len(recs)
        tables.append(scorer.state_table)
    t, j = tables
    assert np.array_equal(t._keys, j._keys)
    tv, jv = t.host_values(), np.asarray(j.values)
    assert tv[:, COL_COUNT].sum() == len(recs)
    assert np.array_equal(tv[:, COL_COUNT], jv[:, COL_COUNT])
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)
    # the record path checkpoints the table inline
    assert tables[0] is not None
    state = StaticScorer(cm, state=StateSpec(capacity=64))
    state.restore({"keyed_state": t.to_payload()})
    assert state.state_table.host_values().tobytes() == tv.tobytes()


@pytest.mark.parametrize("capacity", [4096, 256],
                         ids=["no_eviction", "evicting"])
def test_armed_dispatches_fold_the_same_table_in_any_grouping(gbm,
                                                              capacity):
    """A zipf keyed stream (numpy seed 29, 2,000 keys over 2,048
    records) through ``dispatch_quantized(state=)`` in dispatches of 1,
    2, 4 and 8 compile batches: the same table bytes and host mirror
    each time, also where the table is too small and keys evict one
    another inside an aggregated dispatch."""
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized

    q = gbm[0].quantized_scorer()
    rng = np.random.default_rng(29)
    n = 64 * B
    X = rng.normal(0.0, 1.0, (n, 4)).astype(np.float32)
    keys = ((rng.zipf(1.1, size=n) - 1) % 2000).astype(np.int64)

    def run(rows):
        t = KeyedStateTable(StateSpec(capacity=capacity, key_col=0),
                            device="cpu")
        for off in range(0, n, rows):
            dispatch_quantized(
                q, X[off:off + rows], state=t,
                state_keys=keys[off:off + rows],
                offsets=np.arange(off, off + rows, dtype=np.int64))
        return (t.host_values().tobytes(), t._keys.tobytes(),
                t._occ.tobytes())

    want = run(B)
    for k in (2, 4, 8):
        assert run(k * B) == want


def test_static_scorer_state_needs_the_rank_wire(tmp_path):
    from flink_jpmml_tpu_torch.assets_gen import gen_iris_lr
    from flink_jpmml_tpu_torch.runtime.engine import StaticScorer
    from flink_jpmml_tpu_torch.utils.exceptions import (
        InputValidationException,
    )

    cm = compile_pmml(parse_pmml_file(gen_iris_lr(str(tmp_path))),
                      batch_size=8, device="cpu")
    with pytest.raises(InputValidationException):
        StaticScorer(cm, state=StateSpec(capacity=8))


# -- the block path ------------------------------------------------------------


def _keyed_data(blocks, keys, seed=17):
    rng = np.random.default_rng(seed)
    data = rng.normal(0.0, 1.0, size=(B * blocks, 4)).astype(np.float32)
    data[:, 0] = rng.integers(0, keys, size=B * blocks).astype(np.float32)
    return data


def _port_block_run(cm, data, spec, **kw):
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )

    seen = []
    pipe = BlockPipeline(FiniteBlockSource(data, block_size=B), cm,
                         lambda out, n, off: seen.append((off, n)),
                         max_dispatch_chunks=1, state=spec, **kw)
    if kw.get("checkpoint") is not None:
        pipe.restore()
    pipe.run_until_exhausted(timeout=60.0)
    return pipe, seen


def test_block_pipeline_with_state_equals_the_jax_one(gbm):
    from flink_jpmml_tpu.runtime.block import BlockPipeline as JBlock
    from flink_jpmml_tpu.runtime.block import FiniteBlockSource as JSource

    cm, jcm = gbm
    data = _keyed_data(8, keys=25)
    pipe, seen = _port_block_run(cm, data, StateSpec(capacity=64,
                                                     stride=16),
                                 tenant="gbm@1")
    assert sum(n for _, n in seen) == len(data)
    jpipe = JBlock(JSource(data, block_size=B), jcm,
                   lambda out, n, off: None, max_dispatch_chunks=1,
                   state=jstate.StateSpec(capacity=64, stride=16))
    jpipe.run_until_exhausted(timeout=60.0)
    t, j = pipe._state, jpipe._state
    assert np.array_equal(t._keys, j._keys) and np.array_equal(t._occ, j._occ)
    tv, jv = t.host_values(), np.asarray(j.values)
    assert np.array_equal(tv[:, [COL_COUNT, COL_LAST_T]],
                          jv[:, [COL_COUNT, COL_LAST_T]])
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)
    c = pipe.metrics.struct_snapshot()["counters"]
    assert c["state_records"] == len(data)
    assert c['tenant_records{model="gbm@1"}'] == len(data)


def test_block_pipeline_restores_state_from_its_checkpoint(gbm, tmp_path):
    """Stop after part of the stream, restore from the checkpoint, finish:
    the table equals an uninterrupted run's byte for byte."""
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager

    cm, _ = gbm
    data = _keyed_data(10, keys=30, seed=23)
    spec = StateSpec(capacity=64, stride=8)
    whole, _ = _port_block_run(cm, data, spec)
    ck = CheckpointManager(str(tmp_path / "ck"))
    first, _ = _port_block_run(cm, data[:6 * B], spec, checkpoint=ck)
    assert first.committed_offset == 6 * B
    assert any(f.startswith("state-") for f in
               __import__("os").listdir(tmp_path / "ck"))
    second, seen = _port_block_run(
        cm, data, spec, checkpoint=CheckpointManager(str(tmp_path / "ck")))
    assert seen[0][0] == 6 * B
    assert second._state.host_values().tobytes() == \
        whole._state.host_values().tobytes()
    for a in ("_keys", "_occ"):
        assert np.array_equal(getattr(second._state, a),
                              getattr(whole._state, a))


def test_block_pipeline_replay_below_the_snapshot_bypasses(gbm, tmp_path):
    """A restore whose source replays records the snapshot already holds
    (at-least-once) folds none of them twice."""
    from flink_jpmml_tpu_torch.runtime.block import FiniteBlockSource
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager

    cm, _ = gbm
    data = _keyed_data(6, keys=10, seed=29)
    spec = StateSpec(capacity=64)
    whole, _ = _port_block_run(cm, data, spec)
    ck = CheckpointManager(str(tmp_path / "ck"))
    _port_block_run(cm, data[:4 * B], spec, checkpoint=ck)

    class Rewind(FiniteBlockSource):
        def seek(self, offset):  # replays two blocks before the cursor
            super().seek(max(0, offset - 2 * B))

    from flink_jpmml_tpu_torch.runtime.block import BlockPipeline

    pipe = BlockPipeline(Rewind(data, block_size=B), cm,
                         lambda out, n, off: None, max_dispatch_chunks=1,
                         state=spec,
                         checkpoint=CheckpointManager(str(tmp_path / "ck")))
    pipe.restore()
    pipe.run_until_exhausted(timeout=60.0)
    c = pipe.metrics.struct_snapshot()["counters"]
    assert c["state_bypass_records"] == 2 * B
    assert pipe._state.host_values().tobytes() == \
        whole._state.host_values().tobytes()


def test_dlq_batch_never_folds(gbm, tmp_path, monkeypatch):
    """The never-delivered contract extended to state (JAX
    tests/test_state.py TestNeverDelivered): the poisoned record goes to
    the DLQ, is never delivered and never folded; the table rolled back."""
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.dlq import DeadLetterQueue

    monkeypatch.setenv("FJT_RETRY_BASE_S", "0.01")
    cm, _ = gbm
    blocks, keys = 5, 6
    data = _keyed_data(blocks, keys)
    poison = 70
    data[poison, 0] = 99.0  # a key no other record has
    seen = []
    m = MetricsRegistry()
    dlq = DeadLetterQueue(str(tmp_path / "dlq"), metrics=m)
    assert faults.install_from_env(f"poison_record:offset={poison}")
    try:
        pipe = BlockPipeline(
            FiniteBlockSource(data, block_size=B), cm,
            lambda out, n, first_off: seen.append((first_off, n)),
            metrics=m, in_flight=1, dlq=dlq, max_dispatch_chunks=1,
            state=StateSpec(capacity=64, key_col=0))
        pipe.run_until_exhausted(timeout=60.0)
    finally:
        faults.clear()
    assert sorted(set(dlq.offsets())) == [poison]
    covered = np.zeros(B * blocks, np.int64)
    for off, n in seen:
        covered[off: off + n] += 1
    assert sorted(np.flatnonzero(covered == 0).tolist()) == [poison]
    t = pipe._state
    vals = t.host_values()[: t.capacity]
    folded = dict(zip(t._keys[t._occ].tolist(),
                      vals[t._occ, COL_COUNT].tolist()))
    assert int(t.hash_keys(np.array([99]))[0]) not in folded
    kh = t.hash_keys(data[:, 0].astype(np.int64))
    uk, n = np.unique(kh, return_counts=True)
    true_counts = dict(zip(uk.tolist(), n.tolist()))
    for k, cnt in folded.items():
        assert cnt <= true_counts[k]
    total = sum(folded.values())
    assert total >= B and total % B == 0
    assert m.struct_snapshot()["counters"]["state_rollbacks"] >= 1


def test_block_pipeline_state_on_the_f32_path_is_refused(tmp_path):
    from flink_jpmml_tpu_torch.assets_gen import gen_iris_lr
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.utils.exceptions import (
        InputValidationException,
    )

    cm = compile_pmml(parse_pmml_file(gen_iris_lr(str(tmp_path))),
                      batch_size=8, device="cpu")
    pipe = BlockPipeline(FiniteBlockSource(np.zeros((8, 4), np.float32), 8),
                         cm, lambda out, n, off: None,
                         state=StateSpec(capacity=8))
    with pytest.raises(InputValidationException):
        pipe.run_until_exhausted(timeout=30.0)


def test_block_pipeline_mesh_and_donate_stay_cut(gbm):
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )

    from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices, make_mesh

    with pytest.raises(NotPortedError):
        BlockPipeline(FiniteBlockSource(np.zeros((B, 4), np.float32), B),
                      gbm[0], lambda out, n, off: None, donate=True)
    # mesh= is lifted by the parallel slice: the model is sharded and
    # scores on the f32 path, so the state stage cannot ride it
    pipe = BlockPipeline(
        FiniteBlockSource(np.zeros((B, 4), np.float32), B), gbm[0],
        lambda out, n, off: None, mesh=make_mesh(devices=cpu_devices(2)))
    assert pipe.backend == "f32" and pipe._bound.model.batch_divisor == 2
