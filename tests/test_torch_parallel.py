"""The port's mesh and sharded models against the JAX package, on the CPU.

The twin of tests/test_parallel.py, case by case. The JAX side runs on
the 8-device virtual CPU mesh (tests/conftest.py); the port's on a mesh
of logical ``torch.device("cpu", i)`` devices, at 8×1, 4×2 and 2×4. The
same numpy-seeded inputs go through both: heads are held to the JAX
sharded model at rtol 1e-4 / atol 1e-5 with labels equal, and each DP
shard to the unsharded port at the same bar.
"""

import numpy as np
import pytest
import torch

from flink_jpmml_tpu.compile import compile_pmml as jcompile
from flink_jpmml_tpu.parallel import dp_sharded as jdp_sharded
from flink_jpmml_tpu.parallel import make_mesh as jmake_mesh
from flink_jpmml_tpu.pmml import parse_pmml as jparse
from flink_jpmml_tpu.pmml import parse_pmml_file as jparse_file
from flink_jpmml_tpu.utils.config import MeshConfig as JMeshConfig
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.parallel import (
    HashPartitioner,
    ShardedModel,
    TpLinearScorer,
    dp_sharded,
    make_mesh,
    stable_hash,
)
from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices
from flink_jpmml_tpu_torch.pmml import parse_pmml as tparse
from flink_jpmml_tpu_torch.pmml import parse_pmml_file as tparse_file
from flink_jpmml_tpu_torch.utils.config import MeshConfig
from flink_jpmml_tpu_torch.utils.exceptions import (
    DeviceUnavailableError,
    FlinkJpmmlTpuError,
    InputValidationException,
)

RTOL, ATOL = 1e-4, 1e-5
SHAPES = [(8, 1), (4, 2), (2, 4)]


def tmesh(data, model, n=8):
    return make_mesh(MeshConfig(data=data, model=model),
                     devices=cpu_devices(n))


def jmesh(data, model):
    return jmake_mesh(JMeshConfig(data=data, model=model))


def assert_out_match(got, want, valid=None):
    """A port ModelOutput against a reference one (JAX arrays or port
    tensors): values and rows within the bar, labels equal."""
    g = [None if t is None else np.asarray(t) for t in got]
    w = [None if t is None else np.asarray(t) for t in want]
    np.testing.assert_array_equal(g[1], w[1])
    ok = w[1] if valid is None else valid
    np.testing.assert_allclose(g[0][ok], w[0][ok], rtol=RTOL, atol=ATOL)
    if w[2] is not None:
        np.testing.assert_allclose(g[2][ok], w[2][ok], rtol=RTOL, atol=ATOL)
    if w[3] is not None:
        np.testing.assert_array_equal(g[3][ok], w[3][ok])


class TestMesh:
    def test_all_dp_default_over_given_devices(self):
        mesh = make_mesh(devices=cpu_devices(8))
        assert mesh.shape["data"] == 8
        assert mesh.shape["model"] == 1
        assert mesh.devices.shape == (8, 1)
        assert [d.index for d in mesh.devices.flat] == list(range(8))

    @pytest.mark.parametrize("shape", SHAPES)
    def test_2d(self, shape):
        mesh = tmesh(*shape)
        j = jmesh(*shape)
        assert dict(mesh.shape) == dict(j.shape)
        assert mesh.devices.shape == j.devices.shape
        # the same device order: row-major over the device list
        assert [d.index for d in mesh.devices.flat] == [
            d.id for d in j.devices.flat]

    def test_too_many(self):
        with pytest.raises(FlinkJpmmlTpuError, match="devices"):
            tmesh(16, 2)

    def test_subset_needs_opt_in(self):
        with pytest.raises(FlinkJpmmlTpuError, match="allow_subset"):
            tmesh(2, 2)
        mesh = make_mesh(MeshConfig(data=2, model=2),
                         devices=cpu_devices(8), allow_subset=True)
        assert mesh.size == 4

    def test_no_card_no_devices_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DeviceUnavailableError):
            make_mesh()
        with pytest.raises(DeviceUnavailableError):
            make_mesh(devices=[torch.device("cuda", 0)])

    def test_hashable_and_equal_by_devices(self):
        assert tmesh(4, 2) == tmesh(4, 2)
        assert hash(tmesh(4, 2)) == hash(tmesh(4, 2))
        assert tmesh(4, 2) != tmesh(2, 4)


class TestDpSharded:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_gbm_dp_matches_jax_and_single_device(self, assets_dir, shape):
        path = str(assets_dir / "gbm_small.pmml")
        jcm = jcompile(jparse_file(path))
        cm = compile_pmml(tparse_file(path), device="cpu")
        jsm = jdp_sharded(jcm, jmesh(*shape))
        sm = dp_sharded(cm, tmesh(*shape))
        rng = np.random.default_rng(0)
        X = rng.normal(0, 1, size=(64, 8)).astype(np.float32)
        M = np.zeros((64, 8), bool)
        out = sm.predict(X, M)
        assert_out_match(out, jsm.predict(X, M))
        assert_out_match(out, cm.predict(X, M))
        assert isinstance(sm, ShardedModel)
        assert sm.batch_divisor == shape[0]
        assert sm.tp_sharded_leaves == ()

    def test_classification_dp(self, assets_dir):
        path = str(assets_dir / "iris_lr.pmml")
        jcm = jcompile(jparse_file(path))
        cm = compile_pmml(tparse_file(path), device="cpu")
        jsm = jdp_sharded(jcm, jmesh(8, 1))
        sm = dp_sharded(cm, tmesh(8, 1))
        rng = np.random.default_rng(1)
        X = rng.normal(3, 2, size=(32, 4)).astype(np.float32)
        M = np.zeros((32, 4), bool)
        ref = jsm.decode(jsm.predict(X, M), 32)
        got = sm.decode(sm.predict(X, M), 32)
        assert [p.target.label for p in got] == [
            p.target.label for p in ref]
        assert [p.target.label for p in got] == [
            p.target.label for p in cm.decode(cm.predict(X, M), 32)]

    def test_indivisible_batch_rejected(self, assets_dir):
        cm = compile_pmml(tparse_file(str(assets_dir / "iris_lr.pmml")),
                          device="cpu")
        sm = dp_sharded(cm, tmesh(8, 1))
        with pytest.raises(InputValidationException, match="divide"):
            sm.predict(np.zeros((30, 4), np.float32),
                       np.zeros((30, 4), bool))

    def test_params_replicated_once_per_physical_device(self, assets_dir):
        # the logical cpu:i devices are one physical CPU: every row
        # scores with the base's own tensors, no copy
        cm = compile_pmml(tparse_file(str(assets_dir / "gbm_small.pmml")),
                          device="cpu")
        sm = dp_sharded(cm, tmesh(8, 1))
        assert all(p is cm.params for p in sm._row_params)
        assert sm.quantized_scorer() is None
        assert sm.device == torch.device("cpu")


class TestTpLinear:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("link", ["logit", "identity", "softmax"])
    def test_feature_sharded_matches_dense(self, shape, link):
        from flink_jpmml_tpu.parallel import TpLinearScorer as JTp

        rng = np.random.default_rng(2)
        F, C, B = 1024, 3, 16
        W = rng.normal(0, 0.1, size=(F, C)).astype(np.float32)
        b = rng.normal(0, 0.1, size=(C,)).astype(np.float32)
        X = rng.normal(0, 1, size=(B, F)).astype(np.float32)
        scorer = TpLinearScorer(mesh=tmesh(*shape), W=W, b=b, link=link)
        got = scorer.predict(X).numpy()
        jgot = np.asarray(JTp(mesh=jmesh(*shape), W=W, b=b,
                              link=link).predict(X))
        np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
        y = X.astype(np.float64) @ W + b
        if link == "logit":
            y = 1.0 / (1.0 + np.exp(-y))
        elif link == "softmax":
            e = np.exp(y - y.max(axis=1, keepdims=True))
            y = e / e.sum(axis=1, keepdims=True)
        np.testing.assert_allclose(got, y, rtol=2e-5, atol=1e-6)

    def test_partials_added_in_slice_order(self):
        # the port's psum: one partial product a model slice, added in
        # slice order on the row's first device
        from flink_jpmml_tpu_torch.parallel.sharding import tp_linear

        rng = np.random.default_rng(5)
        W = torch.from_numpy(rng.normal(size=(64, 2)).astype(np.float32))
        b = torch.zeros(2)
        X = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
        fn = tp_linear(tmesh(2, 4), 64, 2)
        want = None
        for lo in range(0, 64, 16):
            p = X[:, lo:lo + 16] @ W[lo:lo + 16]
            want = p if want is None else want + p
        assert torch.equal(fn(W, b, X), want)

    def test_indivisible_features_rejected(self):
        with pytest.raises(InputValidationException, match="divide"):
            TpLinearScorer(mesh=tmesh(4, 2),
                           W=np.zeros((63, 2), np.float32),
                           b=np.zeros(2, np.float32))

    def test_indivisible_batch_rejected(self):
        s = TpLinearScorer(mesh=tmesh(4, 2), W=np.zeros((64, 2), np.float32),
                           b=np.zeros(2, np.float32))
        with pytest.raises(InputValidationException, match="divide"):
            s.predict(np.zeros((6, 64), np.float32))


class TestPartitioner:
    def test_stable_and_equal_to_the_jax_hash(self):
        from flink_jpmml_tpu.parallel import stable_hash as jhash

        for key in ("model-a", ("m", 1), "user-7", 12345):
            assert stable_hash(key) == jhash(key)

    def test_partition_deterministic_and_complete(self):
        p = HashPartitioner(4, key_fn=lambda r: r["k"])
        records = [{"k": f"key{i}", "v": i} for i in range(100)]
        lanes = p.partition(records)
        assert lanes == p.partition(records)
        assert set(lanes) <= set(range(4))
        assert sum(len(lane) for lane in p.split(records)) == 100


class TestShardedPipeline:
    def test_streaming_pipeline_over_dp_sharded_model(self, tmp_path):
        """The record engine scores through a batch-sharded model on an
        8-row CPU mesh, labels equal to the unsharded port's."""
        from assets.generate import gen_iris_lr
        from flink_jpmml_tpu_torch.runtime.engine import (
            Pipeline,
            StaticScorer,
        )
        from flink_jpmml_tpu_torch.runtime.sinks import CollectSink
        from flink_jpmml_tpu_torch.runtime.sources import InMemorySource
        from flink_jpmml_tpu_torch.utils.config import (
            BatchConfig,
            RuntimeConfig,
        )

        cm = compile_pmml(tparse_file(gen_iris_lr(str(tmp_path))),
                          batch_size=64, device="cpu")
        sharded = dp_sharded(cm, tmesh(8, 1))
        rng = np.random.default_rng(0)
        records = [
            {f: float(v) for f, v in zip(cm.active_fields, row)}
            for row in rng.normal(3.0, 2.0, size=(300, 4))
        ]
        sink = CollectSink()
        pipe = Pipeline(
            InMemorySource(records), StaticScorer(sharded), sink,
            RuntimeConfig(batch=BatchConfig(size=64, deadline_us=1000)),
        )
        pipe.run_until_exhausted(timeout=60.0)
        assert len(sink.items) == 300
        ref = StaticScorer(cm, use_quantized=False)
        exp = ref.finish(ref.submit(records))
        assert [a.target.label for a in sink.items] == [
            b.target.label for b in exp]


def _family_docs():
    """The JAX suite's family fixtures (tests/test_parallel.py
    TestNewFamiliesSharded): (name, xml, arity, seed)."""
    from test_anomaly import _iforest_xml
    from test_glm_bayes import MULTINOMIAL, NAIVE_BAYES
    from test_gp_baseline_assoc import ASSOC, BASELINE, GP
    from test_knn import _knn_xml
    from test_scorecard_ruleset import RULESET, SCORECARD
    from test_svm import KERNELS, _PAIR_MACHINES, _svm_xml
    from test_textmodel import _xml
    from test_timeseries import SEASONAL_MUL, TREND_DAMPED, TS

    return [
        ("scorecard", SCORECARD, 2, 0),
        ("ruleset", RULESET.format(criterion="weightedSum"), 2, 0),
        ("glm_multinomial", MULTINOMIAL, 1, 0),
        ("naive_bayes", NAIVE_BAYES, 2, 0),
        ("svm", _svm_xml(KERNELS["radialBasis"][0], _PAIR_MACHINES), 2, 0),
        ("knn", _knn_xml(), 2, 0),
        ("anomaly", _iforest_xml(), 1, 0),
        ("gp", GP.format(kernel='<RadialBasisKernel gamma="1.5" '
                                'noiseVariance="0.1" lambda="1.1"/>'), 2, 0),
        ("baseline", BASELINE.format(
            dist='<GaussianDistribution mean="2.0" variance="9.0"/>'),
         1, 0),
        ("association", ASSOC, 4, 5),
        ("timeseries", TS.format(trend=TREND_DAMPED,
                                 seasonal=SEASONAL_MUL), 1, 0),
        ("textmodel", _xml("logarithmic", "inverseDocumentFrequency",
                           "cosine", "cosine"), 4, 0),
    ]


FAMILIES = [f[0] for f in _family_docs()]


class TestNewFamiliesSharded:
    """Every family scores alike under the 8-row data-parallel mesh: the
    port's sharded output held to the JAX sharded model's and to the
    unsharded port's."""

    @pytest.mark.parametrize("name", FAMILIES)
    def test_family_sharded(self, name):
        _, xml, arity, seed = next(f for f in _family_docs()
                                   if f[0] == name)
        jsm = jdp_sharded(jcompile(jparse(xml)), jmesh(8, 1))
        cm = compile_pmml(tparse(xml), device="cpu")
        sm = dp_sharded(cm, tmesh(8, 1))
        rng = np.random.default_rng(seed)
        X = rng.normal(0.5, 1.2, size=(64, arity)).astype(np.float32)
        M = np.zeros((64, arity), bool)
        out = sm.predict(X, M)
        jout = jsm.predict(X, M)
        assert_out_match(out, jout)
        assert_out_match(out, cm.predict(X, M))
        assert out.value.shape[0] == 64


class TestModelParallelGp:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_instance_sharded_gp_matches(self, shape):
        from flink_jpmml_tpu.parallel.sharding import mp_gp as jmp_gp
        from flink_jpmml_tpu_torch.parallel.sharding import mp_gp
        from test_gp_baseline_assoc import GP

        xml = GP.format(
            kernel='<ARDSquaredExponentialKernel gamma="1.4" '
                   'noiseVariance="0.15"><Lambda>'
                   '<Array n="2" type="real">0.9 1.7</Array></Lambda>'
                   "</ARDSquaredExponentialKernel>"
        )
        cm = compile_pmml(tparse(xml), device="cpu")
        fn = mp_gp(tmesh(*shape), tparse(xml).model)
        jfn = jmp_gp(jmesh(*shape), jparse(xml).model)
        rng = np.random.default_rng(7)
        X = rng.normal(0, 1, size=(32, 2)).astype(np.float32)
        got = fn(X).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(X)), rtol=RTOL,
                                   atol=ATOL)
        ref = cm.predict(X, np.zeros_like(X, bool)).value.numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)

    def test_non_sq_kernel_rejected(self):
        from flink_jpmml_tpu_torch.parallel.sharding import mp_gp
        from flink_jpmml_tpu_torch.utils.exceptions import (
            ModelCompilationException,
        )
        from test_gp_baseline_assoc import GP

        doc = tparse(GP.format(
            kernel='<AbsoluteExponentialKernel gamma="1.0" '
                   'noiseVariance="0.1"/>'))
        with pytest.raises(ModelCompilationException, match="squared"):
            mp_gp(tmesh(4, 2), doc.model)

    def test_indivisible_batch_rejected(self):
        from flink_jpmml_tpu_torch.parallel.sharding import mp_gp
        from test_gp_baseline_assoc import GP

        doc = tparse(GP.format(
            kernel='<RadialBasisKernel gamma="1.0" noiseVariance="0.1" '
                   'lambda="1.0"/>'))
        fn = mp_gp(tmesh(4, 2), doc.model)
        with pytest.raises(InputValidationException, match="divide"):
            fn(np.zeros((30, 2), np.float32))


class TestDistributed:
    def test_single_process_is_a_no_op(self, monkeypatch):
        from flink_jpmml_tpu_torch.parallel import init_distributed

        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert init_distributed() is False
        assert init_distributed(num_processes=1) is False

    def test_global_batch_places_the_local_slice(self):
        from flink_jpmml_tpu_torch.parallel import global_batch

        mesh = tmesh(4, 2)
        X = np.arange(24, dtype=np.float32).reshape(8, 3)
        gb = global_batch(mesh, X, np.zeros((8, 3), bool))
        assert gb.global_rows == 8 and gb.offset == 0
        assert gb.shape == (8, 3)
        assert len(gb.X) == 4 and len(gb.M) == 4
        np.testing.assert_array_equal(
            torch.cat(gb.X).numpy(), X)
        with pytest.raises(InputValidationException, match="divide"):
            global_batch(mesh, X[:6], np.zeros((6, 3), bool))


class TestHealth:
    def test_reporter_beats_reach_the_coordinator(self):
        import time

        from flink_jpmml_tpu_torch.parallel import (
            HealthCoordinator,
            HealthReporter,
        )

        coord = HealthCoordinator(timeout_s=5.0)
        try:
            rep = HealthReporter(coord.host, coord.port, "w0",
                                 interval_s=0.02)
            try:
                deadline = time.monotonic() + 10.0
                while (time.monotonic() < deadline
                       and coord.alive() != ["w0"]):
                    time.sleep(0.01)
                assert coord.alive() == ["w0"]
            finally:
                rep.stop()
        finally:
            coord.close()

    def test_device_health_keys_by_index(self):
        from flink_jpmml_tpu_torch.parallel.health import DeviceHealth

        lost = []
        dh = DeviceHealth(on_lost=lost.append).watch(cpu_devices(4))
        assert dh.mark_lost(torch.device("cpu", 2))
        assert [d.index for d in dh.alive()] == [0, 1, 3]
        assert [d.index for d in dh.lost()] == [2]


_WORKER = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
from flink_jpmml_tpu_torch.parallel import global_batch, init_distributed
from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices, make_mesh

pid, coord, nproc = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
assert init_distributed(coord, nproc, pid)
assert init_distributed(coord, nproc, pid)  # idempotent
assert dist.get_backend() == "gloo" and dist.get_world_size() == nproc
mesh = make_mesh(devices=cpu_devices(2))
# each process contributes 4 + pid rows of (pid + 1)
n = 4 + 2 * pid
X = np.full((n, 3), float(pid + 1), np.float32)
gb = global_batch(mesh, X, np.zeros((n, 3), bool))
assert gb.global_rows == sum(4 + 2 * p for p in range(nproc)), gb
assert gb.offset == sum(4 + 2 * p for p in range(pid)), gb
total = torch.cat(gb.X).sum()
dist.all_reduce(total)
expect = sum(3.0 * (4 + 2 * p) * (p + 1) for p in range(nproc))
assert float(total) == expect, (float(total), expect)
dist.destroy_process_group()
print("proc", pid, "OK")
"""


@pytest.mark.slow
@pytest.mark.parametrize("nproc", [2, 4])
def test_process_group_global_batch(tmp_path, nproc):
    """Real processes join one gloo group over a local rendezvous and
    contribute their local slices; the global row count, each slice's
    offset and an all-reduced sum agree (the twin of
    tests/test_multihost.py)."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), f"127.0.0.1:{port}",
             str(nproc)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}:\n{out}"
        assert f"proc {i} OK" in out
