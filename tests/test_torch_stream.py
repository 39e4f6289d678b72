"""The port's record API on the CPU against the JAX package's: the bounded
queue, ``ModelReader`` with its verify gate, ``StreamEnvironment`` /
``evaluate`` / ``quick_evaluate`` over the record engine (a logistic
regression on the f32 backend, a GBM on the rank wire, dense vectors and
dict records), its metrics, and each option the slice does not port.

Both packages score the same seed-made records through their own API
(the JAX package on the CPU, as tests/test_runtime.py runs it; the port
with ``device="cpu"``, where the GBM reaches the kernel's plain version).
Outputs are compared in order: values at the rank-wire bar rtol 1e-4 /
atol 1e-5, labels and empty lanes exactly."""

import json
import time

import numpy as np
import pytest

import test_torch_verify as tv
from flink_jpmml_tpu.api import ModelReader as JReader
from flink_jpmml_tpu.api import StreamEnvironment as JEnv
from flink_jpmml_tpu.api import clear_model_cache as jclear
from flink_jpmml_tpu.runtime import queues as jqueues
from flink_jpmml_tpu.runtime import sources as jsources
from flink_jpmml_tpu.utils.config import BatchConfig as JBatch
from flink_jpmml_tpu.utils.config import RuntimeConfig as JConfig
from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
from flink_jpmml_tpu_torch.api import clear_model_cache
from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_iris_lr
from flink_jpmml_tpu_torch.compile import qtrees_cuda
from flink_jpmml_tpu_torch.runtime import queues as tqueues
from flink_jpmml_tpu_torch.runtime import sinks as tsinks
from flink_jpmml_tpu_torch.runtime import sources as tsources
from flink_jpmml_tpu_torch.runtime.engine import Pipeline, StaticScorer
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
from flink_jpmml_tpu_torch.utils.exceptions import (
    ModelVerificationException,
    NotPortedError,
)

RTOL, ATOL = 1e-4, 1e-5
B = 32


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("models"))
    return {
        "iris": gen_iris_lr(d),
        "gbm": gen_gbm(d, n_trees=20, depth=4, n_features=6),
    }


def vectors(n, fields, seed=0, missing=0.2):
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.5, size=(n, fields)).astype(np.float32)
    X[rng.random(size=X.shape) < missing] = np.nan
    return X


def dict_records(X, fields):
    """Dict records of ``X`` over ``fields``; NaN cells are left out."""
    return [
        {f: float(v) for f, v in zip(fields, row) if not np.isnan(v)}
        for row in X
    ]


def envs(batch=B):
    return (
        JEnv(JConfig(batch=JBatch(size=batch, deadline_us=2000))),
        StreamEnvironment(
            RuntimeConfig(batch=BatchConfig(size=batch, deadline_us=2000)),
            device="cpu",
        ),
    )


def lanes(preds):
    """Predictions → (values with NaN for empty lanes, labels, the
    probability rows in label order)."""
    vals = np.array([np.nan if p.is_empty else p.score.value for p in preds])
    labels = [None if p.is_empty or p.target is None else p.target.label
              for p in preds]
    probs = [
        None if p.is_empty or p.target is None
        else [p.target.probabilities[k] for k in sorted(p.target.probabilities)]
        for p in preds
    ]
    return vals, labels, probs


def assert_same(got, ref):
    """The port's predictions against the JAX package's, in order."""
    assert len(got) == len(ref)
    gv, gl, gp = lanes(got)
    rv, rl, rp = lanes(ref)
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(rv))
    np.testing.assert_allclose(gv, rv, rtol=RTOL, atol=ATOL)
    assert gl == rl
    for a, b in zip(gp, rp):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# -- the bounded queue (tests/test_runtime.py TestBoundedQueue) -------------

TWINS = [pytest.param(jqueues, id="jax"), pytest.param(tqueues, id="port")]


@pytest.mark.parametrize("mod", TWINS)
def test_drain_fills_to_max(mod):
    q = mod.BoundedQueue(100)
    for i in range(50):
        q.put(i)
    assert q.drain(32, deadline_us=1000) == list(range(32))
    assert q.occupancy() == pytest.approx(18 / 100)


@pytest.mark.parametrize("mod", TWINS)
def test_drain_deadline_partial(mod):
    q = mod.BoundedQueue(100)
    q.put(1)
    t0 = time.monotonic()
    assert q.drain(32, deadline_us=20000) == [1]
    assert time.monotonic() - t0 < 0.5


@pytest.mark.parametrize("mod", TWINS)
def test_close_raises_when_empty(mod):
    q = mod.BoundedQueue(4)
    q.put(1)
    q.close()
    assert q.drain(4, 1000) == [1]
    with pytest.raises(mod.Closed):
        q.drain(4, 1000)


@pytest.mark.parametrize("mod", TWINS)
def test_put_times_out_when_full(mod):
    q = mod.BoundedQueue(2)
    assert q.put(1) and q.put(2)
    assert q.put(3, timeout=0.01) is False
    q.close()
    with pytest.raises(mod.Closed):
        q.put(4)


# -- sources: the port's copies replay like the JAX ones -------------------


@pytest.mark.parametrize("cycle", [False, True])
def test_in_memory_source_matches(cycle):
    recs = list(range(7))
    j = jsources.InMemorySource(recs, cycle=cycle)
    t = tsources.InMemorySource(recs, cycle=cycle)
    for n in (3, 3, 3, 5):
        assert t.poll(n) == j.poll(n)
        assert t.exhausted == j.exhausted
    j.seek(2)
    t.seek(2)
    assert t.poll(4) == j.poll(4)


def test_jsonl_file_source_and_sink(tmp_path):
    path = tmp_path / "in.jsonl"
    path.write_text("".join(json.dumps({"i": i}) + "\n" for i in range(5))
                    + '{"i": 5')  # a partial last line waits for its writer
    j = jsources.JsonlFileSource(str(path))
    t = tsources.JsonlFileSource(str(path))
    got = t.poll(10)
    assert got == j.poll(10) and [r["i"] for _, r in got] == list(range(5))
    assert t.exhausted and j.exhausted
    t.seek(got[1][0])
    assert [r["i"] for _, r in t.poll(2)] == [2, 3]
    t.close()
    j.close()
    out = tmp_path / "out.jsonl"
    sink = tsinks.JsonlFileSink(str(out))
    from flink_jpmml_tpu_torch.models.prediction import Prediction

    sink.emit([Prediction.of(1.5), Prediction.empty()])
    sink.close()
    assert [json.loads(x) for x in out.read_text().splitlines()] == [
        {"empty": False, "value": 1.5, "label": None},
        {"empty": True, "value": None, "label": None},
    ]


def test_control_source_and_fault_injection():
    ctrl = tsources.ControlSource()
    ctrl.push("a")
    ctrl.push("b")
    assert ctrl.poll(1) == [(1, "a")] and ctrl.poll(5) == [(2, "b")]
    src = tsources.FaultInjectionSource(
        tsources.InMemorySource(list(range(10))), fail_after=4)
    assert len(src.poll(4)) == 4
    with pytest.raises(RuntimeError, match="injected fault"):
        src.poll(4)


def test_batch_event_range_skips_bad_stamps():
    recs = [{"t": 5.0}, {"t": None}, {"t": 2.0}, {}, {"t": 0}]
    fn = lambda r: r["t"]  # noqa: E731 — raises KeyError on {}
    assert tsources.batch_event_range(recs, fn) == (2.0, 5.0)
    assert tsources.batch_event_range(recs, fn) == (
        jsources.batch_event_range(recs, fn))
    assert tsources.batch_event_range(recs, None) is None


# -- the static stream (tests/test_runtime.py TestStaticPipeline) -----------


def _static(kind, models, records, quick=False):
    """Run one static stream through both packages → (JAX items, port
    items, the port's environment)."""
    out = []
    for env, reader in zip(envs(), (JReader, ModelReader)):
        stream = env.from_collection(records)
        ev = (stream.quick_evaluate if quick else stream.evaluate)(
            reader(models[kind]))
        sink = ev.collect()
        env.execute(timeout=60.0)
        out.append(sink.items)
    return out[0], out[1], env


@pytest.mark.parametrize("kind", ["iris", "gbm"])
def test_vectors_end_to_end(kind, models):
    F = 4 if kind == "iris" else 6
    X = vectors(101, F)  # not a multiple of the batch: the pad path
    ref, got, env = _static(kind, models, list(X))
    assert len(got) == 101
    assert_same(got, ref)
    # the all-missing-free GBM lanes are never empty; iris's are only
    # where a record misses a field its regression needs
    backend = "rank_wire_cuda_plain" if kind == "gbm" else "f32"
    assert env.metrics.snapshot()[f"scorer_backend_{backend}"] == 1


@pytest.mark.parametrize("kind", ["iris", "gbm"])
def test_dict_records_end_to_end(kind, models):
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    fields = parse_pmml_file(models[kind]).active_fields
    X = vectors(70, len(fields), seed=3)
    ref, got, _ = _static(kind, models, dict_records(X, fields))
    assert_same(got, ref)


@pytest.mark.parametrize("kind", ["iris", "gbm"])
def test_quick_evaluate_pairs(kind, models):
    F = 4 if kind == "iris" else 6
    X = vectors(40, F, seed=1)
    recs = X.tolist()
    ref, got, _ = _static(kind, models, recs, quick=True)
    assert len(got) == 40
    assert [v for _, v in got] == recs  # each input rides beside its score
    assert_same([p for p, _ in got], [p for p, _ in ref])


def test_dirty_lanes_are_empty_not_fatal(models):
    X = vectors(10, 4, missing=0.0)
    X[3] = np.nan  # an all-missing record
    ref, got, _ = _static("iris", models, X.tolist())
    assert got[3].is_empty and not got[4].is_empty  # the stream survived
    assert_same(got, ref)


def test_metrics_populated(models):
    env = StreamEnvironment(
        RuntimeConfig(batch=BatchConfig(size=B, deadline_us=2000)),
        device="cpu")
    env.from_collection(vectors(64, 4).tolist()).evaluate(
        ModelReader(models["iris"])).collect()
    env.execute(timeout=30.0)
    snap = env.metrics.snapshot()
    assert snap["records_in"] == 64 and snap["records_out"] == 64
    assert snap["batches"] >= 2 and snap["batch_fill_records"] == 64
    assert "record_latency_s_p50" in snap
    for stage in ("featurize_dispatch", "readback", "sink"):
        assert snap[f"stage_{stage}_s"] > 0


def test_scoring_error_stops_the_stream(models):
    """Fail fast (no DLQ): a record the extractor cannot take kills the
    pipeline, and ``execute`` re-raises it."""
    env = StreamEnvironment(
        RuntimeConfig(batch=BatchConfig(size=B, deadline_us=2000)),
        device="cpu")
    bad = [[1.0, 2.0, 3.0, 4.0], [1.0, 2.0]]  # ragged: no dense batch
    env.from_collection(bad).evaluate(ModelReader(models["iris"])).collect()
    with pytest.raises(ValueError):
        env.execute(timeout=30.0)


def test_pipeline_stop_is_prompt(models):
    """A cycling (unbounded) source runs until ``stop``."""
    env = StreamEnvironment(
        RuntimeConfig(batch=BatchConfig(size=B, deadline_us=2000)),
        device="cpu")
    sink = env.from_collection(vectors(8, 4).tolist(), cycle=True).evaluate(
        ModelReader(models["iris"])).collect()
    env.start()
    deadline = time.monotonic() + 20.0
    while len(sink) < 200 and time.monotonic() < deadline:
        time.sleep(0.01)
    t0 = time.monotonic()
    env.stop()
    assert len(sink) >= 200 and time.monotonic() - t0 < 10.0


# -- the rank wire on the record path (TestQuantizedScorerPath) -------------


def test_static_scorer_uses_rank_wire_for_gbm(models, monkeypatch):
    from flink_jpmml_tpu.compile import compile_pmml as jcompile
    from flink_jpmml_tpu.pmml import parse_pmml_file as jparse
    from flink_jpmml_tpu.runtime.engine import StaticScorer as JStatic
    from flink_jpmml_tpu_torch.compile import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    cm = compile_pmml(parse_pmml_file(models["gbm"]), batch_size=B,
                      device="cpu")
    s_q, s_f = StaticScorer(cm), StaticScorer(cm, use_quantized=False)
    assert s_q._q is not None and s_f._q is None
    assert (s_q.backend, s_f.backend) == ("rank_wire_cuda_plain", "f32")
    rng = np.random.default_rng(0)
    records = [
        {f"f{j}": float(v) for j, v in enumerate(row) if j % 5 != 3}
        for row in rng.normal(size=(17, 6))
    ]
    calls = []
    plain = qtrees_cuda.leaf_rows_reference
    monkeypatch.setattr(qtrees_cuda, "leaf_rows_reference",
                        lambda *a: calls.append(1) or plain(*a))
    got = s_q.finish(s_q.submit(records))
    assert len(calls) == 1  # one dispatch, one run of the kernel's plain version
    exp = s_f.finish(s_f.submit(records))
    assert len(got) == len(exp) == 17
    for a, b in zip(got, exp):
        assert abs(a.score.value - b.score.value) < 1e-3
    js = JStatic(jcompile(jparse(models["gbm"]), batch_size=B))
    assert_same(got, js.finish(js.submit(records)))


# -- ModelReader and its verify gate (tests/test_verification.py) -----------


@pytest.mark.parametrize("case", sorted(tv.DOCS))
def test_reader_verify_gate_matches_the_jax_package(case, tmp_path):
    xml, n_problems = tv.DOCS[case]
    path = tmp_path / f"{case}.pmml"
    path.write_text(xml)
    clear_model_cache()
    jclear()
    if n_problems:
        with pytest.raises(ModelVerificationException) as got:
            ModelReader(str(path)).load(device="cpu")
        with pytest.raises(Exception) as ref:
            JReader(str(path)).load()
        assert type(ref.value).__name__ == "ModelVerificationException"
        assert str(got.value) == str(ref.value)
        # an explicit opt-out still loads (operator override), and the
        # cached model does not bypass the gate on the next load
        cm = ModelReader(str(path)).load(verify=False, device="cpu")
        assert len(cm.verify()) == n_problems
        with pytest.raises(ModelVerificationException):
            ModelReader(str(path)).load(device="cpu")
    else:
        cm = ModelReader(str(path)).load(device="cpu")
        assert cm.has_verification and cm.verify() == []


def test_reader_cache_is_keyed_by_device_and_path(models, tmp_path):
    clear_model_cache()
    r = ModelReader(models["iris"])
    a = r.load(batch_size=B, device="cpu")
    assert r.load(batch_size=B, device="cpu") is a
    assert r.load(batch_size=8, device="cpu") is not a
    assert ModelReader("file://" + models["iris"]).load(
        batch_size=B, device="cpu") is a
    from flink_jpmml_tpu_torch.utils.exceptions import ModelLoadingException

    with pytest.raises(ModelLoadingException):
        ModelReader(str(tmp_path / "missing.pmml")).load(device="cpu")


# -- the options the port does not carry, and the ones recovery lifted -----

# cut in earlier slices and lifted by the recovery slice: each case now
# builds (and, where it can, runs) the option and checks that it took
LIFTED = frozenset((
    "pipeline_checkpoint", "pipeline_dlq", "pipeline_restore",
    "with_checkpointing", "execute_restore", "start_restore",
    "checkpoint_dir", "scorer_device_retry",
    # the serving edge
    "reader_remote", "scorer_admission", "scorer_lane_fn", "scorer_batcher",
    # multi-tenant and stateful scoring
    "pipeline_tenant", "static_state", "scorer_zoo",
    # the parallel plane
    "reader_mesh", "registry_mesh", "scorer_mesh",
))


def _ckpt_files(d):
    import os

    return [n for n in os.listdir(d) if n.startswith("ckpt-")]


def _cut_cases(tmp="."):
    import os

    from flink_jpmml_tpu_torch.models.control import RolloutMessage
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.runtime.dlq import DeadLetterQueue
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.registry import ModelRegistry
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    def env():
        return StreamEnvironment(device="cpu")

    def stream(path):
        return env().from_collection([[0.0] * 4]).evaluate(ModelReader(path))

    def pipe(**kw):
        return lambda p: Pipeline(
            tsources.InMemorySource([]), StaticScorer(
                ModelReader(p).load(device="cpu")), tsinks.NullSink(), **kw)

    def dyn(**kw):
        return lambda p: DynamicScorer(ControlSource(), batch_size=8,
                                       device="cpu", **kw)

    def cpu_mesh():
        from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices, make_mesh

        return make_mesh(devices=cpu_devices(2))

    def reader_mesh(p):
        m = ModelReader(p).load(batch_size=8, mesh=cpu_mesh())
        assert m.batch_divisor == 2 and m.quantized_scorer() is None

    def registry_mesh(p):
        from flink_jpmml_tpu_torch.models.control import AddMessage
        from flink_jpmml_tpu_torch.models.core import ModelId

        reg = ModelRegistry(batch_size=8, mesh=cpu_mesh())
        reg.apply(AddMessage("m", 1, p, 1.0))
        assert reg.device.type == "cpu"
        assert reg.model(ModelId("m", 1)).mesh == cpu_mesh()

    def scorer_mesh(p):
        s = DynamicScorer(ControlSource(), batch_size=8, mesh=cpu_mesh(),
                          default_reader=ModelReader(p))
        assert s.device.type == "cpu"
        assert s._default_model.mesh == cpu_mesh()

    def registry_apply(p):
        ModelRegistry(device="cpu").apply(RolloutMessage(
            "m", 2, "canary", 1.0, path=p))

    def pipeline_tenant(p):
        assert pipe(tenant="t")(p)._tenant == "t"

    def static_state(p):
        # keyed state rides the rank wire, which the f32 iris model lacks
        from flink_jpmml_tpu_torch.runtime.state import StateSpec
        from flink_jpmml_tpu_torch.utils.exceptions import (
            InputValidationException,
        )

        with pytest.raises(InputValidationException):
            StaticScorer(ModelReader(p).load(device="cpu"),
                         state=StateSpec(capacity=8))

    def scorer_zoo(p):
        from flink_jpmml_tpu_torch.serving.zoo import ZooManager

        assert isinstance(dyn(zoo=True)(p)._zoo, ZooManager)

    def pipeline_checkpoint(p):
        pipe(checkpoint=CheckpointManager(tmp))(p).run_until_exhausted(10)
        assert _ckpt_files(tmp)  # the clean drain saved one

    def pipeline_dlq(p):
        pl = pipe(dlq=DeadLetterQueue(os.path.join(tmp, "dlq")))(p)
        assert pl._dlq is not None and pl._devfault_armed

    def pipeline_restore(p):
        assert pipe()(p).restore() is False  # no checkpoint to resume

    def with_checkpointing(p):
        e = env()
        e.from_collection([[0.0] * 4]).evaluate(
            ModelReader(p)).with_checkpointing(tmp).collect()
        e.execute(timeout=10)
        assert _ckpt_files(tmp)

    def execute_restore(p):
        e = env()
        e.from_collection([[0.0] * 4]).evaluate(
            ModelReader(p)).with_checkpointing(tmp).collect()
        e.execute(restore=True, timeout=10)
        assert _ckpt_files(tmp)

    def start_restore(p):
        e = env()
        e.from_collection([[0.0] * 4]).evaluate(
            ModelReader(p)).with_checkpointing(tmp).collect()
        e.start(restore=True)
        e.stop()

    def checkpoint_dir(p):
        e = StreamEnvironment(RuntimeConfig(checkpoint_dir=tmp),
                              device="cpu")
        e.from_collection([[0.0] * 4]).evaluate(ModelReader(p)).collect()
        e.execute(timeout=10)
        assert _ckpt_files(tmp)

    def scorer_device_retry(p):
        assert dyn(device_retry=True)(p)._device_retry is True

    def reader_remote(p):
        # gs:// and s3:// without their optional dependency: the typed
        # error of api/remote.py, as in the JAX package
        from flink_jpmml_tpu_torch.utils.exceptions import (
            ModelLoadingException,
        )

        with pytest.raises(ModelLoadingException, match="boto3"):
            ModelReader("s3://bucket/m.pmml").load()

    def scorer_admission(p):
        from flink_jpmml_tpu_torch.serving.overload import (
            AdmissionController,
        )
        from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

        adm = AdmissionController(MetricsRegistry())
        assert dyn(admission=adm)(p).admission is adm

    def scorer_lane_fn(p):
        assert dyn(lane_fn=str)(p)._lane_fn is str

    def scorer_batcher(p):
        from flink_jpmml_tpu_torch.serving.overload import AdaptiveBatcher

        b = AdaptiveBatcher(path=os.path.join(tmp, "cap.json"))
        assert dyn(batcher=b)(p).batcher is b

    return {
        "pipeline_checkpoint": pipeline_checkpoint,
        "pipeline_dlq": pipeline_dlq,
        "pipeline_tenant": pipeline_tenant,
        "pipeline_restore": pipeline_restore,
        "with_checkpointing": with_checkpointing,
        "execute_restore": execute_restore,
        "start_restore": start_restore,
        "checkpoint_dir": checkpoint_dir,
        "static_state": static_state,
        "evaluate_guardrails": lambda p: env().from_collection([]).evaluate(
            ModelReader(p), guardrails=object()),
        "evaluate_key_fn": lambda p: env().from_collection([]).evaluate(
            ModelReader(p), key_fn=str),
        "reader_mesh": reader_mesh,
        "reader_remote": reader_remote,
        "registry_mesh": registry_mesh,
        "registry_rollout": registry_apply,
        "scorer_mesh": scorer_mesh,
        "scorer_key_fn": dyn(key_fn=str),
        "scorer_guardrails": dyn(guardrails=object()),
        "scorer_auto_rollout": dyn(auto_rollout=False),
        "scorer_admission": scorer_admission,
        "scorer_lane_fn": scorer_lane_fn,
        "scorer_batcher": scorer_batcher,
        "scorer_zoo": scorer_zoo,
        "scorer_device_retry": scorer_device_retry,
    }


CUTS = sorted(_cut_cases())


@pytest.mark.parametrize("cut", CUTS)
def test_cut_option_raises_not_ported(cut, models, tmp_path):
    case = _cut_cases(str(tmp_path))[cut]
    if cut in LIFTED:
        case(models["iris"])  # accepted now, and its checks hold
        return
    with pytest.raises(NotPortedError):
        case(models["iris"])


def test_failover_env_raises_not_ported(models, monkeypatch):
    # lifted by the recovery slice: FJT_FAILOVER arms the record
    # engine's device-fault ladder instead of raising
    monkeypatch.setenv("FJT_FAILOVER", "1")
    pl = Pipeline(tsources.InMemorySource([]), StaticScorer(
        ModelReader(models["iris"]).load(device="cpu")),
        tsinks.NullSink())
    assert pl._devfault_armed and pl._dlq is None


# -- utils/profiling.py ------------------------------------------------------


def test_stage_timer_books_counters_like_the_jax_one():
    from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JRegistry
    from flink_jpmml_tpu.utils.profiling import StageTimer as JTimer
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry
    from flink_jpmml_tpu_torch.utils.profiling import StageTimer

    for Timer, Registry in ((JTimer, JRegistry), (StageTimer, MetricsRegistry)):
        timer = Timer(Registry())
        with timer.stage("sink"):
            time.sleep(0.002)
        with pytest.raises(KeyError):
            with timer.stage("sink"):
                raise KeyError("booked all the same")
        assert timer.metrics.snapshot()["stage_sink_s"] >= 0.002


def test_trace_and_annotate_on_torch_profiler(tmp_path):
    import torch

    from flink_jpmml_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("featurize"):
            torch.ones(8).sum()
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") == "featurize" for e in doc["traceEvents"])
