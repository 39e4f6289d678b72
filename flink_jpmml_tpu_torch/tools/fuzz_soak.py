"""Extended fuzz soak: arbitrary seed ranges over the random-model
generators, and the chaos soaks, on the card unless the caller asks for
the CPU.

The port's twin of the JAX repo's ``tools/fuzz_soak.py``. The pytest
suite pins fixed seed ranges (tests/test_torch_fuzz.py); this tool
reuses the same generators (``tools/fuzzgen.py``) and the same
lane-by-lane compiled-vs-oracle assertion, but sweeps as many seeds as a
soak budget allows. Usage::

    python -m flink_jpmml_tpu_torch.tools.fuzz_soak
        [--families trees,mining,regression,neural,glm,scorecard,sarima]
        [--seeds 50] [--start 100000]
        [--chaos [--zoo | --stateful | --mesh]] [--platform cpu|gpu|cuda]

It prints one ``<family>: N/N seeds clean in Xs`` line per family (or
``<profile>: N/N seeds clean in Xs`` for a chaos profile) and exits 1 on
any failed seed (the seed is in the ``FAIL`` line: replay it with
``--start <seed> --seeds 1``), 2 on an unknown family.

The profiles, each ported over the port's own modules:

- families: ``compile_pmml(doc, device=)`` → ``score_records`` against
  the oracle ``pmml/interp.evaluate``;
- ``--chaos``: a seeded composition of faults against a
  ``KafkaBlockSource`` → ``BlockPipeline`` stream with checkpoints and
  the DLQ: every offset reaches the sink or the DLQ, poison lands in the
  DLQ exactly, device faults land nowhere. :func:`soak_chaos` takes the
  compiled model (default: ``gen_gbm(n_trees=4, depth=3,
  n_features=5)`` at compile batch 32), and the stream's width and batch
  follow it;
- ``--zoo``: tenant churn and device faults against a zoo-enabled
  ``DynamicScorer`` (its packs launch ``qtrees_leaf_rows_packed`` on the
  card);
- ``--stateful``: SIGKILLed subprocess workers over a keyed state table;
- ``--mesh``: ``chip_loss`` on a degraded mesh of at least four devices.

What differs from the JAX tool:

- The device is the port's: ``--platform`` (or ``FJT_PLATFORM``) through
  ``utils/demo.platform_device``; the card by default, the CPU only on
  request, ``DeviceUnavailableError`` without a card. Nothing falls back
  to the CPU.
- ``--mesh`` builds its mesh over ``cpu:0`` … ``cpu:7`` with ``--platform
  cpu`` (the port's rule for CPU meshes, ``parallel/mesh.py``), else over
  every card; with fewer than four cards it raises
  ``DeviceUnavailableError`` naming the count before any seed runs (the
  JAX tool's assertion fails each seed instead).
- ``--chaos`` and ``--stateful`` raise ``FJT_DEVICE_RETRIES`` to their
  menus' longest ``device_error`` streak (9 and 5). The JAX ladder serves
  a streak past its two retries from the XLA host tier; the port's rank
  wire has no host tier (``serving/failover.FallbackTier``), so the
  ladder re-dispatches until the streak clears. The draws, the menus and
  the contract (device faults land nowhere) are the JAX tool's.
- The stateful worker runs on the soak's device; the JAX worker pins
  itself to JAX's CPU. Each incarnation on the card pays a worker's cold
  start (torch import, CUDA context, compile: 9.8–27.6 s on an H100), so
  a life's deadline grows by ``WORKER_START_S`` an incarnation.
- The soak's knobs (``FJT_RETRY_BASE_S``, the breaker's geometry, the
  retries) are set around each seed and restored after it, so a caller's
  process keeps its own environment.
- Each profile's function returns what it measured (families: the
  largest absolute value error against the oracle; chaos profiles: the
  delivery counts), for callers that report them.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from flink_jpmml_tpu_torch.tools import fuzzgen as fg

# the repo root (the package's parent): the stateful worker imports the
# package from there
_ROOT = str(pathlib.Path(__file__).resolve().parent.parent.parent)

# the longest device_error streak of each profile's menu (n < 10 and
# n < 6): the rank wire's ladder re-dispatches through it
CHAOS_DEVICE_RETRIES = 9
STATE_DEVICE_RETRIES = 5
# a card worker's cold start, spawn to scoring (9.8–27.6 s on an H100)
WORKER_START_S = 30.0


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- the parity families -----------------------------------------------------


def soak_trees(seed, device):
    rng = np.random.default_rng(seed)
    doc = fg.make_doc(fg.rand_tree_model(rng))
    recs = fg.rand_records(rng, 64)
    return fg.assert_parity(doc, recs, f"tree seed={seed}", device)


def soak_mining(seed, device):
    rng = np.random.default_rng(seed)
    model = fg.rand_mining_model(rng)
    doc = fg.make_doc(model)
    recs = fg.rand_records(rng, 32)
    method = model.segmentation.multiple_model_method
    return fg.assert_parity(doc, recs, f"mining {method} seed={seed}",
                            device)


def soak_regression(seed, device):
    rng = np.random.default_rng(seed)
    doc = fg.make_doc(fg.rand_regression_model(rng))
    recs = fg.rand_records(rng, 64)
    return fg.assert_parity(doc, recs, f"regression seed={seed}", device)


def soak_neural(seed, device):
    rng = np.random.default_rng(seed)
    doc = fg.make_doc(fg.rand_nn_model(rng))
    recs = fg.rand_records(rng, 64)
    return fg.assert_parity(doc, recs, f"neural seed={seed}", device)


def soak_glm(seed, device):
    rng = np.random.default_rng(seed)
    doc = fg.make_doc(fg.rand_glm_model(rng))
    recs = fg.rand_records(rng, 64)
    return fg.assert_parity(doc, recs, f"glm seed={seed}", device)


def soak_scorecard(seed, device):
    rng = np.random.default_rng(seed)
    doc = fg.make_doc(fg.rand_scorecard_model(rng))
    recs = fg.rand_records(rng, 40)
    return fg.assert_parity(doc, recs, f"scorecard seed={seed}", device)


def soak_sarima(seed, device):
    rng = np.random.default_rng(seed)
    doc = fg.rand_sarima_doc(rng)
    recs = fg.rand_sarima_records(rng, 24)
    return fg.assert_parity(doc, recs, f"sarima seed={seed}", device)


FAMILIES: Dict[str, Callable] = {
    "trees": soak_trees,
    "mining": soak_mining,
    "regression": soak_regression,
    "neural": soak_neural,
    "glm": soak_glm,
    "scorecard": soak_scorecard,
    "sarima": soak_sarima,
}


# -- --chaos: one compiled model shared across every seed (the chaos is in
# the FAULT composition, not the model) ---------------------------------------

_CHAOS_MODELS: dict = {}


def chaos_model(device):
    """``gen_gbm(n_trees=4, depth=3, n_features=5)`` at compile batch 32
    on ``device``, built once a process and device."""
    import torch

    key = str(torch.device(device))
    if key not in _CHAOS_MODELS:
        from flink_jpmml_tpu_torch.assets_gen import gen_gbm
        from flink_jpmml_tpu_torch.compile import compile_pmml
        from flink_jpmml_tpu_torch.pmml import parse_pmml_file

        tmp = tempfile.mkdtemp(prefix="fjt-chaos-model-")
        try:
            _CHAOS_MODELS[key] = compile_pmml(
                parse_pmml_file(
                    gen_gbm(tmp, n_trees=4, depth=3, n_features=5)),
                batch_size=32, device=device,
            )
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return _CHAOS_MODELS[key]


def _coverage(emitted, total: int) -> np.ndarray:
    covered = np.zeros(total, np.int64)
    for off, n in emitted:
        covered[off: off + n] += 1
    return covered


def _drive_kafka(cm, broker, topic: str, tmp: str, spec: list, total: int,
                 timeout_s: float, mesh=None):
    """Arm the faults of ``spec``, then run a ``KafkaBlockSource`` over
    ``topic`` into a checkpointed ``BlockPipeline`` with its DLQ (batch:
    the model's compile batch, up to 4 a dispatch) until ``total``
    offsets commit, the pipeline dies or ``timeout_s`` passes → (the
    sink's (first offset, n) runs, the DLQ, the registry, the pipeline's
    error)."""
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.block import BlockPipeline
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.runtime.dlq import DeadLetterQueue
    from flink_jpmml_tpu_torch.runtime.kafka import KafkaBlockSource
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    emitted = []
    m = MetricsRegistry()
    dlq = DeadLetterQueue(os.path.join(tmp, "ck", "dlq"), metrics=m)
    src = KafkaBlockSource(
        broker.host, broker.port, topic, n_cols=cm.field_space.arity,
        max_wait_ms=10, metrics=m, dlq=dlq,
    )
    pipe, done = None, False
    try:
        assert faults.install_from_env(",".join(spec)), spec
        pipe = BlockPipeline(
            src, cm, lambda out, n, first_off: emitted.append((first_off, n)),
            RuntimeConfig(
                batch=BatchConfig(size=cm.batch_size, deadline_us=1000),
                checkpoint_interval_s=0.05,
            ),
            metrics=m,
            checkpoint=CheckpointManager(os.path.join(tmp, "ck")),
            dlq=dlq,
            max_dispatch_chunks=4,
            mesh=mesh,
        )
        pipe.start()
        deadline = time.perf_counter() + timeout_s
        while (
            pipe.committed_offset < total
            and pipe._error is None
            and time.perf_counter() < deadline
        ):
            time.sleep(0.01)
        pipe.stop()
        pipe.join(timeout=20.0)
        done = True
        return emitted, dlq, m, pipe._error
    finally:
        if pipe is not None and not done:
            try:
                pipe.stop()
                pipe.join(timeout=10.0)
            except Exception:
                pass
        src.close()


def soak_chaos(seed, device, model=None) -> dict:
    """One chaos iteration: a seeded random COMPOSITION of fault kinds
    (broker death, slow fetch, dispatch delay, checkpoint failure, worker
    wedge, poison records, decode poison, device faults — everything
    except ``worker_crash`` and ``chip_loss``, which would kill the soak
    process itself) against a real Kafka → ``BlockPipeline`` stream with
    checkpoints and the DLQ. Verifies the delivery contract every time:
    every offset either reaches the sink or sits in the DLQ, poison lands
    in the DLQ exactly, device faults land nowhere (an injected
    ``device_error`` classifies as transient, ``runtime/devfault.py``,
    and the ladder re-dispatches it), and the stream drains to the end.

    ``model``: a compiled model with a fixed batch (default
    :func:`chaos_model`); the stream's width is its field count and the
    pipeline's batch its compile batch. → the delivery counts."""
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.kafka import MiniKafkaBroker

    rng = np.random.default_rng(seed)
    cm = model if model is not None else chaos_model(device)
    N = 1500
    data = rng.normal(0, 1.0, size=(N, cm.field_space.arity)).astype(
        np.float32)
    tmp = tempfile.mkdtemp(prefix="fjt-chaos-")
    broker = MiniKafkaBroker(topic="chaos")
    try:
        # interleave decode poison at random positions
        decode_offsets = []
        positions = sorted(
            int(p) for p in rng.choice(
                N, size=int(rng.integers(0, 3)), replace=False,
            )
        )
        produced = 0
        for p in positions:
            broker.append_rows(data[produced:p])
            decode_offsets.append(broker.append(b"chaff"))
            produced = p
        broker.append_rows(data[produced:])
        total = N + len(decode_offsets)
        # score poison via the harness, offsets in the log domain
        score_poison = []
        for _ in range(int(rng.integers(0, 3))):
            o = int(rng.integers(0, total))
            while o in decode_offsets or o in score_poison:
                o = (o + 1) % total
            score_poison.append(o)
        spec = [f"poison_record:offset={o}" for o in score_poison]
        menu = [
            f"slow_fetch:delay_ms=2:p=0.05:seed={seed}",
            f"broker_death:n={int(rng.integers(1, 3))}"
            f":p=0.02:seed={seed}",
            f"dispatch_delay:delay_ms=1:p=0.05:seed={seed}",
            f"checkpoint_fail:n={int(rng.integers(1, 3))}",
            "worker_wedge:wedge_s=0.05:n=1",
            # device kinds: error streaks exercise redispatch and the
            # breaker, OOM streaks the batch-size bisection
            f"device_error:site=device_readback"
            f":n={int(rng.integers(2, 10))}",
            f"device_oom:site=device_dispatch"
            f":n={int(rng.integers(1, 4))}",
        ]
        picks = rng.choice(
            len(menu), size=int(rng.integers(1, len(menu) + 1)),
            replace=False,
        )
        spec += [menu[i] for i in picks]
        with _env(FJT_RETRY_BASE_S="0.01",
                  # fast breaker geometry: a device_error streak completes
                  # its open → half-open → closed cycle within one seed
                  FJT_FAILOVER_COOLDOWN_S="0.1", FJT_FAILOVER_GREENS="1",
                  FJT_DEVICE_RETRIES=str(CHAOS_DEVICE_RETRIES)):
            emitted, dlq, m, err = _drive_kafka(
                cm, broker, "chaos", tmp, spec, total, 60.0)
        covered = _coverage(emitted, total)
        quarantined = sorted(set(dlq.offsets()))
        expected = sorted(set(decode_offsets) | set(score_poison))
        assert quarantined == expected, (
            f"chaos seed={seed}: DLQ {quarantined} != {expected} "
            f"(spec {spec}; pipeline error {err!r})"
        )
        missing = sorted(int(o) for o in np.flatnonzero(covered == 0))
        assert missing == expected, (
            f"chaos seed={seed}: sink gaps {missing[:10]} != "
            f"quarantined {expected} (spec {spec}; pipeline error {err!r})"
        )
        c = m.struct_snapshot()["counters"]
        return {
            "seed": seed, "records": total,
            "delivered": int((covered > 0).sum()),
            "delivered_twice": int((covered > 1).sum()),
            "dlq": len(quarantined), "spec": spec,
            "faults_fired": faults.stats(),
            "redispatch_records": int(c.get("redispatch_records", 0)),
            "oom_shrinks": int(c.get("oom_shrinks", 0)),
        }
    finally:
        faults.clear()
        broker.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- --chaos --mesh ---------------------------------------------------------

MESH_MIN_DEVICES = 4


def mesh_devices(device) -> list:
    """The devices a mesh soak spans: ``cpu:0`` … ``cpu:7`` for the CPU,
    every card otherwise; raises ``DeviceUnavailableError`` naming the
    count when there are fewer than four."""
    import torch

    from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices
    from flink_jpmml_tpu_torch.utils.exceptions import DeviceUnavailableError

    if torch.device(device).type == "cpu":
        return cpu_devices(8)
    n = torch.cuda.device_count()
    if n < MESH_MIN_DEVICES:
        raise DeviceUnavailableError(
            f"mesh chaos needs >= {MESH_MIN_DEVICES} devices, found {n} "
            f"card(s); run on a host with {MESH_MIN_DEVICES} or more, or "
            f"pass --platform cpu for the mesh of cpu:0 ... cpu:7"
        )
    return [torch.device("cuda", i) for i in range(n)]


def soak_mesh_chaos(seed, device) -> dict:
    """One MESH chaos iteration: ``chip_loss`` — survivable on a mesh,
    since the ``chip_loss`` rung rebuilds over the surviving data rows in
    place — composed with kafka-side weather (slow fetch, broker death,
    dispatch delay) against a mesh-sharded Kafka → ``BlockPipeline``
    stream. Verifies degraded-mesh mode under churn: every offset reaches
    the sink exactly once, the DLQ stays EMPTY (a dead chip never
    quarantines records), and every injected chip loss performed a
    rebuild."""
    from flink_jpmml_tpu_torch.parallel.mesh import make_mesh, physical
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.kafka import MiniKafkaBroker
    from flink_jpmml_tpu_torch.utils.config import MeshConfig

    devs = mesh_devices(device)
    mesh = make_mesh(
        MeshConfig(data=4, model=2 if len(devs) >= 8 else 1),
        devices=devs, allow_subset=True,
    )
    rng = np.random.default_rng(seed)
    cm = chaos_model(physical(mesh.primary))
    N = 1504  # divides by 32; the mesh pad keeps partials dispatchable
    data = rng.normal(0, 1.0, size=(N, cm.field_space.arity)).astype(
        np.float32)
    tmp = tempfile.mkdtemp(prefix="fjt-meshchaos-")
    broker = MiniKafkaBroker(topic="meshchaos")
    try:
        broker.append_rows(data)
        # chip loss is the profile's anchor; width 4 survives two
        losses = int(rng.integers(1, 3))
        spec = [f"chip_loss:n={losses}"]
        menu = [
            f"slow_fetch:delay_ms=2:p=0.05:seed={seed}",
            f"broker_death:n={int(rng.integers(1, 3))}"
            f":p=0.02:seed={seed}",
            f"dispatch_delay:delay_ms=1:p=0.05:seed={seed}",
        ]
        picks = rng.choice(
            len(menu), size=int(rng.integers(1, len(menu) + 1)),
            replace=False,
        )
        spec += [menu[i] for i in picks]
        with _env(FJT_RETRY_BASE_S="0.01"):
            emitted, dlq, m, err = _drive_kafka(
                cm, broker, "meshchaos", tmp, spec, N, 120.0, mesh=mesh)
        assert err is None, f"mesh chaos seed={seed}: died {err!r}"
        covered = _coverage(emitted, N)
        assert (covered == 1).all(), (
            f"mesh chaos seed={seed}: coverage "
            f"min={covered.min()} max={covered.max()} (spec {spec})"
        )
        assert sorted(set(dlq.offsets())) == [], (
            f"mesh chaos seed={seed}: chip loss quarantined records"
        )
        fired = faults.stats().get("chip_loss", 0)
        c = m.struct_snapshot()["counters"]
        assert c.get("mesh_rebuilds", 0) >= fired >= 1, (
            f"mesh chaos seed={seed}: {fired} chip losses but "
            f"{c.get('mesh_rebuilds', 0)} rebuilds (spec {spec})"
        )
        return {"seed": seed, "records": N, "delivered": N,
                "chip_losses": int(fired),
                "mesh_rebuilds": int(c.get("mesh_rebuilds", 0)),
                "spec": spec}
    finally:
        faults.clear()
        broker.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- --chaos --zoo ----------------------------------------------------------

_ZOO_DOCS: List[str] = []


def zoo_docs() -> List[str]:
    """Six tiny distinct GBMs, built once a soak process (the chaos seeds
    churn tenants, not documents)."""
    if not _ZOO_DOCS:
        from flink_jpmml_tpu_torch.assets_gen import gen_gbm

        tmp = tempfile.mkdtemp(prefix="fjt-zoochaos-docs-")
        _ZOO_DOCS.extend(
            gen_gbm(tmp, n_trees=4 + i, depth=3, n_features=4,
                    seed=70 + i, name=f"zc{i}")
            for i in range(6)
        )
    return _ZOO_DOCS


def soak_zoo_chaos(seed, device) -> dict:
    """One ZOO chaos iteration: seeded tenant churn (Del / re-Add /
    version bump) composed with device faults against a zoo-enabled
    ``DynamicScorer``. Verifies the per-tenant delivery contract every
    round: every submitted record gets exactly one prediction, live
    tenants' lanes are non-empty (a device fault mid-pack redispatches,
    never surfaces) and churned-out tenants' lanes are empty, never
    misrouted to a packmate."""
    from flink_jpmml_tpu_torch.models.control import AddMessage, DelMessage
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    rng = np.random.default_rng(seed)
    docs = zoo_docs()
    tenants = [f"zc{i}" for i in range(len(docs))]
    fields = [f"f{j}" for j in range(4)]
    data = rng.normal(0, 1.2, size=(4096, 4)).astype(np.float32)
    data[rng.random(size=data.shape) < 0.02] = np.nan

    with _env(FJT_RETRY_BASE_S="0.01"):
        ctrl = ControlSource()
        sc = DynamicScorer(control=ctrl, batch_size=128, auto_rollout=False,
                           zoo=True, device=device)
    version = {}
    served = {}  # name -> every version currently registered: a Del
    # must cover ALL of them — deleting only the newest correctly falls
    # back to the older served version (latest-wins), which is not "dead"
    for i, name in enumerate(tenants):
        version[name] = 1
        served[name] = {1}
        ctrl.push(AddMessage(name, 1, docs[i], timestamp=time.time()))
    sc._drain_control()
    live = set(tenants)

    def wait_live(timeout_s=120.0):
        deadline = time.monotonic() + timeout_s
        for name in sorted(live):
            mid = ModelId(name, version[name])
            while sc.registry.model_if_warm(mid) is None:
                err = sc.registry.warm_error(mid)
                assert err is None, (
                    f"zoo chaos seed={seed}: {mid.key()} warm "
                    f"failed {err!r}"
                )
                assert time.monotonic() < deadline, (
                    f"zoo chaos seed={seed}: {mid.key()} never warmed"
                )
                time.sleep(0.005)

    wait_live()
    cursor = 0
    scored = live_lanes = dead_lanes = 0
    try:
        with _env(FJT_RETRY_BASE_S="0.01"):
            for rnd in range(8):
                # seeded churn between rounds: Del a live tenant, revive a
                # dead one, or bump a live tenant's version (same document:
                # the swap re-packs, the outputs stay total)
                act = rng.integers(0, 4)
                if act == 0 and len(live) > 2:
                    victim = sorted(live)[int(rng.integers(0, len(live)))]
                    # "dead" means NO version remains, so the Del covers
                    # every version ever registered
                    for v in sorted(served[victim]):
                        ctrl.push(DelMessage(victim, v,
                                             timestamp=time.time()))
                    served[victim] = set()
                    live.discard(victim)
                elif act == 1 and len(live) < len(tenants):
                    dead = sorted(set(tenants) - live)
                    name = dead[int(rng.integers(0, len(dead)))]
                    version[name] += 1
                    served[name].add(version[name])
                    ctrl.push(AddMessage(
                        name, version[name], docs[tenants.index(name)],
                        timestamp=time.time(),
                    ))
                    live.add(name)
                elif act == 2:
                    name = sorted(live)[int(rng.integers(0, len(live)))]
                    version[name] += 1
                    served[name].add(version[name])
                    ctrl.push(AddMessage(
                        name, version[name], docs[tenants.index(name)],
                        timestamp=time.time(),
                    ))
                sc._drain_control()
                wait_live()
                if rng.random() < 0.6:
                    # readback site only: the record-path scorer's ladder
                    # lives in finish() (classify → redispatch); streaks
                    # stay within the FJT_DEVICE_RETRIES budget (2): the
                    # record path has no tier below the retry ladder, so a
                    # longer streak escalates by contract
                    kind = ("device_error", "device_oom")[
                        int(rng.integers(0, 2))
                    ]
                    faults.inject(kind, site="device_readback",
                                  n=int(rng.integers(1, 3)))
                rows = int(rng.integers(8, 64))
                ev, owner = [], []
                for name in tenants:
                    for _ in range(rows):
                        rec = dict(zip(
                            fields, data[cursor % len(data)].tolist()
                        ))
                        rec["_key"] = f"k{cursor}"
                        cursor += 1
                        ev.append((name, rec))
                        owner.append(name)
                out = sc.finish(sc.submit(ev))
                assert len(out) == len(ev), (
                    f"zoo chaos seed={seed} round={rnd}: "
                    f"{len(out)} predictions for {len(ev)} records"
                )
                for (p, _), name in zip(out, owner):
                    if name in live:
                        assert not p.is_empty, (
                            f"zoo chaos seed={seed} round={rnd}: live "
                            f"tenant {name} got an empty lane"
                        )
                        live_lanes += 1
                    else:
                        assert p.is_empty, (
                            f"zoo chaos seed={seed} round={rnd}: dead "
                            f"tenant {name} got a prediction (misrouted "
                            "packmate output)"
                        )
                        dead_lanes += 1
                scored += len(ev)
        c = sc.metrics.struct_snapshot()["counters"]
        return {"seed": seed, "records": scored, "live_lanes": live_lanes,
                "dead_lanes": dead_lanes,
                "pack_dispatches": int(c.get("pack_dispatches", 0)),
                "faults_fired": faults.stats()}
    finally:
        faults.clear()


# -- --chaos --stateful: the keyed-state profile. The worker is a SUBPROCESS
# (unlike soak_chaos) because the profile's crash axis is real SIGKILLs —
# parent kills at seeded committed-offset targets plus in-worker
# ``worker_crash`` weather — and the parity claim is about what survives
# them. One tiny GBM a soak process, like chaos_model. ------------------------

_STATE_PMML: List[str] = []


def state_chaos_pmml() -> str:
    if not _STATE_PMML:
        from flink_jpmml_tpu_torch.assets_gen import gen_gbm

        tmp = tempfile.mkdtemp(prefix="fjt-statechaos-model-")
        _STATE_PMML.append(gen_gbm(tmp, n_trees=4, depth=3, n_features=5))
    return _STATE_PMML[0]


STATE_CHAOS_WORKER = r'''
import os, sys, time
# per-incarnation fault seed BEFORE the package imports (env faults arm
# at import): seeded p-gates draw a fresh pattern per incarnation, so a
# site-targeted crash can't deterministically re-fire forever
os.environ["FJT_FAULTS"] = os.environ.get("FJT_FAULTS", "").replace(
    "PIDSEED", str(os.getpid())
)
sys.path.insert(0, sys.argv[11])
import numpy as np
from flink_jpmml_tpu_torch.compile import compile_pmml, qtrees_cuda
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, FiniteBlockSource
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
from flink_jpmml_tpu_torch.runtime.dlq import DeadLetterQueue
from flink_jpmml_tpu_torch.runtime import state as state_mod
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

pmml, ckdir, outpath, emitpath, device = sys.argv[1:6]
seed, records, keys, capacity, B = (int(v) for v in sys.argv[6:11])
# every incarnation regenerates the IDENTICAL keyed stream from the
# seed — the chaos is in the faults, the stream is the constant
rng = np.random.default_rng(seed)
data = rng.normal(0.0, 1.0, size=(records, 5)).astype(np.float32)
data[:, 0] = rng.integers(0, keys, size=records).astype(np.float32)
cm = compile_pmml(parse_pmml_file(pmml), batch_size=B, device=device)
m = MetricsRegistry()
dlq = DeadLetterQueue(os.path.join(ckdir, "dlq"), metrics=m)
emit = open(emitpath, "a", buffering=1)

def sink(out, n, first_off):
    emit.write("%d %d\n" % (first_off, n))

pipe = BlockPipeline(
    # block == dispatch batch + a far fill deadline: every dispatch is
    # one aligned B-sized block, so a restore replays the exact batch
    # boundaries of the reference life
    FiniteBlockSource(data, block_size=B), cm, sink,
    RuntimeConfig(
        batch=BatchConfig(size=B, deadline_us=5_000_000),
        checkpoint_interval_s=0.05,
    ),
    metrics=m,
    checkpoint=CheckpointManager(ckdir),
    dlq=dlq,
    state=state_mod.StateSpec(capacity=capacity, key_col=0),
)
pipe.restore()
restored = pipe.committed_offset
pipe.start()
while pipe.committed_offset < records and pipe._error is None:
    time.sleep(0.02)
pipe.stop()
pipe.join(timeout=30.0)
if pipe._error is not None:
    raise SystemExit("state chaos worker died: %r" % (pipe._error,))
tbl = pipe._state
c = m.struct_snapshot()["counters"]
tmp_out = outpath + ".tmp"
np.savez(
    tmp_out,
    values=tbl.host_values(),
    keys=tbl._keys, occ=tbl._occ,
    applied_hi=np.int64(tbl.applied_hi),
    state_rollbacks=np.int64(c.get("state_rollbacks", 0)),
    launches=np.int64(qtrees_cuda.leaf_rows.launches),
    restored=np.int64(restored),
)
os.replace(tmp_out + ".npz", outpath)  # np.savez appends .npz
emit.close()
'''


def soak_stateful_chaos(seed, device) -> dict:
    """One STATEFUL chaos iteration: seeded faults — worker crashes
    (parent SIGKILLs at committed-offset targets plus in-worker
    ``worker_crash`` weather), ``device_oom`` / ``device_error`` streaks,
    and ``poison_record`` offsets — against a keyed stream through a
    state-armed checkpointed ``BlockPipeline``, run as supervised
    subprocess incarnations on ``device``. Per seed, against a
    same-poison fault-free reference life:

    - delivery contract (every life): the stream drains, the DLQ holds
      the poison offsets EXACTLY, and the sink's only gaps are those
      quarantined offsets;
    - exactly-once fold accounting (every life): no key ever folds more
      records than its count in the seeded stream. Folding fewer is
      legitimate only for rollback seeds (a dispatch error restores the
      last checkpoint snapshot, shedding a wall-clock-sized window of
      folds by design — ``state_rollbacks``);
    - state parity: with no rollback source (kills and ``worker_crash``
      weather only), every key's fold count equals the stream's and the
      final table is byte-identical to an uninterrupted fault-free
      reference life."""
    import torch

    from flink_jpmml_tpu_torch.parallel.partitioner import stable_hash_vec
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.runtime.dlq import DeadLetterQueue

    rng = np.random.default_rng(seed)
    records, keys, capacity, B = 2048, 256, 2048, 32
    pmml = state_chaos_pmml()
    dev = str(torch.device(device))
    tmp = tempfile.mkdtemp(prefix="fjt-statechaos-")
    try:
        # ---- seeded composition --------------------------------------
        poison = []
        for _ in range(int(rng.integers(0, 3))):
            o = int(rng.integers(0, records))
            while o in poison:
                o = (o + 1) % records
            poison.append(o)
        pspec = [f"poison_record:offset={o}" for o in poison]
        kills = int(rng.integers(0, 3))
        if not poison and not kills:
            kills = 1  # never a degenerate fault-free seed
        weather, dev_budget = [], 0
        if rng.random() < 0.4:
            # SIGKILL-anywhere weather: parity-SAFE — exactly-once
            # restore covers any kill instant, in-worker or parent
            weather.append(
                "worker_crash:site=checkpoint_write:p=0.01:n=1"
                ":after_s=0.3:seed=PIDSEED"
            )
        if rng.random() < 0.5:
            dmenu = []
            for kind, site, lo, hi in (
                ("device_error", "device_readback", 2, 6),
                ("device_oom", "device_dispatch", 1, 4),
            ):
                n = int(rng.integers(lo, hi))
                dmenu.append((f"{kind}:site={site}:n={n}", n))
            picks = rng.choice(
                len(dmenu), size=int(rng.integers(1, len(dmenu) + 1)),
                replace=False,
            )
            weather += [dmenu[i][0] for i in picks]
            dev_budget = sum(dmenu[i][1] for i in picks)
        chaos_spec = pspec + weather
        if kills:
            # stretch the drain so the parent's committed-offset poll
            # can land its kills (pure delay: no state effect)
            chaos_spec.append("dispatch_delay:delay_ms=2")

        # ---- one supervised life -------------------------------------
        def run_life(tag, spec, kill_targets):
            # every incarnation pays a worker's cold start on top of
            # the JAX tool's 150 s
            timeout_s = 150.0 + WORKER_START_S * (len(kill_targets) + 2)
            ckdir = os.path.join(tmp, f"ck-{tag}")
            outpath = os.path.join(tmp, f"state-{tag}.npz")
            emitpath = os.path.join(tmp, f"emit-{tag}.log")
            open(emitpath, "w").close()
            argv = [
                sys.executable, "-c", STATE_CHAOS_WORKER,
                pmml, ckdir, outpath, emitpath, dev, str(seed),
                str(records), str(keys), str(capacity), str(B), _ROOT,
            ]
            env = dict(os.environ)
            env.update({
                "FJT_FAULTS": ",".join(spec),
                "FJT_RETRY_BASE_S": "0.01",
                "FJT_FAILOVER_COOLDOWN_S": "0.1",
                "FJT_FAILOVER_GREENS": "1",
                "FJT_DEVICE_RETRIES": str(STATE_DEVICE_RETRIES),
                "FJT_AUTOTUNE_CACHE": os.path.join(tmp, "autotune",
                                                   "autotune.json"),
                "FJT_FLIGHT_DIR": os.path.join(tmp, "flight"),
            })

            def committed():
                try:
                    st = CheckpointManager(ckdir).load_latest()
                    return int(st["source_offset"]) if st else 0
                except Exception:
                    return 0

            pending = list(kill_targets)
            incarnations = 0
            deadline = time.monotonic() + timeout_s
            while True:
                assert incarnations < 25, (
                    f"stateful chaos seed={seed} ({tag}): restart "
                    f"storm without drain (spec {spec})"
                )
                assert time.monotonic() < deadline, (
                    f"stateful chaos seed={seed} ({tag}): no drain in "
                    f"{timeout_s}s, committed "
                    f"{committed()}/{records} (spec {spec})"
                )
                errpath = os.path.join(tmp, f"stderr-{tag}.log")
                with open(errpath, "w") as errf:
                    proc = subprocess.Popen(
                        argv, env=env, stdout=subprocess.DEVNULL,
                        stderr=errf,
                    )
                incarnations += 1
                killed_this = False
                try:
                    while proc.poll() is None:
                        if pending and committed() >= pending[0]:
                            os.kill(proc.pid, signal.SIGKILL)
                            proc.wait(timeout=10)
                            pending.pop(0)
                            killed_this = True
                            break
                        if time.monotonic() >= deadline:
                            break
                        time.sleep(0.02)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait(timeout=10)
                if killed_this:
                    continue
                if proc.returncode == 0:
                    assert os.path.exists(outpath), (
                        f"stateful chaos seed={seed} ({tag}): worker "
                        "exited 0 without its table dump"
                    )
                    return outpath, emitpath, ckdir, incarnations
                if proc.returncode == -signal.SIGKILL:
                    continue  # in-worker worker_crash weather: respawn
                with open(errpath) as f:
                    tail = f.read()[-600:]
                raise AssertionError(
                    f"stateful chaos seed={seed} ({tag}): worker "
                    f"rc={proc.returncode} (spec {spec}): {tail}"
                )

        # a dispatch error rolls the table back to the LAST CHECKPOINT
        # snapshot (wall-clock interval ⇒ nondeterministic shed window),
        # so exact parity is only claimable for compositions with no
        # rollback source at all
        rollback_free = not poison and dev_budget == 0

        targets = [
            int(records * (i + 1) / (kills + 1)) for i in range(kills)
        ]
        ch_path, ch_emit, ch_ck, incarnations = run_life(
            "chaos", chaos_spec, targets,
        )
        lives = [("chaos", ch_path, ch_emit, ch_ck)]
        if rollback_free:
            ref_path, ref_emit, ref_ck, _ = run_life("ref", [], [])
            lives.append(("ref", ref_path, ref_emit, ref_ck))

        # ---- ground truth: the seeded stream's per-key-hash counts ---
        gt = np.random.default_rng(seed)
        gt.normal(0.0, 1.0, size=(records, 5))  # same draw order
        raw = gt.integers(0, keys, size=records).astype(np.float32)
        kh = stable_hash_vec(raw.astype(np.int64))
        uk, true_n = np.unique(kh, return_counts=True)
        true = dict(zip(uk.tolist(), true_n.tolist()))

        def counts(d):
            occ = d["occ"].astype(bool)
            # values carries scratch/padding rows past capacity; the
            # mirror indexes only the table proper
            vals = d["values"][: occ.shape[0]]
            return dict(zip(
                d["keys"][occ].tolist(), vals[occ, 0].tolist(),
            ))

        expected = sorted(poison)
        delivered = {}
        for tag, outpath, emitpath, ckdir in lives:
            # ---- delivery contract -----------------------------------
            covered = np.zeros(records, np.int64)
            with open(emitpath) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 2:
                        continue  # torn final line at a SIGKILL
                    off, n = int(parts[0]), int(parts[1])
                    covered[off: off + n] += 1
            q = sorted(set(DeadLetterQueue(
                os.path.join(ckdir, "dlq")
            ).offsets()))
            assert q == expected, (
                f"stateful chaos seed={seed} ({tag}): DLQ {q} != "
                f"{expected} (spec {chaos_spec})"
            )
            missing = sorted(int(o) for o in np.flatnonzero(covered == 0))
            assert missing == expected, (
                f"stateful chaos seed={seed} ({tag}): sink gaps "
                f"{missing[:10]} != quarantined {expected} "
                f"(spec {chaos_spec})"
            )
            delivered[tag] = int((covered > 0).sum())
            # ---- exactly-once fold accounting ------------------------
            folded = counts(np.load(outpath))
            for k, n in folded.items():
                assert k in true and n <= true[k], (
                    f"stateful chaos seed={seed} ({tag}): key {k} "
                    f"folded {n} records vs {true.get(k, 0)} in the "
                    f"stream — a replay or re-dispatch double-folded "
                    f"(spec {chaos_spec})"
                )
            if rollback_free:
                deficit = sum(true.values()) - sum(folded.values())
                assert deficit == 0, (
                    f"stateful chaos seed={seed} ({tag}): {deficit} "
                    f"folds lost with no rollback source composed "
                    f"(spec {chaos_spec})"
                )

        # ---- byte parity (rollback-free compositions only) -----------
        if rollback_free:
            ref_v = np.load(ref_path)["values"]
            ch_v = np.load(ch_path)["values"]
            assert ref_v.tobytes() == ch_v.tobytes(), (
                f"stateful chaos seed={seed}: table diverged from the "
                f"fault-free reference after {incarnations} "
                f"incarnations / {kills} kills (spec {chaos_spec})"
            )
        return {"seed": seed, "records": records, "dlq": len(expected),
                "delivered": delivered["chaos"], "kills": kills,
                "incarnations": incarnations,
                "rollback_free": rollback_free,
                "byte_parity": bool(rollback_free),
                # the last incarnation's restore point and launches
                "last_restored_at": int(np.load(ch_path)["restored"]),
                "last_worker_launches": int(np.load(ch_path)["launches"]),
                "spec": chaos_spec}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


PROFILES = {
    "chaos": soak_chaos,
    "zoo-chaos": soak_zoo_chaos,
    "stateful-chaos": soak_stateful_chaos,
    "mesh-chaos": soak_mesh_chaos,
}


def soak(name: str, fn, seeds: int, start: int, device, log=print,
         **kw) -> dict:
    """Run ``fn(seed, device, **kw)`` over ``seeds`` seeds from ``start``;
    a seed whose assertion fails is printed (``FAIL <name> seed=<s>:``)
    and counted, any other error propagates. Prints the summary line →
    {"ok", "seeds", "failed", "seconds", "results"}."""
    t0 = time.perf_counter()
    ok, failed, results = 0, [], []
    for s in range(start, start + seeds):
        try:
            results.append(fn(s, device, **kw))
            ok += 1
        except AssertionError as e:
            failed.append(s)
            log(f"FAIL {name} seed={s}: {e}")
    dt = time.perf_counter() - t0
    log(f"{name}: {ok}/{seeds} seeds clean in {dt:.1f}s")
    return {"ok": ok, "seeds": seeds, "failed": failed, "seconds": dt,
            "results": results}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m flink_jpmml_tpu_torch.tools.fuzz_soak")
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--start", type=int, default=100_000)
    ap.add_argument("--chaos", action="store_true",
                    help="fault-composition soak instead of parity "
                         "families: each seed drives a random mix of "
                         "FJT_FAULTS kinds through a Kafka→pipeline "
                         "stream and verifies the delivery contract "
                         "(no loss, poison exactly in the DLQ)")
    ap.add_argument("--mesh", action="store_true",
                    help="with --chaos: the MESH profile instead — "
                         "chip_loss composed with kafka faults against "
                         "a mesh-sharded pipeline (cpu:0..7 with "
                         "--platform cpu, else >= 4 cards), verifying "
                         "degraded-mesh serving under churn")
    ap.add_argument("--zoo", action="store_true",
                    help="with --chaos: the ZOO profile instead — "
                         "tenant churn (Del/re-Add/version bump) "
                         "composed with device faults against the "
                         "packed multi-tenant scorer, verifying the "
                         "per-tenant delivery contract")
    ap.add_argument("--stateful", action="store_true",
                    help="with --chaos: the STATEFUL profile instead — "
                         "seeded worker crashes (SIGKILL), device_oom/"
                         "device_error streaks, and poison offsets "
                         "over a keyed stream through a state-armed "
                         "checkpointed pipeline (subprocess "
                         "incarnations), asserting state parity vs a "
                         "fault-free reference + the delivery "
                         "contract per seed")
    ap.add_argument("--platform", default=None,
                    help="cpu, or gpu / cuda (the default, also read "
                         "from FJT_PLATFORM): where every profile runs")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from flink_jpmml_tpu_torch.utils.demo import platform_device

    args = build_arg_parser().parse_args(argv)
    device = platform_device(
        args.platform or os.environ.get("FJT_PLATFORM") or None)
    if args.chaos and args.mesh and not args.zoo:
        mesh_devices(device)  # refuse before any seed runs
    print(f"device: {device}", flush=True)

    def log(line):
        print(line, flush=True)

    if args.chaos:
        if args.zoo:
            name = "zoo-chaos"
        elif args.mesh:
            name = "mesh-chaos"
        elif args.stateful:
            name = "stateful-chaos"
        else:
            name = "chaos"
        r = soak(name, PROFILES[name], args.seeds, args.start, device,
                 log=log)
        return 1 if r["failed"] else 0
    failures = 0
    for fam in args.families.split(","):
        fam = fam.strip()
        if fam not in FAMILIES:
            print(f"unknown family {fam!r}; have {sorted(FAMILIES)}")
            return 2
        r = soak(fam, FAMILIES[fam], args.seeds, args.start, device,
                 log=log)
        failures += len(r["failed"])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
