"""Example: automatic failure recovery — kill -9 a scoring worker,
watch the supervisor restart it from its checkpoint.

The recovery half of the reference's Flink restart strategies
(SURVEY.md §6 "Failure detection / elastic recovery"), end to end: a
worker process scores a GBM over the Kafka wire with commit-after-sink
checkpointing and beats to the supervisor; this parent SIGKILLs it
mid-stream; the `Supervisor` (runtime/supervisor.py) detects the death,
respawns the worker with bounded backoff, the worker restores the
committed offset and drains the rest — no operator action anywhere.

The port's twin of ``examples/supervised_pipeline.py``: the same job on
``flink_jpmml_tpu_torch``. The JAX job pins its worker to the CPU; here the
worker runs on the device this process resolves (``utils/demo.py``):
the card by default, the CPU with ``--platform cpu`` (or
``FJT_PLATFORM=cpu``), ``DeviceUnavailableError`` on a host without a card
and without the flag. A card worker points its stdout at /dev/null and
its stderr at ``worker-<pid>.err`` in the job's directory, and beats only
once its CUDA context, its model and the kernel exist; its first beat
may take tens of seconds, so the job passes the supervisor a 60 s
first-beat deadline (the default stays 30 s).

Run:  python examples_torch/supervised_pipeline.py [--platform cpu]
"""

import os
import pathlib
import signal
import sys
import tempfile
import textwrap
import time

try:  # installed package (pip install -e .)
    import flink_jpmml_tpu_torch  # noqa: F401
except ImportError:  # source checkout without install: add the repo root
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

REPO = str(pathlib.Path(__file__).resolve().parent.parent)

import numpy as np

from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
from flink_jpmml_tpu_torch.runtime.kafka import MiniKafkaBroker
from flink_jpmml_tpu_torch.runtime.supervisor import (
    RestartPolicy, Supervisor, WorkerSpec,
)
from flink_jpmml_tpu_torch.utils.demo import demo_backend

# a card worker imports torch, makes its CUDA context, compiles the model
# and builds the kernel before its first beat: 9.8-27.6 s per worker on an
# H100 80GB HBM3 (700 W) host, against the supervisor's 30 s default
FIRST_BEAT_S = 60.0

_WORKER = textwrap.dedent(
    """
    import os, sys, time
    host, port, pmml, ckdir, total, device = (
        sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4],
        int(sys.argv[5]), sys.argv[6],
    )
    if device == "cuda":
        # nothing of a card worker reaches the parent's stdout
        os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
        os.dup2(os.open(
            os.path.join(os.path.dirname(ckdir),
                         "worker-%d.err" % os.getpid()),
            os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644), 2)
    sys.path.insert(0, {repo!r})
    from flink_jpmml_tpu_torch.compile import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file
    from flink_jpmml_tpu_torch.runtime.block import BlockPipeline
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.runtime.kafka import KafkaBlockSource
    from flink_jpmml_tpu_torch.runtime.supervisor import reporter_from_env
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    cm = compile_pmml(parse_pmml_file(pmml), batch_size=128, device=device)
    q = cm.quantized_scorer()
    if q is not None and device == "cuda":
        # the kernel's build and first launch before the first beat
        import numpy as np
        import torch

        q.predict_wire(q.wire.encode(np.zeros((128, 6), np.float32)))
        torch.cuda.synchronize()
    rep = reporter_from_env()  # beat to the supervising coordinator
    src = KafkaBlockSource(host, port, "features", n_cols=6,
                           max_wait_ms=20)
    pipe = BlockPipeline(
        src, cm, lambda out, n, off: None,
        RuntimeConfig(batch=BatchConfig(size=128, deadline_us=2000),
                      checkpoint_interval_s=0.05),
        checkpoint=CheckpointManager(ckdir),
    )
    resumed = pipe.restore()
    print(f"[worker] {{'resumed at ' + str(pipe.committed_offset) if resumed else 'fresh start'}}",
          flush=True)
    pipe.start()
    while pipe.committed_offset < total:
        time.sleep(0.02)
    pipe.stop(); pipe.join(timeout=30.0)
    src.close()
    print(f"[worker] drained all {{total}} records", flush=True)
    """
)


def main() -> None:
    device = demo_backend()
    print(f"backend: {device}")
    workdir = tempfile.mkdtemp(prefix="fjt-supervised-")
    pmml = gen_gbm(workdir, n_trees=20, depth=4, n_features=6)
    ckdir = os.path.join(workdir, "ck")

    rng = np.random.default_rng(13)
    N = 30_000
    data = rng.normal(0.0, 1.5, size=(N, 6)).astype(np.float32)
    broker = MiniKafkaBroker(topic="features")
    broker.append_rows(data)
    print(f"broker on {broker.host}:{broker.port}, {N} records")

    spec = WorkerSpec(
        "scorer",
        [sys.executable, "-c", _WORKER.format(repo=REPO),
         broker.host, str(broker.port), pmml, ckdir, str(N), device],
    )
    sup = Supervisor(
        [spec],
        policy=RestartPolicy(max_restarts=3, backoff_s=0.2),
        heartbeat_timeout_s=2.0,
        first_beat_timeout_s=FIRST_BEAT_S,
        on_restart=lambda wid, n: print(
            f"[supervisor] restarted {wid} (restart #{n})"
        ),
    )
    sup.start()
    try:
        # let the worker commit real progress, then murder it
        def committed():
            st = CheckpointManager(ckdir).load_latest()
            return st["source_offset"] if st else 0

        while committed() < N // 4:
            if sup.status()["scorer"]["gave_up"]:
                raise SystemExit(
                    "worker never started (supervisor gave up)"
                )
            time.sleep(0.05)
        pid = sup.status()["scorer"]["pid"]
        print(f"[parent] kill -9 worker pid {pid} at committed offset "
              f"{committed():,}")
        os.kill(pid, signal.SIGKILL)

        # zero operator action from here: detection -> respawn -> resume
        while not sup.status()["scorer"]["finished"]:
            if sup.status()["scorer"]["gave_up"]:
                raise SystemExit("supervisor gave up (unexpected)")
            time.sleep(0.1)
        st = sup.status()["scorer"]
        print(f"[parent] worker finished after {st['restarts']} automatic "
              f"restart(s); final committed offset {committed():,} / {N:,}")
    finally:
        sup.stop()
        broker.close()


if __name__ == "__main__":
    main()
