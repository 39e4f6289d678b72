"""Example: GBM scoring over the Kafka wire protocol with exact resume.

BASELINE config 2's "Kafka tabular stream", end to end on real protocol
bytes: an in-process broker (`MiniKafkaBroker`, the same Fetch v4 /
magic-2 record-batch format a real broker serves) feeds packed-f32 rows
to a `KafkaBlockSource` driving the production `BlockPipeline`; halfway
through, the pipeline is stopped and a fresh one resumes from the
checkpointed Kafka offset — every record scored exactly once.

The port's twin of ``examples/kafka_stream.py``: the same job and flags
on ``flink_jpmml_tpu_torch``. ``--platform cpu`` (or ``FJT_PLATFORM=cpu``)
runs it on the CPU; without it the job runs on the card, where each
dispatch launches the hand-written Hopper kernel ``qtrees_leaf_rows``
(C = 1), and a host without a card raises ``DeviceUnavailableError``
(``utils/demo.py``). Each run also prints its pipeline's metrics snapshot,
whose ``dispatches`` count the kernel's launches (the JAX job prints none).

Run:  python examples_torch/kafka_stream.py [--platform cpu]   (or on the card)
"""

import argparse
import pathlib
import sys
import tempfile
import time

try:  # installed package (pip install -e .)
    import flink_jpmml_tpu_torch  # noqa: F401
except ImportError:  # source checkout without install: add the repo root
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from flink_jpmml_tpu_torch.utils.demo import demo_backend
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
from flink_jpmml_tpu_torch.runtime.kafka import KafkaBlockSource, MiniKafkaBroker
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig


def main() -> None:
    device = demo_backend()
    print(f"backend: {device}")
    ap = argparse.ArgumentParser()
    ap.add_argument("--partitions", type=int, default=1,
                    help="topic partitions (round-robin interleaved "
                         "consumption; one checkpointed offset resumes "
                         "every partition cursor)")
    args = ap.parse_args()
    workdir = tempfile.mkdtemp(prefix="fjt-kafka-")
    pmml = gen_gbm(workdir, n_trees=50, depth=5, n_features=8)
    cm = compile_pmml(parse_pmml_file(pmml), batch_size=256, device=device)

    rng = np.random.default_rng(11)
    N = 20_000
    data = rng.normal(0.0, 1.5, size=(N, 8)).astype(np.float32)

    broker = MiniKafkaBroker(topic="features",
                             n_partitions=args.partitions)
    if args.partitions > 1:
        broker.append_rows_round_robin(data)
    else:
        broker.append_rows(data)
    print(f"broker on {broker.host}:{broker.port}, "
          f"{broker.high_watermark} records in topic 'features' "
          f"({args.partitions} partition(s))")

    cfg = RuntimeConfig(
        batch=BatchConfig(size=256, deadline_us=2000),
        checkpoint_interval_s=0.05,
    )
    ckdir = str(pathlib.Path(workdir, "ck"))
    scored = []

    def sink(out, n, first_off):
        scored.append((first_off, n))

    def make_pipe():
        src = KafkaBlockSource(
            broker.host, broker.port, "features", n_cols=8, max_wait_ms=20,
            partitions=list(range(args.partitions)),
            interleave="strict",  # round-robin producer below: the exact-seek fast path
        )
        return src, BlockPipeline(
            src, cm, sink, cfg, checkpoint=CheckpointManager(ckdir)
        )

    def wait_until(pipe, target, timeout_s=60.0):
        deadline = time.monotonic() + timeout_s
        while pipe.committed_offset < target:
            err = getattr(pipe, "_error", None)
            if err is not None:
                raise RuntimeError(f"pipeline failed: {err!r}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"stalled at offset {pipe.committed_offset} (<{target})"
                )
            time.sleep(0.005)

    # first run: stop mid-stream
    src1, pipe1 = make_pipe()
    pipe1.start()
    wait_until(pipe1, N // 3)
    pipe1.stop()
    pipe1.join(timeout=30.0)
    src1.close()
    print(f"run 1 stopped at committed offset {pipe1.committed_offset}")
    print(f"run 1 metrics: {pipe1.metrics.snapshot()}")

    # restart: resume from the checkpointed Kafka offset
    src2, pipe2 = make_pipe()
    assert pipe2.restore()
    print(f"run 2 resumes at offset {pipe2.committed_offset}")
    t0 = time.perf_counter()
    pipe2.start()
    wait_until(pipe2, N)
    pipe2.stop()
    pipe2.join(timeout=30.0)
    src2.close()
    dt = time.perf_counter() - t0
    broker.close()
    print(f"run 2 metrics: {pipe2.metrics.snapshot()}")

    covered = np.zeros(N, np.int64)
    for off, n in scored:
        covered[off : off + n] += 1
    assert (covered == 1).all(), "exactly-once violated"
    print(
        f"scored all {N} records exactly once; run 2: "
        f"{(N - pipe1.committed_offset) / dt:,.0f} rec/s through the "
        "Kafka wire"
    )


if __name__ == "__main__":
    main()
