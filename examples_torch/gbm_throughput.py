"""Example: 500-tree GBM scored over a tabular stream (BASELINE config 2).

The north-star workload: a histogram-trained gradient-boosted ensemble
scoring a high-rate feature stream. The reference runs JPMML-Evaluator's
per-record tree walk inside a Flink flatMap (SURVEY.md §4.1 hot loop);
here the *production* BlockPipeline drives the quantized rank wire
(compile/qtrees.py) end to end — f32 blocks flow through the C++ ring,
are encoded to uint8 threshold ranks by the multithreaded bucketizer, and
the whole micro-batch is scored by the walk kernel. No Python object per
record exists anywhere.

The port's twin of ``examples/gbm_throughput.py``: the same job and flags
on ``flink_jpmml_tpu_torch``. ``--platform cpu`` (or ``FJT_PLATFORM=cpu``)
runs it on the CPU, where the kernel's wrapper runs its plain version;
without it the job runs on the card, where each dispatch launches the
hand-written Hopper kernel ``qtrees_leaf_rows`` (C = 1), and a host without
a card raises ``DeviceUnavailableError`` (``utils/demo.py``). The warm
dispatch goes through the rank-wire scorer's ``predict_wire`` and
``torch.cuda.synchronize`` instead of ``jax.block_until_ready``. The
printed metrics snapshot carries ``dispatches``, one kernel launch each.

Run:  python examples_torch/gbm_throughput.py [--platform cpu] [--kafka]  [--trees 500 --seconds 3]
chip_smoke.py's main paths drive this same pipeline shape on the card.
"""

import argparse
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from flink_jpmml_tpu_torch.utils.demo import demo_backend
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, CyclingBlockSource
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig


def main() -> None:
    device = demo_backend()
    print(f"backend: {device}")
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", type=int, default=500)
    ap.add_argument("--features", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--kafka", action="store_true",
                    help="stream through the real Kafka wire protocol "
                         "(in-process broker + C++ record-batch decode) "
                         "instead of the in-memory source")
    args = ap.parse_args()

    workdir = tempfile.mkdtemp(prefix="fjt-gbm-")
    pmml = gen_gbm(workdir, n_trees=args.trees, n_features=args.features)
    doc = parse_pmml_file(pmml)
    cm = compile_pmml(doc, batch_size=args.batch, device=device)
    q = cm.quantized_scorer()
    print(
        f"model: {args.trees} trees | rank wire: "
        f"{q.wire.bytes_per_record if q else 'n/a'} B/record | "
        f"kernel backend: {q.backend if q else 'f32'}"
    )

    rng = np.random.default_rng(0)
    data = rng.normal(0.0, 1.5, size=(4 * args.batch, args.features)).astype(
        np.float32
    )
    count = [0]

    def sink(out, n, first_off):
        # force the D2H round trip so the printed rate counts *completed*
        # scoring, not async dispatches still queued on the device
        np.asarray(out.value if hasattr(out, "value") else
                   out[0] if isinstance(out, tuple) else out)
        count[0] += n

    broker = None
    if args.kafka:
        from flink_jpmml_tpu_torch.runtime.kafka import (
            KafkaBlockSource, MiniKafkaBroker,
        )

        broker = MiniKafkaBroker(topic="gbm")
        broker.append_rows(data)
        hw = broker.high_watermark

        class _Cycling(KafkaBlockSource):
            def poll(self):
                if self._next >= hw:
                    self.seek(0)
                return super().poll()

        source = _Cycling(
            broker.host, broker.port, "gbm",
            n_cols=args.features, max_wait_ms=20,
        )
        print(f"kafka broker on {broker.host}:{broker.port}, "
              f"{hw} records cycling")
    else:
        source = CyclingBlockSource(data, block_size=args.batch)
    pipe = BlockPipeline(
        source,
        cm,
        sink,
        RuntimeConfig(batch=BatchConfig(size=args.batch, deadline_us=5000)),
    )
    # the port has no Python ring: every BlockPipeline runs the C++ one
    print(f"pipeline backend: {pipe.backend} | native ring: True")
    if q is not None:
        # one warm dispatch so the kernel build stays outside the timed
        # window
        q.predict_wire(q.wire.encode(data[: args.batch]))
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
    else:
        cm.warmup()
    try:
        t0 = time.perf_counter()
        pipe.run_for(seconds=args.seconds)
        dt = time.perf_counter() - t0
        snap = pipe.metrics.snapshot()
        print(f"scored {count[0]:,} records in {dt:.2f}s "
              f"({count[0] / dt:,.0f} rec/s through the full block pipeline)")
        print(f"metrics: {snap}")
    finally:
        if broker is not None:
            source.close()
            broker.close()


if __name__ == "__main__":
    main()
