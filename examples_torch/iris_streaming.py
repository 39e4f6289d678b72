"""Example: stream Iris vectors through a logistic-regression PMML.

Reference parity: the examples module's K-Means/Iris jobs (SURVEY.md §3 row
D2 [UNVERIFIED]). Generates the fixture, builds a pipeline with the fluent
API, scores a finite stream, prints predictions + runtime metrics.

The port's twin of ``examples/iris_streaming.py``: the same job and flags on
``flink_jpmml_tpu_torch``. ``--platform cpu`` (or ``FJT_PLATFORM=cpu``)
runs it on the CPU; without it the job runs on the card, and a host
without one raises ``DeviceUnavailableError`` (``utils/demo.py``).

Run:  python examples_torch/iris_streaming.py [--platform cpu]
"""

import pathlib
import sys
import tempfile

try:  # installed package (pip install -e .)
    import flink_jpmml_tpu_torch  # noqa: F401
except ImportError:  # source checkout without install: add the repo root
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from flink_jpmml_tpu_torch.utils.demo import demo_backend
from flink_jpmml_tpu_torch.assets_gen import gen_iris_lr
from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig


def main() -> None:
    device = demo_backend()
    print(f"backend: {device}")
    workdir = tempfile.mkdtemp(prefix="fjt-iris-")
    pmml_path = gen_iris_lr(workdir)
    print(f"model: {pmml_path}")

    rng = np.random.default_rng(0)
    vectors = rng.normal(3.0, 2.0, size=(1000, 4)).astype(np.float32).tolist()
    vectors[7] = [float("nan")] * 4  # one dirty record: lane goes empty (C5)

    env = StreamEnvironment(
        RuntimeConfig(batch=BatchConfig(size=256, deadline_us=2000)),
        device=device,
    )
    sink = (
        env.from_collection(vectors)
        .quick_evaluate(ModelReader(pmml_path))
        .collect()
    )
    env.execute(timeout=60.0)

    preds = sink.items
    print(f"scored {len(preds)} records")
    for i in (0, 1, 7):
        pred, vec = preds[i]
        if pred.is_empty:
            print(f"  record {i}: EMPTY (dirty input)")
        else:
            probs = {k: round(v, 3) for k, v in pred.target.probabilities.items()}
            print(f"  record {i}: {pred.target.label} {probs}")

    snap = env.metrics.snapshot()
    print(
        "metrics: records/s={:.0f} p50={:.2f}ms p99={:.2f}ms batches={:.0f}".format(
            snap["records_out_per_s"],
            snap.get("record_latency_s_p50", 0) * 1e3,
            snap.get("record_latency_s_p99", 0) * 1e3,
            snap["batches"],
        )
    )


if __name__ == "__main__":
    main()
