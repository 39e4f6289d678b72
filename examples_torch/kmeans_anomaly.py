"""Example: streaming K-Means anomaly scoring (BASELINE config 4).

A center-based ClusteringModel lowers to a batched squared-euclidean
cdist + argmin (compile/clustering.py). The anomaly signal is the distance
to the winning centroid — records far from every center are flagged.
Mirrors the reference's K-Means-over-Iris example job (SURVEY.md §3 D2).

The port's twin of ``examples/kmeans_anomaly.py``: the same job and flags on
``flink_jpmml_tpu_torch``. ``--platform cpu`` (or ``FJT_PLATFORM=cpu``)
runs it on the CPU; without it the job runs on the card, and a host
without one raises ``DeviceUnavailableError`` (``utils/demo.py``).

Run:  python examples_torch/kmeans_anomaly.py [--platform cpu]
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
from flink_jpmml_tpu_torch.assets_gen import gen_kmeans
from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig


def main() -> None:
    device = demo_backend()
    print(f"backend: {device}")
    workdir = tempfile.mkdtemp(prefix="fjt-kmeans-")
    pmml = gen_kmeans(workdir, k=5, n_features=4)
    print(f"model: {pmml}")

    rng = np.random.default_rng(1)
    normal = rng.normal(0.0, 2.0, size=(990, 4))
    outliers = rng.normal(12.0, 0.5, size=(10, 4))  # far from every center
    stream = np.vstack([normal, outliers]).astype(np.float32).tolist()

    env = StreamEnvironment(
        RuntimeConfig(batch=BatchConfig(size=256, deadline_us=2000)),
        device=device,
    )
    sink = (
        env.from_collection(stream)
        .quick_evaluate(ModelReader(pmml))
        .collect()
    )
    env.execute(timeout=120.0)

    # prediction.target.probabilities carries per-cluster distances; the
    # winning distance is the anomaly score
    dists = np.asarray(
        [min(p.target.probabilities.values()) for p, _v in sink.items]
    )
    thresh = np.percentile(dists, 99)
    flagged = int((dists > thresh).sum())
    print(f"scored {len(dists)} records; p99 distance {thresh:.2f}; "
          f"{flagged} anomalies flagged "
          f"(last 10 records are the planted outliers: "
          f"{[round(float(d), 1) for d in dists[-10:]]})")


if __name__ == "__main__":
    main()
