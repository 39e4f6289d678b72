"""Example: MNIST-shaped MLP NeuralNetwork scoring (BASELINE config 3).

A 784→256→10 NeuralNetwork PMML lowers to an f32 matmul chain
(compile/neural.py); the stream carries dense pixel vectors. The
reference would walk JPMML's per-record neuron graph on the CPU.

The port's twin of ``examples/mnist_mlp.py``: the same job and flags on
``flink_jpmml_tpu_torch``. ``--platform cpu`` (or ``FJT_PLATFORM=cpu``)
runs it on the CPU; without it the job runs on the card, and a host
without one raises ``DeviceUnavailableError`` (``utils/demo.py``).

Run:  python examples_torch/mnist_mlp.py [--platform cpu]
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
from flink_jpmml_tpu_torch.assets_gen import gen_mlp
from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig


def main() -> None:
    device = demo_backend()
    print(f"backend: {device}")
    workdir = tempfile.mkdtemp(prefix="fjt-mlp-")
    pmml = gen_mlp(workdir, n_inputs=784, hidden=(256,), n_classes=10)
    print(f"model: {pmml}")

    rng = np.random.default_rng(0)
    images = rng.uniform(0.0, 1.0, size=(512, 784)).astype(np.float32).tolist()

    env = StreamEnvironment(
        RuntimeConfig(batch=BatchConfig(size=256, deadline_us=2000)),
        device=device,
    )
    sink = (
        env.from_collection(images)
        .quick_evaluate(ModelReader(pmml))
        .collect()
    )
    env.execute(timeout=120.0)

    preds = [p for p, _vec in sink.items]
    by_digit = {}
    for p in preds:
        by_digit[p.target.label] = by_digit.get(p.target.label, 0) + 1
    print(f"scored {len(preds)} images; class histogram: {by_digit}")
    top = preds[0]
    print(f"first image → digit {top.target.label} "
          f"(p={top.score.value:.3f})")


if __name__ == "__main__":
    main()
