"""Example: dynamic model serving with a control stream (capability C6).

Two model versions are published while events flow; a DelMessage retires the
model mid-stream and affected lanes become empty predictions — the stream
never dies. Mirrors the reference's ``withSupportStream`` dynamic API
(SURVEY.md §4.3).

The port's twin of ``examples/dynamic_serving.py``: the same job and flags on
``flink_jpmml_tpu_torch``. ``--platform cpu`` (or ``FJT_PLATFORM=cpu``)
runs it on the CPU; without it the job runs on the card, and a host
without one raises ``DeviceUnavailableError`` (``utils/demo.py``).

Run:  python examples_torch/dynamic_serving.py [--platform cpu]
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
from flink_jpmml_tpu_torch.models.control import AddMessage, DelMessage
from flink_jpmml_tpu_torch.runtime.sources import ControlSource
from flink_jpmml_tpu_torch.serving import DynamicScorer


def main() -> None:
    device = demo_backend()
    print(f"backend: {device}")
    workdir = tempfile.mkdtemp(prefix="fjt-dyn-")
    v1 = gen_iris_lr(workdir, seed=7)
    v2_dir = tempfile.mkdtemp(prefix="fjt-dyn2-")
    v2 = gen_iris_lr(v2_dir, seed=99)

    ctrl = ControlSource()
    scorer = DynamicScorer(control=ctrl, batch_size=64, device=device)
    rng = np.random.default_rng(1)
    vectors = rng.normal(3.0, 2.0, size=(8, 4)).astype(np.float32).tolist()
    events = [("iris", v) for v in vectors]

    print("no model served yet:")
    out = scorer.finish(scorer.submit(events))
    print("  empty lanes:", sum(p.is_empty for p, _ in out), "/", len(out))

    ctrl.push(AddMessage("iris", 1, v1, timestamp=1.0))
    out = scorer.finish(scorer.submit(events))
    print("after Add v1:", [p.target.label for p, _ in out[:4]])

    ctrl.push(AddMessage("iris", 2, v2, timestamp=2.0))
    out = scorer.finish(scorer.submit(events))
    print("after Add v2 (latest wins):", [p.target.label for p, _ in out[:4]])

    ctrl.push(DelMessage("iris", 2, timestamp=3.0))
    out = scorer.finish(scorer.submit(events))
    print("after Del v2 (v1 serves again):", [p.target.label for p, _ in out[:4]])

    state = scorer.state()
    print("checkpointable registry state:", state)


if __name__ == "__main__":
    main()
