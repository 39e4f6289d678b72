"""Example: stacked modelChain ensemble, sharded over a device mesh
(BASELINE config 5).

A MiningModel modelChain — inner GBM whose output field feeds a logistic
calibration RegressionModel — over a wide (default 10k) sparse feature
space, scored with the batch axis sharded across all available devices
(data parallelism over ICI; the reference's only parallelism is Flink
operator DP, SURVEY.md §3 P1).

The port's twin of ``examples/stacked_sharded.py``: the same job and flags
on ``flink_jpmml_tpu_torch``. On the card the mesh is ``make_mesh()``'s,
over every ``cuda:i`` (one card: a 1×1 mesh, pure DP). With
``--platform cpu`` (or ``FJT_PLATFORM=cpu``) it is an explicit list of 8
logical ``cpu:i`` devices (``parallel/mesh.cpu_devices``), the shape of the
JAX package's virtual 8-device CPU mesh, so the wide LR stage
feature-shards over ``model`` = 2. A host without a card and without the
flag raises ``DeviceUnavailableError`` (``utils/demo.py``).

Run:  python examples_torch/stacked_sharded.py [--platform cpu] [--features 10000]
"""

import argparse
import pathlib
import sys
import tempfile

try:  # installed package (pip install -e .)
    import flink_jpmml_tpu_torch  # noqa: F401
except ImportError:  # source checkout without install: add the repo root
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from flink_jpmml_tpu_torch.utils.demo import demo_backend
from flink_jpmml_tpu_torch.assets_gen import gen_stacked
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.parallel.mesh import cpu_devices, make_mesh
from flink_jpmml_tpu_torch.parallel.sharding import dp_sharded
from flink_jpmml_tpu_torch.pmml import parse_pmml_file


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


def main() -> None:
    device = demo_backend()
    print(f"backend: {device}")
    ap = argparse.ArgumentParser()
    ap.add_argument("--features", type=int, default=10_000)
    ap.add_argument("--trees", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2048)
    args = ap.parse_args()

    workdir = tempfile.mkdtemp(prefix="fjt-stacked-")
    pmml = gen_stacked(
        workdir, n_trees=args.trees, depth=4, n_features=args.features,
        wide_lr=True,  # the full config-5 shape: GBM + wide LR + calibration
    )
    doc = parse_pmml_file(pmml)

    from flink_jpmml_tpu_torch.utils.config import MeshConfig

    # every card, or 8 logical CPU devices when the CPU was asked for
    devices = cpu_devices(8) if device == "cpu" else None
    if devices is None:
        import torch

        n = torch.cuda.device_count()
    else:
        n = len(devices)
    # data x model mesh: the wide LR stage feature-shards over `model`
    n_model = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(MeshConfig(data=n // n_model, model=n_model),
                     devices=devices)
    print(f"mesh: {mesh.shape} over {n} devices")

    # mesh-aware compile: the wide stage's [F] coefficient tensors are
    # feature-sharded INSIDE the compiled scorer (row slices whose
    # partial products add in slice order); narrow params replicate
    sharded = compile_pmml(doc, mesh=mesh)
    print(f"TP-sharded param leaves: {list(sharded.tp_sharded_leaves) or '(pure-DP mesh)'}")

    rng = np.random.default_rng(0)
    # sparse-ish stream: most features zero, a few hot
    X = np.zeros((args.batch, args.features), np.float32)
    hot = rng.integers(0, args.features, size=(args.batch, 32))
    X[np.arange(args.batch)[:, None], hot] = rng.normal(
        0.0, 1.0, size=hot.shape
    )
    M = np.zeros_like(X, bool)

    out = sharded.predict(X, M)
    values = _host(out.value)
    print(f"scored {args.batch} x {args.features}-dim records "
          f"(batch sharded over data, wide-LR features over model, "
          f"{mesh.shape}); "
          f"calibrated score range [{values.min():.4f}, {values.max():.4f}]")

    # plain DP on the same document stays available (params replicated)
    dp = dp_sharded(compile_pmml(doc, device=device), mesh)
    np.testing.assert_allclose(
        _host(dp.predict(X, M).value), values, rtol=2e-5, atol=1e-6
    )
    print("DP-replicated predict agrees with the TP-sharded compile")


if __name__ == "__main__":
    main()
