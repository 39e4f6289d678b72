#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports the port (``flink_jpmml_tpu_torch``) and nothing of JAX or the
JAX package, and prints one JSON line per phase:

1. card — the ``nvidia-smi`` name / power-limit line and the torch device;
2. build — compiles ``flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu`` with
   nvcc for sm_90a (into ``build/``) and binds it;
3. kernel — the ensemble-sum kernel against its plain PyTorch version on
   the card, at the main path's shape (the 500-tree, depth-6, 32-feature
   GBM, [262144, 32] uint8 codes with about 20% missing cells), on a
   19-tree model, and on a batch whose length is not a multiple of the
   kernel's 128-row block, at rtol 1e-4 / atol 1e-5;
4. timing — CUDA-event medians of the kernel and of the plain version at
   the main path's shape, beside the least time the card could take;
5. main path — ``gen_gbm`` → ``parse_pmml_file`` → ``compile_pmml``
   (batch 16384, default device: the card) → ``BlockPipeline`` over a
   ``CyclingBlockSource`` in dispatches of 262,144 records, for at least
   16 dispatches; the kernel's launch count is reset just before and read
   just after, and a 4,096-record sample is scored again on the CPU
   (``device="cpu"``, the kernel's plain version) and, on the card, by the
   torch twin of the XLA scorer from the unpacked path matrix (``P_i8`` /
   ``count_i8``), which does not go through the kernel's table packer.

Then the kernels line, the ``nvidia-smi`` line, and last the contract
line ``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script exits non-zero without printing the last line. Without a CUDA
device it exits 1 at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-5  # the repo's rank-wire bar (tests/test_qtrees_pallas.py)
BATCH = 16384  # compile batch (bench.py --chunk)
DISPATCH = 262144  # records per dispatch (bench.py --batch)
MIN_DISPATCHES = 16
MISSING = 0.2
# H100 SXM peaks: HBM bytes/s (data sheet), and the issue rate of the
# INT32 pipe that runs the kernel's integer compare/select/and steps:
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the data sheet's 67 TFLOP/s
# float32 figure is the FP32 pipe, 128 lanes, with an FMA as two ops).
# Each step is taken as at least one instruction, so the bound is a floor.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 132 * 64 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, repeats: int) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events
    around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def model_tables(workdir: str, n_trees: int, name: str):
    """gen_gbm → parse → compile on the card → (compiled, rank-wire scorer)."""
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.compile import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    doc = parse_pmml_file(gen_gbm(workdir, n_trees=n_trees, name=name))
    cm = compile_pmml(doc, batch_size=BATCH)
    q = cm.quantized_scorer()
    if q is None or q.backend != "cuda":
        raise RuntimeError(f"{name}: rank-wire scorer not on the kernel "
                           f"({None if q is None else q.backend})")
    return doc, cm, q


def features(rng, n: int, F: int) -> np.ndarray:
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    X[rng.random(size=X.shape) < MISSING] = np.nan
    return X


def check_kernel(q, X: np.ndarray, label: str) -> dict:
    """Kernel vs plain version on the card for one model and batch."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    codes = torch.from_numpy(q.wire.encode(X)).cuda()
    got = qtrees_cuda.ensemble_sum(codes, tables, len(q.wire.fields))
    ref = qtrees_cuda.ensemble_sum_reference(codes, tables)
    torch.cuda.synchronize()
    if got.shape != (X.shape[0],) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: bad kernel output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL))
    row = {
        "case": label, "rows": X.shape[0], "trees": q.n_trees,
        "missing_share": float((codes == qtrees_cuda.SENTINEL).float().mean()),
        "max_abs_err": err, "ok": ok,
    }
    if not ok:
        emit({"phase": "kernel", **row})
        raise RuntimeError(f"{label}: kernel disagrees with its plain version")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from flink_jpmml_tpu_torch.compile import qtrees_cuda
    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.compile.qtrees import _match_ensemble, _torch_qfn
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        CyclingBlockSource,
    )
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "torch_device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    qtrees_cuda.build(verbose=False)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": "flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu",
          "arch": "sm_90a"})

    rng = np.random.default_rng(0)
    workdir = tempfile.mkdtemp(prefix="fjt-smoke-")
    doc, cm, q = model_tables(workdir, 500, "gbm_500.pmml")
    _, _, q19 = model_tables(workdir, 19, "gbm_19.pmml")
    F = len(q.wire.fields)
    X_main = features(rng, DISPATCH, F)
    rows = [
        check_kernel(q, X_main, "gbm500_262144"),
        check_kernel(q19, features(rng, 65536, F), "gbm19_65536"),
        check_kernel(q, features(rng, 100_003, F), "gbm500_ragged_100003"),
    ]
    emit({"phase": "kernel", "cases": rows})

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    codes = torch.from_numpy(q.wire.encode(X_main)).cuda()
    kern_ms = cuda_ms(lambda: qtrees_cuda.ensemble_sum(codes, tables, F),
                      3, 20)
    plain_ms = cuda_ms(
        lambda: qtrees_cuda.ensemble_sum_reference(codes, tables), 1, 3
    )
    N = codes.shape[0]
    T, S = tables["split"].shape
    L = tables["vals"].shape[1]
    n_bytes = codes.numel() + 4 * N + sum(
        t.numel() * t.element_size() for t in tables.values()
    )
    n_ops = N * T * (S + L)
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_INT32_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit({"phase": "timing", "rows": N, "trees": T, "splits": S,
          "leaves": L, "kernel_ms": kern_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bytes": n_bytes, "bytes_ms": bytes_ms,
          "ops": n_ops, "ops_ms": ops_ms,
          "kernel_records_per_s": N / (kern_ms * 1e-3),
          "library_ms": None})

    # -- main path ---------------------------------------------------------
    data = features(rng, 4 * DISPATCH, F)
    sample = 4096
    kept = {}
    count = [0]

    def sink(out, n, first_off):
        vals = np.asarray(out)
        if vals.ndim != 1 or vals.shape[0] < n:
            raise RuntimeError(f"sink got {vals.shape} for {n} records")
        if first_off == 0:
            kept["head"] = vals[:sample].copy()
        count[0] += n

    # warm the path once outside the counted window
    q.predict_wire(q.wire.encode(data[:BATCH]))
    torch.cuda.synchronize()
    pipe = BlockPipeline(
        CyclingBlockSource(data, block_size=DISPATCH),
        cm,
        sink,
        RuntimeConfig(batch=BatchConfig(
            size=BATCH, deadline_us=5000, queue_capacity=4 * DISPATCH,
        )),
        max_dispatch_chunks=DISPATCH // BATCH,
    )
    if pipe.backend != "rank_wire_cuda":
        raise RuntimeError(f"pipeline backend {pipe.backend}")
    target = MIN_DISPATCHES * DISPATCH
    qtrees_cuda.ensemble_sum.launches = 0
    t0 = time.perf_counter()
    pipe.start()
    deadline = t0 + 600
    while (count[0] < target and pipe.error is None
           and time.perf_counter() < deadline):
        time.sleep(0.01)
    pipe.stop()
    pipe.join(timeout=60)
    dt = time.perf_counter() - t0
    launches = qtrees_cuda.ensemble_sum.launches
    snap = pipe.metrics.snapshot()
    dispatches = int(snap["batches"])
    if count[0] < target:
        raise RuntimeError(f"main path scored {count[0]} < {target} records")
    if launches < dispatches or launches == 0:
        raise RuntimeError(f"{launches} kernel launches for {dispatches} "
                           "dispatches")

    cm_cpu = compile_pmml(doc, batch_size=BATCH, device="cpu")
    q_cpu = cm_cpu.quantized_scorer()
    ref = np.asarray(q_cpu.predict_padded(q_cpu.wire.encode(data[:sample])))
    head = kept["head"]
    if head.shape != (sample,) or not np.isfinite(head).all():
        raise RuntimeError(f"main path output {head.shape} not finite")
    err = float(np.abs(head - ref).max())
    if not np.allclose(head, ref, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"main path disagrees with the CPU port: {err}")
    # the torch twin reads P_i8 / count_i8, not the packed masks, so a
    # packing fault that shows only at 500 trees / depth 6 fails here
    twin = _torch_qfn(_match_ensemble(doc)[2], False, True,
                      q.wire.sentinel, doc.targets)
    with torch.no_grad():
        twin_out = twin(q.params, torch.from_numpy(
            q.wire.encode(data[:sample])).cuda()).cpu().numpy()
    twin_err = float(np.abs(head - twin_out).max())
    if not np.allclose(head, twin_out, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"main path disagrees with the torch twin on the "
                           f"unpacked tables: {twin_err}")
    emit({
        "phase": "main_path", "backend": pipe.backend,
        "cpu_backend": f"rank_wire_{q_cpu.backend}",
        "records": count[0], "seconds": dt, "records_per_s": count[0] / dt,
        "dispatches": dispatches, "launches": launches,
        "records_per_dispatch": snap["batch_fill_records"] / max(dispatches, 1),
        "encode_s": snap.get("encode_s"), "h2d_stall_s": snap.get("h2d_stall_s"),
        "batch_latency_p50_s": snap.get("batch_latency_s_p50"),
        "batch_latency_p99_s": snap.get("batch_latency_s_p99"),
        "cpu_check_rows": sample, "cpu_check_max_abs_err": err,
        "twin_check_max_abs_err": twin_err,
    })

    emit({"kernels": [{
        "name": "qtrees_ensemble_sum",
        "route": "cuda",
        "source": "flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu",
        "replaces": "flink_jpmml_tpu/compile/qtrees_pallas.py:170",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
