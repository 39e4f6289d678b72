#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports the port (``flink_jpmml_tpu_torch``) and nothing of JAX or the
JAX package, and prints one JSON line per phase:

1. card — the ``nvidia-smi`` name / power-limit line and the torch device;
2. build — compiles ``flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu`` (the
   leaf-rows kernel, one instance per class bucket) with nvcc for sm_90a
   (into ``build/``), binds it, and prints what ptxas reported for each
   instance (registers, static shared memory, stack, spills); any spill
   fails the phase;
3. kernel — the kernel (one f32 row per leaf: the GBM's leaf values)
   against its plain PyTorch version on the card, bit for bit, at the main
   path's shape (the 500-tree, depth-6, 32-feature GBM, [262144, 32] uint8
   codes with about 20% missing cells), on a 19-tree model, and on a batch
   whose length is not a multiple of a block's records;
4. walk kernel — the same check on seeded forests the fixtures lack
   (``ragged_forest``: 200 trees of depths 1-12 with single-leaf trees and
   padded split and leaf slots, at C = 1 and C = 3, and at C = 16 over 256
   fields, where a block shrinks to 64 threads; ``caterpillar_forest``: a
   64-split chain of depth 64 and 65 leaves, at C = 1 and C = 16), over
   random codes with 20% missing and ragged batch lengths;
5. timing — CUDA-event medians of the kernel and of the plain version at
   the main path's shape, beside the least time the card could take for
   the work these inputs need (``ops``: one integer step per split on each
   tree's hit path, C f32 adds per tree; ``bytes``: codes, the kernel's
   table and output once); beside them ``design_int_steps``, N × Σ
   depth[t] from the table's headers: the steps the walk is built to take,
   a count from the design, not a reading of the card;
6. main path — ``gen_gbm`` → ``parse_pmml_file`` → ``compile_pmml``
   (batch 16384, default device: the card) → ``BlockPipeline`` over a
   ``CyclingBlockSource`` in dispatches of 262,144 records, for at least
   16 dispatches; the kernel's launch count is reset just before and read
   just after, and a 4,096-record sample is scored again on the CPU
   (``device="cpu"``, the kernel's plain version) and, on the card, by the
   torch twin of the XLA scorer from the unpacked path matrix (``P_i8`` /
   ``count_i8``), which does not go through the kernel's table packer;
7. vote kernel — the same kernel with the class rows of a vote forest
   against its plain version on the card, bit for bit: the 500-tree,
   depth-6, 32-feature, 3-class majorityVote forest (``gen_vote_forest``)
   at [262144, 32] with about 20% missing cells, its weightedMajorityVote
   twin, a 19-tree forest, a 10-class forest and a 100,003-row batch;
8. vote timing — as 5, for the vote forest;
9. vote main path — as 6, over the majorityVote forest, with a sink that
   takes the (value, shares, label) triple. The 4,096-record head is held
   to the CPU port and to the torch twin at rtol 1e-4 / atol 1e-5 for
   shares and values; labels must be equal on rows whose classes do not
   tie on vote count, and on a tied row the kernel path's label is the
   lowest tied class and the other's one of the tied classes (the twin's
   f32 contraction rounds tied totals in an order of its own). Ties are
   found from exact integer vote counts.

The forest generators (``ragged_forest``, ``caterpillar_forest``,
``random_codes``) import nothing beyond numpy and torch; the CPU tests
import them too, so the card and the CPU see the same trees.

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
# f32 adds run on the FP32 pipe, at the data sheet's 67 TFLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 132 * 64 * 1.98e9
PEAK_F32_FLOP_S = 67e12


def _grow(rng, depth: int, n_splits: int) -> list:
    """A random full binary tree of exactly ``depth`` levels and
    ``n_splits`` splits, as its leaves' paths: lists of (split, +1 left /
    -1 right) from the root, splits numbered as they were made."""
    paths = [[]]
    made = 0
    while made < n_splits:
        deep = [i for i, p in enumerate(paths) if len(p) < depth]
        longest = max(len(p) for p in paths)
        if longest < depth:  # first reach the depth, then grow at random
            deep = [i for i in deep if len(paths[i]) == longest]
        p = paths.pop(deep[int(rng.integers(len(deep)))])
        paths += [p + [(made, 1)], p + [(made, -1)]]
        made += 1
    return paths


def _caterpillar_paths(n_splits: int) -> list:
    """Split k's left child is leaf k, its right one split k + 1; the last
    split's right child is the last leaf: ``n_splits + 1`` leaves, one of
    them at depth ``n_splits``."""
    return ([[(j, -1) for j in range(k)] + [(k, 1)] for k in range(n_splits)]
            + [[(j, -1) for j in range(n_splits)]])


def _single_leaf_paths() -> list:
    """A one-leaf tree as the compiler packs it: a manufactured no-op split
    (feature 0, the top rank, missing → left) with the leaf on both sides
    (flink_jpmml_tpu_torch/compile/trees.py pack_ensemble)."""
    return [[(0, 1)], [(0, -1)]]


def forest_inputs(trees: list, n_fields: int, n_classes: int, seed: int,
                  pad_splits: int = 0, pad_leaves: int = 0,
                  single: tuple = ()) -> dict:
    """``qtrees_cuda.pack_tables``'s keyword arguments for trees given as
    leaf paths: split and leaf slots in a random order per tree (so the
    walk cannot lean on preorder numbering), ``pad_*`` unused slots beyond
    the largest tree (padded leaves carry count -5), random features,
    thresholds, missing directions and leaf rows (a bf16 hi/lo pair). The
    trees numbered in ``single`` are single-leaf trees
    (``_single_leaf_paths``): their split is the no-op one and both
    leaves carry the same row."""
    import torch

    rng = np.random.default_rng(seed)
    n_split = [1 + max(s for p in paths for s, _ in p) for paths in trees]
    S = max(n_split) + pad_splits
    L = max(len(paths) for paths in trees) + pad_leaves
    T = len(trees)
    feat = rng.integers(0, n_fields, size=(T, S))
    qthr = rng.integers(0, 255, size=(T, S)).astype(np.uint8)
    dleft = rng.random(size=(T, S)) < 0.5
    P = np.zeros((T, S, L), np.int8)
    count = np.full((T, L), -5, np.int8)
    vals = rng.normal(0.0, 1.0, size=(T, L, n_classes)).astype(np.float32)
    for t, paths in enumerate(trees):
        slot = rng.permutation(S)[: n_split[t]]
        leaf = rng.permutation(L)[: len(paths)]
        if t in single:
            feat[t, slot[0]], qthr[t, slot[0]], dleft[t, slot[0]] = 0, 254, True
            vals[t, leaf[1]] = vals[t, leaf[0]]
        for l, path in zip(leaf, paths):
            count[t, l] = len(path)
            for s, go in path:
                P[t, slot[s], l] = go
    v = torch.from_numpy(vals if n_classes > 1 else vals[..., 0])
    hi = v.to(torch.bfloat16)
    lo = (v - hi.float()).to(torch.bfloat16)
    return dict(feat=feat, qthr=qthr, dleft=dleft, P=P, count=count, hi=hi,
                lo=lo, n_fields=n_fields)


def ragged_forest(seed: int, n_trees: int, n_fields: int,
                  n_classes: int) -> dict:
    """``pack_tables``'s inputs for a seeded forest of mixed depths 1-12
    (up to 60 splits a tree), with single-leaf trees among them and padded
    split and leaf slots."""
    rng = np.random.default_rng(seed)
    # every depth once in each 12 trees, in a shuffled order
    depths = rng.permutation(np.resize(np.arange(1, 13), n_trees))
    single = tuple(range(3, n_trees, 17))
    trees = []
    for t, depth in enumerate(depths.tolist()):
        if t in single:
            trees.append(_single_leaf_paths())
            continue
        hi = min(60, 2 ** depth - 1)
        trees.append(_grow(rng, depth, int(rng.integers(depth, hi + 1))))
    return forest_inputs(trees, n_fields, n_classes, seed + 1,
                         pad_splits=2, pad_leaves=3, single=single)


def caterpillar_forest(seed: int, n_fields: int, n_classes: int) -> dict:
    """``pack_tables``'s inputs for three trees: the 64-split caterpillar
    (depth 64, 65 leaves: every split and leaf slot of the kernel's widest
    tree), a complete depth-2 tree and a single-leaf tree."""
    rng = np.random.default_rng(seed)
    trees = [_caterpillar_paths(64), _grow(rng, 2, 3), _single_leaf_paths()]
    out = forest_inputs(trees, n_fields, n_classes, seed + 1, single=(2,))
    # low thresholds and missing → right, so that records go deep: each
    # split sends ~3% of the uniform codes and ~5% of the missing ones left
    out["qthr"][0] = rng.integers(0, 16, size=64)
    out["dleft"][0] = rng.random(size=64) < 0.05
    return out


def random_codes(seed: int, n: int, n_fields: int, missing: float):
    """u8[n, F] rank codes: uniform over 0..254, ``missing`` of them the
    sentinel 255."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 255, size=(n, n_fields)).astype(np.uint8)
    codes[rng.random(size=codes.shape) < missing] = 255
    return codes


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


def model_tables(workdir: str, n_trees: int, name: str, votes=None):
    """gen_gbm (or, with ``votes`` = gen_vote_forest's keywords, a vote
    forest) → parse → compile on the card → (doc, compiled, rank-wire
    scorer)."""
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_vote_forest
    from flink_jpmml_tpu_torch.compile import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    if votes is None:
        path = gen_gbm(workdir, n_trees=n_trees, name=name)
    else:
        path = gen_vote_forest(workdir, n_trees=n_trees, name=name, **votes)
    doc = parse_pmml_file(path)
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


def check_kernel(q, X: np.ndarray, label: str, phase: str) -> dict:
    """Kernel vs plain version on the card for one model's tables and the
    wire's codes of ``X``, bit for bit."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    codes = torch.from_numpy(q.wire.encode(X)).cuda()
    return check_tables(tables, codes, label, phase)


def check_tables(tables: dict, codes, label: str, phase: str) -> dict:
    """Kernel vs plain version on the card, bit for bit: the walk and the
    masks select the same leaf, whose row both add in ascending tree
    order."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    got = qtrees_cuda.leaf_rows(codes, tables, codes.shape[1])
    ref = qtrees_cuda.leaf_rows_reference(codes, tables)
    torch.cuda.synchronize()
    N = codes.shape[0]
    T, _, C = tables["rows"].shape
    if got.shape != (N, C) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: bad kernel output {tuple(got.shape)}")
    depth = (tables["walk"][:, 0] >> 8) & 0xFF
    row = {
        "case": label, "rows": N, "trees": T, "classes": C,
        "depth_min": int(depth.min()), "depth_max": int(depth.max()),
        "missing_share": float((codes == qtrees_cuda.SENTINEL).float().mean()),
        "max_abs_err": float((got - ref).abs().max()),
        "ok": bool(torch.equal(got, ref)),
    }
    if not row["ok"]:
        emit({"phase": phase, **row})
        raise RuntimeError(f"{label}: kernel differs from its plain version")
    return row


def check_walk_cases(rng) -> list:
    """The kernel on forests the fixtures lack, bit for bit against its
    plain version: ragged depths 1-12 with single-leaf trees and padded
    slots (C = 1 and C = 3, and C = 16 over 256 fields: 64-thread blocks),
    and the 64-split caterpillar (depth 64, 65 leaves), each over a batch
    that is no multiple of a block's records."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    cases = [
        ("ragged200_c1_100003", ragged_forest(5, 200, 32, 1), 100_003),
        ("ragged200_c3_100003", ragged_forest(6, 200, 32, 3), 100_003),
        ("caterpillar64_c1_65537", caterpillar_forest(7, 32, 1), 65_537),
        ("caterpillar64_c16_4099", caterpillar_forest(8, 32, 16), 4_099),
        ("ragged60_f256_c16_5003", ragged_forest(9, 60, 256, 16), 5_003),
    ]
    rows = []
    for label, inputs, n in cases:
        tables = {k: torch.from_numpy(v).cuda()
                  for k, v in qtrees_cuda.pack_tables(**inputs).items()}
        codes = torch.from_numpy(random_codes(
            int(rng.integers(1 << 30)), n, inputs["n_fields"], MISSING)).cuda()
        rows.append(check_tables(tables, codes, label, "walk_kernel"))
    return rows


def vote_counts(q, codes) -> np.ndarray:
    """Exact integer vote counts i64[N, C] of a majorityVote forest: each
    tree's hit leaf label, from the front half and the leaf labels (not
    from the f32 class rows)."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    lab = q.params["lab"].long()
    n = codes.shape[0]
    counts = torch.zeros((n, len(q.labels)), dtype=torch.int64,
                         device=codes.device)
    rows = torch.arange(n, device=codes.device)
    ones = torch.ones(n, dtype=torch.int64, device=codes.device)
    for t, hit in qtrees_cuda._leaf_hits(codes, tables):
        if not bool((hit.sum(dim=1) == 1).all()):
            raise RuntimeError(f"tree {t}: not exactly one leaf hit")
        leaf = hit.long().argmax(dim=1)
        counts.index_put_((rows, lab[t, leaf]), ones, accumulate=True)
    return counts.cpu().numpy()


def check_votes(got, ref, counts: np.ndarray, label: str) -> dict:
    """(value, shares, label) triples ``got`` (the kernel path) against
    ``ref``: shares and values at the rank-wire bar, labels by the tie rule
    of the module docstring → errors and the number of tied rows."""
    gv, gp, gl = (np.asarray(a) for a in got)
    rv, rp, rl = (np.asarray(a) for a in ref)
    n = counts.shape[0]
    if gp.shape != rp.shape or not np.isfinite(gp).all():
        raise RuntimeError(f"{label}: shares {gp.shape} vs {rp.shape}")
    if not (np.allclose(gp, rp, rtol=RTOL, atol=ATOL)
            and np.allclose(gv, rv, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"{label}: shares or values differ: "
                           f"{float(np.abs(gp - rp).max())}")
    top = counts == counts.max(axis=1, keepdims=True)
    tied = top.sum(axis=1) > 1
    rows = np.arange(n)
    if not (np.array_equal(gl[~tied], rl[~tied])
            and np.array_equal(gl[tied], top.argmax(axis=1)[tied])
            and top[rows, rl][tied].all()):
        raise RuntimeError(f"{label}: labels break the tie rule")
    return {"max_abs_err": float(np.abs(gp - rp).max()),
            "value_max_abs_err": float(np.abs(gv - rv).max()),
            "tied_rows": int(tied.sum()),
            "tied_label_differs": int((gl != rl)[tied].sum())}


def needed_ops(codes, tables) -> dict:
    """The operations these inputs need: per record and tree, one integer
    step for each split on the hit leaf's path (the bits of its ``on``
    mask) and C f32 adds for its row; found with the plain front half."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    bits = torch.arange(64, device=codes.device)
    depth = ((tables["on"][..., None] >> bits) & 1).sum(dim=-1)  # [T, L]
    steps = hits = 0
    for t, hit in qtrees_cuda._leaf_hits(codes, tables):
        steps += int((hit * depth[t]).sum())
        hits += int(hit.sum())
    return {"int_steps": steps, "f32_adds": hits * tables["rows"].shape[2]}


def time_kernel(q, X: np.ndarray) -> dict:
    """CUDA-event medians of the kernel and its plain version on one batch,
    beside the least time the card could take: each input read once and
    the output written once over HBM's rate, or the needed integer steps
    and f32 adds over their pipes' rates, whichever is longer."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    codes = torch.from_numpy(q.wire.encode(X)).cuda()
    F = codes.shape[1]
    kern_ms = cuda_ms(lambda: qtrees_cuda.leaf_rows(codes, tables, F), 3, 20)
    plain_ms = cuda_ms(
        lambda: qtrees_cuda.leaf_rows_reference(codes, tables), 1, 3)
    N = codes.shape[0]
    T, S = tables["split"].shape
    _, L, C = tables["rows"].shape
    # what the kernel reads and writes: codes, the walk table, the output
    walk = tables["walk"]
    n_bytes = codes.numel() + 4 * N * C + walk.numel() * walk.element_size()
    ops = needed_ops(codes, tables)
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = max(ops["int_steps"] / PEAK_INT32_OPS_S,
                 ops["f32_adds"] / PEAK_F32_FLOP_S) * 1e3
    return {
        "rows": N, "trees": T, "splits": S, "leaves": L, "classes": C,
        "kernel_ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bytes": n_bytes, "bytes_ms": bytes_ms, "ops": ops, "ops_ms": ops_ms,
        # the walk's trip counts, depth[t] per record and tree, from the
        # headers: what the design executes, not measured on the card
        "design_int_steps": N * int(((walk[:, 0] >> 8) & 0xFF).sum()),
        "kernel_records_per_s": N / (kern_ms * 1e-3),
        "library_ms": None,
    }


def drive(cm, data: np.ndarray, sink, count: list, counter) -> dict:
    """BlockPipeline over ``data`` until MIN_DISPATCHES dispatches of
    DISPATCH records reached the sink; ``counter`` (a kernel wrapper) is
    reset just before and read just after."""
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        CyclingBlockSource,
    )
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

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
    counter.launches = 0
    t0 = time.perf_counter()
    pipe.start()
    deadline = t0 + 600
    while (count[0] < target and pipe.error is None
           and time.perf_counter() < deadline):
        time.sleep(0.01)
    pipe.stop()
    pipe.join(timeout=60)
    dt = time.perf_counter() - t0
    launches = counter.launches
    snap = pipe.metrics.snapshot()
    dispatches = int(snap["batches"])
    if count[0] < target:
        raise RuntimeError(f"main path scored {count[0]} < {target} records")
    if launches < dispatches or launches == 0:
        raise RuntimeError(f"{launches} kernel launches for {dispatches} "
                           "dispatches")
    return {
        "backend": pipe.backend,
        "records": count[0], "seconds": dt, "records_per_s": count[0] / dt,
        "dispatches": dispatches, "launches": launches,
        "records_per_dispatch": snap["batch_fill_records"] / max(dispatches, 1),
        "encode_s": snap.get("encode_s"), "h2d_stall_s": snap.get("h2d_stall_s"),
        "batch_latency_p50_s": snap.get("batch_latency_s_p50"),
        "batch_latency_p99_s": snap.get("batch_latency_s_p99"),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from flink_jpmml_tpu_torch.compile import qtrees_cuda
    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.compile.qtrees import _match_ensemble, _torch_qfn

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "torch_device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    qtrees_cuda.build()
    ptxas = qtrees_cuda.ptxas_report()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": "flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu",
          "arch": "sm_90a", "ptxas": ptxas})
    if not ptxas or any(k.get("spill_stores", 1) or k.get("spill_loads", 1)
                        for k in ptxas):
        raise RuntimeError("ptxas reported spills (or no report)")

    rng = np.random.default_rng(0)
    workdir = tempfile.mkdtemp(prefix="fjt-smoke-")
    doc, cm, q = model_tables(workdir, 500, "gbm_500.pmml")
    _, _, q19 = model_tables(workdir, 19, "gbm_19.pmml")
    F = len(q.wire.fields)
    X_main = features(rng, DISPATCH, F)
    rows = [
        check_kernel(q, X_main, "gbm500_262144", "kernel"),
        check_kernel(q19, features(rng, 65536, F), "gbm19_65536", "kernel"),
        check_kernel(q, features(rng, 100_003, F), "gbm500_ragged_100003",
                     "kernel"),
    ]
    emit({"phase": "kernel", "cases": rows})
    # its own generator, so the main paths' data stay as they were
    wrows = check_walk_cases(np.random.default_rng(1))
    emit({"phase": "walk_kernel", "cases": wrows})
    timing = time_kernel(q, X_main)
    emit({"phase": "timing", **timing})

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
    run = drive(cm, data, sink, count, qtrees_cuda.leaf_rows)
    launches = run["launches"]

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
        "phase": "main_path", **run,
        "cpu_backend": f"rank_wire_{q_cpu.backend}",
        "cpu_check_rows": sample, "cpu_check_max_abs_err": err,
        "twin_check_max_abs_err": twin_err,
    })

    # -- vote forest: kernel -----------------------------------------------
    vote_kw = dict(depth=6, n_features=32, n_classes=3, seed=0)
    vdoc, vcm, vq = model_tables(workdir, 500, "votes_500.pmml",
                                 votes=vote_kw)
    _, _, vq_w = model_tables(workdir, 500, "votes_w500.pmml",
                              votes=dict(vote_kw, weighted=True))
    _, _, vq19 = model_tables(workdir, 19, "votes_19.pmml", votes=vote_kw)
    _, _, vq_c10 = model_tables(workdir, 500, "votes_c10.pmml",
                                votes=dict(vote_kw, n_classes=10))
    vrows = [
        check_kernel(vq, X_main, "votes500_262144", "vote_kernel"),
        check_kernel(vq_w, X_main, "weighted500_262144", "vote_kernel"),
        check_kernel(vq19, features(rng, 65536, F), "votes19_65536",
                     "vote_kernel"),
        check_kernel(vq_c10, features(rng, 65536, F), "votes500_c10_65536",
                     "vote_kernel"),
        check_kernel(vq, features(rng, 100_003, F), "votes500_ragged_100003",
                     "vote_kernel"),
    ]
    emit({"phase": "vote_kernel", "cases": vrows})
    vtiming = time_kernel(vq, X_main)
    emit({"phase": "vote_timing", **vtiming})

    # -- vote forest: main path ----------------------------------------------
    vkept = {}
    vcount = [0]
    C = len(vq.labels)

    def vote_sink(out, n, first_off):
        value, probs, lab = (np.asarray(o) for o in out)
        if (value.ndim != 1 or value.shape[0] < n
                or probs.shape != (value.shape[0], C)
                or lab.shape != value.shape):
            raise RuntimeError(f"vote sink got {value.shape} / {probs.shape}"
                               f" / {lab.shape} for {n} records")
        if first_off == 0:
            vkept["head"] = tuple(a[:sample].copy()
                                  for a in (value, probs, lab))
        vcount[0] += n

    vq.predict_wire(vq.wire.encode(data[:BATCH]))
    torch.cuda.synchronize()
    vrun = drive(vcm, data, vote_sink, vcount, qtrees_cuda.leaf_rows)

    head_codes = vq.wire.encode(data[:sample])
    counts = vote_counts(vq, torch.from_numpy(head_codes).cuda())
    vq_cpu = compile_pmml(vdoc, batch_size=BATCH,
                          device="cpu").quantized_scorer()
    cpu_ref = [o.numpy()[:sample] for o in vq_cpu.predict_padded(
        *vq_cpu.pad_wire(head_codes))]
    cpu_check = check_votes(vkept["head"], cpu_ref, counts, "CPU port")
    vtwin = _torch_qfn(_match_ensemble(vdoc)[2], True, False,
                       vq.wire.sentinel, vdoc.targets)
    with torch.no_grad():
        twin_ref = [o.cpu().numpy() for o in vtwin(
            vq.params, torch.from_numpy(head_codes).cuda())]
    twin_check = check_votes(vkept["head"], twin_ref, counts, "torch twin")
    emit({
        "phase": "vote_main_path", **vrun,
        "cpu_backend": f"rank_wire_{vq_cpu.backend}",
        "check_rows": sample, "cpu_check": cpu_check,
        "twin_check": twin_check,
    })

    def kernel_entry(name, replaces, launches, checked, t):
        return {
            "name": name, "route": "cuda",
            "source": "flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "ops": t["ops"],
        }

    # one kernel, two paths: each entry reads its own path's launches
    emit({"kernels": [
        kernel_entry("qtrees_leaf_rows (regression sum, C=1)",
                     "flink_jpmml_tpu/compile/qtrees_pallas.py:170 and :218",
                     launches,
                     rows + [r for r in wrows if r["classes"] == 1], timing),
        kernel_entry("qtrees_leaf_rows (vote shares)",
                     "flink_jpmml_tpu/compile/qtrees_pallas.py:187 and :238",
                     vrun["launches"],
                     vrows + [r for r in wrows if r["classes"] > 1], vtiming),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
