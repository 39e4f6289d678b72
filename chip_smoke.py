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

10. native — builds the C++ host data plane
    (``flink_jpmml_tpu_torch/_native/fjt_native.cpp``, g++) and prints its
    build seconds and the host's core count; holds the C++ bucketizer
    (``QuantizedWire.encode``) byte for byte to its plain version
    (``encode_reference``, numpy) on the GBM's uint8 lockstep tables, a
    skewed uint8 wire that takes the ragged branch, a uint16 model
    (``gen_gbm(hist_bins=None)``) and a skewed uint16 wire, over cells
    with NaN, ±inf, exact cut values and ±0.0 (``edge_cells``); and
    times both at [262144, 32] on the host (median ms);
11. encode stage — the device encode stage (``encode_device``) on the
    card against the host encode, byte for byte and dtype for dtype, on
    the GBM, the vote forest and the uint16 model, with the same cells;
    its CUDA-event median ms per 262,144 records; and the uint16 model
    scored on the card host-encoded and fused (the torch twin over a
    staged uint16 batch) against the CPU port;
12. fused main path / vote fused main path — 6 and 9 again with no
    ``encode_mode`` set, so the scorer takes its own placement on the
    card, which must be fused: raw f32 ships (128 bytes a record) and the
    encode stage runs on the card in front of the kernel; the heads are
    held to the CPU port as in 6 and 9;
13. kafka wire — a port ``MiniKafkaBroker`` on loopback holding 1,048,576
    rows of the GBM's feature stream (the main paths' generator, seed 0;
    128 MiB of values) appended with ``append_rows`` (the C++ encoder);
    read back through ``KafkaClient`` and ``decode_record_batches_rows``,
    rows and offsets byte-identical to the appended array; the C++,
    vectorized and Python row decoders equal on the log's first 20,480
    records; the append seconds, and the C++ and vectorized decoders'
    host ms per 262,144 rows beside the host's core count;
14. kafka main path — the fused GBM scored by ``BlockPipeline`` (as in
    6, no ``encode_mode`` set) from a ``KafkaBlockSource`` over that
    broker, which seeks back to 0 at the high watermark (``max_wait_ms``
    20, the default ``max_bytes``: about 30,000 records a fetch), through
    the prefetch sidecar, with one registry shared by the source and the
    pipeline, until 19 × 262,144 records reached the sink; the first
    4,096-record head is held to the CPU port at rtol 1e-4 / atol 1e-5;
    its dispatches are deadline drains, yet only their live rows cross
    the bus, so it must ship 128 bytes a record like 12; it prints the
    decode and fetch times, the prefetch counters, the ``kafka_lag``
    gauge and its age, the lag forecaster, the pressure score and the
    record count of every dispatch;
15. kafka main path serial — 14 again with ``prefetch=False``: fetch and
    decode on the pipeline's ingest thread, the sidecar's ablation;
16. device shares — for each main path, the kernel's, the encode
    stage's and the H2D copy's timed milliseconds times the dispatches,
    over the wall: an estimate of the card's idle share (the H2D copies
    of 262,144 records' codes and f32 cells from pinned memory are timed
    in phase 11); for the Kafka paths, whose dispatches hold what the
    ring held, the kernel, the encode stage and the H2D copy are timed at
    each dispatch size the path ran (K compile batches) and weighted by
    its dispatches and live rows.

Every main path runs the C++ ring, and its line carries the stage ledger
of its registry (``attribution``: per stage the count, total ms, p50 /
p99 ms and share of ``obs.attr.summary``; on the card ``h2d`` is host
staging plus the issue of the copy, and the card's time shows up as
``queue_wait`` and ``readback``). Phases 6 and 9 set the scorer's
``encode_mode = "host"`` (the C++ bucketizer); each main path prints the
encode placement that ran (``encode_mode``), with ``h2d_bytes`` per
record: 32 host-encoded, 128 fused.

The generators (``ragged_forest``, ``caterpillar_forest``,
``random_codes``, ``edge_cells``, ``synthetic_wire``) import nothing
beyond numpy and torch and the port; the CPU tests import them too, so
the card and the CPU see the same trees and cells.

Then the kernels line, the ``nvidia-smi`` line, and last the contract
line ``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script exits non-zero without printing the last line. Without a CUDA
device, or without the port beside it, it exits 1 at once. The flight
recorder's directory and the generated model files live in a temporary
directory that the run removes; the broker, the source and the
pipelines' threads are stopped whether a phase passes or fails.
"""

from __future__ import annotations

import json
import os
import statistics
import shutil
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


def edge_cells(rng, cuts, n: int) -> np.ndarray:
    """f32[n, F] cells for the encode checks: N(0, 1.5) values, with 20%
    NaN, 2% +inf, 2% -inf, 3% -0.0, 3% +0.0 and 10% exact cut values of
    the cell's own feature (where it has cuts)."""
    F = len(cuts)
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    u = rng.random(size=(n, F))
    for j, c in enumerate(cuts):
        sel = (u[:, j] >= 0.30) & (u[:, j] < 0.40)
        if len(c):
            X[sel, j] = c[rng.integers(0, len(c), size=int(sel.sum()))]
    X[u < MISSING] = np.nan
    X[(u >= 0.20) & (u < 0.22)] = np.inf
    X[(u >= 0.22) & (u < 0.24)] = -np.inf
    X[(u >= 0.24) & (u < 0.27)] = -0.0
    X[(u >= 0.27) & (u < 0.30)] = 0.0
    return X


def synthetic_wire(seed: int, sizes, dtype):
    """A rank wire over made-up cut tables of the given sizes (0.0 among
    each non-empty table, so ±0.0 cells meet a cut), uint8 or uint16,
    with a missingValueReplacement on every third field."""
    from flink_jpmml_tpu_torch.compile.qtrees import QuantizedWire

    rng = np.random.default_rng(seed)
    cuts = tuple(
        np.unique(np.concatenate([[0.0], rng.normal(0.0, 1.5, size=k - 1)])
                  .astype(np.float32)) if k else np.empty(0, np.float32)
        for k in sizes)
    F = len(sizes)
    has_repl = np.arange(F) % 3 == 1
    repl = np.where(has_repl, rng.normal(0.0, 1.0, size=F), 0.0)
    return QuantizedWire(
        fields=tuple(f"x{j}" for j in range(F)), cuts=cuts, dtype=dtype,
        sentinel=int(np.iinfo(dtype).max), repl=repl.astype(np.float32),
        has_repl=has_repl)


def skewed_sizes(n_fields: int, long: int) -> list:
    """Cut-table sizes with one long table among short ones, so that the
    padding blowup sends the host encode down the ragged branch."""
    return [long] + [4, 0, 7] * ((n_fields - 1) // 3) + [3] * ((n_fields - 1) % 3)


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


def host_ms(fn, repeats: int) -> float:
    """Median host milliseconds of ``fn()`` (one warm-up call first)."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_codes(got: np.ndarray, ref: np.ndarray, label: str,
                phase: str) -> dict:
    """Rank codes against the plain version: dtype for dtype, byte for
    byte."""
    row = {"case": label, "rows": int(ref.shape[0]), "fields": int(ref.shape[1]),
           "dtype": str(got.dtype),
           "sentinel_share": float((ref == np.iinfo(ref.dtype).max).mean()),
           "mismatches": int((got != ref).sum()) if got.shape == ref.shape
           else -1,
           "ok": bool(got.dtype == ref.dtype and np.array_equal(got, ref))}
    if not row["ok"]:
        emit({"phase": phase, **row, "ref_dtype": str(ref.dtype)})
        raise RuntimeError(f"{label}: codes differ from the plain version")
    return row


def check_native(rng, wires) -> dict:
    """Build the C++ host plane; hold its bucketizer to the numpy plain
    version on each ``(label, wire, branch, rows)`` and time both on the
    first wire at DISPATCH rows."""
    from flink_jpmml_tpu_torch.runtime import native

    built_before = native.lib_path().exists()
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    cases = []
    for label, wire, branch, rows in wires:
        taken = "lockstep" if wire._pow2_tables()[0] is not None else "ragged"
        if taken != branch:
            raise RuntimeError(f"{label}: takes the {taken} branch, "
                               f"not {branch}")
        X = edge_cells(rng, wire.cuts, rows)
        row = check_codes(wire.encode(X), wire.encode_reference(X), label,
                          "native")
        cases.append({**row, "branch": taken})
    wire = wires[0][1]
    X = edge_cells(rng, wire.cuts, DISPATCH)
    native_ms = host_ms(lambda: wire.encode(X), 7)
    plain_ms = host_ms(lambda: wire.encode_reference(X), 3)
    return {
        "source": "flink_jpmml_tpu_torch/_native/fjt_native.cpp",
        "build_s": build_s, "built_before": built_before,
        "host_cpus": os.cpu_count(),
        "host_cpus_usable": len(os.sched_getaffinity(0)),
        "cases": cases, "timed_case": wires[0][0],
        "timed_rows": DISPATCH, "native_ms": native_ms, "plain_ms": plain_ms,
        "native_records_per_s": DISPATCH / (native_ms * 1e-3),
    }


def check_encode_stage(rng, scorers, q16_cpu) -> dict:
    """The device encode stage on the card against the host encode, byte
    for byte, on each ``(label, scorer, rows)``; its CUDA-event time at
    DISPATCH rows on the first scorer; and the uint16 scorer (the last)
    scored host-encoded and fused on the card against the CPU port."""
    import torch

    cases = []
    for label, q, rows in scorers:
        X = edge_cells(rng, q.wire.cuts, rows)
        got = q.encode_device(X)
        if got.device.type != "cuda":
            raise RuntimeError(f"{label}: encode stage ran on {got.device}")
        cases.append(check_codes(got.cpu().numpy(), q.wire.encode(X), label,
                                 "encode_stage"))
    q = scorers[0][1]
    X = edge_cells(rng, q.wire.cuts, DISPATCH)
    Xd = torch.from_numpy(X).cuda()
    stage_ms = cuda_ms(lambda: q.encode_device(Xd), 3, 20)
    F = Xd.shape[1]
    # what each placement copies to the card a dispatch, from pinned memory
    pinned_f32 = torch.from_numpy(X).pin_memory()
    pinned_codes = torch.from_numpy(q.wire.encode(X)).pin_memory()
    h2d_f32_ms = cuda_ms(lambda: pinned_f32.to("cuda", non_blocking=True), 3, 20)
    h2d_codes_ms = cuda_ms(
        lambda: pinned_codes.to("cuda", non_blocking=True), 3, 20)
    # the stage reads the f32 batch and writes the codes once
    n_bytes = Xd.numel() * 4 + Xd.numel() * np.dtype(q.wire.dtype).itemsize
    label16, q16, _ = scorers[-1]
    X = edge_cells(rng, q16.wire.cuts, q16.batch_size)
    ref = q16_cpu.predict_wire(q16_cpu.wire.encode(X)).numpy()
    host = q16.predict_wire(q16.wire.encode(X)).cpu().numpy()
    fused = q16.predict_fused(X).cpu().numpy()
    errs = {"host_vs_cpu": float(np.abs(host - ref).max()),
            "fused_vs_cpu": float(np.abs(fused - ref).max()),
            "fused_vs_host": float(np.abs(fused - host).max())}
    if not (np.isfinite(host).all() and np.allclose(host, ref, rtol=RTOL, atol=ATOL)
            and np.allclose(fused, ref, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"{label16} scored on the card differs from the "
                           f"CPU port: {errs}")
    return {
        "cases": cases, "timed_case": scorers[0][0], "timed_rows": DISPATCH,
        "fields": F, "stage_ms": stage_ms,
        "stage_records_per_s": DISPATCH / (stage_ms * 1e-3),
        "h2d_f32_ms": h2d_f32_ms, "h2d_codes_ms": h2d_codes_ms,
        "bytes": n_bytes, "bytes_ms": n_bytes / PEAK_BYTES_S * 1e3,
        "uint16_scoring": {"case": label16, "backend": q16.backend,
                           "rows": int(X.shape[0]), **errs},
    }


def device_shares(run: dict, kernel_ms: float, stage_ms: float = 0.0,
                  h2d_ms: float = 0.0) -> dict:
    """The kernel's, the encode stage's and the H2D copies' shares of a
    main path's wall, from their timed milliseconds a dispatch: an
    estimate of the card's busy share, not a profiler trace."""
    n, wall_ms = run["dispatches"], run["seconds"] * 1e3
    busy = n * (kernel_ms + stage_ms + h2d_ms) / wall_ms
    return {"kernel_share": n * kernel_ms / wall_ms,
            "stage_share": n * stage_ms / wall_ms,
            "h2d_share": n * h2d_ms / wall_ms,
            "device_idle_share_est": 1.0 - busy}


def drive(cm, source, sink, count: list, counter, *, metrics=None,
          prefetch=None, target: int = MIN_DISPATCHES * DISPATCH) -> dict:
    """BlockPipeline over ``source`` until ``target`` records reached the
    sink, in dispatches of up to DISPATCH records; ``counter`` (a kernel
    wrapper) is reset just before and read just after. The line carries
    the pipeline's stage ledger (``attribution``: ``obs.attr.summary`` of
    its registry)."""
    from flink_jpmml_tpu_torch.obs import attr
    from flink_jpmml_tpu_torch.runtime.block import BlockPipeline
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    pipe = BlockPipeline(
        source,
        cm,
        sink,
        RuntimeConfig(batch=BatchConfig(
            size=BATCH, deadline_us=5000, queue_capacity=4 * DISPATCH,
        )),
        metrics=metrics,
        max_dispatch_chunks=DISPATCH // BATCH,
        prefetch=prefetch,
    )
    if pipe.backend != "rank_wire_cuda":
        raise RuntimeError(f"pipeline backend {pipe.backend}")
    q = cm.quantized_scorer()
    placement = q.encode_placement
    counter.launches = 0
    t0 = time.perf_counter()
    pipe.start()
    deadline = t0 + 600
    try:
        while (count[0] < target and pipe.error is None
               and time.perf_counter() < deadline):
            time.sleep(0.01)
    finally:
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
    if snap.get(f"encode_{placement}") != dispatches:
        raise RuntimeError(f"{snap.get(f'encode_{placement}')} of "
                           f"{dispatches} dispatches encoded by {placement}")
    # only live rows cross the bus (a deadline drain's alignment rows
    # are zeroed on the card), so every path ships exactly its bytes
    h2d_per_record = snap["h2d_bytes"] / snap["batch_fill_records"]
    if h2d_per_record != q.staged_bytes_per_record:
        raise RuntimeError(f"{h2d_per_record} H2D bytes a record, expected "
                           f"{q.staged_bytes_per_record} ({placement})")
    encode_s = snap.get("encode_s", 0.0)
    return {
        "backend": pipe.backend, "encode_mode": placement,
        "source": type(pipe._source).__name__,
        "host_cpus": os.cpu_count(),
        "records": count[0], "seconds": dt, "records_per_s": count[0] / dt,
        "dispatches": dispatches, "launches": launches,
        "launches_per_dispatch": launches / dispatches,
        "records_per_dispatch": snap["batch_fill_records"] / max(dispatches, 1),
        "h2d_bytes_per_record": h2d_per_record,
        "encode_s": encode_s, "encode_share": encode_s / dt,
        "encode_ms_per_dispatch": 1e3 * encode_s / dispatches,
        "h2d_stall_s": snap.get("h2d_stall_s"),
        "batch_latency_p50_s": snap.get("batch_latency_s_p50"),
        "batch_latency_p99_s": snap.get("batch_latency_s_p99"),
        "attribution": attr.summary(pipe.metrics),
    }


def kafka_wire(rows: np.ndarray) -> tuple:
    """A port ``MiniKafkaBroker`` holding ``rows`` (appended with the C++
    encoder), read back through ``KafkaClient`` and
    ``decode_record_batches_rows``: rows and offsets byte-identical to the
    appended array, and the C++, vectorized and Python row decoders
    equal on the log's head. → (broker, phase line); the caller closes
    the broker."""
    from flink_jpmml_tpu_torch.runtime import kafka

    n = rows.shape[0]
    broker = kafka.MiniKafkaBroker(topic="smoke")
    try:
        t0 = time.perf_counter()
        broker.append_rows(rows)
        append_s = time.perf_counter() - t0
        client = kafka.KafkaClient(broker.host, broker.port)
        try:
            t0 = time.perf_counter()
            pos, fetches, offs, got = 0, 0, [], []
            while pos < n:
                hw, raw = client.fetch_raw("smoke", 0, pos)
                o, r = kafka.decode_record_batches_rows(raw, rows.shape[1])
                keep = o >= pos
                offs.append(o[keep])
                got.append(r[keep])
                pos = int(o[-1]) + 1
                fetches += 1
            read_s = time.perf_counter() - t0
        finally:
            client.close()
        offs, got = np.concatenate(offs), np.concatenate(got)
        if (hw != n or offs.tobytes() != np.arange(n, dtype=np.int64).tobytes()
                or got.tobytes() != rows.tobytes()):
            raise RuntimeError("rows read back from the broker differ from "
                               "the appended rows")
        # one record set of the log's first DISPATCH rows, as stored
        segs = broker._segs[0]
        head = b"".join(b for base, _, b in segs if base < DISPATCH)
        prefix = b"".join(b for base, _, b in segs if base < 20_000)
        F = rows.shape[1]
        tiers = {}
        for name, fn in (("cpp", kafka.decode_record_batches_rows),
                         ("vectorized", kafka.decode_record_batches_rows_vec),
                         ("python", kafka.decode_record_batches_rows_py)):
            o, r = fn(prefix, F)
            tiers[name] = (o.tobytes(), r.tobytes())
        if len({v for v in tiers.values()}) != 1:
            raise RuntimeError("the row decoders disagree on the log's head")
        n_prefix = len(tiers["python"][0]) // 8
        if tiers["python"][1] != rows[:n_prefix].tobytes():
            raise RuntimeError("the Python row decoder differs from the rows")
        cpp_ms = host_ms(lambda: kafka.decode_record_batches_rows(head, F), 7)
        vec_ms = host_ms(lambda: kafka.decode_record_batches_rows_vec(head, F),
                         1)
        py_ms = host_ms(lambda: kafka.decode_record_batches_rows_py(prefix, F),
                        1)
    except BaseException:
        broker.close()
        raise
    return broker, {
        "rows": n, "fields": F, "value_bytes": rows.nbytes,
        "log_bytes": sum(len(b) for _, _, b in segs),
        "append_s": append_s, "read_back_s": read_s, "fetches": fetches,
        "rows_per_fetch": n / fetches, "read_back_identical": True,
        "host_cpus": os.cpu_count(),
        "host_cpus_usable": len(os.sched_getaffinity(0)),
        "decode_rows": DISPATCH, "cpp_decode_ms": cpp_ms,
        "vectorized_decode_ms": vec_ms,
        "python_check_rows": n_prefix, "python_decode_ms": py_ms,
        "python_ms_per_dispatch_rows": py_ms * DISPATCH / n_prefix,
        "tiers_identical": True,
    }


def kafka_main_path(cm, broker, n_cols: int, counter, prefetch,
                    sample: int, ref: np.ndarray) -> dict:
    """``drive`` over a ``KafkaBlockSource`` reading ``broker`` on
    loopback that seeks back to 0 at the high watermark (a finite log
    sustains the run), with one registry shared by the source, the
    sidecar (``prefetch``: None = auto, on for the Kafka source; False =
    the serial ablation) and the pipeline. After a seek the offsets
    restart and the sink sees ``first_off == 0`` again: only the first
    head is kept. The port's pipeline has no checkpoints yet, so the
    committed offset going back is harmless here. The sink keeps every
    dispatch's record count: ``dispatch_shapes`` maps K compile batches
    to ``[dispatches, live records]``, what ``kafka_device_shares``
    times."""
    from flink_jpmml_tpu_torch.runtime import prefetch as prefetch_mod
    from flink_jpmml_tpu_torch.runtime.kafka import KafkaBlockSource
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    hw = broker.high_watermark

    class CyclingKafka(KafkaBlockSource):
        def poll(self):
            if self._next >= hw:
                self.seek(0)
            return super().poll()

    reg = MetricsRegistry()
    src = CyclingKafka(broker.host, broker.port, broker.topic, n_cols=n_cols,
                       max_wait_ms=20, metrics=reg)
    kept, count, sizes = {}, [0], []

    def sink(out, n, first_off):
        vals = np.asarray(out)
        if vals.ndim != 1 or vals.shape[0] < n:
            raise RuntimeError(f"sink got {vals.shape} for {n} records")
        if first_off == 0 and "head" not in kept:
            kept["head"] = vals[:sample].copy()
        count[0] += n
        sizes.append(n)

    try:
        run = drive(cm, src, sink, count, counter, metrics=reg,
                    prefetch=prefetch, target=19 * DISPATCH)
    finally:
        src.close()
    if (run["encode_mode"] != "fused"
            or run["h2d_bytes_per_record"] != 4 * n_cols):
        raise RuntimeError(f"Kafka path ran {run['encode_mode']} with "
                           f"{run['h2d_bytes_per_record']} bytes a record")
    if len(sizes) != run["dispatches"] or sum(sizes) != run["records"]:
        raise RuntimeError(f"{len(sizes)} sink calls with {sum(sizes)} "
                           f"records for {run['dispatches']} dispatches of "
                           f"{run['records']}")
    shapes = {}
    for n in sizes:
        k = -(-n // BATCH)
        row = shapes.setdefault(k, [0, 0])
        row[0] += 1
        row[1] += n
    head = kept["head"]
    err = float(np.abs(head - ref).max())
    if (head.shape != (sample,) or not np.isfinite(head).all()
            or not np.allclose(head, ref, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"Kafka path disagrees with the CPU port: {err}")
    st = reg.struct_snapshot()
    cs, gs, hs = st["counters"], st["gauges"], reg.snapshot()
    sidecar = run["source"] == "PrefetchedBlockSource"
    if sidecar != (prefetch is None):
        raise RuntimeError(f"source {run['source']} with prefetch={prefetch}")
    return {
        **run, "log_records": hw, "cpu_check_rows": sample,
        "cpu_check_max_abs_err": err,
        "dispatch_records": {"min": min(sizes),
                             "p50": float(np.median(sizes)),
                             "max": max(sizes)},
        "dispatch_shapes": dict(sorted(shapes.items())),
        "kafka_decode_s": cs.get("kafka_decode_s", 0.0),
        "kafka_decode_ms_per_dispatch_rows":
            1e3 * cs.get("kafka_decode_s", 0.0) * DISPATCH / run["records"],
        "kafka_fetch_s_p50": hs.get("kafka_fetch_s_p50"),
        "kafka_fetch_s_p99": hs.get("kafka_fetch_s_p99"),
        "prefetch": {
            "enabled": True, "depth": prefetch_mod.env_depth(),
            "batches": int(cs.get("prefetch_batches", 0)),
            "records": int(cs.get("prefetch_records", 0)),
            "depth_max": gs.get("prefetch_depth", {}).get("max", 0.0),
            "occupancy_max": gs.get("prefetch_occupancy", {}).get("max", 0.0),
            "stall_ms": 1000 * cs.get("prefetch_stall_s", 0.0),
            "block_ms": 1000 * cs.get("prefetch_block_s", 0.0),
        } if sidecar else {"enabled": False},
        "kafka_lag": {k: v["value"] for k, v in gs.items()
                      if k.startswith("kafka_lag{")},
        # the per-registry planes the source and the score loop tick:
        # the lag forecaster (no backlog grows on a cycling log, so the
        # drain ETA and the trend read 0), the lag readings' age, and
        # the composite backpressure score
        "lag_forecast": {k: gs[k]["value"] for k in
                         ("lag_drain_eta_s", "lag_trend", "lag_diverging")
                         if k in gs},
        "kafka_lag_age_s": {k: v["value"] for k, v in gs.items()
                            if k.startswith("kafka_lag_age_s{")},
        "pressure": {k: gs[k]["value"] for k in
                     ("pressure", "pressure_ring", "pressure_window",
                      "pressure_wait", "pressure_prefetch") if k in gs},
    }


def kafka_device_shares(run: dict, q, rng) -> dict:
    """A Kafka path's card busy share from its own dispatch shapes: for
    each size of K compile batches, the kernel and the encode stage timed
    at K × BATCH rows times the dispatches of that size, and the H2D copy
    timed at K × BATCH rows scaled by the live rows those dispatches
    shipped. An estimate of the card's busy share, not a profiler
    trace."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    F = len(q.wire.fields)
    kern = stage = h2d = 0.0
    timed = {}
    for k, (n_disp, live) in run["dispatch_shapes"].items():
        X = features(rng, k * BATCH, F)
        Xd = torch.from_numpy(X).cuda()
        codes = q.encode_device(Xd)
        pinned = torch.from_numpy(X).pin_memory()
        t = {"kernel_ms": cuda_ms(
                 lambda: qtrees_cuda.leaf_rows(codes, tables, F), 3, 20),
             "stage_ms": cuda_ms(lambda: q.encode_device(Xd), 3, 20),
             "h2d_f32_ms": cuda_ms(
                 lambda: pinned.to("cuda", non_blocking=True), 3, 20)}
        timed[k] = t
        kern += n_disp * t["kernel_ms"]
        stage += n_disp * t["stage_ms"]
        h2d += live / (k * BATCH) * t["h2d_f32_ms"]
    wall_ms = run["seconds"] * 1e3
    return {"kernel_share": kern / wall_ms, "stage_share": stage / wall_ms,
            "h2d_share": h2d / wall_ms,
            "device_idle_share_est": 1.0 - (kern + stage + h2d) / wall_ms,
            "timed_by_batches": timed}


def main() -> int:
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if importlib.util.find_spec("flink_jpmml_tpu_torch") is None:
        print("chip_smoke: the port (flink_jpmml_tpu_torch) is not beside "
              "this script; run it from the root of a checkout",
              file=sys.stderr)
        return 1
    # the flight recorder and the model files live in temporary
    # directories that the run removes
    scratch = tempfile.mkdtemp(prefix="fjt-smoke-")
    os.environ["FJT_FLIGHT_DIR"] = os.path.join(scratch, "flight")
    try:
        return run_phases(scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def run_phases(workdir: str) -> int:
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda
    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.compile.qtrees import _match_ensemble, _torch_qfn
    from flink_jpmml_tpu_torch.runtime.block import CyclingBlockSource

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
    doc, cm, q = model_tables(workdir, 500, "gbm_500.pmml")
    _, _, q19 = model_tables(workdir, 19, "gbm_19.pmml")
    F = len(q.wire.fields)

    # -- the C++ host plane (before anything else encodes) -------------------
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    doc16 = parse_pmml_file(gen_gbm(workdir, n_trees=500, name="gbm_u16.pmml",
                                    hist_bins=None))
    q16 = compile_pmml(doc16, batch_size=1024).quantized_scorer()
    q16_cpu = compile_pmml(doc16, batch_size=1024,
                           device="cpu").quantized_scorer()
    if q16.wire.dtype is not np.uint16 or not q16.supports_fused:
        raise RuntimeError(f"gbm_u16: wire {q16.wire.dtype}, fused "
                           f"{q16.supports_fused}")
    nat = check_native(np.random.default_rng(2), [
        ("gbm500_u8_lockstep", q.wire, "lockstep", DISPATCH),
        ("skewed_u8_ragged", synthetic_wire(3, skewed_sizes(F, 200), np.uint8),
         "ragged", 100_003),
        ("gbm500_u16_lockstep", q16.wire, "lockstep", 100_003),
        ("skewed_u16_ragged",
         synthetic_wire(4, skewed_sizes(F, 3000), np.uint16), "ragged",
         100_003),
    ])
    emit({"phase": "native", **nat})
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

    # warm the path once outside the counted window; the host encode is
    # asked for by hand (the card's default is the fused placement)
    q.encode_mode = "host"
    q.predict_wire(q.wire.encode(data[:BATCH]))
    torch.cuda.synchronize()
    run = drive(cm, CyclingBlockSource(data, block_size=DISPATCH), sink, count,
                qtrees_cuda.leaf_rows)

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

    vq.encode_mode = "host"
    vq.predict_wire(vq.wire.encode(data[:BATCH]))
    torch.cuda.synchronize()
    vrun = drive(vcm, CyclingBlockSource(data, block_size=DISPATCH), vote_sink,
                 vcount, qtrees_cuda.leaf_rows)

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

    # -- the device encode stage ----------------------------------------------
    enc = check_encode_stage(np.random.default_rng(3), [
        ("gbm500_u8", q, DISPATCH), ("votes500_u8", vq, 100_003),
        ("gbm500_u16", q16, 100_003),
    ], q16_cpu)
    emit({"phase": "encode_stage", **enc})

    # -- the main paths again, fused: raw f32 ships, encoded on the card -----
    # (the scorer's own choice on the card, with no encode_mode set)
    q.encode_mode = None
    fkept = {}
    fcount = [0]

    def fused_sink(out, n, first_off):
        vals = np.asarray(out)
        if vals.ndim != 1 or vals.shape[0] < n:
            raise RuntimeError(f"sink got {vals.shape} for {n} records")
        if first_off == 0:
            fkept["head"] = vals[:sample].copy()
        fcount[0] += n

    q.predict_fused(data[:BATCH])
    torch.cuda.synchronize()
    frun = drive(cm, CyclingBlockSource(data, block_size=DISPATCH),
                 fused_sink, fcount, qtrees_cuda.leaf_rows)
    if frun["encode_mode"] != "fused" or frun["h2d_bytes_per_record"] != 4 * F:
        raise RuntimeError(f"fused main path ran {frun['encode_mode']} with "
                           f"{frun['h2d_bytes_per_record']} bytes a record")
    fhead = fkept["head"]
    ferr = float(np.abs(fhead - ref).max())
    if (fhead.shape != (sample,) or not np.isfinite(fhead).all()
            or not np.allclose(fhead, ref, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"fused main path disagrees with the CPU port: "
                           f"{ferr}")
    emit({"phase": "fused_main_path", **frun, "cpu_check_rows": sample,
          "cpu_check_max_abs_err": ferr,
          "host_path_max_abs_diff": float(np.abs(fhead - head).max())})

    vq.encode_mode = None
    vfkept = {}

    def vote_fused_sink(out, n, first_off):
        if first_off == 0:
            vfkept["head"] = tuple(np.asarray(o)[:sample].copy() for o in out)
        vote_sink(out, n, first_off)

    vq.predict_fused(data[:BATCH])
    torch.cuda.synchronize()
    vcount[0] = 0
    vfrun = drive(vcm, CyclingBlockSource(data, block_size=DISPATCH),
                  vote_fused_sink, vcount, qtrees_cuda.leaf_rows)
    if (vfrun["encode_mode"] != "fused"
            or vfrun["h2d_bytes_per_record"] != 4 * F):
        raise RuntimeError(f"vote fused path ran {vfrun['encode_mode']} with "
                           f"{vfrun['h2d_bytes_per_record']} bytes a record")
    vf_check = check_votes(vfkept["head"], cpu_ref, counts, "CPU port, fused")
    emit({"phase": "vote_fused_main_path", **vfrun, "check_rows": sample,
          "cpu_check": vf_check})
    # -- the GBM fed from a Kafka stream on loopback, fused ------------------
    # 1,048,576 rows of the feature stream (128 MiB of values), the same
    # generator as the main paths' data, seed 0
    kdata = features(np.random.default_rng(0), 4 * DISPATCH, F)
    kref = np.asarray(q_cpu.predict_padded(q_cpu.wire.encode(kdata[:sample])))
    broker, wire = kafka_wire(kdata)
    try:
        emit({"phase": "kafka_wire", **wire})
        krun = kafka_main_path(cm, broker, F, qtrees_cuda.leaf_rows, None,
                               sample, kref)
        emit({"phase": "kafka_main_path", **krun})
        ksrun = kafka_main_path(cm, broker, F, qtrees_cuda.leaf_rows, False,
                                sample, kref)
        emit({"phase": "kafka_main_path_serial", **ksrun})
    finally:
        broker.close()
    emit({"phase": "device_shares",
          "main_path": device_shares(run, timing["kernel_ms"], 0.0,
                                     enc["h2d_codes_ms"]),
          "vote_main_path": device_shares(vrun, vtiming["kernel_ms"], 0.0,
                                          enc["h2d_codes_ms"]),
          "fused_main_path": device_shares(frun, timing["kernel_ms"],
                                           enc["stage_ms"], enc["h2d_f32_ms"]),
          "vote_fused_main_path": device_shares(
              vfrun, vtiming["kernel_ms"], enc["stage_ms"],
              enc["h2d_f32_ms"]),
          # timed at the Kafka paths' own dispatch shapes
          "kafka_main_path": kafka_device_shares(
              krun, q, np.random.default_rng(5)),
          "kafka_main_path_serial": kafka_device_shares(
              ksrun, q, np.random.default_rng(5))})

    def kernel_entry(name, replaces, runs, checked, t):
        return {
            "name": name, "route": "cuda",
            "source": "flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu",
            "replaces": replaces,
            "launches": sum(r["launches"] for r in runs.values()),
            "launches_by_path": {k: r["launches"] for k, r in runs.items()},
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "ops": t["ops"],
        }

    # one kernel, four paths: each entry reads its own paths' launches
    emit({"kernels": [
        kernel_entry("qtrees_leaf_rows (regression sum, C=1)",
                     "flink_jpmml_tpu/compile/qtrees_pallas.py:170 and :218",
                     {"main_path": run, "fused_main_path": frun,
                      "kafka_main_path": krun,
                      "kafka_main_path_serial": ksrun},
                     rows + [r for r in wrows if r["classes"] == 1], timing),
        kernel_entry("qtrees_leaf_rows (vote shares)",
                     "flink_jpmml_tpu/compile/qtrees_pallas.py:187 and :238",
                     {"vote_main_path": vrun, "vote_fused_main_path": vfrun},
                     vrows + [r for r in wrows if r["classes"] > 1], vtiming),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
