"""Hopper kernel for the rank-wire tree ensembles, its plain version, and
the host packer of its tables.

Replaces the Pallas TPU kernels ``flink_jpmml_tpu/compile/qtrees_pallas.py``
``_kernel`` / ``_kernel_mega`` (the f32[B] ensemble sum of a regression
forest) and ``_kernel_cls`` / ``_kernel_mega_cls`` (the f32[B, C] vote
shares of a majorityVote / weightedMajorityVote forest), all four built on
``_leaf_hits``. On Hopper the tree loop lives inside the block, and each
tree hits exactly one leaf, so one CUDA kernel (``csrc/qtrees_ensemble.cu``)
serves all four: per record, the f32 sum over trees of the hit leaf's
f32[C] row, with C = 1 for the regression sum, trees added in ascending
order, one f32 add per class per tree.

Bound on an H100: per record the kernel moves F bytes of codes in and
4·C bytes out (about 3 µs for 262,144 32-feature records at 3.35 TB/s);
the inputs need one integer step per split on each tree's hit path and
C f32 adds per tree (for 500 complete depth-6 trees, 7.9e8 integer steps
per 262,144 records: 47 µs at the card's 1.67e13/s INT32 issue rate, 132
SMs × 64 INT32 lanes × 1.98 GHz). It is bound by operations. The kernel
walks each tree from the root to the hit leaf, ``depth[t]`` steps per
record and tree, so it executes what the inputs need and little more
(a leaf reached early idles for the rest of the tree's depth); the
design note at the top of the ``.cu`` file says how and what is left.

Tables (``pack_tables``, numpy, host side). The TPU kernel's one-hot
feature-select matmul and block-diagonal int8 path matrices exist because
gathers are slow on a TPU; on Hopper the kernel gathers each split's code
directly. The plain version keeps the path matrix as two 64-bit masks per
leaf; the kernel reads the ``walk`` table:

- ``split`` i32[T, S]: ``feat | qthr << 16 | dleft << 24`` per split;
- ``on`` i64[T, L]: bit s set iff split s lies on the leaf's path;
- ``left`` i64[T, L]: bit s set iff the path goes left at split s;
- ``rows`` f32[T, L, C]: each leaf's row, ``f32(hi) + f32(lo)`` of the
  JAX package's bf16 pair — ``vhi`` / ``vlo`` (leaf values, aggregate
  coefficients folded in, C = 1) or ``phi`` / ``plo`` (class rows);
- ``walk`` i64[T, W]: one slice per tree, W even so that every slice is
  a multiple of 16 bytes. Word 0 is the header ``root | depth << 8``;
  words 1 .. S are the split nodes (node ``1 + s`` for split slot s),
  words S + 1 .. S + L the leaf nodes (node ``1 + S + l``), then the
  tree's ``rows`` as f32 pairs. A split's node word is ``feat | qthr << 8
  | dleft << 16 | left << 32 | right << 40`` with ``left`` / ``right`` its
  children's node numbers (8 bits each: S ≤ 64 allows 65 leaves, 7 bits
  would not reach the last); a leaf's word names itself as both children,
  so the walk idles on it. ``depth`` is the tree's longest path, so every
  lane of a warp takes the same number of steps through a tree.

Leaf l is hit iff ``(go & on[l]) == left[l]``; this equals the JAX
package's ``sign @ P == count`` because ``count`` is the number of nonzero
``P`` entries on the path. Padded leaves (``count = -5``) get ``on = 0,
left = 1`` and never match; in ``walk`` padded split and leaf slots are
zero words that no child names. ``_pack_walk`` orders each leaf's path by
the number of leaves under each of its splits (the root has them all), not
by the split numbering, and raises unless the paths form a full binary
tree, so the walk reaches exactly the leaf the masks select.

Dispatch (``leaf_rows``): a CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain PyTorch version (:func:`leaf_rows_reference`,
the mask form), with the same arithmetic and the same ascending-tree f32
order. There is no fall-back from one to the other. ``threads`` and
``chunk_bytes`` choose the launch shape (:func:`launch_shape`; left out,
the default shape), which the kernel search (``compile/autotune.py``)
varies; a shape the card cannot take raises before the launch. The kernel
reads only
``walk``; the wrapper takes the other tables' shapes for its dimensions,
and the mask tables stay for the plain version. The kernel is built with
``nvcc`` from the repository's sources on first use, into ``build/`` beside
the package (bound through a plain C interface with ``ctypes``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import pathlib
import re
import shutil
import threading
import weakref
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.utils.build import BUILD_DIR, build_shared
from flink_jpmml_tpu_torch.utils.build import lib_path as build_lib_path
from flink_jpmml_tpu_torch.utils.exceptions import FlinkJpmmlTpuError

SENTINEL = 255  # uint8 wire missing code
MAX_SPLITS = 64  # one 64-bit go-left mask per tree
MAX_FIELDS = 256  # a node word holds the feature in 8 bits
# the kernel keeps one f32 accumulator per class in registers; 16 covers
# every vote forest of the repo's fixtures (3 classes) with room, and a
# wider target stays on the torch twin. Must equal kMaxClasses in the .cu
# source.
MAX_CLASSES = 16
TABLE_KEYS = ("split", "on", "left", "rows", "walk")
# the launch shape (launch_shape): the .cu source's launch() takes the
# shape chosen here and checks it against the first four, each equal to
# its constant there
MAX_THREADS = 256  # kMaxThreads (also the kernel's __launch_bounds__)
RECORDS_PER_THREAD = 4  # kRecordsPerThread
SMEM_MAX = 232448  # kSmemMax: 227 KB, a block's limit
BAR_BYTES = 16  # kBarBytes
CHUNK_BYTES = 24 * 1024  # the default tree tables per buffer
SMEM_TARGET = 112 * 1024  # the default block's budget: two blocks per SM

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "qtrees_ensemble.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(FlinkJpmmlTpuError):
    """nvcc is missing or refused the kernel source."""


class KernelLaunchError(FlinkJpmmlTpuError):
    """The CUDA runtime reported an error for a kernel launch.
    ``cuda_error`` is its ``cudaError_t`` code (``runtime/devfault.py``
    reads the fault's kind from it)."""

    def __init__(self, message: str, cuda_error: Optional[int] = None):
        super().__init__(message)
        self.cuda_error = cuda_error


# ---------------------------------------------------------------------------
# Host packer
# ---------------------------------------------------------------------------


def walk_words(S: int, L: int, C: int) -> int:
    """Words per tree in the ``walk`` table: the header, S split and L
    leaf nodes, L·C f32 rows, rounded up to an even count (16 bytes)."""
    words = 1 + S + L + (L * C + 1) // 2
    return words + words % 2


def _pack_masks(feat, qthr, dleft, P, count, n_fields) -> Dict[str, np.ndarray]:
    """``split`` / ``on`` / ``left`` of one forest (see the module
    docstring). Raises ValueError on shapes the kernel does not take."""
    T, S = feat.shape
    if S > MAX_SPLITS:
        raise ValueError(f"{S} split slots per tree > {MAX_SPLITS}")
    if not 0 < n_fields <= MAX_FIELDS:
        raise ValueError(f"{n_fields} fields outside (0, {MAX_FIELDS}]")
    feat = np.asarray(feat, np.int64)
    if feat.size and (feat.min() < 0 or feat.max() >= n_fields):
        raise ValueError("split feature index outside the field space")
    qthr = np.asarray(qthr)
    if qthr.size and int(qthr.max()) > 255:
        raise ValueError("rank threshold does not fit the uint8 wire")
    P = np.asarray(P, np.int64)
    count = np.asarray(count, np.int64)
    on_path = P != 0
    nnz = on_path.sum(axis=1)  # [T, L]
    real = count >= 0
    if np.any(nnz[real] != count[real]) or np.any(nnz[~real] != 0):
        raise ValueError(
            "path counts disagree with the path matrix: the mask form of "
            "the leaf test would select other leaves"
        )
    bit = np.uint64(1) << np.arange(S, dtype=np.uint64)  # [S]
    on = (on_path.astype(np.uint64) * bit[None, :, None]).sum(
        axis=1, dtype=np.uint64
    )
    left = ((P > 0).astype(np.uint64) * bit[None, :, None]).sum(
        axis=1, dtype=np.uint64
    )
    on[~real] = 0
    left[~real] = 1  # (go & 0) == 1 never holds
    split = (
        feat.astype(np.uint32)
        | (qthr.astype(np.uint32) << np.uint32(16))
        | (np.asarray(dleft, bool).astype(np.uint32) << np.uint32(24))
    )
    return {
        "split": split.view(np.int32),
        "on": on.view(np.int64),
        "left": left.view(np.int64),
    }


def _pack_walk(feat, qthr, dleft, P, count) -> np.ndarray:
    """The ``walk`` node words of one forest, i64[T, 1 + S + L] (see the
    module docstring; :func:`pack_tables` appends the rows). Raises
    ValueError unless each tree's real leaves (``count >= 0``) and the
    splits on their paths form a full binary tree.

    Each leaf's path is put in root-to-leaf order by the number of real
    leaves under each of its splits, which falls strictly from the root
    (all of them) along every path of a full binary tree; consecutive
    splits on the path give a parent's child on the path's side, the last
    one the leaf. Then the tree check: no child slot is named twice with
    different nodes, every split on a path has both children, all paths
    start at one root, and every other node has exactly one parent. Since
    the leaf count falls strictly along every edge there is no cycle, so
    the nodes form a full binary tree whose root-to-leaf paths are the
    leaves' paths."""
    feat = np.asarray(feat, np.int64)
    qthr = np.asarray(qthr, np.int64)
    dleft = np.asarray(dleft, bool).astype(np.int64)
    P = np.asarray(P, np.int64)
    T, S, L = P.shape
    n_nodes = 1 + S + L
    if n_nodes > 256:
        raise ValueError(f"{S} split and {L} leaf slots: node numbers do not "
                         "fit 8 bits")
    real = np.asarray(count) >= 0  # [T, L]
    no_leaf = ~real.any(axis=1)
    if no_leaf.any():
        raise ValueError(f"tree {int(np.argmax(no_leaf))} has no real leaf")
    on = (P != 0) & real[:, None, :]  # [T, S, L]
    under = on.sum(axis=2)  # [T, S]: real leaves under each split
    path_len = on.sum(axis=1)  # [T, L]
    # each leaf's splits, most leaves under first; off-path splits last
    key = np.where(on, under[:, :, None], -1)
    order = np.argsort(-key, axis=1, kind="stable")  # [T, S, L]
    ranked = np.take_along_axis(key, order, axis=1)
    step = np.arange(S)[None, :, None]
    on_path = step < path_len[:, None, :]  # [T, S, L]: k-th split exists
    falls = ranked[:, :-1] > ranked[:, 1:]
    _raise_at(~falls & on_path[:, 1:], "a leaf's path is no root-to-leaf "
              "chain (two of its splits have as many leaves under them)")

    # edges: the k-th split of each path → the (k+1)-th, or the leaf
    leaf_node = np.broadcast_to(1 + S + np.arange(L), (T, L))
    nxt = np.concatenate([1 + order[:, 1:], np.zeros((T, 1, L), np.int64)],
                         axis=1)
    last = step == (path_len[:, None, :] - 1)
    child_of = np.where(last, leaf_node[:, None, :], nxt)
    go = np.take_along_axis(P, order, axis=1)  # direction at the k-th split
    tt, kk, ll = np.nonzero(on_path)
    parent = 1 + order[tt, kk, ll]
    side = (go[tt, kk, ll] < 0).astype(np.int64)  # 0: left, 1: right
    kid = child_of[tt, kk, ll]
    kid_min = np.full((T, n_nodes, 2), n_nodes, np.int64)
    child = np.zeros((T, n_nodes, 2), np.int64)  # 0 where no child
    np.minimum.at(kid_min, (tt, parent, side), kid)
    np.maximum.at(child, (tt, parent, side), kid)
    _raise_at(((child > 0) & (kid_min != child)).any(axis=(1, 2)),
              "a split has two children on one side (two leaves share a "
              "path)")
    splits = under > 0  # [T, S]: the splits on some real leaf's path
    _raise_at((splits & ~(child[:, 1:S + 1] > 0).all(axis=2)).any(axis=1),
              "a split lacks a child")
    first = np.where(path_len > 0, 1 + order[:, 0, :], leaf_node)
    root = np.where(real, first, n_nodes).min(axis=1)  # [T]
    _raise_at((real & (first != root[:, None])).any(axis=1),
              "the leaves' paths start at more than one root")
    parents = np.zeros((T, n_nodes), np.int64)
    for side in (0, 1):
        np.add.at(parents, (np.arange(T)[:, None], child[:, :, side]), 1)
    parents[:, 0] = 0  # "no child" entries
    is_node = np.concatenate([np.zeros((T, 1), bool), splits, real], axis=1)
    want = is_node.astype(np.int64)
    want[np.arange(T), root] = 0
    _raise_at((parents != want).any(axis=1),
              "a node is not reached exactly once from the root")

    words = np.zeros((T, n_nodes), np.int64)
    words[:, 0] = root | np.where(real, path_len, 0).max(axis=1) << 8
    words[:, 1:S + 1] = np.where(
        splits,
        feat | qthr << 8 | dleft << 16
        | child[:, 1:S + 1, 0] << 32 | child[:, 1:S + 1, 1] << 40,
        0,
    )
    words[:, S + 1:] = np.where(real, leaf_node << 32 | leaf_node << 40, 0)
    return words


def _raise_at(bad: np.ndarray, what: str) -> None:
    """ValueError naming the first tree (axis 0) where ``bad`` holds."""
    trees = np.flatnonzero(bad.reshape(bad.shape[0], -1).any(axis=1))
    if trees.size:
        raise ValueError(f"tree {int(trees[0])}: {what}; the walk takes "
                         "only full binary trees")


def pack_tables(
    feat: np.ndarray,   # i[T, S] feature index per split
    qthr: np.ndarray,   # u8[T, S] rank thresholds
    dleft: np.ndarray,  # bool[T, S] missing → left
    P: np.ndarray,      # i8[T, S, L] path matrix (+1 left, -1 right, 0 off)
    count: np.ndarray,  # i8[T, L] path lengths (-5 = padded leaf)
    hi: torch.Tensor,   # bf16[T, L] leaf values or bf16[T, L, C] class rows
    lo: torch.Tensor,   # bf16, the low half of the same
    n_fields: int,
) -> Dict[str, np.ndarray]:
    """Per-tree tables of the kernel (see the module docstring). Raises
    ValueError on shapes the kernel does not take.

    ``rows`` is ``f32(hi) + f32(lo)``, with a trailing axis of 1 for a
    [T, L] pair: exact in f32 (lo lies below hi's last bit, so the pair
    spans at most 17 significant bits), and no product of the kernel
    touches it, so one f32 table carries the pair without loss. A kernel
    that moves the rows onto tensor-core products must take the pair apart
    again (ROADMAP, "Precision trap")."""
    T, S = np.shape(feat)
    L = np.shape(P)[2]
    if hi.dtype != torch.bfloat16 or lo.dtype != torch.bfloat16:
        raise ValueError(f"leaf rows must be a bf16 pair, got {hi.dtype} / "
                         f"{lo.dtype}")
    if hi.dim() == 2:
        hi, lo = hi[..., None], lo[..., None]
    if hi.dim() != 3 or tuple(hi.shape[:2]) != (T, L) or hi.shape != lo.shape:
        raise ValueError(f"leaf rows {tuple(hi.shape)} / {tuple(lo.shape)} "
                         f"do not match [{T}, {L}, C]")
    C = hi.shape[2]
    if not 0 < C <= MAX_CLASSES:
        raise ValueError(f"{C} classes outside (0, {MAX_CLASSES}]")
    out = _pack_masks(feat, qthr, dleft, P, count, n_fields)
    out["rows"] = np.ascontiguousarray(
        (hi.float() + lo.float()).cpu().numpy(), np.float32
    )
    nodes = _pack_walk(feat, qthr, dleft, P, count)
    rows = np.zeros((T, 2 * (walk_words(S, L, C) - nodes.shape[1])),
                    np.float32)
    rows[:, : L * C] = out["rows"].reshape(T, L * C)
    out["walk"] = np.concatenate([nodes, rows.view(np.int64)], axis=1)
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _leaf_hits(
    codes: torch.Tensor, tables: Dict[str, torch.Tensor]
) -> Iterator[Tuple[int, torch.Tensor]]:
    """The kernel's front half in plain PyTorch: for each tree t in
    ascending order, ``(t, hit)`` with ``hit`` bool[N, L] the leaves whose
    path masks the record's go-left mask matches."""
    split = tables["split"].long() & 0xFFFFFFFF
    feat = split & 0xFFFF
    qthr = (split >> 16) & 0xFF
    dleft = ((split >> 24) & 1).bool()
    on, left = tables["on"], tables["left"]
    T, S = split.shape
    shifts = torch.arange(S, device=codes.device)
    x_all = codes.long()
    for t in range(T):
        x = x_all[:, feat[t]]  # [N, S]
        go_bit = torch.where(x == SENTINEL, dleft[t], x <= qthr[t])
        # distinct powers of two: the sum is the bitwise or
        go = (go_bit.long() << shifts).sum(dim=1)  # [N]
        yield t, (go[:, None] & on[t][None, :]) == left[t][None, :]


def leaf_rows_reference(codes: torch.Tensor, tables: Dict[str, torch.Tensor]):
    """Plain PyTorch version of the kernel: u8[N, F] codes → f32[N, C].

    The same front half as the kernel; per tree the last hit leaf's row
    (none: nothing) is added to the f32 accumulator, one add per class,
    trees in ascending order, so its sums are the kernel's bit for bit."""
    rows = tables["rows"]
    L, C = rows.shape[1], rows.shape[2]
    leaf_ids = torch.arange(L, device=codes.device)
    acc = torch.zeros((codes.shape[0], C), dtype=torch.float32,
                      device=codes.device)
    for t, hit in _leaf_hits(codes, tables):
        idx = torch.where(hit, leaf_ids[None, :], -1).amax(dim=1)  # [N]
        row = rows[t][idx.clamp(min=0)]  # [N, C]
        acc = acc + torch.where(idx[:, None] >= 0, row, 0.0)
    return acc


# ---------------------------------------------------------------------------
# The kernel: build, bind, launch
# ---------------------------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()
# the launch counts are bumped from the scoring thread and the registry's
# warm threads at once
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def build() -> ctypes.CDLL:
    """Compile ``csrc/qtrees_ensemble.cu`` for sm_90a (once per source
    content and flags, :func:`~flink_jpmml_tpu_torch.utils.build.build_shared`)
    and bind its entry point; → the loaded library. ptxas's report lands
    beside the library (:func:`ptxas_report`)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib_path = _lib_path()
        if not lib_path.exists():
            report = build_shared(_nvcc(), NVCC_FLAGS, SOURCE, lib_path,
                                  KernelBuildError)
            if report is not None:
                lib_path.with_suffix(".ptxas.txt").write_text(report)
        lib = ctypes.CDLL(str(lib_path))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qtrees_leaf_rows.argtypes = [
            p, i64, i32, p, i32, i32, i32, i32, i32, i32, i32, i32, p, p]
        lib.qtrees_leaf_rows.restype = ctypes.c_int
        lib.qtrees_leaf_rows_packed.argtypes = [
            p, p, i32, i64, i32, i32, i64, i32, i32, p, p]
        lib.qtrees_leaf_rows_packed.restype = ctypes.c_int
        lib.qtrees_packed_resident_blocks.argtypes = [
            i32, i32, i64, i32, ctypes.POINTER(ctypes.c_int)]
        lib.qtrees_packed_resident_blocks.restype = ctypes.c_int
        _LIB = lib
        return lib


def _lib_path() -> pathlib.Path:
    return build_lib_path(BUILD_DIR, "qtrees_ensemble", SOURCE, NVCC_FLAGS)


def ptxas_report() -> list:
    """Per kernel of the built library, what ``-Xptxas -v`` said:
    ``{"kernel", "registers", "smem_bytes", "stack_bytes", "spill_stores",
    "spill_loads"}`` (static shared memory; the tables and codes are
    dynamic). Empty before :func:`build` compiled the current source."""
    log = _lib_path().with_suffix(".ptxas.txt")
    if not log.exists():
        return []
    out = []
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append({"kernel": m.group(1)})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[-1].update(stack_bytes=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1].update(registers=int(m.group(1)),
                           smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def _check_tables(tables: Dict[str, torch.Tensor], device: torch.device):
    """Types, shapes and placement of the tables that run on ``device`` →
    (T, S, L, C), read from the shapes of ``split`` and ``rows``. On the
    card only ``walk``, the kernel's one table, must be there; on the CPU
    the plain version reads ``split``, ``on``, ``left`` and ``rows``."""
    split, rows = tables["split"], tables["rows"]
    if split.dim() != 2 or rows.dim() != 3:
        raise ValueError(f"tables 'split' {tuple(split.shape)} / 'rows' "
                         f"{tuple(rows.shape)} must be 2-D / 3-D")
    (T, S), (L, C) = split.shape, rows.shape[1:]
    if S > MAX_SPLITS:
        raise ValueError(f"{S} split slots per tree > {MAX_SPLITS}")
    if not 0 < C <= MAX_CLASSES:
        raise ValueError(f"{C} classes outside (0, {MAX_CLASSES}]")
    expect = {"walk": (torch.int64, (T, walk_words(S, L, C)))}
    if device.type == "cpu":
        expect.update({
            "split": (torch.int32, (T, S)),
            "on": (torch.int64, (T, L)),
            "left": (torch.int64, (T, L)),
            "rows": (torch.float32, (T, L, C)),
        })
    for key, (dtype, shape) in expect.items():
        t = tables[key]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"table {key!r}: {t.dtype}{tuple(t.shape)}, kernel takes "
                f"{dtype}{shape}"
            )
        if t.device != device or not t.is_contiguous():
            raise ValueError(
                f"table {key!r} must be contiguous on {device} (got "
                f"{t.device}, contiguous={t.is_contiguous()})"
            )
    # the kernel copies whole 16-byte tree slices of it
    if device.type == "cuda" and tables["walk"].data_ptr() % 16:
        raise ValueError("table 'walk' must start on a 16-byte boundary")
    return T, S, L, C


def staged_row_stride(n_fields: int) -> int:
    """Bytes of one record's codes in the kernel's shared tile: an odd
    number of 4-byte words (``staged_row_stride`` in the .cu source)."""
    words = (n_fields + 3) // 4
    if words % 2 == 0:
        words += 1
    return 4 * words


def launch_shape(n_fields: int, n_trees: int, tree_words: int,
                 threads: Optional[int] = None,
                 chunk_bytes: Optional[int] = None) -> Tuple[int, int, int]:
    """The kernel's launch shape for a table of ``n_trees`` slices of
    ``tree_words`` words and codes of ``n_fields`` fields →
    ``(threads, chunk_trees, smem_bytes)``; the .cu source's ``launch()``
    takes the first two as they are. ``chunk_bytes`` (None: ``CHUNK_BYTES``) is the
    tree tables a shared-memory buffer holds, at least one tree;
    ``threads`` (None: the most, halving from ``MAX_THREADS``, whose
    shared memory fits ``SMEM_TARGET``) the block's threads. Raises
    ValueError for a shape the card cannot take: threads not a positive
    multiple of 32 up to ``MAX_THREADS``, or a block over ``SMEM_MAX``
    bytes of shared memory."""
    if chunk_bytes is not None and chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes {chunk_bytes} must be positive")
    row_stride = staged_row_stride(n_fields)
    tree_bytes = tree_words * 8
    chunk_trees = min(max((chunk_bytes or CHUNK_BYTES) // tree_bytes, 1),
                      max(n_trees, 1))
    tables = BAR_BYTES + 2 * chunk_trees * tree_bytes
    if threads is None:
        threads = MAX_THREADS
        while (threads > 32 and tables + threads * RECORDS_PER_THREAD
               * row_stride > SMEM_TARGET):
            threads //= 2
    elif threads <= 0 or threads % 32 or threads > MAX_THREADS:
        raise ValueError(f"{threads} threads per block: the kernel takes a "
                         f"multiple of 32 up to {MAX_THREADS}")
    smem = tables + threads * RECORDS_PER_THREAD * row_stride
    if smem > SMEM_MAX:
        raise ValueError(f"{threads} threads and {chunk_trees} trees a chunk "
                         f"need {smem} bytes of shared memory, over the "
                         f"block's {SMEM_MAX}")
    return threads, chunk_trees, smem


def _check_codes(codes: torch.Tensor, n_fields: int) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be u8[N, F], got {codes.dtype}"
                         f"{tuple(codes.shape)}")
    if codes.shape[1] != n_fields:
        raise ValueError(f"codes have {codes.shape[1]} fields, the tables "
                         f"were packed for {n_fields}")
    if not 0 < n_fields <= MAX_FIELDS:
        raise ValueError(f"{n_fields} fields outside (0, {MAX_FIELDS}]")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {codes.device}")
    if codes.device.type == "cuda" and not codes.is_contiguous():
        raise ValueError("codes must be contiguous")


def leaf_rows(codes: torch.Tensor, tables: Dict[str, torch.Tensor],
              n_fields: int, threads: Optional[int] = None,
              chunk_bytes: Optional[int] = None):
    """u8[N, F] rank codes → f32[N, C]: per record, the sum over trees of
    the hit leaf's row — the ensemble sum before Targets (C = 1) or the
    vote shares of a majorityVote / weightedMajorityVote forest (the
    weights are folded into the rows).

    ``n_fields`` is the field count the tables were packed for
    (:func:`pack_tables`); codes of another width raise, since the kernel
    gathers ``code[feat]`` from a row of exactly that width. On a CUDA
    tensor: launch the kernel on the current stream (counted in
    ``leaf_rows.launches`` and, by class count C, in
    ``leaf_rows.launches_by_classes``) or raise — on codes of another width, more than
    ``MAX_CLASSES`` classes, or a ``walk`` table that is not on the card
    (the other tables lend only their shapes). On a CPU tensor: the plain
    version, with all five tables on the CPU.

    ``threads`` and ``chunk_bytes`` set the kernel's launch shape
    (:func:`launch_shape`; None: the default shape). A shape the
    card cannot take raises ValueError before any launch, on either
    device; the plain version reads no launch shape."""
    _check_codes(codes, n_fields)
    T, S, L, C = _check_tables(tables, codes.device)
    threads, chunk_trees, _ = launch_shape(
        n_fields, T, walk_words(S, L, C), threads, chunk_bytes)
    if codes.device.type == "cpu":
        return leaf_rows_reference(codes, tables)
    lib = build()
    N, F = codes.shape
    out = torch.empty((N, C), dtype=torch.float32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = lib.qtrees_leaf_rows(
        codes.data_ptr(), N, F, tables["walk"].data_ptr(), T,
        tables["walk"].shape[1], S, L, C, SENTINEL, threads, chunk_trees,
        out.data_ptr(), stream,
    )
    if rc != 0:
        raise KernelLaunchError(f"qtrees_leaf_rows launch failed: "
                                f"cudaError {rc}", cuda_error=rc)
    with _COUNT_LOCK:
        leaf_rows.launches += 1
        by_c = leaf_rows.launches_by_classes
        by_c[C] = by_c.get(C, 0) + 1
    return out


leaf_rows.launches = 0
leaf_rows.launches_by_classes = {}


# ---------------------------------------------------------------------------
# The packed launch: many members' walks in one launch
# ---------------------------------------------------------------------------

# words of one member's descriptor (DescWord in the .cu source)
DESC_WORDS = 16
(_D_CODES_OFF, _D_ROWS, _D_SRC_STRIDE, _D_FIELDS, _D_WALK, _D_TREES,
 _D_TREE_WORDS, _D_CHUNK_TREES, _D_LEAF_BASE, _D_ROW_WORD, _D_CLASSES,
 _D_OUT_OFF, _D_BLOCK_BEGIN, _D_ROW_STRIDE) = range(14)
# the packed launch's blocks, (threads, records a thread), largest tile
# first and, for one tile, fewest records a thread first: the packed
# kernel has an instance for each records count (kR)
PACKED_BLOCKS = ((256, 4), (256, 2), (128, 4), (256, 1), (128, 2), (64, 4),
                 (128, 1), (64, 2), (32, 4), (64, 1), (32, 2), (32, 1))
# the card the packed shape is sized for (an H100 SXM): its SMs and what
# one SM gives its resident blocks (the .cu source sets the largest
# shared-memory carveout for the packed kernel)
SM_COUNT = 132
SM_SMEM = 233472  # 228 KB of shared memory an SM
SM_SMEM_RESERVED = 1024  # the runtime's own shared memory a block
SM_SMEM_UNIT = 128  # shared memory is allocated in these steps
SM_THREADS = 2048
SM_BLOCKS = 32
SM_REGISTERS = 65536
# members a packed launch takes: its descriptor table is a kernel
# parameter (kMaxPackMembers in the .cu source)
MAX_PACK_MEMBERS = 64
# a member of at least this many rows has at least half of its blocks'
# lanes live
HALF_LIVE_ROWS = 64


class PackedShape(NamedTuple):
    """A packed launch's shape (:func:`packed_shape`): ``threads`` a block
    and ``records_per_thread`` (the tile is their product), and per member
    its ``chunks`` (trees a table buffer), ``bufs`` (table buffers: 1 when
    one chunk holds the whole table) and ``blocks``; ``smem`` bytes of
    shared memory a block (the largest need among the members) and the
    blocks of this shape one SM holds (``resident``)."""

    threads: int
    records_per_thread: int
    chunks: Tuple[int, ...]
    bufs: Tuple[int, ...]
    blocks: Tuple[int, ...]
    smem: int
    resident: int

    @property
    def tile(self) -> int:
        return self.threads * self.records_per_thread

    @property
    def n_blocks(self) -> int:
        return sum(self.blocks)

    @property
    def slots(self) -> int:
        """Blocks the card holds at once at this shape."""
        return SM_COUNT * self.resident


def class_bucket(n_classes: int) -> int:
    """The accumulator bucket of a class count: 1, 4 or ``MAX_CLASSES``."""
    return 1 if n_classes == 1 else 4 if n_classes <= 4 else MAX_CLASSES


def packed_min_blocks(n_classes: int, records_per_thread: int) -> int:
    """Blocks of ``MAX_THREADS`` threads the packed instance for
    ``n_classes`` and ``records_per_thread`` fits in one SM's registers:
    its ``__launch_bounds__`` (``packed_min_blocks`` in the .cu source)."""
    bucket = class_bucket(n_classes)
    if bucket == MAX_CLASSES:
        return {1: 6, 2: 4}.get(records_per_thread, 2)
    return 5 if bucket == 4 and records_per_thread == 4 else 8


def packed_resident(threads: int, records_per_thread: int, smem: int,
                    n_classes: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of dynamic shared
    memory that one SM holds: the least that its shared memory (with the
    runtime's reserve, in allocation steps), its threads, its registers
    (each thread at the register cap its instance's ``__launch_bounds__``
    sets, so this many at least) and its block limit allow."""
    per_block = -(-(smem + SM_SMEM_RESERVED) // SM_SMEM_UNIT) * SM_SMEM_UNIT
    regs = (SM_REGISTERS // (packed_min_blocks(n_classes, records_per_thread)
                             * MAX_THREADS)) // 8 * 8
    by_regs = SM_REGISTERS // (regs * 32) // (threads // 32)
    return min(SM_SMEM // per_block, SM_THREADS // threads, by_regs,
               SM_BLOCKS)


def packed_shape(members, rows, n_classes: int = 1) -> PackedShape:
    """The launch shape of a packed launch over ``members``, each
    ``(n_fields, n_trees, tree_words, threads, chunk_bytes)`` as its solo
    launch takes them (:func:`launch_shape`; None: the default), with
    ``rows[m]`` live rows each and ``n_classes`` the largest class count.

    Each member keeps its own chunk of trees (the kernel search's
    ``chunk_bytes`` stands) and takes one table buffer when that chunk is
    its whole table, two otherwise. The block is the pack's, not a
    member's. Of ``PACKED_BLOCKS`` whose shared memory fits (the largest
    need among the members) and whose tile leaves at least half of the
    lanes live in the blocks of each member of ``HALF_LIVE_ROWS`` rows or
    more (the tile at most twice its rows), it takes those whose waves
    (blocks over the card's resident slots, rounded up) times records a
    thread is least: the walks a thread takes one after another, each
    ``kWalks`` deep (the .cu source's note says why that sets the time).
    Among those, the largest tile whose grid fills every resident slot;
    where none does, the largest with a block for every SM; where none
    does, the smallest. The sums do not depend on the shape (trees are
    added in ascending order whatever it is), so each member's rows are
    its solo launch's bit for bit. Raises ValueError when a member's
    shape is one the card cannot take, there are more than
    ``MAX_PACK_MEMBERS`` members, or even the smallest block's shared
    memory exceeds ``SMEM_MAX``: the pack plan refuses that mix."""
    if not members:
        raise ValueError("a packed launch needs at least one member")
    if len(members) > MAX_PACK_MEMBERS:
        raise ValueError(f"{len(members)} members: a packed launch takes at "
                         f"most {MAX_PACK_MEMBERS}")
    if len(rows) != len(members):
        raise ValueError(f"{len(members)} members but {len(rows)} row counts")
    return _packed_shape(tuple(tuple(m) for m in members),
                         tuple(int(r) for r in rows), int(n_classes))


@functools.lru_cache(maxsize=256)
def _packed_shape(members, rows, n_classes) -> PackedShape:
    chunks, bufs, needs = [], [], []
    for f, t, w, th, cb in members:
        chunk = launch_shape(f, t, w, th, cb)[1]
        buf = 1 if chunk >= t else 2
        chunks.append(chunk)
        bufs.append(buf)
        needs.append((BAR_BYTES + buf * chunk * w * 8, staged_row_stride(f)))
    live = [r for r in rows if r >= HALF_LIVE_ROWS]
    cap = 2 * min(live) if live else None
    plans = []
    for threads, per_thread in PACKED_BLOCKS:
        tile = threads * per_thread
        if cap is not None and tile > cap:
            continue
        smem = max(tables + tile * stride for tables, stride in needs)
        if smem > SMEM_MAX:
            continue
        plans.append(PackedShape(
            threads, per_thread, tuple(chunks), tuple(bufs),
            tuple(-(-r // tile) for r in rows), smem,
            packed_resident(threads, per_thread, smem, n_classes)))
    if not plans:
        raise ValueError(f"a packed launch needs over the block's {SMEM_MAX} "
                         "bytes of shared memory even at its smallest block")
    least = min(map(_chains, plans))
    plans = [plan for plan in plans if _chains(plan) == least]
    for plan in plans:
        if plan.n_blocks >= plan.slots:
            return plan
    for plan in plans:
        if plan.n_blocks >= SM_COUNT:
            return plan
    return plans[-1]


def _chains(plan: PackedShape) -> int:
    """Waves of the grid times records a thread: how many walks of
    ``kWalks`` chains the busiest thread slot takes one after another."""
    return -(-plan.n_blocks // plan.slots) * plan.records_per_thread


def _packed_members(codes, rows, tables, n_fields, launches):
    """Checks of a packed launch's operands → per member (T, S, L, C)."""
    if codes.dim() != 3 or codes.dtype != torch.uint8:
        raise ValueError(f"packed codes must be u8[N, B, F], got "
                         f"{codes.dtype}{tuple(codes.shape)}")
    N, B, F = codes.shape
    if not (len(rows) == len(tables) == len(n_fields) == N):
        raise ValueError(f"{N} member slots but {len(rows)} row counts, "
                         f"{len(tables)} tables, {len(n_fields)} widths")
    if launches is not None and len(launches) != N:
        raise ValueError(f"{N} members but {len(launches)} launch shapes")
    if codes.device.type == "cuda" and not codes.is_contiguous():
        raise ValueError("packed codes must be contiguous")
    dims = []
    for m in range(N):
        if not 0 <= rows[m] <= B:
            raise ValueError(f"member {m}: {rows[m]} rows outside [0, {B}]")
        if not 0 < n_fields[m] <= min(F, MAX_FIELDS):
            raise ValueError(f"member {m}: {n_fields[m]} fields outside "
                             f"(0, {min(F, MAX_FIELDS)}]")
        dims.append(_check_tables(tables[m], codes.device))
    return dims


def leaf_rows_packed_reference(codes: torch.Tensor, rows, tables, n_fields):
    """Plain version of the packed launch: :func:`leaf_rows_reference` over
    each member's rows ``codes[m, :rows[m], :n_fields[m]]`` and its own
    tables → a list of f32[rows[m], C_m]. Used by the tests and on the
    CPU; nothing on the card calls it."""
    return [
        leaf_rows_reference(codes[m, : rows[m], : n_fields[m]], tables[m])
        for m in range(codes.shape[0])
    ]


def _packed_desc(codes: torch.Tensor, rows, tables, n_fields, dims,
                 shape: PackedShape) -> np.ndarray:
    """The packed launch's descriptor table, i64[N, DESC_WORDS] (DescWord
    in the .cu source): member m's codes in slot m of ``codes``
    (u8[N, B, F]), its sums after those of the members before it, its
    blocks after theirs."""
    N, B, F = codes.shape
    words = []
    out_off = begin = 0
    for m, (T, S, L, C) in enumerate(dims):
        words.append((
            m * B * F, rows[m], F, n_fields[m], tables[m]["walk"].data_ptr(),
            T, tables[m]["walk"].shape[1], shape.chunks[m], 1 + S, 1 + S + L,
            C, out_off, begin, staged_row_stride(n_fields[m]), 0, 0))
        out_off += rows[m] * C
        begin += shape.blocks[m]
    return np.array(words, np.int64).reshape(N, DESC_WORDS)


class _PackedPlan(NamedTuple):
    """What a packed launch over given operands needs beside the codes and
    the output: its shape, its descriptor table (and that table's host
    address), each member's class count, the output's shape and the
    launch's arguments between the descriptor and the output."""

    shape: PackedShape
    desc: np.ndarray
    desc_ptr: int
    classes: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    args: Tuple[int, ...]


# packed launch plans by operands: a pack dispatched again over the same
# tables, row counts and buffer shape skips the checks, the shape rule and
# the descriptor's build (host time that the launch waits for). A plan
# goes when one of its tables dies, or when _PLANS_MAX newer ones were
# made.
_PLANS: "collections.OrderedDict[tuple, _PackedPlan]" = (
    collections.OrderedDict())
_PLANS_MAX = 64
_PLANS_LOCK = threading.RLock()
# each plan's weak references to its tables, by the plan's key
_PLAN_REFS: Dict[tuple, list] = {}
_PLAN_TABLES = ("walk", "split", "rows")


def _drop_plan(key):
    def drop(_ref):
        with _PLANS_LOCK:
            _PLANS.pop(key, None)
            _PLAN_REFS.pop(key, None)
    return drop


def _packed_plan(codes: torch.Tensor, rows, tables, n_fields,
                 launches) -> _PackedPlan:
    """The plan of a packed launch on the card, checked and built once per
    operands: the codes' device, type and shape, the row counts, widths
    and launch shapes, and the identity of each member's ``walk``,
    ``split`` and ``rows`` tables (the plan is dropped when one of them
    dies, before its id can name another table)."""
    key = (codes.dtype, codes.shape, codes.get_device(), tuple(rows),
           tuple(n_fields),
           None if launches is None else tuple(map(tuple, launches)),
           tuple([id(t[k]) for t in tables for k in _PLAN_TABLES]))
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    dims = _packed_members(codes, rows, tables, n_fields, launches)
    shape = _packed_shape_of(dims, rows, n_fields, launches)
    desc = _packed_desc(codes, rows, tables, n_fields, dims, shape)
    classes = tuple(d[3] for d in dims)
    max_c = max(classes)
    # one class count: the members' outputs are row ranges of one
    # [rows, C] tensor, cut in one call
    out_shape = ((sum(rows), max_c) if min(classes) == max_c
                 else (sum(r * c for r, c in zip(rows, classes)),))
    plan = _PackedPlan(
        shape, desc, desc.ctypes.data, classes, out_shape,
        (len(dims), shape.n_blocks, shape.threads, shape.records_per_thread,
         shape.smem, max_c, SENTINEL))
    with _PLANS_LOCK:
        drop = _drop_plan(key)
        # the references live as long as the plan: their callbacks drop it
        refs = [weakref.ref(t[k], drop) for t in tables
                for k in _PLAN_TABLES]
        _PLANS[key] = plan
        _PLAN_REFS[key] = refs
        while len(_PLANS) > _PLANS_MAX:
            old, _ = _PLANS.popitem(last=False)
            _PLAN_REFS.pop(old, None)
    return plan


def _packed_shape_of(dims, rows, n_fields, launches) -> PackedShape:
    launches = launches or [(None, None)] * len(dims)
    return packed_shape([
        (n_fields[m], d[0], walk_words(*d[1:]), *launches[m])
        for m, d in enumerate(dims)], rows, max(d[3] for d in dims))


def leaf_rows_packed(codes: torch.Tensor, rows, tables, n_fields,
                     launches=None):
    """One launch over many members → a list of f32[rows[m], C_m]: member
    m's rows are :func:`leaf_rows` of ``codes[m, :rows[m], :n_fields[m]]``
    over ``tables[m]`` at its launch shape ``launches[m]`` (``(threads,
    chunk_bytes)``; None: the default), bit for bit.

    ``codes`` is the packed buffer u8[N, B, F_max]: member m's records in
    slot m, its fields first, the rest of a row ignored. On a CUDA tensor:
    one launch of ``walk_packed_kernel`` on the current stream at the
    pack's shape (:func:`packed_shape`), a block of the grid a (member,
    row tile) pair (counted in ``leaf_rows_packed.launches`` and, by the
    largest class count, in ``leaf_rows_packed.launches_by_classes``), or
    a raise: on a shape the pack cannot take, a table not on the card, or
    a launch the runtime refused (:class:`KernelLaunchError`). There is no
    fall-back to launches a member. On a CPU tensor: the plain version."""
    if codes.device.type == "cpu":
        dims = _packed_members(codes, rows, tables, n_fields, launches)
        _packed_shape_of(dims, rows, n_fields, launches)
        return leaf_rows_packed_reference(codes, rows, tables, n_fields)
    plan = _packed_plan(codes, rows, tables, n_fields, launches)
    if not codes.is_contiguous():
        raise ValueError("packed codes must be contiguous")
    lib = build()
    out = torch.empty(plan.out_shape, dtype=torch.float32,
                      device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = lib.qtrees_leaf_rows_packed(
        codes.data_ptr(), plan.desc_ptr, *plan.args, out.data_ptr(), stream)
    if rc != 0:
        raise KernelLaunchError(f"qtrees_leaf_rows_packed launch failed: "
                                f"cudaError {rc}", cuda_error=rc)
    if plan.shape.n_blocks:
        max_c = plan.args[5]
        with _COUNT_LOCK:
            leaf_rows_packed.launches += 1
            by_c = leaf_rows_packed.launches_by_classes
            by_c[max_c] = by_c.get(max_c, 0) + 1
    if len(plan.out_shape) == 2:
        return list(out.split(list(rows)))
    outs, at = [], 0
    for r, c in zip(rows, plan.classes):
        outs.append(out[at: at + r * c].view(r, c))
        at += r * c
    return outs


def packed_resident_on_card(shape: PackedShape, n_classes: int) -> int:
    """The blocks of ``shape`` one SM of the current card holds, as the
    CUDA runtime's occupancy calculator reads them for the packed instance
    of ``n_classes`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
    :func:`packed_shape` counts on ``shape.resident``. Raises
    :class:`KernelLaunchError` on the runtime's error."""
    lib = build()
    blocks = ctypes.c_int(0)
    rc = lib.qtrees_packed_resident_blocks(
        shape.threads, shape.records_per_thread, shape.smem, n_classes,
        ctypes.byref(blocks))
    if rc != 0:
        raise KernelLaunchError(f"qtrees_packed_resident_blocks failed: "
                                f"cudaError {rc}", cuda_error=rc)
    return blocks.value


leaf_rows_packed.launches = 0
leaf_rows_packed.launches_by_classes = {}
