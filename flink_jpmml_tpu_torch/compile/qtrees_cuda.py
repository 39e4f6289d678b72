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
order. There is no fall-back from one to the other. The kernel reads only
``walk``; the wrapper takes the other tables' shapes for its dimensions,
and the mask tables stay for the plain version. The kernel is built with
``nvcc`` from the repository's sources on first use, into ``build/`` beside
the package (bound through a plain C interface with ``ctypes``).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import threading
from typing import Dict, Iterator, Tuple

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

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "qtrees_ensemble.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(FlinkJpmmlTpuError):
    """nvcc is missing or refused the kernel source."""


class KernelLaunchError(FlinkJpmmlTpuError):
    """The CUDA runtime reported an error for a kernel launch."""


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
            p, i64, i32, p, i32, i32, i32, i32, i32, i32, p, p]
        lib.qtrees_leaf_rows.restype = ctypes.c_int
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
              n_fields: int):
    """u8[N, F] rank codes → f32[N, C]: per record, the sum over trees of
    the hit leaf's row — the ensemble sum before Targets (C = 1) or the
    vote shares of a majorityVote / weightedMajorityVote forest (the
    weights are folded into the rows).

    ``n_fields`` is the field count the tables were packed for
    (:func:`pack_tables`); codes of another width raise, since the kernel
    gathers ``code[feat]`` from a row of exactly that width. On a CUDA
    tensor: launch the kernel on the current stream (counted in
    ``leaf_rows.launches``) or raise — on codes of another width, more than
    ``MAX_CLASSES`` classes, or a ``walk`` table that is not on the card
    (the other tables lend only their shapes). On a CPU tensor: the plain
    version, with all five tables on the CPU."""
    _check_codes(codes, n_fields)
    T, S, L, C = _check_tables(tables, codes.device)
    if codes.device.type == "cpu":
        return leaf_rows_reference(codes, tables)
    lib = build()
    N, F = codes.shape
    out = torch.empty((N, C), dtype=torch.float32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = lib.qtrees_leaf_rows(
        codes.data_ptr(), N, F, tables["walk"].data_ptr(), T,
        tables["walk"].shape[1], S, L, C, SENTINEL, out.data_ptr(), stream,
    )
    if rc != 0:
        raise KernelLaunchError(f"qtrees_leaf_rows launch failed: "
                                f"cudaError {rc}")
    leaf_rows.launches += 1
    return out


leaf_rows.launches = 0
