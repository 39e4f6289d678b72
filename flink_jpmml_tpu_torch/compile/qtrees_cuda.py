"""Hopper kernel for the rank-wire ensemble sum, its plain version, and
the host packer of its tables.

Replaces the Pallas TPU kernels ``flink_jpmml_tpu/compile/qtrees_pallas.py``
``_kernel`` and ``_kernel_mega`` (both compute the same f32[B] ensemble
sum; on Hopper the tree loop lives inside the block, so one CUDA kernel,
``csrc/qtrees_ensemble.cu``, serves both).

Bound on an H100: per record the kernel moves F bytes of codes in and 4
bytes of score out (36 B for the 32-feature GBM: 2.8 µs for 262,144
records at 3.35 TB/s) and does T·(S+L) integer compare-and-select steps
(63.5k for 500 depth-6 trees: 1.0 ms for 262,144 records at the card's
1.67e13/s INT32 issue rate, 132 SMs × 64 INT32 lanes × 1.98 GHz, taking
each step as at least one integer instruction). It is bound by operations. The design note at the
top of the ``.cu`` file says what the kernel does about that.

Tables (``pack_tables``, numpy, host side): the TPU kernel's one-hot
feature-select matmul and block-diagonal int8 path matrices exist because
gathers are slow on a TPU; on Hopper the kernel gathers each split's code
directly, and the path matrix becomes two 64-bit masks per leaf:

- ``split`` i32[T, S]: ``feat | qthr << 16 | dleft << 24`` per split;
- ``on`` i64[T, L]: bit s set iff split s lies on the leaf's path;
- ``left`` i64[T, L]: bit s set iff the path goes left at split s;
- ``vals`` f32[T, L]: leaf values (``vhi + vlo``, coefficients folded in).

Leaf l is hit iff ``(go & on[l]) == left[l]``; this equals the JAX
package's ``sign @ P == count`` because ``count`` is the number of nonzero
``P`` entries on the path. Padded leaves (``count = -5``) get ``on = 0,
left = 1`` and never match.

Dispatch (``ensemble_sum``): a CUDA tensor launches the kernel or raises;
a CPU tensor runs :func:`ensemble_sum_reference`, the plain PyTorch version
with the same arithmetic and the same ascending-tree f32 order. There is
no fall-back from one to the other. The kernel is built with ``nvcc`` from
the repository's sources on first use, into ``build/`` beside the package
(bound through a plain C interface with ``ctypes``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

import numpy as np
import torch

from flink_jpmml_tpu_torch.utils.exceptions import FlinkJpmmlTpuError

SENTINEL = 255  # uint8 wire missing code
MAX_SPLITS = 64  # one 64-bit go-left mask per tree
MAX_FIELDS = 256  # staged codes per block fit the default shared memory
TABLE_KEYS = ("split", "on", "left", "vals")

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "qtrees_ensemble.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "flink_jpmml_tpu_torch"
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


def pack_tables(
    feat: np.ndarray,   # i[T, S] feature index per split
    qthr: np.ndarray,   # u8[T, S] rank thresholds
    dleft: np.ndarray,  # bool[T, S] missing → left
    P: np.ndarray,      # i8[T, S, L] path matrix (+1 left, -1 right, 0 off)
    count: np.ndarray,  # i8[T, L] path lengths (-5 = padded leaf)
    vals: np.ndarray,   # f32[T, L] leaf values
    n_fields: int,
) -> Dict[str, np.ndarray]:
    """Per-tree tables of the kernel (see the module docstring). Raises
    ValueError on shapes the kernel does not take."""
    T, S = feat.shape
    L = P.shape[2]
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
        "vals": np.ascontiguousarray(vals, np.float32),
    }


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def ensemble_sum_reference(codes: torch.Tensor, tables: Dict[str, torch.Tensor]):
    """Plain PyTorch version of the kernel: u8[N, F] codes → f32[N] sums.

    The same gather / compare / mask / f32 arithmetic as the kernel, tree
    by tree in ascending order, so its sums are the kernel's bit for bit
    (each tree contributes exactly one leaf value)."""
    split = tables["split"].long() & 0xFFFFFFFF
    feat = split & 0xFFFF
    qthr = (split >> 16) & 0xFF
    dleft = ((split >> 24) & 1).bool()
    on, left, vals = tables["on"], tables["left"], tables["vals"]
    T, S = split.shape
    shifts = torch.arange(S, device=codes.device)
    x_all = codes.long()
    acc = torch.zeros(codes.shape[0], dtype=torch.float32, device=codes.device)
    for t in range(T):
        x = x_all[:, feat[t]]  # [N, S]
        go_bit = torch.where(x == SENTINEL, dleft[t], x <= qthr[t])
        # distinct powers of two: the sum is the bitwise or
        go = (go_bit.long() << shifts).sum(dim=1)  # [N]
        hit = (go[:, None] & on[t][None, :]) == left[t][None, :]
        acc = acc + torch.where(hit, vals[t][None, :], 0.0).sum(dim=1)
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


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/qtrees_ensemble.cu`` for sm_90a (once per source
    content) and bind it; → the loaded library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"qtrees_ensemble_{tag}.so"
        if not lib_path.exists():
            tmp = BUILD_DIR / f".{lib_path.name}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({res.returncode}):\n{res.stderr}"
                )
            if verbose:
                print(res.stderr, end="")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.qtrees_ensemble_sum
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i64, i32, p, p, p, p, i32, i32, i32, i32, p, p]
        fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def _check_tables(tables: Dict[str, torch.Tensor], device: torch.device):
    split = tables["split"]
    T, S = split.shape
    L = tables["vals"].shape[1]
    expect = {
        "split": (torch.int32, (T, S)),
        "on": (torch.int64, (T, L)),
        "left": (torch.int64, (T, L)),
        "vals": (torch.float32, (T, L)),
    }
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
    if S > MAX_SPLITS:
        raise ValueError(f"{S} split slots per tree > {MAX_SPLITS}")
    return T, S, L


def ensemble_sum(codes: torch.Tensor, tables: Dict[str, torch.Tensor],
                 n_fields: int):
    """u8[N, F] rank codes → f32[N] ensemble sums (before Targets).

    ``n_fields`` is the field count the tables were packed for
    (:func:`pack_tables`); codes of another width raise, since the kernel
    gathers ``code[feat]`` from a row of exactly that width. On a CUDA
    tensor: launch the kernel on the current stream (counted in
    ``ensemble_sum.launches``) or raise. On a CPU tensor: the plain
    version."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be u8[N, F], got {codes.dtype}"
                         f"{tuple(codes.shape)}")
    if codes.shape[1] != n_fields:
        raise ValueError(f"codes have {codes.shape[1]} fields, the tables "
                         f"were packed for {n_fields}")
    if not 0 < n_fields <= MAX_FIELDS:
        raise ValueError(f"{n_fields} fields outside (0, {MAX_FIELDS}]")
    if codes.device.type == "cpu":
        return ensemble_sum_reference(codes, tables)
    if codes.device.type != "cuda":
        raise ValueError(f"no kernel for device {codes.device}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    T, S, L = _check_tables(tables, codes.device)
    lib = build()
    N, F = codes.shape
    out = torch.empty((N,), dtype=torch.float32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = lib.qtrees_ensemble_sum(
        codes.data_ptr(), N, F,
        tables["split"].data_ptr(), tables["on"].data_ptr(),
        tables["left"].data_ptr(), tables["vals"].data_ptr(),
        T, S, L, SENTINEL, out.data_ptr(), stream,
    )
    if rc != 0:
        raise KernelLaunchError(f"qtrees_ensemble_sum launch failed: "
                                f"cudaError {rc}")
    ensemble_sum.launches += 1
    return out


ensemble_sum.launches = 0
