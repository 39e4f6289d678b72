"""ctypes binding for the C++ host data plane (``_native/fjt_native.cpp``).

The port of ``flink_jpmml_tpu/runtime/native.py``. The port builds its own
copy of the source with ``g++ -O3 -std=c++17 -shared -fPIC -lpthread`` at
first use, through :func:`flink_jpmml_tpu_torch.utils.build.build_shared`
(into ``build/flink_jpmml_tpu_torch/`` beside the package, under a name
that carries a hash of the source and the flags).

It binds three parts: the bounded MPSC ring of float32 records
(:class:`NativeRing`), the rank-wire bucketizer (:func:`bucketize`,
:func:`bucketize_pow2`) and the fixed-width Kafka record-batch codec
(:func:`kafka_encode_fixed`, :func:`kafka_decode_fixed`), with the JAX
package's signatures and results.

One deliberate difference: where the JAX package returns None when the
library cannot be built and lets callers drop to the Python ring or to
numpy, the port raises :class:`NativeBuildError` with g++'s stderr. The
port has no Python ring, and the numpy encode
(``QuantizedWire.encode_reference``) runs only where a caller asks for
it.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Optional, Tuple

import numpy as np

from flink_jpmml_tpu_torch.utils.build import BUILD_DIR, build_shared
from flink_jpmml_tpu_torch.utils.build import lib_path as build_lib_path
from flink_jpmml_tpu_torch.utils.exceptions import NativeBuildError

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "_native" / "fjt_native.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
GXX_LIBS = ("-lpthread",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def lib_path() -> pathlib.Path:
    """The library's path, named for a hash of the source and the flags."""
    try:
        return build_lib_path(BUILD_DIR, "libfjt_native", SOURCE,
                              (*GXX_FLAGS, *GXX_LIBS))
    except OSError as e:
        raise NativeBuildError(f"source missing: {SOURCE}: {e}") from e


def _bind(lib: ctypes.CDLL) -> None:
    lib.fjt_ring_create.restype = ctypes.c_void_p
    lib.fjt_ring_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    for name in ("fjt_ring_destroy", "fjt_ring_close"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.fjt_ring_size.restype = ctypes.c_uint32
    lib.fjt_ring_size.argtypes = [ctypes.c_void_p]
    lib.fjt_ring_closed.restype = ctypes.c_int
    lib.fjt_ring_closed.argtypes = [ctypes.c_void_p]
    lib.fjt_ring_push_block.restype = ctypes.c_uint32
    lib.fjt_ring_push_block.argtypes = [
        ctypes.c_void_p, _F32P, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_int64,  # timeout_us (-1 = wait indefinitely)
    ]
    lib.fjt_ring_drain.restype = ctypes.c_uint32
    lib.fjt_ring_drain.argtypes = [
        ctypes.c_void_p, _F32P, _U64P, ctypes.c_uint32,
        ctypes.c_int64,  # deadline_us
        ctypes.c_int64,  # idle_timeout_us (-1 = wait indefinitely)
    ]
    for name, code_t, table_args in (
        # ragged: concatenated sorted tables + int32 offsets [f + 1]
        ("fjt_bucketize_u8", ctypes.c_uint8, [_F32P, _I32P]),
        ("fjt_bucketize_u16", ctypes.c_uint16, [_F32P, _I32P]),
        # lockstep: [f, L] +inf-padded rows, L a power of two
        ("fjt_bucketize_pow2_u8", ctypes.c_uint8, [_F32P, ctypes.c_uint32]),
        ("fjt_bucketize_pow2_u16", ctypes.c_uint16, [_F32P, ctypes.c_uint32]),
    ):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [
            _F32P, ctypes.c_uint64, ctypes.c_uint32,  # X, n, f
            *table_args,
            _F32P, _U8P, _U8P,  # repl, has_repl, mask (nullable)
            ctypes.POINTER(code_t), ctypes.c_uint32,  # out, n_threads
        ]
    lib.fjt_kafka_encode_fixed.restype = ctypes.c_int64
    lib.fjt_kafka_encode_fixed.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # values, n, len, base
        _U8P, ctypes.c_int64,  # out, capacity (bytes)
    ]
    lib.fjt_kafka_decode_fixed.restype = ctypes.c_int64
    lib.fjt_kafka_decode_fixed.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int64,  # record set, len, value_len
        _U8P, ctypes.c_int64, _I64P,  # out values, capacity (records), offsets
    ]


def load() -> ctypes.CDLL:
    """Build (once per source and flags) and bind the library → the loaded
    library; raise :class:`NativeBuildError` when g++ or the loader
    fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        build_shared("g++", GXX_FLAGS, SOURCE, path, NativeBuildError,
                     GXX_LIBS)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        _bind(lib)
        _lib = lib
        return lib


class NativeRing:
    """Bounded MPSC ring of fixed-arity float32 records (the C++ batcher).

    ``push_block`` takes a contiguous ``[n, arity]`` float32 array with
    consecutive source offsets; ``drain`` fills a preallocated batch buffer
    fill-or-deadline and returns (records_view, offsets_view) — zero-copy
    numpy views over reused buffers, valid until the next drain. The calls
    release the GIL while they wait; ``close`` wakes a producer blocked in
    ``push_block`` and a consumer blocked in ``drain``.
    """

    def __init__(self, capacity: int, arity: int, batch_size: int):
        lib = load()
        self._lib = lib
        self._arity = arity
        self._handle = lib.fjt_ring_create(capacity, arity)
        if not self._handle:
            raise ValueError(
                f"fjt_ring_create({capacity}, {arity}) failed: capacity and "
                "arity must be positive and fit in memory"
            )
        self._batch = np.zeros((batch_size, arity), np.float32)
        self._offsets = np.zeros((batch_size,), np.uint64)

    def push_block(
        self, block: np.ndarray, first_offset: int, timeout_us: int = -1
    ) -> int:
        block = np.ascontiguousarray(block, np.float32)
        if block.ndim != 2 or block.shape[1] != self._arity:
            raise ValueError(f"block shape {block.shape} != [n, {self._arity}]")
        return self._lib.fjt_ring_push_block(
            self._handle, block.ctypes.data_as(_F32P), first_offset,
            block.shape[0], timeout_us,
        )

    def drain(
        self, deadline_us: int, idle_timeout_us: int = -1
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``idle_timeout_us >= 0`` bounds the wait for the *first*
        record — an empty return on an open ring then means "idle"."""
        n = self._lib.fjt_ring_drain(
            self._handle, self._batch.ctypes.data_as(_F32P),
            self._offsets.ctypes.data_as(_U64P), self._batch.shape[0],
            deadline_us, idle_timeout_us,
        )
        return self._batch[:n], self._offsets[:n]

    def close(self) -> None:
        self._lib.fjt_ring_close(self._handle)

    @property
    def closed(self) -> bool:
        return bool(self._lib.fjt_ring_closed(self._handle))

    def __len__(self) -> int:
        return self._lib.fjt_ring_size(self._handle)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.fjt_ring_destroy(handle)
            self._handle = None


def kafka_encode_fixed(values: np.ndarray, base_offset: int) -> bytes:
    """Encode a contiguous ``[n, value_len]`` uint8 array (n ≥ 1) as one
    magic-v2 record batch — byte-identical to the JAX package's Python
    ``encode_record_batch`` (null keys, no headers, timestamp 0)."""
    lib = load()
    values = np.ascontiguousarray(values, np.uint8)
    if values.ndim != 2 or values.shape[0] < 1:
        raise ValueError(f"values must be u8[n >= 1, len], got {values.shape}")
    n, value_len = values.shape
    cap = 61 + n * (value_len + 26)  # generous per-record framing bound
    out = np.empty((cap,), np.uint8)
    rc = lib.fjt_kafka_encode_fixed(
        values.ctypes.data_as(_U8P), n, value_len, base_offset,
        out.ctypes.data_as(_U8P), cap,
    )
    if rc < 0:
        raise ValueError(f"fjt_kafka_encode_fixed failed (rc={rc})")
    return out[: int(rc)].tobytes()


def kafka_decode_fixed(
    buf: bytes, value_len: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode magic-v2 record batches whose values are all ``value_len``
    bytes (the tabular-stream contract).

    → ``(offsets int64 [n], values uint8 [n, value_len])``, or ``None``
    when the record set is not fixed-length. Raises ``ValueError`` on CRC
    mismatch, bad magic or malformed framing, with the JAX package's
    messages."""
    lib = load()
    # a record costs at least 6 framing bytes + the value, so this bounds
    # the record count from the buffer size alone
    cap = len(buf) // (value_len + 6) + 1
    out = np.empty((cap, value_len), np.uint8)
    offs = np.empty((cap,), np.int64)
    src = np.frombuffer(buf, np.uint8)  # zero-copy, read-only view
    rc = lib.fjt_kafka_decode_fixed(
        src.ctypes.data_as(_U8P), len(buf), value_len,
        out.ctypes.data_as(_U8P), cap, offs.ctypes.data_as(_I64P),
    )
    if rc == -3:
        return None  # not fixed-length
    if rc == -1:
        raise ValueError("record batch CRC32C mismatch")
    if rc == -2:
        raise ValueError("unsupported record-batch magic")
    if rc < 0:
        raise ValueError(f"malformed record batch (native rc={rc})")
    n = int(rc)
    return offs[:n].copy(), out[:n].copy()


def _checked(X, repl, has_repl, out_dtype, mask):
    """The bucketizers' shared checks → (X, repl, has_repl, mask, out),
    contiguous and of the types the C entry points take."""
    X = np.ascontiguousarray(X, np.float32)
    if X.ndim != 2:
        raise ValueError(f"X must be f32[n, f], got shape {X.shape}")
    f = X.shape[1]
    repl = np.ascontiguousarray(repl, np.float32)
    has_repl = np.ascontiguousarray(has_repl, np.uint8)
    if repl.shape != (f,) or has_repl.shape != (f,):
        raise ValueError(f"repl/has_repl must have shape ({f},)")
    out = np.empty(X.shape, out_dtype)
    if out.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"wire dtype must be uint8 or uint16, got {out.dtype}")
    if mask is not None:
        mask = np.ascontiguousarray(mask, np.uint8)
        if mask.shape != X.shape:
            raise ValueError(f"mask shape {mask.shape} != X shape {X.shape}")
    return X, repl, has_repl, mask, out


def _call(fn, X, tables, repl, has_repl, mask, out, n_threads) -> np.ndarray:
    code_t = ctypes.c_uint8 if out.itemsize == 1 else ctypes.c_uint16
    fn(
        X.ctypes.data_as(_F32P), X.shape[0], X.shape[1], *tables,
        repl.ctypes.data_as(_F32P), has_repl.ctypes.data_as(_U8P),
        _U8P() if mask is None else mask.ctypes.data_as(_U8P),
        out.ctypes.data_as(ctypes.POINTER(code_t)), n_threads,
    )
    return out


def bucketize(
    X: np.ndarray,
    cuts_flat: np.ndarray,
    offs: np.ndarray,
    repl: np.ndarray,
    has_repl: np.ndarray,
    out_dtype,
    mask: Optional[np.ndarray] = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Ragged-table rank-wire featurization (branchless per-feature
    lower_bound) → the [n, f] code array. Memory and search depth follow
    each feature's own cut count, so one long table does not tax the
    others (cf. :func:`bucketize_pow2`). ``n_threads = 0`` takes the
    host's hardware concurrency."""
    lib = load()
    X, repl, has_repl, mask, out = _checked(X, repl, has_repl, out_dtype, mask)
    f = X.shape[1]
    cuts_flat = np.ascontiguousarray(cuts_flat, np.float32)
    offs = np.ascontiguousarray(offs, np.int32)
    if offs.shape != (f + 1,) or offs[0] != 0 or offs[-1] != cuts_flat.size:
        raise ValueError(f"offs must be i32[{f + 1}] from 0 to "
                         f"{cuts_flat.size}, got {offs}")
    if (np.diff(offs) < 0).any():
        raise ValueError("offs must not decrease")
    fn = lib.fjt_bucketize_u8 if out.itemsize == 1 else lib.fjt_bucketize_u16
    tables = (cuts_flat.ctypes.data_as(_F32P), offs.ctypes.data_as(_I32P))
    return _call(fn, X, tables, repl, has_repl, mask, out, n_threads)


def bucketize_pow2(
    X: np.ndarray,
    cuts_padded: np.ndarray,
    L: int,
    repl: np.ndarray,
    has_repl: np.ndarray,
    out_dtype,
    mask: Optional[np.ndarray] = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Lockstep rank-wire featurization over +inf-padded [f, L] tables
    (L a power of two): the per-feature binary-search loads pipeline
    instead of serializing. Every feature pays L-depth rounds and L-width
    memory, so heavily skewed tables belong on :func:`bucketize`
    (``QuantizedWire.encode`` picks). Same results as :func:`bucketize`."""
    lib = load()
    X, repl, has_repl, mask, out = _checked(X, repl, has_repl, out_dtype, mask)
    cuts_padded = np.ascontiguousarray(cuts_padded, np.float32)
    if L < 1 or L & (L - 1) or cuts_padded.shape != (X.shape[1], L):
        raise ValueError(f"cuts_padded must be f32[{X.shape[1]}, L] with L a "
                         f"power of two, got {cuts_padded.shape}, L={L}")
    fn = (lib.fjt_bucketize_pow2_u8 if out.itemsize == 1
          else lib.fjt_bucketize_pow2_u16)
    tables = (cuts_padded.ctypes.data_as(_F32P), L)
    return _call(fn, X, tables, repl, has_repl, mask, out, n_threads)
