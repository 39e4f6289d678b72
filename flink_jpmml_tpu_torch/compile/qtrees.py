"""Quantized-wire fast path for numeric tree ensembles (the bench hot path).

The port of ``flink_jpmml_tpu/compile/qtrees.py``. Scoring only ever
compares each feature against the model's own finite set of split
thresholds, so a record can be shipped as per-feature *threshold ranks*
instead of raw floats:

- **Cut tables.** Every comparison split is normalised to a ``x <= cut``
  test (``<`` becomes ``<= nextafter(v, -inf)``; ``>``/``>=`` flip the
  children, which negates the split's path-matrix row and its missing
  default direction). The sorted unique cuts per feature form the table
  ``U[f]``; ``rank(x) = #{c in U[f] : c < x}`` and the split against cut
  ``U[f][i]`` holds iff ``rank(x) <= i`` — bit-exact with the float
  compares of the dense path.
- **Wire dtype.** ``uint8`` when every feature has <= 254 cuts, else
  ``uint16``. The top code (255/65535) is the missing-value sentinel.
- **Backends.** ``"cuda"``: the Hopper kernel of ``qtrees_cuda.py``
  (uint8 wire, at most 64 split slots per tree and 256 fields) — the
  ensemble sum for a linear regression aggregate whose coefficients fold
  into the leaf values, the vote shares for a majorityVote /
  weightedMajorityVote forest of at most ``MAX_CLASSES`` classes; on a
  CPU device the wrapper runs the kernel's plain version
  (``"cuda_plain"``). ``"torch"``: the twin of the JAX package's XLA
  ``qfn`` in plain PyTorch, for every other model the wire takes (uint16
  wires, max/median aggregates, ``single``-method trees, wider targets).

Encode placement (``QuantizedScorer.encode_placement``):

- ``"host"``: the C++ bucketizer
  (``runtime/native.py``, multithreaded; lockstep over +inf-padded
  power-of-two tables, ragged when the tables are skewed) rank-encodes
  on the host and the uint8/uint16 codes ship;
- ``"fused"``: the raw f32 batch ships and the encode stage
  (:func:`_make_encode_stage`, ``torch.searchsorted`` over the
  +inf-padded tables) runs on the device in front of the scorer. A model
  whose padded tables exceed ``_DEVICE_TABLE_BUDGET`` has no stage and
  stays host-encoded.

The scorer picks from what it sees: fused on a CUDA device when the model
has a stage (on the H100 it carried 1.3-2.0x the host path's records/s on
both main paths, PERF.md), host-encoded on the CPU, where the C++
bucketizer is the faster encode. ``encode_mode`` overrides the choice:
the kernel search (``compile/autotune.py``) sets it from what it measured
on this device, and a scorer built with an entry in the autotune cache
takes the cached placement and kernel variant at build time
(:func:`_consult_autotune`, as the JAX package does). With no entry the
scorer's own choice stands.

Both are byte-identical to :meth:`QuantizedWire.encode_reference`, the
numpy ``searchsorted`` encode (the JAX package's fall-back branch), which
stays as the plain version and runs only where a caller asks for it.

Kernel variants (``compile/layouts.py``): :meth:`QuantizedScorer.
build_variant` builds, and :meth:`~QuantizedScorer.adopt_variant` swaps
in, a layout of the tables (``bfs``; on the torch twin also the packed
wire) and, for the ``cuda`` backends, the kernel's launch shape. Every
variant scores bit-identically to the built default.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile import layouts, prepare, qtrees_cuda
from flink_jpmml_tpu_torch.compile.common import (
    LowerCtx,
    apply_targets_value,
    build_codecs,
    extract_invalid_policy,
    extract_missing_replacements,
    to_device,
)
from flink_jpmml_tpu_torch.compile.trees import (
    _canon_has_halt,
    _canonicalize_forest,
    median_lastdim,
    pack_ensemble,
)
from flink_jpmml_tpu_torch.models.prediction import Prediction, decode_batch
from flink_jpmml_tpu_torch.obs import profiler as prof_mod
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.runtime import native
from flink_jpmml_tpu_torch.utils.config import CompileConfig
from flink_jpmml_tpu_torch.utils.device import resolve_device
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

# opcodes from trees.py: 0 '<', 1 '<=', 2 '>', 3 '>='
_SUPPORTED_OPS = frozenset((0, 1, 2, 3))
# fused-encode cut-table budget: the device encode stage carries an
# [F, L] +inf-padded f32 table; a pathological uint16 wire would pin tens
# of MB of device memory per served model for a stage the host
# bucketizer handles fine
_DEVICE_TABLE_BUDGET = 16 * 1024 * 1024
_REGRESSION_METHODS = frozenset(
    ("single", "sum", "average", "weightedAverage", "max", "median")
)


def _pow2_at_least(m: int) -> int:
    L = 1
    while L < max(m, 1):
        L <<= 1
    return L


def _padded_table(cuts, L: int) -> np.ndarray:
    """[F, L] f32 rows, each feature's sorted cuts then +inf pads."""
    padded = np.full((max(len(cuts), 1), L), np.inf, np.float32)
    for j, c in enumerate(cuts):
        padded[j, : len(c)] = c
    return padded


@dataclass(frozen=True)
class QuantizedWire:
    """Host-side featurizer: f32 records → threshold-rank codes.

    ``cuts[j]`` is the sorted cut table of input column ``j`` (possibly
    empty); ``dtype`` is ``np.uint8`` or ``np.uint16``; ``sentinel`` marks
    missing values. ``repl``/``has_repl`` fold the model's top-level
    mining-schema ``missingValueReplacement`` into encoding.
    """

    fields: Tuple[str, ...]
    cuts: Tuple[np.ndarray, ...]
    dtype: type
    sentinel: int
    repl: np.ndarray  # f32[F]
    has_repl: np.ndarray  # bool[F]

    @property
    def bytes_per_record(self) -> int:
        return len(self.fields) * np.dtype(self.dtype).itemsize

    def _cached(self, name: str, make):
        # the dataclass is frozen: tables derived from the cuts are built
        # once and kept beside them
        cached = self.__dict__.get(name)
        if cached is None:
            cached = (make(),)
            object.__setattr__(self, name, cached)
        return cached[0]

    def _flat_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """(cuts_flat f32, offsets i32[F+1]) for the ragged bucketizer."""
        def make():
            offs = np.zeros((len(self.cuts) + 1,), np.int32)
            for j, c in enumerate(self.cuts):
                offs[j + 1] = offs[j] + len(c)
            flat = (np.concatenate(self.cuts).astype(np.float32) if offs[-1]
                    else np.empty((0,), np.float32))
            return flat, offs
        return self._cached("_flat_cache", make)

    def _pow2_tables(self) -> Tuple[Optional[np.ndarray], int]:
        """(+inf-padded [F, L] f32 table, L) for the lockstep bucketizer,
        or (None, 0) when the padding blowup says the ragged path wins.

        L = next power of two ≥ the longest per-feature cut table; ranks
        are unchanged by +inf pads (a pad is never < any finite x). The
        lockstep kernel makes every feature pay L-depth rounds and
        L-width memory, so it only pays off when cut counts are roughly
        balanced (GBM exports are): a blowup F·L / Σ|cuts| above 4 with
        L > 64 takes the ragged kernel."""
        def make():
            L = _pow2_at_least(max((len(c) for c in self.cuts), default=0))
            total = sum(len(c) for c in self.cuts)
            blowup = (max(len(self.cuts), 1) * L) / max(total, 1)
            if blowup > 4.0 and L > 64:
                return None, 0  # skewed: ragged path
            return _padded_table(self.cuts, L), L
        return self._cached("_pow2_cache", make)

    def encode(
        self, X: np.ndarray, M: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """f32[B, F] (+ optional missing mask) → rank codes [B, F].

        NaNs count as missing. Missing cells take the mining-schema
        replacement value when one is declared, else the sentinel. Runs
        the multithreaded C++ bucketizer (``runtime/native.py``); raises
        ``NativeBuildError`` when it cannot be built — the numpy version
        is :meth:`encode_reference`, taken only on request."""
        has_repl = self.has_repl.astype(np.uint8)
        padded, L = self._pow2_tables()
        if padded is not None:
            return native.bucketize_pow2(
                X, padded, L, self.repl, has_repl, self.dtype, mask=M)
        flat, offs = self._flat_tables()
        return native.bucketize(
            X, flat, offs, self.repl, has_repl, self.dtype, mask=M)

    def encode_reference(
        self, X: np.ndarray, M: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """The plain version of :meth:`encode`: numpy ``searchsorted``
        per column, the same codes byte for byte."""
        X = np.asarray(X, np.float32)
        miss = np.isnan(X)
        if M is not None:
            miss = miss | M
        if self.has_repl.any():
            use = miss & self.has_repl[None, :]
            X = np.where(use, self.repl[None, :], X)
            miss = miss & ~self.has_repl[None, :]
        out = np.empty(X.shape, self.dtype)
        for j, cuts in enumerate(self.cuts):
            # rank = #{c < x}  (side='left' over the sorted cut table)
            out[:, j] = np.searchsorted(cuts, X[:, j], side="left")
        out[miss] = self.sentinel
        return out

    def encode_records(self, space: prepare.FieldSpace, records) -> np.ndarray:
        X, M = prepare.from_records(space, records)
        return self.encode(X, M)

    def device_tables(self) -> Optional[Dict[str, np.ndarray]]:
        """Operands of the device encode stage, or None when the padded
        table exceeds ``_DEVICE_TABLE_BUDGET`` (such models stay
        host-encoded).

        ``enc_cuts`` is the [F, L] +inf-padded cut table (L the next
        power of two ≥ the longest per-feature table). Unlike
        :meth:`_pow2_tables` there is no skew rule: the device search is
        lockstep by construction and +inf pads never change a rank."""
        def make():
            L = _pow2_at_least(max((len(c) for c in self.cuts), default=0))
            if max(len(self.cuts), 1) * L * 4 > _DEVICE_TABLE_BUDGET:
                return None
            return {
                "enc_cuts": _padded_table(self.cuts, L),
                "enc_repl": self.repl.astype(np.float32),
                "enc_has_repl": self.has_repl.astype(bool),
            }
        return self._cached("_dev_cache", make)


def _make_encode_stage(sentinel: int, out_dtype, any_repl: bool):
    """The device encode stage: f32[B, F] → rank codes [B, F] in the wire
    dtype, byte-identical to :meth:`QuantizedWire.encode`.

    The port of the JAX package's XLA stage (qtrees.py
    ``_make_encode_stage``), in torch ops on the scorer's device. NaN
    cells take the mining-schema replacement where one is declared, else
    the sentinel; ``rank = #{cut < x}`` comes from one batched
    ``searchsorted`` (left side) of the [F, B] transposed values over the
    [F, L] +inf-padded tables: a pad is never < x, so it never adds to a
    rank, and a +inf cell ranks at its table's real length. Ranks are
    int32 until the last cast (uint16 is a partial dtype on CUDA)."""
    wire_dtype = torch.from_numpy(np.zeros(0, out_dtype)).dtype

    def encode_stage(pp, X: torch.Tensor) -> torch.Tensor:
        Xt = X.float().T.contiguous()  # [F, B]
        miss = torch.isnan(Xt)
        if any_repl:
            has = pp["enc_has_repl"][:, None]
            Xt = torch.where(miss & has, pp["enc_repl"][:, None], Xt)
            miss = miss & ~has
        ranks = torch.searchsorted(pp["enc_cuts"], Xt, right=False,
                                   out_int32=True)
        codes = torch.where(miss, sentinel, ranks)
        return codes.to(wire_dtype).T.contiguous()

    return encode_stage


Output = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclass
class QuantizedScorer:
    """Rank-wire scorer for one tree-ensemble model on one device.

    ``predict_wire(Xq)`` scores an encoded batch and returns f32 values
    (the full aggregate incl. Targets rescale) — or (values, probs,
    label_idx) for classification; ``score(X, M)`` encodes and decodes.
    """

    wire: QuantizedWire
    params: Dict[str, torch.Tensor]
    field_space: prepare.FieldSpace
    batch_size: Optional[int]
    n_trees: int
    device: torch.device
    _fn: object
    # "cuda": the Hopper kernel; "cuda_plain": its plain version, on the
    # CPU; "torch": the twin of the XLA qfn, for models the kernel does not
    # take
    backend: str = "torch"
    labels: Tuple[str, ...] = ()  # classification class list; () = regression
    # None: encode_placement decides from the device and supports_fused;
    # "host" or "fused" overrides that (a model without a stage stays
    # host-encoded all the same)
    encode_mode: Optional[str] = None
    # the device encode stage (_make_encode_stage); None when the model's
    # padded cut tables exceed _DEVICE_TABLE_BUDGET
    _encode_stage: object = None
    # stable identity for the autotune cache (the JAX package's hash of
    # the wire tables and packed shapes)
    model_hash: str = ""
    tuned: object = None  # the applied autotune.TunedConfig
    # the catalogue layout now built (compile/layouts.py) and, on the
    # cuda backends, the kernel's launch shape (threads, chunk_bytes);
    # None: the default shape (qtrees_cuda.launch_shape)
    layout: str = "ref"
    launch: Tuple[Optional[int], Optional[int]] = (None, None)
    # the active wire packing plan (layouts.WirePack, torch twin only):
    # host-encoded codes ship packed and are unpacked on the device
    _wire_pack: object = None
    # the kernel search's hook: _rebuild(layout, threads, chunk_bytes) →
    # a built variant or None; released once a config is applied (it pins
    # the host-side tables)
    _rebuild: object = None
    # packed-shape summary for the cost model's features
    # (compile/costmodel.py): trees/splits/leaves/fields/batch/dtype
    _meta: dict = field(default_factory=dict)
    # the serving variant's feature dict, canonical id and the cost
    # model's prediction for it (set by autotune; ride the dispatch
    # profile into the kernel cost ledger and the drift band)
    _cost_feat: object = None
    _cost_variant: object = None
    _pred_s_per_record: object = None
    # cross-model packing (compile/packs.py): what a pack needs to score
    # this member in its shared launch. "cuda" members: the kernel's
    # tables, launch shape and epilogue (kept current by adopt_variant);
    # "torch" members: the qfn (as the JAX package's _pack_info)
    _pack_info: dict = field(default_factory=dict)

    @property
    def is_classification(self) -> bool:
        return bool(self.labels)

    @property
    def supports_fused(self) -> bool:
        return self._encode_stage is not None

    @property
    def encode_placement(self) -> str:
        """The encode a dispatch runs: "fused" (raw f32 ships, the device
        stage encodes) or "host" (the C++ bucketizer, codes ship). Without
        an ``encode_mode``, fused on a CUDA device when the model has a
        stage, else host."""
        if not self.supports_fused or self.encode_mode == "host":
            return "host"
        if self.encode_mode == "fused" or self.device.type == "cuda":
            return "fused"
        return "host"

    @property
    def staged_bytes_per_record(self) -> float:
        """Bytes one record costs on the wire under the current encode
        placement: 4·F raw f32 fused, F codes of the wire dtype on the
        host path."""
        if self.encode_placement == "fused":
            return 4.0 * len(self.wire.fields)
        if self._wire_pack is not None:
            return float(self._wire_pack.bytes_per_record)
        return float(self.wire.bytes_per_record)

    def pack_wire(self, Xq: np.ndarray) -> np.ndarray:
        """Host-encoded codes → what ships: packed through the active
        wire pack (``wirepack`` layouts), else unchanged."""
        if self._wire_pack is None:
            return Xq
        return self._wire_pack.pack(Xq)

    def build_variant(self, layout: str = "ref", threads=None,
                      chunk_bytes=None):
        """Kernel-search hook: build (without adopting) the catalogue
        variant ``layout`` at the launch shape ``(threads, chunk_bytes)``
        → a built dict for :meth:`adopt_variant`, or None when this
        scorer cannot take it (a layout outside its backend's catalogue,
        a launch shape on the torch twin or one the card cannot take, the
        hook already released). Any other failure raises."""
        if self._rebuild is None:
            return None
        return self._rebuild(layout, threads, chunk_bytes)

    def adopt_variant(self, built: dict, layout: str = "ref") -> None:
        """Swap in a variant from :meth:`build_variant`: tables, scoring
        function, wire pack and launch shape together, so the host side
        and the device side always agree on the wire format."""
        self.params = built["params"]
        self._fn = built["fn"]
        self._wire_pack = built.get("wire_pack")
        self.launch = built.get("launch", (None, None))
        self.layout = layout
        if self._pack_info.get("route") == "cuda":
            self._pack_info["tables"] = {
                k: self.params[k] for k in qtrees_cuda.TABLE_KEYS}
            self._pack_info["launch"] = self.launch

    def pad_wire(self, Xq: np.ndarray) -> Tuple[np.ndarray, int]:
        """Host-side batch alignment → ``(Xq_padded, K)``: a batch whose
        length differs from the compile ``batch_size`` is zero-padded up
        to K whole batches. Callers trim via ``decode(out, n)``. One
        kernel launch covers all K × ``batch_size`` rows."""
        n = Xq.shape[0]
        bs = self.batch_size
        if bs is None or n == bs:
            return Xq, 1
        pad = (-n) % bs
        if pad:
            Xq = np.concatenate(
                [Xq, np.zeros((pad, Xq.shape[1]), Xq.dtype)], axis=0
            )
        return Xq, Xq.shape[0] // bs

    def predict_padded(self, Xq, K: int = 1) -> Output:
        """Score an aligned batch from :meth:`pad_wire` — a numpy array, or
        a tensor already staged on the device. Asynchronous on a CUDA
        device: the result lands on the current stream."""
        if isinstance(Xq, np.ndarray):
            Xq = torch.from_numpy(np.ascontiguousarray(Xq))
        Xq = Xq.to(self.device)
        # a sampled dispatch's region opens here (obs/profiler.py), where
        # the kernel search's timed call starts from codes on the device
        prof_mod.mark_start(self.device)
        if self._wire_pack is not None and Xq.dtype == torch.uint8:
            # packed codes (the wire itself is uint16): unpack on the
            # device in front of the scorer
            Xq = self._wire_pack.unpack_stage()(Xq)
        return self._score_codes(Xq, K)

    def _score_codes(self, Xq: torch.Tensor, K: int) -> Output:
        with torch.no_grad():
            if self.backend != "torch" or K == 1:
                out = self._fn(self.params, Xq)
            else:
                # the torch twin materialises [rows, T, S] planes: score
                # it in compile-batch chunks to bound that memory
                outs = [self._fn(self.params, c) for c in Xq.chunk(K)]
                out = (tuple(torch.cat(o) for o in zip(*outs))
                       if isinstance(outs[0], tuple) else torch.cat(outs))
        # the sampled region closes before the D2H copy
        prof_mod.mark_stop(self.device)
        return out

    def predict_wire(self, Xq) -> Output:
        Xq, K = self.pad_wire(Xq)
        return self.predict_padded(Xq, K)

    # -- state-armed entries (compile/statekernel.py) ----------------------

    def predict_padded_state(self, Xq, K: int, table, slots, rel, w,
                             reset):
        """State-armed twin of :meth:`predict_padded`: the aligned wire
        batch is scored and folded through the keyed state table in one
        dispatch, the state step queued right after the scorer on the
        current stream → ``(out, derived[B, 8], S')``; the caller commits
        ``S'`` to the table. ``out`` is byte-identical to the stateless
        dispatch's. Slot and decay operands come from
        ``KeyedStateTable.route``."""
        from flink_jpmml_tpu_torch.compile import statekernel

        return statekernel.entry_for(self, "wire")(
            Xq, K, table, slots, rel, w, reset)

    def predict_fused_padded_state(self, X, K: int, table, slots, rel, w,
                                   reset):
        """Fused-encode twin of :meth:`predict_padded_state` (raw f32
        in, encode + score + state on the current stream)."""
        from flink_jpmml_tpu_torch.compile import statekernel

        return statekernel.entry_for(self, "fused")(
            X, K, table, slots, rel, w, reset)

    # -- fused encode + score ---------------------------------------------

    def pad_f32(self, X) -> Tuple[np.ndarray, int]:
        """:meth:`pad_wire`'s f32 twin for the fused path: zero rows up to
        K whole compile batches (trimmed by ``decode(out, n)``)."""
        X = np.ascontiguousarray(X, np.float32)
        n = X.shape[0]
        bs = self.batch_size
        if bs is None or n == bs:
            return X, 1
        pad = (-n) % bs
        if pad:
            X = np.concatenate(
                [X, np.zeros((pad, X.shape[1]), np.float32)], axis=0
            )
        return X, X.shape[0] // bs

    def encode_device(self, X) -> torch.Tensor:
        """Run only the device encode stage on a raw f32 batch (a numpy
        array, or a tensor already on the device) → rank codes on the
        scorer's device, byte-identical to ``wire.encode``. NaN cells are
        the missing convention."""
        if self._encode_stage is None:
            raise ModelCompilationException(
                "fused encode unavailable for this model (device cut tables "
                "over budget); use the host-encode path"
            )
        if isinstance(X, np.ndarray):
            X = torch.from_numpy(np.ascontiguousarray(X, np.float32))
        with torch.no_grad():
            return self._encode_stage(self.params, X.to(self.device))

    def predict_fused_padded(self, X, K: int = 1) -> Output:
        """Fused twin of :meth:`predict_padded`: ``X`` is an aligned raw
        f32 batch from :meth:`pad_f32` (numpy, or staged on the device);
        the encode stage and the scorer queue on the current stream, one
        after the other. The stage's codes never pass a wire pack."""
        codes = self.encode_device(X)
        prof_mod.mark_start(self.device)
        return self._score_codes(codes, K)

    def predict_fused(self, X) -> Output:
        """Fused entry: align (:meth:`pad_f32`) + encode + score. Callers
        with an explicit mask fold it in as NaN first."""
        X, K = self.pad_f32(X)
        return self.predict_fused_padded(X, K)

    def score(self, X, M=None) -> List[Prediction]:
        n = np.asarray(X).shape[0]
        return self.decode(self.predict_wire(self.wire.encode(X, M)), n)

    def decode(self, out: Output, n: int) -> List[Prediction]:
        if not self.is_classification:
            values = _host(out)[:n].astype(np.float32)
            return decode_batch(values.tolist(), [True] * n, None, None)
        value, probs, lab = (_host(o) for o in out)
        value = value[:n].astype(np.float32)
        P = probs[:n].astype(np.float32)
        lbls = [self.labels[i] for i in lab[:n]]
        pmaps = [dict(zip(self.labels, row.tolist())) for row in P]
        return decode_batch(value.tolist(), [True] * n, lbls, pmaps)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _split_bf16(v: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 → (hi, lo) bf16 pair with hi + lo ≈ v to ~2^-17 relative."""
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    hi = t.to(torch.bfloat16)
    lo = (t - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _match_ensemble(
    doc: ir.PmmlDocument,
) -> Optional[Tuple[List[ir.TreeModelIR], List[float], str]]:
    """doc → (trees, weights, method) when the model is a tree ensemble the
    fast path can take (regression aggregates, or classification single /
    majority votes); None otherwise."""
    model = doc.model
    if isinstance(model, ir.TreeModelIR):
        return [model], [1.0], "single"
    if not isinstance(model, ir.MiningModelIR):
        return None
    seg = model.segmentation
    if seg is None:
        return None
    method = seg.multiple_model_method
    if model.function_name == "regression":
        if method not in _REGRESSION_METHODS:
            return None
    elif method not in ("majorityVote", "weightedMajorityVote"):
        return None
    trees: List[ir.TreeModelIR] = []
    weights: List[float] = []
    for s in seg.segments:
        if not isinstance(s.predicate, ir.TruePredicate):
            return None
        if not isinstance(s.model, ir.TreeModelIR):
            return None
        if s.model.function_name != model.function_name:
            return None
        trees.append(s.model)
        weights.append(s.weight)
    if not trees:
        return None
    return trees, weights, method


def _torch_qfn(method: str, classification: bool, fused_linear: bool,
               sentinel: int, targets):
    """The twin of the JAX package's XLA ``qfn`` (qtrees.py:914-994) in
    plain PyTorch: int path sums in float32 (exact: ±1/0 operands, sums
    bounded by the depth), leaf values as the f32 sum of the bf16 hi/lo
    pair, max/median over the per-tree plane."""

    def _hit(pp, Xq):
        xv = Xq.long()[:, pp["feat"]]  # [B, T, S] rank codes
        go = torch.where(xv == sentinel, pp["dleft"], xv <= pp["qthr"])
        sign = torch.where(go, 1.0, -1.0)
        acc = torch.einsum("bts,tsl->btl", sign, pp["P_i8"].float())
        return (acc == pp["count_i8"].float()[None]).float()

    def _pair(spec, hit, hi, lo):
        return torch.einsum(spec, hit, hi.float() + lo.float())

    if not classification:
        def qfn(pp, Xq):
            hit = _hit(pp, Xq)
            if fused_linear:
                value = _pair("btl,tl->b", hit, pp["vhi"], pp["vlo"])
            else:
                per_tree = torch.einsum("btl,tl->bt", hit, pp["vals_f32"])
                value = (
                    per_tree.max(dim=1).values if method == "max"
                    else median_lastdim(per_tree)
                )
            return apply_targets_value(value, targets).float()
        return qfn

    def qfn_cls(pp, Xq):
        hit = _hit(pp, Xq)
        probs = _pair("btl,tlc->bc", hit, pp["phi"], pp["plo"])
        lab = None
        if method == "single":
            # the label is the leaf's score attribute, not argmax
            lab = torch.round(
                torch.einsum("btl,tl->b", hit, pp["lab"])
            ).long()
        return _vote_epilogue(probs, targets, lab)
    return qfn_cls


def _vote_epilogue(probs: torch.Tensor, targets, lab=None):
    """(value, probs, label) from f32[B, C] class shares, as the JAX
    package's classification epilogue (qtrees.py:1076-1087): the label is
    the argmax unless given, the value its share after Targets."""
    if lab is None:
        lab = torch.argmax(probs, dim=1)
    value = torch.gather(probs, 1, lab[:, None])[:, 0]
    value = apply_targets_value(value, targets)
    return value.float(), probs.float(), lab


def build_quantized_scorer(
    doc: ir.PmmlDocument,
    batch_size: Optional[int] = None,
    config: Optional[CompileConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Optional[QuantizedScorer]:
    """Build the rank-wire fast path for ``doc`` on ``device`` (default:
    the CUDA card; raises DeviceUnavailableError without one).

    Returns None when the model shape is outside the fast path's contract
    (the JAX package's eligibility rules, unchanged). A Hopper kernel
    scores the model when it fits one (a uint8 wire, at most 64 split
    slots and 256 fields, and a linear regression aggregate or a
    majorityVote / weightedMajorityVote forest of at most ``MAX_CLASSES``
    classes), the torch twin otherwise."""
    dev = resolve_device(device)
    config = config or CompileConfig()
    if doc.transformations.derived_fields or doc.output_fields:
        return None
    matched = _match_ensemble(doc)
    if matched is None:
        return None
    trees, weights, method = matched

    fields = doc.active_fields
    ctx = LowerCtx(
        field_index={f: i for i, f in enumerate(fields)},
        codecs=build_codecs(doc.data_dictionary),
        config=config,
    )
    # the rank wire bypasses the compiler's sanitize stage: any doc whose
    # fields can be *invalid* must stay on the f32 path
    if (
        extract_invalid_policy(doc.data_dictionary, doc.model.mining_schema, ctx)
        is not None
    ):
        return None
    try:
        canons, classification, depth = _canonicalize_forest(trees, ctx)
    except ModelCompilationException:
        return None
    # int8 path sums are bounded by ±depth — beyond 127 they would wrap
    if depth > min(config.max_dense_depth, 127):
        return None
    if classification and method not in (
        "single", "majorityVote", "weightedMajorityVote"
    ):
        return None
    if any(_canon_has_halt(c) for c in canons):
        return None
    try:
        packed = pack_ensemble(canons, classification)
    except ModelCompilationException:
        return None
    p = packed.params
    if "set_codes" in p or p["mnull"].any():
        return None
    T, S, L = packed.n_trees, packed.n_splits, packed.n_leaves
    ops = packed.opcodes
    # real split slots lie on >=1 leaf path; padded slots have all-zero rows
    real = np.abs(p["P"]).sum(axis=2) > 0  # [T, S]
    if not set(np.unique(ops[real]).tolist()) <= _SUPPORTED_OPS:
        return None
    if ctx.codecs:
        codec_cols = {ctx.field_index[f] for f in ctx.codecs if f in ctx.field_index}
        if any(int(c) in codec_cols for c in np.unique(p["feat"][real])):
            return None

    thresh = p["thresh"]
    feat = p["feat"]
    # normalise every real split to "go_left iff rank <= cut_index"
    cut_val = np.where(
        (ops == 0) | (ops == 3),
        np.nextafter(thresh, -np.inf, dtype=np.float32),
        thresh,
    )
    flip = (ops == 2) | (ops == 3)

    F = len(fields)
    cuts: List[np.ndarray] = [np.empty((0,), np.float32) for _ in range(F)]
    for j in range(F):
        sel = real & (feat == j)
        if sel.any():
            cuts[j] = np.unique(cut_val[sel].astype(np.float32))
    max_cuts = max((len(c) for c in cuts), default=0)
    if max_cuts <= 254:
        dtype, sentinel = np.uint8, 255
    elif max_cuts <= 65534:
        dtype, sentinel = np.uint16, 65535
    else:
        return None

    qthr = np.zeros((T, S), dtype)
    for j in range(F):
        sel = real & (feat == j)
        if sel.any():
            qthr[sel] = np.searchsorted(cuts[j], cut_val[sel]).astype(dtype)

    dleft = (p["dleft"] > 0.5) ^ flip
    P = p["P"].copy()
    P[flip] = -P[flip]

    # fold per-tree aggregate coefficients into leaf values where the
    # aggregate is linear
    w = np.asarray(weights, np.float32)
    fused_linear = False
    params: Dict[str, Union[np.ndarray, torch.Tensor]] = {
        "feat": feat.astype(np.int64),
        "qthr": qthr.astype(np.int64),
        "dleft": dleft,
        "P_i8": P.astype(np.int8),
        "count_i8": p["count"].astype(np.int8),
    }
    if not classification:
        vals = p["leaf_values"].astype(np.float32)  # [T, L]
        if method in ("single", "sum"):
            fused_linear, coef = True, np.ones((T,), np.float32)
        elif method == "average":
            fused_linear, coef = True, np.full((T,), 1.0 / T, np.float32)
        elif method == "weightedAverage":
            fused_linear, coef = True, (w / w.sum()).astype(np.float32)
        else:  # max / median need the per-tree plane
            coef = np.ones((T,), np.float32)
        params["vhi"], params["vlo"] = _split_bf16(vals * coef[:, None])
        if not fused_linear:
            params["vals_f32"] = vals
    else:
        labels = packed.labels
        C = len(labels)
        leaf_label = np.round(p["leaf_label"]).astype(np.int64)  # [T, L]
        if method == "single":
            probs_tbl = p["leaf_probs"].astype(np.float32)  # [T, L, C]
        else:
            w_eff = (
                w if method == "weightedMajorityVote"
                else np.ones((T,), np.float32)
            )
            probs_tbl = np.zeros((T, L, C), np.float32)
            tt, ll = np.meshgrid(np.arange(T), np.arange(L), indexing="ij")
            probs_tbl[tt, ll, leaf_label] = 1.0
            probs_tbl *= w_eff[:, None, None]
            probs_tbl /= w_eff.sum()
        params["phi"], params["plo"] = _split_bf16(probs_tbl)
        params["lab"] = leaf_label.astype(np.float32)

    targets = doc.targets
    repl, has_repl = extract_missing_replacements(doc.model.mining_schema, ctx)
    wire = QuantizedWire(
        fields=fields,
        cuts=tuple(cuts),
        dtype=dtype,
        sentinel=sentinel,
        repl=repl,
        has_repl=has_repl,
    )
    # the device encode stage stands in front of whichever backend scores
    # (the JAX package wires it before the XLA and the Pallas program
    # alike); its tables ride in the params
    enc_tables = wire.device_tables()
    encode_stage = None
    if enc_tables is not None:
        params.update(enc_tables)
        encode_stage = _make_encode_stage(
            sentinel, dtype, bool(has_repl.any()))

    # the JAX package's Pallas conditions (qtrees.py:1012-1018) under the
    # kernels' own limits
    kernel_fits = (
        dtype is np.uint8
        and S <= qtrees_cuda.MAX_SPLITS
        and F <= qtrees_cuda.MAX_FIELDS
        and (
            (not classification and fused_linear)
            or (
                classification
                and method in ("majorityVote", "weightedMajorityVote")
                and len(packed.labels) <= qtrees_cuda.MAX_CLASSES
            )
        )
    )
    if kernel_fits:
        # the kernel sums one f32 row per hit leaf: the bf16 pair's sum
        # (qtrees.py:1028)
        hi, lo = ("phi", "plo") if classification else ("vhi", "vlo")
        params.update(qtrees_cuda.pack_tables(
            feat, qthr, dleft, P.astype(np.int8), p["count"], params[hi],
            params[lo], n_fields=F,
        ))
        C = params["rows"].shape[2]

        def epilogue(rows):
            """f32[N, C] kernel sums → the scorer's output."""
            if classification:
                return _vote_epilogue(rows, targets)
            return apply_targets_value(rows[:, 0], targets).float()

        def make_fn(threads=None, chunk_bytes=None):
            def fn(pp, Xq):
                return epilogue(qtrees_cuda.leaf_rows(
                    Xq, {k: pp[k] for k in qtrees_cuda.TABLE_KEYS}, F,
                    threads, chunk_bytes,
                ))
            return fn

        fn = make_fn()
    else:
        qfn = fn = _torch_qfn(method, classification, fused_linear, sentinel,
                              targets)
    chosen = (
        "torch" if not kernel_fits
        else "cuda" if dev.type == "cuda" else "cuda_plain"
    )
    dev_params = to_device(params, dev)
    bfs_tables: Dict[str, torch.Tensor] = {}

    def rebuild(layout="ref", threads=None, chunk_bytes=None):
        """A catalogue variant (compile/layouts.py) of this scorer → a
        built dict, or None where the backend cannot take it."""
        fl = layouts.flags(layout)
        if fl is None:
            return None
        if kernel_fits:
            if not fl <= {"bfs"}:
                return None
            try:
                qtrees_cuda.launch_shape(
                    F, T, params["walk"].shape[1], threads, chunk_bytes)
            except ValueError:
                return None
            p2 = dict(dev_params)
            if "bfs" in fl:
                if "walk" not in bfs_tables:  # built once, shared
                    bfs_tables["walk"] = torch.from_numpy(layouts.bfs_walk(
                        params["walk"], S, L, C)).to(dev)
                p2["walk"] = bfs_tables["walk"]
            return {"params": p2, "fn": make_fn(threads, chunk_bytes),
                    "wire_pack": None, "launch": (threads, chunk_bytes)}
        if threads is not None or chunk_bytes is not None:
            return None
        p2 = dict(dev_params)
        if "bfs" in fl:
            perm = layouts.bfs_split_order(params["P_i8"])
            soa = layouts.apply_split_order(
                perm, params["feat"], params["qthr"], params["dleft"],
                params["P_i8"])
            p2.update(to_device({
                "feat": soa["feat"], "qthr": soa["qthr"],
                "dleft": soa["dleft"], "P_i8": soa["P"]}, dev))
        wp = None
        if "wirepack" in fl:
            wp = layouts.plan_wire_pack(wire)
            if wp is None:
                return None
        return {"params": p2, "fn": qfn, "wire_pack": wp,
                "launch": (None, None)}

    # stable identity for the autotune cache, the JAX package's: the wire
    # tables and packed shapes pin the kernel variant (weights do not
    # change the choice, but folding in the threshold tables keeps the key
    # from colliding across same-shape models)
    hasher = hashlib.sha256()
    hasher.update(
        f"{T}:{S}:{L}:{F}:{batch_size}:{np.dtype(dtype).name}:"
        f"{int(classification)}:{method}".encode()
    )
    for c in cuts:
        hasher.update(c.tobytes())
    hasher.update(qthr.tobytes())
    hasher.update(np.asarray(dleft, np.uint8).tobytes())

    scorer = QuantizedScorer(
        wire=wire,
        params=dev_params,
        field_space=prepare.FieldSpace(fields=fields, codecs=ctx.codecs),
        batch_size=batch_size,
        n_trees=T,
        device=dev,
        _fn=fn,
        backend=chosen,
        labels=packed.labels if classification else (),
        _encode_stage=encode_stage,
        model_hash=hasher.hexdigest()[:16],
        _rebuild=rebuild,
        _meta={
            "trees": float(T), "splits": float(S), "leaves": float(L),
            "fields": float(F), "batch": float(batch_size or 0),
            "dtype_rank": float(np.dtype(dtype).itemsize),
            "classification": 1.0 if classification else 0.0,
            "classes": float(len(packed.labels)) if classification else 1.0,
            # the walk's integer steps per record: the sum of the trees'
            # depths (the profiler's operations per record on the card)
            **({"path_steps": float(
                ((params["walk"][:, 0] >> 8) & 0xFF).sum())}
               if kernel_fits else {}),
        },
    )
    scorer._pack_info = {
        "fields": F, "dtype": dtype, "sentinel": sentinel,
        "classification": classification,
    }
    if kernel_fits:
        scorer._pack_info.update(
            route="cuda", epilogue=epilogue,
            tables={k: dev_params[k] for k in qtrees_cuda.TABLE_KEYS},
            launch=scorer.launch)
    else:
        scorer._pack_info.update(route="torch", qfn=qfn)
    _consult_autotune(scorer)
    return scorer


def _consult_autotune(scorer: QuantizedScorer) -> None:
    """Apply the config the autotune cache holds for this scorer's model
    and device (compile/autotune.py), as the JAX package does at every
    build. A missing, stale or corrupt entry reads as none, and the
    scorer keeps its own choices."""
    from flink_jpmml_tpu_torch.compile import autotune

    cfg = autotune.lookup(scorer.model_hash, autotune.backend_key(scorer))
    if cfg is not None:
        autotune.apply(scorer, cfg)
