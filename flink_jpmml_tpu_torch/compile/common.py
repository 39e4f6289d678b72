"""Shared lowering machinery: batch layout, output tuple, lowering context.

The port of ``flink_jpmml_tpu/compile/common.py``. Every model family
lowers to a plain function on tensors

    (params: dict[str, Tensor], X: f32[B, F], M: bool[B, F]) -> ModelOutput

where ``X`` holds the records' field values in field-space order and ``M``
marks missing cells (``True`` = missing). Per-record failures are lanes
where ``valid`` is ``False``, never exceptions.

String-valued categorical fields are encoded host-side to float codes by
:mod:`flink_jpmml_tpu_torch.compile.prepare`; predicates over such fields
compare codes, so the device path stays purely numeric.

Host-side tables (codecs, the invalid-value policy, missing-value
replacements) are numpy, exactly as in the JAX package; the compiler moves
them onto the model's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.config import CompileConfig
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException


class ModelOutput(NamedTuple):
    """Batched model result; structure is static per compiled model.

    ``value``:  f32[B] — regression value / winning-class probability.
    ``valid``:  bool[B] — lane validity (False ⇔ reference's EmptyScore).
    ``probs``:  f32[B, C] or None — per-class probabilities.
    ``label_idx``: i64[B] or None — index into the model's label list.
    """

    value: torch.Tensor
    valid: torch.Tensor
    probs: Optional[torch.Tensor] = None
    label_idx: Optional[torch.Tensor] = None


# fn(params, X, M) -> ModelOutput; params is a (nested) dict of tensors
ModelFn = Callable[[dict, torch.Tensor, torch.Tensor], ModelOutput]


@dataclass
class Lowered:
    """A lowered model: fn + its host (numpy) params + metadata."""

    fn: ModelFn
    params: dict
    labels: Tuple[str, ...] = ()  # class labels (classification)

    @property
    def is_classification(self) -> bool:
        return bool(self.labels)


@dataclass
class LowerCtx:
    """Compile-time context threaded through the per-family lowerers.

    ``field_index`` maps field name → column in ``X``; modelChain extends it
    with intermediate output fields. ``codecs`` maps a categorical field
    name to its value→code table (only string-typed categorical fields need
    one; numeric fields compare raw values).
    """

    field_index: Dict[str, int]
    codecs: Dict[str, Dict[str, float]] = dc_field(default_factory=dict)
    config: CompileConfig = dc_field(default_factory=CompileConfig)
    nested: bool = False  # True inside MiningModel segments

    @property
    def n_fields(self) -> int:
        return len(self.field_index)

    def column(self, name: str) -> int:
        try:
            return self.field_index[name]
        except KeyError:
            raise ModelCompilationException(
                f"model references field {name!r} which is not in the input "
                f"field space {sorted(self.field_index)}"
            ) from None

    def encode(self, name: str, raw: str) -> float:
        """Encode a PMML literal for ``name``: string-categorical fields go
        through their codec (unknown category → NaN, which never matches);
        everything else must parse as a number."""
        codec = self.codecs.get(name)
        if codec is not None:
            return codec.get(raw, math.nan)
        try:
            return float(raw)
        except ValueError:
            raise ModelCompilationException(
                f"non-numeric literal {raw!r} for non-categorical field {name!r}"
            ) from None

    def with_extra_fields(
        self, names: Tuple[str, ...], codecs: Dict[str, Dict[str, float]]
    ) -> "LowerCtx":
        """Extend the field space (modelChain intermediate outputs)."""
        idx = dict(self.field_index)
        for n in names:
            if n in idx:
                raise ModelCompilationException(
                    f"modelChain output field {n!r} shadows an existing field"
                )
            idx[n] = len(idx)
        merged = dict(self.codecs)
        merged.update(codecs)
        return LowerCtx(field_index=idx, codecs=merged, config=self.config)


class DeviceConst:
    """A compile-time numpy constant (column indices, per-field weights)
    that a lowered function reads on every call: copied to each device
    once and kept there, so the hot path issues no host→device copy for
    it. The JAX package closes over the same arrays as jit constants."""

    def __init__(self, a, dtype=None):
        self.array = np.ascontiguousarray(a, dtype)
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = torch.from_numpy(self.array).to(device)
            self._on[device] = t
        return t


class TpLeaf:
    """A wide parameter leaf split into model-axis row slices, one on each
    of a mesh row's devices (``parallel/sharding.mesh_sharded`` places it
    where the unsharded tree holds a tensor). A contracting consumer
    computes one partial product per slice on the slice's device and adds
    the partials in slice order (:meth:`partial_sum`), where the JAX
    package lets GSPMD partition the contracting dot and ``psum`` the
    partials; a consumer that selects rather than sums reads the slices
    gathered onto one device (:meth:`gather`), the all-gather GSPMD
    inserts."""

    __slots__ = ("name", "parts", "bounds", "shape")

    def __init__(self, name: str, host: torch.Tensor, devices):
        m = len(devices)
        rows = host.shape[0]
        if m < 1 or rows % m:
            raise ModelCompilationException(
                f"{name}: {rows} rows do not split over {m} devices")
        step = rows // m
        self.name = name
        self.shape = tuple(host.shape)
        self.bounds = tuple((k * step, (k + 1) * step) for k in range(m))
        self.parts = tuple(
            host[lo:hi].to(dev) for (lo, hi), dev in zip(self.bounds, devices)
        )

    def partial_sum(self, fn, device: torch.device, *paired: "TpLeaf"
                    ) -> torch.Tensor:
        """Σ over the slices, in slice order, of ``fn(lo, hi, part,
        *paired_parts)`` (run on the part's device; ``paired`` leaves are
        split alike, as a table's codes and coefficients are), added on
        ``device``."""
        total = None
        for k, ((lo, hi), part) in enumerate(zip(self.bounds, self.parts)):
            p = fn(lo, hi, part, *(o.parts[k] for o in paired)).to(device)
            total = p if total is None else total + p
        return total

    def gather(self, device: torch.device) -> torch.Tensor:
        """The whole leaf on ``device``: the slices concatenated in slice
        order (made anew on every call; the leaf stays stored split)."""
        return torch.cat([part.to(device) for part in self.parts])


def tp_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain weight tensor, or the slice-ordered sum of
    the per-slice partials ``x[:, lo:hi] @ part`` for a :class:`TpLeaf`."""
    if isinstance(w, TpLeaf):
        return w.partial_sum(
            lambda lo, hi, part: torch.matmul(x[:, lo:hi].to(part.device),
                                              part),
            x.device)
    return torch.matmul(x, w)


def build_codecs(dd: ir.DataDictionary) -> Dict[str, Dict[str, float]]:
    """value→code tables for string-typed categorical fields: the code of a
    category is its index in the DataField's declared value list."""
    codecs: Dict[str, Dict[str, float]] = {}
    for f in dd.fields:
        if f.is_categorical and f.dtype == "string" and f.values:
            codecs[f.name] = {v: float(i) for i, v in enumerate(f.values)}
    return codecs


def to_device(tree, device: torch.device):
    """Nested dict of numpy arrays → the same dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    a = np.asarray(tree)  # a 0-d scalar keeps its shape
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a).to(device)


# ---------------------------------------------------------------------------
# Predicate lowering (MiningModel segment predicates)
# ---------------------------------------------------------------------------


class PredOut(NamedTuple):
    is_true: torch.Tensor  # bool[B]
    unknown: torch.Tensor  # bool[B]


PredFn = Callable[[torch.Tensor, torch.Tensor], PredOut]

_CMP = {
    "equal": lambda x, t: x == t,
    "notEqual": lambda x, t: x != t,
    "lessThan": lambda x, t: x < t,
    "lessOrEqual": lambda x, t: x <= t,
    "greaterThan": lambda x, t: x > t,
    "greaterOrEqual": lambda x, t: x >= t,
}


def lower_predicate(pred: ir.Predicate, ctx: LowerCtx) -> PredFn:
    """Three-valued predicate semantics, vectorized: (true, unknown)."""
    if isinstance(pred, (ir.TruePredicate, ir.FalsePredicate)):
        value = isinstance(pred, ir.TruePredicate)

        def const(X, M, _v=value):
            B = X.shape[0]
            return PredOut(
                torch.full((B,), _v, dtype=torch.bool, device=X.device),
                torch.zeros((B,), dtype=torch.bool, device=X.device),
            )
        return const
    if isinstance(pred, ir.SimplePredicate):
        col = ctx.column(pred.field)
        op = pred.operator
        if op in ("isMissing", "isNotMissing"):
            def miss(X, M, _col=col, _neg=(op == "isNotMissing")):
                m = M[:, _col]
                t = ~m if _neg else m
                return PredOut(t, torch.zeros_like(t))
            return miss
        v = np.float32(ctx.encode(pred.field, pred.value))
        cmp = _CMP[op]

        def simple(X, M, _col=col, _v=float(v), _cmp=cmp):
            m = M[:, _col]
            t = _cmp(X[:, _col], _v) & ~m
            return PredOut(t, m)
        return simple
    if isinstance(pred, ir.SimpleSetPredicate):
        col = ctx.column(pred.field)
        codes = np.asarray(
            [ctx.encode(pred.field, s) for s in pred.values], np.float32
        )
        neg = pred.boolean_operator == "isNotIn"

        def sset(X, M, _col=col, _codes=codes, _neg=neg):
            m = M[:, _col]
            c = torch.from_numpy(_codes).to(X.device)
            member = (X[:, _col, None] == c[None, :]).any(dim=-1)
            t = (~member if _neg else member) & ~m
            return PredOut(t, m)
        return sset
    if isinstance(pred, ir.CompoundPredicate):
        subs = [lower_predicate(p, ctx) for p in pred.predicates]
        op = pred.boolean_operator
        if op not in ("and", "or", "xor", "surrogate"):
            raise ModelCompilationException(f"unsupported CompoundPredicate {op!r}")

        def compound(X, M, _subs=subs, _op=op):
            outs = [s(X, M) for s in _subs]
            ts = torch.stack([o.is_true for o in outs])
            us = torch.stack([o.unknown for o in outs])
            if _op == "and":
                any_false = (~ts & ~us).any(dim=0)
                unknown = ~any_false & us.any(dim=0)
                return PredOut(ts.all(dim=0), unknown)
            if _op == "or":
                any_true = ts.any(dim=0)
                unknown = ~any_true & us.any(dim=0)
                return PredOut(any_true, unknown)
            if _op == "xor":
                unknown = us.any(dim=0)
                parity = ts.to(torch.int32).sum(dim=0) % 2 == 1
                return PredOut(parity & ~unknown, unknown)
            # surrogate: first sub-predicate whose value is known
            result = torch.zeros_like(ts[0])
            decided = torch.zeros_like(ts[0])
            for i in range(ts.shape[0]):
                known = ~us[i] & ~decided
                result = torch.where(known, ts[i], result)
                decided = decided | ~us[i]
            return PredOut(result, ~decided)
        return compound
    raise ModelCompilationException(
        f"unsupported predicate {type(pred).__name__}"
    )


# ---------------------------------------------------------------------------
# Targets rescale
# ---------------------------------------------------------------------------


def apply_targets_value(value: torch.Tensor, targets: Tuple[ir.Target, ...]):
    """Targets rescale/cast on a bare value vector (shared by the f32 and
    rank-wire scoring paths so their semantics cannot diverge)."""
    if not targets:
        return value
    t = targets[0]
    v = value * float(np.float32(t.rescale_factor)) + float(
        np.float32(t.rescale_constant)
    )
    if t.cast_integer == "round":
        v = torch.round(v)
    elif t.cast_integer == "ceiling":
        v = torch.ceil(v)
    elif t.cast_integer == "floor":
        v = torch.floor(v)
    return v


def apply_targets(out: ModelOutput, targets: Tuple[ir.Target, ...]) -> ModelOutput:
    if not targets:
        return out
    return out._replace(value=apply_targets_value(out.value, targets))


_TREAT_CODES = {"asIs": 0, "asMissing": 1, "returnInvalid": 2, "asValue": 3}


def extract_invalid_policy(
    dd: "ir.DataDictionary", schema: "ir.MiningSchema", ctx: "LowerCtx"
):
    """DataDictionary validity + ``invalidValueTreatment`` per raw input
    column → policy dict (numpy) for the sanitize stage, or None when no
    active field can ever be invalid (no declared category table, no
    Intervals). Keys: ``treat`` i32[F] (0 asIs, 1 asMissing,
    2 returnInvalid — the spec default — 3 asValue), ``repl`` f32[F],
    ``has_cat`` bool[F], ``cat_n`` f32[F], and when any Intervals exist
    ``lo``/``hi`` f32[F, I] with ``lo_open``/``hi_open`` bool[F, I] and
    ``has_ivl`` bool[F] (else ``has_ivl`` is None)."""
    F = ctx.n_fields
    has_cat = np.zeros((F,), bool)
    cat_n = np.zeros((F,), np.float32)
    intervals: dict = {}
    for f in dd.fields:
        j = ctx.field_index.get(f.name)
        if j is None:
            continue
        if f.is_categorical and f.dtype == "string" and f.values:
            has_cat[j] = True
            cat_n[j] = len(f.values)
        if f.intervals:
            intervals[j] = f.intervals
    if not has_cat.any() and not intervals:
        return None
    treat = np.full((F,), _TREAT_CODES["returnInvalid"], np.int32)
    repl = np.zeros((F,), np.float32)
    for mf in schema.fields:
        j = ctx.field_index.get(mf.name)
        if j is None:
            continue
        code = _TREAT_CODES.get(mf.invalid_value_treatment)
        if code is None:
            raise ModelCompilationException(
                f"unsupported invalidValueTreatment "
                f"{mf.invalid_value_treatment!r} on field {mf.name!r}"
            )
        treat[j] = code
        if code == _TREAT_CODES["asValue"] and (
            has_cat[j] or j in intervals
        ):
            if mf.invalid_value_replacement is None:
                raise ModelCompilationException(
                    f"invalidValueTreatment='asValue' on {mf.name!r} "
                    "needs invalidValueReplacement"
                )
            repl[j] = ctx.encode(mf.name, mf.invalid_value_replacement)
            if math.isnan(repl[j]):
                raise ModelCompilationException(
                    f"invalidValueReplacement "
                    f"{mf.invalid_value_replacement!r} on {mf.name!r} is "
                    "itself not a declared value"
                )
    policy = {
        "treat": treat, "repl": repl, "has_cat": has_cat, "cat_n": cat_n,
    }
    if intervals:
        I = max(len(v) for v in intervals.values())
        lo = np.full((F, I), -np.inf, np.float32)
        hi = np.full((F, I), np.inf, np.float32)
        lo_open = np.zeros((F, I), bool)
        hi_open = np.zeros((F, I), bool)
        has_ivl = np.zeros((F,), bool)
        for j, ivs in intervals.items():
            has_ivl[j] = True
            for k in range(len(ivs), I):  # padded slot: matches nothing
                lo[j, k] = np.inf
                hi[j, k] = -np.inf
            for k, iv in enumerate(ivs):
                if iv.left is not None:
                    lo[j, k] = iv.left
                    lo_open[j, k] = iv.closure.startswith("open")
                if iv.right is not None:
                    hi[j, k] = iv.right
                    hi_open[j, k] = iv.closure.endswith("Open")
        policy.update(
            lo=lo, hi=hi, lo_open=lo_open, hi_open=hi_open, has_ivl=has_ivl
        )
    else:
        policy["has_ivl"] = None
    return policy


def extract_missing_replacements(
    schema: "ir.MiningSchema", ctx: "LowerCtx"
) -> Tuple[np.ndarray, np.ndarray]:
    """Mining-schema ``missingValueReplacement`` per input column →
    (repl f32[F], has_repl bool[F]). Shared by compiler.compile_pmml and the
    rank wire (qtrees.py) — one implementation, one semantics."""
    F = ctx.n_fields
    repl = np.zeros((F,), np.float32)
    has_repl = np.zeros((F,), bool)
    for mf in schema.fields:
        if mf.missing_value_replacement is not None and mf.name in ctx.field_index:
            j = ctx.field_index[mf.name]
            has_repl[j] = True
            repl[j] = ctx.encode(mf.name, mf.missing_value_replacement)
    return repl, has_repl
