"""The fused state stage: lookup → derive → score → update, one dispatch.

The port of ``flink_jpmml_tpu/compile/statekernel.py``. The JAX module is
plain XLA gather and scatter, no Pallas kernel, so the port's stage is
plain PyTorch ops queued on the scorer's stream right after the kernel
of the same dispatch:

    out            = member scorer(params, X)        # unchanged
    derived[B, 8]  = gather(S, slots) → session features
    S'             = S + scatter-add / -min / -max over the batch

Batch-consistent reads, as in the JAX module: every record's derived
features see the table as of the batch start; the updates are sums with
product-form decay weights, a max of the last-seen stride, and min / max
of the score.

**Deterministic sums, in the JAX order.** ``index_add_`` and
``index_put_(accumulate=True)`` use float atomics on CUDA, so the order of
the adds into a slot that appears twice in a batch would change from run
to run, and a replayed table would not be byte-identical (the JAX
acceptance: ``bench.py`` ``_stateful_kill_parity``). The step therefore
sorts the batch by slot with a stable sort, puts each touched slot's
current row at the head of its run of records, and folds the run in one
sequential loop (``torch.segment_reduce`` over the laid-out rows, from
``-0.0``: no atomics), then writes the fold back through an index write
whose indices are unique apart from the scratch row (which the step
zeroes). Min and max are order-free (``scatter_reduce_`` ``amin`` /
``amax``).

That fold is the order of the JAX CPU scatter, which adds a slot's
records into the row one at a time: ``((S + a1) + a2) + a3``. So the
port's table is byte-identical to the JAX step's on any batch, repeated
keys included, and it does not depend on how a stream was cut into
dispatches: a block pipeline that aggregates a backed-up ring into one
multi-batch dispatch, or a replay after a kill that groups the same
records otherwise, folds the same records in the same order into the
same bytes. On the same inputs the result is the same bytes on every
run and on either device.

A table held in data-axis row blocks over several cards
(``runtime/state.RowBlocks``, ``KeyedStateTable.shard``) steps block by
block, each on its own device (``_state_step_blocks``), to the same
bytes.

The step writes a new tensor (out of place, see ``runtime/state.py``):
the port never donates, and the committed tensor is never written after
a snapshot may have started to read it.

Bypassed records (replay below the exactly-once high-water, pad rows)
arrive with ``slot == scratch`` and weight 0: they read the scratch row
(derived zeros) and their contributions land on the scratch row, which
the step zeroes before it returns.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_jpmml_tpu_torch.runtime.state import (
    COL_COUNT,
    COL_DSUM,
    COL_LAST_T,
    COL_MAX,
    COL_MIN,
    COL_SQSUM,
    COL_SUM,
    COL_DCOUNT,
    STATE_WIDTH,
)
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

# row written into freshly claimed slots before the batch gather: zero
# counts, ±inf extrema so the first min/max lands exactly
_INIT_ROW = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, float("inf"), float("-inf"))
# floor on the decayed-count denominator (a key whose decayed mass fully
# evaporated reads mean 0, not inf)
_DCOUNT_FLOOR = 1e-30


def _as_tensor(x, dtype, device) -> torch.Tensor:
    """A host operand (numpy or tensor) on ``device`` as ``dtype``. On the
    card a numpy operand crosses through pinned memory without a host
    wait (a pageable copy would synchronize the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=dtype)


_INIT_ROWS = {}


def _init_row(device) -> torch.Tensor:
    """``_INIT_ROW`` on ``device``, made once."""
    row = _INIT_ROWS.get(device)
    if row is None:
        row = _INIT_ROWS[device] = torch.tensor(
            _INIT_ROW, dtype=torch.float32, device=device)
    return row


def _segment_folds(slots: torch.Tensor, heads: torch.Tensor,
                   adds: torch.Tensor):
    """Per distinct slot, its row's ``heads`` value with the slot's
    records' ``adds`` rows folded in one at a time, in record order:
    ``((h + a1) + a2) + a3``, the order of the JAX CPU scatter-add →
    ``(seg_slot i64[B], seg_fold f32[B, K])``: segment j's slot and fold,
    for j below the number of distinct slots; the rest are empty
    segments (slot -1, fold -0). ``heads[i]`` is the current row of
    ``slots[i]``. No host sync: the shapes are the batch's.

    The records, stably sorted by slot, are laid out with each segment's
    head just before its first record (sorted row i moves to
    ``i + seg[i] + 1``, segment j's head to ``start[j] + j``), and
    ``torch.segment_reduce`` adds each segment's rows in a sequential
    loop from ``-0.0``, which leaves the head's bytes as they are. Each
    empty segment j takes one row of the fill behind the laid-out rows
    (row ``B + j``), so no segment's loop runs over the fill."""
    B, K = adds.shape
    dev = slots.device
    order = torch.sort(slots, stable=True).indices
    ss = slots[order]
    first = torch.ones(B, dtype=torch.bool, device=dev)
    first[1:] = ss[1:] != ss[:-1]
    seg = torch.cumsum(first.long(), 0) - 1  # segment of each sorted row
    ar = torch.arange(B + 1, device=dev)
    # each segment's start; unused segments start at B
    starts = torch.full((B + 1,), B, dtype=torch.long, device=dev)
    starts.scatter_reduce_(0, seg, ar[:B], "amin")
    # rows B + n_seg .. 2B - 1 are fill, one an unused segment, and row
    # 2B takes the heads of the sorted rows that start no segment
    head_at = ar[:B] + seg
    ext = torch.full((2 * B + 1, K), -0.0, dtype=adds.dtype, device=dev)
    ext[head_at + 1] = adds[order]
    ext[torch.where(first, head_at, 2 * B)] = heads[order]
    offsets = starts + ar
    seg_fold = torch.segment_reduce(
        ext, "sum", offsets=offsets, axis=0, unsafe=True, initial=-0.0)
    seg_slot = torch.full((B,), -1, dtype=torch.long, device=dev)
    seg_slot.scatter_(0, seg, ss)
    return seg_slot, seg_fold


def _state_step(S, score, slots, rel, w, reset, scratch, decay):
    """One batch's state transition.

    ``S[rows, 8]`` table · ``score[B]`` model outputs · ``slots[B]`` row
    per record (``scratch`` = bypass) · ``rel[B]`` decay stride relative
    to the table epoch · ``w[B]`` product-form decay weight λ^-rel (0 for
    bypassed rows) · ``reset[B]`` fresh-slot marks → ``(derived[B, 8],
    S')`` with ``S'`` a new tensor. The host-side operands may be numpy
    arrays or tensors; they move to ``S``'s device."""
    dev = S.device
    f32 = torch.float32
    score = _as_tensor(score, f32, dev)
    slots = _as_tensor(slots, torch.long, dev)
    rel = _as_tensor(rel, f32, dev)
    w = _as_tensor(w, f32, dev)
    reset = _as_tensor(reset, torch.bool, dev)
    S = S.clone()
    # fresh slots re-initialize; rows with nothing to reset aim the write
    # at the scratch row (re-zeroed at the end regardless)
    sel = torch.where(reset, slots, scratch)
    S[sel] = _init_row(dev)
    pre = S[slots]
    count = pre[:, COL_COUNT]
    seen = count > 0
    safe = torch.clamp(count, min=1.0)
    mean = pre[:, COL_SUM] / safe
    var = torch.clamp(pre[:, COL_SQSUM] / safe - mean * mean, min=0.0)
    # product form: stored U = Σ λ^-rel_i, decayed count as of this
    # record's stride = U · λ^rel (≤ U); the decayed mean is the ratio,
    # where λ^rel cancels
    dcount = pre[:, COL_DCOUNT] * torch.pow(float(np.float32(decay)), rel)
    dmean = pre[:, COL_DSUM] / torch.clamp(pre[:, COL_DCOUNT],
                                           min=_DCOUNT_FLOOR)
    gap = rel - pre[:, COL_LAST_T]
    derived = torch.stack(
        [count, mean, var, dcount, dmean, gap,
         pre[:, COL_MIN], pre[:, COL_MAX]], dim=1)
    derived = torch.where(seen[:, None], derived,
                          torch.zeros((), dtype=f32, device=dev))
    # the five accumulator columns are contiguous: one segmented sum
    adds = torch.stack(
        [torch.ones_like(score), score, score * score, w, w * score], dim=1)
    seg_slot, seg_fold = _segment_folds(
        slots, pre[:, COL_COUNT:COL_DSUM + 1], adds)
    # empty segments write -0 into the scratch row, zeroed below
    dst = torch.where(seg_slot >= 0, seg_slot, scratch)
    S[dst, COL_COUNT:COL_DSUM + 1] = seg_fold
    S[:, COL_LAST_T].scatter_reduce_(0, slots, rel, "amax")
    S[:, COL_MIN].scatter_reduce_(0, slots, score, "amin")
    S[:, COL_MAX].scatter_reduce_(0, slots, score, "amax")
    # bypass / pad contributions all landed on the scratch row: zero it
    # so snapshots stay clean and the next batch's bypass reads zeros
    S[scratch].zero_()
    return derived, S


def _state_step_blocks(V, score, slots, rel, w, reset, scratch, decay):
    """:func:`_state_step` over a table held in data-axis row blocks
    (``runtime/state.RowBlocks``): each block steps on its own device
    with one extra local scratch row, the records whose slot it does not
    hold (and the table's scratch slot) aimed at that row. A slot's
    records all fall in one block, in record order, so each block's rows
    and each record's derived features are the bytes the one-tensor step
    gives. → ``(derived[B, 8], V')`` with the derived features on the
    score's device."""
    from flink_jpmml_tpu_torch.runtime.state import RowBlocks

    out_dev = score.device if isinstance(score, torch.Tensor) else (
        V.blocks[0].device)
    slots_h = _as_tensor(slots, torch.long, torch.device("cpu"))
    derived = None
    blocks = []
    for (lo, hi), S in zip(V.bounds, V.blocks):
        dev = S.device
        own = (slots_h >= lo) & (slots_h < hi) & (slots_h != scratch)
        local = torch.where(own, slots_h - lo, hi - lo)
        Sx = torch.cat([S, torch.zeros((1, STATE_WIDTH), dtype=S.dtype,
                                       device=dev)])
        d_b, S2 = _state_step(Sx, score, local, rel, w, reset, hi - lo,
                              decay)
        blocks.append(S2[: hi - lo])
        d_b = d_b.to(out_dev)
        own_d = own.to(out_dev)[:, None]
        derived = d_b if derived is None else torch.where(own_d, d_b,
                                                          derived)
    return derived, RowBlocks(V.bounds, blocks)


def _score_of(out):
    """The scalar signal the state accumulates: the f32 value stream
    (classification outputs carry it as the triple's first element)."""
    return out[0] if isinstance(out, tuple) else out


def step_after(out, table, slots, rel, w, reset):
    """Queue the state step behind a dispatch's scoring output ``out`` (on
    the current stream) → ``(out, derived, S')``; the caller commits
    ``S'``. Every byte of ``out`` is what the stateless dispatch returns:
    the step only reads it."""
    table.wait_ready()
    step = (_state_step_blocks if hasattr(table.values, "blocks")
            else _state_step)
    derived, S2 = step(
        table.values, _score_of(out), slots, rel, w, reset, table.scratch,
        table.spec.decay)
    return out, derived, S2


def entry_for(q, kind: str):
    """The state-armed entry for one ``QuantizedScorer`` →
    ``fn(X, K, table, slots, rel, w, reset) → (out, derived, S')``:
    ``kind`` ``"wire"`` scores an aligned code batch
    (``predict_padded``), ``"fused"`` an aligned raw f32 batch through
    the device encode stage (``predict_fused_padded``); the state step
    follows on the same stream."""
    if kind == "fused":
        if not q.supports_fused:
            raise ModelCompilationException(
                "fused encode unavailable for this model; state dispatch "
                "needs the host-encode path")
        predict = q.predict_fused_padded
    elif kind == "wire":
        predict = q.predict_padded
    else:
        raise ValueError(f"state entry kind {kind!r}: 'wire' or 'fused'")

    def state_fn(X, K, table, slots, rel, w, reset):
        out = predict(X, K)
        with torch.no_grad():
            return step_after(out, table, slots, rel, w, reset)

    return state_fn


def packed_entry(pack, member: int = 0):
    """``PackedScorer`` twin: one packed dispatch scores all members and
    folds the designated ``member``'s value stream into the shared table
    → ``fn(Xp, table, slots, rel, w, reset) → (outs, derived, S')``, every
    member's output byte-identical to the stateless ``dispatch``."""

    def state_fn(Xp, table, slots, rel, w, reset):
        outs = pack.dispatch(Xp)
        with torch.no_grad():
            _, derived, S2 = step_after(
                outs[member], table, slots, rel, w, reset)
        return outs, derived, S2

    return state_fn


def renorm(S, mul, add):
    """Epoch renormalization: ``S · mul + add`` broadcast over rows (one
    rare O(capacity) column op — see KeyedStateTable.maybe_renorm)."""
    if hasattr(S, "blocks"):
        from flink_jpmml_tpu_torch.runtime.state import RowBlocks

        return RowBlocks(S.bounds, [renorm(b, mul, add) for b in S.blocks])
    mul = _as_tensor(mul, torch.float32, S.device)
    add = _as_tensor(add, torch.float32, S.device)
    return S * mul[None, :] + add[None, :]
