"""TreeModel / tree ensembles → PyTorch: the path-matrix and node-hop
lowerings.

The port of ``flink_jpmml_tpu/compile/trees.py``. Canonicalization and
packing (``_canonicalize_forest``, ``pack_ensemble``, ``pack_nodes``,
``_canon_has_halt``) are the JAX package's numpy code, copied. The dense
backend is three contractions, as there:

1. **Split indicators**: gather each split's feature into ``x[B,T,S]``,
   compare against thresholds → ``go_left[B,T,S]`` (missing values follow
   the split's ``defaultChild`` direction, or poison the lane when the
   strategy demands a null prediction).
2. **Leaf matching**: each tree's topology is a path matrix
   ``P[T,S,L] ∈ {+1, −1, 0}`` with per-leaf edge counts ``c[T,L]``; a leaf
   is reached iff ``einsum('bts,tsl->btl', sign(go_left), P) == c``.
3. **Leaf values**: the one-hot leaf selection contracts with the leaf
   values (float32) or per-class distributions.

All three run in float32 with TF32 off (``utils/device.py``): the operands
of 1–2 are small integers, exact in float32, and 3 keeps float32 leaf
values exact.

Trees deeper than ``CompileConfig.max_dense_depth`` and trees with a
halting missing-value strategy (lastPrediction / returnLastPrediction) take
the iterative node-hop backend (``make_iterative_eval``): a fixed ``depth``
count of hops, each gathering the current node's attributes per (record,
tree) lane, as the JAX package's ``lax.fori_loop``. Its node tables keep
the JAX dtypes (``col``/``left``/``right`` int32); the hop widens the
gathered indices to int64, which torch's ``take``/``gather`` require.
Non-canonical forests take the general scan backend (``gtrees.py``) and
the fractional-membership strategies the weighted-path walk
(``wtrees.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import Lowered, LowerCtx, ModelOutput
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

# opcodes for canonical splits (static per model)
_OPS = {"lessThan": 0, "lessOrEqual": 1, "greaterThan": 2, "greaterOrEqual": 3,
        "equal": 4, "notEqual": 5}
_OP_IN = 6       # SimpleSetPredicate isIn   (categorical splits)
_OP_NOT_IN = 7   # SimpleSetPredicate isNotIn
_COMPLEMENT = {
    "lessThan": "greaterOrEqual",
    "lessOrEqual": "greaterThan",
    "greaterThan": "lessOrEqual",
    "greaterOrEqual": "lessThan",
    "equal": "notEqual",
    "notEqual": "equal",
}


@dataclass
class _CanonLeaf:
    score: Optional[str]
    distribution: Tuple[ir.ScoreDistribution, ...]


@dataclass
class _CanonSplit:
    col: int
    op: int  # opcode (_OPS values, _OP_IN, _OP_NOT_IN)
    value: float  # threshold (comparison splits; 0.0 for set splits)
    default_left: bool
    missing_null: bool  # True → a missing value here nulls the prediction
    left: "_CanonNode"
    right: "_CanonNode"
    set_values: Tuple[float, ...] = ()  # member codes (set splits only)
    # True → a missing value halts traversal and the tree returns the last
    # *scored* node on the path (lastPrediction / returnLastPrediction)
    halt: bool = False
    # this node's own payload (interior nodes may carry scores — they are
    # the candidates the halt path returns)
    node_score: Optional[str] = None
    node_dist: Tuple[ir.ScoreDistribution, ...] = ()


_CanonNode = object  # _CanonSplit | _CanonLeaf


class NonCanonicalTreeError(ModelCompilationException):
    """The forest's *shape* doesn't fit the canonical binary-split form
    (compound predicates, n-ary nodes, non-complementary children,
    non-True roots): it routes to the general scan backend (gtrees.py).
    Genuine model errors stay plain ModelCompilationExceptions."""


def _canonicalize(
    node: ir.TreeNode, model: ir.TreeModelIR, ctx: LowerCtx
) -> _CanonNode:
    """Reduce a PMML tree node to canonical binary form.

    Canonical: every internal node has exactly two children whose predicates
    are (P, complement-of-P) or (P, True) for a simple comparison P. This is
    the shape every mainstream GBM/CART exporter emits. Non-canonical trees
    raise with a clear message rather than silently misevaluating.
    """
    if node.is_leaf:
        return _CanonLeaf(score=node.score, distribution=node.score_distribution)
    if len(node.children) != 2:
        raise NonCanonicalTreeError(
            f"non-binary tree node (id={node.node_id!r}, "
            f"{len(node.children)} children) — only binary-split trees lower "
            "to the dense path"
        )
    c1, c2 = node.children
    p1, p2 = c1.predicate, c2.predicate

    split = _extract_split(p1, p2, ctx, node)
    if split is None:
        # degenerate: first child is catch-all → it always wins (first-match)
        if isinstance(p1, ir.TruePredicate):
            return _canonicalize(c1, model, ctx)
        raise NonCanonicalTreeError(
            f"tree node {node.node_id!r} children predicates "
            f"({type(p1).__name__}, {type(p2).__name__}) are not a canonical "
            "binary split"
        )
    col, op, value, set_values = split
    right_is_catch_all = isinstance(p2, ir.TruePredicate)

    strategy = model.missing_value_strategy
    halt = False
    if strategy == "defaultChild":
        if node.default_child is not None:
            default_left = node.default_child == c1.node_id
            if not default_left and node.default_child != c2.node_id:
                raise ModelCompilationException(
                    f"defaultChild {node.default_child!r} names no child of "
                    f"node {node.node_id!r}"
                )
            missing_null = False
        else:
            # no defaultChild attribute: a missing value nulls the prediction
            default_left, missing_null = True, True
    elif strategy == "lastPrediction":
        # missing → return the last scored node on the path (oracle
        # interp._eval_tree lastPrediction branch)
        default_left, missing_null, halt = True, False, True
    elif strategy == "none" and right_is_catch_all:
        # UNKNOWN left predicate → scan continues → the <True/> child matches
        default_left, missing_null = False, False
    elif strategy in ("none", "nullPrediction"):
        # both children UNKNOWN → no child matches → noTrueChildStrategy
        # decides: returnNullPrediction nulls, returnLastPrediction halts
        if (
            strategy == "none"
            and model.no_true_child_strategy == "returnLastPrediction"
        ):
            default_left, missing_null, halt = True, False, True
        else:
            default_left, missing_null = True, True
    else:
        raise ModelCompilationException(
            f"missingValueStrategy {strategy!r} has no vectorized lowering "
            "(supported: defaultChild, lastPrediction, none, nullPrediction)"
        )

    return _CanonSplit(
        col=col,
        op=op,
        value=value,
        default_left=default_left,
        missing_null=missing_null,
        left=_canonicalize(c1, model, ctx),
        right=_canonicalize(c2, model, ctx),
        set_values=set_values,
        halt=halt,
        node_score=node.score,
        node_dist=node.score_distribution,
    )


def _extract_split(
    p1: ir.Predicate, p2: ir.Predicate, ctx: LowerCtx, node: ir.TreeNode
) -> Optional[Tuple[int, int, float, Tuple[float, ...]]]:
    """(left pred, right pred) → (col, opcode, threshold, set_codes) or None."""
    if isinstance(p1, ir.SimplePredicate) and p1.operator in _OPS:
        col = ctx.column(p1.field)
        value = ctx.encode(p1.field, p1.value)
        if isinstance(p2, ir.TruePredicate):
            return col, _OPS[p1.operator], value, ()
        if (
            isinstance(p2, ir.SimplePredicate)
            and p2.field == p1.field
            and p2.operator == _COMPLEMENT[p1.operator]
            and p2.value == p1.value
        ):
            return col, _OPS[p1.operator], value, ()
    if isinstance(p1, ir.SimpleSetPredicate):
        col = ctx.column(p1.field)
        codes = tuple(ctx.encode(p1.field, v) for v in p1.values)
        op = _OP_IN if p1.boolean_operator == "isIn" else _OP_NOT_IN
        value = 0.0
        if not codes:
            # degenerate empty set: isIn {} ≡ always-false, isNotIn {} ≡
            # always-true — encode as a NaN comparison (x == NaN is never
            # true, x != NaN always is); missing-value handling is unchanged
            op = _OPS["equal"] if op == _OP_IN else _OPS["notEqual"]
            value = float("nan")
        complementary = (
            isinstance(p2, ir.SimpleSetPredicate)
            and p2.field == p1.field
            and frozenset(p2.values) == frozenset(p1.values)
            and p2.boolean_operator != p1.boolean_operator
        )
        if isinstance(p2, ir.TruePredicate) or complementary:
            return col, op, value, codes
    return None


# ---------------------------------------------------------------------------
# Packing: canonical trees → padded dense arrays
# ---------------------------------------------------------------------------


@dataclass
class _FlatTree:
    # per split
    cols: List[int] = dc_field(default_factory=list)
    ops: List[int] = dc_field(default_factory=list)
    values: List[float] = dc_field(default_factory=list)
    dleft: List[bool] = dc_field(default_factory=list)
    mnull: List[bool] = dc_field(default_factory=list)
    sets: List[Tuple[float, ...]] = dc_field(default_factory=list)
    # per leaf
    leaf_scores: List[Optional[str]] = dc_field(default_factory=list)
    leaf_dists: List[Tuple[ir.ScoreDistribution, ...]] = dc_field(
        default_factory=list
    )
    paths: List[List[Tuple[int, int]]] = dc_field(default_factory=list)
    # (split_idx, +1 left / −1 right) per edge on the leaf's path
    depth: int = 0


# -- shared leaf payload rules (both packers MUST agree on these) -----------


def _collect_labels(leaves) -> Tuple[str, ...]:
    """Ordered label space from (score, distribution) leaf pairs."""
    label_set: List[str] = []
    for score, dist in leaves:
        for d in dist:
            if d.value not in label_set:
                label_set.append(d.value)
        if score is not None and score not in label_set:
            label_set.append(score)
    return tuple(label_set)


def _leaf_class_row(
    score: Optional[str],
    dist: Tuple[ir.ScoreDistribution, ...],
    labels: Tuple[str, ...],
    where: str,
) -> Tuple[int, np.ndarray]:
    """→ (label index, dense per-class probability row).

    The label is the leaf's ``score`` attribute when present (PMML allows it
    to disagree with the distribution argmax); probabilities come from
    explicit ``probability`` attributes or record counts; a score-only leaf
    gets probability 1 on its label.
    """
    total = sum(d.record_count for d in dist)
    probs = {}
    for d in dist:
        if d.probability is not None:
            probs[d.value] = d.probability
        elif total > 0:
            probs[d.value] = d.record_count / total
    lab = score if score is not None else (
        max(probs, key=probs.get) if probs else None
    )
    if lab is None:
        raise ModelCompilationException(
            f"classification leaf {where} has neither score nor "
            "ScoreDistribution"
        )
    row = np.zeros((len(labels),), np.float32)
    for lbl, pr in probs.items():
        row[labels.index(lbl)] = pr
    if not probs:
        row[labels.index(lab)] = 1.0
    return labels.index(lab), row


def _leaf_value(score: Optional[str], where: str) -> float:
    if score is None:
        raise ModelCompilationException(f"regression leaf {where} has no score")
    try:
        return float(score)
    except ValueError:
        raise ModelCompilationException(
            f"regression leaf score {score!r} is not numeric"
        ) from None


def _flatten(node: _CanonNode, flat: _FlatTree, path: List[Tuple[int, int]]):
    if isinstance(node, _CanonLeaf):
        flat.leaf_scores.append(node.score)
        flat.leaf_dists.append(node.distribution)
        flat.paths.append(list(path))
        flat.depth = max(flat.depth, len(path))
        return
    s: _CanonSplit = node
    if s.halt:
        raise ModelCompilationException(
            "halting missing-value semantics (lastPrediction / "
            "returnLastPrediction) require the iterative backend"
        )
    idx = len(flat.cols)
    flat.cols.append(s.col)
    flat.ops.append(s.op)
    flat.values.append(s.value)
    flat.dleft.append(s.default_left)
    flat.mnull.append(s.missing_null)
    flat.sets.append(s.set_values)
    _flatten(s.left, flat, path + [(idx, +1)])
    _flatten(s.right, flat, path + [(idx, -1)])


@dataclass
class PackedEnsemble:
    """Padded dense arrays for T trees (static shape metadata + params)."""

    n_trees: int
    n_splits: int  # S (max, padded)
    n_leaves: int  # L (max, padded)
    depth: int
    opcodes: np.ndarray  # i8[T, S] — static (specializes comparisons)
    uniform_op: Optional[int]
    labels: Tuple[str, ...]  # classification class list ((),) for regression
    params: Dict[str, np.ndarray]
    # params: feat i32[T,S], thresh f32[T,S], dleft f32[T,S], mnull f32[T,S],
    #         P f32[T,S,L], count f32[T,L],
    #         leaf_values f32[T,L] (regression) or leaf_probs f32[T,L,C] and
    #         leaf_label i8/i32[T,L] (classification)


def _canonicalize_forest(
    trees: Sequence[ir.TreeModelIR], ctx: LowerCtx
) -> Tuple[List[_CanonNode], bool, int]:
    """Canonicalize + validate an ensemble ONCE → (canons, classification,
    depth). Both packers consume the canonical forest, so the recursive
    canonicalization cost is paid a single time on the 500-tree fast path."""
    classification = trees[0].function_name == "classification"
    canons: List[_CanonNode] = []
    depth = 1
    for t in trees:
        if (t.function_name == "classification") != classification:
            raise ModelCompilationException(
                "mixed regression/classification trees in one ensemble"
            )
        if not isinstance(t.root.predicate, ir.TruePredicate):
            raise NonCanonicalTreeError(
                "tree root predicate must be <True/> for the fused lowering"
            )
        canon = _canonicalize(t.root, t, ctx)
        canons.append(canon)
        depth = max(depth, _canon_depth(canon))
    return canons, classification, depth


def _canon_depth(canon: _CanonNode) -> int:
    if isinstance(canon, _CanonLeaf):
        return 0
    return 1 + max(_canon_depth(canon.left), _canon_depth(canon.right))


def _canon_has_halt(canon: _CanonNode) -> bool:
    if isinstance(canon, _CanonLeaf):
        return False
    return (
        canon.halt or _canon_has_halt(canon.left) or _canon_has_halt(canon.right)
    )


def pack_ensemble(
    canons: Sequence[_CanonNode], classification: bool
) -> PackedEnsemble:
    flats: List[_FlatTree] = []
    for canon in canons:
        flat = _FlatTree()
        _flatten(canon, flat, [])
        if not flat.cols:
            # single-leaf tree: manufacture a no-op split so S ≥ 1
            flat.cols, flat.ops, flat.values = [0], [0], [float("inf")]
            flat.dleft, flat.mnull, flat.sets = [True], [False], [()]
            flat.paths = [[(0, +1)], [(0, -1)]]
            flat.leaf_scores = flat.leaf_scores * 2
            flat.leaf_dists = flat.leaf_dists * 2
            flat.depth = 1
        flats.append(flat)

    T = len(flats)
    S = max(len(f.cols) for f in flats)
    L = max(len(f.leaf_scores) for f in flats)
    depth = max(f.depth for f in flats)

    feat = np.zeros((T, S), np.int32)
    ops = np.zeros((T, S), np.int8)
    thresh = np.zeros((T, S), np.float32)
    dleft = np.zeros((T, S), np.float32)
    mnull = np.zeros((T, S), np.float32)
    P = np.zeros((T, S, L), np.float32)
    count = np.full((T, L), -5.0, np.float32)  # padded leaves can never match
    K = max((len(s) for f in flats for s in f.sets), default=0)
    set_codes = (
        np.full((T, S, K), np.nan, np.float32) if K > 0 else None
    )  # NaN pad: never equal to any input

    labels: Tuple[str, ...] = ()
    if classification:
        labels = _collect_labels(
            (s, d)
            for f in flats
            for s, d in zip(f.leaf_scores, f.leaf_dists)
        )
        C = len(labels)
        leaf_probs = np.zeros((T, L, C), np.float32)
        leaf_label = np.zeros((T, L), np.int32)
    else:
        leaf_values = np.zeros((T, L), np.float32)

    for ti, f in enumerate(flats):
        ns = len(f.cols)
        feat[ti, :ns] = f.cols
        ops[ti, :ns] = f.ops
        thresh[ti, :ns] = f.values
        dleft[ti, :ns] = np.asarray(f.dleft, np.float32)
        mnull[ti, :ns] = np.asarray(f.mnull, np.float32)
        if set_codes is not None:
            for si, s in enumerate(f.sets):
                if s:
                    set_codes[ti, si, : len(s)] = s
        for li, path in enumerate(f.paths):
            count[ti, li] = len(path)
            for s_idx, direction in path:
                P[ti, s_idx, li] = direction
            score = f.leaf_scores[li]
            where = f"{li} in tree {ti}"
            if classification:
                lab_idx, row = _leaf_class_row(
                    score, f.leaf_dists[li], labels, where
                )
                leaf_label[ti, li] = lab_idx
                leaf_probs[ti, li] = row
            else:
                leaf_values[ti, li] = _leaf_value(score, where)

    # uniform-op specialization: padded split slots don't constrain it
    real_ops = {op for f in flats for op in f.ops}
    uniform_op = real_ops.pop() if len(real_ops) == 1 else None
    if uniform_op is not None:
        ops[:] = uniform_op

    params: Dict[str, np.ndarray] = {
        "feat": feat,
        "thresh": thresh,
        "dleft": dleft,
        "mnull": mnull,
        "P": P,
        "count": count,
    }
    if set_codes is not None:
        params["set_codes"] = set_codes
    if classification:
        params["leaf_probs"] = leaf_probs
        params["leaf_label"] = leaf_label.astype(np.float32)
    else:
        params["leaf_values"] = leaf_values

    return PackedEnsemble(
        n_trees=T,
        n_splits=S,
        n_leaves=L,
        depth=depth,
        opcodes=ops,
        uniform_op=int(uniform_op) if uniform_op is not None else None,
        labels=labels,
        params=params,
    )



# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def _compare(x, t, op_arr, uniform_op, member=None):
    """Split comparison dispatch: ``op_arr`` (int opcodes) broadcasts
    against ``x``; ``member`` is the set-membership lane for
    _OP_IN/_OP_NOT_IN splits (None when there are no set splits)."""
    if uniform_op is not None:
        op = uniform_op
        if op == _OP_IN:
            return member
        if op == _OP_NOT_IN:
            return ~member
        return (
            x < t if op == 0 else
            x <= t if op == 1 else
            x > t if op == 2 else
            x >= t if op == 3 else
            x == t if op == 4 else
            x != t
        )
    cmp = torch.where(
        op_arr == 0, x < t,
        torch.where(op_arr == 1, x <= t,
        torch.where(op_arr == 2, x > t,
        torch.where(op_arr == 3, x >= t,
        torch.where(op_arr == 4, x == t, x != t)))),
    )
    if member is not None:
        cmp = torch.where(
            op_arr == _OP_IN, member,
            torch.where(op_arr == _OP_NOT_IN, ~member, cmp),
        )
    return cmp


def make_ensemble_eval(packed: PackedEnsemble):
    """→ fn(params, X, M) -> (sel f32[B,T,L] one-hot, tree_null bool[B,T]).

    ``sel`` one-hot selects each tree's reached leaf; ``tree_null`` marks
    (record, tree) pairs whose selected path crossed a missing-nulled
    split."""
    opcodes = packed.opcodes
    uniform_op = packed.uniform_op

    def fn(p: dict, X: torch.Tensor, M: torch.Tensor):
        feat = p["feat"].long()  # [T, S]
        x = X[:, feat]  # [B, T, S]
        m = M[:, feat]
        member = None
        if "set_codes" in p:
            member = (x[..., None] == p["set_codes"][None]).any(dim=-1)
        op_arr = torch.from_numpy(opcodes).to(X.device)[None]
        cmp = _compare(x, p["thresh"][None], op_arr, uniform_op, member)
        go = torch.where(m, p["dleft"][None] > 0.5, cmp)
        nulled = m & (p["mnull"][None] > 0.5)
        sign = 2.0 * go.to(torch.float32) - 1.0
        Pm = p["P"]
        match = torch.einsum("bts,tsl->btl", sign, Pm)
        sel = (match == p["count"][None]).to(torch.float32)  # one-hot [B,T,L]
        # a nulled split on the selected path ⇒ the tree's result is null
        nullcnt = torch.einsum(
            "bts,tsl->btl", nulled.to(torch.float32), Pm.abs()
        )
        on_path_null = torch.einsum("btl,btl->bt", sel, nullcnt)
        return sel, on_path_null > 0.5

    return fn


# ---------------------------------------------------------------------------
# Iterative node-hop evaluation (deep and halting trees: O(depth) gathers
# instead of an O(S·L) path matrix)
# ---------------------------------------------------------------------------


@dataclass
class PackedNodes:
    """Node-table form: every tree's canonical nodes in one padded [T, N]
    family; leaves self-loop so a fixed ``depth`` iteration count converges."""

    n_trees: int
    n_nodes: int  # N (max, padded)
    depth: int
    uniform_op: Optional[int]
    has_sets: bool
    labels: Tuple[str, ...]
    params: Dict[str, np.ndarray]
    # params: col i32[T,N], op f32[T,N], thresh f32[T,N], dleft f32[T,N],
    #         mnull f32[T,N], left i32[T,N], right i32[T,N], is_leaf f32[T,N],
    #         halt f32[T,N], scored f32[T,N],
    #         value + valnull f32[T,N] | (probs f32[T,N,C] + label f32[T,N]),
    #         set_codes f32[T,N,K] (when set splits exist)


def _node_flatten(canon: _CanonNode, rows: List[dict]) -> int:
    """Pre-order flatten; returns this node's index."""
    idx = len(rows)
    rows.append({})  # reserve
    if isinstance(canon, _CanonLeaf):
        rows[idx] = {
            "leaf": True,
            "score": canon.score,
            "dist": canon.distribution,
            "left": idx,
            "right": idx,
        }
        return idx
    s: _CanonSplit = canon
    left = _node_flatten(s.left, rows)
    right = _node_flatten(s.right, rows)
    rows[idx] = {
        "leaf": False,
        "col": s.col,
        "op": s.op,
        "thresh": s.value,
        "dleft": s.default_left,
        "mnull": s.missing_null,
        "sets": s.set_values,
        "left": left,
        "right": right,
        "halt": s.halt,
        "score": s.node_score,
        "dist": s.node_dist,
    }
    return idx


def pack_nodes(
    canons: Sequence[_CanonNode], classification: bool, depth: int
) -> PackedNodes:
    per_tree_rows: List[List[dict]] = []
    for canon in canons:
        rows: List[dict] = []
        _node_flatten(canon, rows)
        per_tree_rows.append(rows)

    T = len(per_tree_rows)
    N = max(len(r) for r in per_tree_rows)
    K = max(
        (len(row.get("sets", ())) for rows in per_tree_rows for row in rows),
        default=0,
    )

    col = np.zeros((T, N), np.int32)
    op = np.zeros((T, N), np.float32)
    thresh = np.zeros((T, N), np.float32)
    dleft = np.zeros((T, N), np.float32)
    mnull = np.zeros((T, N), np.float32)
    halt = np.zeros((T, N), np.float32)
    scored = np.zeros((T, N), np.float32)  # node carries a payload
    # padding rows are self-looping leaves; real rows are overwritten below
    left = np.broadcast_to(np.arange(N, dtype=np.int32), (T, N)).copy()
    right = left.copy()
    is_leaf = np.ones((T, N), np.float32)
    set_codes = np.full((T, N, K), np.nan, np.float32) if K else None

    labels: Tuple[str, ...] = ()
    if classification:
        labels = _collect_labels(
            (row["score"], row["dist"])
            for rows in per_tree_rows
            for row in rows
            if row["leaf"] or row["score"] is not None or row["dist"]
        )
        C = len(labels)
        probs = np.zeros((T, N, C), np.float32)
        label = np.zeros((T, N), np.float32)
    else:
        value = np.zeros((T, N), np.float32)
        # dist-only regression interiors count as "scored" for halt
        # tracking (oracle last_scored) but their value is null
        valnull = np.zeros((T, N), np.float32)

    ops_seen = set()
    for ti, rows in enumerate(per_tree_rows):
        for ni, row in enumerate(rows):
            left[ti, ni] = row["left"]
            right[ti, ni] = row["right"]
            has_payload = (
                row["leaf"]
                or row["score"] is not None
                or bool(row["dist"])
            )
            if has_payload:
                scored[ti, ni] = 1.0
                where = f"{ni} in tree {ti}"
                if classification:
                    lab_idx, prow = _leaf_class_row(
                        row["score"], row["dist"], labels, where
                    )
                    label[ti, ni] = lab_idx
                    probs[ti, ni] = prow
                elif row["score"] is None and not row["leaf"]:
                    valnull[ti, ni] = 1.0  # dist-only interior node
                else:
                    value[ti, ni] = _leaf_value(row["score"], where)
            if not row["leaf"]:
                is_leaf[ti, ni] = 0.0
                col[ti, ni] = row["col"]
                op[ti, ni] = row["op"]
                thresh[ti, ni] = row["thresh"]
                dleft[ti, ni] = float(row["dleft"])
                mnull[ti, ni] = float(row["mnull"])
                if row["halt"]:
                    halt[ti, ni] = 1.0
                ops_seen.add(row["op"])
                if set_codes is not None and row["sets"]:
                    set_codes[ti, ni, : len(row["sets"])] = row["sets"]

    uniform_op = ops_seen.pop() if len(ops_seen) == 1 else None
    params: Dict[str, np.ndarray] = {
        "col": col,
        "op": op,
        "thresh": thresh,
        "dleft": dleft,
        "mnull": mnull,
        "left": left,
        "right": right,
        "is_leaf": is_leaf,
        "halt": halt,
        "scored": scored,
    }
    if set_codes is not None:
        params["set_codes"] = set_codes
    if classification:
        params["probs"] = probs
        params["label"] = label
    else:
        params["value"] = value
        params["valnull"] = valnull
    return PackedNodes(
        n_trees=T,
        n_nodes=N,
        depth=depth,
        uniform_op=uniform_op,
        has_sets=set_codes is not None,
        labels=labels,
        params=params,
    )


def tree_offsets(T: int, N: int, device: torch.device) -> torch.Tensor:
    """i64[1, T]: the flat index of each tree's row 0 in a [T*N] table."""
    return (torch.arange(T, dtype=torch.int64, device=device) * N)[None, :]


def make_iterative_eval(packed: PackedNodes):
    """→ tree_eval(params, X, M) -> (final_idx i64[B,T], null bool[B,T]).

    A fixed ``depth`` count of hops (no data-dependent exit: a host test
    of "every lane settled" would wait on the card each hop); every hop
    gathers the current node's attributes per (record, tree) and moves
    left or right. Leaves and padding rows self-loop, so every index fed
    to a gather stays inside the tree's rows.

    Halting strategies (lastPrediction / noTrueChildStrategy
    returnLastPrediction) latch a ``stopped`` mask and track the node index
    of the last *scored* ancestor (``last``, −1 until one is seen, never
    used as an index); a stopped lane's final index is that ancestor (or
    null when no ancestor ever carried a score) — the oracle's
    ``last_scored`` bookkeeping in interp._eval_tree.
    """
    T, N, depth = packed.n_trees, packed.n_nodes, packed.depth
    uniform_op = packed.uniform_op
    has_sets = packed.has_sets
    any_halt = bool(packed.params["halt"].any())

    def fn(p: dict, X: torch.Tensor, M: torch.Tensor):
        B = X.shape[0]
        offs = tree_offsets(T, N, X.device)
        colf = p["col"].reshape(-1).long()
        opf = p["op"].reshape(-1)
        threshf = p["thresh"].reshape(-1)
        dleftf = p["dleft"].reshape(-1) > 0.5
        mnullf = p["mnull"].reshape(-1) > 0.5
        leftf = p["left"].reshape(-1).long()
        rightf = p["right"].reshape(-1).long()
        leaff = p["is_leaf"].reshape(-1) > 0.5
        haltf = p["halt"].reshape(-1) > 0.5
        scoredf = p["scored"].reshape(-1) > 0.5
        setf = p["set_codes"].reshape(T * N, -1) if has_sets else None

        idx = torch.zeros((B, T), dtype=torch.int64, device=X.device)
        null = torch.zeros((B, T), dtype=torch.bool, device=X.device)
        stopped = torch.zeros_like(null)
        last = torch.full((B, T), -1, dtype=torch.int64, device=X.device)
        for _ in range(depth):
            g = offs + idx  # [B, T] flat node ids
            # the current node's own payload counts as "last scored" for
            # a halt at its split (oracle updates last_scored on arrival)
            if any_halt:
                last = torch.where(~stopped & scoredf[g], idx, last)
            cols = colf[g]
            x = torch.gather(X, 1, cols)
            m = torch.gather(M, 1, cols)
            member = (
                (x[..., None] == setf[g]).any(dim=-1) if has_sets else None
            )
            # one opcode for the whole forest: no per-lane opcode gather
            opg = opf[g] if uniform_op is None else None
            cmp = _compare(x, threshf[g], opg, uniform_op, member)
            go = torch.where(m, dleftf[g], cmp)
            leaf = leaff[g]
            null = null | (m & mnullf[g] & ~leaf)
            settled = leaf
            if any_halt:
                stopped = stopped | (m & haltf[g] & ~leaf)
                settled = leaf | stopped
            nxt = torch.where(go, leftf[g], rightf[g])
            idx = torch.where(settled, idx, nxt)
        if any_halt:
            null = null | (stopped & (last < 0))
            idx = torch.where(stopped & (last >= 0), last, idx)
            if "valnull" in p:
                null = null | (p["valnull"].reshape(-1)[offs + idx] > 0.5)
        return idx, null

    return fn


def node_payload_fns(ev, T: int, N: int, classification: bool):
    """Final payload gather shared by every node-table backend (the
    canonical iterative hop and the general scan in gtrees.py): map the
    per-lane final node index to its value / (probs, label)."""
    if not classification:
        def vals(p, X, M):
            idx, null = ev(p, X, M)
            g = tree_offsets(T, N, X.device) + idx
            return p["value"].reshape(-1)[g], null
        return vals

    def cls(p, X, M):
        idx, null = ev(p, X, M)
        g = tree_offsets(T, N, X.device) + idx
        C = p["probs"].shape[-1]
        probs = p["probs"].reshape(T * N, C)[g]
        lab = torch.round(p["label"].reshape(-1)[g]).long()
        return probs, lab, null
    return cls


def _tree_eval_fns(trees, ctx):
    """Choose the dense (path-matrix einsum), iterative (node-hop) or
    general (first-match scan) backend and return a uniform per-tree
    interface:

    regression:      vals(p, X, M)  -> (values f32[B,T], null bool[B,T])
    classification:  cls(p, X, M)   -> (probs f32[B,T,C], label i64[B,T],
                                        null bool[B,T])
    plus (params, labels)."""
    try:
        canons, classification, depth = _canonicalize_forest(trees, ctx)
    except NonCanonicalTreeError:
        # compound predicates, n-ary nodes, non-complementary children,
        # non-True roots, isMissing operators: the general scan
        from flink_jpmml_tpu_torch.compile.gtrees import general_tree_eval_fns

        return general_tree_eval_fns(trees, ctx)
    dense = depth <= ctx.config.max_dense_depth and not any(
        _canon_has_halt(c) for c in canons
    )
    if not dense:
        packed = pack_nodes(canons, classification, depth)
        ev = make_iterative_eval(packed)
        fn = node_payload_fns(
            ev, packed.n_trees, packed.n_nodes, classification
        )
        return fn, packed.params, packed.labels

    packed = pack_ensemble(canons, classification)
    ev = make_ensemble_eval(packed)
    if not classification:
        def vals(p, X, M):
            sel, null = ev(p, X, M)
            return torch.einsum("btl,tl->bt", sel, p["leaf_values"]), null
        return vals, packed.params, ()

    def cls(p, X, M):
        sel, null = ev(p, X, M)
        probs = torch.einsum("btl,tlc->btc", sel, p["leaf_probs"])
        lab = torch.einsum("btl,tl->bt", sel, p["leaf_label"])
        return probs, torch.round(lab).long(), null
    return cls, packed.params, packed.labels


def median_lastdim(v: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, averaging the two middle values of an
    even count (``jnp.median``'s convention; ``torch.median`` returns the
    lower one)."""
    n = v.shape[-1]
    s = torch.sort(v, dim=-1).values
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def lower_tree_ensemble(
    trees: Sequence[ir.TreeModelIR],
    weights: Sequence[float],
    method: str,
    ctx: LowerCtx,
) -> Lowered:
    """Fused lowering for an ensemble of trees under one segmentation
    method (the 500-tree GBM). ``method`` ∈ {sum, average, weightedAverage,
    max, median} for regression, {majorityVote, weightedMajorityVote} for
    classification — or 'single' for a lone TreeModel. Deep, halting and
    non-canonical forests take the node-hop and general backends."""
    w = np.asarray(weights, np.float32)
    w_sum = float(np.float32(w.sum()))
    classification = trees[0].function_name == "classification"
    eval_fn, params, labels = _tree_eval_fns(trees, ctx)

    if not classification:
        if method not in (
            "sum", "single", "average", "weightedAverage", "max", "median"
        ):
            raise ModelCompilationException(
                f"unsupported regression ensemble method {method!r}"
            )

        def rfn(p, X, M):
            per_tree, tree_null = eval_fn(p, X, M)
            valid = ~tree_null.any(dim=1)
            if method in ("sum", "single"):
                value = per_tree.sum(dim=1)
            elif method == "average":
                value = per_tree.mean(dim=1)
            elif method == "weightedAverage":
                wt = torch.from_numpy(w).to(per_tree.device)
                value = (per_tree @ wt) / w_sum
            elif method == "max":
                value = per_tree.max(dim=1).values
            else:
                value = median_lastdim(per_tree)
            return ModelOutput(value=value, valid=valid)

        return Lowered(fn=rfn, params=params)

    C = len(labels)
    if method not in ("single", "majorityVote", "weightedMajorityVote"):
        raise ModelCompilationException(
            f"classification ensemble method {method!r} has no fused lowering"
        )

    def cfn(p, X, M):
        tprobs, tlabel, tree_null = eval_fn(p, X, M)
        if method == "single":
            probs = tprobs[:, 0, :]
            valid = ~tree_null[:, 0]
            # the label comes from the leaf's 'score' attribute, NOT argmax
            # of the distribution — PMML allows them to disagree
            label_idx = tlabel[:, 0]
            value = torch.gather(probs, 1, label_idx[:, None])[:, 0]
            return ModelOutput(
                value=value, valid=valid, probs=probs, label_idx=label_idx
            )
        # each tree votes its leaf's label one-hot (weighted); a tree
        # nulled by a missing value abstains, it does not poison the lane
        votes = torch.nn.functional.one_hot(tlabel, C).to(torch.float32)
        votes = votes * (~tree_null).to(torch.float32)[:, :, None]
        if method == "weightedMajorityVote":
            votes = votes * torch.from_numpy(w).to(votes.device)[None, :, None]
        total = votes.sum(dim=(1, 2))
        probs = votes.sum(dim=1) / torch.clamp(total[:, None], min=1e-30)
        valid = total > 0
        label_idx = torch.argmax(probs, dim=1)
        value = torch.gather(probs, 1, label_idx[:, None])[:, 0]
        return ModelOutput(
            value=value, valid=valid, probs=probs, label_idx=label_idx
        )

    return Lowered(fn=cfn, params=params, labels=labels)


def lower_tree(model: ir.TreeModelIR, ctx: LowerCtx) -> Lowered:
    """A standalone TreeModel is an ensemble of one — except the
    fractional-membership strategies, whose weighted-path walk lives in
    wtrees.py (boolean path matrices cannot express them)."""
    if model.missing_value_strategy in (
        "weightedConfidence", "aggregateNodes"
    ):
        from flink_jpmml_tpu_torch.compile.wtrees import lower_weighted_tree

        return lower_weighted_tree(model, ctx)
    return lower_tree_ensemble([model], [1.0], "single", ctx)
