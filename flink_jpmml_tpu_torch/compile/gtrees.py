"""General tree backend: first-match child scan with compound predicates.

The port of ``flink_jpmml_tpu/compile/gtrees.py``. The canonical backends
in trees.py require binary nodes whose two child predicates are (P,
complement-of-P) or (P, True). Real-world PMML also holds trees the
canonical form can't express: CompoundPredicate children (and / or / xor /
surrogate — R/rpart surrogate splits), n-ary nodes, non-complementary
predicates, isMissing / isNotMissing operators and non-True roots.

This backend vectorizes the oracle's traversal (interp._eval_tree): at each
node the children are scanned in order; the first TRUE predicate wins; an
UNKNOWN (missing-valued) predicate triggers the tree's
missingValueStrategy (none → keep scanning, defaultChild, lastPrediction,
nullPrediction); no match triggers noTrueChildStrategy. Predicates
evaluate in strong-Kleene three-valued logic.

The packers — ``_flatten_predicate``, ``_dnf_terms`` (with the
``_DNF_MAX_*`` guards), ``_Flat``, ``_bfs_rows`` and ``pack_general`` —
are the JAX package's numpy code, copied; ``_bfs_order`` is a copy of its
``compile/layouts.py bfs_order``. The evaluation (``_sub_pred_eval``,
``_combine``, ``make_general_eval``) is torch: a fixed ``depth + 1`` count
of hops, each gathering the C child slots' [K] sub-predicate rows per
(record, tree) lane. The tables keep the JAX dtypes (``pcol``,
``child_idx``, ``dchild``, ``rcol`` int32); the hop widens gathered
indices to int64. Index conventions that keep every gather in range: a
padded child slot points at its own node and holds ``_P_FALSE``; a
``dchild`` of −1 only ever nulls the lane, it is never followed; an
unmatched scan's ``chosen`` of −1 is clamped to 0 before its gather.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import LowerCtx
from flink_jpmml_tpu_torch.compile.trees import (
    _collect_labels,
    _leaf_class_row,
    _leaf_value,
    node_payload_fns,
    tree_offsets,
)
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

# sub-predicate opcodes (beyond trees.py's 0-5 comparison codes)
_P_LT, _P_LE, _P_GT, _P_GE, _P_EQ, _P_NE = 0, 1, 2, 3, 4, 5
_P_IN, _P_NOT_IN = 6, 7
_P_IS_MISSING, _P_IS_NOT_MISSING = 8, 9
_P_TRUE, _P_FALSE = 10, 11

_OPS = {
    "lessThan": _P_LT, "lessOrEqual": _P_LE, "greaterThan": _P_GT,
    "greaterOrEqual": _P_GE, "equal": _P_EQ, "notEqual": _P_NE,
    "isMissing": _P_IS_MISSING, "isNotMissing": _P_IS_NOT_MISSING,
}

# combiner codes. _C_DNF evaluates OR-over-AND-terms: each sub-predicate
# slot carries a term id, slots AND within their term (strong-Kleene),
# terms OR across — the normal form arbitrary nested and/or/xor compounds
# lower to (see _flatten_predicate).
_C_AND, _C_OR, _C_XOR, _C_SURROGATE, _C_DNF = 0, 1, 2, 3, 4

_STRATEGIES = {"none": 0, "defaultChild": 1, "lastPrediction": 2,
               "nullPrediction": 3}

# DNF expansion guards: a pathological deeply-xor-nested document could
# blow up exponentially; reject it loudly instead of compiling forever
_DNF_MAX_TERMS = 32
_DNF_MAX_LITERALS = 256

# sub-predicate tuple: (col, op, value, set_codes, negate, term_id)
_Sub = Tuple[int, int, float, Tuple[float, ...], bool, int]


class _NegWrap:
    def __init__(self, inner: ir.Predicate):
        self.inner = inner


def _flatten_predicate(
    pred: ir.Predicate, ctx: LowerCtx
) -> Tuple[int, List[_Sub]]:
    """predicate → (combiner, [(col, op, value, set_codes, neg, term)]).

    Simple predicates become a one-element AND. Single-level compounds
    keep their native combiner. Nested and/or/xor compounds lower to
    ``_C_DNF`` via exact strong-Kleene normal-form expansion; nested
    surrogates are rejected.
    """
    def leaf(p, negated: bool, term: int) -> _Sub:
        if isinstance(p, ir.TruePredicate):
            return (0, _P_FALSE if negated else _P_TRUE, 0.0, (), False,
                    term)
        if isinstance(p, ir.FalsePredicate):
            return (0, _P_TRUE if negated else _P_FALSE, 0.0, (), False,
                    term)
        if isinstance(p, ir.SimplePredicate):
            if p.operator not in _OPS:
                raise ModelCompilationException(
                    f"unsupported SimplePredicate operator {p.operator!r}"
                )
            op = _OPS[p.operator]
            if op in (_P_IS_MISSING, _P_IS_NOT_MISSING):
                if negated:  # ¬isMissing ≡ isNotMissing and vice versa
                    op = (
                        _P_IS_NOT_MISSING
                        if op == _P_IS_MISSING
                        else _P_IS_MISSING
                    )
                return ctx.column(p.field), op, 0.0, (), False, term
            return (
                ctx.column(p.field), op, ctx.encode(p.field, p.value), (),
                negated, term,
            )
        if isinstance(p, ir.SimpleSetPredicate):
            codes = tuple(ctx.encode(p.field, v) for v in p.values)
            is_in = (p.boolean_operator == "isIn") != negated
            op = _P_IN if is_in else _P_NOT_IN
            if not codes:
                # empty set: isIn {} ≡ false, isNotIn {} ≡ true
                return (0, _P_FALSE if is_in else _P_TRUE, 0.0, (), False,
                        term)
            return ctx.column(p.field), op, 0.0, codes, False, term
        raise ModelCompilationException(
            f"unsupported predicate {type(p).__name__} inside a compound"
        )

    if isinstance(pred, ir.CompoundPredicate):
        has_nested = any(
            isinstance(p, ir.CompoundPredicate) for p in pred.predicates
        )
        comb = {"and": _C_AND, "or": _C_OR, "xor": _C_XOR,
                "surrogate": _C_SURROGATE}.get(pred.boolean_operator)
        if comb is None:
            raise ModelCompilationException(
                f"unsupported CompoundPredicate {pred.boolean_operator!r}"
            )
        if not pred.predicates:
            raise ModelCompilationException("empty CompoundPredicate")
        if not has_nested:
            subs = [leaf(p, False, 0) for p in pred.predicates]
            return comb, subs
        if comb == _C_SURROGATE:
            raise ModelCompilationException(
                "surrogate CompoundPredicates with compound children "
                "have no vectorized lowering; restructure the document "
                "or use the oracle"
            )
        terms = _dnf_terms(pred)
        subs = []
        for tid, t in enumerate(terms):
            if not t:
                # an empty AND term is vacuously TRUE (whole DNF is TRUE)
                subs.append((0, _P_TRUE, 0.0, (), False, tid))
                continue
            for lit, negd in t:
                subs.append(leaf(lit, negd, tid))
        if len(subs) > _DNF_MAX_LITERALS:
            raise ModelCompilationException(
                f"nested CompoundPredicate expands past "
                f"{_DNF_MAX_LITERALS} literals; restructure the document "
                "or use the oracle"
            )
        if not subs:  # DNF with zero terms ≡ FALSE
            return _C_AND, [(0, _P_FALSE, 0.0, (), False, 0)]
        return _C_DNF, subs
    return _C_AND, [leaf(pred, False, 0)]


def _dnf_terms(pred: ir.Predicate):
    """DNF of a (possibly _NegWrap-containing) predicate tree."""

    def walk(p, neg: bool):
        if isinstance(p, _NegWrap):
            return walk(p.inner, not neg)
        if isinstance(p, ir.TruePredicate):
            return [] if neg else [[]]
        if isinstance(p, ir.FalsePredicate):
            return [[]] if neg else []
        if not isinstance(p, ir.CompoundPredicate):
            return [[(p, neg)]]
        op = p.boolean_operator
        kids = list(p.predicates)
        if not kids:
            raise ModelCompilationException("empty CompoundPredicate")
        if op == "surrogate":
            raise ModelCompilationException(
                "surrogate CompoundPredicates nested inside and/or/xor "
                "have no vectorized lowering (positional UNKNOWN "
                "filtering does not distribute); restructure the "
                "document or use the oracle"
            )
        if op == "xor":
            acc = kids[0]
            for k in kids[1:]:
                acc = ir.CompoundPredicate(
                    boolean_operator="or",
                    predicates=(
                        ir.CompoundPredicate(
                            boolean_operator="and",
                            predicates=(acc, _NegWrap(k)),
                        ),
                        ir.CompoundPredicate(
                            boolean_operator="and",
                            predicates=(_NegWrap(acc), k),
                        ),
                    ),
                )
            return walk(acc, neg)
        if op not in ("and", "or"):
            raise ModelCompilationException(
                f"unsupported CompoundPredicate {op!r}"
            )
        effective_and = (op == "and") != neg
        child_dnfs = [walk(k, neg) for k in kids]
        if effective_and:
            terms = [[]]
            for dnf in child_dnfs:
                terms = [a + b for a in terms for b in dnf]
                if len(terms) > _DNF_MAX_TERMS:
                    raise ModelCompilationException(
                        f"nested CompoundPredicate expands past "
                        f"{_DNF_MAX_TERMS} DNF terms; restructure the "
                        "document or use the oracle"
                    )
            return terms
        out = []
        for dnf in child_dnfs:
            out.extend(dnf)
        if len(out) > _DNF_MAX_TERMS:
            raise ModelCompilationException(
                f"nested CompoundPredicate expands past "
                f"{_DNF_MAX_TERMS} DNF terms; restructure the document "
                "or use the oracle"
            )
        return out

    return walk(pred, False)


class _Flat:
    """Per-tree node rows in pre-order (index 0 = root)."""

    def __init__(self) -> None:
        self.rows: List[dict] = []

    def add(self, node: ir.TreeNode, ctx: LowerCtx) -> int:
        idx = len(self.rows)
        row = {
            "score": node.score,
            "dist": node.score_distribution,
            "pred": _flatten_predicate(node.predicate, ctx),
            "children": [],
            "default": -1,
        }
        self.rows.append(row)
        child_ids = {}
        for ch in node.children:
            ci = self.add(ch, ctx)
            row["children"].append(ci)
            if ch.node_id is not None:
                child_ids[ch.node_id] = ci
        if node.default_child is not None:
            row["default"] = child_ids.get(node.default_child, -1)
        return idx


def _tree_depth(node: ir.TreeNode) -> int:
    if not node.children:
        return 0
    return 1 + max(_tree_depth(c) for c in node.children)


def _bfs_order(children: Sequence[Sequence[int]]) -> List[int]:
    """Breadth-first visit order over a node table (``children[i]`` =
    child indices of node ``i``; node 0 is the root). A copy of the JAX
    package's ``compile/layouts.py bfs_order``."""
    order: List[int] = []
    seen = [False] * len(children)
    queue = [0]
    seen[0] = True
    while queue:
        nxt: List[int] = []
        for i in queue:
            order.append(i)
            for c in children[i]:
                if not seen[c]:
                    seen[c] = True
                    nxt.append(c)
        queue = nxt
    # unreachable rows (impossible from the flattener, but a renumbering
    # must be a permutation regardless) go to the tail
    order.extend(i for i, s in enumerate(seen) if not s)
    return order


def _bfs_rows(rows: List[dict]) -> List[dict]:
    """Renumber a tree's node rows breadth-first (``_bfs_order``).

    The hop loop gathers rows by explicit ``child_idx`` indices, so any
    consistent renumbering is semantics-preserving; breadth-first keeps
    the root at 0 and makes hop ``d``'s gathers touch a contiguous
    low-index prefix of the [T, N, ...] tables instead of pre-order's
    leftmost-path scatter — the general backend's slice of the
    breadth-first SoA layout work (ROADMAP item 2)."""
    order = _bfs_order([r["children"] for r in rows])
    if order == list(range(len(rows))):
        return rows
    new_of_old = {old: new for new, old in enumerate(order)}
    out = []
    for old in order:
        r = dict(rows[old])
        r["children"] = [new_of_old[c] for c in r["children"]]
        if r["default"] >= 0:
            r["default"] = new_of_old[r["default"]]
        out.append(r)
    return out


def pack_general(
    trees: Sequence[ir.TreeModelIR], ctx: LowerCtx
) -> Tuple[Dict[str, np.ndarray], dict]:
    """→ (params, meta) node tables for the general scan backend."""
    classification = trees[0].function_name == "classification"
    flats: List[_Flat] = []
    depth = 1
    strat_codes: List[int] = []
    ntc_last: List[int] = []
    for t in trees:
        if (t.function_name == "classification") != classification:
            raise ModelCompilationException(
                "mixed regression/classification trees in one ensemble"
            )
        if t.missing_value_strategy not in _STRATEGIES:
            raise ModelCompilationException(
                f"unsupported missingValueStrategy "
                f"{t.missing_value_strategy!r}"
            )
        strat_codes.append(_STRATEGIES[t.missing_value_strategy])
        ntc_last.append(
            1 if t.no_true_child_strategy == "returnLastPrediction" else 0
        )
        fl = _Flat()
        fl.add(t.root, ctx)
        fl.rows = _bfs_rows(fl.rows)
        flats.append(fl)
        depth = max(depth, _tree_depth(t.root))

    T = len(flats)
    N = max(len(f.rows) for f in flats)
    C = max(
        (len(r["children"]) for f in flats for r in f.rows), default=1
    ) or 1
    K = max(len(r["pred"][1]) for f in flats for r in f.rows)
    KS = max(
        (len(s[3]) for f in flats for r in f.rows for s in r["pred"][1]),
        default=0,
    )

    pcol = np.zeros((T, N, C, K), np.int32)
    pop = np.full((T, N, C, K), float(_P_FALSE), np.float32)  # pad: never T
    pval = np.zeros((T, N, C, K), np.float32)
    pact = np.zeros((T, N, C, K), np.float32)
    pneg = np.zeros((T, N, C, K), np.float32)
    pterm = np.zeros((T, N, C, K), np.float32)
    # padded child slots must evaluate FALSE: an empty AND is vacuously
    # TRUE in the three-valued combiner, an empty OR is FALSE — pad with OR
    pcomb = np.full((T, N, C), float(_C_OR), np.float32)
    psets = (
        np.full((T, N, C, K, KS), np.nan, np.float32) if KS else None
    )
    child_idx = np.zeros((T, N, C), np.int32)
    dchild = np.full((T, N), -1, np.int32)
    is_leaf = np.ones((T, N), np.float32)
    scored = np.zeros((T, N), np.float32)
    # root predicate tables (evaluated once per record before the walk)
    rcomb = np.zeros((T,), np.float32)
    rcol = np.zeros((T, K), np.int32)
    rop = np.full((T, K), float(_P_FALSE), np.float32)
    rval = np.zeros((T, K), np.float32)
    ract = np.zeros((T, K), np.float32)
    rneg = np.zeros((T, K), np.float32)
    rterm = np.zeros((T, K), np.float32)
    rsets = np.full((T, K, KS), np.nan, np.float32) if KS else None

    labels: Tuple[str, ...] = ()
    if classification:
        labels = _collect_labels(
            (r["score"], r["dist"])
            for f in flats
            for r in f.rows
            if not r["children"] or r["score"] is not None or r["dist"]
        )
        Cn = len(labels)
        probs = np.zeros((T, N, Cn), np.float32)
        label = np.zeros((T, N), np.float32)
    else:
        value = np.zeros((T, N), np.float32)
        # a regression node can be "scored" (it stops a lastPrediction
        # halt, like the oracle's last_scored) via a distribution alone —
        # but its *value* is then null (interp._node_result returns None)
        valnull = np.zeros((T, N), np.float32)

    def fill_pred(
        comb_arr, col_a, op_a, val_a, act_a, neg_a, term_a, set_a, where,
        pred,
    ):
        comb, subs = pred
        comb_arr[where] = comb
        for k, (c_, o_, v_, s_, n_, t_) in enumerate(subs):
            col_a[where + (k,)] = c_
            op_a[where + (k,)] = o_
            val_a[where + (k,)] = v_
            act_a[where + (k,)] = 1.0
            neg_a[where + (k,)] = 1.0 if n_ else 0.0
            term_a[where + (k,)] = t_
            if s_ and set_a is not None:
                set_a[where + (k,)][: len(s_)] = s_

    for ti, fl in enumerate(flats):
        # root predicate
        fill_pred(
            rcomb, rcol, rop, rval, ract, rneg, rterm, rsets, (ti,),
            fl.rows[0]["pred"],
        )
        for ni, row in enumerate(fl.rows):
            children = row["children"]
            if children:
                is_leaf[ti, ni] = 0.0
            if len(children) > C:
                raise AssertionError  # C is the max by construction
            for c, ci in enumerate(children):
                child_idx[ti, ni, c] = ci
                fill_pred(
                    pcomb, pcol, pop, pval, pact, pneg, pterm, psets,
                    (ti, ni, c), fl.rows[ci]["pred"],
                )
            for c in range(len(children), C):
                child_idx[ti, ni, c] = ni  # self-loop, predicate stays FALSE
            dchild[ti, ni] = row["default"]
            has_payload = (
                not children
                or row["score"] is not None
                or bool(row["dist"])
            )
            if has_payload:
                scored[ti, ni] = 1.0
                where = f"{ni} in tree {ti}"
                if classification:
                    li, prow = _leaf_class_row(
                        row["score"], row["dist"], labels, where
                    )
                    label[ti, ni] = li
                    probs[ti, ni] = prow
                elif row["score"] is None and children:
                    valnull[ti, ni] = 1.0  # dist-only interior node
                else:
                    value[ti, ni] = _leaf_value(row["score"], where)

    params: Dict[str, np.ndarray] = {
        "pcol": pcol, "pop": pop, "pval": pval, "pact": pact,
        "pneg": pneg, "pterm": pterm,
        "pcomb": pcomb, "child_idx": child_idx, "dchild": dchild,
        "is_leaf": is_leaf, "scored": scored,
        "rcomb": rcomb, "rcol": rcol, "rop": rop, "rval": rval,
        "ract": ract, "rneg": rneg, "rterm": rterm,
        "strat": np.asarray(strat_codes, np.float32),
        "ntc_last": np.asarray(ntc_last, np.float32),
    }
    if psets is not None:
        params["psets"] = psets
        params["rsets"] = rsets
    if classification:
        params["probs"] = probs
        params["label"] = label
    else:
        params["value"] = value
        params["valnull"] = valnull
    meta = {
        "T": T, "N": N, "C": C, "K": K, "KS": KS, "depth": depth,
        "labels": labels, "classification": classification,
        # static: whether any node actually lowers to the DNF combiner —
        # when none does, the eval skips the O(K²) term-matrix entirely
        "has_dnf": bool(
            (pcomb == _C_DNF).any() or (rcomb == _C_DNF).any()
        ),
    }
    return params, meta


def _sub_pred_eval(x, m, op, val, member, neg=None):
    """One padded sub-predicate slot → (isT, isU) three-valued bools.

    ``x``/``m`` are the gathered feature value / missing mask, ``op`` the
    opcode lane, ``member`` the set-membership lane (or None); ``neg``
    applies strong-Kleene negation (T↔F, U fixed) — produced by the DNF
    lowering of nested compounds.
    """
    cmp = torch.where(
        op == _P_LT, x < val,
        torch.where(op == _P_LE, x <= val,
        torch.where(op == _P_GT, x > val,
        torch.where(op == _P_GE, x >= val,
        torch.where(op == _P_EQ, x == val, x != val)))),
    )
    if member is not None:
        cmp = torch.where(
            op == _P_IN, member,
            torch.where(op == _P_NOT_IN, ~member, cmp),
        )
    needs_value = op <= _P_NOT_IN  # comparison / set ops see UNKNOWN on missing
    isU = needs_value & m
    isT = torch.where(
        op == _P_TRUE, True,
        torch.where(op == _P_FALSE, False,
        torch.where(op == _P_IS_MISSING, m,
        torch.where(op == _P_IS_NOT_MISSING, ~m, cmp & ~m))),
    )
    if neg is not None:
        isT = torch.where(neg > 0.5, ~isT & ~isU, isT)
    return isT, isU


def _combine(comb, isT, isU, act, term=None):
    """PMML three-valued combiners over the K axis (last axis).

    ``isT``/``isU``/``act`` are [..., K]; returns ([...] isT, [...] isU).
    ``term`` carries the DNF term id per slot for the ``_C_DNF``
    combiner (OR over AND-terms — the lowering of nested compounds).
    """
    known = act > 0.5
    t = isT & known
    u = isU & known
    f = ~isT & ~isU & known
    anyT = t.any(dim=-1)
    anyF = f.any(dim=-1)
    anyU = u.any(dim=-1)
    and_T = ~anyF & ~anyU
    and_U = ~anyF & anyU
    or_T = anyT
    or_U = ~anyT & anyU
    parity = t.sum(dim=-1) % 2 == 1
    xor_T = ~anyU & parity
    xor_U = anyU
    # surrogate: first slot (in order) whose result is known wins
    K = isT.shape[-1]
    sur_T = torch.zeros(isT.shape[:-1], dtype=torch.bool, device=isT.device)
    resolved = torch.zeros_like(sur_T)
    for k in range(K):
        known_k = known[..., k] & ~u[..., k]
        sel = ~resolved & known_k
        sur_T = torch.where(sel, t[..., k], sur_T)
        resolved = resolved | known_k
    sur_U = ~resolved

    outT = torch.where(
        comb == _C_AND, and_T,
        torch.where(comb == _C_OR, or_T,
        torch.where(comb == _C_XOR, xor_T, sur_T)),
    )
    outU = torch.where(
        comb == _C_AND, and_U,
        torch.where(comb == _C_OR, or_U,
        torch.where(comb == _C_XOR, xor_U, sur_U)),
    )
    if term is not None:
        # DNF: strong-Kleene AND within each term id, OR across terms.
        # Padded slots drop out via `known`; an all-padding term id is
        # empty → F, which the OR ignores.
        tid = torch.arange(K, dtype=term.dtype, device=term.device)
        in_term = (term[..., :, None] == tid) & known[..., :, None]
        termF = (f[..., :, None] & in_term).any(dim=-2)  # [..., Kt]
        termU = (u[..., :, None] & in_term).any(dim=-2) & ~termF
        nonempty = in_term.any(dim=-2)
        termT = nonempty & ~termF & ~termU
        dnf_T = termT.any(dim=-1)
        dnf_U = ~dnf_T & termU.any(dim=-1)
        outT = torch.where(comb == _C_DNF, dnf_T, outT)
        outU = torch.where(comb == _C_DNF, dnf_U, outU)
    return outT, outU


def make_general_eval(params: Dict[str, np.ndarray], meta: dict):
    """→ fn(p, X, M) -> (final_idx i64[B,T], null bool[B,T]).

    Vectorized first-match scan per hop; mirrors interp._eval_tree
    (including last-scored tracking for lastPrediction /
    returnLastPrediction halts and the root-predicate gate).
    """
    T, N, C, K = meta["T"], meta["N"], meta["C"], meta["K"]
    depth = meta["depth"]
    has_sets = "psets" in params
    has_dnf = meta.get("has_dnf", True)

    def child_truth(p, X, M, g, c):
        """(isT, isU) of child c's predicate at nodes g [B,T]."""
        flatsz = T * N * C
        gc = g * C + c  # [B,T] flat (t,n,c) index given g is flat (t,n)
        col = p["pcol"].reshape(flatsz, K)[gc].long()  # [B,T,K]
        op = p["pop"].reshape(flatsz, K)[gc]
        val = p["pval"].reshape(flatsz, K)[gc]
        act = p["pact"].reshape(flatsz, K)[gc]
        neg = p["pneg"].reshape(flatsz, K)[gc]
        term = p["pterm"].reshape(flatsz, K)[gc] if has_dnf else None
        comb = p["pcomb"].reshape(flatsz)[gc]
        B = X.shape[0]
        x = torch.gather(X, 1, col.reshape(B, -1)).reshape(col.shape)
        m = torch.gather(M, 1, col.reshape(B, -1)).reshape(col.shape)
        member = None
        if has_sets:
            KS = p["psets"].shape[-1]
            sets = p["psets"].reshape(flatsz, K, KS)[gc]  # [B,T,K,KS]
            member = (x[..., None] == sets).any(dim=-1)
        isT, isU = _sub_pred_eval(x, m, op, val, member, neg)
        return _combine(comb, isT, isU, act, term)

    def root_truth(p, X, M):
        col = p["rcol"].reshape(-1).long()  # [T*K]
        B = X.shape[0]
        x = X[:, col].reshape(B, T, K)
        m = M[:, col].reshape(B, T, K)
        member = None
        if has_sets:
            member = (x[..., None] == p["rsets"][None]).any(dim=-1)
        isT, isU = _sub_pred_eval(
            x, m, p["rop"][None], p["rval"][None], member, p["rneg"][None]
        )
        return _combine(
            p["rcomb"][None], isT, isU, p["ract"][None],
            p["rterm"][None] if has_dnf else None,
        )

    def fn(p: dict, X: torch.Tensor, M: torch.Tensor):
        B = X.shape[0]
        dev = X.device
        offs = tree_offsets(T, N, dev)
        leaff = p["is_leaf"].reshape(-1) > 0.5
        scoredf = p["scored"].reshape(-1) > 0.5
        childf = p["child_idx"].reshape(-1).long()
        dchildf = p["dchild"].reshape(-1).long()
        strat = p["strat"][None, :]  # [1,T]
        ntc = p["ntc_last"][None, :] > 0.5

        rootT, _rootU = root_truth(p, X, M)
        null = ~rootT  # oracle: root predicate must be TRUE
        idx = torch.zeros((B, T), dtype=torch.int64, device=dev)
        settled = torch.zeros((B, T), dtype=torch.bool, device=dev)
        halted = torch.zeros_like(settled)
        last = torch.full((B, T), -1, dtype=torch.int64, device=dev)
        for _ in range(depth + 1):
            g = offs + idx
            live = ~settled
            last = torch.where(live & scoredf[g], idx, last)
            leaf = leaff[g]

            chosen = torch.full((B, T), -1, dtype=torch.int64, device=dev)
            done = torch.zeros((B, T), dtype=torch.bool, device=dev)
            actU = torch.zeros_like(done)
            for c in range(C):
                cT, cU = child_truth(p, X, M, g, c)
                hit = cT & ~done & ~actU
                chosen = torch.where(hit, c, chosen)
                done = done | hit
                # UNKNOWN halts the scan unless the strategy is 'none'
                actU = actU | (cU & ~done & ~actU & (strat != 0))
            no_match = ~done & ~actU

            # strategy actions on the first UNKNOWN
            use_default = actU & (strat == 1)
            d = dchildf[g]
            null_now = (
                (actU & (strat == 3))
                | (use_default & (d < 0))
                | (no_match & ~ntc)
            ) & ~leaf & live
            halt_now = (
                (actU & (strat == 2)) | (no_match & ntc)
            ) & ~leaf & live
            null = null | null_now
            halted = halted | halt_now
            settled = settled | leaf | null_now | halt_now

            # a lane that follows d has d >= 0 (d < 0 nulled and settled
            # it above); an unmatched scan's chosen −1 is clamped
            nxt_scan = childf[g * C + torch.clamp(chosen, min=0)]
            nxt = torch.where(use_default, d, nxt_scan)
            advance = ~settled & (done | use_default)
            idx = torch.where(advance, nxt, idx)
        null = null | (halted & (last < 0))
        idx = torch.where(halted & (last >= 0), last, idx)
        if "valnull" in p:
            # dist-only regression nodes: scored for halt tracking but
            # their value is null (oracle returns an empty result)
            null = null | (p["valnull"].reshape(-1)[offs + idx] > 0.5)
        return idx, null

    return fn


def general_tree_eval_fns(trees: Sequence[ir.TreeModelIR], ctx: LowerCtx):
    """Same contract as trees._tree_eval_fns, for non-canonical forests."""
    params, meta = pack_general(trees, ctx)
    ev = make_general_eval(params, meta)
    fn = node_payload_fns(
        ev, meta["T"], meta["N"], meta["classification"]
    )
    return fn, params, meta["labels"]
