"""BayesianNetworkModel (discrete) → PyTorch: CPT-row matmuls in log space.

The port of ``flink_jpmml_tpu/compile/bayesnet.py``. Every non-target
node is an observed active field (enforced at parse), so the target
posterior is closed form over its Markov blanket:

    P(t = s | e) ∝ P(t = s | pa(t)) · Π_{c : t ∈ pa(c)} P(c_obs | pa(c), t = s)

Each factor is a CPT-row *match matmul*: for a factor with rows r over
observed parent configs, ``A[B, r] = Π_j [x_{p_j} = config_{r,j}]``; the
log-probability contribution is ``(A * logP) @ onehot(rows → target
states)``. The products are float32 ``torch.matmul`` with TF32 off
(``utils/device.py``), where the JAX package asks for
``Precision.HIGHEST``. Lanes where any observation is missing or unknown,
or where the matched rows do not cover every state exactly once, come out
invalid; a state whose true probability is zero decodes to exactly 0.

The CPT packing is the JAX package's numpy code, copied. Deliberate
differences: the observed child value is found by ``torch.argmax`` over
uint8 (torch refuses bools; the first maximum in both), the column
indices are device constants, and ``label_idx`` is int64.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import (
    DeviceConst,
    Lowered,
    LowerCtx,
    ModelOutput,
)
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

_TINY = 1e-30  # log(0) guard: exp(log(_TINY)) underflows to ~0 after norm


def lower_bayesian_network(
    model: ir.BayesianNetworkIR, ctx: LowerCtx
) -> Lowered:
    by_name = {n.name: n for n in model.nodes}
    tnode = by_name[model.target]
    S = len(tnode.values)
    tpos = {v: i for i, v in enumerate(tnode.values)}
    code = ctx.encode
    params: dict = {}

    # -- target's own CPT ---------------------------------------------------
    R = len(tnode.cpt)
    t_cols = DeviceConst([ctx.column(p) for p in tnode.parents], np.int64)
    t_cfg = np.zeros((R, max(len(tnode.parents), 1)), np.float32)
    t_logp = np.zeros((R, S), np.float32)
    t_pos = np.zeros((R, S), np.float32)
    for r, (config, probs) in enumerate(tnode.cpt):
        for j, v in enumerate(config):
            t_cfg[r, j] = code(tnode.parents[j], v)
        t_logp[r] = np.log(np.maximum(np.asarray(probs), _TINY))
        t_pos[r] = (np.asarray(probs) > 0).astype(np.float32)
    params["t_cfg"] = t_cfg
    params["t_logp"] = t_logp
    # exact positivity beside the clamped logs: a state whose TRUE
    # probability is zero decodes to exactly 0 (all-zero lanes invalid)
    params["t_pos"] = t_pos

    # -- children of the target --------------------------------------------
    children = []
    for child in model.nodes:
        if child.name == model.target or model.target not in child.parents:
            continue
        ti = child.parents.index(model.target)
        other = [p for j, p in enumerate(child.parents) if j != ti]
        Rc = len(child.cpt)
        cfg = np.zeros((Rc, max(len(other), 1)), np.float32)
        onehot = np.zeros((Rc, S), np.float32)
        logp = np.zeros((Rc, len(child.values)), np.float32)
        for r, (config, probs) in enumerate(child.cpt):
            tv = config[ti]
            if tv not in tpos:
                raise ModelCompilationException(
                    f"DiscreteNode {child.name!r}: ParentValue {tv!r} is "
                    f"not a state of target {model.target!r}"
                )
            onehot[r, tpos[tv]] = 1.0
            k = 0
            for j, v in enumerate(config):
                if j == ti:
                    continue
                cfg[r, k] = code(child.parents[j], v)
                k += 1
            logp[r] = np.log(np.maximum(np.asarray(probs), _TINY))
        key = f"c{len(children)}"
        params[f"{key}_cfg"] = cfg
        params[f"{key}_onehot"] = onehot
        params[f"{key}_logp"] = logp
        params[f"{key}_pos"] = np.asarray(
            [[pr > 0 for pr in probs] for _, probs in child.cpt], np.float32
        )
        params[f"{key}_vcodes"] = np.asarray(
            [code(child.name, v) for v in child.values], np.float32
        )
        children.append((
            key,
            ctx.column(child.name),
            DeviceConst([ctx.column(p) for p in other], np.int64),
        ))

    def row_match(p_cfg, X, M, cols):
        """[B, R] product of per-parent equality indicators (1 when the
        factor has no observed parents)."""
        n = cols.array.shape[0]
        if n == 0:
            return torch.ones((X.shape[0], p_cfg.shape[0]),
                              dtype=torch.float32, device=X.device)
        c = cols.on(X.device)
        eq = (X[:, c][:, None, :] == p_cfg[None, :, :n]) & ~M[:, c][:, None, :]
        return eq.all(dim=-1).to(torch.float32)

    def fn(p, X, M):
        A_t = row_match(p["t_cfg"], X, M, t_cols)  # [B, R]
        valid = A_t.sum(dim=1) == 1.0
        logp = torch.matmul(A_t, p["t_logp"])  # [B, S]
        pos = torch.matmul(A_t, p["t_pos"])  # [B, S]
        for key, ccol, ocols in children:
            A = row_match(p[f"{key}_cfg"], X, M, ocols)  # [B, Rc]
            onehot = p[f"{key}_onehot"]
            # exactly one matching row per target state
            valid = valid & (torch.matmul(A, onehot) == 1.0).all(dim=1)
            # observed child value → per-row log prob
            hit = (X[:, ccol][:, None] == p[f"{key}_vcodes"][None, :]) & ~M[
                :, ccol
            ][:, None]
            valid = valid & hit.any(dim=1)
            obs = torch.argmax(hit.to(torch.uint8), dim=1)  # [B]
            lp_obs = p[f"{key}_logp"].T[obs]  # [B, Rc]
            logp = logp + torch.matmul(A * lp_obs, onehot)
            pos_obs = p[f"{key}_pos"].T[obs]  # [B, Rc]
            pos = pos * torch.matmul(A * pos_obs, onehot)
        m = logp.max(dim=1, keepdim=True).values
        # exact zeros where any factor's true probability was zero
        e = torch.exp(logp - m) * pos
        total = e.sum(dim=1, keepdim=True)
        probs = e / torch.clamp(total, min=_TINY)
        valid = valid & (total[:, 0] > 0)
        lab = torch.argmax(probs, dim=1)
        value = probs.gather(1, lab[:, None])[:, 0]
        return ModelOutput(
            value=value, valid=valid, probs=probs, label_idx=lab
        )

    return Lowered(fn=fn, params=params, labels=tnode.values)
