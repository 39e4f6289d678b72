"""NeuralNetwork → PyTorch: a dense matmul chain (BASELINE config 3).

The port of ``flink_jpmml_tpu/compile/neural.py``. PMML expresses networks
as per-neuron ``<Con>`` lists; they are reassembled into layer weight
matrices ``W[in, out]`` + bias ``b[out]`` so the whole layer is one
``torch.matmul`` (float32, TF32 off: ``utils/device.py``). Connections must
be strictly layered (every ``Con`` references the immediately previous
layer); skip connections raise at compile time. A radial-basis layer keeps
the JAX package's expansion of Σ (w − h)² into two matmuls.

Missing semantics (matching the JAX package): any missing network input
makes the whole record's result missing.

Deliberate differences: ``label_idx`` is int64; the radial-basis constants
and output columns are device constants beside the function
(``common.DeviceConst``), as the JAX package closes over them; and when
every input is a plain ``FieldRef`` (the exporters' usual MLP) the inputs
are one column gather, not one expression each: the JAX package's
per-input expressions fuse under XLA, but in eager torch they would be
about three kernel launches an input (2,350 for BASELINE config 3's 784
inputs), issued from the dispatching thread.

On a mesh with a model axis (``parallel/sharding.mesh_sharded``) a layer
whose input width reaches the wide threshold holds ``W`` as a
``common.TpLeaf``: the layer's product, and a radial-basis layer's
expansion, become one partial a slice of the inputs, added in slice order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import (
    DeviceConst,
    Lowered,
    LowerCtx,
    ModelOutput,
    TpLeaf,
    tp_matmul,
)
from flink_jpmml_tpu_torch.compile.exprs import lower_expression
from flink_jpmml_tpu_torch.compile.regression import softmax
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.exceptions import ModelCompilationException

_ACTIVATIONS = {
    "logistic": lambda z: 1.0 / (1.0 + torch.exp(-z)),
    "tanh": torch.tanh,
    "identity": lambda z: z,
    "rectifier": lambda z: torch.clamp(z, min=0.0),
    # PMML 4.x defines arctan as 2*arctan(Z)/pi (range (-1, 1))
    "arctan": lambda z: 2.0 * torch.atan(z) / np.pi,
    "cosine": torch.cos,
    "sine": torch.sin,
    "square": lambda z: z * z,
    "Gauss": lambda z: torch.exp(-(z * z)),
    "reciprocal": lambda z: 1.0 / z,
    "exponential": torch.exp,
    "Elliott": lambda z: z / (1.0 + torch.abs(z)),
    "elliott": lambda z: z / (1.0 + torch.abs(z)),  # lenient-case alias
}


def _resolve(neuron_v, layer_v, model_v):
    """Neuron → Layer → Network attribute resolution."""
    if neuron_v is not None:
        return neuron_v
    return layer_v if layer_v is not None else model_v


def _rbf_z(h, W, conn):
    """z_j = Σ_i conn_ij (w_ij − h_i)², expanded into matmuls:
    colsum(conn·W²) − 2 h@(conn·W) + h²@conn."""
    cw = conn * W
    return (
        (cw * W).sum(dim=0)[None, :]
        - 2.0 * torch.matmul(h, cw)
        + torch.matmul(h * h, conn)
    )


def _rbf_spec(layer, model, prev_ids) -> dict:
    """RBF neuron: the Con weights are the center; per the spec
        z_j = Σ_i (w_ij − x_i)²
        out = exp(fanIn_j · ln(altitude_j) − z_j / (2·width_j²))
    width resolves Neuron → Layer → Network (required), altitude likewise
    (default 1.0); bias is unused."""
    n = len(layer.neurons)
    widths = np.zeros((n,), np.float32)
    alts = np.zeros((n,), np.float32)
    fanin = np.zeros((n,), np.float32)
    conn = np.zeros((len(prev_ids), n), np.float32)
    index = {nid: i for i, nid in enumerate(prev_ids)}
    for j, neuron in enumerate(layer.neurons):
        w = _resolve(neuron.width, layer.width, model.width)
        if w is None or w <= 0:
            raise ModelCompilationException(
                f"radialBasis neuron {neuron.neuron_id!r} has no "
                "positive width (Neuron/NeuralLayer/NeuralNetwork)"
            )
        widths[j] = w
        a = _resolve(neuron.altitude, layer.altitude, model.altitude)
        if a <= 0:
            raise ModelCompilationException(
                f"radialBasis neuron {neuron.neuron_id!r} has "
                f"non-positive altitude {a}"
            )
        alts[j] = a
        fanin[j] = len(neuron.weights)
        for src, _w in neuron.weights:
            conn[index[src], j] = 1.0
    return {
        "kind": "rbf",
        # fanIn · ln(altitude) in float32, as the JAX package forms it
        "log_term": DeviceConst(fanin * np.log(alts).astype(np.float32)),
        "two_w2": DeviceConst(2.0 * widths * widths),
        "conn": DeviceConst(conn),
    }


def _lower_inputs(model: ir.NeuralNetworkIR, ctx: LowerCtx):
    """→ fn(X, M) -> (h [B, I], missing [B]). Inputs that are all plain
    field references are one column gather; otherwise each input
    expression is evaluated and stacked."""
    exprs = [ni.derived_field.expression for ni in model.inputs]
    if all(isinstance(e, ir.FieldRef) for e in exprs):
        cols = DeviceConst([ctx.column(e.field) for e in exprs], np.int64)

        def gather(X, M):
            c = cols.on(X.device)
            return X[:, c], M[:, c].any(dim=1)

        return gather
    input_fns = [lower_expression(e, ctx) for e in exprs]

    def evaluate(X, M):
        vals, misses = zip(*(f(X, M) for f in input_fns))
        missing = misses[0]
        for m2 in misses[1:]:
            missing = missing | m2
        return torch.stack(vals, dim=1), missing

    return evaluate


def lower_neural_network(model: ir.NeuralNetworkIR, ctx: LowerCtx) -> Lowered:
    inputs = _lower_inputs(model, ctx)
    prev_ids = [ni.neuron_id for ni in model.inputs]

    layer_weights = []
    layer_acts = []
    layer_norms = []
    for li, layer in enumerate(model.layers):
        index = {nid: i for i, nid in enumerate(prev_ids)}
        W = np.zeros((len(prev_ids), len(layer.neurons)), np.float32)
        b = np.zeros((len(layer.neurons),), np.float32)
        for j, neuron in enumerate(layer.neurons):
            b[j] = neuron.bias
            for src, w in neuron.weights:
                if src not in index:
                    raise ModelCompilationException(
                        f"neuron {neuron.neuron_id!r} in layer {li} references "
                        f"{src!r} which is not in the previous layer — only "
                        "strictly layered networks lower to the matmul chain"
                    )
                W[index[src], j] = w
        act_name = layer.activation or model.activation_function
        act_spec: dict = {"kind": "plain", "name": act_name}
        if act_name == "threshold":
            # out = 1 if z > threshold else 0 (cut from layer, else model)
            thr = (
                layer.threshold
                if layer.threshold is not None
                else model.threshold
            )
            act_spec = {"kind": "threshold", "thr": float(thr)}
        elif act_name == "radialBasis":
            act_spec = _rbf_spec(layer, model, prev_ids)
        elif act_name not in _ACTIVATIONS:
            raise ModelCompilationException(
                f"unsupported activation {act_name!r}"
            )
        is_last = li == len(model.layers) - 1
        norm = layer.normalization or (
            model.normalization_method if is_last else "none"
        )
        if norm not in ("none", "softmax", "simplemax"):
            raise ModelCompilationException(
                f"unsupported layer normalization {norm!r}"
            )
        layer_weights.append((W, b))
        layer_acts.append(act_spec)
        layer_norms.append(norm)
        prev_ids = [n.neuron_id for n in layer.neurons]

    out_index = {nid: i for i, nid in enumerate(prev_ids)}
    params = {
        f"l{i}": {"W": W, "b": b} for i, (W, b) in enumerate(layer_weights)
    }

    def run_network(p, X, M) -> Tuple[torch.Tensor, torch.Tensor]:
        h, missing = inputs(X, M)  # [B, I], [B]
        for i, spec in enumerate(layer_acts):
            lp = p[f"l{i}"]
            if spec["kind"] == "rbf":
                W_, conn = lp["W"], spec["conn"].on(h.device)
                if isinstance(W_, TpLeaf):
                    z = W_.partial_sum(
                        lambda lo, hi, w: _rbf_z(
                            h[:, lo:hi].to(w.device), w,
                            conn[lo:hi].to(w.device)),
                        h.device)
                else:
                    z = _rbf_z(h, W_, conn)
                h = torch.exp(
                    spec["log_term"].on(h.device) - z / spec["two_w2"].on(h.device)
                )
            else:
                z = tp_matmul(h, lp["W"]) + lp["b"]
                if spec["kind"] == "threshold":
                    h = (z > spec["thr"]).to(torch.float32)
                else:
                    h = _ACTIVATIONS[spec["name"]](z)
            if layer_norms[i] == "softmax":
                h = softmax(h)
            elif layer_norms[i] == "simplemax":
                s = h.sum(dim=1, keepdim=True)
                h = torch.where(s == 0, h, h / s)
        return h, missing

    if model.function_name == "classification":
        labels = []
        out_cols = []
        for no in model.outputs:
            expr = no.derived_field.expression
            if not isinstance(expr, ir.NormDiscrete):
                raise ModelCompilationException(
                    "classification NeuralOutput must map via NormDiscrete"
                )
            labels.append(expr.value)
            if no.output_neuron not in out_index:
                raise ModelCompilationException(
                    f"NeuralOutput references unknown neuron "
                    f"{no.output_neuron!r}"
                )
            out_cols.append(out_index[no.output_neuron])
        cols = DeviceConst(np.asarray(out_cols, np.int64))

        def cfn(p, X, M):
            h, missing = run_network(p, X, M)
            probs = h[:, cols.on(h.device)]
            label_idx = torch.argmax(probs, dim=1)
            value = torch.gather(probs, 1, label_idx[:, None])[:, 0]
            return ModelOutput(
                value=value, valid=~missing, probs=probs, label_idx=label_idx
            )

        return Lowered(fn=cfn, params=params, labels=tuple(labels))

    if not model.outputs:
        raise ModelCompilationException("regression NeuralNetwork has no outputs")
    no = model.outputs[0]
    if no.output_neuron not in out_index:
        raise ModelCompilationException(
            f"NeuralOutput references unknown neuron {no.output_neuron!r}"
        )
    out_col = out_index[no.output_neuron]
    expr = no.derived_field.expression
    if isinstance(expr, ir.NormContinuous):
        if len(expr.norms) != 2:
            raise ModelCompilationException(
                "regression NeuralOutput NormContinuous supports exactly two "
                "LinearNorm points in the lowering (n-point: oracle only)"
            )
        a, b2 = expr.norms
        slope = np.float32((b2.orig - a.orig) / (b2.norm - a.norm))
        denorm = (float(np.float32(a.orig)), float(np.float32(a.norm)),
                  float(slope))
    elif isinstance(expr, ir.FieldRef):
        denorm = None
    else:
        raise ModelCompilationException(
            f"unsupported NeuralOutput expression {type(expr).__name__}"
        )

    def rfn(p, X, M):
        h, missing = run_network(p, X, M)
        y = h[:, out_col]
        if denorm is not None:
            orig0, norm0, slope_ = denorm
            y = orig0 + (y - norm0) * slope_
        return ModelOutput(value=y, valid=~missing)

    return Lowered(fn=rfn, params=params)
