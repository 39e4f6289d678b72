"""Top-level PMML → PyTorch compiler: dispatch, device placement, decode.

The port of ``flink_jpmml_tpu/compile/compiler.py`` for TreeModel and
MiningModel-of-trees documents. ``compile_pmml`` lowers the document to a
plain function on tensors and places its parameter tables on the device;
``CompiledModel.predict(X, M)`` scores one micro-batch and
``CompiledModel.quantized_scorer()`` builds the rank-wire fast path
(``qtrees.py``).

Every other model family, TransformationDictionary derived fields and a
top-level ``<Output>`` raise :class:`NotPortedError`. Unlike the JAX
package, a failure while building the rank-wire scorer is never caught and
turned into a silent fall-back to the f32 path: it propagates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile import prepare
from flink_jpmml_tpu_torch.compile.common import (
    Lowered,
    LowerCtx,
    ModelOutput,
    apply_targets,
    build_codecs,
    extract_invalid_policy,
    extract_missing_replacements,
    to_device,
)
from flink_jpmml_tpu_torch.compile.mining import lower_mining
from flink_jpmml_tpu_torch.compile.trees import lower_tree
from flink_jpmml_tpu_torch.models.prediction import Prediction, decode_batch
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.utils.config import CompileConfig
from flink_jpmml_tpu_torch.utils.device import resolve_device
from flink_jpmml_tpu_torch.utils.exceptions import (
    ModelCompilationException,
    NotPortedError,
)

_UNSET = object()  # sentinel: rank-wire scorer not yet built


def lower_model(model: ir.ModelIR, ctx: LowerCtx) -> Lowered:
    """Dispatch a parsed model to its family lowerer."""
    if isinstance(model, ir.TreeModelIR):
        return lower_tree(model, ctx)
    if isinstance(model, ir.MiningModelIR):
        return lower_mining(model, ctx)
    raise NotPortedError(
        f"model family {type(model).__name__} is not ported yet "
        "(the port covers TreeModel and MiningModel of trees)"
    )


def as_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype
    )


@dataclass
class CompiledModel:
    """A PMML document compiled to a batch scorer on one device.

    ``predict`` is the hot path: arrays in, :class:`ModelOutput` of device
    tensors out; ``decode`` turns an output into ``Prediction`` lists.
    """

    field_space: prepare.FieldSpace
    labels: Tuple[str, ...]
    params: Dict
    batch_size: Optional[int]
    _fn: object
    device: torch.device
    model_name: Optional[str] = None
    _doc: Optional[ir.PmmlDocument] = None
    _config: Optional[CompileConfig] = None
    _quantized: object = _UNSET

    @property
    def is_classification(self) -> bool:
        return bool(self.labels)

    def predict(self, X, M) -> ModelOutput:
        X = as_tensor(X, torch.float32, self.device)
        M = as_tensor(M, torch.bool, self.device)
        with torch.no_grad():
            return self._fn(self.params, X, M)

    def quantized_scorer(self):
        """Rank-wire fast path (qtrees.py) for this model on its device,
        or None when the model is outside the wire's contract. Built on
        first call and cached. A failure to build it raises: there is no
        fall-back to the f32 path."""
        if self._quantized is _UNSET:
            from flink_jpmml_tpu_torch.compile.qtrees import (
                build_quantized_scorer,
            )

            self._quantized = build_quantized_scorer(
                self._doc,
                batch_size=self.batch_size,
                config=self._config,
                device=self.device,
            )
            # the parse tree is only needed for this build
            self._doc = None
            self._config = None
        return self._quantized

    def decode(self, out: ModelOutput, n: Optional[int] = None) -> List[Prediction]:
        value = out.value.cpu().numpy()[:n]
        valid = out.valid.cpu().numpy()[:n]
        labels = None
        probabilities = None
        if self.is_classification and out.label_idx is not None:
            idx = out.label_idx.cpu().numpy()[:n]
            labels = [self.labels[i] for i in idx]
            if out.probs is not None:
                P = out.probs.cpu().numpy()[:n]
                probabilities = [
                    dict(zip(self.labels, row.tolist())) for row in P
                ]
        return decode_batch(value.tolist(), valid.tolist(), labels, probabilities)


def compile_pmml(
    doc: ir.PmmlDocument,
    batch_size: Optional[int] = None,
    config: Optional[CompileConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> CompiledModel:
    """Parse tree → scorer on ``device`` (default: the CUDA card; raises
    DeviceUnavailableError without one — pass ``device="cpu"`` for the
    CPU).

    ``batch_size`` is the compile batch: the block pipeline drains to it
    and the rank wire aligns dispatches to multiples of it."""
    dev = resolve_device(device)
    config = config or CompileConfig()
    fields = doc.active_fields
    if not fields:
        raise ModelCompilationException("model has no active fields")
    if doc.transformations.derived_fields:
        raise NotPortedError(
            "TransformationDictionary derived fields (compile/exprs) are "
            "not ported yet"
        )
    if doc.output_fields:
        raise NotPortedError(
            "top-level <Output> post-processing (pmml/outputs) is not "
            "ported yet"
        )
    codecs = build_codecs(doc.data_dictionary)
    ctx = LowerCtx(
        field_index={f: i for i, f in enumerate(fields)},
        codecs=codecs,
        config=config,
    )
    lowered = lower_model(doc.model, ctx)

    # top-level mining-schema missingValueReplacement (C4), vectorized
    repl, has_repl = extract_missing_replacements(doc.model.mining_schema, ctx)
    any_repl = bool(has_repl.any())
    targets = doc.targets
    # DataDictionary validity × invalidValueTreatment (None = nothing can
    # be invalid; the sanitize stage is skipped entirely)
    ivp = extract_invalid_policy(doc.data_dictionary, doc.model.mining_schema, ctx)
    host_params = {"model": lowered.params, "repl": repl, "has_repl": has_repl}
    if ivp is not None:
        host_params["ivp"] = {k: v for k, v in ivp.items() if v is not None}
    has_ivl = ivp is not None and ivp["has_ivl"] is not None

    def full_fn(params, X, M):
        lane_bad = None
        if ivp is not None:
            pv = params["ivp"]
            # a categorical cell is invalid unless it holds an exact code
            # in [0, n_declared) (prepare.encode_cell marks undeclared
            # strings +inf)
            inv = (
                pv["has_cat"][None, :]
                & ~M
                & (
                    (X < 0)
                    | (X >= pv["cat_n"][None, :])
                    | (X != torch.round(X))
                )
            )
            if has_ivl:
                xk = X[:, :, None]
                ge = torch.where(
                    pv["lo_open"][None], xk > pv["lo"][None],
                    xk >= pv["lo"][None],
                )
                le = torch.where(
                    pv["hi_open"][None], xk < pv["hi"][None],
                    xk <= pv["hi"][None],
                )
                in_any = (ge & le).any(dim=-1)
                inv = inv | (pv["has_ivl"][None, :] & ~in_any & ~M)
            treat = pv["treat"][None, :]
            X = torch.where(inv & (treat == 3), pv["repl"][None, :], X)
            M = M | (inv & (treat == 1))
            lane_bad = (inv & (treat == 2)).any(dim=1)
            # asIs / asMissing / returnInvalid categorical markers become
            # a never-match code
            X = torch.where(inv & pv["has_cat"][None, :] & (treat != 3), -2.0, X)
            X = torch.where(M, 0.0, X)
        if any_repl:
            use = M & params["has_repl"][None, :]
            X = torch.where(use, params["repl"][None, :], X)
            M = M & ~params["has_repl"][None, :]
        out = lowered.fn(params["model"], X, M)
        out = apply_targets(out, targets)
        if lane_bad is not None:
            out = out._replace(valid=out.valid & ~lane_bad)
        return out

    return CompiledModel(
        field_space=prepare.FieldSpace(fields=fields, codecs=ctx.codecs),
        labels=lowered.labels,
        params=to_device(host_params, dev),
        batch_size=batch_size,
        _fn=full_fn,
        device=dev,
        model_name=getattr(doc.model, "model_name", None),
        _doc=doc,
        _config=config,
    )
