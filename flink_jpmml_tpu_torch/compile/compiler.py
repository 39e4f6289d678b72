"""Top-level PMML → PyTorch compiler: dispatch, device placement, decode.

The port of ``flink_jpmml_tpu/compile/compiler.py`` for every model
family of the JAX package: TreeModel (every tree shape: dense, node-hop,
general scan, weighted-path walk), MiningModel (aggregates, votes,
modelChain, selectFirst, selectAll), RegressionModel, NeuralNetwork,
ClusteringModel, Scorecard, RuleSetModel, GeneralRegression,
NaiveBayes, SupportVectorMachine, NearestNeighbor, AnomalyDetection,
GaussianProcess, Baseline, Association, TimeSeries, BayesianNetwork and
TextModel. ``compile_pmml`` lowers the document to a plain function on
tensors and places its parameter tables on the device;
``CompiledModel.predict(X, M)`` scores one micro-batch, ``score_records``
/ ``score_dense`` wrap it with the decode, ``verify()`` replays the
document's ModelVerification records (``compile/verify.py``),
``warmup()`` runs one batch ahead of the hot path, and
``CompiledModel.quantized_scorer()`` builds the rank-wire fast path
(``qtrees.py``) for tree ensembles. TransformationDictionary derived
fields become extra device columns after the missing-value replacement
of the raw columns; a top-level ``<Output>`` is validated at compile time
and computed at decode (``pmml/outputs.py``), with the clustering and
KNN entity rankings (rank-k ``entityId``), the scorecard's reason codes,
the association rules' ``ruleValue`` ranking and the selectAll
per-segment map.

An IR class without a lowering raises :class:`NotPortedError` and names
itself. ``compile_pmml(mesh=)`` compiles on the mesh's primary device and
returns ``parallel/sharding.mesh_sharded(...)`` with
``config.tp_wide_threshold``, as the JAX package does; a sharded model
scores on the f32 path (its ``quantized_scorer()`` is None). Unlike the
JAX package, a failure while building the rank-wire scorer is never
caught and turned into a silent fall-back to the f32 path: it propagates.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile import prepare
from flink_jpmml_tpu_torch.compile.assoc import lower_association, rule_order
from flink_jpmml_tpu_torch.compile.baseline import lower_baseline
from flink_jpmml_tpu_torch.compile.bayes import lower_naive_bayes
from flink_jpmml_tpu_torch.compile.bayesnet import lower_bayesian_network
from flink_jpmml_tpu_torch.compile.clustering import lower_clustering
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
from flink_jpmml_tpu_torch.compile.exprs import lower_expression
from flink_jpmml_tpu_torch.compile.glm import lower_general_regression
from flink_jpmml_tpu_torch.compile.gp import lower_gp
from flink_jpmml_tpu_torch.compile.knn import lower_knn
from flink_jpmml_tpu_torch.compile.mining import lower_mining
from flink_jpmml_tpu_torch.compile.neural import lower_neural_network
from flink_jpmml_tpu_torch.compile.regression import lower_regression
from flink_jpmml_tpu_torch.compile.ruleset import lower_ruleset
from flink_jpmml_tpu_torch.compile.scorecard import (
    ReasonCodeMeta,
    lower_scorecard,
)
from flink_jpmml_tpu_torch.compile.svm import lower_svm
from flink_jpmml_tpu_torch.compile.textmodel import lower_text_model
from flink_jpmml_tpu_torch.compile.timeseries import lower_time_series
from flink_jpmml_tpu_torch.compile.trees import lower_tree
from flink_jpmml_tpu_torch.models.prediction import Prediction, decode_batch
from flink_jpmml_tpu_torch.pmml import ir
from flink_jpmml_tpu_torch.pmml.interp import rule_meta_dict
from flink_jpmml_tpu_torch.pmml.outputs import (
    compute_outputs,
    validate_output_fields,
)
from flink_jpmml_tpu_torch.utils.config import CompileConfig
from flink_jpmml_tpu_torch.utils.device import resolve_device
from flink_jpmml_tpu_torch.utils.exceptions import (
    ModelCompilationException,
    NotPortedError,
)

_UNSET = object()  # sentinel: rank-wire scorer not yet built


def _lower_anomaly(model: ir.AnomalyDetectionIR, ctx: LowerCtx) -> Lowered:
    # imported when used, as in the JAX package (anomaly imports this
    # module's lower_model for its inner model)
    from flink_jpmml_tpu_torch.compile.anomaly import lower_anomaly

    return lower_anomaly(model, ctx)


# the JAX package's dispatch order (compiler.py lower_model); MiningModel
# stays last
_LOWERERS = (
    (ir.TreeModelIR, lower_tree),
    (ir.RegressionModelIR, lower_regression),
    (ir.NeuralNetworkIR, lower_neural_network),
    (ir.ClusteringModelIR, lower_clustering),
    (ir.ScorecardIR, lower_scorecard),
    (ir.RuleSetIR, lower_ruleset),
    (ir.GeneralRegressionIR, lower_general_regression),
    (ir.NaiveBayesIR, lower_naive_bayes),
    (ir.SvmModelIR, lower_svm),
    (ir.NearestNeighborIR, lower_knn),
    (ir.AnomalyDetectionIR, _lower_anomaly),
    (ir.GaussianProcessIR, lower_gp),
    (ir.BaselineIR, lower_baseline),
    (ir.AssociationIR, lower_association),
    (ir.TimeSeriesIR, lower_time_series),
    (ir.BayesianNetworkIR, lower_bayesian_network),
    (ir.TextModelIR, lower_text_model),
    (ir.MiningModelIR, lower_mining),
)


def lower_model(model: ir.ModelIR, ctx: LowerCtx) -> Lowered:
    """Dispatch a parsed model to its family lowerer."""
    for cls, lower in _LOWERERS:
        if isinstance(model, cls):
            return lower(model, ctx)
    raise NotPortedError(
        f"model family {type(model).__name__} has no lowering in the port"
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
    tensors out; ``decode`` turns an output into ``Prediction`` lists, and
    ``score_records`` / ``score_dense`` do both (host-side decode; not for
    the hot loop).
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
    output_fields: Tuple[ir.OutputField, ...] = ()  # top-level <Output>
    # scorecard reason codes: (ReasonCodeMeta, n_characteristics) when the
    # document declares useReasonCodes and the metadata is complete
    _reason: Optional[tuple] = None
    # association: per-rule metadata (ruleFeature-keyed dicts, document
    # order) + the static confidence/support ranking, feeding
    # <Output feature="ruleValue"> fields at decode
    _rule_meta: Optional[Tuple[dict, ...]] = None
    _rule_order: Optional[Tuple[int, ...]] = None
    # embedded <ModelVerification> vectors + the target name they may
    # reference (verify() replays them)
    _verification: Optional[ir.ModelVerification] = None
    _target_field: Optional[str] = None
    # selectAll: segment ids, decoding probs = [values ∥ active] into
    # the per-segment outputs mapping
    _segment_ids: Optional[Tuple[str, ...]] = None
    # clustering: its probabilities mapping holds per-entity comparison
    # scores — the entityId/affinity output features read it; the order
    # ("asc" distances / "desc" similarities) ranks entities for rank-k
    # entityId
    _entity_scores: bool = False
    _entity_order: Optional[str] = None
    # KNN instanceIdVariable: (instance ids, k, n_label_columns) — the
    # last k probs columns are ranked neighbour indices
    _neighbor_meta: Optional[tuple] = None

    @property
    def is_classification(self) -> bool:
        return bool(self.labels)

    @property
    def active_fields(self) -> Tuple[str, ...]:
        return self.field_space.fields

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

    @property
    def has_verification(self) -> bool:
        return self._verification is not None

    def verify(self) -> List[str]:
        """Replay the document's embedded ModelVerification records on
        this model's device → mismatch descriptions; empty = verified (or
        nothing embedded)."""
        from flink_jpmml_tpu_torch.compile.verify import run_verification

        return run_verification(self, self._target_field)

    def warmup(self) -> "CompiledModel":
        """Score one zero batch ahead of the hot path: the parameter
        tables are on the device already, so this runs the lowered
        function once (the card's lazy initialisation, the kernels'
        first launch) and waits for the card."""
        b = self.batch_size or 1
        X = np.zeros((b, self.field_space.arity), np.float32)
        M = np.zeros((b, self.field_space.arity), bool)
        self.predict(X, M)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # -- convenience wrappers (host-side decode; not for the hot loop) -----

    def score_dense(
        self, vectors, replace_nan: Optional[float] = None
    ) -> List[Prediction]:
        X, M = prepare.from_dense(self.field_space, vectors, replace_nan)
        return self._score(X, M, n=X.shape[0])

    def score_records(self, records: Sequence[dict]) -> List[Prediction]:
        X, M = prepare.from_records(self.field_space, records)
        return self._score(X, M, n=X.shape[0])

    def _score(self, X, M, n: int) -> List[Prediction]:
        if self.batch_size is not None:
            X, M, _ = prepare.pad_batch(X, M, self.batch_size)
        out = self.predict(X, M)
        return self.decode(out, n)

    def decode(self, out: ModelOutput, n: Optional[int] = None) -> List[Prediction]:
        value = out.value.cpu().numpy()[:n]
        valid = out.valid.cpu().numpy()[:n]
        labels = None
        probabilities = None
        if self.is_classification and out.label_idx is not None:
            idx = out.label_idx.cpu().numpy()[:n]
            labels = [self.labels[i] for i in idx]
            # association: probs is the fired-rule mask, not class
            # probabilities — consumed below for ruleValue ranking.
            # KNN-with-ids: only the first L columns are vote shares
            # (the rest are ranked neighbour indices; zip stops at L)
            if out.probs is not None and self._rule_meta is None:
                P = out.probs.cpu().numpy()[:n]
                probabilities = [
                    dict(zip(self.labels, row.tolist())) for row in P
                ]
        preds = decode_batch(value.tolist(), valid.tolist(), labels, probabilities)
        if self._rule_meta is not None and not self.output_fields:
            # oracle parity: with no <Output> declared, the association
            # winner's metadata is still surfaced
            idx = out.label_idx.cpu().numpy()[:n]
            preds = [
                p if p.is_empty
                else dataclasses.replace(p, outputs=self._rule_meta[idx[i]])
                for i, p in enumerate(preds)
            ]
        if self._segment_ids is not None and not self.output_fields:
            # selectAll: probs = [values ∥ active mask]; surface every
            # active segment's value (None where inactive), oracle parity
            S = len(self._segment_ids)
            P = out.probs.cpu().numpy()[:n]
            preds = [
                p if p.is_empty
                else dataclasses.replace(p, outputs={"segments": {
                    sid: (float(P[i, j]) if P[i, S + j] > 0.5 else None)
                    for j, sid in enumerate(self._segment_ids)
                }})
                for i, p in enumerate(preds)
            ]
        if not self.output_fields:
            return preds
        # top-level <Output> post-processing (pmml/outputs.py): only
        # documents that declare it pay this host-side per-record step
        rc_rows = None
        if self._reason is not None and any(
            of.feature == "reasonCode" for of in self.output_fields
        ):
            meta, C = self._reason
            P = out.probs.cpu().numpy()[:n]  # [B, 2C]: partials ∥ attr
            rc_rows = [
                meta.rank(P[i, :C], P[i, C:].astype(np.int32))
                for i in range(P.shape[0])
            ]
        rankings = self._entity_rankings(out, n)
        rank_rows = None
        if self._rule_meta is not None and out.probs is not None and any(
            of.feature == "ruleValue" for of in self.output_fields
        ):
            # fired mask (document order) → ranked fired-rule metadata
            # via the static confidence/support order
            fired = out.probs.cpu().numpy()[:n] > 0.5
            rank_rows = [
                tuple(self._rule_meta[j] for j in self._rule_order
                      if fired[i, j])
                for i in range(fired.shape[0])
            ]
        return [
            p
            if p.is_empty
            else dataclasses.replace(
                p,
                outputs=compute_outputs(
                    self.output_fields,
                    p.score.value,
                    p.target.label if p.target else None,
                    p.target.probabilities if p.target else None,
                    reason_codes=(
                        rc_rows[i] if rc_rows is not None else None
                    ),
                    rule_ranking=(
                        rank_rows[i] if rank_rows is not None else None
                    ),
                    entity_scores=(
                        (p.target.probabilities or None)
                        if self._entity_scores and p.target
                        else None
                    ),
                    entity_ranking=(
                        rankings[i] if rankings is not None else None
                    ),
                ),
            )
            for i, p in enumerate(preds)
        ]

    def _entity_rankings(self, out, n):
        """Per-record best-first entity ids for rank-k entityId decode:
        clustering sorts its score row; KNN-with-ids reads the ranked
        neighbour-index columns the lowered function appended."""
        if not any(of.feature == "entityId" for of in self.output_fields):
            return None
        if self._neighbor_meta is not None and out.probs is not None:
            ids, k, L = self._neighbor_meta
            idx = out.probs.cpu().numpy()[:n, L:].astype(np.int64)
            return [
                tuple(ids[j] for j in idx[i]) for i in range(idx.shape[0])
            ]
        if self._entity_order is not None and out.probs is not None:
            P = out.probs.cpu().numpy()[:n]
            sign = 1.0 if self._entity_order == "asc" else -1.0
            order = np.argsort(sign * P, axis=1, kind="stable")
            return [
                tuple(self.labels[j] for j in order[i])
                for i in range(order.shape[0])
            ]
        return None


def compile_pmml(
    doc: ir.PmmlDocument,
    batch_size: Optional[int] = None,
    config: Optional[CompileConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
    mesh=None,
) -> CompiledModel:
    """Parse tree → scorer on ``device`` (default: the CUDA card; raises
    DeviceUnavailableError without one — pass ``device="cpu"`` for the
    CPU).

    ``batch_size`` is the compile batch: the block pipeline drains to it
    and the rank wire aligns dispatches to multiples of it. ``mesh`` (a
    ``parallel/mesh.Mesh``) compiles on the mesh's primary device and
    returns the mesh-sharded model (``ShardedModel``)."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.primary:
            raise ModelCompilationException(
                f"device={device} is not the mesh's primary device "
                f"{mesh.primary}")
        device = mesh.primary
    dev = resolve_device(device)
    config = config or CompileConfig()
    fields = doc.active_fields
    if not fields:
        raise ModelCompilationException("model has no active fields")
    codecs = build_codecs(doc.data_dictionary)

    # TransformationDictionary derived fields become extra input columns,
    # computed on the device from the raw columns before the model body
    # runs (declaration order; later fields may reference earlier ones).
    # The user-facing field space stays the raw active fields.
    field_index = {f: i for i, f in enumerate(fields)}
    derived_fns = []
    for df in doc.transformations.derived_fields:
        dctx = LowerCtx(
            field_index=dict(field_index), codecs=codecs, config=config
        )
        derived_fns.append(lower_expression(df.expression, dctx))
        if df.name in field_index:
            raise ModelCompilationException(
                f"derived field {df.name!r} shadows an existing field"
            )
        field_index[df.name] = len(field_index)

    ctx = LowerCtx(field_index=field_index, codecs=codecs, config=config)
    lowered = lower_model(doc.model, ctx)

    # top-level mining-schema missingValueReplacement (C4), vectorized —
    # sized to the RAW columns (it runs before derived columns exist,
    # mirroring the reference's replacement → transformations order)
    raw_ctx = LowerCtx(
        field_index={f: i for i, f in enumerate(fields)},
        codecs=codecs,
        config=config,
    )
    repl, has_repl = extract_missing_replacements(
        doc.model.mining_schema, raw_ctx
    )
    any_repl = bool(has_repl.any())
    targets = doc.targets
    # DataDictionary validity × invalidValueTreatment (None = nothing can
    # be invalid; the sanitize stage is skipped entirely)
    ivp = extract_invalid_policy(
        doc.data_dictionary, doc.model.mining_schema, raw_ctx
    )
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
        for dfn in derived_fns:  # appends columns in declaration order
            v, miss = dfn(X, M)
            X = torch.cat([X, v.to(torch.float32)[:, None]], dim=1)
            M = torch.cat([M, miss[:, None]], dim=1)
        out = lowered.fn(params["model"], X, M)
        out = apply_targets(out, targets)
        if lane_bad is not None:
            out = out._replace(valid=out.valid & ~lane_bad)
        return out

    validate_output_fields(doc.output_fields)
    reason = None
    if isinstance(doc.model, ir.ScorecardIR) and doc.model.use_reason_codes:
        wants_rc = any(
            of.feature == "reasonCode" for of in doc.output_fields
        )
        try:
            reason = (
                ReasonCodeMeta(doc.model),
                len(doc.model.characteristics),
            )
        except ModelCompilationException:
            if wants_rc:
                raise  # requested but the metadata is incomplete
            reason = None
    rule_meta = rule_rank = None
    if isinstance(doc.model, ir.AssociationIR):
        rule_meta = tuple(rule_meta_dict(r) for r in doc.model.rules)
        rule_rank = tuple(rule_order(doc.model.rules))
    segment_ids = None
    if (
        isinstance(doc.model, ir.MiningModelIR)
        and doc.model.segmentation.multiple_model_method == "selectAll"
    ):
        segment_ids = tuple(
            s.segment_id or str(i)
            for i, s in enumerate(doc.model.segmentation.segments)
        )
    entity_scores = isinstance(doc.model, ir.ClusteringModelIR)
    entity_order = None
    if entity_scores:
        entity_order = (
            "desc" if doc.model.measure.kind == "similarity" else "asc"
        )
    neighbor_meta = None
    if (
        isinstance(doc.model, ir.NearestNeighborIR)
        and doc.model.instance_ids
    ):
        neighbor_meta = (
            doc.model.instance_ids,
            doc.model.n_neighbors,
            len(lowered.labels),
        )
    compiled = CompiledModel(
        field_space=prepare.FieldSpace(fields=fields, codecs=ctx.codecs),
        labels=lowered.labels,
        params=to_device(host_params, dev),
        batch_size=batch_size,
        _fn=full_fn,
        device=dev,
        model_name=getattr(doc.model, "model_name", None),
        _doc=doc,
        _config=config,
        output_fields=doc.output_fields,
        _reason=reason,
        _rule_meta=rule_meta,
        _rule_order=rule_rank,
        _verification=doc.verification,
        _target_field=doc.target_field,
        _segment_ids=segment_ids,
        _entity_scores=entity_scores,
        _entity_order=entity_order,
        _neighbor_meta=neighbor_meta,
    )
    if mesh is not None:
        from flink_jpmml_tpu_torch.parallel.sharding import mesh_sharded

        return mesh_sharded(
            compiled, mesh, wide_threshold=config.tp_wide_threshold
        )
    return compiled
