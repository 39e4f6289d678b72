"""Sharded scoring: DP over the batch axis, 1-D TP over wide feature dims.

The port of ``flink_jpmml_tpu/parallel/sharding.py``. Reference parity
(SURVEY.md §3 P1–P3): Flink ran N subtasks each holding a model copy;
here one scoring call spans the mesh —

- :func:`dp_sharded` wraps any :class:`CompiledModel` with the
  micro-batch split over the ``data`` axis and the params replicated
  once per distinct physical device. Each data row's equal share of the
  padded batch runs the base model's function on the row's first device
  — on that device's own CUDA stream when it is not the mesh's primary
  device — and the outputs are gathered back in row order on the
  primary device. No collective is needed on the forward path.
- :func:`mesh_sharded` adds the model axis. There is no GSPMD in
  PyTorch, so the JAX rule only *picks* the wide leaves (leading dim ≥
  ``tp_wide_threshold``, divisible by the model width, model width > 1;
  ``tp_sharded_leaves`` names the same leaves as the JAX model's), and
  every leaf it picks is stored as a ``compile.common.TpLeaf``:
  model-axis row slices on the row's devices, never a quiet replica.
  Its consumer takes it in one of two ways. A contracting consumer
  computes one partial product per slice on the slice's device and adds
  the partials in slice order (the partitioned dot and ``psum`` GSPMD
  derives): a regression table's ``num_coefs`` and paired ``cat_codes``
  / ``cat_coefs`` (``compile/regression.py``), a neural layer's weights
  or radial-basis centres ``W`` (``compile/neural.py``), the GLM's
  ``beta`` (``compile/glm.py``), the SVM's support vectors ``S`` paired
  with their coefficient rows ``A`` (``compile/svm.py``), and the GP's
  training rows ``Zs`` / ``Zs_sq`` or ``Ztr`` paired with ``alpha``
  (``compile/gp.py``) — :data:`CONTRACTING`. Every other leaf the rule
  picks is gathered onto the row's first device, in slice order, right
  before each call (the all-gather GSPMD inserts): KNN's instance,
  label and target tables (``compile/knn.py``), the text model's
  document matrix and its norms (``compile/textmodel.py``), a wide
  neural bias, the GP's ``inv_lam`` over a wide input, the Cox
  baseline, a tree ensemble's stacked tables, and any other family's.
- :func:`tp_linear` / :class:`TpLinearScorer` and :func:`mp_gp` spell
  the same recipe out by hand: per-slice partial products with
  ``torch.matmul`` (TF32 off, ``utils/device.py``), added in slice order
  where the JAX functions ``psum`` over the model axis.

``ShardedModel.quantized_scorer()`` returns None, as in the JAX package:
a sharded model serves on the f32 path, so the mesh never reaches the
rank-wire kernel. On a 1×1 mesh the sharded model runs the base's
function on the base's own params, the same ops on the same batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import ModelOutput, TpLeaf, to_device
from flink_jpmml_tpu_torch.compile.compiler import CompiledModel, as_tensor
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    device_id,
    physical,
)
from flink_jpmml_tpu_torch.utils.exceptions import (
    FlinkJpmmlTpuError,
    InputValidationException,
)


def _keystr(path) -> str:
    """A leaf path as ``jax.tree_util.keystr`` spells a dict path."""
    return "".join(f"['{k}']" for k in path)


def _leaves(tree, path=()):
    """(path, parent dict, key, tensor) of every leaf of a nested dict, in
    the order ``jax.tree_util`` flattens a dict (sorted keys)."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), tree, k, v


def _with_leaves(tree, new: Dict[tuple, object], path=()):
    """A copy of the dict structure of ``tree`` with the leaves at the
    paths of ``new`` replaced (the other leaves are shared)."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _with_leaves(v, new, p)
        else:
            out[k] = new.get(p, v)
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _stream_for(streams: dict, dev: torch.device):
    s = streams.get(dev)
    if s is None:
        s = streams[dev] = torch.cuda.Stream(dev)
    return s


@dataclass
class ShardedModel:
    """A CompiledModel placed on a mesh: same predict contract, batch
    split over ``data``; params replicated (:func:`dp_sharded`) or
    feature-sharded over ``model`` where wide (:func:`mesh_sharded`)."""

    base: CompiledModel
    mesh: Mesh
    # the params tree each data row scores with (on the row's devices)
    _row_params: List[dict]
    # names of param leaves sharded over the model axis ("" = none):
    # observability for tests asserting the TP path is real
    tp_sharded_leaves: tuple = ()
    # hot-path serving state carried THROUGH a degraded-mesh rebuild:
    # - dispatch_state: the dispatcher/window geometry the pipelines
    #   configured (in-flight depth) — opaque dict, copied verbatim onto
    #   the rebuilt model;
    # - assignment: the ChipAssignment (parallel/assignment.py) mapping
    #   kafka partitions / record keys to chips — re-balanced with
    #   ``.without(lost)`` so only the dead chip's work moves.
    dispatch_state: Optional[dict] = None
    assignment: object = None
    # the wide threshold a TP-sharded model was built with (a rebuild
    # over the survivors picks the same leaves)
    _wide_threshold: Optional[int] = None
    # paths (in the params tree) of the split leaves whose consumer
    # selects rather than sums: gathered before each call
    _gathered: tuple = ()

    def __post_init__(self):
        self._row_dev = [physical(self.mesh.devices[r, 0])
                         for r in range(self.mesh.shape[DATA_AXIS])]
        self._streams: dict = {}

    @property
    def batch_divisor(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def device(self) -> torch.device:
        """Where inputs arrive and gathered outputs land: the mesh's
        primary device."""
        return self.mesh.primary

    @property
    def params(self) -> dict:
        """The first data row's params tree."""
        return self._row_params[0]

    def _call_params(self, r: int) -> dict:
        """Row ``r``'s params tree as its call reads it: each gathered
        leaf's slices concatenated on the row's first device."""
        tree = self._row_params[r]
        if not self._gathered:
            return tree
        dev = self._row_dev[r]
        return _with_leaves(tree, {
            p: _at(tree, p).gather(dev) for p in self._gathered})

    def in_flight_depth(self, base_depth: int) -> int:
        """Mesh-aware in-flight window: the carried dispatch_state's
        depth when one was configured, else the data-width heuristic
        (parallel/assignment.mesh_in_flight)."""
        from flink_jpmml_tpu_torch.parallel.assignment import mesh_in_flight

        ds = self.dispatch_state or {}
        if "in_flight" in ds:
            return int(ds["in_flight"])
        return mesh_in_flight(self.mesh, base_depth)

    def with_dispatch_state(self, **kv) -> "ShardedModel":
        """Attach/merge dispatcher-window state (returns self — the
        pipelines call this at bind time)."""
        ds = dict(self.dispatch_state or {})
        ds.update(kv)
        self.dispatch_state = ds
        return self

    def predict(self, X, M) -> ModelOutput:
        if X.shape[0] % self.batch_divisor != 0:
            raise InputValidationException(
                f"sharded batch {X.shape[0]} must divide by the data-axis "
                f"size {self.batch_divisor} (pad the micro-batch)"
            )
        dev = self.device
        X = as_tensor(X, torch.float32, dev)
        M = as_tensor(M, torch.bool, dev)
        fn = self.base._fn
        with torch.no_grad():
            if self.batch_divisor == 1:
                return fn(self._call_params(0), X, M)
            outs = []
            for r, (Xr, Mr) in enumerate(zip(X.chunk(self.batch_divisor),
                                             M.chunk(self.batch_divisor))):
                rdev = self._row_dev[r]
                if rdev == dev:
                    outs.append(fn(self._call_params(r), Xr, Mr))
                    continue
                # another card: its own stream; the cross-device copies
                # order themselves against both devices' current streams
                with torch.cuda.stream(_stream_for(self._streams, rdev)):
                    out = fn(self._call_params(r), Xr.to(rdev),
                             Mr.to(rdev))
                    outs.append(ModelOutput(*(
                        None if t is None else t.to(dev) for t in out)))
            return ModelOutput(*(
                None if parts[0] is None else torch.cat(parts, dim=0)
                for parts in zip(*outs)))

    def decode(self, out: ModelOutput, n: Optional[int] = None):
        return self.base.decode(out, n)

    def warmup(self) -> "ShardedModel":
        b = self.base.batch_size or self.batch_divisor
        b += (-b) % self.batch_divisor
        X = np.zeros((b, self.field_space.arity), np.float32)
        M = np.zeros((b, self.field_space.arity), bool)
        self.predict(X, M)
        for d in {physical(d) for d in self.mesh.devices.flat}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return self

    # -- convenience wrappers (CompiledModel parity for serving/tests) ----

    def score_records(self, records):
        from flink_jpmml_tpu_torch.compile import prepare

        X, M = prepare.from_records(self.field_space, records)
        return self._score(X, M, n=X.shape[0])

    def score_dense(self, vectors, replace_nan: Optional[float] = None):
        from flink_jpmml_tpu_torch.compile import prepare

        X, M = prepare.from_dense(self.field_space, vectors, replace_nan)
        return self._score(X, M, n=X.shape[0])

    def _score(self, X, M, n: int):
        from flink_jpmml_tpu_torch.compile import prepare

        target = self.base.batch_size or X.shape[0]
        target += (-target) % self.batch_divisor  # mesh-divisible pad
        X, M, _ = prepare.pad_batch(X, M, target)
        return self.decode(self.predict(X, M), n)

    def quantized_scorer(self):
        """The rank-wire fast path is single-device only: a sharded
        serving plane scores on the f32 path (None keeps the
        BlockPipeline fallback contract)."""
        return None

    @property
    def field_space(self):
        return self.base.field_space

    @property
    def batch_size(self):
        return self.base.batch_size

    @property
    def labels(self):
        return self.base.labels

    @property
    def is_classification(self):
        return self.base.is_classification

    @property
    def model_name(self):
        return self.base.model_name

    @property
    def output_fields(self):
        return self.base.output_fields

    @property
    def active_fields(self):
        return self.base.active_fields

    @property
    def _verification(self):
        return self.base._verification

    @property
    def _target_field(self):
        return self.base._target_field

    @property
    def has_verification(self) -> bool:
        return self.base.has_verification

    def verify(self):
        """Replay embedded <ModelVerification> vectors through the
        SHARDED path — the computation that will actually serve (row
        shards, model-axis partial products), not the unsharded base."""
        from flink_jpmml_tpu_torch.compile.verify import run_verification

        return run_verification(self, self.base._target_field)

    def without_devices(self, lost) -> "ShardedModel":
        """Degraded-mesh mode: rebuild this model over the mesh MINUS
        ``lost`` — the recovery move for an unrecoverable ``chip_loss``
        (runtime/devfault.py). Params re-place onto the survivors from
        the host copy, the batch divisor shrinks, and the scoring
        contract is unchanged. TP sharding is kept when the survivors
        still fill the model axis (:func:`degraded_mesh`).

        Serving state CARRIES THROUGH the rebuild: the dispatcher/window
        geometry (``dispatch_state``) copies verbatim, and the
        partition/key assignment re-balances via ``assignment
        .without(lost)`` — only the dead chip's partitions and keys
        move (rendezvous hashing)."""
        new_mesh = degraded_mesh(self.mesh, lost)
        if self.tp_sharded_leaves:
            rebuilt = mesh_sharded(self.base, new_mesh,
                                   wide_threshold=self._wide_threshold)
        else:
            rebuilt = dp_sharded(self.base, new_mesh)
        if self.dispatch_state is not None:
            rebuilt.dispatch_state = dict(self.dispatch_state)
        if self.assignment is not None:
            rebuilt.assignment = self.assignment.without(lost)
        flight.record(
            "mesh_degraded",
            lost=[str(device_id(d)) for d in lost],
            data=new_mesh.shape[DATA_AXIS],
            model=new_mesh.shape[MODEL_AXIS],
        )
        return rebuilt


def degraded_mesh(mesh: Mesh, lost) -> Mesh:
    """→ the ``data × model`` mesh over ``mesh``'s devices minus
    ``lost`` (devices or device ids). The MODEL axis width is preserved —
    TP shards partition param tensors, so shrinking that axis would
    change the program; the DATA axis absorbs the loss. Survivors that no
    longer fill a whole data row are trimmed (idle beats wrong). Raises
    when no full data row survives."""
    lost_ids = {device_id(d) for d in lost}
    survivors = [d for d in mesh.devices.flat if device_id(d) not in lost_ids]
    n_model = mesh.shape[MODEL_AXIS]
    data = len(survivors) // n_model
    if data < 1:
        raise FlinkJpmmlTpuError(
            f"degraded mesh unsurvivable: {len(survivors)} device(s) "
            f"left cannot fill one {n_model}-wide model-axis row"
        )
    grid = np.empty(data * n_model, dtype=object)
    grid[:] = survivors[: data * n_model]
    return Mesh(grid.reshape(data, n_model),
                axis_names=(DATA_AXIS, MODEL_AXIS))


def _replicas(model: CompiledModel, mesh: Mesh) -> Dict[torch.device, dict]:
    """The params tree once per distinct physical device of the mesh's
    data rows (the base's own device reuses the base's tensors)."""
    out = {physical(model.device): model.params}
    for r in range(mesh.shape[DATA_AXIS]):
        d = physical(mesh.devices[r, 0])
        if d not in out:
            out[d] = to_device(model.params, d)
    return out


def dp_sharded(model: CompiledModel, mesh: Mesh) -> ShardedModel:
    """Batch-data-parallel scoring over the mesh (replicated params)."""
    reps = _replicas(model, mesh)
    rows = [reps[physical(mesh.devices[r, 0])]
            for r in range(mesh.shape[DATA_AXIS])]
    return ShardedModel(base=model, mesh=mesh, _row_params=rows)


def wide_leaves(params: dict, n_model: int, wide_threshold: int) -> list:
    """The JAX rule's pick, over the model's params: (path, parent, key,
    tensor) of every leaf whose leading dim is ≥ ``wide_threshold`` and
    divisible by the model width, when that width is > 1."""
    if n_model <= 1:
        return []
    return [
        (path, parent, key, leaf)
        for path, parent, key, leaf in _leaves(params)
        if leaf.ndim >= 1 and leaf.shape[0] >= wide_threshold
        and leaf.shape[0] % n_model == 0
    ]


# the consumers that contract over a split leaf's leading dim and take a
# TpLeaf themselves: (the keys of the params dict that holds the leaf,
# the keys among them a contracting consumer splits). Leaves split alike
# (same leading dim) are passed to ``TpLeaf.partial_sum`` as its paired
# leaves.
CONTRACTING = (
    # compile/regression.py: a RegressionTable
    ({"intercept", "num_coefs", "cat_codes", "cat_coefs"},
     {"num_coefs", "cat_codes", "cat_coefs"}),
    # compile/neural.py: a layer (the bias is added, so gathered)
    ({"W", "b"}, {"W"}),
    # compile/glm.py: β, with or without the Cox baseline
    ({"beta"}, {"beta"}),
    ({"beta", "cox_times", "cox_haz"}, {"beta"}),
    # compile/svm.py: support vectors and their coefficient rows
    ({"S", "A", "b"}, {"S", "A"}),
    # compile/gp.py: training rows (pre-scaled or raw) and α
    ({"alpha", "inv_lam", "Zs", "Zs_sq"}, {"alpha", "Zs", "Zs_sq"}),
    ({"alpha", "inv_lam", "Ztr"}, {"alpha", "Ztr"}),
)


def is_contracting(parent: dict, key: str) -> bool:
    """Does ``parent[key]``'s consumer compute per-slice partials?"""
    keys = set(parent)
    return any(keys == held and key in split for held, split in CONTRACTING)


def mesh_sharded(
    model: CompiledModel,
    mesh: Mesh,
    wide_threshold: Optional[int] = None,
) -> ShardedModel:
    """DP over the batch axis + 1-D feature TP over wide param tensors
    (BASELINE config 5: the stacked model's 10k-dim linear stage).

    The wide leaves are picked by the JAX rule over the lowered model's
    params (the JAX ``CompiledModel.params``; the port's tree holds them
    under ``"model"`` beside the compiler's own replacement / validity
    tables, which JAX closes over as constants). Each becomes a
    :class:`TpLeaf` over the row's devices, taken per slice by a
    contracting consumer (:func:`is_contracting`) and gathered before
    the call for any other; narrow params replicate. A pure-DP mesh
    (model axis 1) is exactly :func:`dp_sharded`."""
    if wide_threshold is None:
        from flink_jpmml_tpu_torch.utils.config import CompileConfig

        wide_threshold = CompileConfig().tp_wide_threshold
    n_model = mesh.shape[MODEL_AXIS]
    wide = wide_leaves(model.params["model"], n_model, wide_threshold)
    sm = dp_sharded(model, mesh)
    sm._wide_threshold = wide_threshold
    if not wide:
        return sm
    host = {("model",) + path: leaf.detach().cpu()
            for path, _, _, leaf in wide}
    by_devs: Dict[tuple, dict] = {}
    rows = []
    for r in range(mesh.shape[DATA_AXIS]):
        devs = tuple(physical(d) for d in mesh.row(r))
        tree = by_devs.get(devs)
        if tree is None:
            tree = by_devs[devs] = _with_leaves(sm._row_params[r], {
                p: TpLeaf(_keystr(p[1:]), h, devs) for p, h in host.items()
            })
        rows.append(tree)
    sm._row_params = rows
    sm._gathered = tuple(("model",) + path for path, parent, key, _ in wide
                         if not is_contracting(parent, key))
    sm.tp_sharded_leaves = tuple(_keystr(path) for path, _, _, _ in wide)
    return sm


# ---------------------------------------------------------------------------
# 1-D tensor parallelism for wide linear models (config 5)
# ---------------------------------------------------------------------------


def _slices(n: int, m: int) -> list:
    step = n // m
    return [(k * step, (k + 1) * step) for k in range(m)]


def _check_batch(X, n_data: int) -> None:
    if X.shape[0] % n_data != 0:
        raise InputValidationException(
            f"sharded batch {X.shape[0]} must divide by the data-axis "
            f"size {n_data} (pad the micro-batch)"
        )


def tp_linear(mesh: Mesh, n_features: int, n_outputs: int):
    """→ fn(W [F,C], b [C], X [B,F]) -> [B,C], feature dim sharded.

    Each data row scores its share of the batch; within the row, model
    slice k computes its partial ``X[:, F_k] @ W[F_k]`` on the row's
    k-th device, and the partials are added in slice order on the row's
    first device (the JAX function's ``psum`` over the model axis), then
    the bias. The rows are gathered back in order on the mesh's primary
    device."""
    n_model = mesh.shape[MODEL_AXIS]
    if n_features % n_model != 0:
        raise InputValidationException(
            f"feature dim {n_features} must divide by model-axis size "
            f"{n_model} (pad the feature space)"
        )
    n_data = mesh.shape[DATA_AXIS]
    bounds = _slices(n_features, n_model)
    primary = mesh.primary

    def fn(W, b, X):
        _check_batch(X, n_data)
        W, b = torch.as_tensor(W), torch.as_tensor(b)
        rows = []
        for r, Xr in enumerate(torch.as_tensor(X).chunk(n_data)):
            devs = [physical(d) for d in mesh.row(r)]
            full = None
            for (lo, hi), d in zip(bounds, devs):
                part = torch.matmul(Xr[:, lo:hi].to(d), W[lo:hi].to(d))
                part = part.to(devs[0])
                full = part if full is None else full + part
            rows.append((full + b.to(devs[0])).to(primary))
        return torch.cat(rows, dim=0)

    return fn


@dataclass
class TpLinearScorer:
    """A feature-sharded logistic/linear scorer for very wide models
    (BASELINE config 5's 10k-dim sparse LR): ``sigmoid(X @ W + b)`` with
    W's feature dimension split over the ``model`` axis; each slice of W
    is placed once on its devices."""

    mesh: Mesh
    W: np.ndarray  # [F, C]
    b: np.ndarray  # [C]
    link: str = "logit"  # logit | identity | softmax

    def __post_init__(self):
        F, C = self.W.shape
        n_model = self.mesh.shape[MODEL_AXIS]
        if F % n_model != 0:
            raise InputValidationException(
                f"feature dim {F} must divide by model-axis size "
                f"{n_model} (pad the feature space)"
            )
        self._bounds = _slices(F, n_model)
        W = torch.from_numpy(np.ascontiguousarray(self.W, np.float32))
        b = torch.from_numpy(np.ascontiguousarray(self.b, np.float32))
        placed: dict = {}
        self._rows = []
        for r in range(self.mesh.shape[DATA_AXIS]):
            devs = tuple(physical(d) for d in self.mesh.row(r))
            if devs not in placed:
                placed[devs] = (
                    [W[lo:hi].to(d) for (lo, hi), d in zip(self._bounds,
                                                           devs)],
                    b.to(devs[0]),
                )
            self._rows.append(placed[devs])

    def predict(self, X) -> torch.Tensor:
        from flink_jpmml_tpu_torch.compile.regression import softmax

        n_data = self.mesh.shape[DATA_AXIS]
        if X.ndim != 2 or X.shape[1] != self.W.shape[0]:
            raise InputValidationException(
                f"input shape {getattr(X, 'shape', None)} != "
                f"[batch, {self.W.shape[0]}]"
            )
        _check_batch(X, n_data)
        primary = self.mesh.primary
        X = as_tensor(X, torch.float32, primary)
        out = []
        with torch.no_grad():
            for Xr, (parts, b) in zip(X.chunk(n_data), self._rows):
                y = None
                for (lo, hi), w in zip(self._bounds, parts):
                    p = torch.matmul(Xr[:, lo:hi].to(w.device), w)
                    p = p.to(b.device)
                    y = p if y is None else y + p
                y = y + b
                if self.link == "logit":
                    y = 1.0 / (1.0 + torch.exp(-y))
                elif self.link == "softmax":
                    y = softmax(y)
                out.append(y.to(primary))
        return torch.cat(out, dim=0)


def mp_gp(mesh: Mesh, model):
    """Model-parallel GP inference: training instances sharded over the
    ``model`` axis.

    GP scoring is ``μ(x) = k(x, X_train)ᵀ α`` — a [B, N] kernel block
    against N stored instances. Each model slice holds an instance shard
    (its slice of the pre-scaled rows and of α) on its device, computes
    its partial ``k(x, X_shard) @ α_shard``, and the partials are added
    in slice order on the row's first device (the JAX function's
    ``psum``); the batch stays split over the ``data`` axis.
    Squared-exponential kernels only (their ‖x−z‖² matmul expansion is
    what shards cleanly); others raise.

    ``model`` is a :class:`~flink_jpmml_tpu_torch.pmml.ir.GaussianProcessIR`.
    → fn(X f32[B, D]) -> f32[B] with B divisible by the data axis."""
    from flink_jpmml_tpu_torch.compile.gp import gp_prescale
    from flink_jpmml_tpu_torch.pmml import ir
    from flink_jpmml_tpu_torch.utils.exceptions import (
        ModelCompilationException,
    )

    if not isinstance(model, ir.GaussianProcessIR):
        raise ModelCompilationException("mp_gp takes a GaussianProcessIR")
    if model.function_name != "regression":
        raise ModelCompilationException(
            "GaussianProcessModel supports functionName=regression only"
        )
    if model.kernel.kind not in ("radialBasis", "ARDSquaredExponential"):
        raise ModelCompilationException(
            "mp_gp supports the squared-exponential kernels "
            "(radialBasis, ARDSquaredExponential)"
        )
    alpha, lam, Zs, Zs_sq, _ = gp_prescale(model)
    N, D = Zs.shape
    inv_lam = (1.0 / lam).astype(np.float32)
    gamma = float(model.kernel.gamma)

    n_model = mesh.shape[MODEL_AXIS]
    pad = (-N) % n_model
    if pad:
        # zero-α padding rows contribute exactly 0 to the sum
        Zs = np.concatenate([Zs, np.zeros((pad, D), np.float32)])
        Zs_sq = np.concatenate([Zs_sq, np.zeros((pad,), np.float32)])
        alpha = np.concatenate([alpha, np.zeros((pad,))])
    alpha32 = alpha.astype(np.float32)
    bounds = _slices(N + pad, n_model)
    n_data = mesh.shape[DATA_AXIS]
    primary = mesh.primary

    # commit the constant params to their slices' devices ONCE — per-call
    # host arrays would re-transfer the whole training matrix every batch
    host = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (alpha32, Zs, Zs_sq)]
    placed: dict = {}
    rows = []
    for r in range(n_data):
        devs = tuple(physical(d) for d in mesh.row(r))
        if devs not in placed:
            placed[devs] = [
                tuple(a[lo:hi].to(d) for a in host) + (
                    torch.from_numpy(inv_lam).to(d),)
                for (lo, hi), d in zip(bounds, devs)
            ]
        rows.append((devs[0], placed[devs]))

    def predict(X):
        _check_batch(X, n_data)
        if X.shape[1] != D:
            raise InputValidationException(
                f"feature dim {X.shape[1]} != model inputs {D}"
            )
        X = as_tensor(X, torch.float32, primary)
        out = []
        with torch.no_grad():
            for Xr, (first, shards) in zip(X.chunk(n_data), rows):
                total = None
                for alpha_s, Zs_s, Zssq_s, il in shards:
                    xs = Xr.to(il.device) * il[None, :]
                    cross = torch.matmul(xs, Zs_s.T)  # [B, N/m]
                    d2 = torch.clamp(
                        (xs ** 2).sum(dim=1, keepdim=True)
                        + Zssq_s[None, :] - 2.0 * cross, min=0.0)
                    part = torch.matmul(gamma * torch.exp(-0.5 * d2),
                                        alpha_s).to(first)
                    total = part if total is None else total + part
                out.append(total.to(primary))
        return torch.cat(out, dim=0)

    return predict
