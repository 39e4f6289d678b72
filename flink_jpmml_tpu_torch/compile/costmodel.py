"""Learned kernel cost model: predict device-s/record, verify top-K.

The port of ``flink_jpmml_tpu/compile/costmodel.py``. The kernel search
(``compile/autotune.py``) ranks its whole candidate space with a cheap
ridge regressor over analytic features, fit on the kernel cost ledger
(``obs/profiler.py``: every profiler sample and every earlier search's
timings are (features → observed device-s/record) pairs), and times only
the top K on the device.

The fit is closed-form ridge in log space (device costs span orders of
magnitude across backends and launch shapes; relative error is what
ranking needs), standardized features, numpy only — a copy of the JAX
package's ``CostModel``, ``fit``, ``predict``, ``rank``, ``save`` /
``load``, ``training_rows``, ``fit_from_ledger``, ``current_model`` and
``mark_stale``, and of the pack pricing (``pack_dispatch_overhead_s``,
``FJT_PACK_DISPATCH_OVERHEAD_S``; ``pack_partition_cost``).

What differs:

- :func:`variant_features` describes the port's candidates. For the
  ``cuda`` backends: the kernel's launch shape as it resolves
  (``qtrees_cuda.launch_shape``: threads per block, trees per
  shared-memory chunk), the walk layout, and the model's T, depth, C and
  F; for the torch twin, its layout flags. Model-shape features (trees,
  depth, leaves, fields, batch, wire bytes) are the JAX package's.
- The fit persists in the port's cache beside the autotune cache
  (``cost_model-<device>.json``, ``utils/cache.device_tag``), stamped
  with the platform its rows came from (``"cuda:<card>"`` or
  ``"cpu:cpu"``); a fit from another platform reads as none.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

_MIN_ROWS = 6  # below this a fit would memorize noise; search bootstraps
_RIDGE_L2 = 1e-2
_FIT_MAX_AGE_S = 60.0  # per-process fit cache: sweeps within a minute reuse

# feature vocabulary: every row is a {name: float} dict; fit/predict
# align on the sorted union so old ledger rows with fewer features stay
# usable (missing → 0.0)
_LAYOUT_FLAGS = ("bfs", "wirepack")


def model_path() -> str:
    """``cost_model-<device>.json`` beside the autotune cache (the
    kernel cost ledger lives there too)."""
    from flink_jpmml_tpu_torch.compile import autotune
    from flink_jpmml_tpu_torch.utils import cache

    return str(autotune.cache_path().parent
               / f"cost_model-{cache.device_tag()}.json")


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------


def _log2(x: float) -> float:
    return math.log2(max(float(x), 1.0))


def variant_features(
    meta: Dict[str, float],
    backend: str,
    layout: str,
    threads: Optional[int],
    chunk_bytes: Optional[int],
    wire_bytes: Optional[float] = None,
) -> Dict[str, float]:
    """Analytic feature dict for one (model, kernel-variant) pair.

    ``meta`` is the scorer's packed-shape summary
    (``QuantizedScorer._meta``: trees/splits/leaves/fields/batch/
    dtype_rank/classes). Model-shape features make the fit transfer
    across models of the same family; variant features are what the
    search ranks over. A ``cuda`` candidate's launch shape enters as it
    resolves on this model (``qtrees_cuda.launch_shape``), so the kernel's
    own choice and an explicit shape equal to it read alike."""
    from flink_jpmml_tpu_torch.compile import layouts, qtrees_cuda

    meta = meta or {}
    fl = layouts.flags(layout) or frozenset()
    trees = meta.get("trees", 0.0)
    splits = meta.get("splits", 0.0)
    leaves = meta.get("leaves", 0.0)
    fields = meta.get("fields", 0.0)
    classes = meta.get("classes", 1.0)
    cuda = backend in layouts.CUDA_BACKENDS
    out = {
        "log2_trees": _log2(trees),
        # split-slot count is 2^depth − 1 for dense trees: log2(S+1)
        # IS the tree depth
        "depth": _log2(splits + 1.0),
        "log2_leaves": _log2(leaves),
        "log2_fields": _log2(fields),
        "log2_batch": _log2(meta.get("batch", 0.0)),
        "dtype_rank": float(meta.get("dtype_rank", 1.0)),
        "log2_wire_bytes": _log2(
            wire_bytes if wire_bytes is not None else fields
        ),
        "classes": float(classes),
        "backend_cuda": 1.0 if cuda else 0.0,
        "classification": float(meta.get("classification", 0.0)),
        "log2_threads": 0.0,
        "log2_chunk_trees": 0.0,
    }
    if cuda and trees >= 1 and fields >= 1:
        words = qtrees_cuda.walk_words(int(splits), int(leaves),
                                       max(int(classes), 1))
        try:
            th, chunk_trees, _ = qtrees_cuda.launch_shape(
                int(fields), int(trees), words, threads, chunk_bytes)
        except ValueError:
            th, chunk_trees = threads or 0, 0
        out["log2_threads"] = _log2(th)
        out["log2_chunk_trees"] = _log2(chunk_trees)
    for f in _LAYOUT_FLAGS:
        out[f"layout_{f}"] = 1.0 if f in fl else 0.0
    return out


def scorer_meta(scorer) -> Dict[str, float]:
    """The scorer's model-shape features (falls back to {} for foreign
    scorer objects — rows without features are skipped at fit time)."""
    return dict(getattr(scorer, "_meta", None) or {})


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class CostModel:
    """Ridge regression log(device-s/record) ~ features."""

    def __init__(
        self,
        names: List[str],
        weights: np.ndarray,
        bias: float,
        mean: np.ndarray,
        std: np.ndarray,
        stats: Optional[dict] = None,
    ):
        self.names = list(names)
        self.weights = np.asarray(weights, np.float64)
        self.bias = float(bias)
        self.mean = np.asarray(mean, np.float64)
        self.std = np.asarray(std, np.float64)
        self.stats = dict(stats or {})

    # -- fitting ----------------------------------------------------------

    @classmethod
    def fit(
        cls,
        rows: Iterable[Tuple[Dict[str, float], float]],
        l2: float = _RIDGE_L2,
    ) -> Optional["CostModel"]:
        """rows of (feature dict, observed device-s/record) → a fitted
        model, or None when there is nothing usable to fit."""
        feats: List[Dict[str, float]] = []
        ys: List[float] = []
        for f, y in rows:
            if not isinstance(f, dict) or not f:
                continue
            try:
                y = float(y)
            except (TypeError, ValueError):
                continue
            if not (y > 0 and math.isfinite(y)):
                continue
            feats.append(f)
            ys.append(math.log(y))
        if not feats:
            return None
        names = sorted({k for f in feats for k in f})
        X = np.asarray(
            [[float(f.get(k, 0.0)) for k in names] for f in feats],
            np.float64,
        )
        y = np.asarray(ys, np.float64)
        mean = X.mean(axis=0)
        std = X.std(axis=0)
        std[std < 1e-9] = 1.0
        Xs = (X - mean) / std
        n, d = Xs.shape
        A = Xs.T @ Xs + l2 * max(n, 1) * np.eye(d)
        try:
            w = np.linalg.solve(A, Xs.T @ (y - y.mean()))
        except np.linalg.LinAlgError:
            return None
        pred = Xs @ w + y.mean()
        resid = y - pred
        ss_tot = float(((y - y.mean()) ** 2).sum())
        stats = {
            "rows": int(n),
            "mae_log": round(float(np.abs(resid).mean()), 4),
            "r2": round(1.0 - float((resid ** 2).sum()) / ss_tot, 4)
            if ss_tot > 0
            else None,
            "ts": time.time(),
        }
        return cls(names, w, float(y.mean()), mean, std, stats)

    # -- prediction -------------------------------------------------------

    def predict(self, features: Dict[str, float]) -> Optional[float]:
        """→ predicted device-s/record, or None on a degenerate input."""
        try:
            x = np.asarray(
                [float(features.get(k, 0.0)) for k in self.names],
                np.float64,
            )
            z = float(((x - self.mean) / self.std) @ self.weights + self.bias)
        except (TypeError, ValueError):
            return None
        if not math.isfinite(z):
            return None
        return math.exp(min(z, 50.0))  # clamp: exp overflow → inf ranking

    def rank(
        self, candidates: Dict[str, Dict[str, float]]
    ) -> List[Tuple[str, float]]:
        """{name: features} → [(name, predicted)] ascending predicted
        cost; unpredictable candidates sink to the tail."""
        preds = []
        for name, f in candidates.items():
            p = self.predict(f)
            preds.append((name, p if p is not None else math.inf))
        preds.sort(key=lambda t: t[1])
        return preds

    # -- persistence ------------------------------------------------------

    def as_dict(self) -> dict:
        return {
            "version": 1,
            "names": self.names,
            "weights": self.weights.tolist(),
            "bias": self.bias,
            "mean": self.mean.tolist(),
            "std": self.std.tolist(),
            "stats": self.stats,
        }

    @classmethod
    def from_dict(cls, d: dict) -> Optional["CostModel"]:
        try:
            names = list(d["names"])
            w = np.asarray(d["weights"], np.float64)
            mean = np.asarray(d["mean"], np.float64)
            std = np.asarray(d["std"], np.float64)
            if not (len(names) == w.size == mean.size == std.size):
                return None
            return cls(
                names, w, float(d["bias"]), mean, std, d.get("stats")
            )
        except (KeyError, TypeError, ValueError):
            return None


# ---------------------------------------------------------------------------
# Cross-model pack pricing (the zoo layout search's cost axis)
# ---------------------------------------------------------------------------

# per-dispatch host+launch overhead the pack amortizes: the quantity
# packing exists to defeat. Overridable for hosts whose measured launch
# cost differs.
_PACK_OVERHEAD_ENV = "FJT_PACK_DISPATCH_OVERHEAD_S"
_PACK_OVERHEAD_DEFAULT_S = 5e-4
# relative weight of padded waste in the ranking: waste is wasted
# bytes staged AND wasted rows scored, so it prices like a throughput
# multiplier on the compute term
_PACK_WASTE_WEIGHT = 0.5


def pack_dispatch_overhead_s() -> float:
    try:
        v = float(
            os.environ.get(_PACK_OVERHEAD_ENV) or _PACK_OVERHEAD_DEFAULT_S
        )
        return v if v > 0 and math.isfinite(v) else _PACK_OVERHEAD_DEFAULT_S
    except ValueError:
        return _PACK_OVERHEAD_DEFAULT_S


def _member_compute_s(meta: Dict[str, float], model) -> float:
    """Predicted device seconds for one member's full batch-B slot —
    the learned fit when one exists for this platform, else an analytic
    bytes-proportional proxy (enough to ORDER partitions; absolute
    scale cancels against the shared overhead term only, which is why
    the proxy's constant matters and is conservative)."""
    meta = meta or {}
    b = max(float(meta.get("batch", 0.0)), 1.0)
    if model is not None:
        f = variant_features(meta, "torch", "ref", None, None)
        p = model.predict(f)
        if p is not None and math.isfinite(p) and p > 0:
            return p * b
    # proxy: einsum work ~ B * T * L; ~1e9 tiny-gather ops/s
    work = b * max(meta.get("trees", 1.0), 1.0) * max(
        meta.get("leaves", 1.0), 1.0
    )
    return work / 1e9


def pack_partition_cost(
    metas: Dict[str, Dict[str, float]],
    partition,
    model: Optional[CostModel] = None,
    overhead_s: Optional[float] = None,
) -> Tuple[float, float]:
    """Price one packing partition → ``(pred_s_per_record, waste)``.

    One scoring round dispatches every group once with full slots:
    round time = Σ_groups (dispatch overhead + Σ_members member
    compute), records = Σ_members B. Packing moves the overhead term
    from per-model to per-group while padded waste inflates the compute
    term. The returned cost is the ranking key of
    :func:`flink_jpmml_tpu_torch.compile.autotune.ensure_pack_plan`."""
    from flink_jpmml_tpu_torch.compile import layouts

    ov = pack_dispatch_overhead_s() if overhead_s is None else overhead_s
    total_s = 0.0
    total_records = 0.0
    for group in partition:
        total_s += ov
        for h in group:
            m = metas.get(h) or {}
            total_s += _member_compute_s(m, model)
            total_records += max(float(m.get("batch", 0.0)), 1.0)
    waste = layouts.pack_pad_waste(metas, partition)
    if total_records <= 0:
        return math.inf, waste
    s_per_record = total_s / total_records
    return s_per_record * (1.0 + _PACK_WASTE_WEIGHT * waste), waste


def _current_platform() -> str:
    from flink_jpmml_tpu_torch.obs import profiler

    return profiler._platform()


def save(model: CostModel, path: Optional[str] = None,
         platform: Optional[str] = None) -> None:
    """Atomic persist (``utils/diskio``); failures silent — a read-only
    cache dir must not break a sweep. The file is stamped with the
    platform its training rows came from (default: the current device):
    a CPU fit must never rank the card's search (see :func:`load`)."""
    from flink_jpmml_tpu_torch.utils.diskio import atomic_write_json

    d = model.as_dict()
    d["platform"] = platform or _current_platform()
    atomic_write_json(path or model_path(), d)


def load(
    path: Optional[str] = None, platform: Optional[str] = None
) -> Optional[CostModel]:
    """→ the persisted model; None on ANY problem (missing, corrupt,
    wrong schema) — the silent-refit contract. With ``platform``, a
    fit persisted on a DIFFERENT platform also reads as None."""
    try:
        with open(path or model_path()) as f:
            d = json.load(f)
        if platform is not None and d.get("platform") not in (
            None, platform
        ):
            return None
        return CostModel.from_dict(d)
    except (OSError, ValueError, AttributeError):
        return None


# ---------------------------------------------------------------------------
# Ledger replay + the per-process fit cache
# ---------------------------------------------------------------------------


def training_rows(
    path: Optional[str] = None, platform: Optional[str] = None
) -> List[Tuple[Dict[str, float], float]]:
    """(features, observed device-s/record) pairs replayed from the
    kernel cost ledger. Rows without features are skipped; ``platform``
    filters to measurements of one platform (CPU timings must not train
    the card's fit)."""
    from flink_jpmml_tpu_torch.obs import profiler

    rows: List[Tuple[Dict[str, float], float]] = []
    for e in profiler.read_ledger(path).values():
        f = e.get("features")
        y = e.get("device_s_per_record")
        if not isinstance(f, dict) or not f:
            continue
        if platform is not None and e.get("platform") not in (None, platform):
            continue
        rows.append((f, y))
    return rows


_mu = threading.Lock()
_generation = 0
_cached: Optional[Tuple[int, float, Optional[CostModel], Optional[str]]] = None


def generation() -> int:
    with _mu:
        return _generation


def mark_stale(reason: str = "") -> None:
    """Invalidate every cached fit (the drift-band hook: observed
    device cost left the prediction band for good) — the next search
    refits from the ledger instead of trusting the stale fit."""
    global _generation, _cached
    from flink_jpmml_tpu_torch.obs import recorder as flight

    with _mu:
        _generation += 1
        _cached = None
    try:
        # the persisted fit is what went stale: drop it so a fresh
        # process can't resurrect it before the refit
        os.unlink(model_path())
    except OSError:
        pass
    flight.record("costmodel_stale", reason=reason or None)


def fit_from_ledger(
    path: Optional[str] = None,
    min_rows: int = _MIN_ROWS,
    platform: Optional[str] = None,
    persist: bool = True,
) -> Optional[CostModel]:
    """Fit (and persist) a model from the ledger; None when the ledger
    holds fewer than ``min_rows`` usable rows — the search bootstraps
    by timing a heuristic subset instead."""
    global _cached
    rows = training_rows(path, platform=platform)
    if len(rows) < max(1, min_rows):
        return None
    model = CostModel.fit(rows)
    if model is not None and persist and path is None:
        save(model, platform=platform)
        # refresh the per-process cache too: a search that just fed
        # the ledger must hand its refit to the NEXT search even
        # within the cache age window
        with _mu:
            _cached = (_generation, time.monotonic(), model, platform)
    return model


def current_model(
    min_rows: int = _MIN_ROWS, platform: Optional[str] = None
) -> Optional[CostModel]:
    """The per-process fit for ``platform``, refit from the ledger when
    the cache is cold, aged out, made for another platform, or
    invalidated by :func:`mark_stale`."""
    global _cached
    now = time.monotonic()
    with _mu:
        gen = _generation
        if _cached is not None:
            cgen, cts, cmodel, cplat = _cached
            # a cached None is never authoritative — the ledger may
            # have grown since (each search feeds it); only a real fit
            # is worth the cache
            if cmodel is not None and cgen == gen and cplat == platform and (
                now - cts < _FIT_MAX_AGE_S
            ):
                return cmodel
    model = fit_from_ledger(min_rows=min_rows, platform=platform)
    if model is None:
        # a prior process's persisted fit — only if it was trained on
        # THIS platform (the file is stamped at save time)
        model = load(platform=platform or _current_platform())
    with _mu:
        if _generation == gen:
            _cached = (gen, now, model, platform)
    return model
