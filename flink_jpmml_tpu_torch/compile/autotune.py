"""Learned-cost-model kernel search + on-disk config cache.

The port of ``flink_jpmml_tpu/compile/autotune.py``: the same
predict-then-verify search over the port's own candidate space.

1. **Predict.** A ridge cost model (``compile/costmodel.py``) fit on the
   kernel cost ledger (every profiler sample and every earlier search's
   timings are training rows) ranks the whole candidate space by
   predicted device-s/record.
2. **Verify.** Only the top K (``FJT_SEARCH_TOPK``, default 5) are built
   and timed on the device; the built default is always among them. Every
   timing lands in the ledger with its feature vector, and the search
   refits from it, so the next search ranks with this one's measurements.
3. **Re-search on drift.** The live profiler (``obs/profiler.py``)
   compares sampled device cost with the adopted config's prediction;
   sustained drift clears the fit and this model's cache entry.

With no usable fit (a cold ledger) the search *bootstraps*: it times the
built default, then one candidate per layout, then the other launch
shapes, still at most K.

The space (``candidate_space``) follows the port's backends
(``compile/layouts.py``): on the ``cuda`` backends the kernel's launch
shape ``(threads, chunk_bytes)`` (``qtrees_cuda.launch_shape``; shapes
the card cannot take are left out by the same arithmetic that refuses
them at launch) crossed with the ``ref`` and ``bfs`` walk layouts; on the
torch twin the JAX package's XLA layouts. Then the encode placement:
host-encoded against fused, end to end from raw f32.

What differs from the JAX package:

- Every candidate scores through the scorer's own path:
  ``qtrees_leaf_rows`` at its launch shape on the card, the torch stages
  on the twin; no candidate is the plain version. A failed build or
  launch raises, and a candidate whose output on the sweep's rows is not
  bit-equal to the built default's raises :class:`VariantMismatchError`,
  so nothing that disagrees is ever adopted.
- Candidates are timed with CUDA events on the current stream (best of
  ``repeats`` after a warm call; on the CPU, the host clock): a ``cuda``
  candidate's scoring function (the kernel and its epilogue) on codes
  already on the card, a torch
  candidate from its staged payload (the H2D copy of the packed or plain
  codes, the unpack, the scoring), since packing changes the bytes that
  cross. The encode placement is timed end to end on the host clock.
- The sample is tiled to whole compile batches (the JAX package trims it
  to one), so a caller times the dispatch size it serves.
- The cache is the port's (``utils/cache.py``):
  ``$FJT_AUTOTUNE_CACHE``, else
  ``~/.cache/flink_jpmml_tpu_torch/autotune-<device>.json``; the JAX
  package's ``~/.cache/flink_jpmml_tpu/`` is never read or written. Its
  keys hold the device (``backend_key``). Every entry carries
  ``layouts.SPACE_TAG``; a stale tag or a corrupt file reads as no entry.
- The knobs are the JAX package's: ``FJT_AUTOTUNE_CACHE``,
  ``FJT_AUTOTUNE_DISABLE`` (no cached config or pack plan is read),
  ``FJT_KERNEL_SEARCH_DISABLE`` (the ``ref`` layout's launch shapes
  only) and ``FJT_SEARCH_TOPK``.

``PackPlan`` / ``ensure_pack_plan`` (the multi-tenant zoo's layout
decision, per model *set*) are copies, over the port's cache.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import pathlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile import layouts
from flink_jpmml_tpu_torch.utils.exceptions import FlinkJpmmlTpuError

_CACHE_ENV = "FJT_AUTOTUNE_CACHE"
_CACHE_VERSION = 1
_SEARCH_DISABLE_ENV = "FJT_KERNEL_SEARCH_DISABLE"
_TOPK_ENV = "FJT_SEARCH_TOPK"
_DEFAULT_TOPK = 5
# the launch-shape axis of the cuda space: threads per block × tree-table
# bytes per shared-memory buffer (the default shape is candidate 0)
_THREADS = (64, 128, 256)
_CHUNK_BYTES = (12288, 24576, 49152, 98304)


class VariantMismatchError(FlinkJpmmlTpuError):
    """A kernel variant scored the sweep's rows differently from the
    built default: a defect in the variant, never adopted."""


@dataclass
class TunedConfig:
    """One measured winner: encode placement + kernel variant.

    ``layout`` is the ``compile/layouts.py`` catalogue id; ``threads`` /
    ``chunk_bytes`` the kernel's launch shape (None: its own choice, and
    always None on the torch twin); ``rates`` keeps the per-candidate
    records/s the search observed; ``predicted_s_per_record`` is the cost
    model's prediction for the adopted variant (the live profiler verifies
    it); ``search`` summarizes the predict-then-verify pass; ``space``
    stamps the search-space schema (a mismatched tag reads as no entry);
    ``source`` says where the config came from ("default" | "sweep" |
    "cache")."""

    encode: str = "host"  # "host" | "fused"
    threads: Optional[int] = None
    chunk_bytes: Optional[int] = None
    layout: str = "ref"
    space: str = layouts.SPACE_TAG
    rec_s: Optional[float] = None
    predicted_s_per_record: Optional[float] = None
    rates: Dict[str, float] = dataclasses.field(default_factory=dict)
    search: Optional[dict] = None
    source: str = "default"

    def as_dict(self) -> dict:
        return {
            "encode": self.encode,
            "threads": self.threads,
            "chunk_bytes": self.chunk_bytes,
            "layout": self.layout,
            "space": self.space,
            "rec_s": self.rec_s,
            "predicted_s_per_record": self.predicted_s_per_record,
            "rates": dict(self.rates),
            "search": self.search,
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        enc = d.get("encode")
        layout = d.get("layout")
        return cls(
            encode=enc if enc in ("host", "fused") else "host",
            threads=int(d["threads"]) if d.get("threads") else None,
            chunk_bytes=(
                int(d["chunk_bytes"]) if d.get("chunk_bytes") else None
            ),
            layout=layout if isinstance(layout, str) and layout else "ref",
            # an absent tag must NOT default to the current one, or a
            # winner of an older space would survive the schema bump
            space=str(d.get("space") or ""),
            rec_s=float(d["rec_s"]) if d.get("rec_s") else None,
            predicted_s_per_record=(
                float(d["predicted_s_per_record"])
                if d.get("predicted_s_per_record")
                else None
            ),
            rates={
                str(k): float(v)
                for k, v in (d.get("rates") or {}).items()
                if isinstance(v, (int, float))
            },
            search=d.get("search") if isinstance(d.get("search"), dict)
            else None,
            source=str(d.get("source") or "cache"),
        )


# ---------------------------------------------------------------------------
# On-disk cache
# ---------------------------------------------------------------------------


def cache_path() -> pathlib.Path:
    """``$FJT_AUTOTUNE_CACHE``, else ``autotune-<device>.json`` in the
    port's cache directory, for the current device. The kernel cost
    ledger and the cost model live beside it."""
    p = os.environ.get(_CACHE_ENV)
    if p:
        return pathlib.Path(p)
    from flink_jpmml_tpu_torch.utils import cache

    return pathlib.Path(cache.device_cache_path("autotune"))


@contextlib.contextmanager
def _cache_lock():
    """Exclusive flock over the cache's sidecar lock file: ``store`` and
    ``clear`` are read-modify-write, and ``clear`` is a live trigger (the
    profiler's drift band fires it). No flock (read-only dir) ⇒ proceed
    unlocked; the atomic replace still keeps readers safe."""
    lock = None
    try:
        import fcntl

        path = cache_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        lock = open(f"{path}.lock", "w")
        fcntl.flock(lock, fcntl.LOCK_EX)
    except (ImportError, OSError):
        if lock is not None:
            lock.close()
        lock = None
    try:
        yield
    finally:
        if lock is not None:
            try:
                lock.close()  # closing releases the flock
            except OSError:
                pass


def _load_cache() -> dict:
    """→ the entries dict; {} on ANY problem (missing, corrupt,
    unreadable, wrong schema) — the silent-re-tune contract."""
    try:
        with open(cache_path()) as f:
            data = json.load(f)
        entries = data.get("entries")
        if isinstance(entries, dict):
            return entries
    except (OSError, ValueError, AttributeError):
        pass
    return {}


def lookup(model_hash: str, backend_key: str) -> Optional[TunedConfig]:
    # FJT_AUTOTUNE_DISABLE=1 keeps every scorer on its own choices: a
    # config an earlier run cached must not creep back into an ablation
    if os.environ.get("FJT_AUTOTUNE_DISABLE"):
        return None
    if not model_hash:
        return None
    raw = _load_cache().get(f"{model_hash}|{backend_key}")
    if not isinstance(raw, dict):
        return None
    try:
        cfg = TunedConfig.from_dict(raw)
    except (TypeError, ValueError):
        return None
    if cfg.space != layouts.SPACE_TAG:
        # cached against an older search space: reads as no entry
        return None
    cfg.source = "cache"
    return cfg


def store(model_hash: str, backend_key: str, cfg: TunedConfig) -> None:
    """Read-modify-write with an atomic replace; failures are silent
    (a read-only home dir must not break a sweep)."""
    if not model_hash:
        return
    from flink_jpmml_tpu_torch.utils.diskio import atomic_write_json

    with _cache_lock():
        entries = _load_cache()
        entry = cfg.as_dict()
        entry["ts"] = time.time()
        entries[f"{model_hash}|{backend_key}"] = entry
        atomic_write_json(
            str(cache_path()),
            {"version": _CACHE_VERSION, "entries": entries},
        )


def clear(model_hash: Optional[str] = None) -> None:
    """Drop the whole cache file (or, with ``model_hash``, just that
    model's entries, through the same atomic replace as :func:`store`).
    The profiler's drift band calls it to re-open a model's search."""
    path = cache_path()
    if model_hash is None:
        try:
            os.unlink(path)
        except OSError:
            pass
        return
    from flink_jpmml_tpu_torch.utils.diskio import atomic_write_json

    with _cache_lock():
        entries = {
            k: v for k, v in _load_cache().items()
            if not k.startswith(f"{model_hash}|")
        }
        atomic_write_json(
            str(path), {"version": _CACHE_VERSION, "entries": entries}
        )


def _device_key(device) -> str:
    from flink_jpmml_tpu_torch.utils import cache

    dev = torch.device(device)
    return f"{dev.type}:{cache.device_tag(dev)}"


def backend_key(scorer) -> str:
    """Cache key half that pins where the measurement holds: the device
    type and name, and which scorer backend runs
    (``cuda:NVIDIA_H100_80GB_HBM3:cuda``). A config measured on the card
    does not transfer to the CPU or another card."""
    return f"{_device_key(scorer.device)}:{scorer.backend}"


def platform_of(scorer) -> str:
    """The device half of :func:`backend_key`: what the cost model's
    training rows and fits are scoped by."""
    return _device_key(scorer.device)


# ---------------------------------------------------------------------------
# Cross-model pack plans (the zoo's layout decision, keyed per model SET)
# ---------------------------------------------------------------------------


@dataclass
class PackPlan:
    """One adopted packing partition for a model set.

    ``groups`` are lists of model hashes sharing a packed buffer
    (singleton = solo). Cached per ``(model-set hash, platform)`` — the
    SET hash, not any member's hash: adding or removing a tenant changes
    the set hash, so the stale winner simply misses and the partition
    re-searches."""

    groups: List[List[str]]
    set_hash: str
    pred_s_per_record: Optional[float] = None
    waste: float = 0.0
    space: str = layouts.PACK_SPACE_TAG
    source: str = "search"

    def as_dict(self) -> dict:
        return {
            "kind": "pack_plan",
            "groups": [list(g) for g in self.groups],
            "set_hash": self.set_hash,
            "pred_s_per_record": self.pred_s_per_record,
            "waste": self.waste,
            "space": self.space,
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: dict) -> Optional["PackPlan"]:
        try:
            groups = [
                [str(h) for h in g] for g in d["groups"]
            ]
            return cls(
                groups=groups,
                set_hash=str(d.get("set_hash") or ""),
                pred_s_per_record=(
                    float(d["pred_s_per_record"])
                    if d.get("pred_s_per_record") is not None
                    else None
                ),
                waste=float(d.get("waste") or 0.0),
                # an absent tag must NOT default to the current one (the
                # TunedConfig rule): a pre-packspace entry re-searches
                space=str(d.get("space") or ""),
                source=str(d.get("source") or "cache"),
            )
        except (KeyError, TypeError, ValueError):
            return None


def platform_key() -> str:
    """Pack-plan cache key half: the current device (the card when there
    is one, else the CPU)."""
    return _device_key("cuda" if torch.cuda.is_available() else "cpu")


def model_set_hash(hashes: Sequence[str]) -> str:
    """Stable identity of a model multiset: the pack-plan cache key half
    (a copy of the JAX package's ``packs.model_set_hash``). Sorted, so
    tenant arrival order cannot split the cache."""
    h = hashlib.sha256()
    for mh in sorted(str(x) for x in hashes):
        h.update(mh.encode())
        h.update(b"|")
    return h.hexdigest()[:16]


def _pack_key(set_hash: str, plat: str) -> str:
    return f"packset:{set_hash}|{plat}"


def lookup_pack_plan(
    set_hash: str, plat: Optional[str] = None
) -> Optional[PackPlan]:
    if os.environ.get("FJT_AUTOTUNE_DISABLE"):
        return None
    if not set_hash:
        return None
    raw = _load_cache().get(_pack_key(set_hash, plat or platform_key()))
    if not isinstance(raw, dict):
        return None
    plan = PackPlan.from_dict(raw)
    if plan is None or plan.space != layouts.PACK_SPACE_TAG:
        return None
    plan.source = "cache"
    return plan


def store_pack_plan(plan: PackPlan, plat: Optional[str] = None) -> None:
    """Same read-modify-write + atomic-replace discipline as
    :func:`store`; silent on failure."""
    if not plan.set_hash or os.environ.get("FJT_AUTOTUNE_DISABLE"):
        return
    from flink_jpmml_tpu_torch.utils.diskio import atomic_write_json

    with _cache_lock():
        entries = _load_cache()
        entry = plan.as_dict()
        entry["ts"] = time.time()
        entries[_pack_key(plan.set_hash, plat or platform_key())] = entry
        atomic_write_json(
            str(cache_path()),
            {"version": _CACHE_VERSION, "entries": entries},
        )


def ensure_pack_plan(
    metas: Dict[str, dict], plat: Optional[str] = None
) -> PackPlan:
    """The zoo's layout decision: adopted pack partition for a model
    set, cache-else-search-else-store.

    ``metas`` maps model_hash → packed-shape summary
    (``QuantizedScorer._meta``). The search enumerates
    ``layouts.pack_partitions`` and prices each with
    ``costmodel.pack_partition_cost`` (predicted device-s/record
    inflated by padded waste); the argmin is adopted and persisted under
    the model-SET hash. A cached plan whose member union no longer
    matches the live set reads as no entry."""
    from flink_jpmml_tpu_torch.compile import costmodel
    from flink_jpmml_tpu_torch.obs import recorder as flight

    plat = plat or platform_key()
    set_hash = model_set_hash(list(metas))
    cached = lookup_pack_plan(set_hash, plat)
    if cached is not None:
        members = {h for g in cached.groups for h in g}
        if members == set(metas):
            return cached
    model = costmodel.current_model(platform=plat)
    best = None
    best_cost = math.inf
    best_waste = 0.0
    n_cands = 0
    for part in layouts.pack_partitions(metas):
        n_cands += 1
        cost, waste = costmodel.pack_partition_cost(metas, part, model)
        if cost < best_cost:
            best, best_cost, best_waste = part, cost, waste
    if best is None:  # empty set: degenerate, nothing to pack
        return PackPlan(groups=[], set_hash=set_hash, source="empty")
    plan = PackPlan(
        groups=[list(g) for g in best],
        set_hash=set_hash,
        pred_s_per_record=(
            best_cost if math.isfinite(best_cost) else None
        ),
        waste=best_waste,
        source="search",
    )
    store_pack_plan(plan, plat)
    flight.record(
        "pack_plan_adopted",
        set_hash=set_hash,
        models=len(metas),
        groups=len(plan.groups),
        candidates=n_cands,
        waste=round(best_waste, 4),
        pred_s_per_record=plan.pred_s_per_record,
    )
    return plan


# ---------------------------------------------------------------------------
# Candidate space
# ---------------------------------------------------------------------------


def search_top_k(top_k: Optional[int] = None) -> int:
    if top_k is not None:
        return max(1, int(top_k))
    try:
        return max(1, int(os.environ.get(_TOPK_ENV) or _DEFAULT_TOPK))
    except ValueError:
        return _DEFAULT_TOPK


def _resolved_shape(scorer, threads, chunk_bytes):
    """(threads, chunk_trees) the kernel would launch with; ValueError
    for a shape the card cannot take."""
    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    walk = scorer.params["walk"]
    T, W = int(walk.shape[0]), int(walk.shape[1])
    th, trees, _ = qtrees_cuda.launch_shape(
        len(scorer.wire.fields), T, W, threads, chunk_bytes)
    return th, trees


def candidate_space(scorer, legacy: bool = False) -> List[dict]:
    """Every kernel variant the search may rank for this scorer: (walk
    layout × launch shape) on the ``cuda`` backends, the layout catalogue
    alone on the torch twin. The built default (``ref``, the kernel's own
    launch shape) is always candidate 0. A launch shape the card cannot
    take, or one that resolves to a shape already listed for its layout
    (the default shape first), is left out.
    ``legacy`` restricts to the ``ref`` layout's launch shapes
    (``FJT_KERNEL_SEARCH_DISABLE``)."""
    cands = [{"layout": "ref", "threads": None, "chunk_bytes": None}]
    if scorer._rebuild is None:
        return cands
    if scorer.backend in layouts.CUDA_BACKENDS:
        names = ("ref",) if legacy else layouts.cuda_layouts()
        for layout in names:
            if layout != "ref":
                cands.append(
                    {"layout": layout, "threads": None, "chunk_bytes": None})
            seen = {_resolved_shape(scorer, None, None)}
            for th in _THREADS:
                for cb in _CHUNK_BYTES:
                    try:
                        shape = _resolved_shape(scorer, th, cb)
                    except ValueError:
                        continue
                    if shape in seen:
                        continue
                    seen.add(shape)
                    cands.append(
                        {"layout": layout, "threads": th, "chunk_bytes": cb})
    elif not legacy:
        for layout in layouts.torch_layouts(scorer.wire):
            if layout != "ref":
                cands.append(
                    {"layout": layout, "threads": None, "chunk_bytes": None})
    return cands


def _cand_name(scorer, c: dict) -> str:
    return layouts.variant_id(
        scorer.backend, c["layout"], c["threads"], c["chunk_bytes"]
    )


def _cand_features(scorer, c: dict) -> Dict[str, float]:
    from flink_jpmml_tpu_torch.compile import costmodel

    wire_bytes = float(scorer.wire.bytes_per_record)
    if "wirepack" in (layouts.flags(c["layout"]) or ()):
        wp = layouts.plan_wire_pack(scorer.wire)
        if wp is not None:
            wire_bytes = float(wp.bytes_per_record)
    return costmodel.variant_features(
        costmodel.scorer_meta(scorer), scorer.backend,
        c["layout"], c["threads"], c["chunk_bytes"], wire_bytes=wire_bytes,
    )


def _bootstrap_order(cands: List[dict]) -> List[dict]:
    """Cold-ledger timing order: the default first, then one candidate
    per distinct layout (the kernel's own launch shape where available),
    then the remaining ``ref`` shapes, then everything else — so even a
    K-bounded first search measures every layout family once."""
    first: List[dict] = [cands[0]]
    seen_layouts = {cands[0]["layout"]}
    rest: List[dict] = []
    for c in cands[1:]:
        if c["layout"] not in seen_layouts and (
            c["threads"] is None and c["chunk_bytes"] is None
        ):
            seen_layouts.add(c["layout"])
            first.append(c)
        else:
            rest.append(c)
    rest.sort(key=lambda c: (c["layout"] != "ref",))
    return first + rest


# ---------------------------------------------------------------------------
# Apply / search / sweep
# ---------------------------------------------------------------------------


def _serving_features(scorer, threads, chunk_bytes) -> None:
    """The cost-model feature vector and variant id of what the scorer
    now serves (they ride its dispatch profiles into the ledger)."""
    c = {"layout": scorer.layout, "threads": threads,
         "chunk_bytes": chunk_bytes}
    scorer._cost_feat = _cand_features(scorer, c)
    scorer._cost_variant = _cand_name(scorer, c)


def apply(scorer, cfg: TunedConfig) -> None:
    """Apply a config to a scorer: build and adopt the cached variant when
    it differs from the built default, then set the encode placement (a
    cached "fused" on a scorer without a device stage stays host).

    A variant the scorer cannot take (``build_variant`` → None) leaves the
    default serving, with no prediction shipped for it. The rebuild hook
    is released afterwards: a scorer is tuned at most once, and the hook
    pins the host-side tables."""
    layout = cfg.layout or "ref"
    applied = True
    if layout != "ref" or cfg.threads or cfg.chunk_bytes:
        built = scorer.build_variant(layout, cfg.threads, cfg.chunk_bytes)
        applied = built is not None
        if applied:
            scorer.adopt_variant(built, layout)
    scorer._rebuild = None
    scorer.encode_mode = (
        "fused" if cfg.encode == "fused" and scorer.supports_fused else "host"
    )
    # the feature vector, variant id and prediction describe the variant
    # actually serving: a cached variant that degraded to the default
    # must not train the cost model, or arm the drift band, as if it ran
    threads, chunk = scorer.launch
    _serving_features(scorer, threads, chunk)
    scorer._pred_s_per_record = (
        cfg.predicted_s_per_record if applied else None
    )
    scorer.tuned = cfg


def _time_best(fn, repeats: int, device: torch.device) -> float:
    """Best-of seconds of ``fn()`` after one unmeasured warm call: CUDA
    events around each call on the current stream on the card, the host
    clock on the CPU (where the work is synchronous)."""
    fn()
    best = math.inf
    for _ in range(max(1, repeats)):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            dt = t0.elapsed_time(t1) / 1e3
        else:
            s = time.perf_counter()
            fn()
            dt = time.perf_counter() - s
        best = min(best, dt)
    return best


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _variant_search(
    scorer,
    Xq: np.ndarray,
    repeats: int,
    budget_s: float,
    t_start: float,
    rates: Dict[str, float],
    top_k: Optional[int] = None,
):
    """Predict-then-verify over the candidate space → (winning candidate
    dict, predicted s/record for it, search summary).

    Ranks every candidate by the ledger-fit cost model when one exists
    (bootstrap order otherwise), times at most K on the device, holds
    each one's output to the built default's bit for bit, adopts the
    measured winner, and feeds every timing back into the ledger as a
    (features → device-s/record) training row."""
    from flink_jpmml_tpu_torch.compile import costmodel
    from flink_jpmml_tpu_torch.obs import attr
    from flink_jpmml_tpu_torch.obs import profiler as prof_mod

    legacy = bool(os.environ.get(_SEARCH_DISABLE_ENV))
    cands = candidate_space(scorer, legacy=legacy)
    K = search_top_k(top_k)
    feats = {_cand_name(scorer, c): _cand_features(scorer, c) for c in cands}
    platform = platform_of(scorer)
    model = None if legacy else costmodel.current_model(platform=platform)
    predictions: Dict[str, float] = {}
    if model is not None:
        ranked = model.rank(feats)
        predictions = {
            n: round(p, 12) for n, p in ranked if math.isfinite(p)
        }
        by_name = {_cand_name(scorer, c): c for c in cands}
        order = [by_name[n] for n, _ in ranked]
        # the built default is always verified, mispredicted or not: a
        # bad fit must never adopt a variant slower than a default it
        # never measured
        order = [cands[0]] + [c for c in order if c is not cands[0]]
        mode = "learned"
    else:
        order = _bootstrap_order(cands)
        mode = "legacy" if legacy else "bootstrap"

    dev = scorer.device
    bs = Xq.shape[0]
    codes = torch.from_numpy(np.ascontiguousarray(Xq)).to(dev)
    ops_rec = attr._scorer_flops_per_record(scorer)
    ledger = prof_mod.KernelCostLedger(flush_interval_s=math.inf)
    default_fn, default_params = scorer._fn, scorer.params
    default_wp = scorer._wire_pack
    with torch.no_grad():
        ref_out = default_fn(default_params, codes)
    best_rate, best_cand, best_built = -1.0, cands[0], None
    timed = 0
    for c in order:
        if timed >= K:
            break
        if time.perf_counter() - t_start > budget_s and timed:
            break
        name = _cand_name(scorer, c)
        is_default = c is cands[0]
        if is_default:
            built = None
            params, fn, wp = default_params, default_fn, default_wp
        else:
            built = scorer.build_variant(
                c["layout"], c["threads"], c["chunk_bytes"])
            if built is None:
                continue  # ineligible here
            params, fn, wp = built["params"], built["fn"], built["wire_pack"]
        if scorer.backend in layouts.CUDA_BACKENDS:
            payload = None

            def run(fn=fn, params=params):
                return fn(params, codes)
        else:
            # the torch twin from its staged payload: packing changes
            # what crosses the bus
            payload = torch.from_numpy(
                np.ascontiguousarray(wp.pack(Xq) if wp is not None else Xq))
            if dev.type == "cuda":
                payload = payload.pin_memory()
            unpack = wp.unpack_stage() if wp is not None else None

            def run(fn=fn, params=params, payload=payload, unpack=unpack):
                x = payload.to(dev, non_blocking=True)
                return fn(params, unpack(x) if unpack is not None else x)
        with torch.no_grad():
            out = run()
            if not _same(out, ref_out):
                raise VariantMismatchError(
                    f"kernel variant {name} disagrees with the built "
                    f"default on the sweep's {bs} rows")
            dt = _time_best(run, repeats, dev)
        timed += 1
        rates[name] = round(bs / dt, 1)
        staged = (payload.element_size() * payload.shape[1]
                  if payload is not None else Xq.dtype.itemsize * Xq.shape[1])
        ledger.update(
            scorer.model_hash, scorer.backend, dt, bs, ops_rec,
            float(staged) + attr._output_bytes_per_record(scorer),
            variant=name, features=feats[name],
            predicted=predictions.get(name), platform=platform,
        )
        if bs / dt > best_rate:
            best_rate, best_cand, best_built = bs / dt, c, built
    if best_built is not None:
        scorer.adopt_variant(best_built, best_cand["layout"])
    ledger.flush()
    # refit from the ledger (now with this search's rows) and persist,
    # so the NEXT search predicts from these measurements
    refit = costmodel.fit_from_ledger(platform=platform)
    best_name = _cand_name(scorer, best_cand)
    # predicted-vs-measured residual over the verified candidates
    resid = None
    checked = [
        (predictions[n], 1.0 / rates[n])
        for n in rates
        if n in predictions and rates.get(n)
    ]
    if checked:
        ratios = [
            abs(math.log(max(p, 1e-18) / max(obs, 1e-18)))
            for p, obs in checked
        ]
        resid = round(sum(ratios) / len(ratios), 4)
    search_info = {
        "space": layouts.SPACE_TAG,
        "mode": mode,
        "candidates_total": len(cands),
        "timed": timed,
        "top_k": K,
        "rows": int(bs),
        "chosen": best_name,
        "predicted": predictions or None,
        "pred_abs_log_err": resid,
        "model": (refit or model).stats if (refit or model) else None,
    }
    return best_cand, predictions.get(best_name), search_info


def sweep(
    scorer,
    X_sample: np.ndarray,
    repeats: int = 2,
    budget_s: float = 30.0,
    top_k: Optional[int] = None,
) -> TunedConfig:
    """Search the kernel-variant space and measure the encode placement
    on this scorer's device; adopt the winner.

    ``X_sample`` is a raw f32 feature batch, tiled to whole compile
    batches (at least one), so every candidate times the same dispatch
    shape. Returns the applied :class:`TunedConfig` (``source="sweep"``)
    with per-candidate rates in ``rates`` and the predict-then-verify
    summary in ``search``."""
    t_start = time.perf_counter()
    X = np.ascontiguousarray(np.asarray(X_sample, np.float32))
    bs = scorer.batch_size or X.shape[0]
    rows = max(bs, -(-X.shape[0] // bs) * bs)
    if X.shape[0] != rows:
        reps = -(-rows // X.shape[0])
        X = np.ascontiguousarray(np.tile(X, (reps, 1))[:rows])
    rates: Dict[str, float] = {}
    chosen = {"layout": "ref", "threads": None, "chunk_bytes": None}
    predicted = None
    search_info = None

    # -- kernel-variant search (host-encoded codes) ------------------------
    if scorer._rebuild is not None:
        chosen, predicted, search_info = _variant_search(
            scorer, scorer.wire.encode(X), repeats, budget_s, t_start, rates,
            top_k
        )
    # tuned once: release the rebuild hook (see apply())
    scorer._rebuild = None

    # -- encode placement (end to end from raw f32 on the host) ------------
    def _sync():
        if scorer.device.type == "cuda":
            torch.cuda.current_stream(scorer.device).synchronize()

    def _host():
        scorer.predict_padded(
            *scorer.pad_wire(scorer.pack_wire(scorer.wire.encode(X))))
        _sync()

    def _fused():
        scorer.predict_fused_padded(*scorer.pad_f32(X))
        _sync()

    def _wall(fn):
        fn()
        best = math.inf
        for _ in range(max(1, repeats)):
            s = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - s)
        return best

    rates["encode_host"] = round(rows / _wall(_host), 1)
    encode = "host"
    if scorer.supports_fused:
        rates["encode_fused"] = round(rows / _wall(_fused), 1)
        if rates["encode_fused"] > rates["encode_host"]:
            encode = "fused"

    cfg = TunedConfig(
        encode=encode,
        threads=chosen["threads"],
        chunk_bytes=chosen["chunk_bytes"],
        layout=scorer.layout,
        rec_s=rates.get(f"encode_{encode}"),
        predicted_s_per_record=predicted,
        rates=rates,
        search=search_info,
        source="sweep",
    )
    scorer.encode_mode = encode
    _serving_features(scorer, chosen["threads"], chosen["chunk_bytes"])
    # the chosen candidate IS the serving variant (the search adopted it),
    # so its prediction is the one the live band verifies
    scorer._pred_s_per_record = predicted
    scorer.tuned = cfg
    return cfg


def ensure_tuned(
    scorer,
    X_sample: np.ndarray,
    repeats: int = 2,
    use_cache: bool = True,
    budget_s: float = 30.0,
    top_k: Optional[int] = None,
) -> TunedConfig:
    """The warmup entry point: cache hit → apply it; miss → search and
    persist the winner. Always returns the config now in force."""
    from flink_jpmml_tpu_torch.obs import recorder as flight

    key = backend_key(scorer)
    if use_cache:
        cfg = lookup(scorer.model_hash, key)
        if cfg is not None:
            apply(scorer, cfg)
            flight.record(
                "autotune_decision", source="cache", backend=key,
                model_hash=scorer.model_hash, encode=cfg.encode,
                threads=cfg.threads, chunk_bytes=cfg.chunk_bytes,
                layout=cfg.layout,
            )
            return cfg
    cfg = sweep(
        scorer, X_sample, repeats=repeats, budget_s=budget_s, top_k=top_k
    )
    store(scorer.model_hash, key, cfg)
    flight.record(
        "autotune_decision", source="sweep", backend=key,
        model_hash=scorer.model_hash, encode=cfg.encode,
        threads=cfg.threads, chunk_bytes=cfg.chunk_bytes, layout=cfg.layout,
        rec_s=cfg.rec_s,
        timed=(cfg.search or {}).get("timed"),
        candidates=(cfg.search or {}).get("candidates_total"),
    )
    return cfg
