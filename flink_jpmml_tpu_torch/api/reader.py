"""ModelReader: the path-not-model distribution contract (capability C2).

The port's counterpart of ``flink_jpmml_tpu/api/reader.py``. Reference
parity: ``ModelReader(path)`` (SURVEY.md §3 row B3, §4.4 [UNVERIFIED]) —
the PMML document never travels through the job graph; only its *path*
does, and every worker loads it independently. The reader is a tiny
pickleable handle; ``load()`` parses and compiles at the worker, with a
process-level cache so repeated opens (restarts, several pipelines)
compile once — the idempotent-reload property C7 depends on — and the
verify gate: a document whose embedded ModelVerification vectors fail
does not load.

Where it differs from the JAX package:

- ``load`` takes ``device=`` (``utils/device.resolve_device``: the card by
  default, the CPU only on request), and the cache key holds the resolved
  device, so a CPU load and a card load of one path never share a model;
- ``mesh=`` (a ``parallel/mesh.Mesh``) loads the model mesh-sharded
  (``compile_pmml(mesh=)``) on the mesh's primary device; the mesh joins
  the cache key, as the JAX reader keys on its ``jax.sharding.Mesh``.

Remote paths (``http(s)://``, ``gs://``, ``s3://``, ``hdfs://``,
``alluxio://``) resolve through ``api/remote.py`` as in the JAX package:
the bytes are cached in the port's own model cache and revalidated on
each ``load`` (a 304 costs one round trip and no recompile), and the
remote version token (ETag / Last-Modified / generation) takes the
compile-cache slot that a local file's mtime fills, so a changed remote
model recompiles and an unchanged one does not. ``file://`` URIs resolve
to their path.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from flink_jpmml_tpu_torch.api import remote
from flink_jpmml_tpu_torch.compile import CompiledModel, compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.utils.config import CompileConfig
from flink_jpmml_tpu_torch.utils.device import resolve_device
from flink_jpmml_tpu_torch.utils.exceptions import (
    ModelVerificationException,
)

_cache_lock = threading.Lock()
_cache: Dict[Tuple, CompiledModel] = {}
_verified: set = set()  # cache keys whose models passed verification


@dataclass(frozen=True)
class ModelReader:
    path: str

    def load(
        self,
        batch_size: Optional[int] = None,
        config: Optional[CompileConfig] = None,
        warmup: bool = False,
        verify: bool = True,
        mesh=None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> CompiledModel:
        """``verify=True`` (default) replays any embedded
        <ModelVerification> vectors through the compiled model and
        raises :class:`ModelVerificationException` on mismatch — a model
        whose own test vectors fail must not serve (JPMML's
        ``Evaluator.verify()`` contract). Documents without embedded
        vectors load unconditionally. ``device`` picks the card (None,
        the default) or ``"cpu"``; ``mesh`` loads the model mesh-aware —
        batch-sharded over the data axis, wide linear stages
        feature-sharded over the model axis — on the mesh's primary
        device."""
        local_path, token = remote.fetch(self.path)
        if mesh is not None and device is None:
            device = mesh.primary
        dev = resolve_device(device)
        key = (
            self.path if remote.is_remote(self.path)
            else os.path.abspath(local_path),
            token,
            batch_size,
            config,
            dev,
            mesh,  # hashable; None = single-device
        )
        with _cache_lock:
            cached = _cache.get(key)
            cached_verified = key in _verified
        if cached is not None:
            # the cache may hold a model first loaded with verify=False
            # (operator override): a verify=True load must still replay
            # the vectors before handing it out
            if verify and cached.has_verification and not cached_verified:
                self._verify(cached)
                with _cache_lock:
                    _verified.add(key)
            return cached
        doc = parse_pmml_file(local_path)
        model = compile_pmml(
            doc, batch_size=batch_size, config=config, device=dev, mesh=mesh
        )
        if verify and model.has_verification:
            self._verify(model)
        if warmup:
            model.warmup()
        with _cache_lock:
            _cache[key] = model
            if verify:
                _verified.add(key)
        return model

    def _verify(self, model: CompiledModel) -> None:
        problems = model.verify()
        if problems:
            raise ModelVerificationException(
                f"{self.path}: {len(problems)} ModelVerification "
                f"mismatch(es): " + "; ".join(problems[:5])
            )


def clear_model_cache() -> None:
    with _cache_lock:
        _cache.clear()
        _verified.clear()
