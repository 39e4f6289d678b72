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
- remote paths (``http(s)://``, ``gs://``, ``s3://``, ``hdfs://``,
  ``alluxio://``; the JAX package's ``api/remote.py``) and ``mesh=``
  raise :class:`NotPortedError`. A local path's cache token is its mtime,
  as there; ``file://`` URIs resolve to their path.
"""

from __future__ import annotations

import os
import threading
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from flink_jpmml_tpu_torch.compile import CompiledModel, compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.utils.config import CompileConfig
from flink_jpmml_tpu_torch.utils.device import resolve_device
from flink_jpmml_tpu_torch.utils.exceptions import (
    ModelVerificationException,
    NotPortedError,
)

# the JAX package's api/remote.py schemes
_REMOTE_SCHEMES = ("http", "https", "gs", "s3", "hdfs", "alluxio")

_cache_lock = threading.Lock()
_cache: Dict[Tuple, CompiledModel] = {}
_verified: set = set()  # cache keys whose models passed verification


def _local(path: str) -> Tuple[str, str]:
    """→ (local path, version token: its mtime, -1.0 when unreadable)."""
    parts = urllib.parse.urlsplit(path)
    if parts.scheme in _REMOTE_SCHEMES:
        raise NotPortedError(
            f"ModelReader: remote path {path!r} (api/remote.py is not "
            "ported)"
        )
    if parts.scheme == "file":
        path = urllib.request.url2pathname(parts.path)
    try:
        token = os.stat(path).st_mtime
    except OSError:
        token = -1.0
    return path, str(token)


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
        the default) or ``"cpu"``."""
        if mesh is not None:
            raise NotPortedError("ModelReader.load(mesh=...)")
        local_path, token = _local(self.path)
        dev = resolve_device(device)
        key = (os.path.abspath(local_path), token, batch_size, config, dev)
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
            doc, batch_size=batch_size, config=config, device=dev
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
