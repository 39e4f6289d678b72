"""Tracing / profiling hooks (SURVEY.md §6 row "Tracing / profiling").

The port's counterpart of ``flink_jpmml_tpu/utils/profiling.py``.
:class:`StageTimer` is a copy; :func:`trace` and :func:`annotate`, which
run on ``jax.profiler`` there, run on ``torch.profiler`` here:

- :func:`trace` — a context manager around ``torch.profiler.profile``
  (CPU and, with a card, CUDA activities) that writes a chrome://tracing
  JSON file into ``log_dir``;
- :class:`StageTimer` — wall-clock accounting per pipeline stage
  (featurize / dispatch / readback / sink), feeding the metrics registry
  so ``snapshot()`` shows where stream time goes;
- :func:`annotate` — a ``record_function`` span, so runtime stages show
  up by name inside a trace.

Not ported: the host-side chrome://tracing spans that ``FJT_TRACE_DIR``
turns on in the JAX package (``obs/spans.py``); they wait for the
journey-tracing slice, and until then :class:`StageTimer` and
:func:`annotate` emit none. Nor ``overlap_stats`` / ``wire_stats``, which
only the JAX package's bench reads.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``log_dir/trace.json``.

    Usage::

        with profiling.trace("/tmp/fjt-trace"):
            pipeline.run_until_exhausted()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span inside a ``torch.profiler`` trace (a cheap no-op when
    nothing is tracing)."""
    with torch.profiler.record_function(name):
        yield


class StageTimer:
    """Per-stage wall-clock accounting into a :class:`MetricsRegistry`.

    Each ``stage(name)`` context adds its elapsed seconds to the counter
    ``stage_<name>_s``; the registry snapshot then shows the share of
    pipeline time per stage.
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics or MetricsRegistry()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.metrics.counter(f"stage_{name}_s").inc(dt)
