"""Device-fault classification: a sick card is not a poison record.

The port of ``flink_jpmml_tpu/runtime/devfault.py``. The hot paths run
this triage FIRST on any dispatch- or readback-time exception, so that a
device fault never sends clean records to the dead-letter queue:

=================  ====================================================
kind               meaning / recovery ladder entry
=================  ====================================================
``device_oom``     the card's allocator refused the batch — bisect the
                   *batch size* (never the records)
``device_error``   a CUDA runtime failure that leaves the context
                   usable — re-dispatch the batch from its host-retained
                   staging copy under the shared full-jitter backoff;
                   persistent streaks trip the circuit breaker
                   (serving/failover.py)
``chip_loss``      the card is gone for this process — escalate with a
                   raise (the supervisor restarts the worker)
``None``           not a device fault: record poison, featurize errors,
                   a failed build, a missing card — the isolation path
                   owns the first two, and the rest are never retried
=================  ====================================================

Where it differs: the JAX classifier matches the XLA runtime error types
and the status markers XLA writes into them. This one reads CUDA's:

- ``device_oom``: ``torch.cuda.OutOfMemoryError``, the injected
  ``InjectedDeviceOOM``, a ``KernelLaunchError`` whose ``cuda_error`` is
  2 (``cudaErrorMemoryAllocation``), or a CUDA error text that says "out
  of memory".
- ``chip_loss``: a *sticky* CUDA error — illegal address (700),
  device-side assert (710), illegal instruction (715), misaligned address
  (716) or launch failure (719), as a ``KernelLaunchError`` code or as
  the "CUDA error: ..." text of a ``RuntimeError`` /
  ``torch.AcceleratorError`` — and the injected ``InjectedChipLoss``.
  After a sticky error the CUDA context is gone: every later call in the
  process fails, so no in-process retry can succeed. A lost context is
  to this process what a lost chip is to the JAX worker, so the port
  maps it to ``chip_loss`` rather than adding a kind the JAX package
  does not have.
- ``device_error``: every other CUDA runtime error (a ``KernelLaunchError``
  at another code, another "CUDA error: ..." text) and the injected
  ``InjectedDeviceError``.
- ``None``: ``KernelBuildError``, ``NativeBuildError``,
  ``DeviceUnavailableError`` and ``NotPortedError`` (a failed build or a
  missing card is never retried and never served elsewhere), and every
  record error.

A kernel's asynchronous error surfaces where the host first waits on it
(``DeviceOutput.synchronize``, the readback), not at the launch: the
readback's exception is what the ladder classifies.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from flink_jpmml_tpu_torch.obs import recorder as flight

KIND_OOM = "device_oom"
KIND_ERROR = "device_error"
KIND_LOST = "chip_loss"
KINDS = (KIND_OOM, KIND_ERROR, KIND_LOST)

# cudaError_t codes
CUDA_OOM_CODES = frozenset((2,))  # cudaErrorMemoryAllocation
# illegal address, assert, illegal instruction, misaligned address,
# launch failure: each leaves the context unusable
CUDA_STICKY_CODES = frozenset((700, 710, 715, 716, 719))

# the runtime's error strings for the sticky codes (lowercased substring
# match on a "CUDA error: ..." message); sticky checks first
_STICKY_MARKERS = (
    "illegal memory access", "device-side assert", "illegal instruction",
    "misaligned address", "unspecified launch failure",
)
_OOM_MARKERS = ("out of memory",)
_CUDA_MARKERS = ("cuda error", "cudaerror", "cuda driver error")


def _kind_from_code(code: int) -> str:
    if code in CUDA_OOM_CODES:
        return KIND_OOM
    if code in CUDA_STICKY_CODES:
        return KIND_LOST
    return KIND_ERROR


def _kind_from_message(msg: str, cuda: bool = False) -> Optional[str]:
    """``cuda``: the type already says the text is the CUDA runtime's
    (``torch.cuda.CudaError`` carries the bare error string)."""
    m = msg.lower()
    if not cuda and not any(marker in m for marker in _CUDA_MARKERS):
        return None
    for marker in _STICKY_MARKERS:
        if marker in m:
            return KIND_LOST
    for marker in _OOM_MARKERS:
        if marker in m:
            return KIND_OOM
    return KIND_ERROR


def classify(exc: BaseException) -> Optional[str]:
    """→ the device-fault kind of ``exc``, or None when it is NOT a
    device fault (record poison, application errors, a failed build, a
    missing card). The one triage call the hot paths make before the
    isolation path may run."""
    import torch

    from flink_jpmml_tpu_torch.compile.qtrees_cuda import KernelLaunchError
    from flink_jpmml_tpu_torch.runtime import faults

    if isinstance(exc, faults.InjectedChipLoss):
        return KIND_LOST
    if isinstance(exc, faults.InjectedDeviceOOM):
        return KIND_OOM
    if isinstance(exc, faults.InjectedDeviceError):
        return KIND_ERROR
    if isinstance(exc, KernelLaunchError):
        code = getattr(exc, "cuda_error", None)
        return KIND_ERROR if code is None else _kind_from_code(int(code))
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return KIND_OOM
    if isinstance(exc, torch.cuda.CudaError):
        return _kind_from_message(str(exc), cuda=True)
    # only the types torch raises CUDA errors as: a RuntimeError subclass
    # of the runtime's own (PoisonIsolationOverflow quotes the error it
    # gave up on) is not one, and the build and availability errors are
    # not RuntimeErrors at all
    accel = getattr(torch, "AcceleratorError", None)
    if type(exc) is RuntimeError or (
            accel is not None and isinstance(exc, accel)):
        return _kind_from_message(str(exc))
    return None


# -- shared fault accounting -------------------------------------------------

_EVENT_MIN_PERIOD_S = 1.0
_note_mu = threading.Lock()
# rate limiter PER KIND: a chatty device_error stream must not
# suppress the first (possibly only) device_oom/chip_loss event
_last_event: dict = {}


def note(metrics, kind: str, model=None, first_off=None, n=None,
         error=None) -> None:
    """Book one observed device fault: the ``device_fault_total{kind}``
    counter plus a rate-limited ``device_fault`` flight event. Shared by
    the block path's failover plane, the record engine and the dynamic
    scorer so the taxonomy cannot drift between them. (The JAX event
    also carries the active journey's trace id; journey tracing is not
    ported.)"""
    if metrics is not None:
        metrics.counter(f'device_fault_total{{kind="{kind}"}}').inc()
    now = time.monotonic()
    due = False
    with _note_mu:
        if now - _last_event.get(kind, 0.0) >= _EVENT_MIN_PERIOD_S:
            _last_event[kind] = now
            due = True
    if due:
        flight.record(
            "device_fault", fault=kind, model=model, first=first_off,
            n=n, error=None if error is None else repr(error),
        )
