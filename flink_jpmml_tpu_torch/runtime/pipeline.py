"""Overlapped host→device dispatch: the depth-K in-flight window on CUDA.

The port of ``flink_jpmml_tpu/runtime/pipeline.py``. While batch N runs
on the card, batch N+1 is drained, rank-encoded (on the host, or by the
device encode stage) and copied to the device; results are read back only when the window is full (or on
flush). Where the JAX package relies on async dispatch,
``copy_to_host_async`` and ``block_until_ready``, the port uses:

- one CUDA stream per pipeline, on which every dispatch's H2D copy,
  kernel and D2H copy are queued in order;
- pinned host staging buffers (:class:`HostStaging`) with ``non_blocking``
  H2D copies; a buffer is refilled only after the event recorded behind
  its last H2D copy has fired;
- a ``non_blocking`` D2H copy into a fresh pinned buffer queued at
  dispatch, and an event behind it (:class:`DeviceOutput`): readiness is
  ``event.query()``, the wait is ``event.synchronize()``.

Semantics kept from the JAX package: completions happen strictly in launch
order (FIFO, for in-order sink delivery and contiguous offset commits);
at most ``depth`` dispatches stay in flight after ``launch`` returns;
errors surface where the host blocks; ``close()`` flushes.

Metrics: ``h2d_stall_s`` (host time blocked on device work),
``dispatches``, ``window_full_launches``, the ``inflight_depth`` gauge,
and from :func:`dispatch_quantized` ``encode_s`` / ``h2d_bytes`` /
``encode_host`` / ``encode_fused``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from flink_jpmml_tpu_torch.utils.exceptions import FlinkJpmmlTpuError
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry


class DeviceOutput:
    """One dispatch's result: host tensor(s) filled by a queued D2H copy,
    and the event behind that copy (None when the work ran on the CPU)."""

    __slots__ = ("host", "event", "_keep")

    def __init__(self, host, event: Optional["torch.cuda.Event"] = None,
                 keep=None):
        self.host = host
        self.event = event
        # device tensors the queued copies read: alive until completion
        self._keep = keep

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def synchronize(self) -> None:
        if self.event is not None:
            self.event.synchronize()
            self._keep = None

    def result(self):
        """→ the host tensor (or tuple of tensors), after the copy."""
        self.synchronize()
        return self.host


class HostStaging:
    """Pinned host buffers for H2D copies, used in rotation.

    ``stage(payload)`` copies a numpy batch into the next buffer and
    queues its ``non_blocking`` copy to the device on the current stream;
    before refilling a buffer it waits for the event recorded behind that
    buffer's previous H2D copy, so a copy in flight is never overwritten.
    ``slots`` must exceed the dispatch window's depth for staging to
    overlap device work."""

    def __init__(self, device: torch.device, slots: int = 3):
        self._device = device
        self._slots = [None] * max(1, slots)  # (buffer, event) per slot
        self._next = 0

    def stage(self, payload: np.ndarray) -> torch.Tensor:
        i = self._next
        self._next = (i + 1) % len(self._slots)
        held = self._slots[i]
        src = torch.from_numpy(np.ascontiguousarray(payload))
        if held is not None:
            held[1].synchronize()  # its last H2D copy has landed
        if held is None or held[0].shape != src.shape or held[0].dtype != src.dtype:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        else:
            buf = held[0]
        buf.copy_(src)
        dev = buf.to(self._device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._slots[i] = (buf, ev)
        return dev


def _to_host(out, keep: list):
    """Queue D2H copies of ``out`` (a tensor, or a tuple / NamedTuple of
    tensors and Nones) into fresh pinned buffers."""
    if out is None:
        return None
    if isinstance(out, tuple):
        parts = [_to_host(o, keep) for o in out]
        return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
    keep.append(out)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    return host


def device_output(out, staged: Optional[torch.Tensor] = None) -> DeviceOutput:
    """Wrap a just-launched result: on the card, queue its D2H copy and an
    event behind it on the current stream (keeping ``staged`` and the
    device result alive until then); on the CPU the result is final."""
    if staged is None or staged.device.type != "cuda":
        return DeviceOutput(out)
    keep = [staged]
    host = _to_host(out, keep)
    done = torch.cuda.Event()
    done.record()
    return DeviceOutput(host, done, keep)


def dispatch_quantized(
    q,
    X,
    M=None,
    *,
    metrics: Optional[MetricsRegistry] = None,
    staging: Optional[HostStaging] = None,
) -> DeviceOutput:
    """Encode + stage + dispatch one raw f32 batch through a
    :class:`~flink_jpmml_tpu_torch.compile.qtrees.QuantizedScorer`: the one
    place the scorer's encode placement (``q.encode_placement``) is
    enacted.

    - ``"host"``: the C++ bucketizer rank-encodes the batch
      (``q.wire.encode``), ``q.pad_wire`` aligns it and the codes ship;
    - ``"fused"``: ``q.pad_f32`` aligns the raw f32 batch, it ships, and
      the device encode stage runs in front of the scorer. The stage knows
      only the NaN convention, so an explicit mask ``M`` folds in as NaN
      first. A scorer asked for ``"fused"`` whose tables exceed the device
      budget stays host-encoded.

    On a CUDA scorer the payload is copied into a pinned buffer of
    ``staging`` (a :class:`HostStaging`; required there) before this
    returns, so ``X`` may be a view of a buffer that the next ring drain
    reuses; the H2D copy, the scorer and the D2H copy of the result queue
    on the current stream. On a CPU scorer the work is done when it
    returns.

    ``metrics`` books ``encode_s`` (host encode + align time, ≈ 0 fused),
    ``h2d_bytes`` (bytes staged per dispatch: F codes of the wire dtype a
    record host-encoded, 4·F fused) and ``encode_<placement>`` (dispatches
    per placement)."""
    t0 = time.monotonic()
    placement = q.encode_placement
    if placement == "fused":
        X = np.asarray(X, np.float32)
        if M is not None and np.asarray(M).any():
            X = np.where(M, np.float32(np.nan), X)
        payload, K = q.pad_f32(X)
        predict = q.predict_fused_padded
    else:
        payload, K = q.pad_wire(q.wire.encode(X, M))
        predict = q.predict_padded
    if metrics is not None:
        metrics.counter("encode_s").inc(time.monotonic() - t0)
        metrics.counter("h2d_bytes").inc(payload.nbytes)
        metrics.counter(f"encode_{placement}").inc()
    if q.device.type != "cuda":
        return device_output(predict(payload, K))
    if staging is None:
        raise ValueError("a CUDA dispatch needs a HostStaging")
    staged = staging.stage(payload)
    return device_output(predict(staged, K), staged)


class DispatcherClosed(FlinkJpmmlTpuError):
    """launch() after close(): the window is shut down."""


class OverlappedDispatcher:
    """Bounded FIFO window of in-flight device dispatches.

    Each entry is a ``(result, meta)`` pair; a result is anything with
    ``ready()`` and ``synchronize()`` (a :class:`DeviceOutput`).
    ``complete(result, meta)`` (optional) runs on the launching thread for
    every finished entry, in launch order — the block pipeline hangs sink
    delivery and offset commit on it. ``depth`` = dispatches allowed to
    remain in flight after ``launch`` returns (0 = synchronous)."""

    def __init__(
        self,
        depth: int = 2,
        metrics: Optional[MetricsRegistry] = None,
        complete: Optional[Callable[[Any, Any], None]] = None,
    ):
        self._depth = max(0, int(depth))
        self._window: "deque[tuple]" = deque()
        self._complete = complete
        self._closed = False
        self.metrics = metrics or MetricsRegistry()
        self._stall = self.metrics.counter("h2d_stall_s")
        self._dispatches = self.metrics.counter("dispatches")
        self._window_full = self.metrics.counter("window_full_launches")
        self._gauge = self.metrics.gauge("inflight_depth")

    def __len__(self) -> int:
        return len(self._window)

    def launch(self, dispatch_fn: Callable[[], Any], meta: Any = None) -> None:
        """Dispatch (``dispatch_fn()`` must queue device work and return
        without waiting on it) and admit the result to the window; if that
        overflows ``depth``, finish the oldest entry first — the only
        place a healthy steady state blocks. ``window_full_launches``
        counts the launches whose oldest entry was still running."""
        if self._closed:
            raise DispatcherClosed("launch() on a closed dispatcher")
        self._window.append((dispatch_fn(), meta))
        self._dispatches.inc()
        if 0 < self._depth < len(self._window) and not self._window[0][0].ready():
            self._window_full.inc()
        while len(self._window) > self._depth:
            self.finish_oldest()
        self._gauge.set(len(self._window))

    def finish_oldest(self) -> None:
        """Wait for the oldest entry and run the complete-callback."""
        if not self._window:
            return
        out, meta = self._window[0]
        t0 = time.monotonic()
        try:
            out.synchronize()
        finally:
            # stall time counts even when the wait raised; the entry
            # leaves the window either way, so one poisoned batch cannot
            # wedge every later flush
            self._stall.inc(time.monotonic() - t0)
            self._window.popleft()
            self._gauge.set(len(self._window))
        if self._complete is not None:
            self._complete(out, meta)

    def flush(self) -> None:
        """Finish everything in flight."""
        while self._window:
            self.finish_oldest()

    def close(self) -> None:
        """Flush, then refuse further launches."""
        self.flush()
        self._closed = True
