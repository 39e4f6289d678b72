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
  its last H2D copy has fired. Only a dispatch's live rows cross the bus:
  the zero rows that align it to whole compile batches are written on
  the card;
- a ``non_blocking`` D2H copy into a fresh pinned buffer queued at
  dispatch, and an event behind it (:class:`DeviceOutput`): readiness is
  ``event.query()``, the wait is ``event.synchronize()``.

Semantics kept from the JAX package: completions happen strictly in launch
order (FIFO, for in-order sink delivery and contiguous offset commits);
at most ``depth`` dispatches stay in flight after ``launch`` returns
(``depth=None``: unbounded); errors surface where the host blocks;
``close()`` flushes (``close(drain=False)`` abandons). The handle API
the dynamic scorer needs is the JAX package's too: ``launch`` returns an
:class:`InFlight` handle, ``wait(handle)`` finishes entries in FIFO order
up to it, ``abandon()`` drops the window. So is its ``on_error`` hook
(a failed completion goes to the block pipeline's recovery ladder or
suspect scan instead of raising) and its fault-injection sites:
``dispatch`` and ``device_dispatch`` before each launch,
``device_readback`` inside the wait, so that an injected device fault
takes the path a real one takes. So are its ``accounted=False``
launches: the admission controller's shed entries ride the window only
for their FIFO offset commit — they launch no kernel, fire no device
fault site, and count in neither ``dispatches`` nor
``window_full_launches``. So is its sampled device profiler
(``obs/profiler.py``; ``profiler=``, ``profiling``, ``launch(profile=)``),
on CUDA events instead of a drained window and a blocking bracket: a
launch the profiler picks runs its dispatch inside
``profiler.open_sample()``, the scorer marks the region the kernel search
times (on the ``cuda`` backends the walk kernel and its epilogue, after
the H2D copy and the encode stage and before the D2H copy), and the pair
of events is read when the entry completes, after the wait the window
makes anyway. No synchronize is added. On the CPU the marks read the
host clock.

Metrics: ``h2d_stall_s`` (host time blocked on device work),
``dispatches``, ``window_full_launches``, the ``inflight_depth`` gauge,
and from :func:`dispatch_quantized` ``encode_s`` / ``h2d_bytes`` /
``encode_host`` / ``encode_fused``.

Stage ledger (``obs/attr.py``, ``stage_seconds{stage=...}``), booked
where the JAX package books it, with host clocks around calls that are
already there — no stage adds a ``torch.cuda.synchronize()`` or an
event wait:

- ``encode``: the host encode and alignment in :func:`dispatch_quantized`
  (≈ 0 fused);
- ``h2d``: the copy into pinned staging plus the issue of the
  asynchronous H2D copy, the kernel launch and the D2H copy. On the card
  this is host time; the copy itself runs later on the stream. On the
  CPU the work is synchronous, so it includes the scoring;
- ``queue_wait``: :meth:`OverlappedDispatcher.launch` waiting on the
  oldest dispatch of a full window;
- ``readback``: :meth:`OverlappedDispatcher.finish_oldest` waiting on
  the oldest dispatch otherwise (a flush, the close).

The card's own time therefore shows up in ``queue_wait`` and
``readback``: the host waits there for the events behind the queued
work.

Spans (``obs/spans.py``, with ``FJT_TRACE_DIR`` set), where the JAX
package emits them: ``featurize`` and ``h2d_dispatch`` in
:func:`dispatch_quantized` (the ``encode`` and ``h2d`` intervals above,
host time: ``h2d_dispatch`` is the staging plus the issue, not the copy)
and ``readback`` around every wait on the oldest entry (the window's
depth in its args). Each carries the active journey context's ids.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile import prepare
from flink_jpmml_tpu_torch.compile.layouts import CUDA_BACKENDS
from flink_jpmml_tpu_torch.obs import attr as attr_mod
from flink_jpmml_tpu_torch.obs import drift as drift_mod
from flink_jpmml_tpu_torch.obs import profiler as prof_mod
from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.obs import spans
from flink_jpmml_tpu_torch.runtime import faults
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

    ``stage(payload, rows)`` copies a numpy batch into the next buffer
    and queues its ``non_blocking`` copy into the head of a device tensor
    of ``rows`` rows on the current stream; the rows past the payload are
    zeroed there, so alignment padding never crosses the bus. Before
    refilling a buffer it waits for the event recorded behind that
    buffer's previous H2D copy, so a copy in flight is never overwritten.
    A buffer is kept while it holds the payload, so a stream of deadline
    drains of varying length reuses it. ``slots`` must exceed the
    dispatch window's depth for staging to overlap device work."""

    def __init__(self, device: torch.device, slots: int = 3):
        self._device = device
        self._slots = [None] * max(1, slots)  # (buffer, event) per slot
        self._next = 0

    def stage(self, payload: np.ndarray, rows: int,
              mark: bool = False,
              span: Optional["LaunchSpan"] = None) -> torch.Tensor:
        """→ the device tensor the payload is copied into; ``mark`` opens
        a sampled dispatch's region (``obs/profiler.mark_start``) and
        ``span`` starts (:meth:`LaunchSpan.start`) just before the H2D
        copy."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        held = self._slots[i]
        src = torch.from_numpy(np.ascontiguousarray(payload))
        n = src.shape[0]
        if held is not None:
            held[1].synchronize()  # its last H2D copy has landed
        if (held is None or held[0].shape[0] < n
                or held[0].shape[1:] != src.shape[1:]
                or held[0].dtype != src.dtype):
            buf = torch.empty((rows,) + tuple(src.shape[1:]),
                              dtype=src.dtype, pin_memory=True)
        else:
            buf = held[0]
        buf[:n].copy_(src)
        dev = torch.empty((rows,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=self._device)
        if mark:
            prof_mod.mark_start(self._device)
        if span is not None:
            span.start()
        dev[:n].copy_(buf[:n], non_blocking=True)
        if rows > n:
            dev[n:].zero_()
        ev = torch.cuda.Event()
        ev.record()
        self._slots[i] = (buf, ev)
        return dev


class LaunchSpan:
    """One dispatch's time from its first device operation to its
    completion, read after the wait the window makes anyway (no
    synchronize is added). On the card: a pair of timing events on the
    current stream, the first recorded by :meth:`start` just before the
    dispatch's H2D copy (``HostStaging.stage``, ``dispatch_f32``), the
    second by :meth:`close` once the launch has queued its D2H copy — the
    card's time for the dispatch, without the host work in front of it
    (featurize, encode on the host, staging) or behind it (the waits and
    decodes of other groups). On the CPU, where a dispatch completes
    inside its launch: the host time from the span's creation (just
    before the launch) to :meth:`close`."""

    __slots__ = ("_device", "_start", "_end")

    def __init__(self, device: torch.device):
        self._device = device
        self._start = time.monotonic() if device.type != "cuda" else None
        self._end = None

    def start(self) -> None:
        if self._device.type == "cuda" and self._start is None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()

    def close(self) -> None:
        if self._device.type != "cuda":
            self._end = time.monotonic()
            return
        self.start()  # a dispatch that staged nothing: from here
        self._end = torch.cuda.Event(enable_timing=True)
        self._end.record()

    def seconds(self) -> float:
        if self._device.type != "cuda":
            return self._end - self._start
        self._end.synchronize()  # behind the D2H copy the wait saw land
        return self._start.elapsed_time(self._end) / 1e3


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


def device_output(out, staged: Optional[torch.Tensor] = None
                  ) -> DeviceOutput:
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
    state=None,
    state_keys=None,
    offsets=None,
    span: Optional[LaunchSpan] = None,
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

    A batch that is not whole compile batches is aligned with zero rows
    up to K of them (``pad_f32`` / ``pad_wire`` on the CPU); on the card
    only its live rows are staged and the zero rows are written there.

    ``state`` (a ``runtime/state.KeyedStateTable``) arms the keyed state
    stage, as in the JAX package: the host routes the batch's keys to
    slots (``state_keys``: precomputed uint32 key hashes; default: hash
    the table's key column of ``X``; ``offsets``: the records' offsets,
    the decay clock and the exactly-once replay guard), the state step
    follows the scorer on the same stream, the table commits the new
    values, and the result becomes ``(out, derived[rows, 8])`` (callers
    unwrap it with ``state.split_output``). Alignment rows route to the
    scratch slot with weight 0.

    ``metrics`` books ``encode_s`` (host encode time, ≈ 0 fused),
    ``h2d_bytes`` (bytes staged per dispatch: F codes of the wire dtype a
    live record host-encoded, 4·F fused) and ``encode_<placement>`` (dispatches
    per placement), and the ``encode`` and ``h2d`` stages of its stage
    ledger (see the module docstring).

    The data-drift plane (``obs/drift.py``) profiles the caller's raw
    batch here, as in the JAX package: before either placement encodes
    or stages it (so the sampled rows are the caller's rows) and outside
    the encode timing window. Unarmed (``FJT_DRIFT_SAMPLE`` unset and no
    plane installed on ``metrics``) that is one dict miss and one env
    lookup.

    ``span`` (a :class:`LaunchSpan`) starts at the H2D copy of the staged
    payload."""
    dplane = drift_mod.plane_for(metrics)
    if dplane is not None:
        dplane.record_features(q, X, M)
    t0 = time.monotonic()
    placement = q.encode_placement
    if placement == "fused":
        payload = np.ascontiguousarray(X, np.float32)
        if M is not None and np.asarray(M).any():
            payload = np.where(M, np.float32(np.nan), payload)
        pad, predict = q.pad_f32, q.predict_fused_padded
    else:
        # the active wire pack (a wirepack layout) packs what ships
        payload = q.pack_wire(q.wire.encode(X, M))
        pad, predict = q.pad_wire, q.predict_padded
    n, bs = payload.shape[0], q.batch_size
    rows = n if bs is None else -(-n // bs) * bs
    K = rows // bs if bs else 1
    t1 = time.monotonic()
    spans.emit("featurize", t0, t1 - t0, fused=placement == "fused")
    ledger = attr_mod.ledger_for(metrics)
    if metrics is not None:
        metrics.counter("encode_s").inc(t1 - t0)
        metrics.counter("h2d_bytes").inc(payload.nbytes)
        metrics.counter(f"encode_{placement}").inc()
        ledger.observe("encode", t1 - t0)
    # a sampled dispatch's region is what the kernel search times for
    # the serving variant (obs/profiler.py): the torch twin's opens at
    # its payload's copy; behind a fused encode the search timed no such
    # copy, so that sample trains no cost-model row
    torch_twin = q.backend not in CUDA_BACKENDS
    marks = prof_mod.active_sample()
    if marks is not None and torch_twin and placement == "fused":
        marks.sweep_region = False
    if state is not None:
        predict = _state_armed(q, X, n, rows, placement, state, state_keys,
                               offsets)
    if q.device.type != "cuda":
        out = device_output(predict(*pad(payload)))
    elif staging is None:
        raise ValueError("a CUDA dispatch needs a HostStaging")
    else:
        staged = staging.stage(
            payload, rows, mark=torch_twin and placement != "fused",
            span=span)
        out = device_output(predict(staged, K), staged)
    t2 = time.monotonic()
    spans.emit("h2d_dispatch", t1, t2 - t1, bytes=payload.nbytes)
    if ledger is not None:
        ledger.observe("h2d", t2 - t1)
    return out


def _state_armed(q, X, n: int, rows: int, placement: str, state,
                 state_keys, offsets):
    """Host slot routing for one state-armed dispatch (one vectorized
    pass, as the JAX package's) → the dispatch's ``predict`` in its
    state-armed form, which scores, steps the table and commits."""
    khash = (
        np.asarray(state_keys, np.uint32) if state_keys is not None
        else state.hash_keys(state.extract_keys(X))
    )
    offs = np.asarray(offsets, np.int64) if offsets is not None else None
    first = (int(offs[0]) if offs is not None and offs.size
             else state.applied_hi)
    state.maybe_renorm(first)
    slots, reset, rel, w = state.assign_slots(khash, offs)
    pad = rows - n
    if pad > 0:
        # alignment rows ride the scratch slot with zero weight: by
        # construction they cannot touch any key's state
        slots = np.concatenate(
            [slots, np.full(pad, state.scratch, np.int32)])
        reset = np.concatenate([reset, np.zeros(pad, bool)])
        rel = np.concatenate([rel, np.zeros(pad, np.float32)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    predict_state = (q.predict_fused_padded_state if placement == "fused"
                     else q.predict_padded_state)

    def predict(payload, K):
        out, derived, S2 = predict_state(payload, K, state, slots, rel, w,
                                         reset)
        state.commit(S2)
        return out, derived

    return predict


def dispatch_f32(model, X, M, *, metrics: Optional[MetricsRegistry] = None,
                 span: Optional[LaunchSpan] = None) -> DeviceOutput:
    """The f32 path's dispatch of one ``(X, M)`` batch through a
    :class:`~flink_jpmml_tpu_torch.compile.compiler.CompiledModel` (or a
    mesh-sharded ``parallel/sharding.ShardedModel``): pad it to the
    compile batch when shorter, copy X and M to the model's device and
    queue the model there; on the card a D2H copy of the result is queued
    behind it on the current stream. A sharded model's data axis must
    divide the dispatch, and a degraded-mesh rebuild can leave a divisor
    that no longer divides the batch, so the pad target rounds up to it
    (a single-device model, divisor 1, keeps the pad-to-batch geometry).
    ``metrics`` books the bytes shipped (``h2d_bytes``: X and M, padding
    rows included); ``span`` starts at the H2D copy of X."""
    target = max(model.batch_size or 0, X.shape[0])
    target += (-target) % getattr(model, "batch_divisor", 1)
    if X.shape[0] < target:
        X, M, _ = prepare.pad_batch(X, M, target)
    if metrics is not None:
        metrics.counter("h2d_bytes").inc(X.nbytes + M.nbytes)
    if span is not None:
        span.start()
    Xs = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
        model.device, non_blocking=True)
    Ms = torch.from_numpy(np.ascontiguousarray(M)).to(
        model.device, non_blocking=True)
    # a sampled dispatch's region: the model's own device work
    prof_mod.mark_start(model.device)
    out = model.predict(Xs, Ms)
    prof_mod.mark_stop(model.device)
    return device_output(out, Xs)


class DispatcherClosed(FlinkJpmmlTpuError):
    """launch() after close(): the window is shut down."""


class InFlight:
    """One launched dispatch: its result (a :class:`DeviceOutput`) and the
    caller's metadata. ``done`` means the entry left the window; ``error``
    carries the wait's failure when it left poisoned, so a later
    :meth:`OverlappedDispatcher.wait` re-raises it instead of handing back
    a result that never completed. ``accounted`` is False for a shed
    entry, which launched nothing."""

    __slots__ = ("out", "meta", "done", "error", "accounted", "sample")

    def __init__(self, out: Any, meta: Any, accounted: bool = True):
        self.out = out
        self.meta = meta
        self.done = False
        self.error: Optional[BaseException] = None
        self.accounted = accounted
        # (dispatch profile, SampleMarks) when the profiler picked this
        # launch
        self.sample = None


def _ready(out) -> bool:
    """Readiness of a window entry's result (None: a shed no-op)."""
    return out is None or out.ready()


def _synchronize(out) -> None:
    if out is not None:
        out.synchronize()


class OverlappedDispatcher:
    """Bounded FIFO window of in-flight device dispatches.

    A result is anything with ``ready()`` and ``synchronize()`` (a
    :class:`DeviceOutput`). ``complete(result, meta)`` (optional) runs on
    the launching thread for every finished entry, in launch order — the
    block pipeline hangs sink delivery and offset commit on it.
    ``launch`` returns the entry's :class:`InFlight` handle, and
    ``finish_oldest`` / ``wait`` also return finished results, for callers
    (the dynamic scorer) that prefer pull-style completion. ``depth`` =
    dispatches allowed to remain in flight after ``launch`` returns (0 =
    synchronous; None = unbounded: ``launch`` never blocks, for callers
    whose own contract forbids blocking in ``submit`` — they bound the
    window themselves through ``wait``).

    ``on_error(out, meta, exc) -> bool`` (optional) runs on the launching
    thread when finishing an entry raised an ``Exception``: True means
    handled — the complete-callback is skipped and the caller's loop goes
    on; False re-raises. The block pipelines hang the device-fault ladder
    and poison isolation on it.

    ``profiler`` (default: the registry's, ``obs/profiler.profiler_for``)
    is the sampled device profiler that launches with a ``profile`` feed
    (see the module docstring)."""

    def __init__(
        self,
        depth: Optional[int] = 2,
        metrics: Optional[MetricsRegistry] = None,
        complete: Optional[Callable[[Any, Any], None]] = None,
        on_error: Optional[Callable[[Any, Any, Exception], bool]] = None,
        profiler: Optional["prof_mod.DeviceProfiler"] = None,
    ):
        self._depth = None if depth is None else max(0, int(depth))
        self._window: "deque[InFlight]" = deque()
        self._complete = complete
        self._on_error = on_error
        self._closed = False
        self.metrics = metrics or MetricsRegistry()
        self._stall = self.metrics.counter("h2d_stall_s")
        self._dispatches = self.metrics.counter("dispatches")
        self._window_full = self.metrics.counter("window_full_launches")
        self._gauge = self.metrics.gauge("inflight_depth")
        self._ledger = attr_mod.ledger_for(self.metrics)
        self._profiler = (
            profiler if profiler is not None
            else prof_mod.profiler_for(self.metrics)
        )

    def __len__(self) -> int:
        return len(self._window)

    @property
    def profiling(self) -> bool:
        """True when launches should build a dispatch profile — a sampled
        device profiler is attached and not disabled — so call sites skip
        the per-launch profile when ``FJT_PROF_SAMPLE`` is off."""
        p = self._profiler
        return p is not None and p.enabled

    def launch(self, dispatch_fn: Callable[[], Any], meta: Any = None,
               accounted: bool = True,
               profile: Optional[dict] = None) -> InFlight:
        """Dispatch (``dispatch_fn()`` must queue device work and return
        without waiting on it) and admit the result to the window; if that
        overflows ``depth``, finish the oldest entry first — the only
        place a healthy steady state blocks. ``window_full_launches``
        counts the launches whose oldest entry was still running. The
        wait books ``queue_wait``; at depth 0 the host waits on its own
        just-launched batch, and that is ``readback``. → the entry's
        handle.

        ``accounted=False`` keeps this entry out of the ``dispatches``
        and window-full counters: the admission controller's shed no-ops
        (``dispatch_fn`` returns None, no kernel) ride the window only for
        their FIFO offset commit — counting them as dispatches would
        dilute the pressure monitor's window-full fraction exactly while
        the shed rate is highest, flapping the gate open mid-overload.

        ``profile`` (:func:`obs.attr.dispatch_profile`) opts this launch
        into the sampled device-timing pool: when the profiler's rate
        limiter picks it, the dispatch runs with its region marked
        (``obs/profiler.open_sample``), read when the entry completes."""
        if self._closed:
            raise DispatcherClosed("launch() on a closed dispatcher")
        # dispatch delay + launch-time device-fault injection: one global
        # load + None check each when no faults are configured; a fault
        # raised here propagates to the caller's direct-dispatch handler
        faults.fire("dispatch")
        faults.fire("device_dispatch")
        prof = self._profiler
        sampling = (accounted and profile is not None and prof is not None
                    and prof.should_sample())
        if sampling:
            marks = prof_mod.open_sample()
            try:
                out = dispatch_fn()
            finally:
                prof_mod.close_sample()
            handle = InFlight(out, meta, accounted=accounted)
            handle.sample = (profile, marks)
        else:
            handle = InFlight(dispatch_fn(), meta, accounted=accounted)
        self._window.append(handle)
        if accounted:
            self._dispatches.inc()
        depth = self._depth
        if depth is not None:
            if (accounted and 0 < depth < len(self._window)
                    and not _ready(self._window[0].out)):
                self._window_full.inc()
            while len(self._window) > depth:
                self.finish_oldest(
                    _stage="queue_wait" if depth > 0 else "readback"
                )
        self._gauge.set(len(self._window))
        return handle

    def finish_oldest(self, _stage: str = "readback"):
        """Wait for the oldest entry and run the complete-callback →
        ``(result, meta)``, or None when the window is empty. ``_stage``
        is the ledger stage the wait is booked under; the callback books
        its own (``sink``), so no interval lands in two stages."""
        if not self._window:
            return None
        handle = self._window[0]
        depth = len(self._window)
        t0 = time.monotonic()
        error: Optional[BaseException] = None
        try:
            # readback-time device-fault injection, inside the same try
            # as the real wait: an injected fault takes the real path;
            # a shed no-op launched nothing and is skipped
            if handle.accounted:
                faults.fire("device_readback")
            _synchronize(handle.out)
        except BaseException as e:
            handle.error = e
            error = e
        finally:
            # stall time counts even when the wait raised; the entry
            # leaves the window either way, so one poisoned batch cannot
            # wedge every later flush
            dt = time.monotonic() - t0
            self._stall.inc(dt)
            # the in-flight window on the trace: how long the host sat
            # on the oldest dispatch, and how deep the window was
            spans.emit("readback", t0, dt, inflight=depth)
            self._ledger.observe(_stage, dt)
            self._window.popleft()
            handle.done = True
            self._gauge.set(len(self._window))
        if error is not None:
            if (
                self._on_error is not None
                and isinstance(error, Exception)
                and self._on_error(handle.out, handle.meta, error)
            ):
                # handled (recovered, or isolated to the DLQ): the
                # handler owns delivery and commit
                return None
            raise error
        self._record_sample(handle)
        if self._complete is not None:
            self._complete(handle.out, handle.meta)
        return handle.out, handle.meta

    def wait(self, handle: InFlight) -> Any:
        """Finish entries in FIFO order until ``handle`` is done → its
        result, completed. A handle whose wait failed re-raises its error
        on every wait; one the window no longer holds (dropped by
        :meth:`abandon`) is waited on directly, never handed back
        unfinished."""
        while not handle.done and self._window:
            self.finish_oldest()
        if not handle.done:
            t0 = time.monotonic()
            try:
                if handle.accounted:
                    faults.fire("device_readback")
                _synchronize(handle.out)
            except BaseException as e:
                handle.error = e
                raise
            finally:
                dt = time.monotonic() - t0
                self._stall.inc(dt)
                self._ledger.observe("readback", dt)
                handle.done = True
            if handle.error is None:
                self._record_sample(handle)
        if handle.error is not None:
            raise handle.error
        return handle.out

    def _record_sample(self, handle: InFlight) -> None:
        """Hand a completed sampled entry's region time to the profiler
        (on the card both events have fired: the entry's wait is done).
        The marks cost the pipeline nothing, so no overhead is charged.
        No sample when the dispatch marked no whole region, or marked it
        on another device than its profile's (a host tier scoring in the
        card's stead)."""
        if handle.sample is None:
            return
        profile, marks = handle.sample
        handle.sample = None
        device_s = marks.seconds()
        platform = profile.get("platform")
        if device_s is None or (
                platform and platform.split(":")[0] != marks.device.type):
            return
        if not marks.sweep_region:
            # not what the sweep timed for these features
            profile = {k: v for k, v in profile.items()
                       if k not in ("variant", "features",
                                    "predicted_s_per_record")}
        self._profiler.record_sample(device_s, profile, overhead_s=0.0)

    def flush(self) -> None:
        """Finish everything in flight."""
        while self._window:
            self.finish_oldest()

    def abandon(self) -> int:
        """Drop every in-flight entry without waiting on it → the count
        dropped. A dropped handle stays waitable (:meth:`wait`)."""
        n = len(self._window)
        self._window.clear()
        self._gauge.set(0)
        if n:
            flight.record("dispatch_abandon", dropped=n)
        return n

    def close(self, drain: bool = True) -> None:
        """Flush (default) or abandon, then refuse further launches, and
        write the profiler's cost ledger out. Idempotent."""
        if drain:
            self.flush()
        else:
            self.abandon()
        self._closed = True
        if self._profiler is not None:
            self._profiler.cost_ledger.flush()
