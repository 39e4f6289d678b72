"""Latency attribution: the per-batch stage ledger.

The port's copy of ``flink_jpmml_tpu/obs/attr.py``, with the import
lines renamed and its notes on the project's history cut.
``dispatch_profile`` and ``_scorer_flops_per_record`` are left out: they
feed the sampled device profiler (``obs/profiler.py``), which the port
does not have yet, and no caller needs them without it. The ``device``
stage is that profiler's to book, so the port books the other eight. On
the card, ``h2d`` is the host-side staging plus the issue of the
asynchronous copy and launch; the device's own time shows up as
``readback`` (the score thread waiting on the oldest dispatch) and
``queue_wait`` (a launch waiting for a window slot).

Batch latency says how long batches took but not WHERE the time went.
This module is the decomposition: every scored batch's wall time splits
into the pipeline stages

    fetch → decode → encode → h2d → queue_wait → device → readback → sink

each recorded into a ``stage_seconds{stage="..."}`` histogram in the
caller's :class:`~flink_jpmml_tpu_torch.utils.metrics.MetricsRegistry`. The
histograms are the SAME mergeable fixed-bucket sketches every other
fleet metric uses, so per-stage attribution aggregates across workers
exactly like the latency quantiles: heartbeats piggyback them, the
supervisor's ``/metrics`` merges them, and ``fjt-top`` renders the
fleet-wide ranked list of which stage to attack next.

Stage semantics (who observes what):

- ``fetch``     — source fetch RPC (kafka consumer, per fetch; on the
                  prefetch sidecar when pipelined ingest is armed);
- ``decode``    — wire → f32 block decode (kafka consumer thread /
                  prefetch sidecar);
- ``prefetch_wait`` — the ring-feeding thread waiting on an EMPTY
                  prefetch handoff queue (runtime/prefetch.py): the
                  residual ingest cost once fetch+decode moved
                  off-thread — if this ranks high, the sidecar is the
                  bottleneck, not the hot path;
- ``encode``    — host featurize+align on the dispatch path
                  (``dispatch_quantized``; ≈0 when the encode is fused
                  on-device);
- ``h2d``       — host-side staging + async dispatch issue;
- ``queue_wait``— a ready batch waiting for an in-flight window slot
                  (``OverlappedDispatcher.launch`` on a full window);
- ``device``    — SAMPLED pure device execution time (the profiler's
                  block-until-ready delta pair, obs/profiler.py — a
                  sampled distribution, not every batch);
- ``readback``  — host blocked fetching results (``finish_oldest`` /
                  ``wait``);
- ``sink``      — sink delivery (block pipelines' ``_complete``).

**Exemplars**: an observation landing at (or above) the highest bucket
a stage has ever filled gets a trace id attached — recorded as a
``latency_exemplar`` flight-recorder event (with the active span file,
if tracing) and exported on the ``_bucket`` line of
OpenMetrics-negotiated ``/metrics`` scrapes (classic 0.0.4 scrapes
stay suffix-free: that format does not admit exemplars) — so a p99
scrape links directly to the postmortem context of the batch that
caused it. With a record-journey context active on the thread
(``obs/trace.py``), the exemplar id IS the journey's trace id and the
capture marks the journey kept.

**Stall events**: with a deadline configured (``FJT_SLO_TARGET_MS``), a
``queue_wait`` observation beyond ``FJT_SLO_STALL_FRAC`` (default 0.5)
of it records a ``stage_stall`` flight event (rate-limited: the flight
ring is for rare events).

Steady-state cost with nothing special happening: one dict lookup, one
``bisect``, one locked histogram increment per stage per batch — the
perf-smoke observability-overhead tripwire holds the total under 2% of
hand-loop throughput.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Dict, Optional

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.obs import spans
from flink_jpmml_tpu_torch.obs import trace as trace_mod
from flink_jpmml_tpu_torch.utils.metrics import Histogram, MetricsRegistry

STAGES = (
    "fetch", "decode", "prefetch_wait", "encode", "h2d",
    "queue_wait", "device", "readback", "sink",
)

# which thread each stage is observed on — rendered as the fjt-top
# stage table's thread column so an operator reading a pipelined-ingest
# profile knows which stages burn SIDECAR time (overlapped with
# scoring; runtime/prefetch.py moves fetch/decode there) vs hot-path
# time. "ingest" = the source-facing thread: the prefetch sidecar when
# one is armed, the pipeline's own ingest thread otherwise.
STAGE_THREADS = {
    "fetch": "ingest",
    "decode": "ingest",
    "prefetch_wait": "ring-feed",  # hot path waiting on the handoff
    "encode": "score",
    "h2d": "score",
    "queue_wait": "score",
    "device": "device",
    "readback": "score",
    "sink": "score",
}

_STALL_MS_ENV = "FJT_SLO_TARGET_MS"
_STALL_FRAC_ENV = "FJT_SLO_STALL_FRAC"
_EXEMPLAR_MIN_PERIOD_S = 1.0  # repeat top-bucket exemplars at most 1/s
# a steady stream landing in the SAME top bucket re-checks the clock
# only every this-many hits: the common hot-path outcome (top bucket,
# not due) costs an int compare instead of a time.monotonic() call
_EXEMPLAR_CHECK_EVERY = 32
_STALL_MIN_PERIOD_S = 1.0

_tid_lock = threading.Lock()
_tid_seq = 0


def new_trace_id() -> str:
    """Process-unique trace id: pid + monotone sequence (hex). Short
    enough to ride every exemplar, unique enough to grep a flight dump
    and a span file for."""
    global _tid_seq
    with _tid_lock:
        _tid_seq += 1
        seq = _tid_seq
    return f"{os.getpid():x}-{seq:x}"


def stage_metric_name(stage: str) -> str:
    """The registry-name convention for the per-stage family (the obs
    server renders the suffix as a real Prometheus label, like
    ``kafka_lag{partition="..."}``)."""
    return f'stage_seconds{{stage="{stage}"}}'


class StageLedger:
    """Per-batch stage attribution into one :class:`MetricsRegistry`.

    One ledger per registry (see :func:`ledger_for`); all methods are
    thread-safe — ingest threads observe ``fetch``/``decode`` while the
    score thread observes the dispatch-side stages.
    """

    def __init__(self, metrics: MetricsRegistry):
        # weak: the _LEDGERS cache is keyed weakly on the registry, and
        # a strong back-reference from the cached VALUE would keep the
        # key alive forever (the documented WeakKeyDictionary caveat) —
        # every ephemeral bench/test registry would leak
        self._metrics_ref = weakref.ref(metrics)
        self._hists: Dict[str, Histogram] = {}
        self._mu = threading.Lock()
        # per-stage exemplar state: [max bucket idx, last capture t,
        # same-bucket hits since the last clock check]
        self._ex_state: Dict[str, list] = {}
        self._last_stall = 0.0
        # deadline config is read once per ledger: the hot path must not
        # hit os.environ per batch
        try:
            ms = float(os.environ.get(_STALL_MS_ENV) or 0.0)
        except ValueError:
            ms = 0.0
        try:
            frac = float(os.environ.get(_STALL_FRAC_ENV) or 0.5)
        except ValueError:
            frac = 0.5
        self._stall_threshold_s = (ms / 1000.0) * frac if ms > 0 else None

    def _hist(self, stage: str) -> Histogram:
        h = self._hists.get(stage)
        if h is None:
            reg = self._metrics_ref()
            if reg is None:  # registry died under a live caller:
                return Histogram()  # absorb the observe, don't cache
            # literal f-string so tools/metrics_lint.py sees the site
            h = reg.histogram(f'stage_seconds{{stage="{stage}"}}')
            self._hists[stage] = h
        return h

    def observe(self, stage: str, seconds: float) -> None:
        """Record one batch's time in ``stage``; captures an exemplar
        when the observation lands in the stage's top-ever bucket and
        a ``stage_stall`` flight event when a ``queue_wait`` crosses
        the configured deadline fraction."""
        h = self._hists.get(stage)
        if h is None:
            h = self._hist(stage)
        idx = h.bucket_index(seconds)
        exemplar = None
        # journey linkage (obs/trace.py): with a record-journey context
        # active on this thread, the exemplar id IS the journey's trace
        # id — the fjt-top exemplar row pivots straight to fjt-trace —
        # and capturing one marks the journey interesting, which is
        # exactly the "top-latency journeys survive tail-sampling"
        # policy (the exemplar path already decides what the tail is)
        jctx = trace_mod.current()
        with self._mu:
            st = self._ex_state.get(stage)
            # st = [max bucket idx seen, last capture t, hits since check]
            if st is None:
                st = self._ex_state[stage] = [-1, 0.0, 0]
            if idx > st[0]:
                st[0] = idx
                st[1] = time.monotonic()
                st[2] = 0
                exemplar = (
                    jctx.trace_id if jctx is not None else new_trace_id()
                )
            elif idx == st[0]:
                # the steady-state outcome for a stage whose tail sits
                # in one bucket: an int compare, no clock read
                st[2] += 1
                if st[2] >= _EXEMPLAR_CHECK_EVERY:
                    st[2] = 0
                    now = time.monotonic()
                    if now - st[1] >= _EXEMPLAR_MIN_PERIOD_S:
                        st[1] = now
                        exemplar = (
                            jctx.trace_id if jctx is not None
                            else new_trace_id()
                        )
        if exemplar is not None and jctx is not None:
            jstore = trace_mod.store_for(self._metrics_ref())
            if jstore is not None:
                jstore.mark(jctx.trace_id, "exemplar")
        if exemplar is not None:
            w = spans.writer()
            flight.record(
                "latency_exemplar",
                trace_id=exemplar,
                stage=stage,
                seconds=round(seconds, 6),
                span_file=(w.path if w is not None else None),
            )
            spans.emit(
                stage + "_exemplar",
                time.monotonic() - seconds,
                seconds,
                trace_id=exemplar,
            )
        h.observe(seconds, exemplar=exemplar)
        if (
            stage == "queue_wait"
            and self._stall_threshold_s is not None
            and seconds > self._stall_threshold_s
        ):
            now = time.monotonic()  # rare path: past the deadline frac
            with self._mu:
                stall_due = now - self._last_stall >= _STALL_MIN_PERIOD_S
                if stall_due:
                    self._last_stall = now
            if stall_due:
                flight.record(
                    "stage_stall",
                    stage=stage,
                    seconds=round(seconds, 6),
                    threshold_s=round(self._stall_threshold_s, 6),
                )


# one ledger per registry, resolved once per dispatch path (cf. the
# _WIRE_COUNTERS pattern in runtime/pipeline.py); weak keys let
# ephemeral bench registries die normally
_LEDGERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_LEDGERS_MU = threading.Lock()


def ledger_for(metrics: Optional[MetricsRegistry]) -> Optional[StageLedger]:
    if metrics is None:
        return None
    led = _LEDGERS.get(metrics)
    if led is None:
        with _LEDGERS_MU:
            led = _LEDGERS.get(metrics)
            if led is None:
                led = _LEDGERS[metrics] = StageLedger(metrics)
    return led


# ---------------------------------------------------------------------------
# Attribution summaries (bench artifacts / fjt-top)
# ---------------------------------------------------------------------------


def summary(struct_or_registry) -> Optional[dict]:
    """Per-stage attribution summary from a metrics struct (or a live
    registry): ``{stage: {n, total_ms, p50_ms, p99_ms, share}}`` with
    ``share`` = this stage's total over all stages' total. None when no
    stage was ever observed (the field stays honest in artifacts)."""
    if isinstance(struct_or_registry, MetricsRegistry):
        struct = struct_or_registry.struct_snapshot()
    else:
        struct = struct_or_registry or {}
    hists = struct.get("histograms") or {}
    out: dict = {}
    total = 0.0
    for stage in STAGES:
        state = hists.get(stage_metric_name(stage))
        if not isinstance(state, dict):
            continue
        try:
            h = Histogram.from_state(state)
        except (KeyError, IndexError, TypeError, ValueError):
            continue
        if h.count() == 0:
            continue
        s = h.sum()
        total += s
        out[stage] = {
            "n": h.count(),
            "total_ms": round(1000.0 * s, 3),
            "p50_ms": round(1000.0 * (h.quantile(0.5) or 0.0), 3),
            "p99_ms": round(1000.0 * (h.quantile(0.99) or 0.0), 3),
        }
    if not out:
        return None
    for stage, row in out.items():
        row["share"] = round((row["total_ms"] / 1000.0) / total, 4) if total else 0.0
    return out


# ---------------------------------------------------------------------------
# Snapshot staleness (fjt-top --watch honesty, fjt-replay frame ages)
# ---------------------------------------------------------------------------


def snapshot_age_s(struct, now: Optional[float] = None) -> Optional[float]:
    """Age of a metrics struct from its OWN capture timestamp (the
    ``ts`` every ``struct_snapshot`` self-reports; a merged struct
    carries its stalest member's). None for pre-``ts`` structs (old
    BENCH artifacts, version-skewed workers) — unknown age, not zero:
    a watch loop re-rendering a wedged source must say 'stale', never
    imply freshness it can't prove."""
    if not isinstance(struct, dict):
        return None
    try:
        ts = float(struct["ts"])
    except (KeyError, TypeError, ValueError):
        return None
    return max(0.0, (time.time() if now is None else now) - ts)


def staleness_tag(
    struct,
    threshold_s: float = 10.0,
    now: Optional[float] = None,
) -> str:
    """Render suffix for a panel title: empty while fresh, a loud
    ``[STALE <age>]`` past ``threshold_s`` — identical numbers from a
    dead source must not keep looking live."""
    age = snapshot_age_s(struct, now=now)
    if age is None or age <= threshold_s:
        return ""
    return f"  [STALE {age:.0f}s]"
