"""Dead-letter queue: durable quarantine for poison records.

The port's copy of ``flink_jpmml_tpu/runtime/dlq.py``, with the import
lines renamed and one note on the project's history reworded.

At-least-once replay (C7) is also the runtime's sharpest failure
amplifier: a single record that crashes decode or scoring is replayed
from the committed offset on every restart, exhausts the supervisor's
restart budget, and turns one bad byte into a whole-job ``on_give_up``
outage. The delivery-correctness fix is record-level: the hot paths
isolate the offending record (bisection "suspect mode" in
runtime/block.py and runtime/engine.py, crash-loop fingerprinting for
records that kill the process outright), quarantine it HERE, and let
the rest of the stream proceed. A quarantined record never reaches the
sink, the shadow diff, or the watermarks — it is an explicit, bounded,
inspectable drop, not a silent one.

Storage: JSONL segment files (``dlq-<seq>.jsonl``) in a directory that
conventionally sits beside the checkpoints (``<ckpt_dir>/dlq`` — the
pipelines create it there automatically when checkpointing is on).
Durability per append is one line + ``fsync`` on an append-only
segment handle (the directory is fsync'd once per segment creation,
the checkpoint writer's durable-name half): a SIGKILL mid-append can tear
at most the LAST line of the newest segment, which :meth:`scan` skips
— every fsync'd envelope survives, and a decode-poison flood costs
one fsync per record instead of a whole-segment rewrite plus two
(which would cap the ingest thread at a few hundred records/s exactly
when a poisoned producer floods it). Writes are lock-serialized: the
default wiring shares one DLQ between the ingest thread (decode
quarantine) and the score thread (suspect-mode quarantine).

Envelope per quarantined record::

    {"offset": int, "partition": int|None, "payload_b64": str,
     "reason": "score"|"decode"|"crash_loop", "exception": str|None,
     "attempts": int, "fingerprint": sha256-hex-16, "t": unix-s,
     "pid": int, ...extra}

The quarantine paths additionally stamp ``trace_id``/``span_id`` (the
record's journey context, obs/trace.py) into ``extra``: the envelope
is the journey's terminal hop, and ``fjt-dlq redrive`` carries those
ids back into the topic as a ``traceparent`` record header so the
redriven record's new journey segment links the original.

Bounded: at most ``max_records`` envelopes are retained; when a
rotation overflows the budget the OLDEST segments are dropped, counted
in ``dlq_dropped`` and marked with one ``dlq_truncated`` flight event —
a DLQ that silently eats its own tail is a data-loss bug, a DLQ that
grows without bound is a disk-full outage.

Operator surface: the ``fjt-dlq`` CLI (list / inspect / redrive) reads
this layout; redrive produces the payload bytes back into a Kafka topic
(``KafkaClient.produce``) so a corrected pipeline re-scores them
through the live path.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.utils.diskio import atomic_write_json

_SEG_PREFIX = "dlq-"

#: the quarantine reasons the runtime emits (the ``reason`` label on
#: ``dlq_records``); free-form reasons are allowed but these are the
#: documented lifecycle (docs/operations.md "Poison records & DLQ")
REASON_SCORE = "score"        # a scoring/dispatch exception isolated it
REASON_DECODE = "decode"      # wire/record decode rejected the bytes
REASON_CRASH_LOOP = "crash_loop"  # it killed the process; fingerprinted


class PoisonIsolationOverflow(RuntimeError):
    """Suspect-mode isolation found MORE failing records than the
    per-batch quarantine budget (``FJT_DLQ_MAX_PER_BATCH``): that is a
    model- or deployment-level failure wearing a poison-record costume,
    and quarantining a whole stream record-by-record would convert an
    outage into silent mass data loss. The isolation aborts and the
    original error propagates — the worker dies honestly and the
    supervisor's restart/give-up policy takes over."""

    def __init__(self, quarantined: int, original: BaseException):
        super().__init__(
            f"isolation abandoned after {quarantined} quarantines in "
            f"one batch (FJT_DLQ_MAX_PER_BATCH): {original!r}"
        )
        self.original = original


def env_count(name: str, fallback: int) -> int:
    """Non-negative-int env knob (0 allowed — unlike retry.env_int,
    which treats 0 as 'use the fallback')."""
    raw = os.environ.get(name)
    if not raw:
        return fallback
    try:
        v = int(raw)
    except ValueError:
        return fallback
    return v if v >= 0 else fallback


def fingerprint(payload: bytes) -> str:
    """Stable 16-hex-char content fingerprint: the SAME bad bytes
    replayed across restarts land as recognizably the SAME poison
    record, whatever offset or attempt count they carry."""
    return hashlib.sha256(payload).hexdigest()[:16]


def make_envelope(
    payload: bytes,
    offset: int,
    reason: str,
    partition: Optional[int] = None,
    error: Optional[BaseException] = None,
    attempts: int = 1,
    **extra,
) -> dict:
    env = {
        "offset": int(offset),
        "partition": None if partition is None else int(partition),
        "payload_b64": base64.b64encode(bytes(payload)).decode("ascii"),
        "reason": str(reason),
        "exception": (
            f"{type(error).__name__}: {error}" if error is not None
            else None
        ),
        "attempts": int(attempts),
        "fingerprint": fingerprint(bytes(payload)),
        "t": time.time(),
        "pid": os.getpid(),
    }
    env.update(extra)
    return env


def payload_bytes(envelope: dict) -> bytes:
    return base64.b64decode(envelope.get("payload_b64", ""))


def serialize_record(record) -> bytes:
    """Record-object → quarantine payload bytes: JSON when the record
    is JSON-shaped (the engine's dict/list records — redrivable), repr
    otherwise (still inspectable, still fingerprintable)."""
    try:
        return json.dumps(record, sort_keys=True, default=str).encode()
    except (TypeError, ValueError):
        return repr(record).encode()


class DeadLetterQueue:
    """Bounded, durably-persisted quarantine (see module docstring).

    ``metrics`` (optional ``MetricsRegistry``) books one
    ``dlq_records{reason=...}`` count per envelope (fleet merge SUM —
    the aggregate quarantine volume is a real total) and ``dlq_dropped``
    when the retention bound evicts old segments. :meth:`put` is
    thread-safe (one lock): the ingest thread quarantines decode
    poison while the score thread quarantines scoring poison into the
    SAME queue. Two *processes* sharing one directory remain a
    deployment error the segment sequence numbers make visible
    (colliding names), not a supported topology."""

    def __init__(
        self,
        directory: str,
        max_records: int = 65536,
        segment_records: int = 64,
        metrics=None,
    ):
        self._dir = str(directory)
        self._max_records = max(1, int(max_records))
        self._seg_records = max(1, int(segment_records))
        self._metrics = metrics
        os.makedirs(self._dir, exist_ok=True)
        segs = self._segments()
        self._seq = (self._seg_seq(segs[-1]) + 1) if segs else 0
        self._mu = threading.Lock()
        # the open segment's append handle + envelope count
        self._open_f = None
        self._open_n = 0
        self._last_event = 0.0  # flight-event rate limit (1/s)

    @property
    def directory(self) -> str:
        return self._dir

    # -- write side --------------------------------------------------------

    def put(self, envelope: dict) -> dict:
        """Durably quarantine one envelope; → the envelope. Raises
        OSError when the directory cannot be written — a quarantine
        that silently vanishes would let the caller drop the record
        as if it were safely parked."""
        with self._mu:
            self._append_locked(envelope)
            rotated = self._open_n >= self._seg_records
            if rotated:
                try:
                    self._open_f.close()
                except OSError:
                    pass
                self._open_f = None
                self._open_n = 0
                self._seq += 1
        if self._metrics is not None:
            reason = envelope.get("reason", "unknown")
            self._metrics.counter(f'dlq_records{{reason="{reason}"}}').inc()
        # rate-limited (≥1 s apart): a poisoned PRODUCER floods decode
        # errors by the thousand, and the flight ring is a story, not a
        # firehose — exact volume lives in the dlq_records counters
        now = time.monotonic()
        if now - self._last_event >= 1.0:
            self._last_event = now
            flight.record(
                "poison_quarantined",
                offset=envelope.get("offset"),
                partition=envelope.get("partition"),
                reason=envelope.get("reason"),
                fingerprint=envelope.get("fingerprint"),
                exception=envelope.get("exception"),
                # the journey handle (obs/trace.py): callers stamp the
                # record's trace context into the envelope so the
                # quarantine links its journey — and fjt-dlq redrive
                # carries it back into the topic as a traceparent header
                trace_id=envelope.get("trace_id"),
            )
        if rotated:
            self._gc()
        return envelope

    def _append_locked(self, envelope: dict) -> None:
        """One fsync'd line on the append-only open segment (opened —
        and its directory entry fsync'd — on first use)."""
        if self._open_f is None:
            path = self._open_path()
            self._open_f = open(path, "a", encoding="utf-8")
            try:
                dfd = os.open(self._dir, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
        self._open_f.write(json.dumps(envelope, sort_keys=True) + "\n")
        self._open_f.flush()
        os.fsync(self._open_f.fileno())
        self._open_n += 1

    def quarantine(
        self,
        payload: bytes,
        offset: int,
        reason: str,
        partition: Optional[int] = None,
        error: Optional[BaseException] = None,
        attempts: int = 1,
        **extra,
    ) -> dict:
        """Convenience: build the envelope and :meth:`put` it."""
        return self.put(make_envelope(
            payload, offset, reason, partition=partition, error=error,
            attempts=attempts, **extra,
        ))

    def _open_path(self) -> str:
        return os.path.join(
            self._dir, f"{_SEG_PREFIX}{self._seq:012d}.jsonl"
        )

    # -- read side ---------------------------------------------------------

    def scan(self) -> Iterator[dict]:
        """Yield every retained envelope, oldest first. Unparseable
        lines (a SIGKILL-torn trailing append, disk damage) are
        skipped — a corrupt neighbor must not hide the rest."""
        for path in self._segments():
            try:
                with open(path, "r", encoding="utf-8") as f:
                    raw_lines = f.readlines()
            except OSError:
                continue
            for ln in raw_lines:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    env = json.loads(ln)
                except ValueError:
                    continue
                if isinstance(env, dict):
                    yield env

    def count(self) -> int:
        return sum(1 for _ in self.scan())

    def offsets(self) -> List[int]:
        return [
            int(e["offset"]) for e in self.scan()
            if e.get("offset") is not None
        ]

    # -- internals ---------------------------------------------------------

    def _segments(self) -> List[str]:
        try:
            names = sorted(
                n for n in os.listdir(self._dir)
                if n.startswith(_SEG_PREFIX) and n.endswith(".jsonl")
            )
        except OSError:
            return []
        return [os.path.join(self._dir, n) for n in names]

    @staticmethod
    def _seg_seq(path: str) -> int:
        name = os.path.basename(path)
        try:
            return int(name[len(_SEG_PREFIX):-len(".jsonl")])
        except ValueError:
            return 0

    def _gc(self) -> None:
        """Enforce the retention bound at segment granularity: drop the
        OLDEST whole segments once the total would exceed the budget."""
        max_segments = max(1, self._max_records // self._seg_records)
        segs = self._segments()
        drop = segs[:-max_segments] if len(segs) > max_segments else []
        dropped = 0
        for p in drop:
            try:
                with open(p, "r", encoding="utf-8") as f:
                    dropped += sum(1 for ln in f if ln.strip())
            except OSError:
                pass
            try:
                os.unlink(p)
            except OSError:
                pass
        if dropped:
            if self._metrics is not None:
                self._metrics.counter("dlq_dropped").inc(dropped)
            flight.record(
                "dlq_truncated", dropped=dropped,
                max_records=self._max_records,
            )


def dlq_for_checkpoint(checkpoint, metrics=None) -> Optional["DeadLetterQueue"]:
    """The default wiring: a DLQ living BESIDE the checkpoints
    (``<ckpt_dir>/dlq``), so the quarantine survives exactly as long as
    the resume state it protects. → None when ``checkpoint`` is None
    (no durable state → nowhere durable to park poison)."""
    if checkpoint is None:
        return None
    directory = getattr(checkpoint, "directory", None)
    if directory is None:
        return None
    return DeadLetterQueue(os.path.join(directory, "dlq"), metrics=metrics)


# ---------------------------------------------------------------------------
# Crash-loop fingerprint state (suspect markers), shared by the pipelines
# ---------------------------------------------------------------------------

_CRASH_FILE = "crashes.json"
_MARKER_FILE = "suspect-marker.json"


class CrashFingerprint:
    """Worker-side crash-loop bookkeeping in the checkpoint directory.

    Two small atomic files:

    - ``crashes.json`` — ``{"committed": O, "count": k}``: how many
      consecutive incarnations restored at the SAME committed offset.
      ``note_restore(O)`` bumps the count when O is unchanged (the
      previous incarnation died without making progress) and resets it
      otherwise. Together with the supervisor's ``FJT_RESTART_STREAK``
      env (either signal suffices), a count ≥ ``FJT_POISON_RESTARTS``
      flips the pipeline into suspect mode over the checkpoint's
      in-flight offset range.
    - ``suspect-marker.json`` — ``{"lo": o, "hi": o2, "attempts": k}``:
      written BEFORE each suspect-mode dispatch, cleared after it
      completes. An incarnation that finds a marker knows the previous
      one died mid-dispatch of exactly that offset range: the range is
      never re-dispatched whole — it is bisected (one narrowing per
      death), and a single-record marker is quarantined WITHOUT being
      dispatched at all, converting a process-killing record into a DLQ
      entry in O(log batch) restarts.
    """

    def __init__(self, directory: str):
        self._dir = str(directory)
        os.makedirs(self._dir, exist_ok=True)

    # -- crash counting ----------------------------------------------------

    def note_restore(self, committed: int) -> int:
        """Record one restore at ``committed``; → the consecutive count
        of restores stuck at this offset (1 = first)."""
        st = self._read(_CRASH_FILE)
        if st is not None and int(st.get("committed", -1)) == int(committed):
            count = int(st.get("count", 0)) + 1
        else:
            count = 1
        atomic_write_json(
            os.path.join(self._dir, _CRASH_FILE),
            {"committed": int(committed), "count": count},
        )
        return count

    # -- suspect markers ---------------------------------------------------

    def read_marker(self) -> Optional[Dict[str, int]]:
        m = self._read(_MARKER_FILE)
        if (
            isinstance(m, dict)
            and "lo" in m and "hi" in m
            and int(m["hi"]) > int(m["lo"])
        ):
            return {
                "lo": int(m["lo"]), "hi": int(m["hi"]),
                "attempts": int(m.get("attempts", 1)),
            }
        return None

    def write_marker(self, lo: int, hi: int, attempts: int = 1) -> None:
        atomic_write_json(
            os.path.join(self._dir, _MARKER_FILE),
            {"lo": int(lo), "hi": int(hi), "attempts": int(attempts)},
        )

    def clear_marker(self) -> None:
        try:
            os.unlink(os.path.join(self._dir, _MARKER_FILE))
        except OSError:
            pass

    def _read(self, name: str) -> Optional[dict]:
        try:
            with open(
                os.path.join(self._dir, name), "r", encoding="utf-8"
            ) as f:
                obj = json.load(f)
        except (OSError, ValueError):
            return None
        return obj if isinstance(obj, dict) else None
