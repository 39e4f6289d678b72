"""Flight recorder: a bounded ring of structured runtime events.

The port's copy of ``flink_jpmml_tpu/obs/recorder.py``, with the import
lines renamed (a dump flushes the span writer first, as there). Tests point ``flight_dir()`` at a temporary directory
through ``FJT_FLIGHT_DIR``.

A crashed or wedged worker used to leave NOTHING behind but an exit
code; the operators' postmortem question is always "what was the
runtime doing in the seconds before?". The recorder answers it at
near-zero steady-state cost: every interesting-but-rare event
(reconnects, checkpoint save/load, worker death/restart, autotune
decisions, dispatch abandons, donation-warning filters) appends one
dict to a lock-guarded ring; failure paths call :func:`dump` and the
last ``capacity`` events land as a JSONL file under ``FJT_FLIGHT_DIR``
(default: ``$TMPDIR/fjt-flight``).

Hot paths (per-record, per-batch) must NOT record — the ring is for
events that happen seconds-to-hours apart, so 2048 slots span the whole
story. One process-wide default recorder keeps call sites one-line
(``flight.record("kafka_reconnect", topic=...)``); subsystems that want
isolation can own a :class:`FlightRecorder` instance.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

_DIR_ENV = "FJT_FLIGHT_DIR"
_KEEP_DUMPS = 16  # retained dump files per directory


def flight_dir() -> str:
    return os.environ.get(_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "fjt-flight"
    )


class FlightRecorder:
    def __init__(self, capacity: int = 2048):
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=capacity
        )
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, kind: str, **fields) -> None:
        ev = {"t": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(
        self, path: Optional[str] = None, reason: Optional[str] = None
    ) -> Optional[str]:
        """Write the ring as JSONL → the file path (None on I/O failure:
        a postmortem helper must never become the second failure)."""
        try:
            # the span file must contain everything up to the moment of
            # the dump: a buffered span writer (obs/spans.py) would
            # otherwise hold the last ~flush-interval of the story a
            # postmortem exists to tell
            from flink_jpmml_tpu_torch.obs import spans

            spans.flush()
        except Exception:
            pass
        events = self.events()
        try:
            if path is None:
                d = flight_dir()
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d,
                    f"flight-{os.getpid()}-{int(time.time() * 1e6)}.jsonl",
                )
                self._prune(d)
            with open(path, "w", encoding="utf-8") as f:
                if reason is not None:
                    f.write(json.dumps(
                        {"t": time.time(), "kind": "dump", "reason": reason}
                    ) + "\n")
                for ev in events:
                    f.write(json.dumps(ev, default=repr) + "\n")
            return path
        except (OSError, ValueError):
            return None

    @staticmethod
    def _dump_time(name: str) -> int:
        """The µs timestamp embedded in ``flight-<pid>-<µs>.jsonl`` —
        the prune key. Lexicographic filename order would interleave
        pids (pid 999 sorts after pid 1000), deleting fresh dumps and
        keeping stale ones across worker restarts."""
        try:
            return int(name[len("flight-"):-len(".jsonl")].split("-")[1])
        except (IndexError, ValueError):
            return 0  # unparseable = oldest: pruned first

    @classmethod
    def _prune(cls, d: str) -> None:
        """Keep the newest ``_KEEP_DUMPS`` dumps: failure loops (a
        crash-restart cycle dumps per death) must not fill the disk."""
        try:
            names = sorted(
                (
                    n for n in os.listdir(d)
                    if n.startswith("flight-") and n.endswith(".jsonl")
                ),
                key=cls._dump_time,
            )
            # the caller is about to add one more file
            for n in names[: len(names) - (_KEEP_DUMPS - 1)]:
                try:
                    os.unlink(os.path.join(d, n))
                except OSError:
                    pass
        except OSError:
            pass


# the process-wide default recorder: one ring tells one process's story
DEFAULT = FlightRecorder()


def record(kind: str, **fields) -> None:
    DEFAULT.record(kind, **fields)


def dump(path: Optional[str] = None, reason: Optional[str] = None):
    return DEFAULT.dump(path, reason=reason)


def events() -> List[dict]:
    return DEFAULT.events()
