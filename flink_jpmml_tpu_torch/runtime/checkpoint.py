"""Checkpoint/resume for the streaming runtime (capability C7).

The port's copy of ``flink_jpmml_tpu/runtime/checkpoint.py``, with the
import lines renamed. One difference follows from the port's
``utils/retry.py``: :class:`Backoff` reads no ``FJT_RETRY_*`` knob, so a
write streak runs the JAX package's default schedule (0.05 s base, 5 s
cap, 8 attempts).

The reference inherited checkpointing from Flink barriers and contributed
only its operator state — the served-models map (SURVEY.md §6). Our runtime
owns the whole mechanism, but the state is deliberately tiny and JSON-shaped:
(source offsets, served-model registry, counters). Model *parameters* are
never checkpointed — models reload from their PMML paths on resume, exactly
like the reference's idempotent ``open()`` reload (capability C2).

Atomicity: write to a temp file in the same directory, fsync, replace,
fsync the DIRECTORY — the last step makes the rename itself durable, so
a crash at any instant leaves either the previous snapshot set or the
new one, never a truncated newest file (pinned by the kill-mid-write
drill in tests/test_checkpoint.py).
Retention: the last ``keep`` checkpoints are kept for manual rollback.
Transient write failures retry through the shared capped-jittered
backoff (utils/retry.py, the kafka reconnect schedule); only an
exhausted streak raises.
"""

from __future__ import annotations

import errno as errno_mod
import json
import os
import tempfile
import time
import warnings
from typing import Any, Dict, Optional

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.runtime import faults
from flink_jpmml_tpu_torch.utils.exceptions import CheckpointException
from flink_jpmml_tpu_torch.utils.retry import Backoff

_PREFIX = "ckpt-"


_FULL_DISK_ERRNOS = (errno_mod.ENOSPC, errno_mod.EDQUOT)
_SUSPEND_EVENT_MIN_PERIOD_S = 5.0


def _is_disk_full(exc: BaseException) -> bool:
    """Does this CheckpointException trace back to a full disk/quota?
    ENOSPC is a DEGRADE signal, not a die signal: the records are
    safe (they replay from the last committed offset), it is only the
    snapshot cadence that stalls."""
    cause = exc.__cause__
    return (
        isinstance(cause, OSError)
        and cause.errno in _FULL_DISK_ERRNOS
    )


class CheckpointPolicy:
    """Interval-gated save/restore shared by the record and block pipelines
    (one implementation of the timing + enablement logic, so the two
    engines cannot drift on checkpoint semantics).

    Persistent-ENOSPC degrade: a save streak exhausted by a FULL DISK
    does not raise out of the score loop (that crash-looped the worker
    against a disk a restart cannot empty) — checkpointing SUSPENDS
    instead: serving continues, the ``checkpoint_suspended`` gauge
    (fleet merge: worst-of) and a rate-limited flight event flag the
    widened replay window, and each subsequent interval sends ONE
    cheap write probe — the first one that lands resumes the cadence
    automatically (``checkpoint_resumed``). Any other exhausted save
    failure keeps the historical raise."""

    def __init__(self, manager: Optional["CheckpointManager"],
                 interval_s: float, metrics=None):
        self._mgr = manager
        self._interval = interval_s
        self._last = 0.0
        self._metrics = metrics
        self.suspended = False
        # gauge registered lazily at the first suspension (the
        # adaptive_batch discipline: healthy pipelines don't export a
        # permanent 0 row)
        self._suspended_gauge = None
        self._last_suspend_event = 0.0

    @property
    def enabled(self) -> bool:
        return self._mgr is not None

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        if self._mgr is None:
            return None
        return self._mgr.load_latest()

    def maybe_save(self, state_fn) -> None:
        if self._mgr is None:
            return
        if time.monotonic() - self._last >= self._interval:
            self.save_now(state_fn)

    def save_now(self, state_fn) -> None:
        if self._mgr is None:
            return
        try:
            # suspended → one cheap probe per interval instead of a
            # full retry streak per attempt
            self._mgr.save(state_fn(), probe=self.suspended)
        except CheckpointException as e:
            if not _is_disk_full(e):
                raise
            self._note_suspended(e)
            # probe cadence: next attempt only after another interval
            self._last = time.monotonic()
            return
        if self.suspended:
            self.suspended = False
            if self._suspended_gauge is not None:
                self._suspended_gauge.set(0.0)
            flight.record("checkpoint_resumed")
        self._last = time.monotonic()

    def _note_suspended(self, exc: BaseException) -> None:
        first = not self.suspended
        self.suspended = True
        if self._metrics is not None:
            if self._suspended_gauge is None:
                self._suspended_gauge = self._metrics.gauge(
                    "checkpoint_suspended"
                )
            self._suspended_gauge.set(1.0)
        now = time.monotonic()
        if first or now - self._last_suspend_event >= (
            _SUSPEND_EVENT_MIN_PERIOD_S
        ):
            self._last_suspend_event = now
            flight.record(
                "checkpoint_suspended", error=str(exc), first=first,
            )


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self._dir = directory
        self._keep = keep
        os.makedirs(directory, exist_ok=True)

    @property
    def directory(self) -> str:
        """Public so siblings can colocate durable state with the
        resume state it protects: the pipelines' default DLQ and the
        crash-loop fingerprint files live under here (runtime/dlq.py)."""
        return self._dir

    def save(self, state: Dict[str, Any], probe: bool = False) -> str:
        """Write one snapshot crash-safely, retrying transient failures.

        Each attempt is temp-file → fsync → ``os.replace`` → directory
        fsync: the file's bytes are durable before the name appears,
        and the name itself is durable before save() returns — a crash
        (or SIGKILL) at ANY instant leaves every ``ckpt-*.json``
        parseable. Transient OSErrors (EMFILE, an NFS hiccup, a full
        disk that clears) retry with the shared jittered backoff; an
        exhausted streak raises so the operator sees a checkpoint plane
        that cannot make progress.

        ``probe=True`` (the suspended-checkpointing resume probe,
        :class:`CheckpointPolicy`): ONE write attempt, no backoff, no
        retry flight events — a known-full disk must not re-pay the
        whole schedule (or spam the flight ring) every interval."""
        payload = {"timestamp": time.time(), "state": state}
        retries = 0
        if probe:
            try:
                path = self._write_once(payload)
            except OSError as e:
                raise CheckpointException(
                    f"checkpoint probe failed: {e}"
                ) from e
        else:
            backoff = Backoff("checkpoint")
            while True:
                try:
                    path = self._write_once(payload)
                except OSError as e:
                    flight.record(
                        "checkpoint_save_retry",
                        error=str(e), attempt=backoff.attempts + 1,
                    )
                    if backoff.exhausted:
                        flight.record(
                            "checkpoint_save_failed", error=str(e)
                        )
                        raise CheckpointException(
                            f"cannot write checkpoint after "
                            f"{backoff.attempts} retries: {e}"
                        ) from e
                    backoff.sleep()
                    continue
                break
            retries = backoff.attempts
        flight.record(
            "checkpoint_save", path=path,
            source_offset=state.get("source_offset"),
            retries=retries,
        )
        self._gc()
        return path

    def _write_once(self, payload: Dict[str, Any]) -> str:
        """One crash-safe write attempt; raises OSError on failure
        (the temp file, if any, is removed so retries can't litter)."""
        fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=self._dir)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f)
                f.flush()
                # mid-write fault hook (runtime/faults.py): an injected
                # OSError here leaves a partial temp file — exactly the
                # crash the atomic-replace protocol must survive
                faults.fire("checkpoint_write")
                os.fsync(f.fileno())
            path = os.path.join(
                self._dir, f"{_PREFIX}{int(time.time() * 1e6)}.json"
            )
            os.replace(tmp, path)
            tmp = None
            # durable NAME, not just durable bytes: fsync the directory
            # so the replace survives a crash (best-effort — some
            # filesystems refuse directory fds)
            try:
                dfd = os.open(self._dir, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
            return path
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def load_latest(self) -> Optional[Dict[str, Any]]:
        """Newest readable checkpoint's state (None when none exist).

        A corrupt newest file (disk damage — the atomic rename rules out
        torn writes) falls back to the next retained snapshot with a
        loud warning: that is what retention is FOR, and resuming from
        an older offset just replays more records (the at-least-once
        contract). Only when every retained checkpoint is unreadable
        does restore fail.

        Transient I/O failures (EMFILE, EACCES, an NFS hiccup) are NOT
        corruption: falling back past an intact newest snapshot would
        silently replay up to a full retention window. Such reads get
        one retry; a second failure raises so the operator sees it."""
        ckpts = self._list()
        if not ckpts:
            return None
        errors = []
        for path in reversed(ckpts):
            try:
                state = self._read_state(path)
            except (
                ValueError, KeyError, TypeError,
            ) as e:
                # ValueError covers json.JSONDecodeError (malformed
                # JSON) and UnicodeDecodeError (bit-rot turned the
                # newest snapshot into invalid UTF-8 — deterministic
                # corruption, not a transient read failure); TypeError:
                # valid JSON that isn't a dict payload
                errors.append(f"{path!r}: {e}")
                continue
            except FileNotFoundError as e:
                # a concurrent _gc may legitimately remove older files;
                # a vanished file is not an intact snapshot being skipped
                errors.append(f"{path!r}: {e}")
                continue
            except OSError as e:
                raise CheckpointException(
                    f"transient I/O failure reading {path!r} (retried "
                    f"once): {e} — not falling back past a possibly "
                    "intact snapshot"
                ) from e
            if errors:
                warnings.warn(
                    "corrupt checkpoint(s) skipped during restore "
                    f"({'; '.join(errors)}); resuming from {path!r}",
                    RuntimeWarning,
                    stacklevel=2,
                )
            flight.record(
                "checkpoint_load", path=path, skipped_corrupt=len(errors),
                source_offset=(
                    state.get("source_offset")
                    if isinstance(state, dict) else None
                ),
            )
            return state
        raise CheckpointException(
            f"no readable checkpoint: {'; '.join(errors)}"
        )

    @staticmethod
    def _read_state(path: str):
        """Read + decode one snapshot, retrying a transient OSError
        once (decode errors are deterministic — no point retrying)."""
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)["state"]
        except FileNotFoundError:
            raise
        except OSError:
            time.sleep(0.05)
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)["state"]

    def _list(self):
        try:
            names = [
                n
                for n in os.listdir(self._dir)
                if n.startswith(_PREFIX) and n.endswith(".json")
            ]
        except OSError as e:
            raise CheckpointException(f"cannot list checkpoints: {e}") from e
        return [os.path.join(self._dir, n) for n in sorted(names)]

    def _gc(self) -> None:
        ckpts = self._list()
        for p in ckpts[: -self._keep]:
            try:
                os.unlink(p)
            except OSError:
                pass
