"""Deterministic fault injection: overload and recovery, drilled.

The port's copy of ``flink_jpmml_tpu/runtime/faults.py``, with the
import lines renamed.

PRs 3-7 built the telemetry that *reports* a dying broker, a wedged
worker, or a failed checkpoint write — but every one of those paths was
only ever exercised by whatever chaos a test could improvise (monkey-
patched sockets, killed subprocesses). This harness injects the faults
into the REAL code paths, deterministically, so the overload drill and
the recovery tests run the same failure the same way every time:

=================  =========================================  ===========================
kind               fires in (site)                            effect
=================  =========================================  ===========================
``broker_death``   kafka fetch RPC (``runtime/kafka.py``)     raises ``ConnectionError`` →
                                                              the real reconnect/backoff path
``slow_fetch``     kafka fetch RPC                            sleeps ``delay_ms``
``dispatch_delay`` device dispatch                            sleeps ``delay_ms`` before the
                   (``OverlappedDispatcher.launch``)          dispatch is issued
``checkpoint_fail`` checkpoint write                          raises ``OSError`` mid-write →
                   (``CheckpointManager.save``)               the retry/backoff path
``worker_wedge``   the block score loop                       sleeps ``wedge_s`` per fire —
                                                              the heartbeat-wedge shape
``poison_record``  per-batch scoring (``score_batch`` site,   raises ``InjectedPoisonRecord``
                   carries the dispatched offsets)            when ``offset=``/``every=``
                                                              matches → the record-isolation
                                                              (suspect-mode bisection) path
``worker_crash``   any site via ``site=`` (default            SIGKILLs the process — the
                   ``score_loop``); ``offset=`` targets the   kill-anywhere recovery drill's
                   batch containing that record               chaos primitive
``device_oom``     device launch/readback (``device_dispatch``raises ``InjectedDeviceOOM``
                   / ``device_readback`` via ``site=``)       → batch-size bisection
``device_error``   device launch/readback                     raises ``InjectedDeviceError``
                                                              → redispatch / circuit breaker
``chip_loss``      device launch/readback                     raises ``InjectedChipLoss``
                                                              → supervisor escalation /
                                                              degraded-mesh mode
=================  =========================================  ===========================

The device kinds ride the real launch/readback hook sites in
``runtime/pipeline.OverlappedDispatcher`` and the record engine's
submit/finish path; ``runtime/devfault.classify`` recognizes their
exceptions exactly like real XLA runtime errors, so the drills prove
the production recovery ladder, not a parallel test-only path.
``checkpoint_fail`` accepts ``errno=`` (e.g. ``errno=28`` = ENOSPC) so
a persistent-full-disk outage is drillable end to end.

Two front doors:

- **env** — ``FJT_FAULTS`` holds comma-separated specs, each a kind
  followed by ``:key=value`` params::

      FJT_FAULTS="slow_fetch:delay_ms=40:p=0.5,broker_death:after_s=5:for_s=2"

  parsed once at import (and re-parseable via :func:`install_from_env`);
  a malformed spec is skipped loudly (stderr), never fatal.
- **programmatic** — :func:`inject`/:func:`clear` for tests and drills.

Gate params (all optional): ``after_s`` (arm delay from install),
``for_s`` (active window after arming), ``n`` (max fires), ``p``
(per-call probability from a seeded RNG — ``seed`` makes it
deterministic), ``delay_ms`` / ``wedge_s`` (the action magnitudes).

Every fire records a rate-limited ``fault_injected`` flight event (≥1 s
apart per fault — the flight ring is for rare events; exact counts live
in :func:`stats`).

**Zero-overhead contract**: with no faults configured, ``fire(site)``
is one global load and a None check — pinned by the perf-smoke
tripwire. Hook sites sit on per-fetch / per-batch paths, never
per-record.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
from typing import Dict, List, Optional

from flink_jpmml_tpu_torch.obs import recorder as flight

_ENV = "FJT_FAULTS"
_EVENT_MIN_PERIOD_S = 1.0

# the sites the runtime actually hooks; a kind IS its DEFAULT site
# mapping (worker_crash may override via its ``site=`` param — a kill
# must land ANYWHERE: mid-fetch, mid-dispatch, mid-checkpoint)
SITES = {
    "broker_death": "kafka_fetch",
    "slow_fetch": "kafka_fetch",
    "dispatch_delay": "dispatch",
    "checkpoint_fail": "checkpoint_write",
    "worker_wedge": "score_loop",
    # per-batch scoring hook carrying the batch's offsets as context:
    # an injected poison record raises exactly when its offset is in
    # the dispatched range, so bisection isolates it like a real one
    "poison_record": "score_batch",
    # SIGKILL self at the chosen site — the kill-anywhere recovery
    # drill's chaos primitive (no Python cleanup runs, like a real OOM
    # kill); with ``offset=`` it fires only when that offset is in the
    # batch, the shape of a record that hard-crashes the process
    "worker_crash": "score_loop",
    # device faults (runtime/devfault.py's taxonomy): default to the
    # readback site — async dispatch errors surface where the host
    # first blocks, like the real thing; ``site=device_dispatch``
    # moves them to launch time
    "device_oom": "device_readback",
    "device_error": "device_readback",
    "chip_loss": "device_readback",
}

# sites a ``site=`` param may name (worker_crash: any; device kinds:
# the two device hook sites only)
KNOWN_SITES = frozenset(
    list(SITES.values()) + ["score_batch", "dispatch", "device_dispatch"]
)
_DEVICE_KINDS = frozenset(("device_oom", "device_error", "chip_loss"))
_DEVICE_SITES = frozenset(("device_dispatch", "device_readback"))


class InjectedBrokerDeath(ConnectionError):
    """Injected broker death: rides the kafka sources' real
    ``except (OSError, ConnectionError, ...)`` → reconnect path."""


class InjectedCheckpointFailure(OSError):
    """Injected checkpoint write failure: rides ``CheckpointManager
    .save``'s real ``except OSError`` → retry/backoff path."""


class InjectedDeviceOOM(RuntimeError):
    """Injected device OOM: message mirrors XLA's RESOURCE_EXHAUSTED
    status so ``runtime/devfault.classify`` routes it exactly like a
    real allocator refusal → the batch-size bisection ladder."""

    def __init__(self):
        super().__init__(
            "RESOURCE_EXHAUSTED: Out of memory allocating device "
            "buffer (injected device OOM)"
        )


class InjectedDeviceError(RuntimeError):
    """Injected transient XLA runtime failure → the redispatch /
    circuit-breaker ladder."""

    def __init__(self):
        super().__init__(
            "INTERNAL: injected XLA runtime error (transient device "
            "failure)"
        )


class InjectedChipLoss(RuntimeError):
    """Injected unrecoverable device loss → supervisor escalation
    (and, on a mesh, degraded-mesh mode)."""

    def __init__(self):
        super().__init__(
            "UNAVAILABLE: device lost (injected chip loss)"
        )


class InjectedPoisonRecord(ValueError):
    """Injected poison record: raised from the per-batch scoring hook
    when a configured offset lands in the dispatched range — rides the
    pipelines' real record-isolation (suspect-mode bisection) path.
    ``offsets`` carries the matched offsets."""

    def __init__(self, offsets):
        super().__init__(
            f"injected poison record at offset(s) {list(offsets)}"
        )
        self.offsets = tuple(int(o) for o in offsets)


class _Fault:
    """One configured fault: its gates (arm delay, active window, count
    cap, probability) and its action."""

    def __init__(self, kind: str, params: Dict[str, float],
                 clock=time.monotonic):
        if kind not in SITES:
            raise ValueError(
                f"unknown fault kind {kind!r} (have {sorted(SITES)})"
            )
        self.kind = kind
        site = params.get("site")
        if site is not None:
            if kind == "worker_crash":
                allowed = KNOWN_SITES
            elif kind in _DEVICE_KINDS:
                # a device fault can only strike where device work is
                # launched or waited on
                allowed = _DEVICE_SITES
            else:
                raise ValueError(
                    f"site= is only meaningful on worker_crash and the "
                    f"device kinds, not {kind!r}"
                )
            if site not in allowed:
                raise ValueError(
                    f"unknown fault site {site!r} for {kind!r} "
                    f"(have {sorted(allowed)})"
                )
            self.site = str(site)
        else:
            self.site = SITES[kind]
        self._clock = clock
        self._t0 = clock()
        self.after_s = float(params.get("after_s", 0.0))
        self.for_s = params.get("for_s")
        self.max_fires = (
            int(params["n"]) if params.get("n") is not None else None
        )
        self.p = params.get("p")
        self.delay_s = float(params.get("delay_ms", 50.0)) / 1000.0
        self.wedge_s = float(params.get("wedge_s", 0.5))
        # offset targeting (poison_record / worker_crash at an
        # offset-carrying site): ``offset=K`` fires exactly when record
        # K is in the batch; ``every=N`` poisons offsets ≡ 0 (mod N) —
        # both deterministic across replays, which is what lets the
        # drill assert "these offsets land in the DLQ exactly"
        self.offset = (
            int(params["offset"]) if params.get("offset") is not None
            else None
        )
        self.every = (
            int(params["every"]) if params.get("every") is not None
            else None
        )
        # checkpoint_fail only: stamp this errno on the injected
        # OSError (errno=28 drills persistent ENOSPC → the checkpoint
        # plane's degrade-don't-die path)
        self.errno = (
            int(params["errno"]) if params.get("errno") is not None
            else None
        )
        if kind == "poison_record" and self.offset is None and self.every is None:
            raise ValueError(
                "poison_record needs offset= or every= targeting"
            )
        # seeded by default: the SAME drill injects the SAME faults —
        # determinism is the point of a harness over improvised chaos
        self._rng = random.Random(int(params.get("seed", 0xFA17)))
        self.fires = 0
        self._last_event = 0.0
        self._mu = threading.Lock()

    def _match_offsets(self, ctx: Optional[dict]):
        """Offset-targeted gate: → the matched offsets (possibly ()),
        or True when this fault has no offset constraint."""
        if self.offset is None and self.every is None:
            return True
        offsets = None if ctx is None else ctx.get("offsets")
        if offsets is None:
            return ()  # offset-targeted fault at an offset-less site
        matched = []
        for o in offsets:
            o = int(o)
            if self.offset is not None and o == self.offset:
                matched.append(o)
            elif self.every is not None and self.every > 0 and o % self.every == 0:
                matched.append(o)
        return tuple(matched)

    def try_claim(self, ctx: Optional[dict] = None):
        """Evaluate the gates; claim one fire when they all pass.
        → falsy (no fire), or a fire token: ``True`` / the non-empty
        tuple of matched offsets for offset-targeted faults."""
        token = self._match_offsets(ctx)
        if not token:
            return False
        now = self._clock()
        armed_at = self._t0 + self.after_s
        if now < armed_at:
            return False
        if self.for_s is not None and now > armed_at + float(self.for_s):
            return False
        with self._mu:
            if self.max_fires is not None and self.fires >= self.max_fires:
                return False
            if self.p is not None and self._rng.random() >= float(self.p):
                return False
            self.fires += 1
            event_due = now - self._last_event >= _EVENT_MIN_PERIOD_S
            if event_due:
                self._last_event = now
        if event_due:
            flight.record(
                "fault_injected", fault=self.kind, site=self.site,
                fires=self.fires,
            )
        return token

    def act(self, token=True) -> None:
        if self.kind == "broker_death":
            raise InjectedBrokerDeath("injected broker death")
        if self.kind == "checkpoint_fail":
            e = InjectedCheckpointFailure(
                "injected checkpoint write failure"
            )
            if self.errno is not None:
                e.errno = self.errno
            raise e
        if self.kind == "device_oom":
            raise InjectedDeviceOOM()
        if self.kind == "device_error":
            raise InjectedDeviceError()
        if self.kind == "chip_loss":
            raise InjectedChipLoss()
        if self.kind == "poison_record":
            raise InjectedPoisonRecord(
                token if token is not True else ()
            )
        if self.kind == "worker_crash":
            # SIGKILL self: no atexit, no finally, no flushes — the
            # honest shape of an OOM kill or a segfaulting record. The
            # flight event above already rode its own fsync'd dump path
            # only if a dump was triggered; a crash drill reads the
            # SUPERVISOR's events, not this process's.
            os.kill(os.getpid(), 9)
            return  # pragma: no cover - unreachable
        if self.kind == "worker_wedge":
            time.sleep(self.wedge_s)
        else:  # slow_fetch / dispatch_delay
            time.sleep(self.delay_s)


class FaultPlan:
    def __init__(self, faults: List[_Fault]):
        self.faults = faults
        self._by_site: Dict[str, List[_Fault]] = {}
        for f in faults:
            self._by_site.setdefault(f.site, []).append(f)

    def fire(self, site: str, ctx: Optional[dict] = None) -> None:
        for f in self._by_site.get(site, ()):
            token = f.try_claim(ctx)
            if token:
                f.act(token)


# None = no faults configured: fire() is a global load + None check
_ACTIVE: Optional[FaultPlan] = None


def fire(site: str, **ctx) -> None:
    """The hook the runtime calls at each injection site. A raised
    fault propagates to the caller's real error-handling path.
    ``ctx`` carries site context for targeted faults (the
    ``score_batch`` site passes ``offsets=<array>`` so poison faults
    can match the dispatched range); with no faults configured this
    stays one global load + a None check."""
    plan = _ACTIVE
    if plan is None:
        return
    plan.fire(site, ctx if ctx else None)


def active() -> bool:
    return _ACTIVE is not None


def inject(kind: str, **params) -> _Fault:
    """Programmatically add one fault (tests/drills). → the fault, so
    the caller can read ``fires``."""
    global _ACTIVE
    f = _Fault(kind, params)
    faults = list(_ACTIVE.faults) if _ACTIVE is not None else []
    faults.append(f)
    _ACTIVE = FaultPlan(faults)
    return f


def clear() -> None:
    """Drop every configured fault (idempotent)."""
    global _ACTIVE
    _ACTIVE = None


def stats() -> Dict[str, int]:
    """→ {kind: fires} for every configured fault (summed per kind)."""
    plan = _ACTIVE
    out: Dict[str, int] = {}
    if plan is not None:
        for f in plan.faults:
            out[f.kind] = out.get(f.kind, 0) + f.fires
    return out


def parse_spec(spec: str) -> List[_Fault]:
    """Parse the ``FJT_FAULTS`` grammar → faults. Raises ValueError on
    an unknown kind or an unparseable param."""
    faults: List[_Fault] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        pieces = part.split(":")
        kind = pieces[0].strip()
        params: Dict[str, float] = {}
        for kv in pieces[1:]:
            k, _, v = kv.partition("=")
            if not _ or not k.strip():
                raise ValueError(f"bad fault param {kv!r} in {part!r}")
            if k.strip() == "site":
                # the one string-valued param (worker_crash site
                # selection); everything else stays numeric
                params[k.strip()] = v.strip()
            else:
                params[k.strip()] = float(v)
        faults.append(_Fault(kind, params))
    return faults


def install_from_env(env: Optional[str] = None) -> bool:
    """(Re)install the plan from ``FJT_FAULTS`` (or ``env``). → True
    when faults were installed. A malformed spec is skipped loudly on
    stderr — a typo in a drill config must not crash the pipeline it
    was meant to drill."""
    global _ACTIVE
    raw = os.environ.get(_ENV) if env is None else env
    if not raw:
        return False
    try:
        faults = parse_spec(raw)
    except ValueError as e:
        print(f"[fjt-faults] ignoring {_ENV}={raw!r}: {e}",
              file=sys.stderr, flush=True)
        return False
    if not faults:
        return False
    _ACTIVE = FaultPlan(faults)
    flight.record(
        "faults_installed", kinds=[f.kind for f in faults], spec=raw,
    )
    return True


# env faults arm at import so every process in a drill (workers spawned
# by the supervisor included) picks them up with no plumbing
install_from_env()
