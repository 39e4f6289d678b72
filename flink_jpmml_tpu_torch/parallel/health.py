"""Worker health monitoring: heartbeats + failure detection (SURVEY.md
§6 row "Failure detection / elastic recovery").

A copy of ``flink_jpmml_tpu/parallel/health.py`` with the import lines
renamed; sockets, framing, the control channel and the flight-recorder
events are the JAX module's. What differs: ``DeviceHealth`` keys a device
by its ``torch.device.index`` (``parallel/mesh.device_id``) where the JAX
module reads ``Device.id``. The supervisor that
drives it (``runtime/supervisor.py``) and the fleet ``/metrics`` server
(``obs/server.py``) are ported too.

The reference inherits Flink's runtime heartbeats and restart
strategies; the library's own contribution was idempotent model reload
plus checkpointed state, so recovery = restart from checkpoint. The
equivalent here:

- :class:`HealthCoordinator` — a tiny framed-TCP listener (one thread +
  one thread per connection) tracking each worker's last heartbeat.
  A worker with no beat within ``timeout_s`` is declared DEAD and the
  ``on_dead`` callback fires; a worker that resumes beating is declared
  recovered via ``on_recover`` — the elastic re-join path. ALL state
  transitions (and both callbacks) happen on the single monitor thread,
  in order, so callbacks never race each other and a crash-prone
  callback cannot take the monitor down (exceptions are swallowed).
- :class:`HealthReporter` — the worker side: beats every
  ``interval_s`` over a persistent connection, reconnecting with
  backoff through coordinator restarts. With ``snapshot_fn`` set (a
  ``MetricsRegistry.struct_snapshot`` bound method is the intended
  value) every beat piggybacks a compact metrics snapshot, so the
  coordinator holds each worker's latest counters/gauges/histograms and
  the supervisor's ``/metrics`` endpoint (obs/server.py) can expose the
  merged fleet view without a second wire protocol. The attribution
  plane rides the same channel untouched: per-stage
  ``stage_seconds{stage=...}`` histograms (with their exemplar trace
  ids), the live ``device_mfu``/``device_membw_util`` gauges, and the
  ``slo_burn_*`` family are ordinary registry entries, so a worker's
  latency attribution reaches the fleet scrape — exemplars included —
  through the existing struct merge (``utils.metrics.merge_structs``
  keeps, per bucket, the worst exemplar it sees).

The heartbeat link also carries the **control channel** (the rollout
plane's fleet-convergence path, rollout/): the coordinator holds one
current control document (:meth:`HealthCoordinator.set_control`, a
monotonically sequenced dict), and a reporter constructed with
``on_control`` advertises the sequence it has applied in every beat
(``"ctl"``); the coordinator replies on the same socket with the
document whenever the reporter is behind. Propagation latency is one
beat interval; a worker that reconnects or restarts converges on its
first beat. Backward compatible in both directions: a reporter without
``on_control`` sends no ``"ctl"`` and gets no reply; a reporter talking
to a pre-control coordinator times out once waiting for the first ack
and stops expecting replies.

Recovery itself stays the C7 model: the operator (or a supervisor
script) restarts the dead worker, which resumes from the checkpointed
source offsets and serving registry — nothing here tries to migrate
state over the wire, matching the reference's restart-from-checkpoint
semantics rather than inventing new ones.

Frame format: u32 big-endian length + UTF-8 JSON ``{"id": worker_id,
"seq": n}`` — same framing discipline as runtime/net.py, small enough
to need none of its machinery.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.parallel.mesh import device_id
from flink_jpmml_tpu_torch.utils.metrics import govern_struct
from flink_jpmml_tpu_torch.utils.netio import recv_exact

_U32 = struct.Struct(">I")
# beats may piggyback a metrics struct_snapshot (sparse histograms for
# a busy worker run tens of KB); anything bigger than this is garbage
_MAX_FRAME = 1 << 20


class HealthCoordinator:
    """Heartbeat listener + liveness registry.

    ``on_dead(worker_id)`` / ``on_recover(worker_id)`` both fire on the
    monitor thread, once per state transition, in transition order;
    exceptions they raise are swallowed (a broken supervisor hook must
    not disable failure detection). ``alive()`` / ``dead()`` snapshot
    the current view. ``remove(worker_id)`` deregisters a
    decommissioned worker; ``expire_after_s`` (optional) auto-drops
    workers that have been dead that long, so elastic fleets with
    unstable ids don't grow the registry without bound.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        timeout_s: float = 2.0,
        on_dead: Optional[Callable[[str], None]] = None,
        on_recover: Optional[Callable[[str], None]] = None,
        expire_after_s: Optional[float] = None,
    ):
        self._timeout = timeout_s
        self._expire = expire_after_s
        self._on_dead = on_dead
        self._on_recover = on_recover
        self._mu = threading.Lock()
        self._last_seen: Dict[str, float] = {}
        # latest piggybacked metrics struct per worker (see
        # HealthReporter.snapshot_fn); deliberately kept after death —
        # a dead worker's last snapshot is exactly what a postmortem
        # scrape wants — dropped only by remove()/expiry
        self._snapshots: Dict[str, dict] = {}
        # known workers → declared dead? (transitions only on the
        # monitor thread; _beat just stamps _last_seen)
        self._declared_dead: Dict[str, bool] = {}
        # current control documents by key: key -> (seq, dict). Keyed,
        # not single-slot: concurrent rollouts of different model names
        # are independent state machines — a worker that was down for
        # "rollback A" then "promote B" must receive BOTH on its next
        # beat, not just the newest (see set_control)
        self._controls: Dict[str, tuple] = {}
        self._control_seq = 0
        self._closing = False
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._conns: List[socket.socket] = []
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True),
            threading.Thread(target=self._monitor_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # -- views / admin -----------------------------------------------------

    def alive(self) -> List[str]:
        with self._mu:
            return sorted(
                w for w, d in self._declared_dead.items() if not d
            )

    def dead(self) -> List[str]:
        with self._mu:
            return sorted(w for w, d in self._declared_dead.items() if d)

    def last_seen(self, worker_id: str) -> Optional[float]:
        with self._mu:
            return self._last_seen.get(worker_id)

    def metrics_snapshots(self) -> Dict[str, dict]:
        """Latest piggybacked metrics struct per worker (copies the
        mapping, not the structs: a worker's snapshot is replaced whole
        on each beat, never mutated in place)."""
        with self._mu:
            return dict(self._snapshots)

    def remove(self, worker_id: str) -> None:
        """Deregister a decommissioned worker (no callback)."""
        with self._mu:
            self._last_seen.pop(worker_id, None)
            self._declared_dead.pop(worker_id, None)
            self._snapshots.pop(worker_id, None)

    def set_control(self, doc: dict, key: str = "") -> int:
        """Publish ``doc`` as the current control document for ``key``;
        → its seq.

        Replaces the previous document OF THE SAME KEY only: within one
        key the channel carries "the newest decision", not a log, but
        different keys (e.g. per-model-name rollout decisions) are
        independent — a reconnecting worker receives every key's current
        document it hasn't applied yet, piggybacked on the reply to its
        next beat. Retention is bounded by the number of live keys."""
        with self._mu:
            self._control_seq += 1
            self._controls[key] = (self._control_seq, dict(doc))
            return self._control_seq

    # -- internals ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._mu:
                self._conns.append(conn)
            if self._closing:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            t = threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            )
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._closing:
                hdr = recv_exact(conn, 4)
                if hdr is None:
                    return
                (n,) = _U32.unpack(hdr)
                if n > _MAX_FRAME:
                    return
                payload = recv_exact(conn, n)
                if payload is None:
                    return
                try:
                    beat = json.loads(payload)
                    wid = str(beat["id"])
                except (ValueError, KeyError, TypeError):
                    continue  # one garbage frame must not kill the feed
                snap = beat.get("metrics")
                with self._mu:
                    self._last_seen[wid] = time.monotonic()
                    if isinstance(snap, dict):
                        self._snapshots[wid] = snap
                    ctls = list(self._controls.values())
                if "ctl" in beat:
                    # control-aware reporter: always ack (it blocks on
                    # the reply), shipping every key's current document
                    # the worker hasn't applied yet (seq-ordered, so a
                    # worker down across several decisions converges on
                    # all of them in one beat)
                    try:
                        have = int(beat["ctl"])
                    except (TypeError, ValueError):
                        have = 0
                    top = max([s for s, _ in ctls], default=0)
                    pending = sorted(
                        (s, d) for s, d in ctls if s > have
                    )
                    reply = {"ctl_seq": top}
                    if pending:
                        reply["controls"] = [d for _, d in pending]
                    payload = json.dumps(reply, default=repr).encode()
                    try:
                        conn.sendall(_U32.pack(len(payload)) + payload)
                    except OSError:
                        return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._mu:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass

    def _fire(self, cb: Optional[Callable[[str], None]], wid: str) -> None:
        if cb is None:
            return
        try:
            cb(wid)
        except Exception:
            pass  # a broken hook must not kill the monitor thread

    def _monitor_loop(self) -> None:
        while not self._closing:
            time.sleep(min(self._timeout / 4.0, 0.25))
            now = time.monotonic()
            newly_dead: List[str] = []
            recovered: List[str] = []
            with self._mu:
                for wid, t in list(self._last_seen.items()):
                    stale = now - t > self._timeout
                    was_dead = self._declared_dead.get(wid)
                    if was_dead is None:  # first sighting: register
                        self._declared_dead[wid] = stale
                        if stale:
                            newly_dead.append(wid)
                    elif stale and not was_dead:
                        self._declared_dead[wid] = True
                        newly_dead.append(wid)
                    elif not stale and was_dead:
                        self._declared_dead[wid] = False
                        recovered.append(wid)
                    if (
                        self._expire is not None
                        and now - t > self._timeout + self._expire
                    ):
                        self._last_seen.pop(wid, None)
                        self._declared_dead.pop(wid, None)
                        self._snapshots.pop(wid, None)
            # single thread, strict order: a recovery observed in the
            # same sweep as a death cannot be delivered out of order
            for wid in newly_dead:
                flight.record("heartbeat_dead", worker=wid)
                self._fire(self._on_dead, wid)
            for wid in recovered:
                flight.record("heartbeat_recover", worker=wid)
                self._fire(self._on_recover, wid)

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._mu:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class DeviceHealth:
    """Chip-liveness registry: the worker-health discipline applied to
    DEVICES (the degraded-mesh requirement). A chip is
    treated exactly like a worker is today — registered, declared lost
    on an unrecoverable device fault (``runtime/devfault.py``'s
    ``chip_loss``), recovered when it comes back — and the callbacks
    are where shard re-balancing hangs:
    ``on_lost(device) → ShardedModel.without_devices([device])``
    (parallel/sharding.py) rebuilds the mesh over the survivors, and
    because per-chip metrics/sketches fleet-merge EXACTLY (the DrJAX
    map/reduce discipline — utils/metrics.merge_structs), a mesh minus
    one chip is just a smaller fleet: no telemetry rebaselining, no
    state migration.

    Transitions fire callbacks once (idempotent mark calls), under no
    lock (the coordinator discipline: a crash-prone callback must not
    poison liveness tracking). ``mesh_lost_devices`` (fleet merge:
    worst-of) exports the count."""

    def __init__(self, metrics=None, on_lost=None, on_recover=None):
        self._on_lost = on_lost
        self._on_recover = on_recover
        self._mu = threading.Lock()
        self._known: Dict[object, object] = {}  # id -> device
        self._lost: Dict[object, object] = {}
        self._gauge = (
            metrics.gauge("mesh_lost_devices")
            if metrics is not None else None
        )

    @staticmethod
    def _key(device):
        return device_id(device)

    def watch(self, devices) -> "DeviceHealth":
        with self._mu:
            for d in devices:
                self._known.setdefault(self._key(d), d)
        return self

    def alive(self) -> List[object]:
        with self._mu:
            return [
                d for k, d in self._known.items() if k not in self._lost
            ]

    def lost(self) -> List[object]:
        with self._mu:
            return list(self._lost.values())

    def survivors(self, devices) -> List[object]:
        with self._mu:
            return [d for d in devices if self._key(d) not in self._lost]

    def mark_lost(self, device, error=None) -> bool:
        """Declare one chip lost; → True on the transition (False when
        already lost). The callback + flight event fire once."""
        k = self._key(device)
        with self._mu:
            self._known.setdefault(k, device)
            if k in self._lost:
                return False
            self._lost[k] = device
            n_lost = len(self._lost)
        if self._gauge is not None:
            self._gauge.set(float(n_lost))
        flight.record(
            "chip_lost", device=str(k), lost=n_lost,
            error=None if error is None else repr(error),
        )
        if self._on_lost is not None:
            try:
                self._on_lost(device)
            except Exception:
                pass  # a broken hook must not disable chip tracking
        return True

    def mark_recovered(self, device) -> bool:
        k = self._key(device)
        with self._mu:
            if k not in self._lost:
                return False
            del self._lost[k]
            n_lost = len(self._lost)
        if self._gauge is not None:
            self._gauge.set(float(n_lost))
        flight.record("chip_recovered", device=str(k), lost=n_lost)
        if self._on_recover is not None:
            try:
                self._on_recover(device)
            except Exception:
                pass
        return True


class HealthReporter:
    """Worker-side heartbeat: beats every ``interval_s``, reconnecting
    with backoff through coordinator outages/restarts."""

    def __init__(
        self,
        host: str,
        port: int,
        worker_id: str,
        interval_s: float = 0.5,
        reconnect_backoff_s: float = 0.2,
        snapshot_fn: Optional[Callable[[], dict]] = None,
        on_control: Optional[Callable[[dict], None]] = None,
    ):
        """``snapshot_fn`` (optional) is called once per beat and its
        dict rides along as the beat's ``"metrics"`` field — pass a
        registry's ``struct_snapshot`` so the coordinator/supervisor
        can serve this worker's metrics without a second protocol.
        ``on_control`` (optional) opts in to the control channel: each
        beat advertises the last applied control seq and the hook
        receives every newer control document the coordinator holds
        (the rollout broadcast path). Exceptions it raises are
        swallowed — liveness outranks control application."""
        self._addr = (host, port)
        self._id = worker_id
        self._interval = interval_s
        self._backoff = reconnect_backoff_s
        self._snapshot_fn = snapshot_fn
        self._on_control = on_control
        # False once a reply timed out: a pre-control coordinator never
        # acks, and blocking a heartbeat on it every beat would turn the
        # control channel into a liveness hazard
        self._expect_replies = on_control is not None
        self._ctl_seq = 0
        self._stop = threading.Event()
        self._seq = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def _recv_raising(conn: socket.socket, n: int) -> bytes:
        """Exact read that RAISES (timeout/OSError/closed peer): the
        reporter needs to tell 'no reply coming' (socket.timeout) apart
        from 'connection died' (everything else) — recv_exact folds
        both into None."""
        buf = bytearray()
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return bytes(buf)

    def _read_control_reply(self, conn: socket.socket) -> bool:
        """Consume the coordinator's per-beat control ack; → False when
        the connection must be torn down (reconnect path)."""
        try:
            (m,) = _U32.unpack(self._recv_raising(conn, 4))
            if m > _MAX_FRAME:
                raise ConnectionError(f"oversized control reply: {m}")
            reply = json.loads(self._recv_raising(conn, m))
        except socket.timeout:
            # no ack within the socket timeout: a pre-control
            # coordinator — stop expecting replies, keep beating
            self._expect_replies = False
            return True
        except (OSError, ValueError):
            return False
        if isinstance(reply, dict) and self._on_control is not None:
            docs = reply.get("controls")
            if not isinstance(docs, list):  # older coordinator wire form
                docs = [reply.get("control")]
            for doc in docs:
                if isinstance(doc, dict):
                    try:
                        self._on_control(doc)
                    except Exception:
                        pass  # a broken hook must not stop the heartbeat
        seq = reply.get("ctl_seq") if isinstance(reply, dict) else None
        if isinstance(seq, (int, float)):
            self._ctl_seq = max(self._ctl_seq, int(seq))
        return True

    def _run(self) -> None:
        conn: Optional[socket.socket] = None
        while not self._stop.is_set():
            if conn is None:
                try:
                    conn = socket.create_connection(self._addr, timeout=1.0)
                    conn.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                except OSError:
                    conn = None
                    self._stop.wait(self._backoff)
                    continue
            beat = {"id": self._id, "seq": self._seq}
            if self._snapshot_fn is not None:
                try:
                    # the cardinality governor bounds the heartbeat
                    # frame exactly like scrape pages and history
                    # frames: at zoo scale an ungoverned snapshot
                    # carries one series per tenant toward _MAX_FRAME
                    # every beat (FJT_METRICS_MAX_SERIES unset:
                    # identity)
                    beat["metrics"] = govern_struct(self._snapshot_fn())
                except Exception:
                    # a broken snapshot hook must not stop the
                    # heartbeat — liveness outranks metrics
                    pass
            if self._expect_replies:
                beat["ctl"] = self._ctl_seq
            payload = json.dumps(beat, default=repr).encode()
            self._seq += 1
            try:
                conn.sendall(_U32.pack(len(payload)) + payload)
            except OSError:
                try:
                    conn.close()
                except OSError:
                    pass
                conn = None
                continue
            if self._expect_replies and not self._read_control_reply(conn):
                try:
                    conn.close()
                except OSError:
                    pass
                conn = None
                continue
            self._stop.wait(self._interval)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
