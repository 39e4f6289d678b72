"""Network streaming: an offset-replayable framed-TCP record feed.

The port's copy of ``flink_jpmml_tpu/runtime/net.py``, with the import
lines renamed: the same ``FJT1`` frames and offset domain, so a
``BlockFrameServer`` of either package feeds a source of the other. It
imports the port's ``runtime/block.BlockSource`` and
``runtime/sources``; a ``TcpBlockSource`` feeds ``BlockPipeline`` on the
card like any other block source.

The reference gets network ingestion from Flink's connector ecosystem.
This module is the in-tree equivalent: a
deliberately tiny Kafka-style *pull* protocol — offset-addressed fetch
over TCP with length-prefixed frames — so sources get exact resume
semantics without an external broker. The real Kafka-wire counterpart
lives in :mod:`flink_jpmml_tpu_torch.runtime.kafka` (actual binary protocol:
Fetch v4, magic-2 record batches, CRC32C) behind the same
Source/BlockSource interfaces; this simpler protocol remains for
low-dependency drills and as the block-frame push server.

Protocol (little-endian):
  client → server on connect:  magic ``b"FJT1"`` + u64 start_offset
  server → client frames:      u32 body_len, then body:
      u8 kind
      kind 1 (f32 block):    u64 first_offset, u32 n_rows, u32 n_cols,
                             n_rows*n_cols f32
      kind 2 (end-of-stream): empty
      kind 3 (JSON records): u64 first_offset, u32 count,
                             newline-joined JSON docs

Offset domain (ONE domain end to end — frames, sources, checkpoints):
an offset k always means "k records consumed"; equivalently, the next
record to serve/score has 0-based index k. A frame's ``first_offset`` is
the consumed-count *before* its first record (= that record's index), and
the offset checkpointed after scoring a record of index i is ``i + 1``
(see :func:`consumed_offset` — the only index→offset conversion in this
module). ``seek(k)`` therefore passes a checkpointed engine offset to the
frame protocol *unchanged*: both mean "resume at record index k". A
client (re)connects at its next-needed offset and the server replays from
there — the Kafka consumer model in miniature. Client-side reconnect is
automatic: a dropped connection (server restart, network blip) retries
with backoff from the exact next offset, so no record is lost or
duplicated across the blip.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from flink_jpmml_tpu_torch.obs import recorder as flight
from flink_jpmml_tpu_torch.runtime.block import BlockSource
from flink_jpmml_tpu_torch.runtime.sources import Polled, Record, Source

MAGIC = b"FJT1"
KIND_BLOCK = 1
KIND_EOS = 2
KIND_RECORDS = 3

_HDR = struct.Struct("<I")  # frame body length
_BLOCK_HDR = struct.Struct("<BQII")  # kind, first_offset, n_rows, n_cols
_REC_HDR = struct.Struct("<BQI")  # kind, first_offset, count
_REQ = struct.Struct("<4sQ")  # magic, start_offset


def consumed_offset(record_index: int) -> int:
    """Record index → checkpoint offset ("records consumed through this
    record"). The inverse direction needs no conversion: a checkpointed
    offset k IS the index of the next record, so ``seek(k)`` forwards k
    to the frame protocol verbatim. This is the single place the two
    representations of the one offset domain meet (module docstring)."""
    return record_index + 1


class BlockFrameServer:
    """Serves a replayable record log over the frame protocol.

    ``data`` is either an ``[N, F]`` float32 array (block frames) or a
    sequence of dict records (JSON frames). Any client may fetch from any
    offset — the log is fully replayable, which is what gives the sources
    their exact-resume contract. ``cycle=True`` serves an endless stream
    (offset o maps to row ``o % N``; offsets keep growing) for load tests.
    """

    def __init__(
        self,
        data,
        block_size: int = 1024,
        port: int = 0,
        cycle: bool = False,
        throttle_s: float = 0.0,
        host: str = "127.0.0.1",
    ):
        """``host`` is the bind interface — default loopback for tests;
        pass ``"0.0.0.0"`` (or a specific NIC address) to serve remote
        workers in a multi-host deployment."""
        self._throttle = throttle_s
        if isinstance(data, np.ndarray):
            self._arr: Optional[np.ndarray] = np.ascontiguousarray(
                data, np.float32
            )
            self._recs: Optional[List[Record]] = None
            self._n = self._arr.shape[0]
        else:
            self._arr = None
            self._recs = list(data)
            self._n = len(self._recs)
        self._block = block_size
        self._cycle = cycle
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fjt-net-accept", daemon=True
        )
        self._accept_thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        for t in self._threads:
            t.join(timeout=2.0)

    # -- internals ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_client, args=(conn,), daemon=True
            )
            t.start()
            # keep the handler list bounded across reconnect churn
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_client(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            req = _recv_exact(conn, _REQ.size)
            if req is None:
                return
            magic, offset = _REQ.unpack(req)
            if magic != MAGIC:
                return
            while not self._stop.is_set():
                if not self._cycle and offset >= self._n:
                    conn.sendall(_HDR.pack(1) + bytes([KIND_EOS]))
                    return
                n = min(self._block, (self._n - offset) if not self._cycle
                        else self._block)
                if self._arr is not None:
                    rows = (
                        self._arr[offset % self._n : offset % self._n + n]
                        if not self._cycle
                        else np.take(
                            self._arr,
                            np.arange(offset, offset + n) % self._n,
                            axis=0,
                        )
                    )
                    body = (
                        _BLOCK_HDR.pack(
                            KIND_BLOCK, offset, rows.shape[0], rows.shape[1]
                        )
                        + rows.tobytes()
                    )
                else:
                    recs = [
                        self._recs[(offset + i) % self._n] for i in range(n)
                    ]
                    payload = "\n".join(json.dumps(r) for r in recs).encode()
                    body = _REC_HDR.pack(KIND_RECORDS, offset, n) + payload
                conn.sendall(_HDR.pack(len(body)) + body)  # TCP backpressure
                offset += n
                if self._throttle:
                    # paced mode: tests use this to pin down "server died
                    # mid-stream" states independent of socket buffering
                    time.sleep(self._throttle)
        except (OSError, BrokenPipeError, ConnectionResetError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class _FrameClient:
    """Shared reconnect-at-offset frame reader for both source flavors."""

    def __init__(self, host: str, port: int, poll_timeout: float = 0.002):
        self._addr = (host, port)
        self._sock: Optional[socket.socket] = None
        self._buf = bytearray()
        self._poll_timeout = poll_timeout
        # adaptive idle backoff: each consecutive empty read doubles the
        # socket timeout (up to _IDLE_TIMEOUT_MAX); any data resets it.
        # Callers that spin on None therefore cost ~20 wakeups/s against
        # an idle or dead server instead of ~500/s at the base timeout.
        self._idle_timeout = poll_timeout
        self._last_retry = 0.0
        self.next_offset = 0
        self.eos = False

    _IDLE_TIMEOUT_MAX = 0.05

    def seek(self, offset: int) -> None:
        self.next_offset = int(offset)
        self.eos = False
        self._disconnect()

    def close(self) -> None:
        self._disconnect()

    def _disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf.clear()

    def _connect(self) -> bool:
        # throttle reconnect attempts so a dead server doesn't spin-burn
        now = time.monotonic()
        if now - self._last_retry < 0.05:
            return False
        self._last_retry = now
        try:
            s = socket.create_connection(self._addr, timeout=1.0)
            s.settimeout(self._idle_timeout)
            s.sendall(_REQ.pack(MAGIC, self.next_offset))
            self._sock = s
            return True
        except OSError:
            return False

    def read_frame(self) -> Optional[bytes]:
        """One frame body, or None when none is currently available.
        Transparently reconnects (from ``next_offset``) on a dropped
        connection — exactly-once across server restarts."""
        if self.eos:
            return None
        if self._sock is None and not self._connect():
            return None
        try:
            while True:
                if len(self._buf) >= _HDR.size:
                    (body_len,) = _HDR.unpack_from(self._buf, 0)
                    if len(self._buf) >= _HDR.size + body_len:
                        body = bytes(
                            self._buf[_HDR.size : _HDR.size + body_len]
                        )
                        del self._buf[: _HDR.size + body_len]
                        if self._idle_timeout != self._poll_timeout:
                            self._idle_timeout = self._poll_timeout
                            self._sock.settimeout(self._idle_timeout)
                        return body
                chunk = self._sock.recv(1 << 20)
                if not chunk:
                    # server went away mid-stream: one event per lost
                    # connection (reconnect ATTEMPTS are throttled spin
                    # and would flood the ring)
                    flight.record(
                        "net_disconnect", peer=f"{self._addr[0]}:"
                        f"{self._addr[1]}", next_offset=self.next_offset,
                    )
                    self._disconnect()
                    return None
                self._buf.extend(chunk)
        except socket.timeout:
            self._idle_timeout = min(
                self._idle_timeout * 2, self._IDLE_TIMEOUT_MAX
            )
            try:
                self._sock.settimeout(self._idle_timeout)
            except OSError:
                pass
            return None
        except OSError:
            flight.record(
                "net_disconnect",
                peer=f"{self._addr[0]}:{self._addr[1]}",
                next_offset=self.next_offset,
            )
            self._disconnect()
            return None


class TcpBlockSource(BlockSource):
    """Network block feed for :class:`BlockPipeline` (config 2's stream).

    ``poll`` returns ``(first_offset, [n, F] f32)`` blocks; ``seek`` makes
    the next fetch start at that record offset (the checkpoint-resume
    hook). The f32 payload is decoded zero-copy via ``np.frombuffer``.
    """

    def __init__(self, host: str, port: int, arity: Optional[int] = None):
        self._client = _FrameClient(host, port)
        self._arity = arity

    def poll(self) -> Optional[Tuple[int, np.ndarray]]:
        body = self._client.read_frame()
        if body is None:
            return None
        kind = body[0]
        if kind == KIND_EOS:
            self._client.eos = True
            return None
        if kind != KIND_BLOCK:
            # a mismatched stream must fail loudly, not complete cleanly
            # with zero records scored
            raise ValueError(
                "stream carries JSON record frames — use TcpRecordSource"
                if kind == KIND_RECORDS
                else f"unknown frame kind {kind}"
            )
        _, first, rows, cols = _BLOCK_HDR.unpack_from(body, 0)
        if self._arity is not None and cols != self._arity:
            raise ValueError(
                f"stream arity {cols} != model arity {self._arity}"
            )
        blk = np.frombuffer(
            body, np.float32, count=rows * cols, offset=_BLOCK_HDR.size
        ).reshape(rows, cols)
        self._client.next_offset = first + rows
        return first, blk

    def seek(self, offset: int) -> None:
        self._client.seek(offset)

    @property
    def exhausted(self) -> bool:
        return self._client.eos

    def close(self) -> None:
        self._client.close()


class TcpRecordSource(Source):
    """Network dict-record feed for the record-object engine Pipeline."""

    def __init__(self, host: str, port: int):
        self._client = _FrameClient(host, port)

    def poll(self, max_n: int) -> Polled:
        out: Polled = []
        while len(out) < max_n:
            body = self._client.read_frame()
            if body is None:
                break
            kind = body[0]
            if kind == KIND_EOS:
                self._client.eos = True
                break
            if kind != KIND_RECORDS:
                raise ValueError(
                    "stream carries f32 block frames — use TcpBlockSource"
                    if kind == KIND_BLOCK
                    else f"unknown frame kind {kind}"
                )
            _, first, count = _REC_HDR.unpack_from(body, 0)
            lines = body[_REC_HDR.size :].decode().split("\n")
            for i, line in enumerate(lines[:count]):
                out.append((consumed_offset(first + i), json.loads(line)))
            self._client.next_offset = first + count
        return out

    def seek(self, offset: int) -> None:
        # checkpointed offset k == index of the next record: one domain,
        # forwarded verbatim (module docstring / consumed_offset)
        self._client.seek(offset)

    @property
    def exhausted(self) -> bool:
        return self._client.eos

    def close(self) -> None:
        self._client.close()
