"""Shared socket helpers for the framed-TCP servers/monitors.

The port's copy of ``flink_jpmml_tpu/utils/netio.py``, with the import
lines renamed.

The canonical EOF/error-tolerant exact read: returns ``None`` on a
closed peer OR a socket error, so accept-side loops treat both as "this
connection is done" without a try/except at every call site. (The
*client*-side readers in runtime/net.py and runtime/kafka.py keep their
raising variants on purpose — their reconnect logic is driven by the
exception path.)
"""

from __future__ import annotations

import socket
from typing import Optional


def recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    # recv_into a preallocated buffer: no per-chunk bytes objects or
    # append-resize churn; ONE final copy remains, to keep the bytes
    # return type (KafkaClient._recv_exact, client-side and hotter,
    # returns the bytearray itself)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = conn.recv_into(view[got:])
        except OSError:
            return None
        if not r:
            return None
        got += r
    return bytes(buf)
