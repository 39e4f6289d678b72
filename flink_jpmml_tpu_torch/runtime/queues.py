"""Bounded queue with fill-or-deadline batch draining.

The port's copy of ``flink_jpmml_tpu/runtime/queues.py``, unchanged.

The reference's backpressure came from Flink's credit-based network stack
(SURVEY.md §3 row D1, EXT-A); ours is a bounded host-side queue between
sources and the device loop: producers block when the device falls behind,
and the consumer drains *batches* — up to ``max_n`` records, waiting at most
``deadline_us`` after the first record arrives (SURVEY.md §8 step 3
"fill-or-deadline"). This is the latency/throughput control point: a full
batch ships immediately; a trickle ships after the deadline with padding.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional


class Closed(Exception):
    """The queue was closed and fully drained."""


class BoundedQueue:
    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0: {capacity}")
        self._capacity = capacity
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        """Blocking put; returns False on timeout, raises Closed if closed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_full:
            while len(self._items) >= self._capacity:
                if self._closed:
                    raise Closed()
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._not_full.wait(remaining)
            if self._closed:
                raise Closed()
            self._items.append(item)
            self._not_empty.notify()
            return True

    def drain(self, max_n: int, deadline_us: int) -> List[Any]:
        """Take up to ``max_n`` items.

        Blocks until at least one item is available (or the queue closes —
        then raises :class:`Closed` once empty). After the first item, keeps
        taking until ``max_n`` or until ``deadline_us`` microseconds have
        elapsed since the first item was taken.
        """
        out: List[Any] = []
        with self._not_empty:
            while not self._items:
                if self._closed:
                    raise Closed()
                self._not_empty.wait(0.1)
            take = min(max_n, len(self._items))
            for _ in range(take):
                out.append(self._items.popleft())
            self._not_full.notify_all()
        if len(out) >= max_n:
            return out
        deadline = time.monotonic() + deadline_us / 1e6
        while len(out) < max_n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            with self._not_empty:
                if not self._items:
                    if self._closed:
                        break
                    self._not_empty.wait(min(remaining, 0.05))
                take = min(max_n - len(out), len(self._items))
                for _ in range(take):
                    out.append(self._items.popleft())
                if take:
                    self._not_full.notify_all()
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def capacity(self) -> int:
        return self._capacity

    def occupancy(self) -> float:
        """Fill fraction in [0, 1] — the queue-side input to the
        composite backpressure score (obs/pressure.py): producers are
        blocked exactly when this sits at 1.0."""
        with self._lock:
            return min(len(self._items) / self._capacity, 1.0)
