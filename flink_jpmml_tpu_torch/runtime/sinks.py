"""Stream sinks: where scored predictions land.

The port's copy of ``flink_jpmml_tpu/runtime/sinks.py``, with the import
line renamed.

Reference parity: Flink sinks; tests used "sink into a static concurrent
collection, assert collected predictions" (SURVEY.md §5) — that's
:class:`CollectSink` here.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, List, Sequence


class Sink:
    def emit(self, items: Sequence[Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CollectSink(Sink):
    """Thread-safe in-memory collector (the test harness sink)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: List[Any] = []

    def emit(self, items: Sequence[Any]) -> None:
        with self._lock:
            self._items.extend(items)

    @property
    def items(self) -> List[Any]:
        with self._lock:
            return list(self._items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class CallbackSink(Sink):
    def __init__(self, fn: Callable[[Sequence[Any]], None]):
        self._fn = fn

    def emit(self, items: Sequence[Any]) -> None:
        self._fn(items)


class NullSink(Sink):
    """Discards everything (benchmark mode: measures the scoring path only)."""

    def __init__(self) -> None:
        self.count = 0

    def emit(self, items: Sequence[Any]) -> None:
        self.count += len(items)


class JsonlFileSink(Sink):
    def __init__(self, path: str):
        self._f = open(path, "a", encoding="utf-8")

    def emit(self, items: Sequence[Any]) -> None:
        for it in items:
            self._f.write(json.dumps(it, default=_jsonify) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _jsonify(o: Any):
    from flink_jpmml_tpu_torch.models.prediction import EmptyScore, Prediction, Score

    if isinstance(o, Prediction):
        return {
            "empty": o.is_empty,
            "value": None if o.is_empty else o.score.value,
            "label": o.target.label if o.target else None,
        }
    if isinstance(o, Score):
        return o.value
    if isinstance(o, EmptyScore):
        return None
    return str(o)
