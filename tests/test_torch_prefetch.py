"""The port's prefetch sidecar (``flink_jpmml_tpu_torch/runtime/prefetch.py``)
against the JAX package's twin over the same inner source, on the CPU: it
keeps order, pauses and discards on ``seek``, re-raises a sidecar
exception from ``poll()``, parks on ``stop_prefetch``, and obeys
``FJT_PREFETCH_DISABLE`` and ``FJT_PREFETCH_DEPTH``."""

import time

import numpy as np
import pytest

from flink_jpmml_tpu.runtime import prefetch as jp
from flink_jpmml_tpu.utils.metrics import MetricsRegistry as JRegistry
from flink_jpmml_tpu_torch.runtime import prefetch as tp
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

TWINS = [(jp, JRegistry), (tp, TRegistry)]


class ScriptedSource:
    """A finite block source of ``n_blocks`` blocks of ``size`` rows whose
    values are their offsets; ``fail_at`` makes that poll raise once."""

    prefetchable = True

    def __init__(self, n_blocks=40, size=5, fail_at=None):
        self._size = size
        self._n = n_blocks * size
        self._pos = 0
        self._fail_at = fail_at
        self.polls = 0

    def poll(self):
        self.polls += 1
        if self._fail_at is not None and self.polls == self._fail_at:
            self._fail_at = None
            raise RuntimeError("inner source broke")
        if self._pos >= self._n:
            return None
        off = self._pos
        self._pos = min(self._pos + self._size, self._n)
        rows = np.arange(off, self._pos, dtype=np.float32)[:, None]
        return off, np.repeat(rows, 3, axis=1)

    def seek(self, offset):
        self._pos = offset

    @property
    def exhausted(self):
        return self._pos >= self._n

    def close(self):
        pass


def _drain(src, timeout=10.0):
    got = []
    deadline = time.monotonic() + timeout
    while not src.exhausted and time.monotonic() < deadline:
        polled = src.poll()
        if polled is not None:
            got.append((polled[0], polled[1].tobytes()))
    return got


def _both(fn):
    """``fn(prefetch_module, registry)`` for the JAX twin and the port."""
    return [fn(mod, reg()) for mod, reg in TWINS]


def test_keeps_order_and_counts_like_the_jax_twin():
    def run(mod, reg):
        src = mod.PrefetchedBlockSource(ScriptedSource(), depth=2, metrics=reg)
        try:
            got = _drain(src)
        finally:
            src.stop_prefetch()
        snap = reg.struct_snapshot()
        return (got, snap["counters"]["prefetch_batches"],
                snap["counters"]["prefetch_records"]), \
            snap["gauges"]["prefetch_depth"]["max"]

    (jax_run, jax_depth), (port_run, port_depth) = _both(run)
    # order, bytes and counts are fixed by the source; how full the
    # handoff queue ever got depends on how the threads were scheduled,
    # so each twin's high-water mark is held to the queue's bounds alone
    assert port_run == jax_run
    got, batches, records = port_run
    assert [off for off, _ in got] == list(range(0, 200, 5))
    assert (batches, records) == (40, 200)
    assert 1 <= port_depth <= 2 and 1 <= jax_depth <= 2


def test_seek_pauses_and_discards_prefetched_batches():
    def run(mod, reg):
        inner = ScriptedSource()
        src = mod.PrefetchedBlockSource(inner, depth=4, metrics=reg)
        try:
            deadline = time.monotonic() + 5
            first = None
            while first is None and time.monotonic() < deadline:
                # a poll waits only briefly for the sidecar's first block
                first = src.poll()
            deadline = time.monotonic() + 5
            while len(src._q) < 4 and time.monotonic() < deadline:
                time.sleep(0.001)  # the sidecar ran ahead
            src.seek(100)
            assert len(src._q) == 0 and not src._busy
            got = _drain(src)
        finally:
            src.stop_prefetch()
        return first[0], got

    jax_run, port_run = _both(run)
    assert port_run[0] == 0
    assert [off for off, _ in port_run[1]] == list(range(100, 200, 5))
    assert port_run == jax_run


def test_sidecar_exception_is_re_raised_from_poll():
    def run(mod, reg):
        src = mod.PrefetchedBlockSource(ScriptedSource(fail_at=3), depth=2,
                                        metrics=reg)
        got = []
        try:
            with pytest.raises(RuntimeError, match="inner source broke"):
                deadline = time.monotonic() + 5
                while time.monotonic() < deadline:
                    polled = src.poll()
                    if polled is not None:
                        got.append(polled[0])
            # sticky until a seek clears it
            with pytest.raises(RuntimeError, match="inner source broke"):
                src.poll()
            src.seek(190)
            after = _drain(src)
        finally:
            src.stop_prefetch()
        return got, [off for off, _ in after]

    jax_run, port_run = _both(run)
    assert port_run == jax_run
    assert port_run[0] == [0, 5] and port_run[1] == [190, 195]


def test_stop_prefetch_parks_the_sidecar():
    def run(mod, reg):
        src = mod.PrefetchedBlockSource(ScriptedSource(n_blocks=10_000),
                                        depth=2, metrics=reg)
        src.poll()
        t = src._thread
        assert t is not None and t.is_alive()
        src.stop_prefetch()
        assert not t.is_alive()
        polls = src._inner.polls
        time.sleep(0.05)
        # what was queued before the stop is still handed out, then None
        queued = []
        while (polled := src.poll()) is not None:
            queued.append(polled[0])
        return src._inner.polls == polls, len(queued) <= 2, src.poll()

    assert _both(run) == [(True, True, None), (True, True, None)]


@pytest.mark.parametrize("enable", [None, True, False])
@pytest.mark.parametrize("disabled", [False, True])
def test_wrap_rules_and_the_kill_switch(monkeypatch, enable, disabled):
    if disabled:
        monkeypatch.setenv("FJT_PREFETCH_DISABLE", "1")
    else:
        monkeypatch.delenv("FJT_PREFETCH_DISABLE", raising=False)

    class Plain(ScriptedSource):
        prefetchable = False

    for inner_cls in (ScriptedSource, Plain):
        wrapped = []
        for mod, reg in TWINS:
            inner = inner_cls()
            w = mod.maybe_wrap_block(inner, metrics=reg(), enable=enable)
            wrapped.append(w is not inner)
            if w is not inner:
                assert mod.maybe_wrap_block(w, enable=True) is w
                w.stop_prefetch()
        assert wrapped[0] == wrapped[1]
        want = not disabled and (
            enable if enable is not None else inner_cls.prefetchable)
        assert wrapped[1] == want
    assert tp.env_disabled() == jp.env_disabled() == disabled


@pytest.mark.parametrize("value,depth", [(None, 4), ("7", 7), ("0", 1),
                                         ("x", 4)])
def test_depth_env(monkeypatch, value, depth):
    if value is None:
        monkeypatch.delenv("FJT_PREFETCH_DEPTH", raising=False)
    else:
        monkeypatch.setenv("FJT_PREFETCH_DEPTH", value)
    assert tp.env_depth() == jp.env_depth() == depth
