"""The port's device bootstrap (``flink_jpmml_tpu_torch/utils/demo.py``)
held to the JAX package's ``utils/demo.py`` on the CPU.

The JAX tests' three cases run through both packages: the ``--platform``
flag is parsed and stripped, ``FJT_PLATFORM`` is the fall-back, and a
resolve without either returns the backend with no re-exec. Then the
port's own policy: without a card and without a flag it raises
``DeviceUnavailableError``, a platform that is neither the CPU nor the
card raises ``ValueError``, ``--backend-timeout`` raises
``NotPortedError``, and ``os.execv`` is never called.
"""

import os
import sys

import pytest
import torch

from flink_jpmml_tpu.utils import demo as jdemo
from flink_jpmml_tpu_torch.utils import demo as tdemo
from flink_jpmml_tpu_torch.utils.exceptions import (
    DeviceUnavailableError,
    NotPortedError,
)


@pytest.fixture(autouse=True)
def _no_execv(monkeypatch):
    fired = []
    monkeypatch.setattr(os, "execv", lambda *a: fired.append(a))
    monkeypatch.delenv("FJT_PLATFORM", raising=False)
    yield
    assert not fired, "a bootstrap re-exec'd the process"


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_platform_flag_parsed_and_stripped(monkeypatch):
    argv = ["ex.py", "--platform", "cpu", "--trees", "7"]
    monkeypatch.setattr(sys, "argv", list(argv))
    assert jdemo.demo_backend() == "cpu"
    jax_rest = list(sys.argv)
    monkeypatch.setattr(sys, "argv", list(argv))
    assert tdemo.demo_backend() == "cpu"
    assert sys.argv == jax_rest == ["ex.py", "--trees", "7"]


def test_env_var_default(monkeypatch):
    monkeypatch.setenv("FJT_PLATFORM", "cpu")
    for demo in (jdemo, tdemo):
        monkeypatch.setattr(sys, "argv", ["ex.py"])
        assert demo.demo_backend() == "cpu"
        assert sys.argv == ["ex.py"]


def test_resolved_backend_returned_without_flag(monkeypatch):
    # the JAX twin resolves its default backend (cpu under the test
    # conftest) under a watchdog; the port has none, and on a host with
    # a card resolves it with nothing to re-exec
    monkeypatch.setattr(sys, "argv", ["ex.py"])
    assert jdemo.demo_backend(timeout_s=30.0) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(sys, "argv", ["ex.py"])
    assert tdemo.demo_backend() == "cuda"


@pytest.mark.parametrize("value", ["gpu", "cuda"])
def test_card_platforms_resolve_to_the_card(monkeypatch, value):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tdemo.resolve_backend(value) == "cuda"
    assert tdemo.platform_device(value).type == "cuda"


@pytest.mark.parametrize("value", ["cuda:0", "cuda:1", "cuda:7"])
def test_card_by_index_raises(monkeypatch, value):
    # the jobs run on the current card, so an index would be dropped
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES"):
        tdemo.resolve_backend(value)
    monkeypatch.setattr(sys, "argv", ["ex.py", "--platform", value])
    with pytest.raises(ValueError, match="by index"):
        tdemo.demo_backend()


@pytest.mark.parametrize("argv", [["ex.py"], ["ex.py", "--platform", "gpu"],
                                  ["ex.py", "--platform", "cuda"]])
def test_no_card_raises(monkeypatch, no_card, argv):
    monkeypatch.setattr(sys, "argv", list(argv))
    with pytest.raises(DeviceUnavailableError):
        tdemo.demo_backend()


def test_no_card_with_env_cpu_runs_on_the_cpu(monkeypatch, no_card):
    monkeypatch.setenv("FJT_PLATFORM", "cpu")
    monkeypatch.setattr(sys, "argv", ["ex.py", "-n", "3"])
    assert tdemo.demo_backend() == "cpu"
    assert sys.argv == ["ex.py", "-n", "3"]


@pytest.mark.parametrize("value", ["tpu", "TPU", "cpu:0", "metal"])
def test_other_platforms_raise(monkeypatch, value):
    monkeypatch.setattr(sys, "argv", ["ex.py", "--platform", value])
    with pytest.raises(ValueError, match="unknown platform"):
        tdemo.demo_backend()
    monkeypatch.setenv("FJT_PLATFORM", value)
    with pytest.raises(ValueError, match="unknown platform"):
        tdemo.resolve_backend(None)


def test_backend_timeout_is_not_ported(monkeypatch):
    monkeypatch.setattr(
        sys, "argv", ["ex.py", "--platform", "cpu", "--backend-timeout", "5"])
    with pytest.raises(NotPortedError, match="re-execs"):
        tdemo.demo_backend()
    with pytest.raises(NotPortedError, match="--backend-timeout"):
        tdemo.resolve_backend("cpu", timeout_s=60.0)
