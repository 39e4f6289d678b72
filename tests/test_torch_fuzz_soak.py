"""The port's soak tool (``python -m flink_jpmml_tpu_torch.tools.fuzz_soak``)
on the CPU: every profile through its own entry in a subprocess with
``--platform cpu``, a forced parity failure, and the refusals — no card
without ``--platform cpu``, no mesh on fewer devices than it needs.

Each run has its own temporary directory (``TMPDIR``, the flight
recorder's and the autotune cache's), the brokers bind free ports, and
the ``FJT_*`` environment is the test's own, so the file runs under
xdist beside the others."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from flink_jpmml_tpu_torch.tools import fuzz_soak
from flink_jpmml_tpu_torch.utils.exceptions import DeviceUnavailableError

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOL = ["-m", "flink_jpmml_tpu_torch.tools.fuzz_soak"]


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FJT_")}
    env.update({
        "TMPDIR": str(tmp_path),
        "FJT_FLIGHT_DIR": str(tmp_path / "flight"),
        "FJT_AUTOTUNE_CACHE": str(tmp_path / "autotune" / "autotune.json"),
    })
    return env


def run_tool(tmp_path, *args, prelude=None, timeout=600):
    """The tool in a subprocess from the repo root; ``prelude`` (code
    run first) patches the tool's modules in that process."""
    argv = [sys.executable]
    if prelude is None:
        argv += TOOL + list(args)
    else:
        argv += ["-c", prelude + "\nimport sys\nfrom flink_jpmml_tpu_torch."
                 "tools import fuzz_soak\nsys.exit(fuzz_soak.main("
                 f"{list(args)!r}))"]
    return subprocess.run(argv, cwd=ROOT, env=_env(tmp_path),
                          capture_output=True, text=True, timeout=timeout)


def _ok(proc):
    assert proc.returncode == 0, (
        f"rc={proc.returncode}\nstdout:\n{proc.stdout}\n"
        f"stderr:\n{proc.stderr[-3000:]}")
    assert proc.stdout.startswith("device: cpu\n"), proc.stdout


@pytest.mark.parametrize("family", sorted(fuzz_soak.FAMILIES))
def test_family_two_seeds(tmp_path, family):
    proc = run_tool(tmp_path, "--platform", "cpu", "--families", family,
                    "--seeds", "2")
    _ok(proc)
    assert f"{family}: 2/2 seeds clean" in proc.stdout


@pytest.mark.parametrize("flags,seeds,name", [
    (["--chaos"], 2, "chaos"),
    (["--chaos", "--zoo"], 1, "zoo-chaos"),
    (["--chaos", "--stateful"], 1, "stateful-chaos"),
    (["--chaos", "--mesh"], 1, "mesh-chaos"),
], ids=["chaos", "zoo", "stateful", "mesh"])
def test_chaos_profile(tmp_path, flags, seeds, name):
    proc = run_tool(tmp_path, "--platform", "cpu", *flags,
                    "--seeds", str(seeds))
    _ok(proc)
    assert f"{name}: {seeds}/{seeds} seeds clean" in proc.stdout


@pytest.mark.slow
def test_mesh_chaos_three_seeds(tmp_path):
    """tests/test_mesh_hotpath.py's slow soak, on the port's CPU mesh."""
    proc = run_tool(tmp_path, "--platform", "cpu", "--chaos", "--mesh",
                    "--seeds", "3", "--start", "7")
    _ok(proc)
    assert "mesh-chaos: 3/3 seeds clean" in proc.stdout


def test_a_parity_failure_exits_nonzero_naming_the_seed(tmp_path):
    # the oracle is patched to move every value: the family's assertion
    # fails on the first lane with a value
    prelude = (
        "import dataclasses\n"
        "from flink_jpmml_tpu_torch.tools import fuzzgen\n"
        "_real = fuzzgen.evaluate\n"
        "def _off(doc, rec):\n"
        "    r = _real(doc, rec)\n"
        "    if r.value is None:\n"
        "        return r\n"
        "    return dataclasses.replace(r, value=r.value + 1.0)\n"
        "fuzzgen.evaluate = _off\n"
    )
    proc = run_tool(tmp_path, "--platform", "cpu", "--families",
                    "regression", "--seeds", "1", "--start", "123",
                    prelude=prelude)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "FAIL regression seed=123: regression seed=123 record" \
        in proc.stdout
    assert "regression: 0/1 seeds clean" in proc.stdout


def test_an_unknown_family_exits_2(tmp_path):
    proc = run_tool(tmp_path, "--platform", "cpu", "--families", "nope",
                    "--seeds", "1")
    assert proc.returncode == 2 and "unknown family 'nope'" in proc.stdout


def test_no_card_without_platform_cpu_raises(tmp_path):
    assert not torch.cuda.is_available()
    proc = run_tool(tmp_path, "--seeds", "1")
    assert proc.returncode != 0
    assert "DeviceUnavailableError" in proc.stderr
    assert "seeds clean" not in proc.stdout


def test_mesh_on_fewer_devices_raises_naming_the_count(monkeypatch, capsys):
    # a host that shows one card: the profile refuses before any seed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(DeviceUnavailableError, match="found 1 card"):
        fuzz_soak.main(["--chaos", "--mesh", "--platform", "cuda",
                        "--seeds", "1"])
    assert "seeds clean" not in capsys.readouterr().out


def test_chaos_counts_and_restores_the_environment(monkeypatch, tmp_path):
    for k in ("FJT_DEVICE_RETRIES", "FJT_RETRY_BASE_S",
              "FJT_FAILOVER_COOLDOWN_S", "FJT_FAILOVER_GREENS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("FJT_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    r = fuzz_soak.soak_chaos(7, torch.device("cpu"))
    assert r["delivered"] + r["dlq"] == r["records"]
    assert r["delivered_twice"] == 0
    assert "FJT_DEVICE_RETRIES" not in os.environ
    assert "FJT_RETRY_BASE_S" not in os.environ
