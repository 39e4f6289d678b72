"""The nine example jobs of ``examples_torch/`` held to their JAX twins in
``examples/`` on the CPU.

Each port job runs in-process with ``--platform cpu`` at small sizes
through its own flags. Where a job prints scores or labels, the JAX job
runs at the same flags (always with ``--platform cpu``, so its backend
watchdog never arms) and the printed numbers must agree at rtol 1e-4 /
atol 1e-5, labels exactly; rates and temporary paths are not compared.
The jobs that print no scores (``gbm_throughput``, ``kafka_stream``,
``supervised_pipeline``) must exit cleanly, score records and, for the two
kernel jobs, report their dispatches. An AST walk shows that no file under
``examples_torch/`` imports ``flink_jpmml_tpu`` or ``jax``.
"""

import ast
import os
import re
import runpy
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "examples_torch")
JAX_DIR = os.path.join(REPO, "examples")
JOBS = ["iris_streaming", "mnist_mlp", "kmeans_anomaly", "dynamic_serving",
        "gbm_throughput", "kafka_stream", "stacked_sharded",
        "supervised_pipeline", "model_zoo"]
_NUM = re.compile(r"-?\d+(?:,\d{3})*(?:\.\d+)?(?:e[-+]?\d+)?")
_TMP = re.compile(r"/tmp/fjt-[\w-]+/|/[\w/.-]*/fjt-[\w-]+/")


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("FJT_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.delenv("FJT_PLATFORM", raising=False)


def _run(directory, job, args, capsys, monkeypatch):
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{job}.py", "--platform", "cpu",
                                      *args])
    runpy.run_path(os.path.join(directory, f"{job}.py"),
                   run_name="__main__")
    return capsys.readouterr().out


def _split(text):
    """Printed text → (its words with numbers and paths blanked, the
    numbers)."""
    text = _TMP.sub("<tmp>/", text)
    # the JAX mesh's shape is an OrderedDict, the port's a dict
    text = re.sub(r"OrderedDict\((\{[^}]*\})\)", r"\1", text)
    nums = [float(n.replace(",", "")) for n in _NUM.findall(text)]
    return _NUM.sub("#", text), nums


def _agree(port_out, jax_out, skip=()):
    """Line by line: the same words, the same numbers at rtol 1e-4 /
    atol 1e-5. Lines that start with an entry of ``skip`` (rates,
    timings) are left out."""
    def keep(out):
        return [ln for ln in out.splitlines()
                if not ln.startswith(tuple(skip))]

    p_lines, j_lines = keep(port_out), keep(jax_out)
    assert len(p_lines) == len(j_lines), (port_out, jax_out)
    for p, j in zip(p_lines, j_lines):
        pw, pn = _split(p)
        jw, jn = _split(j)
        assert pw == jw, (p, j)
        assert pn == pytest.approx(jn, rel=1e-4, abs=1e-5), (p, j)


@pytest.mark.parametrize("job,args,skip", [
    ("iris_streaming", [], ("metrics:", "model:")),
    ("mnist_mlp", [], ("model:",)),
    ("kmeans_anomaly", [], ("model:",)),
    ("dynamic_serving", [], ()),
    ("stacked_sharded", ["--features", "5000", "--trees", "5",
                         "--batch", "256"], ()),
    ("model_zoo", [], ()),
])
def test_job_prints_what_the_jax_job_prints(job, args, skip, capsys,
                                            monkeypatch):
    port_out = _run(PORT_DIR, job, args, capsys, monkeypatch)
    jax_out = _run(JAX_DIR, job, args, capsys, monkeypatch)
    assert port_out.startswith("backend: cpu\n")
    _agree(port_out, jax_out, skip=skip)


def test_gbm_throughput_scores_through_the_walk_kernel_wrapper(
        capsys, monkeypatch):
    out = _run(PORT_DIR, "gbm_throughput", [
        "--trees", "20", "--features", "8", "--batch", "1024",
        "--seconds", "0.5"], capsys, monkeypatch)
    assert "kernel backend: cuda_plain" in out
    assert "pipeline backend: rank_wire_cuda_plain" in out
    scored = int(re.search(r"scored ([\d,]+) records", out)
                 .group(1).replace(",", ""))
    dispatches = float(re.search(r"'dispatches': ([\d.]+)", out).group(1))
    assert scored > 0 and dispatches > 0


def test_kafka_stream_scores_every_record_once(capsys, monkeypatch):
    out = _run(PORT_DIR, "kafka_stream", [], capsys, monkeypatch)
    assert "scored all 20000 records exactly once" in out
    runs = re.findall(r"run \d metrics: .*'dispatches': ([\d.]+)", out)
    assert len(runs) == 2 and sum(float(d) for d in runs) > 0


def test_supervised_pipeline_restarts_its_worker(capsys, monkeypatch):
    # the workers inherit a 5 ms dispatch delay, so the kill lands while
    # the log still has records to score
    monkeypatch.setenv("FJT_FAULTS", "dispatch_delay:delay_ms=5")
    out = _run(PORT_DIR, "supervised_pipeline", [], capsys, monkeypatch)
    assert "[supervisor] restarted scorer (restart #1)" in out
    assert "final committed offset 30,000 / 30,000" in out


@pytest.mark.parametrize("job", JOBS)
def test_twin_imports_neither_jax_nor_the_jax_package(job):
    path = os.path.join(PORT_DIR, f"{job}.py")
    src = open(path, encoding="utf-8").read()
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    roots = {m.split(".")[0] for m in mods}
    assert "jax" not in roots and "flink_jpmml_tpu" not in roots, roots
    assert "flink_jpmml_tpu_torch" in roots
    # code run from strings (the supervised job's worker) too
    assert not re.search(r"\bimport jax\b|flink_jpmml_tpu\.(?!_)", src)
    assert "demo_backend()" in src
