"""The port's metric-name lint (``python -m
flink_jpmml_tpu_torch.tools.metrics_lint``): the names the port registers
against the operator catalogue (docs/operations.md) and the port's delta
table, and the merge rules against the port's ``utils/metrics.py``.

The drift cases run on temporary copies of the package's sources, the
catalogue and the delta table; the tree itself is read only."""

import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "flink_jpmml_tpu_torch"
DOCS = ROOT / "docs" / "operations.md"
DELTAS = PKG / "tools" / "metric_deltas.md"


def lint(*args):
    return subprocess.run(
        [sys.executable, "-m", "flink_jpmml_tpu_torch.tools.metrics_lint",
         *map(str, args)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )


def _copy_src(tmp_path) -> pathlib.Path:
    dst = tmp_path / "flink_jpmml_tpu_torch"
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "*.so", "*.cu", "*.cpp"))
    return dst


def test_the_tree_is_in_sync():
    proc = lint()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "in sync" in proc.stdout


def test_the_delta_table_names_the_three_drifts():
    text = DELTAS.read_text(encoding="utf-8")
    for row in ("| `encode_*` | counter | sum | emitted |",
                "| `redispatches` | counter | sum | emitted |",
                "| `donation_hits` | counter | sum | not-registered |"):
        assert row in text


def test_an_uncatalogued_counter_fails_naming_file_and_line(tmp_path):
    src = _copy_src(tmp_path)
    target = src / "runtime" / "block.py"
    n_lines = len(target.read_text(encoding="utf-8").splitlines())
    with open(target, "a", encoding="utf-8") as f:
        f.write('\n\ndef _probe(metrics):\n'
                '    metrics.counter("x_new").inc()\n')
    proc = lint("--src", src)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert (f"`x_new` is emitted (flink_jpmml_tpu_torch/runtime/block.py:"
            f"{n_lines + 4})") in proc.stdout


STALE = {
    # an emitted name the catalogue now has
    "catalogued_upstream": (
        "| `encode_s` | counter | sum | emitted | stale |",
        "`encode_s` is an `emitted` row", "catalogue now has it"),
    # an emitted name the port no longer registers
    "no_longer_emitted": (
        "| `ghost_total` | counter | sum | emitted | stale |",
        "`ghost_total` is an `emitted` row", "registers it"),
    # a not-registered name the port registers
    "now_registered": (
        "| `records_out` | counter | sum | not-registered | stale |",
        "`records_out` is a `not-registered` row", "the port registers"),
    # a not-registered name the catalogue no longer has
    "dropped_upstream": (
        "| `ghost_total` | counter | sum | not-registered | stale |",
        "`ghost_total` is a `not-registered` row",
        "catalogue no longer has it"),
}


@pytest.mark.parametrize("case", sorted(STALE))
def test_a_stale_delta_row_fails(tmp_path, case):
    row, who, why = STALE[case]
    deltas = tmp_path / "metric_deltas.md"
    deltas.write_text(DELTAS.read_text(encoding="utf-8").rstrip("\n")
                      + "\n" + row + "\n", encoding="utf-8")
    proc = lint("--deltas", deltas)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    line = next(ln for ln in proc.stdout.splitlines() if who in ln)
    assert why in line


def test_a_dropped_delta_row_is_drift(tmp_path):
    # without its row, the port's own counter is uncatalogued again
    deltas = tmp_path / "metric_deltas.md"
    deltas.write_text("\n".join(
        ln for ln in DELTAS.read_text(encoding="utf-8").splitlines()
        if not ln.startswith("| `redispatches`")) + "\n", encoding="utf-8")
    proc = lint("--deltas", deltas)
    assert proc.returncode == 1
    assert "`redispatches` is emitted (flink_jpmml_tpu_torch/" in proc.stdout


def test_a_catalogue_without_its_heading_exits_2(tmp_path):
    docs = tmp_path / "operations.md"
    docs.write_text(DOCS.read_text(encoding="utf-8").replace(
        "### Metric name catalogue", "### Metric names"), encoding="utf-8")
    proc = lint("--docs", docs)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "section not found" in proc.stderr


def test_an_unreadable_delta_row_exits_2(tmp_path):
    deltas = tmp_path / "metric_deltas.md"
    deltas.write_text(DELTAS.read_text(encoding="utf-8").rstrip("\n")
                      + "\n| `x` | counter | sum | maybe | why |\n",
                      encoding="utf-8")
    proc = lint("--deltas", deltas)
    assert proc.returncode == 2 and "unparseable delta row" in proc.stderr
