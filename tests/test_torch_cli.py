"""The port's operator commands (``flink_jpmml_tpu_torch/cli.py``) held to
the JAX package's ``cli.py`` on the CPU.

Each command runs through both packages on the same inputs, and the two
runs must print the same stdout and stderr and write the same files
(scores within rtol 1e-4 / atol 1e-5, labels equal). Then the JAX tests'
own assertions run on the port's output. The cases are the twins of
``tests/test_cli.py`` and of the CLI cases of ``test_dlq.py``,
``test_drift.py``, ``test_trace.py``, ``test_attr.py`` (``fjt-top``),
``test_overload.py``, ``test_devfault.py`` and ``test_history.py``.

``score_main`` takes ``--platform cpu`` here; without it and without a
card it raises ``DeviceUnavailableError``. The six other commands run
with ``torch.cuda.is_available`` patched to False: they need no device.
"""

import io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from flink_jpmml_tpu import cli as jcli
from flink_jpmml_tpu.obs import drift as jdrift
from flink_jpmml_tpu.obs import history as jhistory
from flink_jpmml_tpu.runtime import kafka as jk
from flink_jpmml_tpu.runtime.dlq import DeadLetterQueue as JDLQ
from flink_jpmml_tpu_torch import cli as tcli
from flink_jpmml_tpu_torch.api import ModelReader
from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_iris_lr
from flink_jpmml_tpu_torch.models.control import from_wire
from flink_jpmml_tpu_torch.obs import attr, drift
from flink_jpmml_tpu_torch.obs import history as thistory
from flink_jpmml_tpu_torch.obs import trace as trace_mod
from flink_jpmml_tpu_torch.obs.freshness import freshness_for
from flink_jpmml_tpu_torch.runtime import kafka as tk
from flink_jpmml_tpu_torch.runtime.dlq import DeadLetterQueue
from flink_jpmml_tpu_torch.serving import failover as failover_mod
from flink_jpmml_tpu_torch.serving.overload import AdmissionController
from flink_jpmml_tpu_torch.utils.exceptions import DeviceUnavailableError
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"jax": jcli, "port": tcli}


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("FJT_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.delenv("FJT_PLATFORM", raising=False)


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _call(mod, name, argv, capsys):
    capsys.readouterr()
    rc = getattr(mod, name)(list(argv))
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _both(name, argv, capsys):
    """Run ``name`` in both packages → the port's (rc, out, err), after
    checking it equals the JAX one."""
    got = {k: _call(mod, name, argv, capsys) for k, mod in CLIS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _both_raise(name, argv, exc=SystemExit):
    msgs = []
    for mod in CLIS.values():
        with pytest.raises(exc) as ei:
            getattr(mod, name)(list(argv))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    return msgs[1]


def _dump(tmp_path, struct, name="varz.json"):
    p = tmp_path / name
    p.write_text(json.dumps(struct))
    return str(p)


# -- fjt-score (tests/test_cli.py) -------------------------------------------


@pytest.fixture()
def iris(tmp_path):
    return gen_iris_lr(str(tmp_path))


def _write_inputs(tmp_path, fields, rows):
    csv_p = pathlib.Path(tmp_path, "in.csv")
    lines = [",".join(fields)]
    for row in rows:
        lines.append(",".join("" if v is None else str(v) for v in row))
    csv_p.write_text("\n".join(lines) + "\n")
    jsonl_p = pathlib.Path(tmp_path, "in.jsonl")
    jsonl_p.write_text("\n".join(
        json.dumps({f: v for f, v in zip(fields, row) if v is not None})
        for row in rows) + "\n")
    return str(csv_p), str(jsonl_p)


def _close(a, b):
    """Two fjt-score output lines agree: same keys, labels equal, numbers
    within rtol 1e-4 / atol 1e-5."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _close(a[k], b[k])
        elif isinstance(a[k], float) or isinstance(b[k], float):
            assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-5), k
        else:
            assert a[k] == b[k], k


def _score_both(tmp_path, argv_of, capsys):
    """fjt-score in both packages, each to its own output file →
    [(rc, lines, stderr)] for jax, port."""
    runs = []
    for k, mod in CLIS.items():
        out_p = str(tmp_path / f"out-{k}.jsonl")
        rc, out, err = _call(mod, "score_main", argv_of(out_p), capsys)
        lines = [json.loads(ln)
                 for ln in pathlib.Path(out_p).read_text().splitlines()]
        runs.append((rc, lines, err))
    (jrc, jl, jerr), (prc, pl, perr) = runs
    assert (prc, perr) == (jrc, jerr) and len(pl) == len(jl)
    for a, b in zip(pl, jl):
        _close(a, b)
    return prc, pl, perr


@pytest.mark.parametrize("fmt", ["csv", "jsonl"])
def test_csv_and_jsonl_match_api(tmp_path, iris, capsys, fmt):
    cm = ModelReader(iris).load(device="cpu")
    fields = list(cm.field_space.fields)
    rng = np.random.default_rng(3)
    rows = [[round(float(v), 4) for v in rng.normal(3, 2, len(fields))]
            for _ in range(20)]
    rows[5] = [None] * len(fields)  # all-missing record → empty lane
    csv_p, jsonl_p = _write_inputs(tmp_path, fields, rows)
    inp = csv_p if fmt == "csv" else jsonl_p
    ref = cm.score_records([{f: v for f, v in zip(fields, row)
                             if v is not None} for row in rows])
    rc, got, err = _score_both(
        tmp_path, lambda o: [iris, inp, "-o", o, "--platform", "cpu"],
        capsys)
    assert rc == 0 and err == "scored 20 records\n"
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if r.is_empty:
            assert g == {"empty": True}
        else:
            assert g["value"] == pytest.approx(r.score.value, rel=1e-6)
            assert g["label"] == r.target.label
            assert g["probs"][r.target.label] == pytest.approx(
                r.target.probabilities[r.target.label], abs=2e-6)


def test_replace_nan_fills_numeric_fields(tmp_path, iris, capsys):
    cm = ModelReader(iris).load(device="cpu")
    fields = list(cm.field_space.fields)
    rows = [[None] * len(fields), [1.0] + [None] * (len(fields) - 1)]
    csv_p, _ = _write_inputs(tmp_path, fields, rows)
    rc, got, _ = _score_both(
        tmp_path, lambda o: [iris, csv_p, "-o", o, "--replace-nan", "0.0",
                             "--platform", "cpu"], capsys)
    assert rc == 0 and all("empty" not in g for g in got)
    ref = cm.score_records([{f: 0.0 for f in fields}])[0]
    assert got[0]["value"] == pytest.approx(ref.score.value, rel=1e-6)


def test_stdin_jsonl(tmp_path, iris, monkeypatch, capsys):
    cm = ModelReader(iris).load(device="cpu")
    rec = {f: 2.0 for f in cm.field_space.fields}
    outs = []
    for mod in CLIS.values():
        monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(rec) + "\n"))
        rc, out, err = _call(mod, "score_main",
                             [iris, "-", "--platform", "cpu"], capsys)
        assert rc == 0 and err == "scored 1 records\n"
        outs.append([json.loads(ln) for ln in out.strip().splitlines()])
    assert len(outs[1]) == 1
    _close(outs[1][0], outs[0][0])
    ref = cm.score_records([rec])[0]
    assert outs[1][0]["value"] == pytest.approx(ref.score.value, rel=1e-6)


def test_invalid_jsonl_is_typed_exit(tmp_path, iris):
    bad = pathlib.Path(tmp_path, "bad.jsonl")
    bad.write_text("{not json}\n")
    msg = _both_raise("score_main", [iris, str(bad), "--platform", "cpu"])
    assert "invalid JSON" in msg


def test_missing_files_are_typed_exits(tmp_path, iris):
    msg = _both_raise("score_main", [iris, str(tmp_path / "nope.csv"),
                                     "--platform", "cpu"])
    assert "cannot read" in msg
    good = pathlib.Path(tmp_path, "ok.jsonl")
    good.write_text("{}\n")
    msg = _both_raise("score_main", [
        iris, str(good), "-o", str(tmp_path / "no" / "dir" / "out.jsonl"),
        "--platform", "cpu"])
    assert "cannot write" in msg


def test_csv_numeric_looking_categoricals_ride_the_codec(tmp_path, capsys):
    xml = """<PMML version="4.3"><DataDictionary>
      <DataField name="c" optype="categorical" dataType="string">
        <Value value="1"/><Value value="2"/><Value value="3"/>
      </DataField>
      <DataField name="y" optype="continuous" dataType="double"/>
      </DataDictionary>
      <RegressionModel functionName="regression">
      <MiningSchema><MiningField name="y" usageType="target"/>
        <MiningField name="c"/></MiningSchema>
      <RegressionTable intercept="0.0">
        <CategoricalPredictor name="c" value="1" coefficient="10"/>
        <CategoricalPredictor name="c" value="2" coefficient="20"/>
        <CategoricalPredictor name="c" value="3" coefficient="30"/>
      </RegressionTable></RegressionModel></PMML>"""
    model = pathlib.Path(tmp_path, "cat.pmml")
    model.write_text(xml)
    csv_p = pathlib.Path(tmp_path, "in.csv")
    csv_p.write_text("c\n2\n3\n")
    rc, got, _ = _score_both(
        tmp_path, lambda o: [str(model), str(csv_p), "-o", o,
                             "--platform", "cpu"], capsys)
    assert rc == 0
    assert [g["value"] for g in got] == [pytest.approx(20.0),
                                         pytest.approx(30.0)]


def test_gbm_with_missing_cells_matches_the_jax_command(tmp_path, capsys):
    path = gen_gbm(str(tmp_path), n_trees=12, depth=3, n_features=6,
                   seed=11)
    cm = ModelReader(path).load(device="cpu")
    fields = list(cm.field_space.fields)
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1.5, (300, len(fields)))
    rows = [[None if rng.random() < 0.2 else round(float(v), 5) for v in r]
            for r in X]
    csv_p, _ = _write_inputs(tmp_path, fields, rows)
    rc, got, err = _score_both(
        tmp_path, lambda o: [path, csv_p, "-o", o, "--batch", "64",
                             "--platform", "cpu"], capsys)
    assert rc == 0 and err == "scored 300 records\n" and len(got) == 300
    ref = cm.score_records([{f: v for f, v in zip(fields, row)
                             if v is not None} for row in rows])
    for g, r in zip(got, ref):
        assert g["value"] == pytest.approx(r.score.value, rel=1e-4,
                                           abs=1e-5)


def test_score_without_a_card_raises(tmp_path, iris, no_card):
    _, jsonl_p = _write_inputs(tmp_path, ["a"], [[1.0]])
    with pytest.raises(DeviceUnavailableError, match="no CUDA device"):
        tcli.score_main([iris, jsonl_p])
    with pytest.raises(DeviceUnavailableError):
        tcli.score_main([iris, jsonl_p, "--platform", "gpu"])
    with pytest.raises(ValueError, match="unknown platform 'tpu'"):
        tcli.score_main([iris, jsonl_p, "--platform", "tpu"])


def test_score_takes_fjt_platform(tmp_path, iris, monkeypatch, capsys,
                                  no_card):
    monkeypatch.setenv("FJT_PLATFORM", "cpu")
    fields = list(ModelReader(iris).load(device="cpu").field_space.fields)
    _, jsonl_p = _write_inputs(tmp_path, fields, [[5.0] * len(fields)])
    rc, out, err = _call(tcli, "score_main", [iris, jsonl_p], capsys)
    assert rc == 0 and err == "scored 1 records\n"
    assert "value" in json.loads(out)


def test_module_entry_point_on_a_host_without_a_card(tmp_path, iris):
    """``python -m flink_jpmml_tpu_torch.cli`` is ``fjt-score``: without a
    card it exits non-zero with the device error; with ``--platform cpu``
    it scores. Both runs hide any card with ``CUDA_VISIBLE_DEVICES``."""
    _, jsonl_p = _write_inputs(tmp_path, ["sepal_length"], [[5.0], [6.0]])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    env.pop("FJT_PLATFORM", None)
    cmd = [sys.executable, "-m", "flink_jpmml_tpu_torch.cli", iris, jsonl_p]
    bad = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path))
    assert bad.returncode != 0
    assert "DeviceUnavailableError" in bad.stderr
    assert "no CUDA device is present" in bad.stderr
    good = subprocess.run(cmd + ["--platform", "cpu"], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=str(tmp_path))
    assert good.returncode == 0, good.stderr[-2000:]
    assert good.stderr.strip().endswith("scored 2 records")
    assert len(good.stdout.splitlines()) == 2


# -- fjt-rollout (tests/test_drift.py) ----------------------------------------


def _frames(path):
    rows = [json.loads(ln) for ln in pathlib.Path(path).read_text()
            .splitlines()]
    for r in rows:
        r.pop("timestamp", None)  # wall clock at append
    return rows


@pytest.mark.parametrize("argv", [
    ["canary", "--name", "m", "--version", "2", "--max-prediction-psi",
     "0.25", "--hold-prediction-psi", "0.1"],
    ["shadow", "--name", "m", "--version", "3", "--path", "v3.pmml",
     "--min-samples", "7", "--window-s", "2.5", "--shadow-sample", "0.5"],
    ["full", "--name", "m", "--version", "2"],
    ["rollback", "--name", "m", "--version", "2", "--fraction", "0.3"],
])
def test_fjt_rollout_frames_match(tmp_path, capsys, no_card, argv):
    outs = {}
    for k, mod in CLIS.items():
        ctrl = tmp_path / f"ctrl-{k}.jsonl"
        rc, out, err = _call(mod, "rollout_main", [str(ctrl)] + argv, capsys)
        outs[k] = (rc, out, err.replace(str(ctrl), "<ctrl>"), _frames(ctrl))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0


def test_fjt_rollout_cli_psi_flags(tmp_path, capsys, no_card):
    ctrl = tmp_path / "ctrl.jsonl"
    assert tcli.rollout_main([
        str(ctrl), "canary", "--name", "m", "--version", "2",
        "--max-prediction-psi", "0.25", "--hold-prediction-psi", "0.1",
    ]) == 0
    msg = from_wire(json.loads(ctrl.read_text().strip()))
    assert msg.guardrails.max_prediction_psi == 0.25
    assert msg.guardrails.hold_prediction_psi == 0.1


def test_fjt_rollout_rejects_a_bad_message(tmp_path, no_card):
    msg = _both_raise("rollout_main", [
        str(tmp_path / "c.jsonl"), "canary", "--name", "m", "--version",
        "2", "--fraction", "1.5"])
    assert msg.startswith("invalid rollout message")


# -- fjt-top (tests/test_attr.py, test_overload.py, test_devfault.py) ---------


def _stage_struct():
    m = MetricsRegistry()
    led = attr.StageLedger(m)
    for _ in range(20):
        led.observe("sink", 0.001)
    led.observe("readback", 0.08)
    m.gauge("device_mfu").set(0.058)
    m.gauge("device_membw_util").set(0.0001)
    m.gauge("device_ns_per_record").set(920.0)
    m.gauge("slo_ok").set(1.0)
    m.gauge('slo_burn_rate{window="300"}').set(0.25)
    return m.struct_snapshot()


def _freshness_struct(diverging=False):
    m = MetricsRegistry()
    m.gauge("pressure").set(0.72)
    m.gauge("pressure_ring").set(0.72)
    m.gauge("pressure_window").set(0.10)
    m.gauge("pressure_wait").set(0.05)
    m.counter("pressure_breaches").inc(2)
    m.gauge("lag_drain_eta_s").set(12.5)
    m.gauge("lag_trend").set(-340.0)
    m.gauge("lag_diverging").set(1.0 if diverging else 0.0)
    m.gauge("watermark_ts").set(1_700_000_000.0)
    m.gauge('watermark_lag_s{partition="0"}').set(1.25)
    m.gauge('watermark_lag_s{partition="1"}').set(0.4)
    m.gauge('kafka_lag{partition="0"}').set(5000.0)
    m.gauge('kafka_lag_age_s{partition="0"}').set(0.3)
    h = m.histogram("record_staleness_s")
    for v in (0.5, 0.8, 1.4, 2.0):
        h.observe(v)
    return m.struct_snapshot()


def test_top_renders_struct_dump(tmp_path, capsys, no_card):
    rc, out, _ = _both("top_main", [_dump(tmp_path, _stage_struct())], capsys)
    assert rc == 0
    assert "readback" in out and "sink" in out
    assert out.index("readback") < out.index("sink")
    assert "mfu   5.80%" in out
    assert "slo      OK" in out and "300s: 0.25x" in out


def test_top_renders_bench_artifact_and_varz_mapping(tmp_path, capsys,
                                                     no_card):
    s = _stage_struct()
    dump = _dump(tmp_path, {"": s, "w0": s}, "fleet.json")
    _, out, _ = _both("top_main", [dump], capsys)
    assert "== aggregate ==" in out and "== w0 ==" in out
    _, out, _ = _both("top_main", [dump, "--worker", "w0"], capsys)
    assert "== w0 ==" in out and "== aggregate ==" not in out
    art = _dump(tmp_path, {"metric": "x", "varz": s}, "BENCH.json")
    _, out, _ = _both("top_main", [art], capsys)
    assert "sink" in out
    assert "== aggregate ==" in out and "== varz ==" not in out
    wrapped = _dump(tmp_path, {"rc": 0, "parsed": {"metric": "x",
                                                   "varz": s}},
                    "BENCH_r9.json")
    _, out, _ = _both("top_main", [wrapped], capsys)
    assert "sink" in out


@pytest.mark.parametrize("struct,flag,says", [
    ({"counters": {}, "histograms": {}}, [], "no stage attribution"),
    ({"counters": {}, "gauges": {}}, ["--freshness"],
     "no freshness telemetry"),
    ({"gauges": {}, "counters": {}}, ["--overload"], "no overload telemetry"),
    ({"gauges": {}, "counters": {}}, ["--failover"], "no failover telemetry"),
    ({"gauges": {}, "counters": {}}, ["--drift"], "no drift telemetry"),
    ({"gauges": {}, "counters": {}}, ["--mesh"], "no mesh telemetry"),
])
def test_top_empty_struct_says_so(tmp_path, capsys, no_card, struct, flag,
                                  says):
    rc, out, _ = _both("top_main", [_dump(tmp_path, struct)] + flag, capsys)
    assert rc == 0 and says in out


def test_top_rejects_garbage(tmp_path, no_card):
    p = tmp_path / "nope.json"
    p.write_text("[1, 2]")
    assert "is not a JSON object" in _both_raise("top_main", [str(p)])
    assert "cannot read" in _both_raise(
        "top_main", [str(tmp_path / "missing.json")])


def test_top_freshness_panel(tmp_path, capsys, no_card):
    _, out, _ = _both("top_main", [_dump(tmp_path, _freshness_struct()),
                                   "--freshness"], capsys)
    assert "freshness" in out and "pressure  0.72" in out
    assert "ring 0.72" in out and "breaches 2" in out
    assert "eta 12.5s" in out and "-340.0 rec/s" in out
    assert "stale" in out and "p99" in out
    assert re.search(r"^0\s+1\.250\s+5,000\s+0\.3$", out, re.M)
    assert re.search(r"^1\s+0\.400\s+-\s+-$", out, re.M)


def test_top_freshness_diverging_renders_loudly(tmp_path, capsys, no_card):
    _, out, _ = _both("top_main", [
        _dump(tmp_path, _freshness_struct(diverging=True)), "--freshness"],
        capsys)
    assert "DIVERGING" in out and "12.5s" not in out


def test_top_freshness_fleet_mapping(tmp_path, capsys, no_card):
    s = _freshness_struct()
    _, out, _ = _both("top_main", [_dump(tmp_path, {"": s, "w0": s}),
                                   "--freshness"], capsys)
    assert "== aggregate · freshness ==" in out
    assert "== w0 · freshness ==" in out


def test_top_watermark_only_and_empty_staleness(tmp_path, capsys, no_card):
    m = MetricsRegistry()
    m.gauge("watermark_ts").set(1_700_000_000.0)
    _, out, _ = _both("top_main", [_dump(tmp_path, m.struct_snapshot()),
                                   "--freshness"], capsys)
    assert "low-watermark" in out and "no freshness telemetry" not in out
    m = MetricsRegistry()
    freshness_for(m)  # registers the (empty) staleness histogram
    _, out, _ = _both("top_main", [_dump(tmp_path, m.struct_snapshot()),
                                   "--freshness"], capsys)
    assert "no freshness telemetry" in out


def _interrupt_after(monkeypatch, n):
    import time as time_mod

    calls = {"n": 0}

    def fake_sleep(secs):
        calls["n"] += 1
        if calls["n"] >= n:
            calls["n"] = 0
            raise KeyboardInterrupt

    monkeypatch.setattr(time_mod, "sleep", fake_sleep)


def _watch_both(argv, capsys, monkeypatch, n):
    got = []
    for mod in CLIS.values():
        _interrupt_after(monkeypatch, n)
        capsys.readouterr()
        with pytest.raises(KeyboardInterrupt):
            mod.top_main(list(argv))
        cap = capsys.readouterr()
        got.append((cap.out, cap.err))
    assert got[0] == got[1]
    return got[1]


def test_top_watch_rerenders_until_interrupted(tmp_path, capsys,
                                               monkeypatch, no_card):
    m = MetricsRegistry()
    attr.StageLedger(m).observe("sink", 0.002)
    out, _ = _watch_both([_dump(tmp_path, m.struct_snapshot()), "--watch",
                          "0.01"], capsys, monkeypatch, 2)
    assert out.count("sink") >= 2


def test_top_watch_retries_through_fetch_failures(tmp_path, capsys,
                                                  monkeypatch, no_card):
    _, err = _watch_both([str(tmp_path / "gone.json"), "--watch", "0.01"],
                         capsys, monkeypatch, 2)
    assert err.count("retrying") == 2


def test_top_watch_retries_missing_worker_label(tmp_path, capsys,
                                                monkeypatch, no_card):
    m = MetricsRegistry()
    attr.StageLedger(m).observe("sink", 0.002)
    _, err = _watch_both([_dump(tmp_path, {"": m.struct_snapshot()}),
                          "--watch", "0.01", "--worker", "w9"],
                         capsys, monkeypatch, 1)
    assert "w9" in err and "retrying" in err


@pytest.mark.parametrize("every", ["0", "-2"])
def test_top_watch_validation(tmp_path, no_card, every):
    _both_raise("top_main", [str(tmp_path / "x.json"), "--watch", every])


def _forced_controller(metrics, lanes, level, pressure=1.0):
    t = [0.0]
    p = [pressure]
    adm = AdmissionController(
        metrics, lanes=lanes, dwell_s=0.1, interval_s=0.01,
        on_threshold=0.8, off_threshold=0.3,
        pressure_fn=lambda: p[0], clock=lambda: t[0],
    )
    while adm.shed_level < level:
        t[0] += 0.2
        adm.tick()
        assert t[0] < 100.0
    p[0] = 0.5
    return adm


def test_top_overload_panel(tmp_path, capsys, no_card):
    m = MetricsRegistry()
    adm = _forced_controller(m, ("low", "high"), level=1)
    adm.admit("low", n=5)
    adm.admit("high", n=9)
    m.gauge("slo_deadline_ms").set(10.0)
    m.gauge("adaptive_batch").set(512.0)
    for _ in range(20):
        m.histogram("batch_latency_s").observe(0.004)
    _, out, _ = _both("top_main", ["--overload",
                                   _dump(tmp_path, m.struct_snapshot())],
                      capsys)
    assert "deadline 10.0 ms" in out and "MET" in out
    assert "low" in out and "shed" in out


def test_top_failover_panel(tmp_path, capsys, no_card):
    m = MetricsRegistry()
    plane = failover_mod.FailoverPlane(m)
    b = plane.breaker_for("m1")
    for _ in range(3):
        b.record_failure()
    plane.note_fallback(100, "m1")
    m.counter("records_out").inc(1000)
    m.counter('device_fault_total{kind="device_error"}').inc(3)
    struct = m.struct_snapshot()
    texts = []
    for mod in CLIS.values():
        out = io.StringIO()
        mod._top_render_failover("w0", struct, out, source="dump.json")
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert "open" in texts[1] and "fallback" in texts[1]
    assert "fjt-trace" in texts[1]
    _, out, _ = _both("top_main", ["--failover", _dump(tmp_path, struct)],
                      capsys)
    assert "open" in out


def test_top_exemplar_pivot_hint(tmp_path, capsys, no_card):
    m = MetricsRegistry()
    m.histogram('stage_seconds{stage="sink"}').observe(0.5,
                                                       exemplar="abcd1234")
    dump = _dump(tmp_path, m.struct_snapshot())
    _, out, _ = _both("top_main", [dump], capsys)
    assert "fjt-trace" in out and "--id abcd1234" in out and dump in out


def test_top_mesh_zoo_and_state_panels(tmp_path, capsys, no_card):
    m = MetricsRegistry()
    for chip in ("cuda:0", "cuda:1"):
        m.counter(f'mesh_chip_records{{chip="{chip}"}}').inc(4096)
        m.gauge(f'mesh_chip_inflight{{chip="{chip}"}}').set(2.0)
    m.gauge("mesh_data_width").set(2.0)
    m.counter("mesh_rebuilds").inc()
    m.gauge("pack_occupancy").set(0.75)
    m.counter("pack_dispatches").inc(12)
    m.counter("warm_pool_hits").inc(5)
    m.counter("warm_pool_misses").inc(2)
    m.counter('tenant_records{model="z0001"}').inc(300)
    m.counter('tenant_records{model="z0002"}').inc(200)
    m.histogram("cold_start_s").observe(0.4)
    m.counter("state_records").inc(1000)
    m.gauge("state_hit_ratio").set(0.9)
    m.gauge("state_occupancy_frac").set(0.25)
    dump = _dump(tmp_path, m.struct_snapshot())
    for flag in ("--mesh", "--zoo", "--state"):
        rc, out, _ = _both("top_main", [dump, flag], capsys)
        assert rc == 0 and out.strip()


def test_top_drift_panel(tmp_path, capsys, no_card):
    reg, _ = _drifted_registry(tmp_path)
    struct = reg.struct_snapshot()
    texts = []
    for mod in CLIS.values():
        out = io.StringIO()
        mod._top_render_drift("w0", struct, out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    text = texts[1]
    assert "w0 · drift" in text and "ALARM" in text
    assert text.index("\nb ") < text.index("\na ")
    _, out, _ = _both("top_main", ["--drift", _dump(tmp_path, struct)],
                      capsys)
    assert "ALARM" in out


# -- fjt-drift (tests/test_drift.py) ------------------------------------------


class _FakeWire:
    def __init__(self, fields, cuts):
        self.fields = tuple(fields)
        self.cuts = tuple(np.asarray(c, np.float32) for c in cuts)


class _FakeScorer:
    def __init__(self, fields, cuts, model_hash="m01"):
        self.wire = _FakeWire(fields, cuts)
        self.model_hash = model_hash


def _drifted_registry(tmp_path):
    reg = MetricsRegistry()
    store = drift.BaselineStore(tmp_path / "bl")
    plane = drift.install(reg, store=store, interval_s=0.0, budget_frac=0)
    mon = plane.monitor
    mon.min_n, mon.dwell_s, mon._interval = 50, 0.0, 0.0
    rng = np.random.default_rng(19)
    q = _FakeScorer(("a", "b"), [np.array([-1.0, 1.0])] * 2)
    for _ in range(8):
        plane.record_features(q, rng.normal(0, 1, (128, 2))
                              .astype(np.float32))
    drift.snapshot_registry(reg, store=store)
    for _ in range(8):
        X = rng.normal(0, 1, (128, 2)).astype(np.float32)
        X[:, 1] += 5.0
        plane.record_features(q, X)
    return reg, store


def test_fjt_drift_cli_roundtrip(tmp_path, capsys, no_card):
    reg, _ = _drifted_registry(tmp_path)
    dump = tmp_path / "varz.json"
    dump.write_text(json.dumps(reg.struct_snapshot()))
    outs = {}
    for k, mod in CLIS.items():
        bl = str(tmp_path / f"cli-bl-{k}")
        steps = [_call(mod, "drift_main", ["snapshot", str(dump), "--dir",
                                           bl], capsys),
                 _call(mod, "drift_main", ["list", "--dir", bl], capsys),
                 _call(mod, "drift_main", ["check", str(dump), "--dir", bl],
                       capsys)]
        outs[k] = [(rc, o.replace(bl, "<bl>"), e.replace(bl, "<bl>"))
                   for rc, o, e in steps]
    # the snapshot and list lines carry the capture's wall-clock time
    strip = re.compile(r"\d{4}-\d\d-\d\d[ T][\d:.]+|\d{9,}\.\d+")
    norm = {k: [(rc, strip.sub("<t>", o), strip.sub("<t>", e))
                for rc, o, e in v] for k, v in outs.items()}
    assert norm["port"] == norm["jax"]
    assert [rc for rc, _, _ in outs["port"]] == [0, 0, 0]
    assert "m01" in outs["port"][1][1]
    # a shifted source fails the check with exit 1, in both packages
    rng = np.random.default_rng(20)
    plane = drift.plane_for(reg)
    q = _FakeScorer(("a", "b"), [np.array([-1.0, 1.0])] * 2)
    for _ in range(20):
        X = rng.normal(0, 1, (256, 2)).astype(np.float32)
        X[:, 0] += 8.0
        plane.record_features(q, X)
    dump.write_text(json.dumps(reg.struct_snapshot()))
    got = {}
    for k, mod in CLIS.items():
        bl = str(tmp_path / f"cli-bl-{k}")
        rc, out, _ = _call(mod, "drift_main", ["check", str(dump), "--dir",
                                               bl], capsys)
        got[k] = (rc, out.replace(bl, "<bl>"))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1 and "DRIFTED" in got["port"][1]


def test_fjt_drift_baselines_read_across_packages(tmp_path, capsys, no_card):
    reg, _ = _drifted_registry(tmp_path)
    dump = _dump(tmp_path, reg.struct_snapshot())
    bl = str(tmp_path / "shared-bl")
    assert jcli.drift_main(["snapshot", dump, "--dir", bl]) == 0
    capsys.readouterr()
    assert tcli.drift_main(["check", dump, "--dir", bl]) == 0
    assert drift.BaselineStore(bl).models() == ["m01"]
    assert drift.BaselineStore(bl).load("m01") == jdrift.BaselineStore(
        bl).load("m01")


# -- fjt-trace (tests/test_trace.py) ------------------------------------------


def _journeys(tmp_path):
    m = MetricsRegistry()
    store = trace_mod.JourneyStore(
        str(tmp_path / "journeys"), metrics=m, head_n=100, budget_frac=1.0)
    for i, off in enumerate((0, 64, 128)):
        ctx = trace_mod.context_for(off)
        store.hop("dispatch", ctx, off, 64)
        store.finish(ctx, off, 64, latency_s=0.01 * (i + 1))
    store.terminal("dlq", trace_mod.context_for(70), offset=70,
                   reason="score")
    store.close()
    return store


def test_trace_summary_grep_slowest_id(tmp_path, capsys, no_card):
    _journeys(tmp_path)
    d = str(tmp_path)
    _, out, _ = _both("trace_main", [d], capsys)
    assert "journey(s)" in out
    _, out, _ = _both("trace_main", [d, "--grep", "offset=70"], capsys)
    assert "dlq" in out and "[64..128)" in out
    _, out, _ = _both("trace_main", [d, "--slowest", "2"], capsys)
    assert "30.000" in out
    tid = trace_mod.trace_id_for(128)
    _, out, _ = _both("trace_main", [d, "--id", tid], capsys)
    assert tid[:12] in out


def test_trace_id_selection_pulls_batch_terminal_hops(tmp_path, no_card):
    _journeys(tmp_path)
    rows = {k: mod._trace_rows_from_dir(str(tmp_path))
            for k, mod in CLIS.items()}
    assert rows["port"] == rows["jax"]
    batch_tid = trace_mod.trace_id_for(64)
    sel = tcli._trace_select(rows["port"], trace_id=batch_tid)
    assert sel == jcli._trace_select(rows["jax"], trace_id=batch_tid)
    kinds = {r["kind"] for r in sel}
    assert "dlq" in kinds
    assert {r["kind"] for r in tcli._trace_select(rows["port"],
                                                  offset=70)} >= kinds


@pytest.mark.parametrize("grep", ["pid=3", "offset=x", "offset=99999"])
def test_trace_rejects_bad_or_unmatched_grep(tmp_path, no_card, grep):
    _journeys(tmp_path)
    _both_raise("trace_main", [str(tmp_path), "--grep", grep])


def test_trace_artifact_source(tmp_path, capsys, no_card):
    store = _journeys(tmp_path)
    art = _dump(tmp_path, {"metric": "recovery_drill",
                           "journeys": trace_mod.read_rows(store.directory)},
                "BENCH_x.json")
    _, out, _ = _both("trace_main", [art, "--grep", "offset=70"], capsys)
    assert "dlq" in out


def test_trace_incarnation_boundary_render(no_card):
    rows = [
        {"t": 1.0, "pid": 10, "kind": "dispatch", "trace_id": "aa",
         "span_id": "s1", "first_off": 0, "n": 8},
        {"t": 2.0, "pid": 20, "kind": "restore", "trace_id": "aa",
         "span_id": "s2", "first_off": 0},
    ]
    texts = []
    for mod in CLIS.values():
        buf = io.StringIO()
        mod._trace_render(rows, buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "incarnation boundary: pid 10 → pid 20" in texts[1]


def test_trace_flight_and_dlq_normalization(tmp_path, capsys, no_card):
    _journeys(tmp_path)
    (tmp_path / "flight-1-2.jsonl").write_text(json.dumps({
        "t": 5.0, "kind": "poison_suspect_mode", "lo": 64, "hi": 128,
        "restarts": 3, "pid": 99,
    }) + "\n" + json.dumps({"t": 5.1, "kind": "kafka_reconnect"}) + "\n")
    q = DeadLetterQueue(str(tmp_path / "dlq"))
    q.quarantine(b"\x00" * 16, offset=70, reason="score",
                 trace_id="tt", span_id="ss")
    rows = tcli._trace_rows_from_dir(str(tmp_path))
    jrows = jcli._trace_rows_from_dir(str(tmp_path))
    assert rows == jrows
    kinds = {r["kind"] for r in rows}
    assert {"poison_suspect_mode", "dlq_envelope"} <= kinds
    assert "kafka_reconnect" not in kinds
    sus = [r for r in rows if r["kind"] == "poison_suspect_mode"][0]
    assert sus["first_off"] == 64 and sus["n"] == 64
    assert {"poison_suspect_mode", "dlq_envelope", "dlq"} <= {
        r["kind"] for r in tcli._trace_select(rows, offset=70)}
    _, out, _ = _both("trace_main", [str(tmp_path), "--grep", "offset=70"],
                      capsys)
    assert "dlq_envelope" in out


# -- fjt-dlq (tests/test_dlq.py) ----------------------------------------------


def _quarantined(ck, dlq_cls):
    q = dlq_cls(str(ck / "dlq"))
    row = np.arange(4, dtype=np.float32)
    q.quarantine(row.tobytes(), offset=137, reason="score",
                 error=ValueError("boom"), partition=0,
                 trace_id="ab" * 16, span_id="cd" * 8)
    q.quarantine(b"junk", offset=200, reason="decode", partition=0)
    # a replayed quarantine: redrive must dedupe it
    q.quarantine(row.tobytes(), offset=137, reason="score",
                 trace_id="ab" * 16, span_id="cd" * 8)
    return row


def test_cli_list_inspect_redrive(tmp_path, capsys, no_card):
    ck = tmp_path / "ck"
    row = _quarantined(ck, DeadLetterQueue)
    rc, out, _ = _both("dlq_main", ["list", str(ck)], capsys)
    assert rc == 0 and "137" in out and "score" in out and "boom" in out
    rc, out, _ = _both("dlq_main", ["inspect", str(ck), "--offset", "137"],
                       capsys)
    assert "as f32 row: [0.0, 1.0, 2.0, 3.0]" in out
    _both("dlq_main", ["inspect", str(ck), "--index", "1"], capsys)
    assert "out of range" in _both_raise(
        "dlq_main", ["inspect", str(ck), "--index", "9"])
    assert "no envelope with offset 5" in _both_raise(
        "dlq_main", ["inspect", str(ck), "--offset", "5"])
    runs = {}
    for k, mod in CLIS.items():
        broker = tk.MiniKafkaBroker(topic="re")
        try:
            rc, out, err = _call(mod, "dlq_main", [
                "redrive", str(ck), "--host", broker.host, "--port",
                str(broker.port), "--topic", "re", "--reason", "score",
            ], capsys)
            c = tk.KafkaClient(broker.host, broker.port)
            try:
                _, raw = c.fetch_raw("re", 0, 0)
                recs = c.fetch("re", 0, 0)[1]
            finally:
                c.close()
        finally:
            broker.close()
        runs[k] = (rc, out, err, recs, tk.record_batch_traceparents(raw))
    assert runs["port"] == runs["jax"]
    rc, _, err, recs, tps = runs["port"]
    assert rc == 0 and err == "1 record(s) redriven\n"
    assert [v for _, v in recs] == [row.tobytes()]  # deduped
    assert tps == {0: trace_mod.TraceContext("ab" * 16, "cd" * 8)
                   .to_traceparent()}


@pytest.mark.parametrize("broker_pkg", ["jax", "port"])
def test_redrive_into_either_broker(tmp_path, capsys, no_card, broker_pkg):
    ck = tmp_path / "ck"
    row = _quarantined(ck, JDLQ)
    broker = (jk if broker_pkg == "jax" else tk).MiniKafkaBroker(topic="re")
    try:
        broker.append(b"head")
        rc, out, _ = _call(tcli, "dlq_main", [
            "redrive", str(ck), "--host", broker.host, "--port",
            str(broker.port), "--topic", "re", "--offset", "137",
        ], capsys)
        assert rc == 0 and "-> re[0]@1" in out
        c = jk.KafkaClient(broker.host, broker.port)
        try:
            _, raw = c.fetch_raw("re", 0, 0)
        finally:
            c.close()
    finally:
        broker.close()
    got = jk.decode_record_batches_h(raw)
    assert [v for _, v, _ in got] == [b"head", row.tobytes()]
    assert got[1][2] == [("traceparent", trace_mod.TraceContext(
        "ab" * 16, "cd" * 8).to_traceparent().encode("ascii"))]


def test_cli_redrive_nothing_matches(tmp_path, no_card):
    q = DeadLetterQueue(str(tmp_path / "dlq"))
    q.quarantine(b"x", offset=1, reason="decode")
    msg = _both_raise("dlq_main", [
        "redrive", str(tmp_path), "--host", "h", "--port", "1",
        "--topic", "t", "--reason", "score"])
    assert "nothing to redrive" in msg


def test_dlq_missing_and_empty(tmp_path, capsys, no_card):
    assert "no DLQ at" in _both_raise("dlq_main",
                                      ["list", str(tmp_path / "none")])
    (tmp_path / "dlq").mkdir()
    rc, out, err = _both("dlq_main", ["list", str(tmp_path)], capsys)
    assert rc == 0 and out == "" and err.startswith("DLQ empty at")


# -- fjt-replay (tests/test_history.py) ---------------------------------------


def _history_frame(h, src, t0, t1, counters, gauges=None):
    def struct(ts, uptime, c, g=None):
        return {"ts": float(ts), "uptime_s": float(uptime),
                "counters": dict(c),
                "gauges": {n: {"value": float(v), "max": float(v)}
                           for n, v in (g or {}).items()},
                "histograms": {}}

    return h.capture_frame(struct(t0, 1.0, {n: 0.0 for n in counters}),
                           struct(t1, 1.0 + (t1 - t0), counters, gauges),
                           src, 1.0, t0=t0, t1=t1)


def _history_store(h, directory):
    store = h.HistoryStore(str(directory), resolutions=(1.0, 5.0))
    fine = [_history_frame(h, src, float(i), float(i + 1),
                           {"records_out": 3.0, "records_in": 4.0},
                           gauges={"queue_depth": float(i)})
            for src in ("w0", "w1") for i in range(10)]
    for f in fine:
        store.append(f)
    for f in h.downsample(fine, 5.0):
        store.append(f)
    store.append(_history_frame(h, h.FLEET_SRC, 0.0, 10.0,
                                {"records_out": 60.0}))
    store.close()


def test_replay_cli_json_on_a_directory(tmp_path, capsys, no_card):
    _history_store(thistory, tmp_path)
    rc, out, _ = _both("replay_main", [str(tmp_path), "--step", "1",
                                       "--json", "--panel", "none"], capsys)
    assert rc == 0
    payload = json.loads(out)
    assert payload["frames"] and payload["resolutions"] == [1.0, 5.0]


@pytest.mark.parametrize("argv", [
    ["--step", "1"], ["--step", "5", "--panel", "overload"],
    ["--source", "_fleet", "--panel", "none"],
    ["--name", "records_*", "--step", "2", "--panel", "zoo"],
    ["--start", "3", "--end", "6", "--step", "1", "--panel", "freshness"],
])
def test_replay_renders_as_the_jax_command(tmp_path, capsys, no_card, argv):
    _history_store(thistory, tmp_path / "port")
    _history_store(jhistory, tmp_path / "jax")
    outs = {}
    for k, mod in CLIS.items():
        d = str(tmp_path / k)
        rc, out, err = _call(mod, "replay_main", [d] + argv, capsys)
        outs[k] = (rc, out.replace(d, "<dir>"), err.replace(d, "<dir>"))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0 and outs["port"][1].strip()


def test_replay_rejects_bad_ranges(tmp_path, no_card):
    _history_store(thistory, tmp_path)
    assert "--last must be > 0" in _both_raise(
        "replay_main", [str(tmp_path), "--last", "0"])
