"""The operator's commands, the port's twin of ``flink_jpmml_tpu/cli.py``.

The functions, flags, output and typed ``SystemExit``s are the JAX
package's, command by command, with the imports renamed to the port.
What differs:

- ``score_main`` resolves its device through ``utils/demo.py``:
  ``--platform cpu`` (or ``FJT_PLATFORM=cpu``) scores on the CPU;
  ``gpu`` or ``cuda``, or no value, score on the card, and a host
  without one raises ``DeviceUnavailableError``; a card by index
  (``cuda:N``) raises ``ValueError`` (pick it with
  ``CUDA_VISIBLE_DEVICES``). There is no
  backend-init watchdog and no re-exec onto the CPU. The device goes to
  ``ModelReader.load(batch_size=, device=)``, so ``fjt-score`` runs the
  lowered f32 function (``CompiledModel.predict``), as in JAX, and not
  the rank wire.
- The six other commands (``fjt-rollout``, ``fjt-top``, ``fjt-drift``,
  ``fjt-trace``, ``fjt-dlq``, ``fjt-replay``) read files, control
  streams, obs endpoints and the broker only; none of them resolves a
  device, so they run on a host without a card.

The pyproject scripts ``fjt-torch-score``, ``-rollout``, ``-top``,
``-drift``, ``-dlq``, ``-trace`` and ``-replay`` point here;
``python -m flink_jpmml_tpu_torch.cli`` runs ``score_main``. The JAX
package's docstrings follow.

``fjt-score``: score a PMML document over a CSV/JSONL file from the
shell — the quickest "switching user" path from a model file to
predictions, no code required.

    fjt-score model.pmml records.csv            # CSV with a header row
    fjt-score model.pmml records.jsonl -o out.jsonl
    cat records.jsonl | fjt-score model.pmml - --format jsonl

Input: CSV (header row names the fields; empty cells = missing) or
JSONL (one record object per line); ``-`` reads stdin. Output: one JSON
object per input record —

    {"value": 1.25, "label": "versicolor", "probs": {...}}
    {"empty": true}                                 # invalid lane (C5)

The hot path is the same compiled scorer the streaming runtime uses
(`ModelReader.load()` → ``score_records`` in batches); this is a
convenience frontend, not a second engine.

``fjt-rollout``: drive staged rollouts from the shell by appending
control frames (models/control.py wire form) to a JSONL control file a
pipeline tails as its control stream (``JsonlFileSource(path,
follow=True)`` → ``with_control_stream``; the dynamic scorer decodes
wire dicts natively). The manual promote/rollback recipe — see
docs/operations.md §Rollouts:

    fjt-rollout ctrl.jsonl shadow   --name m --version 2 --path v2.pmml
    fjt-rollout ctrl.jsonl canary   --name m --version 2 --fraction 0.1
    fjt-rollout ctrl.jsonl full     --name m --version 2   # promote
    fjt-rollout ctrl.jsonl rollback --name m --version 2   # abort

``fjt-top``: render the latency-attribution plane (obs/attr.py) as a
ranked table — per-stage p50/p99/total share, live device occupancy,
top exemplars — from a running pipeline's ``/varz`` endpoint or a
struct dump (a ``/varz`` JSON file or a ``BENCH_*.json`` artifact).
Turns "the chip is 94% idle" into the ordered list of which stage to
attack next. No device needed — safe on any host:

    fjt-top http://127.0.0.1:9100          # live /varz scrape
    fjt-top BENCH_r06.json                 # bench artifact's varz
    fjt-top /tmp/varz-dump.json
    fjt-top --overload http://host:9100    # admission/deadline panel
    fjt-top --drift http://host:9100       # per-feature data-health panel

``fjt-drift``: the data-drift baseline registry (obs/drift.py) —
snapshot a live pipeline's per-feature profiles as the reference,
list what's stored, or check a source against it:

    fjt-drift snapshot http://127.0.0.1:9100
    fjt-drift check http://127.0.0.1:9100   # exit 1 past --psi

``fjt-trace``: reconstruct one record's causal journey (obs/trace.py)
as an ordered timeline by merging journey rows + flight events + DLQ
envelopes + trace-id'd spans across ALL worker incarnations — from a
dump directory (journey store / flight dumps / DLQ / span files,
scanned recursively), a live ``/trace`` endpoint (journeys + flight +
the active span file's trace-id'd events; DLQ envelopes ride only the
directory scan — the store's own ``dlq`` hops carry the quarantine
either way), or a BENCH artifact:

    fjt-trace /data/ckpt --grep offset=1374   # who touched record 1374?
    fjt-trace http://127.0.0.1:9100 --slowest 5
    fjt-trace BENCH_r13.json --id 3fa1…       # the fjt-top exemplar pivot

``fjt-replay``: retrospective incident replay from the durable
telemetry history (obs/history.py) — a per-window timeline (records,
shed, pressure, offered vs capacity, headroom) plus any fjt-top panel
rendered over the merged range, reconstructed from on-disk frames
alone, so it works after every involved process is dead:

    fjt-replay /data/history --last 600 --step 15
    fjt-replay http://127.0.0.1:9100 --panel zoo
    fjt-replay /data/history --source _fleet --panel overload
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from typing import Any, Dict, Iterator, List, Optional, TextIO


def _records_csv(f: TextIO, codec_fields) -> Iterator[Dict[str, Any]]:
    reader = csv.DictReader(f)
    for row in reader:
        rec: Dict[str, Any] = {}
        for k, v in row.items():
            if k is None or v is None or v == "":
                continue  # absent cell = missing value
            if k in codec_fields:
                # categorical: the raw string must ride the codec — a
                # numeric-looking category ("2") float-parsed here would
                # bypass it and alias onto a wrong category code
                rec[k] = v
                continue
            try:
                rec[k] = float(v)
            except ValueError:
                rec[k] = v
        yield rec


def _records_jsonl(f: TextIO) -> Iterator[Dict[str, Any]]:
    for i, line in enumerate(f, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise SystemExit(f"input line {i}: invalid JSON ({e})")
        if not isinstance(rec, dict):
            raise SystemExit(f"input line {i}: expected an object")
        yield rec


def _pred_json(pred) -> Dict[str, Any]:
    if pred.is_empty:
        return {"empty": True}
    out: Dict[str, Any] = {"value": pred.score.value}
    if pred.target is not None:
        if pred.target.label is not None:
            out["label"] = pred.target.label
        if pred.target.probabilities:
            out["probs"] = {
                k: round(float(v), 6)
                for k, v in pred.target.probabilities.items()
            }
    if pred.outputs:
        out["outputs"] = {k: v for k, v in pred.outputs.items()}
    return out


def score_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="fjt-score",
        description="Score a PMML document over CSV/JSONL records.",
    )
    ap.add_argument("model", help="PMML path or URI (any ModelReader scheme)")
    ap.add_argument("input", help="records file (.csv / .jsonl) or - for stdin")
    ap.add_argument("-o", "--output", default="-",
                    help="output JSONL path (default stdout)")
    ap.add_argument("--format", choices=("auto", "csv", "jsonl"),
                    default="auto")
    ap.add_argument("--batch", type=int, default=4096,
                    help="records per scoring dispatch")
    ap.add_argument("--replace-nan", type=float, default=None,
                    help="replace missing/NaN inputs with this value")
    ap.add_argument("--platform", default=None,
                    help="cpu, or the card (gpu, cuda); without "
                         "it the card, and a host without one raises "
                         "(FJT_PLATFORM honored)")
    args = ap.parse_args(argv)

    from flink_jpmml_tpu_torch.utils.demo import resolve_backend

    # the examples' bootstrap: the card unless the CPU was asked for
    device = resolve_backend(args.platform)

    from flink_jpmml_tpu_torch.api import ModelReader

    fmt = args.format
    if fmt == "auto":
        if args.input == "-":
            fmt = "jsonl"
        elif args.input.lower().endswith(".csv"):
            fmt = "csv"
        else:
            fmt = "jsonl"

    cm = ModelReader(args.model).load(batch_size=args.batch, device=device)

    try:
        fin = sys.stdin if args.input == "-" else open(
            args.input, "r", encoding="utf-8"
        )
    except OSError as e:
        raise SystemExit(f"cannot read {args.input!r}: {e}")
    try:
        fout = sys.stdout if args.output == "-" else open(
            args.output, "w", encoding="utf-8"
        )
    except OSError as e:
        if fin is not sys.stdin:
            fin.close()
        raise SystemExit(f"cannot write {args.output!r}: {e}")
    n = 0
    try:
        records = (
            _records_csv(fin, set(cm.field_space.codecs))
            if fmt == "csv"
            else _records_jsonl(fin)
        )
        # --replace-nan fills missing/NaN NUMERIC active fields (the
        # reference's replaceNan option); categorical fields keep the
        # missing-value semantics their codecs define
        numeric_fields = [
            f for f in cm.field_space.fields
            if f not in cm.field_space.codecs
        ]

        def fill(rec: Dict[str, Any]) -> Dict[str, Any]:
            if args.replace_nan is None:
                return rec
            for f in numeric_fields:
                v = rec.get(f)
                if v is None or (isinstance(v, float) and v != v):
                    rec[f] = args.replace_nan
            return rec

        batch: List[Dict[str, Any]] = []

        def flush() -> None:
            nonlocal n
            if not batch:
                return
            preds = cm.score_records(batch)
            for p in preds:
                fout.write(json.dumps(_pred_json(p)) + "\n")
            n += len(batch)
            batch.clear()

        for rec in records:
            batch.append(fill(rec))
            if len(batch) >= args.batch:
                flush()
        flush()
    finally:
        if fin is not sys.stdin:
            fin.close()
        if fout is not sys.stdout:
            fout.close()
    print(f"scored {n} records", file=sys.stderr)
    return 0


def rollout_main(argv: Optional[List[str]] = None) -> int:
    """``fjt-rollout``: append one staged-rollout control frame to a
    JSONL control file (no device needed — safe on any host)."""
    ap = argparse.ArgumentParser(
        prog="fjt-rollout",
        description="Stage, promote, or roll back a served-model rollout "
                    "by appending a control frame to a JSONL control file.",
    )
    ap.add_argument("control_file",
                    help="JSONL control file the pipeline tails "
                         "(JsonlFileSource(follow=True) as its control "
                         "stream)")
    ap.add_argument("stage",
                    choices=("shadow", "canary", "full", "rollback"),
                    help="target stage: shadow/canary start or advance a "
                         "rollout; full promotes; rollback aborts")
    ap.add_argument("--name", required=True, help="served model name")
    ap.add_argument("--version", type=int, required=True,
                    help="candidate version")
    ap.add_argument("--path", default=None,
                    help="candidate PMML path/URI (registers it in the "
                         "same message; required unless already served)")
    ap.add_argument("--fraction", type=float, default=None,
                    help="canary traffic share (default: the guardrail "
                         "spec's canary_fraction)")
    g = ap.add_argument_group("guardrails (any flag builds a spec; "
                              "unset fields keep the defaults)")
    g.add_argument("--max-disagree-rate", type=float, default=None)
    g.add_argument("--max-latency-ratio", type=float, default=None)
    g.add_argument("--max-error-rate", type=float, default=None)
    g.add_argument("--max-prediction-psi", type=float, default=None,
                   help="roll back when the candidate's windowed score "
                        "distribution drifts past this PSI vs the "
                        "incumbent (obs/drift.py)")
    g.add_argument("--hold-prediction-psi", type=float, default=None,
                   help="withhold promotion while prediction PSI "
                        "exceeds this (default: half of "
                        "--max-prediction-psi)")
    g.add_argument("--min-samples", type=int, default=None)
    g.add_argument("--promote-after-s", type=float, default=None)
    g.add_argument("--window-s", type=float, default=None)
    g.add_argument("--shadow-sample", type=float, default=None)
    args = ap.parse_args(argv)

    import time

    from flink_jpmml_tpu_torch.models.control import RolloutMessage, to_wire
    from flink_jpmml_tpu_torch.rollout.state import GuardrailSpec

    guard_kw = {
        k: v for k, v in (
            ("max_disagree_rate", args.max_disagree_rate),
            ("max_latency_ratio", args.max_latency_ratio),
            ("max_error_rate", args.max_error_rate),
            ("max_prediction_psi", args.max_prediction_psi),
            ("hold_prediction_psi", args.hold_prediction_psi),
            ("min_samples", args.min_samples),
            ("promote_after_s", args.promote_after_s),
            ("window_s", args.window_s),
            ("shadow_sample", args.shadow_sample),
        ) if v is not None
    }
    try:
        msg = RolloutMessage(
            name=args.name, version=args.version, stage=args.stage,
            timestamp=time.time(), path=args.path,
            fraction=args.fraction,
            guardrails=(
                GuardrailSpec.from_dict(guard_kw) if guard_kw else None
            ),
        )
    except ValueError as e:
        raise SystemExit(f"invalid rollout message: {e}")
    try:
        with open(args.control_file, "a", encoding="utf-8") as f:
            f.write(json.dumps(to_wire(msg)) + "\n")
    except OSError as e:
        raise SystemExit(f"cannot append to {args.control_file!r}: {e}")
    print(
        f"queued {args.stage} for {args.name}_{args.version} on "
        f"{args.control_file}",
        file=sys.stderr,
    )
    return 0


def _top_load(source: str) -> Dict[str, dict]:
    """→ {label: metrics struct} from a /varz URL, a /varz JSON dump,
    or a BENCH artifact (its embedded ``varz`` structs, per mode)."""
    if source.startswith(("http://", "https://")):
        import urllib.error
        import urllib.request

        url = source.rstrip("/")
        if not url.endswith("/varz"):
            url += "/varz"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                payload = json.loads(r.read().decode())
        except (urllib.error.URLError, OSError,
                json.JSONDecodeError) as e:
            raise SystemExit(f"cannot read {url!r}: {e}")
    else:
        try:
            with open(source, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise SystemExit(f"cannot read {source!r}: {e}")
    if not isinstance(payload, dict):
        raise SystemExit(f"{source!r} is not a JSON object")
    if isinstance(payload.get("parsed"), dict):
        payload = payload["parsed"]  # a bench capture's {"parsed": ...} wrap
    if "histograms" in payload or "counters" in payload:
        return {"": payload}  # a bare struct dump
    out: Dict[str, dict] = {}
    if isinstance(payload.get("varz"), dict):
        out[""] = payload["varz"]  # a bench artifact's top-level mode
    for k, v in payload.items():
        if k == "varz" and "" in out:
            continue  # the headline struct, already the aggregate
        if isinstance(v, dict):
            if "histograms" in v or "counters" in v:
                out[str(k)] = v  # a /varz {label: struct} mapping
            elif isinstance(v.get("varz"), dict):
                out[str(k)] = v["varz"]  # bench sub-modes (latency/kafka)
    if not out:
        raise SystemExit(f"no metrics structs found in {source!r}")
    return out


def _top_render(label: str, struct: dict, out, source: str = None) -> None:
    from flink_jpmml_tpu_torch.obs import attr

    title = label or "aggregate"
    print(f"== {title} ==", file=out)
    gauges = struct.get("gauges") or {}

    def g(name):
        v = gauges.get(name)
        return v.get("value") if isinstance(v, dict) else None

    mfu, membw = g("device_mfu"), g("device_membw_util")
    nsrec, flops = g("device_ns_per_record"), g("flops_per_record")
    if any(x is not None for x in (mfu, membw, nsrec)):
        parts = []
        if mfu is not None:
            parts.append(f"mfu {100.0 * mfu:6.2f}%")
        if membw is not None:
            parts.append(f"membw {100.0 * membw:6.2f}%")
        if nsrec is not None:
            parts.append(f"{nsrec:,.0f} ns/rec (device, sampled)")
        if flops is not None:
            parts.append(f"{flops:,.0f} flops/rec")
        print("device   " + "   ".join(parts), file=out)
    slo_ok = g("slo_ok")
    if slo_ok is not None:
        burns = ", ".join(
            f"{k.split('=', 1)[1].strip(chr(34) + '}')}s: "
            f"{v['value']:.2f}x"
            for k, v in sorted(gauges.items())
            if k.startswith("slo_burn_rate{") and isinstance(v, dict)
        )
        state = "OK" if slo_ok else "BREACHED"
        print(f"slo      {state}" + (f"   burn [{burns}]" if burns else ""),
              file=out)
    summary = attr.summary(struct)
    if summary is None:
        print("(no stage attribution recorded)", file=out)
        return
    print(
        f"{'stage':<14}{'thread':<10}{'batches':>9}{'p50 ms':>10}"
        f"{'p99 ms':>10}{'total ms':>12}{'share':>8}",
        file=out,
    )
    ranked = sorted(
        summary.items(), key=lambda kv: kv[1]["total_ms"], reverse=True
    )
    for stage, row in ranked:
        # decode-thread stages vs hot-path stages (obs/attr.py): with
        # pipelined ingest armed, "ingest" time runs on the prefetch
        # sidecar and overlaps scoring — only "score"/"ring-feed" rows
        # steal from the hot path
        thread = attr.STAGE_THREADS.get(stage, "-")
        print(
            f"{stage:<14}{thread:<10}{row['n']:>9}{row['p50_ms']:>10.3f}"
            f"{row['p99_ms']:>10.3f}{row['total_ms']:>12.3f}"
            f"{100.0 * row['share']:>7.1f}%",
            file=out,
        )
    # top exemplars: the tail batches a p99 scrape would link to
    exemplars = []
    for name, hstate in (struct.get("histograms") or {}).items():
        for ex in (hstate.get("exemplars") or {}).values():
            try:
                exemplars.append((float(ex[1]), str(ex[0]), name))
            except (IndexError, TypeError, ValueError):
                continue
    if exemplars:
        exemplars.sort(reverse=True)
        print("exemplars (worst observed per bucket):", file=out)
        # the attribution→journey pivot: an exemplar captured under an
        # active journey context carries the journey's trace id, so the
        # printed invocation reconstructs that record's whole timeline
        src = source if source is not None else "<journey-source>"
        for v, tid, name in exemplars[:5]:
            print(
                f"  {1000.0 * v:10.3f} ms  trace_id={tid}  {name}",
                file=out,
            )
            print(f"      ↳ fjt-trace {src} --id {tid}", file=out)


def _top_render_freshness(label: str, struct: dict, out) -> None:
    """The ``--freshness`` panel: event-time watermark lag and kafka
    lag per partition (with observation age), record staleness
    quantiles, drain forecast, and the composite pressure score —
    obs/freshness.py + obs/pressure.py rendered as one operator view."""
    import re as _re

    from flink_jpmml_tpu_torch.utils.metrics import Histogram

    title = label or "aggregate"
    print(f"== {title} · freshness ==", file=out)
    gauges = struct.get("gauges") or {}
    counters = struct.get("counters") or {}

    def g(name):
        v = gauges.get(name)
        return v.get("value") if isinstance(v, dict) else None

    rendered = False
    p = g("pressure")
    if p is not None:
        rendered = True
        comps = "  ".join(
            f"{k.split('_', 1)[1]} {g(k):.2f}"
            for k in ("pressure_ring", "pressure_window", "pressure_wait")
            if g(k) is not None
        )
        breaches = counters.get("pressure_breaches", 0)
        print(
            f"pressure {p:5.2f}   [{comps}]   breaches {breaches:.0f}",
            file=out,
        )
    eta, trend = g("lag_drain_eta_s"), g("lag_trend")
    if eta is not None or trend is not None:
        rendered = True
        diverging = bool(g("lag_diverging"))
        eta_s = (
            "DIVERGING" if diverging
            else ("-" if eta is None else f"{eta:,.1f}s")
        )
        print(
            f"drain    eta {eta_s}   trend "
            f"{trend if trend is not None else 0:+,.1f} rec/s "
            "(+ = falling behind)",
            file=out,
        )
    hstate = (struct.get("histograms") or {}).get("record_staleness_s")
    if isinstance(hstate, dict):
        try:
            h = Histogram.from_state(hstate)
            if h.count():
                rendered = True
                print(
                    f"stale    p50 {1000.0 * (h.quantile(0.5) or 0):,.1f} ms"
                    f"   p99 {1000.0 * (h.quantile(0.99) or 0):,.1f} ms"
                    f"   n {h.count()}",
                    file=out,
                )
        except (KeyError, TypeError, ValueError):
            pass
    wm = g("watermark_ts")
    if wm is not None:
        rendered = True
        import datetime

        ts = datetime.datetime.fromtimestamp(
            wm, datetime.timezone.utc
        ).strftime("%H:%M:%S.%f")[:-3]
        print(f"watermark sink low-watermark {ts}Z", file=out)
    # per-partition table, keyed across the three labelled families
    pat = _re.compile(
        r'^(watermark_lag_s|kafka_lag|kafka_lag_age_s)'
        r'\{partition="([^"]+)"\}$'
    )
    parts: Dict[str, Dict[str, float]] = {}
    for name, v in gauges.items():
        m = pat.match(name)
        if m and isinstance(v, dict):
            parts.setdefault(m.group(2), {})[m.group(1)] = v["value"]
    if parts:
        rendered = True
        print(
            f"{'partition':<12}{'wm lag s':>10}{'kafka lag':>12}"
            f"{'obs age s':>11}",
            file=out,
        )
        for part in sorted(parts):
            row = parts[part]

            def cell(key, fmt):
                v = row.get(key)
                return "-" if v is None else format(v, fmt)

            print(
                f"{part:<12}{cell('watermark_lag_s', '.3f'):>10}"
                f"{cell('kafka_lag', ',.0f'):>12}"
                f"{cell('kafka_lag_age_s', '.1f'):>11}",
                file=out,
            )
    if not rendered:
        # nothing above actually printed (an eagerly-registered but
        # empty staleness histogram is not telemetry)
        print("(no freshness telemetry recorded)", file=out)


def _top_render_drift(label: str, struct: dict, out) -> None:
    """The ``--drift`` panel: the data-health plane (obs/drift.py) as a
    ranked per-feature table — live-vs-baseline PSI, missing and
    out-of-domain rates, sketch sample counts, alarm markers — plus the
    per-model prediction-distribution drift line. Rows rank worst
    first: the feature to investigate is the top one."""
    from flink_jpmml_tpu_torch.obs import drift as drift_mod

    title = label or "aggregate"
    print(f"== {title} · drift ==", file=out)
    s = drift_mod.summary(struct)
    counters = struct.get("counters") or {}
    if not s:
        print("(no drift telemetry recorded — set FJT_DRIFT_SAMPLE "
              "and snapshot a baseline with fjt-drift)", file=out)
        return
    alarms = counters.get("drift_alarms", 0)
    if alarms:
        print(f"alarms   {alarms:.0f} raised (see drift_alarm flight "
              "events)", file=out)
    for model in sorted(s):
        m = s[model]
        pred = m.get("prediction_psi")
        head = f"model {model}"
        if pred is not None:
            mark = " [ALARM]" if m.get("prediction_alarmed") else ""
            head += f"   prediction drift PSI {pred:.4f}{mark}"
        print(head, file=out)
        rows = m.get("features") or {}
        if not rows:
            continue
        print(
            f"{'feature':<20}{'psi':>9}{'missing':>9}{'unseen':>9}"
            f"{'n':>10}  alarm",
            file=out,
        )
        ranked = sorted(
            rows.items(),
            key=lambda kv: (
                kv[1]["psi"] if kv[1]["psi"] is not None else -1.0
            ),
            reverse=True,
        )
        for name, row in ranked:
            def cell(key, fmt):
                v = row.get(key)
                return "-" if v is None else format(v, fmt)

            print(
                f"{name:<20}{cell('psi', '.4f'):>9}"
                f"{cell('missing_rate', '.2%'):>9}"
                f"{cell('unseen_rate', '.2%'):>9}"
                f"{cell('n', ',.0f'):>10}"
                f"  {'ALARM' if row.get('alarmed') else '-'}",
                file=out,
            )


def _top_render_overload(label: str, struct: dict, out) -> None:
    """The ``--overload`` panel: the admission/adaptive-batching plane
    (serving/overload.py) as one operator view — deadline vs live p99,
    the chosen dispatch size, shed level + per-lane shed counts, and
    the pressure signal the controller sheds on."""
    from flink_jpmml_tpu_torch.serving import overload as overload_mod

    title = label or "aggregate"
    print(f"== {title} · overload ==", file=out)
    gauges = struct.get("gauges") or {}

    def g(name):
        v = gauges.get(name)
        return v.get("value") if isinstance(v, dict) else None

    s = overload_mod.summary(struct) or {}
    rendered = False
    deadline = s.get("deadline_ms")
    if deadline:
        rendered = True
        p99 = s.get("p99_ms")
        ratio = s.get("p99_vs_deadline_ratio")
        verdict = (
            "-" if ratio is None
            else ("MET" if ratio <= 1.0 else "BREACHED")
        )
        line = f"deadline {deadline:,.1f} ms   {verdict}"
        if p99 is not None:
            line += (
                f"   p99 {p99:,.1f} ms ({ratio:.2f}x, "
                f"{s.get('latency_source')})"
            )
        print(line, file=out)
    batch = s.get("adaptive_batch")
    if batch is not None:
        rendered = True
        print(f"batch    {batch:,.0f} records/dispatch (adaptive cap)",
              file=out)
    p = g("pressure")
    if p is not None:
        rendered = True
        print(f"pressure {p:5.2f}", file=out)
    level = s.get("shed_level")
    admitted = s.get("admitted_records")
    shed = s.get("shed_records") or {}
    if level is not None or admitted is not None or shed:
        rendered = True
        total_shed = sum(shed.values())
        print(
            f"admission level {level if level is not None else 0:.0f}   "
            f"admitted {admitted or 0:,.0f}   shed {total_shed:,.0f}",
            file=out,
        )
        if shed:
            print(f"{'lane':<12}{'shed records':>14}", file=out)
            for lane in sorted(shed):
                print(f"{lane:<12}{shed[lane]:>14,.0f}", file=out)
    backoff = g("reconnect_backoff_s")
    if backoff:
        rendered = True
        print(f"backoff  {backoff:,.3f}s (retry streak in progress)",
              file=out)
    if not rendered:
        print("(no overload telemetry recorded)", file=out)


def _top_render_failover(label: str, struct: dict, out,
                         source: str = None) -> None:
    """The ``--failover`` panel: the device-fault resilience plane
    (runtime/devfault.py + serving/failover.py) as one operator view —
    circuit state per served model, the fallback tier's share of
    delivered records, redispatch/OOM-shrink counts, the device-fault
    taxonomy totals, and the checkpoint-suspension flag. The last
    device error itself rides the rate-limited ``device_fault`` flight
    event with the journey's trace id — the printed ``fjt-trace``
    invocation is the pivot."""
    from flink_jpmml_tpu_torch.serving import failover as failover_mod

    title = label or "aggregate"
    print(f"== {title} · failover ==", file=out)
    s = failover_mod.summary(struct) or {}
    rendered = False
    states = s.get("states") or {}
    if states:
        rendered = True
        print(f"{'model':<24}{'circuit':>10}", file=out)
        for model in sorted(states):
            print(f"{model:<24}{states[model]:>10}", file=out)
    share = s.get("fallback_share")
    fb = s.get("fallback_records")
    if fb:
        rendered = True
        line = f"fallback   {fb:,.0f} records"
        if share is not None:
            line += f" ({100.0 * share:.2f}% of delivered)"
        print(line, file=out)
    rd = s.get("redispatch_records")
    if rd:
        rendered = True
        print(f"redispatch {rd:,.0f} records", file=out)
    oo = s.get("oom_shrinks")
    if oo:
        rendered = True
        print(f"oom-shrink {oo:,.0f} batch-size bisections", file=out)
    faults_by_kind = s.get("device_faults") or {}
    if faults_by_kind:
        rendered = True
        print(f"{'fault kind':<24}{'observed':>10}", file=out)
        for kind in sorted(faults_by_kind):
            print(f"{kind:<24}{faults_by_kind[kind]:>10,.0f}", file=out)
    if s.get("checkpoint_suspended"):
        rendered = True
        print("checkpoint plane SUSPENDED (disk full — replay window "
              "widening)", file=out)
    if s.get("mesh_lost_devices"):
        rendered = True
        print(f"mesh: {s['mesh_lost_devices']:.0f} chip(s) lost "
              "(degraded-mesh mode)", file=out)
    if not rendered:
        print("(no failover telemetry recorded)", file=out)
    elif source:
        # the trace pivot: device_fault flight events carry trace ids
        print(f"pivot: fjt-trace {source} --id <trace_id>   "
              "(ids ride device_fault flight events)", file=out)


def _top_render_mesh(label: str, struct: dict, out) -> None:
    """The ``--mesh`` panel: per-chip serving telemetry (obs/mesh.py)
    as one operator view — rec/s, cumulative records, in-flight window
    depth, and health state per chip, plus the surviving data-axis
    width and the degraded-mesh rebuild count. On a fleet struct the
    per-chip counters arrive SUM-merged and ``mesh_data_width``
    MIN-merged (the most-degraded worker), per the catalogue rules."""
    from flink_jpmml_tpu_torch.obs import mesh as mesh_mod

    title = label or "aggregate"
    print(f"== {title} · mesh ==", file=out)
    s = mesh_mod.summary(struct)
    if not s:
        print("(no mesh telemetry recorded — single-chip serving)",
              file=out)
        return
    print(f"{'chip':<10}{'rec/s':>12}{'records':>14}{'in-flight':>11}"
          f"{'state':>10}", file=out)
    for chip, v in s["chips"].items():
        rate = v.get("rec_per_s")
        print(
            f"{chip:<10}"
            f"{(f'{rate:,.0f}' if rate is not None else '-'):>12}"
            f"{v['records']:>14,.0f}"
            f"{v['inflight']:>11,.0f}"
            f"{v['state']:>10}",
            file=out,
        )
    width = s.get("data_width")
    if width is not None:
        print(f"data width {width:.0f} surviving chip(s)", file=out)
    if s.get("rebuilds"):
        print(f"rebuilds   {s['rebuilds']:,.0f} degraded-mesh "
              "rebuild(s)", file=out)
    if s.get("lost_devices"):
        print(f"lost       {s['lost_devices']:.0f} device(s) retired "
              "(degraded-mesh mode)", file=out)


def _top_render_zoo(label: str, struct: dict, out) -> None:
    """The ``--zoo`` panel: multi-tenant packed-serving telemetry
    (serving/zoo.py + the per-tenant families) as one operator view —
    pack dispatch/occupancy/pad-waste, warm-pool and cold-start
    economics, and the per-tenant table ranked by delivered records
    with shed counts and latency quantiles. On a fleet struct the
    counters arrive SUM-merged, ``pack_occupancy`` MIN-merged (the
    worst-filled worker) and ``pack_pad_waste`` MAX-merged (the most
    wasteful), per the catalogue rules."""
    import re as _re

    from flink_jpmml_tpu_torch.utils.metrics import Histogram

    title = label or "aggregate"
    print(f"== {title} · zoo ==", file=out)
    gauges = struct.get("gauges") or {}
    counters = struct.get("counters") or {}
    hists = struct.get("histograms") or {}

    def g(name):
        v = gauges.get(name)
        return v.get("value") if isinstance(v, dict) else None

    def hq(name, q):
        hstate = hists.get(name)
        if not isinstance(hstate, dict):
            return None
        try:
            h = Histogram.from_state(hstate)
            return h.quantile(q) if h.count() else None
        except (KeyError, TypeError, ValueError):
            return None

    rendered = False
    disp = counters.get("pack_dispatches", 0)
    occ, waste = g("pack_occupancy"), g("pack_pad_waste")
    res = g("zoo_resident_bytes")
    if disp or occ is not None or res is not None:
        rendered = True
        parts = [f"dispatches {disp:,.0f}"]
        if occ is not None:
            parts.append(f"occupancy {100.0 * occ:.1f}%")
        if waste is not None:
            parts.append(f"pad-waste {100.0 * waste:.1f}%")
        if res is not None:
            parts.append(f"resident {res / 1e6:,.1f} MB")
        print("packs    " + "   ".join(parts), file=out)
    hits = counters.get("warm_pool_hits", 0)
    miss = counters.get("warm_pool_misses", 0)
    evict = counters.get("zoo_evictions", 0)
    if hits or miss or evict:
        rendered = True
        line = (f"warm     hits {hits:,.0f}   misses {miss:,.0f}"
                f"   evictions {evict:,.0f}")
        p50, p99 = hq("cold_start_s", 0.5), hq("cold_start_s", 0.99)
        if p50 is not None:
            line += (f"   cold-start p50 {1000.0 * p50:,.1f} ms"
                     f"  p99 {1000.0 * (p99 or p50):,.1f} ms")
        print(line, file=out)
    # per-tenant table: the three {model=*} families joined on label
    pat = _re.compile(
        r'^(tenant_records|tenant_shed_records)\{model="([^"]+)"\}$'
    )
    tenants: Dict[str, Dict[str, float]] = {}
    for name, v in counters.items():
        m = pat.match(name)
        if m:
            tenants.setdefault(m.group(2), {})[m.group(1)] = float(v)
    if tenants:
        rendered = True
        print(
            f"{'tenant':<24}{'records':>12}{'shed':>9}{'p50 ms':>10}"
            f"{'p99 ms':>10}",
            file=out,
        )
        ranked = sorted(
            tenants.items(),
            key=lambda kv: kv[1].get("tenant_records", 0.0),
            reverse=True,
        )
        for tenant, row in ranked[:20]:
            lname = f'tenant_latency_s{{model="{tenant}"}}'
            p50, p99 = hq(lname, 0.5), hq(lname, 0.99)
            print(
                f"{tenant:<24}"
                f"{row.get('tenant_records', 0.0):>12,.0f}"
                f"{row.get('tenant_shed_records', 0.0):>9,.0f}"
                f"{(f'{1000.0 * p50:,.2f}' if p50 is not None else '-'):>10}"
                f"{(f'{1000.0 * p99:,.2f}' if p99 is not None else '-'):>10}",
                file=out,
            )
        if len(ranked) > 20:
            print(f"... and {len(ranked) - 20} more tenant(s)", file=out)
    if not rendered:
        print("(no zoo telemetry recorded — single-tenant serving or "
              "zoo mode off)", file=out)


def _top_render_state(label: str, struct: dict, out) -> None:
    """The ``--state`` panel: the keyed session-state plane
    (runtime/state.py) as one operator view — table occupancy and hit
    ratio, routing outcome counts (hits / inserts / evictions /
    collisions / overflow), and the correctness counters (bypassed
    replays, rollbacks). Empty-by-default: a pipeline without a state
    table registers nothing, and the panel says so instead of
    rendering a wall of zeros. On a fleet struct ``state_*`` counters
    and ``state_resident_keys`` arrive SUM-merged,
    ``state_occupancy_frac`` MAX-merged (the fullest table) and
    ``state_hit_ratio`` MIN-merged (the coldest), per the catalogue
    rules."""
    title = label or "aggregate"
    print(f"== {title} · state ==", file=out)
    gauges = struct.get("gauges") or {}
    counters = struct.get("counters") or {}

    def g(name):
        v = gauges.get(name)
        return v.get("value") if isinstance(v, dict) else None

    def c(name):
        try:
            return float(counters.get(name, 0) or 0)
        except (TypeError, ValueError):
            return 0.0

    resident, occ = g("state_resident_keys"), g("state_occupancy_frac")
    hit_ratio = g("state_hit_ratio")
    records = c("state_records")
    rendered = False
    if resident is not None or records:
        rendered = True
        parts = []
        if resident is not None:
            parts.append(f"resident {resident:,.0f} keys")
        if occ is not None:
            parts.append(f"occupancy {100.0 * occ:.1f}%")
        if hit_ratio is not None:
            parts.append(f"hit-ratio {100.0 * hit_ratio:.1f}%")
        print("table    " + "   ".join(parts), file=out)
        print(
            f"routing  records {records:,.0f}   hits "
            f"{c('state_hits'):,.0f}   inserts "
            f"{c('state_inserts'):,.0f}   evictions "
            f"{c('state_evictions'):,.0f}   collisions "
            f"{c('state_collisions'):,.0f}   overflow "
            f"{c('state_overflow'):,.0f}",
            file=out,
        )
    bypassed, rollbacks = c("state_bypass_records"), c("state_rollbacks")
    if bypassed or rollbacks:
        rendered = True
        print(
            f"safety   bypassed replays {bypassed:,.0f}   rollbacks "
            f"{rollbacks:,.0f}",
            file=out,
        )
    if not rendered:
        print("(no keyed-state telemetry recorded — state plane "
              "unarmed)", file=out)


def top_main(argv: Optional[List[str]] = None) -> int:
    """``fjt-top``: the fleet attribution table (see module docstring).
    Renders every labelled source (the supervisor's /varz serves the
    aggregate under ``""`` plus one struct per worker); ``--worker``
    narrows to one label."""
    ap = argparse.ArgumentParser(
        prog="fjt-top",
        description="Render per-stage latency attribution, live device "
                    "occupancy, and top exemplars from /varz or a "
                    "struct dump.",
    )
    ap.add_argument("source",
                    help="obs-server base URL (or /varz URL), a /varz "
                         "JSON dump, or a BENCH_*.json artifact")
    ap.add_argument("--worker", default=None,
                    help="render only this source label "
                         "(default: all, aggregate first)")
    ap.add_argument("--freshness", action="store_true",
                    help="render the freshness/backpressure panel "
                         "(event-time watermark lag, staleness, drain "
                         "forecast, pressure) instead of the stage table")
    ap.add_argument("--overload", action="store_true",
                    help="render the overload/admission panel (deadline "
                         "vs p99, adaptive batch, shed level + per-lane "
                         "shed counts) instead of the stage table")
    ap.add_argument("--drift", action="store_true",
                    help="render the data-drift panel (per-feature "
                         "live-vs-baseline PSI ranked worst-first, "
                         "missing/out-of-domain rates, prediction "
                         "drift, alarms) instead of the stage table")
    ap.add_argument("--failover", action="store_true",
                    help="render the device-fault/failover panel "
                         "(circuit state per model, fallback-tier "
                         "share, redispatch/OOM-shrink counts, device "
                         "fault taxonomy, checkpoint suspension) "
                         "instead of the stage table")
    ap.add_argument("--mesh", action="store_true",
                    help="render the multichip panel (per-chip rec/s, "
                         "in-flight depth, health state, surviving "
                         "data width, degraded-mesh rebuilds) instead "
                         "of the stage table")
    ap.add_argument("--zoo", action="store_true",
                    help="render the multi-tenant zoo panel (pack "
                         "dispatch/occupancy/pad-waste, warm-pool and "
                         "cold-start economics, per-tenant records/"
                         "shed/latency ranked by traffic) instead of "
                         "the stage table")
    ap.add_argument("--state", action="store_true",
                    help="render the keyed session-state panel (table "
                         "occupancy/hit-ratio, routing outcome counts, "
                         "bypassed replays and rollbacks) instead of "
                         "the stage table")
    ap.add_argument("--watch", type=float, default=None, metavar="N",
                    help="re-render every N seconds from a live source "
                         "(operator console mode; mid-watch fetch "
                         "failures retry instead of exiting)")
    args = ap.parse_args(argv)
    if args.watch is not None and args.watch <= 0:
        raise SystemExit(f"--watch must be > 0, got {args.watch}")
    if sum((args.freshness, args.overload, args.drift,
            args.failover, args.mesh, args.zoo, args.state)) > 1:
        raise SystemExit(
            "--freshness, --overload, --drift, --failover, --mesh, "
            "--zoo, and --state are exclusive"
        )
    render = (
        _top_render_freshness if args.freshness
        else _top_render_overload if args.overload
        else _top_render_drift if args.drift
        else _top_render_mesh if args.mesh
        else _top_render_zoo if args.zoo
        else _top_render_state if args.state
        else (
            lambda label, struct, out: _top_render_failover(
                label, struct, out, source=args.source
            )
        ) if args.failover
        else (
            lambda label, struct, out: _top_render(
                label, struct, out, source=args.source
            )
        )
    )

    def _render_once(sources, stale_after=None, now=None) -> None:
        from flink_jpmml_tpu_torch.obs import attr as _attr

        if args.worker is not None:
            if args.worker not in sources:
                raise SystemExit(
                    f"no source {args.worker!r}; have "
                    f"{sorted(sources)}"
                )
            sources = {args.worker: sources[args.worker]}
        first = True
        for label in sorted(sources, key=lambda k: (k != "", k)):
            if not first:
                print(file=sys.stdout)
            disp = label
            if stale_after is not None:
                # the snapshot's OWN capture timestamp, not fetch time:
                # a supervisor keeps serving a dead worker's last struct,
                # and that panel must say so instead of reading as live
                tag = _attr.staleness_tag(
                    sources[label], stale_after, now=now
                )
                if tag:
                    disp = (label or "aggregate") + tag
            render(disp, sources[label], sys.stdout)
            first = False

    if args.watch is None:
        _render_once(_top_load(args.source))
        return 0
    import time as _time

    from flink_jpmml_tpu_torch.obs import attr as _attr

    try:
        stale_after = float(os.environ["FJT_TOP_STALE_S"])
    except (KeyError, ValueError):
        stale_after = max(10.0, 3.0 * args.watch)

    while True:
        try:
            sources = _top_load(args.source)
        except (SystemExit, Exception) as e:
            # an operator console must ride out a worker restart or a
            # dropped tunnel: note the failure, keep watching (a
            # missing --worker label is surfaced the same way — it
            # reappears when the worker rejoins). Any Exception, not
            # just the wrapped SystemExit: a proxy's non-UTF-8 error
            # page or a half-written struct must not kill the console
            # at exactly the moment it promises to ride out
            print(f"[fjt-top] {e!r}; retrying in {args.watch:g}s",
                  file=sys.stderr, flush=True)
        else:
            if sys.stdout.isatty():  # console: repaint in place
                print("\x1b[2J\x1b[H", end="", file=sys.stdout)
            now = _time.time()
            ages = [
                a for a in (
                    _attr.snapshot_age_s(s, now=now)
                    for s in sources.values()
                )
                if a is not None
            ]
            hdr = _time.strftime("-- %H:%M:%S ")
            if ages:
                lo, hi = min(ages), max(ages)
                hdr += f" (frame age {lo:.1f}s"
                if hi - lo > 0.05:
                    hdr += f" .. {hi:.1f}s"
                hdr += ")"
            print(hdr, file=sys.stdout)
            try:
                _render_once(sources, stale_after=stale_after, now=now)
            except (SystemExit, Exception) as e:
                print(f"[fjt-top] {e!r}; retrying in {args.watch:g}s",
                      file=sys.stderr, flush=True)
            sys.stdout.flush()
        _time.sleep(args.watch)


def _replay_load(source: str, qargs: dict) -> dict:
    """→ a ``/history`` payload (obs/history.py ``query`` shape) from a
    history directory or an obs-server base (or /history) URL."""
    if source.startswith(("http://", "https://")):
        import urllib.error
        import urllib.parse
        import urllib.request

        url = source.rstrip("/")
        if not url.endswith("/history"):
            url += "/history"
        q = {}
        if qargs.get("names"):
            q["name"] = ",".join(qargs["names"])
        if qargs.get("sources"):
            q["source"] = ",".join(qargs["sources"])
        for k in ("start", "end", "step"):
            if qargs.get(k) is not None:
                q[k] = repr(float(qargs[k]))
        if q:
            url += "?" + urllib.parse.urlencode(q)
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                payload = json.loads(r.read().decode())
        except (urllib.error.URLError, OSError,
                json.JSONDecodeError) as e:
            raise SystemExit(f"cannot read {url!r}: {e}")
        if not isinstance(payload, dict):
            raise SystemExit(f"{url!r} is not a JSON object")
        return payload
    from flink_jpmml_tpu_torch.obs import history

    if not os.path.isdir(source):
        raise SystemExit(
            f"{source!r} is neither a history directory nor an "
            "obs-server URL"
        )
    return history.query(source, **qargs)


def replay_main(argv: Optional[List[str]] = None) -> int:
    """``fjt-replay``: retrospective incident replay from the durable
    telemetry history (obs/history.py). Reads delta frames from a
    history directory (``FJT_HISTORY_DIR``) or a live ``/history``
    endpoint, prints a per-window timeline (records, shed, pressure,
    offered vs fitted capacity, headroom), then renders the whole range
    through the selected ``fjt-top`` panel — the console a worker's
    SIGKILL cannot erase, because the frames are already on disk:

        fjt-replay /data/history --last 600 --step 15
        fjt-replay http://127.0.0.1:9100 --panel zoo
        fjt-replay /data/history --source _fleet --panel overload
    """
    ap = argparse.ArgumentParser(
        prog="fjt-replay",
        description="Replay recorded telemetry history: a per-window "
                    "incident timeline plus any fjt-top panel rendered "
                    "over the range, from durable frames alone.",
    )
    ap.add_argument("path", metavar="DIR|URL",
                    help="history directory (FJT_HISTORY_DIR) or "
                         "obs-server base / /history URL")
    ap.add_argument("--start", type=float, default=None, metavar="TS",
                    help="range start (unix seconds)")
    ap.add_argument("--end", type=float, default=None, metavar="TS",
                    help="range end (unix seconds)")
    ap.add_argument("--last", type=float, default=None, metavar="S",
                    help="shorthand: the trailing S seconds "
                         "(end defaults to now)")
    ap.add_argument("--step", type=float, default=None, metavar="S",
                    help="timeline window width in seconds (default: "
                         "the finest stored resolution)")
    ap.add_argument("--source", default=None,
                    help="comma-separated frame sources (worker ids, "
                         "or _fleet for the supervisor's aggregate; "
                         "default: all workers — _fleet excluded, it "
                         "re-counts the same traffic)")
    ap.add_argument("--name", default=None,
                    help="comma-separated metric name patterns "
                         "(fnmatch) to project frames down to")
    ap.add_argument("--panel", default="stage",
                    choices=["stage", "freshness", "overload", "drift",
                             "failover", "mesh", "zoo", "state",
                             "none"],
                    help="fjt-top panel to render over the merged "
                         "range (default: stage; none = timeline only)")
    ap.add_argument("--json", action="store_true",
                    help="dump the raw query payload (frames keep the "
                         "exact wire encoding) instead of rendering")
    args = ap.parse_args(argv)
    if args.last is not None and args.last <= 0:
        raise SystemExit(f"--last must be > 0, got {args.last}")
    import time as _time

    from flink_jpmml_tpu_torch.obs import history as _hist

    qargs = {
        "names": (
            [p for p in args.name.split(",") if p] if args.name else None
        ),
        "sources": (
            [p for p in args.source.split(",") if p]
            if args.source else None
        ),
        "start": args.start,
        "end": args.end,
        "step": args.step,
    }
    if args.last is not None:
        qargs["end"] = args.end if args.end is not None else _time.time()
        qargs["start"] = qargs["end"] - args.last
    payload = _replay_load(args.path, qargs)
    if args.json:
        json.dump(payload, sys.stdout, sort_keys=True)
        print(file=sys.stdout)
        return 0
    frames = [
        f for f in (payload.get("frames") or []) if isinstance(f, dict)
    ]
    if not frames:
        res = payload.get("resolutions") or []
        print(
            "no frames in range"
            + (f" (stored resolutions: {res})" if res
               else " (nothing recorded — FJT_HISTORY_DIR armed?)"),
            file=sys.stderr,
        )
        return 1

    def _cnt(f: dict, *bases: str) -> float:
        """Exact-wire counter sum over the given base families (label
        series included), rendered as a float."""
        tot = 0.0
        for n, v in (f.get("counters") or {}).items():
            if n.split("{", 1)[0] in bases:
                try:
                    tot += _hist.wire_float(v)
                except (TypeError, ValueError, ZeroDivisionError):
                    pass
        return tot

    def _gv(f: dict, name: str) -> Optional[float]:
        g = (f.get("gauges") or {}).get(name)
        if not isinstance(g, dict):
            return None
        try:
            return _hist.combined_last(name, g.get("last"))
        except (AttributeError, TypeError, ValueError):
            return None

    def _fmt(v: Optional[float], spec: str) -> str:
        return format(v, spec) if v is not None else "-"

    print(
        f"{'time':<10}{'records':>10}{'rec/s':>9}{'shed':>8}"
        f"{'press':>7}{'offered':>9}{'capacity':>9}{'headroom':>9}"
        f"{'resets':>7}",
        file=sys.stdout,
    )
    for f in frames:
        t0, t1 = float(f.get("t0", 0.0)), float(f.get("t1", 0.0))
        span = max(t1 - t0, 1e-9)
        rec = _cnt(f, "records_out")
        shed = _cnt(f, "shed_records", "tenant_shed_records")
        hr = _gv(f, "headroom_frac")
        print(
            f"{_time.strftime('%H:%M:%S', _time.localtime(t0)):<10}"
            f"{rec:>10,.0f}"
            f"{rec / span:>9,.0f}"
            f"{shed:>8,.0f}"
            f"{_fmt(_gv(f, 'pressure'), '.2f'):>7}"
            f"{_fmt(_gv(f, 'offered_rec_s'), ',.0f'):>9}"
            f"{_fmt(_gv(f, 'capacity_rec_s'), ',.0f'):>9}"
            f"{_fmt(100.0 * hr if hr is not None else None, '.1f'):>8}"
            f"{'%' if hr is not None else ' '}"
            f"{int(f.get('resets', 0) or 0):>7}",
            file=sys.stdout,
        )
    merged = _hist.merge_frames(frames)
    srcs = str(merged.get("src", ""))
    total_resets = int(merged.get("resets", 0) or 0)
    print(
        f"{len(frames)} window(s)   sources [{srcs}]"
        + (f"   {total_resets} counter reset(s) — worker restart(s) "
           "inside the range" if total_resets else ""),
        file=sys.stdout,
    )
    if args.panel == "none":
        return 0
    struct = _hist.frame_to_struct(merged)
    t0s = _time.strftime(
        "%H:%M:%S", _time.localtime(float(merged.get("t0", 0.0)))
    )
    t1s = _time.strftime(
        "%H:%M:%S", _time.localtime(float(merged.get("t1", 0.0)))
    )
    label = f"replay {t0s}..{t1s}"
    render = {
        "stage": lambda l, s, o: _top_render(l, s, o, source=args.path),
        "freshness": _top_render_freshness,
        "overload": _top_render_overload,
        "drift": _top_render_drift,
        "failover": lambda l, s, o: _top_render_failover(
            l, s, o, source=args.path
        ),
        "mesh": _top_render_mesh,
        "zoo": _top_render_zoo,
        "state": _top_render_state,
    }[args.panel]
    print(file=sys.stdout)
    render(label, struct, sys.stdout)
    return 0


def _drift_merge_sources(sources: Dict[str, dict]) -> dict:
    """One struct to snapshot/check against: the aggregate (``""``)
    label when the source carries one, else the fleet merge of every
    labelled struct (a supervisor /varz without a precomputed
    aggregate)."""
    from flink_jpmml_tpu_torch.utils.metrics import merge_structs

    if "" in sources:
        return sources[""]
    return merge_structs(list(sources.values()))


def drift_main(argv: Optional[List[str]] = None) -> int:
    """``fjt-drift``: manage the data-drift baseline registry
    (obs/drift.py) from the shell — no device needed, safe on any host.

        fjt-drift snapshot http://127.0.0.1:9100   # live profile → baseline
        fjt-drift snapshot BENCH_r09.json --model <hash>
        fjt-drift list
        fjt-drift check http://127.0.0.1:9100      # PSI table vs baseline

    ``snapshot`` captures the source's CURRENT cumulative per-feature
    profiles as the reference the DriftMonitor diffs live windows
    against, content-addressed beside the autotune cache (override with
    --dir). A corrupt baseline file on disk reads as absent — simply
    re-snapshot."""
    ap = argparse.ArgumentParser(
        prog="fjt-drift",
        description="Capture, list, and check data-drift baselines.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    ap_snap = sub.add_parser(
        "snapshot",
        help="capture a reference profile per (model, feature) from a "
             "live /varz URL, a struct dump, or a BENCH artifact",
    )
    ap_snap.add_argument("source")
    ap_snap.add_argument("--model", default=None,
                         help="only this model label (default: all)")
    ap_snap.add_argument("--dir", default=None,
                         help="baseline directory (default: "
                              "drift_baselines/ beside the autotune "
                              "cache)")
    ap_list = sub.add_parser("list", help="list stored baselines")
    ap_list.add_argument("--dir", default=None)
    ap_check = sub.add_parser(
        "check",
        help="PSI of a source's cumulative profiles vs the stored "
             "baselines (exit 1 when any feature exceeds --psi)",
    )
    ap_check.add_argument("source")
    ap_check.add_argument("--model", default=None)
    ap_check.add_argument("--dir", default=None)
    ap_check.add_argument("--psi", type=float, default=0.25,
                          help="failure threshold (default 0.25)")
    args = ap.parse_args(argv)

    from flink_jpmml_tpu_torch.obs import drift as drift_mod
    from flink_jpmml_tpu_torch.utils.metrics import QuantileSketch

    store = drift_mod.BaselineStore(args.dir)

    if args.cmd == "list":
        models = store.models()
        if not models:
            print(f"no baselines under {store.root}", file=sys.stderr)
            return 0
        for m in models:
            payload = store.load(m)
            feats = sorted((payload or {}).get("features") or {})
            print(f"{m}  features={len(feats)}  "
                  f"predictions={'yes' if (payload or {}).get('predictions') else 'no'}  "
                  f"({store.path(m)})")
        return 0

    struct = _drift_merge_sources(_top_load(args.source))
    payloads = drift_mod.snapshot_from_struct(struct)
    if args.model is not None:
        payloads = {
            k: v for k, v in payloads.items() if k == args.model
        }
    if not payloads:
        raise SystemExit(
            f"no drift profiles in {args.source!r}"
            + (f" for model {args.model!r}" if args.model else "")
            + " — is FJT_DRIFT_SAMPLE set on the pipeline?"
        )

    if args.cmd == "snapshot":
        for label, payload in sorted(payloads.items()):
            try:
                path = store.save(label, payload)
            except OSError as e:
                # a snapshot that didn't land must FAIL — the operator
                # would otherwise believe the drift plane is armed
                raise SystemExit(
                    f"cannot write baseline for {label!r}: {e}"
                )
            print(
                f"baselined {label}: {len(payload['features'])} features"
                + (", predictions" if payload.get("predictions") else "")
                + f" -> {path}",
                file=sys.stderr,
            )
        return 0

    # check: cumulative-vs-baseline PSI per feature
    rc = 0
    for label, payload in sorted(payloads.items()):
        base = store.load(label)
        if base is None:
            print(f"{label}: no baseline stored (fjt-drift snapshot "
                  "first)", file=sys.stderr)
            continue
        print(f"model {label}")
        rows = []
        for feat, lstate in sorted(payload.get("features", {}).items()):
            bstate = (base.get("features") or {}).get(feat)
            if bstate is None:
                continue
            try:
                score = drift_mod.psi(
                    QuantileSketch.from_state(bstate),
                    QuantileSketch.from_state(lstate),
                )
            except (KeyError, TypeError, ValueError):
                score = None
            rows.append((feat, score))
        bpred, lpred = base.get("predictions"), payload.get("predictions")
        if isinstance(bpred, dict) and isinstance(lpred, dict):
            try:
                rows.append(("(predictions)", drift_mod.psi(
                    QuantileSketch.from_state(bpred),
                    QuantileSketch.from_state(lpred),
                )))
            except (KeyError, TypeError, ValueError):
                pass
        rows.sort(key=lambda r: -1.0 if r[1] is None else r[1],
                  reverse=True)
        for feat, score in rows:
            verdict = "-"
            if score is not None and score > args.psi:
                verdict = "DRIFTED"
                rc = 1
            s = "-" if score is None else f"{score:.4f}"
            print(f"  {feat:<20} psi {s:>9}  {verdict}")
    return rc


# ---------------------------------------------------------------------------
# fjt-trace: causal record-journey reconstruction (obs/trace.py)
# ---------------------------------------------------------------------------

# flight-event kinds worth placing on a journey timeline (others are
# process-wide noise for this view); offset-carrying ones get their
# range fields normalized below
_TRACE_FLIGHT_KINDS = {
    "poison_suspect_mode", "poison_suspect_exit", "poison_isolation",
    "poison_isolated", "poison_quarantined", "latency_exemplar",
    "decode_error", "dispatch_abandon", "dlq_truncated",
    "worker_death", "worker_restart", "worker_spawn", "worker_give_up",
    "fault_injected", "drift_alarm",
}


def _trace_norm_flight(ev: dict) -> Optional[dict]:
    """Flight-recorder event → journey-row shape (None = not journey-
    relevant). ``lo``/``hi`` and ``first``/``n`` normalize to the
    journey rows' ``first_off``/``n`` so offset selection is uniform."""
    kind = ev.get("kind")
    if kind not in _TRACE_FLIGHT_KINDS:
        return None
    row = dict(ev)
    row["src"] = "flight"
    if "lo" in ev and "hi" in ev:
        try:
            row["first_off"] = int(ev["lo"])
            row["n"] = int(ev["hi"]) - int(ev["lo"])
        except (TypeError, ValueError):
            pass
    elif "first" in ev:
        try:
            row["first_off"] = int(ev["first"])
            if ev.get("n") is not None:
                row["n"] = int(ev["n"])
        except (TypeError, ValueError):
            pass
    return row


def _trace_norm_dlq(env: dict) -> dict:
    return {
        "t": env.get("t"),
        "pid": env.get("pid"),
        "kind": "dlq_envelope",
        "offset": env.get("offset"),
        "partition": env.get("partition"),
        "reason": env.get("reason"),
        "attempts": env.get("attempts"),
        "fingerprint": env.get("fingerprint"),
        "exception": env.get("exception"),
        "trace_id": env.get("trace_id"),
        "span_id": env.get("span_id"),
        "src": "dlq",
    }


def _trace_norm_span(ev: dict) -> Optional[dict]:
    """Chrome-trace span event → journey-row shape, ONLY when it
    carries a trace id (an uncorrelated span belongs in Perfetto, not
    here). Spans ride the monotonic clock, not unix time — they render
    in their own section, never interleaved by wall clock."""
    args = ev.get("args") or {}
    tid = args.get("trace_id")
    if not tid:
        return None
    row = {
        "t": None,  # monotonic clock: not comparable to unix rows
        "mono_us": ev.get("ts"),
        "dur_us": ev.get("dur"),
        "pid": ev.get("pid"),
        "kind": f"span:{ev.get('name')}",
        "trace_id": tid,
        "span_id": args.get("span_id"),
        "src": "span",
    }
    for k in ("first_off", "n", "offset"):
        if args.get(k) is not None:
            row[k] = args[k]
    return row


def _trace_rows_from_dir(directory: str) -> List[Dict[str, Any]]:
    """Recursively scan a dump directory for every durable journey
    fragment: journey-store segments (``journeys-*.jsonl``), flight
    dumps (``flight-*.jsonl``), DLQ segments (``dlq-*.jsonl``), and
    span files (``spans-*.trace.json``). Torn/garbage lines skip (the
    shared tolerant reader, ``obs.trace.iter_jsonl``)."""
    from flink_jpmml_tpu_torch.obs.trace import iter_jsonl as _jsonl

    rows: List[Dict[str, Any]] = []
    for root, _dirs, names in os.walk(directory):
        for nm in sorted(names):
            path = os.path.join(root, nm)
            if nm.startswith("journeys-") and nm.endswith(".jsonl"):
                for obj in _jsonl(path):
                    obj.setdefault("src", "journey")
                    rows.append(obj)
            elif nm.startswith("flight-") and nm.endswith(".jsonl"):
                for obj in _jsonl(path):
                    norm = _trace_norm_flight(obj)
                    if norm is not None:
                        rows.append(norm)
            elif nm.startswith("dlq-") and nm.endswith(".jsonl"):
                for obj in _jsonl(path):
                    rows.append(_trace_norm_dlq(obj))
            elif nm.startswith("spans-") and nm.endswith(".trace.json"):
                for obj in _jsonl(path):
                    norm = _trace_norm_span(obj)
                    if norm is not None:
                        rows.append(norm)
    return rows


def _trace_load(source: str) -> List[Dict[str, Any]]:
    """→ normalized journey rows from a dump directory, a live
    ``/trace`` endpoint, or a BENCH artifact's embedded ``journeys``."""
    if source.startswith(("http://", "https://")):
        import urllib.error
        import urllib.request

        url = source.rstrip("/")
        if not url.endswith("/trace"):
            url += "/trace"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                payload = json.loads(r.read().decode())
        except (urllib.error.URLError, OSError,
                json.JSONDecodeError) as e:
            raise SystemExit(f"cannot read {url!r}: {e}")
        rows = []
        for obj in payload.get("journeys") or []:
            if isinstance(obj, dict):
                obj.setdefault("src", "journey")
                rows.append(obj)
        for ev in payload.get("flight") or []:
            if isinstance(ev, dict):
                norm = _trace_norm_flight(ev)
                if norm is not None:
                    rows.append(norm)
        for ev in payload.get("spans") or []:
            if isinstance(ev, dict):
                norm = _trace_norm_span(ev)
                if norm is not None:
                    rows.append(norm)
        return rows
    if os.path.isdir(source):
        return _trace_rows_from_dir(source)
    try:
        with open(source, encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"cannot read {source!r}: {e}")
    if not isinstance(payload, dict):
        raise SystemExit(f"{source!r} is not a JSON object")
    if isinstance(payload.get("parsed"), dict):
        payload = payload["parsed"]  # a bench capture's {"parsed": ...} wrap
    rows = payload.get("journeys")
    if rows is None:
        for v in payload.values():  # one nested level (drill sub-line)
            if isinstance(v, dict) and isinstance(v.get("journeys"), list):
                rows = v["journeys"]
                break
    if not isinstance(rows, list):
        raise SystemExit(
            f"no journey rows in {source!r} (need a dump dir, a /trace "
            "URL, or an artifact with an embedded 'journeys' list)"
        )
    out = []
    for obj in rows:
        if isinstance(obj, dict):
            obj.setdefault("src", "journey")
            out.append(obj)
    return out


def _trace_row_covers(row: dict, offset: int) -> bool:
    if row.get("offset") is not None:
        try:
            if int(row["offset"]) == offset:
                return True
        except (TypeError, ValueError):
            pass
    fo = row.get("first_off")
    if fo is not None:
        try:
            fo = int(fo)
            n = int(row.get("n") or 1)
            return fo <= offset < fo + n
        except (TypeError, ValueError):
            return False
    return False


def _trace_select(
    rows: List[dict],
    trace_id: Optional[str] = None,
    offset: Optional[int] = None,
) -> List[dict]:
    """The journey join: rows matching the selector directly, expanded
    one round through what the direct matches carry — an offset pulls
    in the trace ids of every batch that contained it (other
    incarnations' fragments), a trace id pulls in the per-record
    terminal hops (dlq/shed — minted under per-RECORD ids) whose
    offset falls inside its batches' ``(first_off, n)`` ranges, so the
    fjt-top exemplar pivot's timeline shows a quarantine that happened
    inside the slow batch."""
    direct = []
    id_ranges: List[tuple] = []  # (lo, hi) of rows matched BY trace id
    for r in rows:
        if trace_id is not None and r.get("trace_id") == trace_id:
            direct.append(r)
            fo, n = r.get("first_off"), r.get("n")
            if fo is not None:
                try:
                    id_ranges.append((int(fo), int(fo) + int(n or 1)))
                except (TypeError, ValueError):
                    pass
        elif offset is not None and _trace_row_covers(r, offset):
            direct.append(r)
    ids = {r["trace_id"] for r in direct if r.get("trace_id")}
    offsets = set()
    if offset is not None:
        offsets.add(offset)
    for r in direct:
        if r.get("offset") is not None:
            try:
                offsets.add(int(r["offset"]))
            except (TypeError, ValueError):
                pass
    direct_ids = {id(r) for r in direct}

    def _off_in_id_ranges(r: dict) -> bool:
        # only rows with an EXPLICIT per-record offset join through a
        # batch range (range∩range would let a fetch-run ingest row
        # matched by offset pull in every batch it ever fed)
        if not id_ranges or r.get("offset") is None:
            return False
        try:
            o = int(r["offset"])
        except (TypeError, ValueError):
            return False
        return any(lo <= o < hi for lo, hi in id_ranges)

    seen = set()
    out = []
    for r in rows:
        match = (
            id(r) in direct_ids
            or (r.get("trace_id") in ids)
            or any(_trace_row_covers(r, o) for o in offsets)
            or _off_in_id_ranges(r)
        )
        if not match:
            continue
        key = id(r)
        if key in seen:
            continue
        seen.add(key)
        out.append(r)
    return out


def _trace_render(rows: List[dict], out, title: str = "journey") -> None:
    timed = [r for r in rows if isinstance(r.get("t"), (int, float))]
    spans_ = [r for r in rows if r.get("src") == "span"]
    timed.sort(key=lambda r: r["t"])
    ids = sorted({
        str(r["trace_id"])[:12] for r in rows if r.get("trace_id")
    })
    print(f"== {title} · trace ids [{', '.join(ids) or '-'}] ==",
          file=out)
    if not timed:
        print("(no timeline rows matched)", file=out)
    t0 = timed[0]["t"] if timed else 0.0
    last_pid = None
    for r in timed:
        pid = r.get("pid")
        if last_pid is not None and pid is not None and pid != last_pid:
            print(
                f"-- incarnation boundary: pid {last_pid} → pid {pid} --",
                file=out,
            )
        if pid is not None:
            last_pid = pid
        where = ""
        if r.get("offset") is not None:
            where = f"offset={r['offset']}"
        elif r.get("first_off") is not None:
            n = r.get("n")
            where = (
                f"[{r['first_off']}..{int(r['first_off']) + int(n)})"
                if n is not None else f"@{r['first_off']}"
            )
        detail = "  ".join(
            f"{k}={r[k]}" for k in (
                "reason", "lane", "attempts", "restarts", "latency_s",
                "sampled", "stage", "seconds", "model", "error",
                "exception", "redriven",
            )
            if r.get(k) not in (None, False)
        )
        tid = str(r.get("trace_id") or "")[:8]
        sid = str(r.get("span_id") or "")[:8]
        par = str(r.get("parent_id") or "")[:8]
        link = f"{tid}/{sid}" + (f"<-{par}" if par else "")
        print(
            f"+{r['t'] - t0:9.3f}s  pid {pid or '?':>7}  "
            f"{r.get('kind', '?'):<18} {where:<18} {link:<28} {detail}",
            file=out,
        )
    if spans_:
        print("spans (monotonic clock, per pid — not wall-aligned):",
              file=out)
        spans_.sort(key=lambda r: (r.get("pid") or 0,
                                   r.get("mono_us") or 0))
        for r in spans_[:64]:
            dur = r.get("dur_us")
            print(
                f"  pid {r.get('pid') or '?':>7}  "
                f"{r.get('kind', '?'):<24} "
                f"dur {0.0 if dur is None else dur / 1000.0:9.3f} ms  "
                f"trace {str(r.get('trace_id'))[:8]}",
                file=out,
            )


def _trace_summary(rows: List[dict], out, limit: int) -> None:
    """No selector: one line per known journey, newest last."""
    by_id: Dict[str, List[dict]] = {}
    for r in rows:
        tid = r.get("trace_id")
        if tid:
            by_id.setdefault(str(tid), []).append(r)
    if not by_id:
        print("(no journeys found)", file=out)
        return
    items = sorted(
        by_id.items(),
        key=lambda kv: max(
            (r.get("t") or 0) for r in kv[1]
        ),
    )[-limit:]
    print(f"{'TRACE':<14}{'HOPS':>5}  {'KINDS':<40} OFFSETS", file=out)
    for tid, rs in items:
        kinds = sorted({r.get("kind", "?") for r in rs})
        offs = sorted({
            int(r["first_off"]) for r in rs
            if r.get("first_off") is not None
        } | {
            int(r["offset"]) for r in rs
            if r.get("offset") is not None
        })
        off_s = (
            f"{offs[0]}..{offs[-1]}" if len(offs) > 1
            else (str(offs[0]) if offs else "-")
        )
        print(
            f"{tid[:12]:<14}{len(rs):>5}  "
            f"{','.join(kinds)[:40]:<40} {off_s}",
            file=out,
        )
    print(
        f"{len(by_id)} journey(s); fjt-trace <source> --id <TRACE> or "
        "--grep offset=K for a timeline",
        file=out,
    )


def trace_main(argv: Optional[List[str]] = None) -> int:
    """``fjt-trace``: reconstruct causal record journeys (see module
    docstring) — no device needed, safe on any host."""
    ap = argparse.ArgumentParser(
        prog="fjt-trace",
        description="Reconstruct a record's causal journey from journey "
                    "rows, flight events, DLQ envelopes, and spans.",
    )
    ap.add_argument("source",
                    help="dump directory (journey store / checkpoint "
                         "dir — scanned recursively), obs-server base "
                         "URL (its /trace endpoint), or a BENCH "
                         "artifact with embedded journeys")
    ap.add_argument("--id", dest="trace_id", default=None,
                    help="render the journey with this trace id (the "
                         "id an fjt-top exemplar row shows)")
    ap.add_argument("--grep", default=None, metavar="KEY=VAL",
                    help="find journeys without knowing ids; supported: "
                         "offset=K (every fragment whose offset range "
                         "contains record K)")
    ap.add_argument("--slowest", type=int, default=None, metavar="N",
                    help="rank completed journeys by sink latency and "
                         "list the N slowest (with their trace ids)")
    ap.add_argument("--limit", type=int, default=32,
                    help="journeys shown in the no-selector summary "
                         "(default 32)")
    args = ap.parse_args(argv)

    rows = _trace_load(args.source)
    offset = None
    if args.grep is not None:
        key, _, val = args.grep.partition("=")
        if key.strip() != "offset" or not val.strip():
            raise SystemExit(
                f"unsupported --grep {args.grep!r} (supported: offset=K)"
            )
        try:
            offset = int(val)
        except ValueError:
            raise SystemExit(f"--grep offset wants an int, got {val!r}")

    if args.slowest is not None:
        sinks = [
            r for r in rows
            if r.get("kind") == "sink"
            and isinstance(r.get("latency_s"), (int, float))
        ]
        sinks.sort(key=lambda r: -float(r["latency_s"]))
        if not sinks:
            print("(no completed journeys with latencies)",
                  file=sys.stdout)
            return 0
        print(f"{'LATENCY':>11}  {'TRACE':<14}{'RANGE':<18}PID",
              file=sys.stdout)
        for r in sinks[: args.slowest]:
            fo, n = r.get("first_off"), r.get("n")
            rng = (
                f"[{fo}..{int(fo) + int(n)})"
                if fo is not None and n is not None else "-"
            )
            print(
                f"{1000.0 * float(r['latency_s']):9.3f}ms  "
                f"{str(r.get('trace_id'))[:12]:<14}{rng:<18}"
                f"{r.get('pid', '?')}",
                file=sys.stdout,
            )
        print("pivot: fjt-trace <source> --id <TRACE>", file=sys.stdout)
        return 0

    if args.trace_id is None and offset is None:
        _trace_summary(rows, sys.stdout, max(1, args.limit))
        return 0

    sel = _trace_select(rows, trace_id=args.trace_id, offset=offset)
    if not sel:
        raise SystemExit(
            "no fragments matched "
            + (f"trace id {args.trace_id!r}" if args.trace_id
               else f"offset {offset}")
        )
    title = (
        f"offset {offset}" if offset is not None
        else f"id {str(args.trace_id)[:12]}"
    )
    _trace_render(sel, sys.stdout, title=title)
    return 0


def _dlq_open(directory: str):
    """Accept either the DLQ directory itself or the checkpoint
    directory it sits beside (``<ckpt>/dlq`` — the pipelines' default
    layout)."""
    import glob as _glob

    from flink_jpmml_tpu_torch.runtime.dlq import DeadLetterQueue

    d = directory
    if not _glob.glob(os.path.join(d, "dlq-*.jsonl")):
        nested = os.path.join(d, "dlq")
        if _glob.glob(os.path.join(nested, "dlq-*.jsonl")):
            d = nested
        elif not os.path.isdir(d) and os.path.isdir(nested):
            d = nested
    if not os.path.isdir(d):
        raise SystemExit(f"no DLQ at {directory!r}")
    return DeadLetterQueue(d)


def _dlq_payload_preview(env: dict) -> str:
    from flink_jpmml_tpu_torch.runtime.dlq import payload_bytes

    raw = payload_bytes(env)
    head = raw[:64]
    lines = [f"payload: {len(raw)} bytes, hex {head.hex()}"
             + ("…" if len(raw) > 64 else "")]
    try:
        lines.append(f"as text: {raw.decode('utf-8')!r}")
    except UnicodeDecodeError:
        pass
    if len(raw) % 4 == 0 and raw:
        import numpy as _np

        vals = _np.frombuffer(raw, _np.float32)
        if vals.size <= 64:
            lines.append(f"as f32 row: {vals.tolist()}")
    return "\n".join(lines)


def dlq_main(argv: Optional[List[str]] = None) -> int:
    """``fjt-dlq``: inspect and redrive the dead-letter queue
    (runtime/dlq.py) from the shell — no device needed, safe on any host.

        fjt-dlq list /data/ckpt              # table of quarantined records
        fjt-dlq inspect /data/ckpt --offset 1374
        fjt-dlq redrive /data/ckpt --host b1 --port 9092 --topic records

    ``redrive`` produces the quarantined payload bytes back INTO the
    topic (Kafka Produce), so a corrected pipeline re-scores them
    through the live consume path — the quarantine lifecycle's exit.
    Envelopes stay in place after a redrive (the DLQ is an append-only
    audit trail); re-running redrive re-produces them."""
    ap = argparse.ArgumentParser(
        prog="fjt-dlq",
        description="List, inspect, and redrive dead-letter records.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    ap_list = sub.add_parser("list", help="one line per envelope")
    ap_list.add_argument("dir")
    ap_list.add_argument("--limit", type=int, default=64,
                         help="newest N envelopes (default 64; 0 = all)")
    ap_ins = sub.add_parser("inspect", help="full envelope + payload")
    ap_ins.add_argument("dir")
    g = ap_ins.add_mutually_exclusive_group(required=True)
    g.add_argument("--offset", type=int, default=None)
    g.add_argument("--index", type=int, default=None,
                   help="0-based position in scan order")
    ap_re = sub.add_parser(
        "redrive",
        help="produce quarantined payloads back into a Kafka topic",
    )
    ap_re.add_argument("dir")
    ap_re.add_argument("--host", required=True)
    ap_re.add_argument("--port", type=int, required=True)
    ap_re.add_argument("--topic", required=True)
    ap_re.add_argument("--partition", type=int, default=None,
                       help="target partition (default: the envelope's "
                            "own, else 0)")
    ap_re.add_argument("--offset", type=int, action="append",
                       default=None,
                       help="redrive only these quarantined offsets "
                            "(repeatable; default: every envelope)")
    ap_re.add_argument("--reason", default=None,
                       help="redrive only envelopes with this reason "
                            "(score / decode / crash_loop)")
    args = ap.parse_args(argv)

    q = _dlq_open(args.dir)
    envs = list(q.scan())

    if args.cmd == "list":
        if not envs:
            print(f"DLQ empty at {q.directory}", file=sys.stderr)
            return 0
        shown = envs if args.limit <= 0 else envs[-args.limit:]
        print(f"{'OFFSET':>10} {'PART':>4} {'REASON':<10} {'ATT':>3} "
              f"{'FINGERPRINT':<16} EXCEPTION")
        for e in shown:
            exc = (e.get("exception") or "-").splitlines()[0]
            part = e.get("partition")
            print(f"{e.get('offset', '?'):>10} "
                  f"{'-' if part is None else part:>4} "
                  f"{e.get('reason', '?'):<10} "
                  f"{e.get('attempts', 1):>3} "
                  f"{e.get('fingerprint', '?'):<16} {exc[:80]}")
        print(f"{len(envs)} envelope(s) in {q.directory}",
              file=sys.stderr)
        return 0

    if args.cmd == "inspect":
        if args.index is not None:
            if not (0 <= args.index < len(envs)):
                raise SystemExit(
                    f"index {args.index} out of range (have {len(envs)})"
                )
            picked = [envs[args.index]]
        else:
            picked = [
                e for e in envs if e.get("offset") == args.offset
            ]
            if not picked:
                raise SystemExit(
                    f"no envelope with offset {args.offset}"
                )
        for e in picked:
            print(json.dumps(e, indent=2, sort_keys=True))
            print(_dlq_payload_preview(e))
        return 0

    # redrive
    from flink_jpmml_tpu_torch.runtime.dlq import payload_bytes
    from flink_jpmml_tpu_torch.runtime.kafka import (
        KafkaClient, KafkaProtocolError,
    )

    picked = envs
    if args.offset is not None:
        want = set(args.offset)
        picked = [e for e in picked if e.get("offset") in want]
    if args.reason is not None:
        picked = [e for e in picked if e.get("reason") == args.reason]
    # one produce per envelope at most once per fingerprint: replays
    # across restarts can leave duplicate envelopes for the same record
    seen: set = set()
    unique = []
    for e in picked:
        key = (e.get("fingerprint"), e.get("offset"))
        if key in seen:
            continue
        seen.add(key)
        unique.append(e)
    if not unique:
        raise SystemExit("nothing to redrive (filters matched nothing)")
    client = KafkaClient(args.host, args.port, client_id="fjt-dlq")
    count = 0
    try:
        for e in unique:
            part = args.partition
            if part is None:
                part = e.get("partition")
            if part is None:
                part = 0
            # journey continuity (obs/trace.py): the envelope carries
            # the quarantined record's trace context — stamp it back
            # into the topic as a traceparent record header, so the
            # redriven record's ingest opens a CHILD span of the
            # original journey instead of starting an unlinked one
            headers = None
            tid, sid = e.get("trace_id"), e.get("span_id")
            if tid and sid:
                from flink_jpmml_tpu_torch.obs.trace import TraceContext

                tp = TraceContext(str(tid), str(sid)).to_traceparent()
                headers = [[("traceparent", tp.encode("ascii"))]]
            try:
                base = client.produce(
                    args.topic, int(part), [payload_bytes(e)],
                    headers=headers,
                )
            except (OSError, ConnectionError, KafkaProtocolError) as ex:
                raise SystemExit(
                    f"redrive failed at offset {e.get('offset')}: {ex} "
                    f"({count} redriven before the failure)"
                )
            count += 1
            print(
                f"redrove offset {e.get('offset')} "
                f"({e.get('reason')}, {e.get('fingerprint')}) -> "
                f"{args.topic}[{part}]@{base}"
            )
    finally:
        client.close()
    print(f"{count} record(s) redriven", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(score_main())
