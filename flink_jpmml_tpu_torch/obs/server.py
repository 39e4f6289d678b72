"""HTTP exposition endpoint: /metrics, /healthz, /varz.

The port's copy of ``flink_jpmml_tpu/obs/server.py`` (stdlib HTTP over
the port's metrics structs, no device code), with the import lines
renamed; the text format, the routes and the status codes are the JAX
module's. ``/healthz`` composes the drift monitor's ``health_fn``
(``obs/drift.py``) through ``health_fn=``, as the JAX server does.

The scrape surface for a running pipeline or a whole supervised fleet,
on stdlib ``http.server`` only (no external metrics framework — the
same discipline as utils/netio.py's hand-rolled framing):

- ``/metrics`` — Prometheus text format 0.0.4, or OpenMetrics when the
  scraper's Accept header negotiates it (exemplar suffixes on histogram
  buckets + ``# EOF`` ride only the OpenMetrics form — the classic
  format doesn't admit them). Counters and gauges map 1:1;
  :class:`~flink_jpmml_tpu_torch.utils.metrics.Histogram` maps to the
  native Prometheus histogram series (cumulative ``_bucket{le=...}`` +
  ``_sum`` + ``_count``), so PromQL's ``histogram_quantile`` over a
  fleet computes the SAME answer as the in-process bucket merge.
- ``/healthz`` — liveness JSON ({"ok": true} + whatever the health
  callback adds); HTTP 503 when the callback says not-ok.
- ``/varz`` — the raw JSON snapshot(s), the same struct format the
  heartbeats piggyback and bench artifacts embed.
- ``/trace`` — the record-journey payload (obs/trace.py): this
  process's durable journey rows, its live flight-ring events, and the
  active span file — what ``fjt-trace <url>`` reconstructs timelines
  from.
- ``/history`` — the telemetry-history range query (obs/history.py):
  durable downsampled delta frames, selected by
  ``?name=<fnmatch,..>&start=<ts>&end=<ts>&step=<s>&source=<src,..>``
  — what ``fjt-replay <url>`` renders past windows from.

Sources are pluggable: a single registry
(:meth:`ObsServer.for_registry`) or a callable returning
``{label_value_or_None: registry_or_struct}`` — the supervisor serves
``{None: merged fleet, worker_id: per-worker}`` so the aggregate rides
unlabeled and per-worker series carry ``worker="..."``.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Mapping, Optional, Union

from flink_jpmml_tpu_torch.utils.metrics import (
    Histogram,
    MetricsRegistry,
    govern_struct,
)

_PREFIX = "fjt_"
_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
# a registry name may embed prometheus-style labels: kafka_lag{partition="0"}
_LABELLED = re.compile(r'^([^{]+)\{(.*)\}$')


def _struct(source: Union[MetricsRegistry, dict]) -> dict:
    # the cardinality governor bounds every scrape page the same way
    # it bounds heartbeat and history frames (FJT_METRICS_MAX_SERIES
    # unset: identity) — at zoo scale a /metrics or /varz page must
    # not grow one series per registered tenant
    if isinstance(source, MetricsRegistry):
        return govern_struct(source.struct_snapshot())
    return govern_struct(source or {})


def _fmt(v: float) -> str:
    return format(float(v), ".10g")


def _series_name(raw: str, extra: Dict[str, str]):
    """registry name → (prometheus name, label string incl. braces)."""
    m = _LABELLED.match(raw)
    base, inline = (m.group(1), m.group(2)) if m else (raw, "")
    name = _PREFIX + _NAME_OK.sub("_", base)
    parts = [inline] if inline else []
    parts += [f'{k}="{v}"' for k, v in extra.items()]
    return name, ("{" + ",".join(parts) + "}") if parts else ""


def prometheus_text(
    sources: Mapping[Optional[str], Union[MetricsRegistry, dict]],
    label: str = "worker",
    openmetrics: bool = False,
) -> str:
    """Render registries/structs as Prometheus text exposition.

    ``sources`` keys become ``label`` values; the ``None`` (or ``""``)
    key renders unlabeled — the aggregate series a fleet scrape reads.
    ``# TYPE`` lines are emitted once per metric name across all
    sources, as the format requires.

    Default is the classic text format 0.0.4 — which does NOT admit
    exemplars, so none are rendered (a stock scraper would reject the
    whole page). ``openmetrics=True`` (the server sets it when the
    scraper's Accept header negotiates ``application/openmetrics-text``
    — modern Prometheus does by default) emits OpenMetrics instead:
    exemplar suffixes on histogram ``_bucket`` lines and a terminating
    ``# EOF``. Counters are declared ``unknown`` there — OpenMetrics
    requires a ``_total`` sample-name suffix on counter families, and
    keeping the SAME series names across both formats matters more to
    dashboards than the type annotation (PromQL doesn't consult it)."""
    typed: Dict[str, str] = {}  # prom name -> type line emitted
    blocks: Dict[str, list] = {}  # prom name -> series lines

    def _add(name: str, mtype: str, lines) -> None:
        if name not in typed:
            typed[name] = f"# TYPE {name} {mtype}\n"
            blocks[name] = []
        blocks[name].extend(lines)

    counter_type = "unknown" if openmetrics else "counter"
    for key in sorted(sources, key=lambda k: (k is not None, k or "")):
        extra = {} if key in (None, "") else {label: str(key)}
        s = _struct(sources[key])
        for raw, v in sorted(s.get("counters", {}).items()):
            name, lab = _series_name(raw, extra)
            _add(name, counter_type, [f"{name}{lab} {_fmt(v)}\n"])
        for raw, g in sorted(s.get("gauges", {}).items()):
            name, lab = _series_name(raw, extra)
            _add(name, "gauge", [f"{name}{lab} {_fmt(g['value'])}\n"])
            _add(
                name + "_max", "gauge",
                [f"{name}_max{lab} {_fmt(g['max'])}\n"],
            )
        for raw, hstate in sorted(s.get("histograms", {}).items()):
            name, lab = _series_name(raw, extra)
            h = Histogram.from_state(hstate)
            inner = lab[1:-1] if lab else ""
            lines = []
            acc = 0
            counts = h._counts  # snapshot-local object: no racing writers
            exemplars = h.exemplars()

            def _bucket_line(le: str, acc: int, idx: int) -> str:
                line = f"{name}_bucket{{{le}}} {acc}"
                ex = exemplars.get(idx) if openmetrics else None
                if ex is not None:
                    # OpenMetrics exemplar syntax: the trace id links a
                    # scraped tail bucket straight to its
                    # flight-recorder `latency_exemplar` event
                    line += (
                        f' # {{trace_id="{ex[0]}"}} '
                        f"{_fmt(ex[1])} {_fmt(ex[2])}"
                    )
                return line + "\n"

            for i, edge in enumerate(h.edges):
                acc += counts[i]
                le = ",".join(x for x in (inner, f'le="{_fmt(edge)}"') if x)
                lines.append(_bucket_line(le, acc, i))
            acc += counts[-1]
            le = ",".join(x for x in (inner, 'le="+Inf"') if x)
            lines.append(_bucket_line(le, acc, len(h.edges)))
            lines.append(f"{name}_sum{lab} {_fmt(h.sum())}\n")
            lines.append(f"{name}_count{lab} {acc}\n")
            _add(name, "histogram", lines)
        up = s.get("uptime_s")
        if up is not None:
            name, lab = _series_name("uptime_s", extra)
            _add(name, "gauge", [f"{name}{lab} {_fmt(up)}\n"])

    out = []
    for name in sorted(typed):
        out.append(typed[name])
        out.extend(blocks[name])
    if openmetrics:
        out.append("# EOF\n")
    return "".join(out)


CollectFn = Callable[[], Mapping[Optional[str], Union[MetricsRegistry, dict]]]


class ObsServer:
    """Threaded stdlib HTTP server exposing /metrics, /healthz, /varz.

    ``collect()`` is called per scrape; ``health_fn()`` returns a JSON
    dict whose falsy ``"ok"`` turns /healthz into a 503; ``varz_fn()``
    (optional) overrides the default /varz payload (the collected
    structs)."""

    def __init__(
        self,
        collect: CollectFn,
        host: str = "127.0.0.1",
        port: int = 0,
        health_fn: Optional[Callable[[], dict]] = None,
        varz_fn: Optional[Callable[[], dict]] = None,
        trace_fn: Optional[Callable[[], dict]] = None,
        history_fn: Optional[Callable[[dict], dict]] = None,
    ):
        self._collect = collect
        self._health = health_fn
        self._varz = varz_fn
        # /trace: the record-journey payload (obs/trace.py) — durable
        # journey rows + the live flight ring + the active span file,
        # so `fjt-trace <url>` reconstructs without filesystem access.
        # Default: this process's journey store, when one is armed.
        self._trace = trace_fn
        # /history: the telemetry-history range query (obs/history.py)
        # — called with the parsed query string (name/start/end/step/
        # source), returns durable downsampled frames. Default: this
        # process's history directory, when one is armed.
        self._history = history_fn
        obs = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: scrapes are periodic
                pass

            def _reply(self, code: int, body: str, ctype: str) -> None:
                raw = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self) -> None:
                path, _, qs = self.path.partition("?")
                try:
                    if path == "/metrics":
                        om = "application/openmetrics-text" in (
                            self.headers.get("Accept") or ""
                        )
                        self._reply(
                            200,
                            prometheus_text(
                                obs._collect(), openmetrics=om
                            ),
                            "application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8"
                            if om else
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        h = {"ok": True}
                        if obs._health is not None:
                            h.update(obs._health())
                        self._reply(
                            200 if h.get("ok") else 503,
                            json.dumps(h),
                            "application/json",
                        )
                    elif path == "/varz":
                        if obs._varz is not None:
                            payload = obs._varz()
                        else:
                            payload = {
                                (k if k is not None else ""): _struct(v)
                                for k, v in obs._collect().items()
                            }
                        self._reply(
                            200,
                            json.dumps(payload, default=repr),
                            "application/json",
                        )
                    elif path == "/history":
                        from urllib.parse import parse_qs

                        params = parse_qs(qs)
                        if obs._history is not None:
                            payload = obs._history(params)
                        else:
                            from flink_jpmml_tpu_torch.obs import (
                                history as hm,
                            )

                            payload = hm.history_payload(None, params)
                        self._reply(
                            200,
                            json.dumps(payload, default=repr),
                            "application/json",
                        )
                    elif path == "/trace":
                        if obs._trace is not None:
                            payload = obs._trace()
                        else:
                            from flink_jpmml_tpu_torch.obs import trace as tm

                            payload = tm.trace_payload()
                        self._reply(
                            200,
                            json.dumps(payload, default=repr),
                            "application/json",
                        )
                    else:
                        self._reply(404, "not found\n", "text/plain")
                except Exception as e:  # a scrape must never kill serving
                    try:
                        self._reply(500, f"{e!r}\n", "text/plain")
                    except OSError:
                        pass

        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="fjt-obs-http", daemon=True
        )
        self._thread.start()

    @classmethod
    def for_registry(cls, metrics: MetricsRegistry, **kw) -> "ObsServer":
        if "trace_fn" not in kw:
            from flink_jpmml_tpu_torch.obs import trace as tm

            kw["trace_fn"] = lambda: tm.trace_payload(metrics)
        if "history_fn" not in kw:
            from flink_jpmml_tpu_torch.obs import history as hm

            # exposing metrics is the natural arming point for history
            # too: with FJT_HISTORY_DIR set, the recorder starts with
            # the server (idempotent per registry)
            hm.history_for(metrics)
            kw["history_fn"] = (
                lambda params: hm.history_payload(metrics, params)
            )
        return cls(lambda: {None: metrics}, **kw)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5.0)
