"""Exporters: Prometheus text rendering, a stdlib /metrics HTTP endpoint,
and a bridge mirroring registry metrics into TensorBoard writers (port
of ``bigdl_tpu/observability/exporters.py``).

Three sinks over one source (the MetricRegistry):

- ``render_prometheus(registry)`` — the text exposition format
  (``text/plain; version=0.0.4``) any Prometheus-compatible scraper
  ingests; ``render_snapshot_prometheus`` renders plain-data registry
  snapshots shipped from fleet workers under a ``replica=`` label.
- ``MetricsHTTPServer`` / ``start_http_server`` — a stdlib-only
  ``ThreadingHTTPServer`` serving ``/metrics`` + ``/healthz`` plus the
  flight-recorder debug routes (``/debug/events``, ``/debug/requests``,
  ``/debug/trace`` — Chrome trace download); attach it to a serving
  process and point the scraper at it. No dependencies.
- ``TensorBoardBridge`` — mirrors counters/gauges (and histogram
  sum/count) into anything with ``add_scalar(tag, value, step)``
  (``bigdl_tpu_torch.visualization``'s TrainSummary / FileWriter), so
  training dashboards and
  the scrape endpoint present the same numbers.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional

from bigdl_tpu_torch.observability.metrics import (
    MetricRegistry, default_registry,
)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(kv) -> str:
    if not kv:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in kv)
    return "{" + inner + "}"


def render_prometheus(registry: Optional[MetricRegistry] = None) -> str:
    """The registry in Prometheus text exposition format. Histograms
    render cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``
    per the exposition contract."""
    registry = registry or default_registry()
    out = []
    for m in registry.collect():
        out.append(f"# HELP {m.name} {_escape_help(m.help)}")
        out.append(f"# TYPE {m.name} {m.type}")
        for values, child in m.children():
            kv = list(zip(m.labelnames, values))
            if m.type in ("counter", "gauge"):
                out.append(f"{m.name}{_labels_str(kv)} "
                           f"{_fmt(child.get())}")
            else:  # histogram
                cum, total_sum, count = child.get()
                edges = [_fmt(b) for b in m.buckets] + ["+Inf"]
                for edge, c in zip(edges, cum):
                    le = _labels_str(kv + [("le", edge)])
                    out.append(f"{m.name}_bucket{le} {c}")
                out.append(f"{m.name}_sum{_labels_str(kv)} "
                           f"{_fmt(total_sum)}")
                out.append(f"{m.name}_count{_labels_str(kv)} {count}")
    return "\n".join(out) + ("\n" if out else "")


def render_snapshot_prometheus(snapshots: dict,
                               label: str = "replica") -> str:
    """Render plain-data registry snapshots (``registry_snapshot()``
    dumps shipped across a process boundary — the fleet workers'
    ``metrics_export`` RPC) as Prometheus text, with ``label`` (the
    replica id) injected into every series so one scrape of the front
    door's ``/metrics`` carries the whole fleet, per-replica
    attributable. ``snapshots`` maps label value -> snapshot list;
    HELP/TYPE headers are emitted once per metric name."""
    by_name: dict = {}
    for lv, snap in snapshots.items():
        for m in snap or []:
            ent = by_name.setdefault(
                m["name"], {"type": m.get("type", "gauge"),
                            "help": m.get("help", ""), "rows": []})
            for row in m.get("series") or []:
                ent["rows"].append((lv, row))
    out = []
    for name in sorted(by_name):
        ent = by_name[name]
        out.append(f"# HELP {name} {_escape_help(ent['help'])}")
        out.append(f"# TYPE {name} {ent['type']}")
        for lv, row in ent["rows"]:
            kv = [(label, lv)] + sorted(
                (row.get("labels") or {}).items())
            if ent["type"] in ("counter", "gauge"):
                out.append(f"{name}{_labels_str(kv)} "
                           f"{_fmt(row.get('value', 0))}")
            else:  # histogram snapshot: cumulative buckets + sum/count
                for le, c in (row.get("buckets") or {}).items():
                    out.append(f"{name}_bucket"
                               f"{_labels_str(kv + [('le', le)])} {c}")
                out.append(f"{name}_sum{_labels_str(kv)} "
                           f"{_fmt(row.get('sum', 0.0))}")
                out.append(f"{name}_count{_labels_str(kv)} "
                           f"{row.get('count', 0)}")
    return "\n".join(out) + ("\n" if out else "")


def write_prometheus(path: str,
                     registry: Optional[MetricRegistry] = None) -> str:
    """Atomically dump the registry snapshot as Prometheus text to
    ``path`` (write to a unique temp file, then rename; a reader never
    sees a torn file even under concurrent writers). Returns the
    rendered text."""
    import os
    import tempfile

    text = render_prometheus(registry)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".",
        prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return text


# ------------------------------------------------------------- HTTP server
class MetricsHTTPServer:
    """Stdlib-only scrape + debug endpoint. ``GET /metrics`` returns
    the Prometheus text snapshot; ``GET /healthz`` returns 200 with a
    JSON body (or 503 when the ``healthz`` callable returns
    falsy/raises). ``port=0`` binds an ephemeral port — read it back
    from ``.port``.

    Six debug routes expose the flight recorder, the resource layer,
    and the usage ledger:

    - ``GET /debug/events[?n=256]`` — the recorder's newest events as
      JSON (``{"events": [...], "total": N}``).
    - ``GET /debug/requests`` — whatever ``debug_requests()`` returns;
      wire ``ContinuousBatchingEngine.debug_requests`` here for
      in-flight request states + recent per-request timeline
      breakdowns (queue wait / prefill / TTFT / decode percentiles).
    - ``GET /debug/trace`` — the Chrome trace-event JSON of the span
      trees + recorder events (open it in Perfetto or
      ``chrome://tracing``).
    - ``GET /debug/memory`` — the device-memory picture: per-device
      HBM bytes in use / peak / limit / headroom plus per-pool byte
      attribution and the high-watermark history
      (``memory.DeviceMemoryMonitor.debug_memory``; defaults to the
      process-default monitor).
    - ``GET /debug/usage[?n=10]`` — per-tenant usage attribution:
      wire ``ContinuousBatchingEngine.debug_usage`` here for the
      tenant table (tokens, queue seconds, device-seconds, KV
      byte-seconds, prefix savings), the engine goodput block, and
      the top-``n`` requests by attributed device-seconds. The
      callable receives the top-N count.
    - ``GET /debug/incidents[?n=10]`` — the newest captured incident
      bundles (anomaly/watchdog/chaos triggers with their evidence);
      wire ``ContinuousBatchingEngine.debug_incidents`` here. The
      callable receives the bundle count.
    - ``GET/POST /debug/profile?seconds=N`` — one bounded on-demand
      ``torch.profiler`` capture (CUDA kernels of every thread on a
      card); responds with the artifact directory (501 when the
      profiler cannot start, 409 while another capture is in flight).
    - ``GET /debug/timeseries[?metric=&n=]`` — the engine's background
      sampler rings (MFU, tokens/s, slot occupancy, queue depth,
      acceptance rate, alerts) as JSON; wire
      ``ContinuousBatchingEngine.debug_timeseries`` here.
    - ``GET /debug/dashboard`` — one self-contained HTML page (inline
      SVG sparklines, zero external assets) over the same rings plus
      the live roofline and loop-phase blocks; wire
      ``ContinuousBatchingEngine.dashboard`` here.
    - ``GET /debug/capacity`` — the capacity/what-if estimate plus
      the SLO error-budget ledger; wire
      ``ContinuousBatchingEngine.debug_capacity`` here.

    ``recorder``/``tracer`` default to the process defaults, resolved
    per request (a swapped default redirects the endpoints too)."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 host: str = "0.0.0.0", port: int = 0,
                 healthz: Optional[Callable[[], object]] = None,
                 recorder=None, tracer=None,
                 debug_requests: Optional[Callable[[], dict]] = None,
                 debug_memory: Optional[Callable[[], dict]] = None,
                 debug_usage: Optional[Callable[[int], dict]] = None,
                 profiler: Optional[Callable[[float], str]] = None,
                 debug_timeseries=None,
                 dashboard: Optional[Callable[[], str]] = None,
                 debug_incidents=None,
                 debug_capacity: Optional[Callable[[], dict]] = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from bigdl_tpu_torch.observability import events as _events

        get_registry = (lambda: registry) if registry is not None \
            else default_registry
        get_recorder = (lambda: recorder) if recorder is not None \
            else _events.default_recorder

        def get_tracer():
            if tracer is not None:
                return tracer
            from bigdl_tpu_torch.observability.tracing import trace
            return trace

        def run_profile(query: str):
            """Shared GET/POST body of ``/debug/profile``: one bounded
            capture, returning (payload, status)."""
            from urllib.parse import parse_qs

            from bigdl_tpu_torch.observability import profiler as _profiler

            import math

            try:
                seconds = float(parse_qs(query).get("seconds",
                                                    ["1.0"])[0])
            except ValueError:
                return {"error": "seconds must be a number"}, 400
            if not math.isfinite(seconds) or seconds <= 0:
                return {"error": "seconds must be a finite value > 0"
                        }, 400
            seconds = min(seconds, _profiler.MAX_SECONDS)
            try:
                fn = profiler or _profiler.capture
                path = fn(seconds)
                return {"artifact": path, "seconds": seconds}, 200
            except _profiler.ProfilerUnavailable as e:
                return {"error": str(e)}, 501
            except _profiler.ProfilerBusy as e:
                return {"error": str(e)}, 409
            except Exception as e:
                return {"error": str(e)}, 500

        def run_debug_memory():
            if debug_memory is not None:
                return debug_memory()
            from bigdl_tpu_torch.observability.memory import default_monitor
            return default_monitor().debug_memory()

        class Handler(BaseHTTPRequestHandler):
            def _send_json(self, payload, status: int = 200,
                           download: Optional[str] = None):
                body = payload if isinstance(payload, bytes) \
                    else json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                if download:
                    self.send_header(
                        "Content-Disposition",
                        f'attachment; filename="{download}"')
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_html(self, text: str, status: int = 200):
                body = text.encode()
                self.send_response(status)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib handler contract)
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    body = render_prometheus(get_registry()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     PROMETHEUS_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/debug/events":
                    try:
                        from urllib.parse import parse_qs
                        n = int(parse_qs(query).get("n", ["256"])[0])
                        rec = get_recorder()
                        self._send_json({"events": rec.snapshot(n),
                                         "total": rec.total,
                                         "capacity": rec.capacity})
                    except Exception as e:
                        self._send_json({"error": str(e)}, status=500)
                elif path == "/debug/requests":
                    try:
                        if debug_requests is None:
                            self._send_json(
                                {"in_flight": [], "recent": [],
                                 "note": "no request source attached "
                                         "(pass debug_requests=)"})
                        else:
                            self._send_json(debug_requests())
                    except Exception as e:
                        self._send_json({"error": str(e)}, status=500)
                elif path == "/debug/trace":
                    try:
                        from bigdl_tpu_torch.observability.chrometrace import (
                            render_chrome_trace,
                        )
                        self._send_json(
                            render_chrome_trace(
                                get_tracer(), get_recorder()).encode(),
                            download="bdt_trace.json")
                    except Exception as e:
                        self._send_json({"error": str(e)}, status=500)
                elif path == "/debug/memory":
                    try:
                        self._send_json(run_debug_memory())
                    except Exception as e:
                        self._send_json({"error": str(e)}, status=500)
                elif path == "/debug/usage":
                    try:
                        if debug_usage is None:
                            self._send_json(
                                {"tenants": {}, "top_requests": [],
                                 "note": "no usage source attached "
                                         "(pass debug_usage=)"})
                        else:
                            from urllib.parse import parse_qs
                            n = int(parse_qs(query).get("n", ["10"])[0])
                            self._send_json(debug_usage(n))
                    except Exception as e:
                        self._send_json({"error": str(e)}, status=500)
                elif path == "/debug/incidents":
                    try:
                        if debug_incidents is None:
                            self._send_json(
                                {"incidents": [],
                                 "note": "no incident source attached "
                                         "(pass debug_incidents=)"})
                        else:
                            from urllib.parse import parse_qs
                            n = int(parse_qs(query).get("n", ["10"])[0])
                            self._send_json(debug_incidents(n))
                    except Exception as e:
                        self._send_json({"error": str(e)}, status=500)
                elif path == "/debug/profile":
                    payload, status = run_profile(query)
                    self._send_json(payload, status=status)
                elif path == "/debug/capacity":
                    try:
                        if debug_capacity is None:
                            self._send_json(
                                {"capacity": {"ready": False},
                                 "note": "no capacity source attached "
                                         "(pass debug_capacity=)"})
                        else:
                            self._send_json(debug_capacity())
                    except Exception as e:
                        self._send_json({"error": str(e)}, status=500)
                elif path == "/debug/timeseries":
                    try:
                        if debug_timeseries is None:
                            self._send_json(
                                {"metrics": {},
                                 "note": "no timeseries source attached "
                                         "(pass debug_timeseries=)"})
                        else:
                            from urllib.parse import parse_qs
                            q = parse_qs(query)
                            metric = q.get("metric", [None])[0]
                            n_raw = q.get("n", [None])[0]
                            n = int(n_raw) if n_raw is not None else None
                            self._send_json(
                                debug_timeseries(metric=metric, n=n))
                    except Exception as e:
                        self._send_json({"error": str(e)}, status=500)
                elif path == "/debug/dashboard":
                    try:
                        if dashboard is None:
                            self._send_html(
                                "<!doctype html><html><body><p>no "
                                "dashboard source attached (pass "
                                "dashboard=)</p></body></html>")
                        else:
                            self._send_html(dashboard())
                    except Exception as e:
                        self._send_html(
                            "<!doctype html><html><body><pre>dashboard "
                            "error: %s</pre></body></html>"
                            % str(e), status=500)
                elif path == "/healthz":
                    status, payload = 200, {"status": "ok"}
                    if healthz is not None:
                        try:
                            detail = healthz()
                            if not detail:
                                status = 503
                                payload = {"status": "unhealthy"}
                            elif isinstance(detail, dict):
                                payload.update(detail)
                        except Exception as e:
                            status = 503
                            payload = {"status": "unhealthy",
                                       "error": str(e)}
                    body = json.dumps(payload).encode()
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):  # noqa: N802 (stdlib handler contract)
                path, _, query = self.path.partition("?")
                if path == "/debug/profile":
                    payload, status = run_profile(query)
                    self._send_json(payload, status=status)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *args):  # silence per-scrape stderr spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="bdt-metrics-http",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_http_server(port: int = 0,
                      registry: Optional[MetricRegistry] = None,
                      host: str = "0.0.0.0",
                      healthz: Optional[Callable[[], object]] = None,
                      recorder=None, tracer=None,
                      debug_requests: Optional[Callable[[], dict]] = None,
                      debug_memory: Optional[Callable[[], dict]] = None,
                      debug_usage: Optional[Callable[[int], dict]] = None,
                      profiler: Optional[Callable[[float], str]] = None,
                      debug_timeseries=None,
                      dashboard: Optional[Callable[[], str]] = None,
                      debug_incidents=None,
                      debug_capacity: Optional[Callable[[], dict]] = None
                      ) -> MetricsHTTPServer:
    """Convenience wrapper: start and return a MetricsHTTPServer."""
    return MetricsHTTPServer(registry=registry, host=host, port=port,
                             healthz=healthz, recorder=recorder,
                             tracer=tracer,
                             debug_requests=debug_requests,
                             debug_memory=debug_memory,
                             debug_usage=debug_usage,
                             profiler=profiler,
                             debug_timeseries=debug_timeseries,
                             dashboard=dashboard,
                             debug_incidents=debug_incidents,
                             debug_capacity=debug_capacity)


# -------------------------------------------------------- TensorBoard bridge
class TensorBoardBridge:
    """Mirror registry metrics into a TensorBoard writer.

    ``writer`` is anything exposing ``add_scalar(tag, value, step)`` —
    ``visualization.TrainSummary`` or a raw ``FileWriter``. Each
    ``publish(step)`` walks the registry: counters and gauges emit their
    value under ``name{label=value,...}``; histograms emit ``name_count``
    ``name_sum`` and ``name_mean`` (event files carry scalar series —
    the full bucket vector stays on the scrape endpoint)."""

    def __init__(self, writer,
                 registry: Optional[MetricRegistry] = None):
        self._writer = writer
        self._registry = registry

    def publish(self, step: int) -> "TensorBoardBridge":
        registry = self._registry or default_registry()
        for m in registry.collect():
            for values, child in m.children():
                tag = m.name + _labels_str(list(zip(m.labelnames, values)))
                if m.type in ("counter", "gauge"):
                    self._writer.add_scalar(tag, float(child.get()), step)
                else:
                    _, total_sum, count = child.get()
                    self._writer.add_scalar(f"{tag}_count", float(count),
                                            step)
                    self._writer.add_scalar(f"{tag}_sum", float(total_sum),
                                            step)
                    if count:
                        self._writer.add_scalar(f"{tag}_mean",
                                                total_sum / count, step)
        return self
