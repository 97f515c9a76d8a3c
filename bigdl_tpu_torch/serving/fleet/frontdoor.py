"""The fleet's HTTP front door: streaming inference over stdlib HTTP (port
of ``bigdl_tpu/serving/fleet/frontdoor.py``).

One ``ThreadingHTTPServer`` (the ``MetricsHTTPServer`` idiom — no
framework, no dependencies) in front of a ``ReplicaSupervisor``:

- ``POST /v1/generate`` — body ``{"prompt_ids": [...],
  "max_new_tokens": N, "tenant": ..., "priority": "high|normal|low",
  "stream": true}``. The streaming default answers with Server-Sent
  Events driven directly by the replica handle's token iterator — one
  held connection, tokens flowing one way as the engine decodes
  (never a per-token request/response):

  ``event: meta``  — ``{request_id, replica, route, trace_id}``
  (where the router placed it, first thing on the wire);
  ``data:`` lines — ``{"token": t, "index": i}`` per decoded token;
  ``event: done`` — the terminal summary (token count, timeline).

  A client that disappears mid-stream is detected by the failed
  socket write and the request is CANCELLED into the engine — the
  slot frees immediately instead of decoding tokens nobody will read
  (``bdt_fleet_client_disconnects_total``) — including while the
  request is still QUEUED (the socket is probed until the first
  token, so a vanished client frees its queue slot too).
  ``"stream": false`` returns one JSON body after completion.
  Backpressure maps to HTTP: ``QueueFull`` -> 429,
  ``RequestShed``/``RequestRateLimited`` -> 429 with a
  ``Retry-After`` header derived from the engine's token-bucket
  refill time, fleet down -> 503, bad request -> 400.
- ``GET /v1/stats`` — the supervisor's fleet-wide aggregate: per-
  replica ``stats()``, the fleet prefix hit rate, the routing table.
- ``GET /v1/replicas`` — just the routing table (the ``serve.py
  --fleet`` demo's table source).
- ``GET /healthz`` — 200 with the fleet health dict; 503 once no
  replica can take traffic (same crashed-loop convention as the
  engine endpoint).
- ``GET /metrics`` — Prometheus text, ``bdt_fleet_*`` included,
  PLUS every worker child's registry fetched over pipe RPC and
  rendered with a ``replica="<rid>"`` label — one scrape, whole
  fleet.

Fleet tracing: every request gets a ``trace_id`` — an inbound W3C
``traceparent`` header is honored, otherwise one is minted — which
rides the pipe RPC into the replica so every recorder event and
usage record fleet-wide carries it. Responses echo ``X-Trace-Id`` /
``X-Request-Id``; the ``meta`` SSE event and the JSON body carry
``trace_id`` too. Finished requests are decomposed into
``bdt_fleet_hop_seconds`` histogram observations
(route / rpc_submit / queue / prefill / first_token / decode /
stream) whose per-request sum reconciles with the client-observed
total. Two debug endpoints expose the merged view:

- ``GET /debug/fleet/trace`` — ONE Chrome/Perfetto trace merging the
  front door's and every worker process's recorder events onto a
  clock-aligned common timeline (per-process tracks).
- ``GET /debug/fleet/requests`` — the recent-request ring (hop
  breakdowns) plus per-request cross-process timelines.
- ``GET /debug/fleet/incidents[?n=]`` — every replica's incident
  bundles (``IncidentManager`` captures, fetched over the
  ``incident_export`` RPC) stamped with ``replica=``, fleet-wide
  counts by kind, per-replica detector states, and the trace ids the
  exemplars reference — each resolvable in the merged fleet trace.
- ``GET /debug/fleet/timeseries[?metric=&n=]`` — every replica's
  sampler rings (the ``timeseries_export`` RPC) merged onto the
  supervisor's clock-aligned timeline, keyed ``metric -> replica ->
  ring``, with fleet-sum/mean derived series.
- ``GET /debug/fleet/dashboard`` — one self-contained HTML page over
  the merged timeline: per-metric rows with per-replica SVG
  overlays, incident/drain markers, and SLO error-budget bars.
- ``GET /debug/fleet/capacity[?offered=]`` — the fleet capacity /
  what-if aggregate (sustainable rates, headroom, replicas-needed
  for the observed or an explicit offered load) plus each replica's
  error-budget ledger.
"""

from __future__ import annotations

import json
import math
import select
import socket
import threading
import time
from typing import Optional
from urllib.parse import parse_qs

from bigdl_tpu_torch.observability.exporters import (
    PROMETHEUS_CONTENT_TYPE, render_prometheus,
    render_snapshot_prometheus,
)
from bigdl_tpu_torch.observability.fleettrace import (
    hop_breakdown, mint_trace_id, parse_traceparent,
    render_fleet_trace,
)
from bigdl_tpu_torch.observability.metrics import default_registry
from bigdl_tpu_torch.serving.fleet.router import NoLiveReplicas
from bigdl_tpu_torch.serving.streams import (
    EngineDraining, EngineStopped, QueueFull, RequestCancelled,
    RequestRateLimited, RequestShed, RequestTimedOut,
)

__all__ = ["FleetFrontDoor", "start_front_door"]

_MAX_BODY = 8 << 20  # refuse absurd request bodies before parsing


class FleetFrontDoor:
    """Serve a ``ReplicaSupervisor`` over HTTP. ``port=0`` binds an
    ephemeral port — read it back from ``.port``. Context manager;
    ``close()`` stops the listener (the supervisor's lifecycle stays
    the caller's)."""

    def __init__(self, supervisor, host: str = "127.0.0.1",
                 port: int = 0, registry=None):
        from http.server import (
            BaseHTTPRequestHandler, ThreadingHTTPServer,
        )

        sup = supervisor
        ins = sup._ins
        get_registry = (lambda: registry) if registry is not None \
            else default_registry

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send_json(self, payload, status: int = 200,
                           headers: Optional[dict] = None):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
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

            def _send_429(self, e) -> None:
                # structured shed / rate-limit rejection: Retry-After
                # comes from the engine's token-bucket refill math (or
                # the shed backoff), rounded UP to the header's whole
                # seconds — never 0, which clients read as "retry now"
                retry = max(1, math.ceil(
                    getattr(e, "retry_after_s", 1.0)))
                self._send_json(
                    {"error": str(e),
                     "kind": type(e).__name__,
                     "retry_after_s": getattr(e, "retry_after_s",
                                              1.0)},
                    429, headers={"Retry-After": str(retry)})

            def _client_gone(self) -> bool:
                # a disconnected client shows up as a readable socket
                # whose peek returns EOF — the only portable way to
                # see a hangup while we are WAITING (not writing)
                try:
                    r, _, _ = select.select([self.connection], [], [],
                                            0)
                    if not r:
                        return False
                    return self.connection.recv(
                        1, socket.MSG_PEEK) == b""
                except OSError:
                    return True

            # ------------------------------------------------ streaming
            def _sse(self, event: Optional[str], payload: dict) -> None:
                chunk = b""
                if event:
                    chunk += b"event: " + event.encode() + b"\n"
                chunk += b"data: " + json.dumps(payload).encode() \
                    + b"\n\n"
                self.wfile.write(chunk)
                self.wfile.flush()

            def _generate(self, req: dict) -> None:
                prompt = req.get("prompt_ids")
                if not isinstance(prompt, list) or not prompt \
                        or not all(isinstance(t, int) for t in prompt):
                    return self._send_json(
                        {"error": "prompt_ids must be a non-empty "
                                  "list of ints"}, 400)
                try:
                    n = int(req.get("max_new_tokens", 32))
                except (TypeError, ValueError):
                    return self._send_json(
                        {"error": "max_new_tokens must be an int"}, 400)
                stream = bool(req.get("stream", True))
                # trace context: honor an inbound W3C ``traceparent``
                # (or bare 32-hex id) so the fleet joins the caller's
                # distributed trace; mint fresh otherwise. The id rides
                # the pipe RPC into the replica and back out in the
                # merged fleet trace.
                trace_id = parse_traceparent(
                    self.headers.get("traceparent")) or mint_trace_id()
                t_start = time.monotonic()
                try:
                    routed = sup.submit(
                        prompt, n, tenant=req.get("tenant"),
                        priority=req.get("priority", "normal"),
                        timeout_s=req.get("timeout_s"),
                        trace_id=trace_id)
                except (RequestShed, RequestRateLimited) as e:
                    return self._send_429(e)
                except QueueFull as e:
                    return self._send_json(
                        {"error": f"fleet saturated: {e}"}, 429)
                except (NoLiveReplicas, EngineStopped,
                        EngineDraining) as e:
                    return self._send_json(
                        {"error": f"fleet unavailable: {e}"}, 503)
                except ValueError as e:
                    return self._send_json({"error": str(e)}, 400)
                h = routed.handle
                meta = {"request_id": getattr(h, "request_id", None),
                        "replica": routed.replica,
                        "route": routed.route,
                        "trace_id": trace_id}
                if not stream:
                    return self._collect(routed, meta, t_start)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Trace-Id", trace_id)
                if meta["request_id"] is not None:
                    self.send_header("X-Request-Id",
                                     str(meta["request_id"]))
                # SSE is an unbounded stream: no Content-Length; close
                # delimits the body
                self.send_header("Connection", "close")
                self.end_headers()
                delivered = 0
                try:
                    self._sse("meta", meta)
                    # queued-phase disconnect watch: until the first
                    # token, no socket write happens — a vanished
                    # client would hold its queue slot until admission.
                    # Probe the connection while the request waits and
                    # cancel into the engine the moment the peer hangs
                    # up, freeing the slot for live traffic.
                    while (getattr(h, "first_token_at", None) is None
                           and not h.done()):
                        if self._client_gone():
                            h.cancel()
                            ins.disconnects_total.inc()
                            return
                        time.sleep(0.02)
                    for tok in h.tokens():
                        self._sse(None, {"token": int(tok),
                                         "index": delivered})
                        delivered += 1
                    total_s = time.monotonic() - t_start
                    hops = self._note_hops(routed, total_s)
                    self._sse("done", {**meta, "tokens": delivered,
                                       "timeline": h.timeline(),
                                       "hops": hops,
                                       "total_s": total_s})
                except (BrokenPipeError, ConnectionResetError,
                        OSError):
                    # the client vanished mid-stream: cancel into the
                    # engine so the slot frees NOW instead of decoding
                    # to an audience of zero
                    h.cancel()
                    ins.disconnects_total.inc()
                except RequestCancelled:
                    try:
                        self._sse("error", {**meta,
                                            "error": "cancelled",
                                            "tokens": delivered})
                    except OSError:
                        pass
                except (RequestTimedOut, EngineStopped, EngineDraining,
                        RequestShed, RequestRateLimited) as e:
                    # a refusal the replica could only give after its
                    # submit returned (a worker whose process died, or
                    # a bucket that empties later) ends the stream with
                    # its terminal event, retry advice included
                    payload = {**meta, "error": type(e).__name__,
                               "detail": str(e), "tokens": delivered}
                    if isinstance(e, (RequestShed,
                                      RequestRateLimited)):
                        payload["retry_after_s"] = e.retry_after_s
                    try:
                        self._sse("error", payload)
                    except OSError:
                        pass

            def _note_hops(self, routed, total_s: float):
                """Decompose the client-observed total into fleet hops
                and feed the supervisor's ``bdt_fleet_hop_seconds``
                histograms + request ring. Best-effort: a hop record
                must never fail a request that already finished."""
                try:
                    h = routed.handle
                    tl = h.timeline() if hasattr(h, "timeline") else {}
                    hops = hop_breakdown(tl or {}, routed.route_s,
                                         routed.rpc_submit_s, total_s)
                    sup.note_request(routed, hops, total_s)
                    return hops
                except Exception:
                    return None

            def _collect(self, routed, meta: dict,
                         t_start: float) -> None:
                h = routed.handle
                hdrs = {"X-Trace-Id": meta["trace_id"]}
                if meta["request_id"] is not None:
                    hdrs["X-Request-Id"] = str(meta["request_id"])
                try:
                    toks = h.result(timeout=None) \
                        if hasattr(h, "result") else list(h.tokens())
                    toks = [int(t) for t in toks]
                except (RequestShed, RequestRateLimited) as e:
                    return self._send_429(e)
                except RequestCancelled:
                    return self._send_json(
                        {**meta, "error": "cancelled"}, 499,
                        headers=hdrs)
                except RequestTimedOut as e:
                    return self._send_json(
                        {**meta, "error": "timeout",
                         "detail": str(e)}, 504, headers=hdrs)
                except EngineStopped as e:
                    return self._send_json(
                        {**meta, "error": "engine stopped",
                         "detail": str(e)}, 503, headers=hdrs)
                total_s = time.monotonic() - t_start
                hops = self._note_hops(routed, total_s)
                # in-process handles' result() includes the prompt —
                # normalize to generated-only via the timeline count
                tl = h.timeline() if hasattr(h, "timeline") else {}
                gen = tl.get("tokens")
                if gen is not None and len(toks) > gen:
                    toks = toks[-gen:]
                self._send_json({**meta, "tokens": toks,
                                 "timeline": tl, "hops": hops,
                                 "total_s": total_s}, headers=hdrs)

            # ------------------------------------------------- requests
            def do_POST(self):  # noqa: N802 (stdlib handler contract)
                path = self.path.partition("?")[0]
                if path != "/v1/generate":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if not 0 < length <= _MAX_BODY:
                        return self._send_json(
                            {"error": "missing or oversized body"}, 400)
                    req = json.loads(self.rfile.read(length))
                    if not isinstance(req, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    return self._send_json(
                        {"error": f"bad request body: {e}"}, 400)
                self._generate(req)

            def do_GET(self):  # noqa: N802 (stdlib handler contract)
                path = self.path.partition("?")[0]
                if path == "/v1/stats":
                    try:
                        self._send_json(sup.stats())
                    except Exception as e:
                        self._send_json({"error": str(e)}, 500)
                elif path == "/v1/replicas":
                    self._send_json(sup.routing_table())
                elif path == "/healthz":
                    try:
                        self._send_json(sup.healthz())
                    except Exception as e:
                        self._send_json(
                            {"status": "unhealthy", "error": str(e)},
                            503)
                elif path == "/debug/fleet/trace":
                    # ONE merged Chrome/Perfetto trace for the whole
                    # fleet: front-door events plus every worker
                    # replica's recorder export, timestamps aligned by
                    # the supervisor's clock-offset estimates
                    try:
                        body = render_fleet_trace(
                            sup.trace_exports(),
                            wall_offset=sup.wall_offset).encode()
                    except Exception as e:
                        return self._send_json({"error": str(e)}, 500)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/debug/fleet/requests":
                    try:
                        self._send_json(sup.fleet_requests())
                    except Exception as e:
                        self._send_json({"error": str(e)}, 500)
                elif path == "/debug/fleet/incidents":
                    # every replica's incident bundles stamped with
                    # replica=, fleet counts by kind, and the trace
                    # ids the exemplars reference (each resolvable in
                    # /debug/fleet/requests' merged timelines)
                    try:
                        query = self.path.partition("?")[2]
                        n_raw = parse_qs(query).get("n", ["10"])[0]
                        self._send_json(
                            sup.fleet_incidents(int(n_raw)))
                    except Exception as e:
                        self._send_json({"error": str(e)}, 500)
                elif path == "/debug/fleet/timeseries":
                    # every replica's sampler rings merged onto the
                    # supervisor's clock (points shifted by each
                    # replica's ping-estimated offset)
                    try:
                        q = parse_qs(self.path.partition("?")[2])
                        metric = q.get("metric", [None])[0]
                        n_raw = q.get("n", [None])[0]
                        n = int(n_raw) if n_raw is not None else None
                        self._send_json(
                            sup.fleet_timeseries(metric=metric, n=n))
                    except Exception as e:
                        self._send_json({"error": str(e)}, 500)
                elif path == "/debug/fleet/dashboard":
                    try:
                        self._send_html(sup.fleet_dashboard())
                    except Exception as e:
                        self._send_html(
                            "<!doctype html><html><body><pre>fleet "
                            "dashboard error: %s</pre></body></html>"
                            % str(e), status=500)
                elif path == "/debug/fleet/capacity":
                    try:
                        q = parse_qs(self.path.partition("?")[2])
                        offered = q.get("offered", [None])[0]
                        self._send_json(sup.fleet_capacity(
                            offered_rps=(float(offered)
                                         if offered is not None
                                         else None)))
                    except Exception as e:
                        self._send_json({"error": str(e)}, 500)
                elif path == "/metrics":
                    text = render_prometheus(get_registry())
                    try:
                        # replica-labeled aggregation: each worker
                        # child's registry, fetched over pipe RPC and
                        # rendered with a replica="<rid>" label so one
                        # scrape sees the whole fleet
                        snaps = sup.metrics_snapshots()
                        if snaps:
                            text += "\n" + render_snapshot_prometheus(
                                snaps, label="replica")
                    except Exception:
                        # graftlint: ok[resource-hygiene] — child metrics are best-effort; the parent text still serves
                        pass
                    body = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     PROMETHEUS_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *args):  # silence request spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-front-door",
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


def start_front_door(supervisor, host: str = "127.0.0.1",
                     port: int = 0, registry=None) -> FleetFrontDoor:
    """Convenience wrapper: start and return a ``FleetFrontDoor``."""
    return FleetFrontDoor(supervisor, host=host, port=port,
                          registry=registry)
