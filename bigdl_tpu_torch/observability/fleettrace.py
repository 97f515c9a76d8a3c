"""Fleet-wide distributed tracing: trace ids, clock alignment, and the
cross-process trace merge (port of
``bigdl_tpu/observability/fleettrace.py``).

A fleet request's life spans the front door, the router, a pipe-RPC
hop, and a spawn-worker replica — each process with its own flight
recorder and its own *monotonic clock*, which do NOT agree across
processes. This module is the glue that turns those per-process
recordings back into ONE coherent story:

- **Trace context** (``mint_trace_id`` / ``parse_traceparent``): the
  front door mints a W3C-style 32-hex ``trace_id`` per request
  (honoring an inbound ``traceparent`` header) and threads it through
  supervisor → replica RPC → ``engine.submit(trace_id=...)``, so every
  recorder event and usage record in the child carries it.
- **Clock alignment** (``estimate_clock_offset``): a ping-style
  min-RTT estimator over the worker RPC. The sample with the smallest
  round trip bounds the offset error by ``rtt/2`` — the classic
  NTP-without-NTP trick; the supervisor refreshes it periodically so
  drift never accumulates.
- **Trace merge** (``merge_fleet_trace`` / ``render_fleet_trace``):
  per-replica event exports (raw monotonic ``ts_s`` + the estimated
  ``clock_offset_s``) land as per-process tracks on the supervisor's
  timeline, as Chrome trace-event JSON loadable in Perfetto. Besides
  the raw instants, each request's per-process arc is rendered as
  derived "X" spans (request envelope + queue/prefill/decode phases),
  so spans from the front-door process and every worker line up with
  no negative cross-process gaps.
- **Hop decomposition** (``hop_breakdown``): one finished request's
  client-observed total split into
  ``route | rpc_submit | queue | prefill | first_token | decode |
  stream`` — the components sum to the total by construction (the
  IPC/delivery hops are the exact residuals), feeding the
  ``bdt_fleet_hop_seconds`` histograms.

The front door serves the merge live at ``GET /debug/fleet/trace``;
``write_fleet_trace`` writes it to a file.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

from bigdl_tpu_torch.observability.events import _atomic_write

__all__ = [
    "FLEET_HOPS", "estimate_clock_offset", "hop_breakdown",
    "merge_fleet_trace", "merge_request_timelines", "mint_trace_id",
    "parse_traceparent", "render_fleet_trace", "write_fleet_trace",
]

#: the seven fleet hops, in request order; ``hop_breakdown`` returns
#: exactly these keys and their values sum to the client-observed
#: total (the ``bdt_fleet_hop_seconds`` ``hop=`` label values)
FLEET_HOPS = ("route", "rpc_submit", "queue", "prefill",
              "first_token", "decode", "stream")

_TRACEPARENT = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


# --------------------------------------------------------- trace context
def mint_trace_id() -> str:
    """A fresh 32-hex trace id (the W3C trace-context shape)."""
    return os.urandom(16).hex()


def parse_traceparent(header: Optional[str]) -> Optional[str]:
    """The trace id from a W3C ``traceparent`` header
    (``00-<32 hex>-<16 hex>-<2 hex>``), or a bare 32-hex trace id;
    None when absent/malformed/all-zero (the caller mints instead —
    a bad inbound header must never kill the request)."""
    if not header:
        return None
    h = header.strip().lower()
    m = _TRACEPARENT.match(h)
    tid = m.group(2) if m else (h if re.fullmatch(r"[0-9a-f]{32}", h)
                                else None)
    if tid is None or tid == "0" * 32:
        return None
    return tid


# -------------------------------------------------------- clock alignment
def estimate_clock_offset(ping: Callable[[], float], samples: int = 8,
                          clock: Callable[[], float] = time.monotonic
                          ) -> Tuple[float, float]:
    """Estimate a remote process's monotonic-clock offset by pinging.

    ``ping()`` must return the REMOTE clock's reading (seconds); the
    local ``clock`` is read immediately before and after. Assuming the
    remote read happens mid-flight, ``offset = (t0 + t1)/2 - remote``
    maps remote onto local: ``remote_ts + offset ≈ local_ts`` for the
    same instant. The min-RTT sample wins — its offset error is
    bounded by ``rtt/2`` regardless of asymmetry, so a handful of
    pings through a busy pipe still yields a tight estimate.

    Returns ``(offset_s, rtt_s)`` of the best sample."""
    best_off: Optional[float] = None
    best_rtt: Optional[float] = None
    for _ in range(max(1, int(samples))):
        t0 = clock()
        remote = float(ping())
        t1 = clock()
        rtt = t1 - t0
        if best_rtt is None or rtt < best_rtt:
            best_rtt = rtt
            best_off = (t0 + t1) / 2.0 - remote
    return float(best_off), float(best_rtt)


# ------------------------------------------------------ hop decomposition
def hop_breakdown(timeline: dict, route_s: float, rpc_submit_s: float,
                  total_s: float,
                  ttft_s: Optional[float] = None) -> Dict[str, float]:
    """Split one finished fleet request's client-observed ``total_s``
    into the seven ``FLEET_HOPS``.

    ``timeline`` is the replica engine's own phase breakdown (worker
    handles add the parent-measured ``client_ttft_s``); ``route_s`` /
    ``rpc_submit_s`` are supervisor-measured (routing decision,
    replica ``submit()`` call). The two delivery hops are residuals:
    ``first_token`` is the client TTFT not explained by submit + queue
    + prefill (pipe/IPC delivery of the first token), ``stream`` is
    the total not explained by everything else (SSE writes + delivery
    of the remaining tokens). The engine phases are measured on the
    REPLICA's clock while ``total_s`` is the client's — on short
    requests their sum can exceed the client window by pipe/poll
    jitter, so when it does the engine phases are scaled
    proportionally into the remaining budget. Result: the hop sum
    reconciles with ``total_s`` by construction (exactly, whenever
    the client total covers its own measured parts) — the acceptance
    test bounds the reconciliation at 10%.
    """
    queue = float(timeline.get("queue_wait_s") or 0.0)
    prefill = float(timeline.get("prefill_s") or 0.0)
    decode = float(timeline.get("decode_s") or 0.0)
    if ttft_s is None:
        ttft_s = timeline.get("client_ttft_s")
    if ttft_s is None:
        # in-process replica: the engine clock IS the client clock,
        # so first-token delivery is instantaneous by definition
        ttft_s = rpc_submit_s + queue + prefill
    first = max(0.0, float(ttft_s) - rpc_submit_s - queue - prefill)
    budget = max(0.0, float(total_s) - route_s - rpc_submit_s - first)
    engine = queue + prefill + decode
    if engine > budget:
        # replica-clock phases overran the client window: fit them
        scale = (budget / engine) if engine > 0 else 0.0
        queue, prefill, decode = (queue * scale, prefill * scale,
                                  decode * scale)
        engine = budget
    stream = max(0.0, budget - engine)
    return {
        "route": float(route_s),
        "rpc_submit": float(rpc_submit_s),
        "queue": float(queue),
        "prefill": float(prefill),
        "first_token": first,
        "decode": float(decode),
        "stream": stream,
    }


# ----------------------------------------------------------- trace merge
#: lifecycle-kind suffix pairs the merge derives per-request phase
#: spans from (emitted only when both boundaries are present, in
#: order, within one process)
_PHASES = (
    ("queue", "request/submitted", "request/admitted"),
    ("prefill", "request/admitted", "request/first_token"),
    ("decode", "request/first_token", None),  # → the request's last event
)


def _aligned(ev: dict, offset_s: float) -> Optional[float]:
    ts = ev.get("ts_s")
    return None if ts is None else float(ts) + float(offset_s)


def merge_fleet_trace(exports: List[dict],
                      wall_offset: float = 0.0) -> List[dict]:
    """Merge per-process event exports into one Chrome trace-event
    list with per-process tracks and aligned timestamps.

    Each export is ``{"process": name, "events": [...],
    "clock_offset_s": s}`` — ``events`` are flight-recorder snapshot
    dicts carrying that process's RAW monotonic ``ts_s``;
    ``clock_offset_s`` maps them onto the reference (supervisor)
    monotonic timeline (0 for the reference process itself), and
    ``wall_offset`` then anchors the whole merged timeline on the
    wall clock (Chrome's microsecond axis). An export may pin its
    ``pid``; otherwise processes get stable synthetic pids in listing
    order.

    Output per process: a ``process_name`` metadata row, one thread
    track per recording thread, an "i" instant per event, and derived
    "X" spans per request — the request envelope (first → last event)
    plus queue/prefill/decode phase spans where the lifecycle kinds
    are present. Per-process event order is preserved under the
    per-export offset (one constant shift), so derived spans can
    never go negative — the merged-trace invariant the tests pin."""
    out: List[dict] = []
    used_pids: set = set()
    for i, ex in enumerate(exports):
        name = str(ex.get("process") or f"proc{i}")
        pid = ex.get("pid")
        if pid is None or pid in used_pids:
            pid = 1 + i
            while pid in used_pids:
                pid += 1
        used_pids.add(pid)
        off = float(ex.get("clock_offset_s") or 0.0) + float(wall_offset)
        events = ex.get("events") or []
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": name}})
        tids: Dict[str, int] = {}
        by_req: Dict[str, List[dict]] = {}
        for ev in events:
            ts = _aligned(ev, off)
            if ts is None:
                continue
            thread = str(ev.get("thread") or "main")
            tid = tids.get(thread)
            if tid is None:
                tid = tids[thread] = len(tids) + 1
                out.append({"name": "thread_name", "ph": "M",
                            "pid": pid, "tid": tid,
                            "args": {"name": thread}})
            args = {k: v for k, v in ev.items()
                    if k not in ("ts_s", "wall_s", "thread", "kind")}
            out.append({"name": str(ev.get("kind", "event")),
                        "cat": "event", "ph": "i", "s": "t",
                        "ts": ts * 1e6, "pid": pid, "tid": tid,
                        "args": args})
            rid = ev.get("request_id")
            if rid is not None:
                by_req.setdefault(str(rid), []).append(ev)
        # derived per-request spans: the envelope + lifecycle phases.
        # events arrive in recording order; a constant per-process
        # offset preserves it, so every duration here is >= 0.
        for rid, evs in by_req.items():
            first, last = _aligned(evs[0], off), _aligned(evs[-1], off)
            trace_id = next((e.get("trace") for e in evs
                             if e.get("trace") is not None), None)
            span_args = {"request_id": rid, "events": len(evs)}
            if trace_id is not None:
                span_args["trace"] = trace_id
            tid = tids.get(str(evs[0].get("thread") or "main"), 1)
            out.append({"name": f"req {rid}", "cat": "request",
                        "ph": "X", "ts": first * 1e6,
                        "dur": max(0.0, last - first) * 1e6,
                        "pid": pid, "tid": tid, "args": span_args})
            kinds = {e.get("kind"): _aligned(e, off) for e in evs}
            for phase, start_kind, end_kind in _PHASES:
                t0 = kinds.get(start_kind)
                t1 = kinds.get(end_kind) if end_kind else last
                if t0 is None or t1 is None or t1 < t0:
                    continue
                out.append({"name": f"{phase} {rid}", "cat": "phase",
                            "ph": "X", "ts": t0 * 1e6,
                            "dur": (t1 - t0) * 1e6, "pid": pid,
                            "tid": tid, "args": dict(span_args)})
    return out


def merge_request_timelines(exports: List[dict]) -> Dict[str, dict]:
    """Aggregate the exports per REQUEST instead of per process: for
    every request, which processes saw it, each process's aligned
    first/last timestamps and event-kind sequence, and the trace id
    joining them — the ``/debug/fleet/requests`` shape.

    Keyed by trace id when the event carries one (request ids are
    minted per engine, so two replicas both have a ``req-000001`` —
    only the trace id is fleet-unique), falling back to the request
    id for untraced requests."""
    reqs: Dict[str, dict] = {}
    for i, ex in enumerate(exports):
        name = str(ex.get("process") or f"proc{i}")
        off = float(ex.get("clock_offset_s") or 0.0)
        for ev in ex.get("events") or []:
            rid = ev.get("request_id")
            ts = _aligned(ev, off)
            if rid is None or ts is None:
                continue
            attrs = ev.get("attrs") or {}
            trace = ev.get("trace") or attrs.get("trace")
            r = reqs.setdefault(str(trace or rid),
                                {"request_id": str(rid),
                                 "trace_id": None,
                                 "processes": {}})
            if r["trace_id"] is None and trace is not None:
                r["trace_id"] = trace
            p = r["processes"].setdefault(
                name, {"first_ts_s": ts, "last_ts_s": ts, "events": 0,
                       "kinds": []})
            p["first_ts_s"] = min(p["first_ts_s"], ts)
            p["last_ts_s"] = max(p["last_ts_s"], ts)
            p["events"] += 1
            p["kinds"].append(ev.get("kind"))
    return reqs


def render_fleet_trace(exports: List[dict],
                       wall_offset: float = 0.0) -> str:
    """The merged fleet trace as Chrome trace JSON (object form) —
    what ``GET /debug/fleet/trace`` serves; open it in Perfetto."""
    return json.dumps({
        "traceEvents": merge_fleet_trace(exports, wall_offset),
        "displayTimeUnit": "ms",
    })


def write_fleet_trace(path: str, exports: List[dict],
                      wall_offset: float = 0.0) -> str:
    """Atomically write the merged trace JSON to ``path``; returns
    the text."""
    text = render_fleet_trace(exports, wall_offset)
    _atomic_write(path, text)
    return text
