"""Chrome trace-event export: span trees + recorder events, one file.

Renders the :class:`~bigdl_tpu_torch.observability.tracing.Tracer`'s span
trees (completed roots AND still-open stacks) and the
:class:`~bigdl_tpu_torch.observability.events.FlightRecorder`'s event tail
into the Chrome trace-event JSON format, loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``:

- every span becomes a complete ("X") duration event on its thread's
  track (children nest visually because their intervals nest);
  still-open spans render with their duration-so-far and
  ``args.open = true`` — exactly what a crash investigation needs.
- every recorder event becomes a thread-scoped instant ("i") event;
  its request id and attrs land in ``args``, so searching a request id
  in the Perfetto query bar lights up that request's whole timeline
  across engine, queue, and micro-batcher tracks.

Timestamps are wall-clock microseconds (the format's unit): spans
carry their own wall start; recorder events map through the
recorder's monotonic→wall anchor. Both sources therefore land on ONE
coherent timeline in the viewer.

Quick start::

    from bigdl_tpu_torch import observability as obs

    obs.write_chrome_trace("trace.json")     # default tracer+recorder
    # or serve it: GET /debug/trace on a MetricsHTTPServer
"""

from __future__ import annotations

import json
import time
from typing import List, Optional

from bigdl_tpu_torch.observability.events import (
    FlightRecorder, _atomic_write, default_recorder,
)
from bigdl_tpu_torch.observability.tracing import Span, Tracer, trace


class _Tids:
    """Stable small integer track ids per thread name (tid 0 is
    reserved so the viewer never merges a track with the process
    row)."""

    def __init__(self):
        self._map = {}

    def __call__(self, thread_name: str) -> int:
        tid = self._map.get(thread_name)
        if tid is None:
            tid = self._map[thread_name] = len(self._map) + 1
        return tid

    def items(self):
        return self._map.items()


def _span_events(sp: Span, tids: _Tids, pid: int, now_wall: float,
                 out: List[dict]) -> None:
    dur = sp.duration
    args = {}
    if dur is None:
        # still open: duration so far (durations are measured on
        # perf_counter but rendered on the wall axis; the skew over a
        # span's lifetime is negligible at trace resolution)
        dur = max(0.0, now_wall - sp.start)
        args["open"] = True
    out.append({
        "name": sp.name, "cat": "span", "ph": "X",
        "ts": sp.start * 1e6, "dur": dur * 1e6,
        "pid": pid, "tid": tids(sp.thread), "args": args,
    })
    for c in sp.children:
        _span_events(c, tids, pid, now_wall, out)


def chrome_trace_events(tracer: Optional[Tracer] = None,
                        recorder: Optional[FlightRecorder] = None,
                        last_events: Optional[int] = None,
                        process_name: str = "bigdl_tpu_torch") -> List[dict]:
    """The combined trace-event list (no enclosing JSON object):
    metadata rows naming the process and each thread track, one "X"
    event per span (completed roots, then open stacks), one "i" event
    per retained recorder event."""
    import os

    tracer = tracer if tracer is not None else trace
    recorder = recorder if recorder is not None else default_recorder()
    pid = os.getpid()
    tids = _Tids()
    now_wall = time.time()
    out: List[dict] = []

    for root in tracer.roots():
        _span_events(root, tids, pid, now_wall, out)
    for root in tracer.open_spans():
        _span_events(root, tids, pid, now_wall, out)

    off = recorder.wall_offset
    for ev in recorder.tail(last_events):
        args = {"seq": ev.seq}
        if ev.request_id is not None:
            args["request_id"] = ev.request_id
        if ev.attrs:
            args.update(ev.attrs)
        out.append({
            "name": ev.kind, "cat": "event", "ph": "i", "s": "t",
            "ts": (ev.ts + off) * 1e6,
            "pid": pid, "tid": tids(ev.thread), "args": args,
        })

    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": process_name}}]
    for thread_name, tid in tids.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": thread_name}})
    return meta + out


def render_chrome_trace(tracer: Optional[Tracer] = None,
                        recorder: Optional[FlightRecorder] = None,
                        last_events: Optional[int] = None) -> str:
    """The full trace as a JSON string (object form, with
    ``traceEvents``) — what ``/debug/trace`` serves and
    ``write_chrome_trace`` saves."""
    return json.dumps({
        "traceEvents": chrome_trace_events(tracer, recorder,
                                           last_events),
        "displayTimeUnit": "ms",
    })


def write_chrome_trace(path: str, tracer: Optional[Tracer] = None,
                       recorder: Optional[FlightRecorder] = None,
                       last_events: Optional[int] = None) -> str:
    """Atomically write the trace JSON to ``path``; returns the text.
    Open the file in Perfetto or ``chrome://tracing``."""
    text = render_chrome_trace(tracer, recorder, last_events)
    _atomic_write(path, text)
    return text
