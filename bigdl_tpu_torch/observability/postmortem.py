"""Crash postmortems: one JSON artifact holding everything a 3am
debugger needs.

When the continuous-batching engine's loop thread dies, aggregate
metrics freeze and the process may be seconds from restarting — the
state that explains the crash is about to vanish. ``build_postmortem``
gathers it into one dict and ``write_postmortem`` lands it atomically
on disk:

- the **error** (type, message, traceback),
- the flight recorder's last-N **events** (what happened, in order,
  right up to the crash),
- every thread's still-**open span** tree (what was mid-flight),
- a structured **metrics snapshot** of the registry,
- the caller's **in-flight request states** (the engine passes each
  queued / prefilling / decoding request's id, phase, and progress).

``scripts/dump_postmortem.py`` pretty-prints the file;
``ContinuousBatchingEngine`` writes one automatically from ``_crash``
(path: ``postmortem_path=`` arg, else ``$BIGDL_POSTMORTEM_PATH``,
else ``bigdl_postmortem.json`` in the working directory).
"""

from __future__ import annotations

import datetime
import json
import time
import traceback as _tb
from typing import List, Optional

from bigdl_tpu_torch.observability.events import (
    FlightRecorder, _atomic_write, default_recorder,
)
from bigdl_tpu_torch.observability.metrics import (
    MetricRegistry, default_registry,
)
from bigdl_tpu_torch.observability.tracing import Tracer, trace

#: bump when the artifact layout changes (readers check this first)
POSTMORTEM_SCHEMA = "bigdl_postmortem/1"


def registry_snapshot(registry: Optional[MetricRegistry] = None
                      ) -> List[dict]:
    """The registry as plain data: one entry per metric, one series
    row per label tuple (counters/gauges carry ``value``; histograms
    ``sum``/``count`` plus cumulative ``buckets``)."""
    registry = registry or default_registry()
    out = []
    for m in registry.collect():
        series = []
        for values, child in m.children():
            row: dict = {"labels": dict(zip(m.labelnames, values))}
            if m.type in ("counter", "gauge"):
                row["value"] = child.get()
            else:
                cum, total_sum, count = child.get()
                row["sum"] = total_sum
                row["count"] = count
                row["buckets"] = {
                    str(le): c for le, c in
                    zip(list(m.buckets) + ["+Inf"], cum)}
            series.append(row)
        out.append({"name": m.name, "type": m.type, "help": m.help,
                    "series": series})
    return out


def _error_dict(error: Optional[BaseException]) -> Optional[dict]:
    if error is None:
        return None
    return {
        "type": type(error).__name__,
        "message": str(error),
        "traceback": "".join(_tb.format_exception(
            type(error), error, error.__traceback__)),
        "cause": repr(error.__cause__) if error.__cause__ else None,
    }


def build_postmortem(error: Optional[BaseException] = None,
                     requests: Optional[List[dict]] = None,
                     recorder: Optional[FlightRecorder] = None,
                     tracer: Optional[Tracer] = None,
                     registry: Optional[MetricRegistry] = None,
                     last_events: int = 512,
                     window_s: Optional[float] = None,
                     context: Optional[dict] = None) -> dict:
    """Assemble the postmortem dict (see module docstring for the
    payload). Every section degrades independently — a reader always
    gets whatever could be captured. The events slice goes through
    the recorder's ``window_snapshot`` — the same evidence path the
    incident manager uses — bounded to ``window_s`` seconds when
    given, always capped at ``last_events``."""
    recorder = recorder if recorder is not None else default_recorder()
    tracer = tracer if tracer is not None else trace
    pm = {
        "schema": POSTMORTEM_SCHEMA,
        "written_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="milliseconds"),
        "error": _error_dict(error),
        "context": context or {},
        "requests": requests or [],
    }
    try:
        now = time.monotonic()
        t0 = now - window_s if window_s is not None else float("-inf")
        pm["events"] = recorder.window_snapshot(
            t0, now, limit=last_events)
        pm["events_dropped"] = max(
            0, recorder.total - len(recorder))
    except Exception as e:  # a torn recorder must not kill the artifact
        pm["events"] = []
        pm["events_error"] = repr(e)
    try:
        pm["open_spans"] = [
            {"thread": sp.thread, "name": sp.name,
             "started_wall_s": sp.start, "tree": sp.tree()}
            for sp in tracer.open_spans()]
    except Exception as e:
        pm["open_spans"] = []
        pm["open_spans_error"] = repr(e)
    try:
        pm["metrics"] = registry_snapshot(registry)
    except Exception as e:
        pm["metrics"] = []
        pm["metrics_error"] = repr(e)
    return pm


def write_postmortem(path: str, error: Optional[BaseException] = None,
                     requests: Optional[List[dict]] = None,
                     recorder: Optional[FlightRecorder] = None,
                     tracer: Optional[Tracer] = None,
                     registry: Optional[MetricRegistry] = None,
                     last_events: int = 512,
                     window_s: Optional[float] = None,
                     context: Optional[dict] = None) -> dict:
    """Build and atomically write the postmortem JSON to ``path``;
    returns the dict. Pretty-print it later with
    ``python scripts/dump_postmortem.py <path>``."""
    pm = build_postmortem(error=error, requests=requests,
                          recorder=recorder, tracer=tracer,
                          registry=registry, last_events=last_events,
                          window_s=window_s, context=context)
    _atomic_write(path, json.dumps(pm, indent=1, default=repr))
    return pm
