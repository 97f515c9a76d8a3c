"""Incident capture: one bundle holding everything a trigger implies.

A watchdog alert or anomaly-detector trigger
(:mod:`bigdl_tpu_torch.observability.anomaly`) is a *pointer* — "TTFT is
burning", "slot 3 stopped advancing" — not evidence. The
:class:`IncidentManager` turns the pointer into a self-contained
artifact while the state still exists:

- the flight recorder's **time-windowed event slice** (the same
  ``window()`` path postmortems use),
- the top-N slow-request **exemplars** with *phase attribution* —
  each finished timeline classified as queue-bound / prefill-bound /
  page_wait-bound / preempted / decode-bound,
- **memory + page-pool** snapshot, qos/cost/loop **stats blocks**,
- the engine **config digest** (which knobs produced this behavior),
- the recent **trigger history** (what else fired around it).

Bundles are deduped per kind under a cooldown (a sustained burn mints
one incident, not one per iteration), kept in a bounded in-memory
ring, optionally mirrored to a bounded on-disk ring (per-bundle JSON
plus a JSONL index), and served over ``GET /debug/incidents[?n=]``.
``scripts/show_incident.py`` pretty-prints a saved bundle. Everything
here is host-side Python — no device program ever runs on the
incident path, so the jit-compile gauge stays flat with capture on.
"""

from __future__ import annotations

import collections
import datetime
import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from bigdl_tpu_torch.observability.events import (
    FlightRecorder, _atomic_write, default_recorder,
)
from bigdl_tpu_torch.observability.instruments import incident_instruments
from bigdl_tpu_torch.observability.metrics import (
    MetricRegistry, default_registry,
)

#: bump when the bundle layout changes (readers check this first)
INCIDENT_SCHEMA = "bigdl_incident/1"

#: classification vocabulary ``classify_timeline`` can return
PHASES = ("queue-bound", "prefill-bound", "page_wait-bound",
          "preempted", "decode-bound")


def classify_timeline(tl: Dict[str, Any]) -> str:
    """Attribute one finished request's latency to its dominant
    phase. Flags outrank durations: a preempted request's long queue
    segment is a *consequence* of preemption, and a page-wait stall
    hides inside queue wait — so ``preempted`` and ``page_waited``
    claim the request before the duration comparison runs."""
    if tl.get("preempted"):
        return "preempted"
    if tl.get("page_waited"):
        return "page_wait-bound"
    phases = {
        "queue-bound": tl.get("queue_wait_s") or 0.0,
        "prefill-bound": tl.get("prefill_s") or 0.0,
        "decode-bound": tl.get("decode_s") or 0.0,
    }
    best = max(phases, key=lambda k: phases[k])
    if phases[best] <= 0.0:
        return "decode-bound"
    return best


def _config_digest(config: Optional[Dict[str, Any]]) -> Optional[dict]:
    if not config:
        return None
    text = json.dumps(config, sort_keys=True, default=repr)
    return {"sha256": hashlib.sha256(text.encode()).hexdigest()[:16],
            "config": config}


class IncidentManager:
    """Assembles, dedupes, stores, and serves incident bundles.

    Capture runs on whatever thread hands in the trigger (the engine
    loop, or a crash handler) — never the sampler thread — and every
    evidence section degrades independently: a torn stats callback
    costs that section, not the bundle.
    """

    def __init__(self, service_name: str = "engine", *,
                 recorder: Optional[FlightRecorder] = None,
                 registry: Optional[MetricRegistry] = None,
                 dirpath: Optional[str] = None,
                 capacity: int = 32,
                 cooldown_s: float = 30.0,
                 window_s: float = 30.0,
                 exemplars: int = 5,
                 config: Optional[Dict[str, Any]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.service_name = service_name
        self._rec = (recorder if recorder is not None
                     else default_recorder())
        self._registry = registry or default_registry()
        self._ins = incident_instruments(self._registry)
        self.dirpath = dirpath
        self.capacity = int(capacity)
        self.cooldown_s = float(cooldown_s)
        self.window_s = float(window_s)
        self.exemplars = int(exemplars)
        self._config = dict(config) if config else None
        self._lock = threading.Lock()
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        self._history: "collections.deque[dict]" = collections.deque(
            maxlen=64)
        self._last_by_kind: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._seq = 0
        if dirpath is not None:
            os.makedirs(dirpath, exist_ok=True)

    # ------------------------------------------------------------ capture
    def capture(self, trigger: Dict[str, Any], *,
                timelines: Optional[List[dict]] = None,
                stats: Optional[Dict[str, Any]] = None,
                memory: Optional[Dict[str, Any]] = None,
                error: Optional[BaseException] = None,
                extra: Optional[Dict[str, Any]] = None
                ) -> Optional[dict]:
        """Assemble and store one bundle for ``trigger``; returns it,
        or None when the kind is inside its dedupe cooldown. Every
        trigger — captured or deduped — lands in the bounded trigger
        history so the next bundle shows what fired around it."""
        now = time.monotonic()
        kind = str(trigger.get("kind", "anomaly"))
        hist_entry = {**trigger, "observed_ts_s": now}
        with self._lock:
            self._history.append(hist_entry)
            last = self._last_by_kind.get(kind)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_by_kind[kind] = now
            self._seq += 1
            inc_id = f"inc-{self._seq:06d}"
            history = list(self._history)
        bundle: Dict[str, Any] = {
            "schema": INCIDENT_SCHEMA,
            "id": inc_id,
            "service": self.service_name,
            "kind": kind,
            "reason": trigger.get("reason", kind),
            "ts_s": now,
            "written_at": datetime.datetime.now(
                datetime.timezone.utc).isoformat(
                timespec="milliseconds"),
            "trigger": dict(trigger),
            "trigger_history": history,
        }
        try:
            bundle["events"] = self._rec.window_snapshot(
                now - self.window_s, now)
        except Exception as e:  # torn recorder must not kill the bundle
            bundle["events"] = []
            bundle["events_error"] = repr(e)
        try:
            bundle["exemplars"] = self._exemplars(timelines)
        except Exception as e:
            bundle["exemplars"] = []
            bundle["exemplars_error"] = repr(e)
        if stats is not None:
            bundle["stats"] = stats
        if memory is not None:
            bundle["memory"] = memory
        if error is not None:
            bundle["error"] = {"type": type(error).__name__,
                               "message": str(error)}
        if extra:
            bundle.update(extra)
        digest = _config_digest(self._config)
        if digest is not None:
            bundle["config_digest"] = digest
        with self._lock:
            self._ring.append(bundle)
            self._counts[kind] = self._counts.get(kind, 0) + 1
        self._ins.incidents_total.labels(self.service_name, kind).inc()
        self._rec.record("incident/captured",
                         trigger.get("request_id"),
                         service=self.service_name, incident=inc_id,
                         incident_kind=kind,
                         detector=trigger.get("detector"))
        if self.dirpath is not None:
            try:
                self._persist(bundle)
            except OSError:
                pass  # a full disk must not take down the engine loop
        return bundle

    def _exemplars(self, timelines: Optional[List[dict]]
                   ) -> List[dict]:
        """Top-N slowest finished requests, phase-attributed. The
        timelines arrive as plain dicts (the engine's bounded
        ``_timelines`` ring) — no engine internals are touched."""
        if not timelines:
            return []
        ranked = sorted(timelines,
                        key=lambda t: t.get("total_s") or 0.0,
                        reverse=True)[:self.exemplars]
        out = []
        for tl in ranked:
            out.append({
                "request_id": tl.get("request_id"),
                "trace_id": tl.get("trace_id"),
                "tenant": tl.get("tenant"),
                "outcome": tl.get("outcome"),
                "phase": classify_timeline(tl),
                "priority": tl.get("priority"),
                "preempted": tl.get("preempted"),
                "page_waited": bool(tl.get("page_waited")),
                "total_s": tl.get("total_s"),
                "queue_wait_s": tl.get("queue_wait_s"),
                "prefill_s": tl.get("prefill_s"),
                "ttft_s": tl.get("ttft_s"),
                "decode_s": tl.get("decode_s"),
                "tokens": tl.get("tokens"),
            })
        return out

    # ------------------------------------------------------------ storage
    def _persist(self, bundle: dict) -> None:
        path = os.path.join(self.dirpath,
                            f"incident-{bundle['id']}.json")
        _atomic_write(path, json.dumps(bundle, indent=1,
                                       default=repr))
        index = os.path.join(self.dirpath, "incidents.jsonl")
        line = json.dumps({
            "id": bundle["id"], "kind": bundle["kind"],
            "reason": bundle["reason"], "ts_s": bundle["ts_s"],
            "written_at": bundle["written_at"],
            "service": bundle["service"], "file": os.path.basename(
                path)}) + "\n"
        with open(index, "a") as f:
            f.write(line)
        # bounded on-disk ring: drop the oldest bundle files beyond
        # capacity (the JSONL index keeps the full summary history)
        bundles = sorted(
            n for n in os.listdir(self.dirpath)
            if n.startswith("incident-") and n.endswith(".json"))
        for victim in bundles[:-self.capacity]:
            try:
                os.unlink(os.path.join(self.dirpath, victim))
            except OSError:
                pass

    # ------------------------------------------------------------ readers
    def snapshot(self, n: Optional[int] = None) -> List[dict]:
        """The newest ``n`` bundles (all, if None), newest first —
        the ``/debug/incidents`` payload."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        if n is not None:
            out = out[:max(0, int(n))]
        return out

    # /debug/incidents serves this (exporters call the same shape on
    # the engine facade)
    debug_incidents = snapshot

    def counts_by_kind(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def history(self) -> List[dict]:
        with self._lock:
            return list(self._history)


def load_incident(path: str) -> dict:
    """Read one saved bundle back (``scripts/show_incident.py``)."""
    with open(path) as f:
        return json.load(f)
