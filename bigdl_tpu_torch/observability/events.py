"""Request-scoped flight recorder: a bounded ring of typed events.

Aggregate metrics (the registry) answer "how is the fleet doing";
they cannot answer "what happened to request X, and in what order"
when one request in a mixed continuous batch is slow or the decode
loop dies. The ``FlightRecorder`` is that black box: a thread-safe,
bounded ring buffer of structured events — monotonic timestamp,
recording thread, request id, kind, free-form attrs — that every
serving layer (engine lifecycle transitions, admission queue,
micro-batcher dispatches) feeds and that exporters read back as a
JSONL tail, a Chrome trace (``chrometrace``), or a crash postmortem
(``postmortem``).

Design points, mirroring the metrics registry:

- **Near-zero cost when disabled**: ``record()`` checks one boolean
  before allocating anything; ``disable()`` turns the per-token hot
  path into a branch and an early return.
- **Bounded**: a ``deque(maxlen=capacity)`` — the recorder can run
  forever in a serving process; old events fall off, ``total``
  keeps the lifetime count so readers can see how much history the
  ring no longer holds.
- **Process default**: ``default_recorder()`` /
  ``set_default_recorder()`` follow the registry's swap convention
  (tests install a fresh recorder BEFORE constructing services;
  integrations capture the default at construction).

Event-kind vocabulary used by the built-in integrations (namespaced
``noun/verb`` strings — the recorder itself accepts any kind):

- ``request/submitted|queued|admitted|prefill_chunk|first_token|``
  ``decode_token|finished|cancelled|timed_out|stopped|crashed`` —
  the continuous-batching engine's per-request lifecycle.
- ``batch/enqueue|dispatch|error`` — micro-batcher coalescing in
  the batch services, tagged with the same request ids.
- ``engine/crash`` — the decode loop died (a postmortem follows).
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

_REQ_SEQ = itertools.count(1)


def next_request_id(prefix: str = "req") -> str:
    """A process-unique request id (``req-000042``) — the correlation
    key shared by the recorder, the serving handles, the micro-batcher
    dispatch tags, and the ``/debug/*`` endpoints."""
    return f"{prefix}-{next(_REQ_SEQ):06d}"


class Event:
    """One recorded occurrence. ``ts`` is ``time.monotonic()`` seconds
    (orderable, never jumps); ``seq`` is the recorder's lifetime
    sequence number (a total order even within one clock tick)."""

    __slots__ = ("seq", "ts", "thread", "request_id", "kind", "attrs")

    def __init__(self, seq: int, ts: float, thread: str,
                 request_id: Optional[str], kind: str,
                 attrs: Optional[Dict[str, Any]]):
        self.seq = seq
        self.ts = ts
        self.thread = thread
        self.request_id = request_id
        self.kind = kind
        self.attrs = attrs

    def to_dict(self, wall_offset: Optional[float] = None) -> dict:
        d: Dict[str, Any] = {"seq": self.seq, "ts_s": self.ts,
                             "thread": self.thread, "kind": self.kind}
        if wall_offset is not None:
            d["wall_s"] = self.ts + wall_offset
        if self.request_id is not None:
            d["request_id"] = self.request_id
        if self.attrs:
            d.update(self.attrs)
        return d

    def __repr__(self):
        rid = f", {self.request_id}" if self.request_id else ""
        return f"Event({self.kind!r}{rid}, ts={self.ts:.6f})"


class FlightRecorder:
    """Thread-safe bounded ring buffer of :class:`Event`.

    ``record(kind, request_id=None, **attrs)`` appends one event (or
    does nothing, cheaply, while disabled). Readers — ``tail``,
    ``for_request``, ``snapshot``, ``to_jsonl`` — copy under the lock
    and never block writers for long."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: "collections.deque[Event]" = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self._enabled = enabled
        self._total = 0
        # process-wide attrs stamped on every event (a fleet worker
        # sets ``replica=<id>`` here so its whole export is
        # attributable after a cross-process merge)
        self._context: Dict[str, Any] = {}
        # request_id -> attrs stamped on that request's events (the
        # engine binds ``trace=<trace_id>`` at submit); bounded like
        # the ring so long-lived recorders never grow without limit
        self._bound: "collections.OrderedDict[str, Dict[str, Any]]" = \
            collections.OrderedDict()
        # anchor: maps monotonic event timestamps onto the wall clock
        # for exports (Chrome trace, JSONL) without ever ordering by
        # the jumpable wall clock internally
        self._mono0 = time.monotonic()
        self._wall0 = time.time()

    # ------------------------------------------------------------- switch
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        """Turn ``record`` into a boolean check and an early return
        (the per-token decode path stays unmeasurable)."""
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    # ------------------------------------------------------------ context
    def set_context(self, **attrs) -> None:
        """Merge process-wide attrs into every subsequently recorded
        event (explicit per-call attrs win). A fleet worker stamps
        ``replica=<id>`` once here instead of threading it through
        every integration."""
        with self._lock:
            self._context.update(attrs)

    @property
    def context(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._context)

    def bind_request(self, request_id: str, **attrs) -> None:
        """Attach attrs to one request id: every event recorded with
        that id carries them (the trace-context channel — the engine
        binds ``trace=<trace_id>`` at submit so the whole per-request
        arc is joinable across processes). Bindings are bounded by
        the ring capacity; the oldest falls off first."""
        with self._lock:
            self._bound[request_id] = dict(attrs)
            self._bound.move_to_end(request_id)
            while len(self._bound) > self.capacity:
                self._bound.popitem(last=False)

    def request_context(self, request_id: str) -> Dict[str, Any]:
        with self._lock:
            return dict(self._bound.get(request_id) or {})

    # ------------------------------------------------------------- writer
    def record(self, kind: str, request_id: Optional[str] = None,
               **attrs) -> Optional[Event]:
        """Append one event; returns it (or None while disabled)."""
        if not self._enabled:
            return None
        ts = time.monotonic()
        thread = threading.current_thread().name
        with self._lock:
            if self._context:
                attrs = {**self._context, **attrs}
            if request_id is not None and self._bound:
                bound = self._bound.get(request_id)
                if bound:
                    attrs = {**bound, **attrs}
            self._total += 1
            ev = Event(self._total, ts, thread, request_id, kind,
                       attrs or None)
            self._events.append(ev)
        return ev

    # ------------------------------------------------------------ readers
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def total(self) -> int:
        """Lifetime recorded count (``total - len`` fell off the ring)."""
        with self._lock:
            return self._total

    @property
    def wall_offset(self) -> float:
        """Add to an event's ``ts`` to get wall-clock seconds."""
        return self._wall0 - self._mono0

    def tail(self, n: Optional[int] = None) -> List[Event]:
        """The newest ``n`` events (all, if None; none, if <= 0 —
        ``out[-0:]`` would be everything), oldest first."""
        with self._lock:
            out = list(self._events)
        if n is None:
            return out
        return out[-n:] if n > 0 else []

    def for_request(self, request_id: str) -> List[Event]:
        """Every retained event of one request, in recording order."""
        return [e for e in self.tail() if e.request_id == request_id]

    def window(self, t0: float,
               t1: Optional[float] = None) -> List[Event]:
        """Events whose monotonic ``ts`` falls in ``[t0, t1]``
        (``t1`` defaults to now), oldest first — the evidence slice
        incidents and postmortems share."""
        if t1 is None:
            t1 = time.monotonic()
        with self._lock:
            out = list(self._events)
        return [e for e in out if t0 <= e.ts <= t1]

    def window_snapshot(self, t0: float, t1: Optional[float] = None,
                        limit: Optional[int] = None) -> List[dict]:
        """:meth:`window` as plain dicts (with ``wall_s``), capped to
        the newest ``limit`` when given."""
        off = self.wall_offset
        evs = self.window(t0, t1)
        if limit is not None and limit > 0:
            evs = evs[-limit:]
        return [e.to_dict(off) for e in evs]

    def snapshot(self, last: Optional[int] = None) -> List[dict]:
        """The newest ``last`` events as plain dicts (with ``wall_s``)
        — what the ``/debug/events`` endpoint and postmortems embed."""
        off = self.wall_offset
        return [e.to_dict(off) for e in self.tail(last)]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # ------------------------------------------------------------- export
    def to_jsonl(self, path: Optional[str] = None,
                 last: Optional[int] = None) -> str:
        """The newest ``last`` events as JSON lines; when ``path`` is
        given, also atomically write them there (temp file + rename)."""
        text = "\n".join(json.dumps(d) for d in self.snapshot(last))
        if text:
            text += "\n"
        if path is not None:
            _atomic_write(path, text)
        return text


def _atomic_write(path: str, text: str) -> None:
    import os
    import tempfile

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


def percentile_summary(values: Iterable[Optional[float]]) -> dict:
    """Nearest-rank percentile summary of a small sample —
    ``{count, mean, p50, p90, p99}`` (None entries are skipped; an
    empty sample reports count 0 and None quantiles). What the serving
    ``stats()`` facades report per timeline phase."""
    xs = sorted(v for v in values if v is not None)
    if not xs:
        return {"count": 0, "mean": None, "p50": None, "p90": None,
                "p99": None}

    def q(p: float) -> float:
        return xs[min(len(xs) - 1, int(round(p * (len(xs) - 1))))]

    return {"count": len(xs),
            "mean": sum(xs) / len(xs),
            "p50": q(0.50), "p90": q(0.90), "p99": q(0.99)}


#: The process default recorder — what the built-in integrations
#: (serving engine, admission queue, micro-batcher) feed unless handed
#: an explicit one.
RECORDER = FlightRecorder()

_default_lock = threading.Lock()
_default: FlightRecorder = RECORDER


def default_recorder() -> FlightRecorder:
    return _default


def set_default_recorder(rec: FlightRecorder) -> FlightRecorder:
    """Swap the process default (returns the previous one). The same
    test convention as ``set_default_registry``: swap BEFORE
    constructing services — they capture the default at construction."""
    global _default
    with _default_lock:
        prev = _default
        _default = rec
        return prev


def record(kind: str, request_id: Optional[str] = None,
           **attrs) -> Optional[Event]:
    """``default_recorder().record(...)`` — the one-liner for app code."""
    return _default.record(kind, request_id, **attrs)
