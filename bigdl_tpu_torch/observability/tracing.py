"""Span-based wall-time tracing (port of
``bigdl_tpu/observability/tracing.py``).

``with trace.span("train/step"):`` measures the block's wall time and
records it into a tree of nested spans. Nesting is tracked per thread
(a ``threading.local`` stack), so concurrent serving threads each build
their own correct tree instead of corrupting a shared stack; a span
opened on a worker thread becomes a root of that thread's own trace.

While a ``torch.profiler`` capture runs, every span also enters a
``torch.profiler.record_function`` of its name, so the same names show
up on the host timeline of the captured trace, around the kernels they
launched. Outside a capture no ``record_function`` is entered: it would
cost a dispatcher round trip per span for a trace nobody records.

Completed ROOT spans accumulate in a bounded ring (oldest dropped), one
entry per top-level operation; ``trace.roots()`` / ``trace.render()``
read them back, and ``span(..., histogram=child)`` streams durations
into a registry histogram so traces and metrics share one timing source.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

import torch


class Span:
    """One timed region. ``duration`` is wall seconds (None while open);
    ``children`` are the spans opened inside it on the same thread."""

    __slots__ = ("name", "start", "duration", "children", "thread")

    def __init__(self, name: str, thread: str):
        self.name = name
        self.start = time.time()
        self.duration: Optional[float] = None
        self.children: List["Span"] = []
        self.thread = thread

    def tree(self, indent: int = 0) -> str:
        dur = f"{self.duration * 1e3:.3f}ms" if self.duration is not None \
            else "open"
        lines = [f"{'  ' * indent}{self.name}  {dur}"]
        for c in self.children:
            lines.append(c.tree(indent + 1))
        return "\n".join(lines)

    def __repr__(self):
        return f"Span({self.name!r}, duration={self.duration})"


def _profiler_annotation(name: str):
    """A ``torch.profiler.record_function`` for ``name`` while a profiler
    capture is recording, else None."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    return torch.profiler.record_function(name)


class Tracer:
    """Per-thread span stacks + a bounded ring of completed root spans."""

    def __init__(self, max_roots: int = 256, forward_to_profiler: bool = True):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._roots: collections.deque = collections.deque(maxlen=max_roots)
        #: thread ident -> that thread's live span stack. Registered
        #: when a thread opens its first span, REMOVED when its last
        #: span closes — so thread churn (one thread per request)
        #: never grows this map unboundedly, and crash postmortems can
        #: enumerate every still-open span tree across threads.
        self._live: dict = {}
        self._enabled = True
        self.forward_to_profiler = forward_to_profiler

    # ------------------------------------------------------------- switch
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -------------------------------------------------------------- spans
    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
            with self._lock:
                self._live[threading.get_ident()] = s
        return s

    def _drop_stack(self) -> None:
        """Reclaim this thread's (now empty) stack storage — both the
        thread-local slot and the live-stack registration."""
        with self._lock:
            self._live.pop(threading.get_ident(), None)
        try:
            del self._local.stack
        except AttributeError:
            pass

    @contextmanager
    def span(self, name: str, histogram=None):
        """Time the with-block as a span nested under the thread's
        current span (or as a new root). ``histogram`` (a registry
        histogram or child) additionally receives the duration."""
        if not self._enabled:
            # a disabled TRACER must not silence a caller's METRIC: the
            # histogram still gets the block's duration
            if histogram is not None:
                t0 = time.perf_counter()
                try:
                    yield None
                finally:
                    histogram.observe(time.perf_counter() - t0)
            else:
                yield None
            return
        stack = self._stack()
        sp = Span(name, threading.current_thread().name)
        if stack:
            stack[-1].children.append(sp)
        stack.append(sp)
        ann = (_profiler_annotation(name) if self.forward_to_profiler
               else None)
        if ann is not None:
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield sp
        finally:
            sp.duration = time.perf_counter() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            # pop THIS span even if an inner span leaked open
            while stack and stack.pop() is not sp:
                pass
            if not stack:
                with self._lock:
                    self._roots.append(sp)
                # last span on this thread closed: reclaim its stack
                # storage (short-lived request threads must not leave
                # a thread-local entry behind forever)
                self._drop_stack()
            if histogram is not None:
                histogram.observe(sp.duration)

    def current(self) -> Optional[Span]:
        # read-only: must not allocate (and register) stack storage
        # for a thread that never opened a span
        s = getattr(self._local, "stack", None)
        return s[-1] if s else None

    # ------------------------------------------------------------ readers
    def open_spans(self) -> List[Span]:
        """The still-open ROOT span of every thread currently inside a
        ``span(...)`` block — live objects, read for rendering only
        (crash postmortems and the Chrome trace include them so
        "what was mid-flight" survives the crash)."""
        with self._lock:
            stacks = [list(s) for s in self._live.values()]
        return [s[0] for s in stacks if s]

    def roots(self, name: Optional[str] = None) -> List[Span]:
        """Completed root spans, oldest first; ``name`` filters."""
        with self._lock:
            out = list(self._roots)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def render(self, last: int = 10) -> str:
        """The newest ``last`` completed root trees, rendered."""
        roots = self.roots()[-last:]
        return "\n".join(s.tree() for s in roots)

    def reset(self) -> None:
        with self._lock:
            self._roots.clear()


#: The process default tracer (what the built-in integrations use).
trace = Tracer()
