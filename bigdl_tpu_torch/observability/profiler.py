"""On-demand ``torch.profiler`` capture with a bounded, serialized API
(port of ``bigdl_tpu/observability/profiler.py``).

The profiler is the tool of last resort an operator reaches for when
the metrics say "slow" but not "why" — and reaching for it must not
require redeploying with tracing compiled in. This module wraps a
``torch.profiler.profile`` (CPU activity, plus CUDA activity on a
machine with a card) behind:

- ``capture(seconds, out_dir=None)`` — start a trace, sleep the
  bounded duration, stop, and return the artifact directory (it holds
  one ``*.pt.trace.json`` Chrome trace; open it in Perfetto). Used
  programmatically and by tests.
- ``start_capture()`` / ``stop_capture()`` — the split pair for
  profiling a region whose duration the caller controls.
- ``GET/POST /debug/profile?seconds=N`` on
  ``exporters.MetricsHTTPServer`` — the zero-redeploy path: the
  endpoint runs one bounded ``capture`` and returns the artifact path.
- ``available()`` — whether the profiler can record CUDA activity here.

Exactly ONE capture runs at a time (``ProfilerBusy`` otherwise — the
underlying profiler is a process-global singleton; ``models/perf.py``'s
``traced`` takes the same lock through ``exclusive()``), durations are
clamped to ``MAX_SECONDS``, and a profiler that cannot start fails with
``ProfilerUnavailable`` and a clear message. The CPU operator events
are the starting thread's. The kernels of another thread are not
reliably the trace's: on an H100 with torch 2.11, a session started on
one thread while a second thread launched often held none of the
second thread's kernels, though it held their ``cudaLaunchKernel``
calls, and it never lost them when the launching thread started the
session itself (``scripts/torch_profiler_threads.py`` measures both;
PERF.md has the counts). So a loop that launches device work hosts
the captures: it runs inside ``hosting(wake)`` and calls ``poll()``
between its iterations, and ``capture`` called on any other thread
hands the session to it, which starts and stops it on its own thread
(the serving engine's loop does this). A host that has polled before
is in the middle of an iteration, or idle until it has work, and is
waited for (up to ``HOST_REACH_S``); with no host, or only hosts that
have never polled and do not take the session within ``HANDOFF_S``,
the session runs on the calling thread. Start/stop land in the flight
recorder (``profiler/capture_start`` / ``profiler/capture_done``, with
the starting thread's name) so captures show up on the same timeline
as the requests they overlapped.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from typing import Optional

#: Hard ceiling on one capture's duration: the endpoint must never be
#: talked into an unbounded trace that fills the disk.
MAX_SECONDS = 60.0
#: How long ``capture`` waits for a hosting loop to take the session
#: before it runs the session on the calling thread, unless a host that
#: has polled before is still registered (it is mid-iteration).
HANDOFF_S = 0.5
#: How long ``capture`` waits at most for a host that has polled before
#: to reach its next poll (one iteration of the loop: a batch, a step).
HOST_REACH_S = 60.0
#: How long past its duration ``capture`` waits for the host to stop
#: a session (the host stops it between two iterations).
HOST_STOP_GRACE_S = 60.0


class ProfilerUnavailable(RuntimeError):
    """The profiler cannot capture here."""


class ProfilerBusy(RuntimeError):
    """A capture is already in flight (the profiler is process-global)."""


_LOCK = threading.Lock()       # held for the whole capture
_STATE = threading.Lock()      # guards _active and the handoff state
_active: Optional[tuple] = None     # (artifact dir, profile object)
_hosts: dict = {}                   # host thread ident -> _Host
_handoff: Optional["_Handoff"] = None   # waiting for a host to take it
_hosted: Optional["_Handoff"] = None    # running on a host's thread


class _Host:
    """A hosting loop: its wake and idle callables, and whether it has
    polled."""

    def __init__(self, wake, idle):
        self.wake, self.idle, self.polled = wake, idle, False


class _Handoff:
    """One ``capture`` handed to a hosting loop."""

    def __init__(self, seconds: float, out_dir: Optional[str]):
        self.seconds, self.out_dir = seconds, out_dir
        self.taken, self.done = threading.Event(), threading.Event()
        self.path: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.host: Optional[int] = None
        self.t_end = 0.0


def _busy() -> ProfilerBusy:
    return ProfilerBusy(
        "a profiler capture is already in flight (the torch profiler "
        "is process-global); retry after it finishes")


@contextlib.contextmanager
def exclusive():
    """Hold the capture lock for a with-block that runs its own
    ``torch.profiler`` session (``ProfilerBusy`` when a capture is in
    flight), so two sessions never overlap."""
    if not _LOCK.acquire(blocking=False):
        raise _busy()
    try:
        yield
    finally:
        _LOCK.release()


def available() -> bool:
    """Whether ``torch.profiler`` can record CUDA activity here: the
    profiler imports and the machine has a card (a True here does not
    guarantee a capture succeeds — ``start_capture`` still fails
    cleanly if it cannot)."""
    try:
        import torch
        from torch.profiler import ProfilerActivity

        return torch.cuda.is_available() and hasattr(
            ProfilerActivity, "CUDA")
    except Exception:
        return False


def activities():
    """CPU activity, plus CUDA activity on a machine with a card."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_capture(out_dir: Optional[str] = None) -> str:
    """Begin one trace into ``out_dir`` (a fresh temp dir by default).
    Returns the artifact directory. Raises ``ProfilerBusy`` when a
    capture is already running, ``ProfilerUnavailable`` when the
    profiler cannot start."""
    global _active
    if not _LOCK.acquire(blocking=False):
        raise _busy()
    try:
        try:
            from torch.profiler import profile
        except ImportError as e:
            raise ProfilerUnavailable(
                f"torch.profiler is not importable here: {e!r}") from e
        path = out_dir or tempfile.mkdtemp(prefix="bdt_profile_")
        os.makedirs(path, exist_ok=True)
        prof = profile(activities=activities())
        try:
            prof.start()
        except RuntimeError as e:
            raise ProfilerUnavailable(
                f"profiler capture unsupported here: {e!r}") from e
        with _STATE:
            _active = (path, prof)
    except BaseException:
        _LOCK.release()
        raise
    from bigdl_tpu_torch.observability.events import record
    record("profiler/capture_start", path=path,
           thread=threading.current_thread().name)
    return path


def stop_capture(strict: bool = True) -> Optional[str]:
    """End the in-flight capture, write its Chrome trace
    (``trace.<pid>.<ns>.pt.trace.json``) and return its artifact
    directory. With ``strict=False`` a missing capture returns None
    instead of raising — the idempotent form for timer/finally callers
    that race the natural end of a region."""
    global _active
    with _STATE:
        if _active is None:
            if strict:
                raise ProfilerBusy("no capture in flight")
            return None
        (path, prof), _active = _active, None
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            path, f"trace.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
    finally:
        # a plain Lock may be released by a thread other than the
        # acquirer — exactly what the timer/finally split needs
        _LOCK.release()
    from bigdl_tpu_torch.observability.events import record
    record("profiler/capture_done", path=path)
    return path


def capturing() -> bool:
    return _active is not None


def capture(seconds: float, out_dir: Optional[str] = None) -> str:
    """One bounded capture: start, sleep ``seconds`` (clamped to
    ``(0, MAX_SECONDS]``), stop. Returns the artifact directory."""
    import math

    seconds = float(seconds)
    if not math.isfinite(seconds) or seconds <= 0:
        raise ValueError(f"seconds must be a finite value > 0, "
                         f"got {seconds}")
    seconds = min(seconds, MAX_SECONDS)
    if _hosts and threading.get_ident() not in _hosts:
        h = _hand_off(seconds, out_dir)
        if h is not None:
            return _await(h)
    path = start_capture(out_dir)
    try:
        time.sleep(seconds)
    finally:
        stop_capture()
    return path


def _hand_off(seconds: float, out_dir: Optional[str]) -> Optional[_Handoff]:
    """Offer the session to the hosting loops; the taken handoff, or
    None when no host took it within ``HANDOFF_S`` and none that has
    polled before is left to reach its next poll (within
    ``HOST_REACH_S``)."""
    global _handoff
    h = _Handoff(seconds, out_dir)
    with _STATE:
        if _handoff is not None or _hosted is not None or _LOCK.locked():
            raise _busy()
        _handoff = h
        wakes = [host.wake for host in _hosts.values()]
    for wake in wakes:
        wake()
    give_up = time.monotonic() + HOST_REACH_S
    wait = HANDOFF_S
    while not h.taken.wait(wait):
        with _STATE:
            if _handoff is not h:   # taken between the wait and the lock
                return h
            # an idle host was woken and would have taken it by now; one
            # that has polled before is mid-iteration and polls next
            if (not any(host.polled for host in _hosts.values())
                    or time.monotonic() >= give_up):
                _handoff = None     # withdrawn: the caller runs it
                return None
        wait = min(HANDOFF_S, 0.05)
    return h


def _await(h: _Handoff) -> str:
    if not h.done.wait(h.seconds + HOST_STOP_GRACE_S):
        raise ProfilerUnavailable(
            f"the loop hosting the capture has not stopped it "
            f"{HOST_STOP_GRACE_S:.0f} s past its {h.seconds} s")
    if h.error is not None:
        raise h.error
    return h.path


@contextlib.contextmanager
def hosting(wake=None, idle=None):
    """Make the calling thread, a loop that launches device work, the
    host of ``capture`` sessions asked for on other threads while the
    with-block runs. The loop calls ``poll()`` between its iterations;
    ``wake()`` (optional) rouses it from an idle wait, and ``idle()``
    (optional) tells whether it has nothing to launch: an idle loop
    leaves a handed-over session to a loop with work (a loop without
    ``idle`` always has work), and takes it itself once it has work. A
    session still running when the block ends is stopped there."""
    me = threading.get_ident()
    with _STATE:
        _hosts[me] = _Host(wake or (lambda: None), idle)
    try:
        yield
    finally:
        with _STATE:
            del _hosts[me]
            h = _hosted if _hosted is not None and _hosted.host == me \
                else None
        if h is not None:
            _finish(h)


def poll() -> Optional[float]:
    """Called by a hosting loop between iterations: takes a session
    handed over (starting it on this thread), stops this thread's
    session once its time is up, and returns the seconds it has left
    (None when this thread runs none), the longest the loop should
    wait idle before it polls again."""
    global _handoff, _hosted
    h = _hosted
    me = threading.get_ident()
    host = _hosts.get(me)
    if host is not None:
        host.polled = True
    if h is not None and h.host == me:
        left = h.t_end - time.monotonic()
        if left > 0:
            return left
        _finish(h)
        return None
    if _handoff is None:
        return None
    if host is not None and host.idle is not None and host.idle():
        return None     # left to a loop with work, or to this one's next
    with _STATE:
        h, _handoff = _handoff, None
        if h is None:
            return None
        if me not in _hosts:          # not a host: give it back
            _handoff = h
            return None
        h.host, _hosted = me, h
    try:
        h.path = start_capture(h.out_dir)
    except BaseException as e:
        with _STATE:
            _hosted = None
        h.error = e
        h.taken.set()
        h.done.set()
        return None
    h.t_end = time.monotonic() + h.seconds
    h.taken.set()
    return h.seconds


def _finish(h: _Handoff) -> None:
    """Stop a hosted session on its host's thread."""
    global _hosted
    try:
        stop_capture()
    except BaseException as e:
        h.error = e
    finally:
        with _STATE:
            if _hosted is h:
                _hosted = None
        h.done.set()
