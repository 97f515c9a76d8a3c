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
``ProfilerUnavailable`` and a clear message. The CUDA activity is the
device's: kernels launched by any thread (the serving loop while an
HTTP thread holds the capture) land in the trace; the CPU operator
events are the starting thread's. Start/stop land in the flight
recorder (``profiler/capture_start`` / ``profiler/capture_done``) so
captures show up on the same timeline as the requests they overlapped.
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


class ProfilerUnavailable(RuntimeError):
    """The profiler cannot capture here."""


class ProfilerBusy(RuntimeError):
    """A capture is already in flight (the profiler is process-global)."""


_LOCK = threading.Lock()       # held for the whole capture
_STATE = threading.Lock()      # guards the _active transition only
_active: Optional[tuple] = None     # (artifact dir, profile object)


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
    record("profiler/capture_start", path=path)
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
    path = start_capture(out_dir)
    try:
        time.sleep(seconds)
    finally:
        stop_capture()
    return path
