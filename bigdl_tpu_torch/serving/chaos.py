"""Deterministic fault injection for the serving engine (port of
``bigdl_tpu/serving/chaos.py``, a copy: the JAX package's module is
framework-free, but importing it would import JAX).

Overload behavior (shedding, preemption, loop crashes) is the
hardest serving surface to test: the triggering conditions — SLO burn
under a storm, a device fault mid-dispatch, a wedged slot — are
timing-dependent and slow to reproduce for real. ``ChaosInjector`` is
the scripted stand-in: the engine consults it at three fixed points
(``engine(chaos=...)``), and a test (or ``chip_smoke.py``'s
``qos_gate``) flips exactly the condition it wants, deterministically:

- ``force_burn(active, severe=...)`` — a synthetic TTFT SLO burn: the
  engine's load-shedding decision treats it exactly like an active
  SloWatchdog burn alert (``severe`` escalates the shed set from
  low-class to low+normal), without needing real latency violations.
- ``fail_dispatch(nth)`` — raise ``ChaosFault`` on the Nth device
  dispatch from now: exercises the loop-crash →
  ``EngineStopped`` path on demand.
- ``freeze_slot(sid, iterations)`` — withhold one slot from the fused
  decode for N loop iterations: its request stalls mid-decode (the
  deadline sweep and the preemption victim scan still see it), the
  other slots keep streaming.

Everything is host-side and thread-safe; the injector never touches a
device tensor or launches anything. A default-constructed injector
injects nothing.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class ChaosFault(RuntimeError):
    """The scripted dispatch failure (``fail_dispatch``): raised from
    the engine loop thread at the chosen dispatch, crashing the loop
    through the same path a real device fault would."""


class ChaosInjector:
    """Scripted, deterministic fault injection (see module docstring).

    Control side (any thread): ``force_burn`` / ``fail_dispatch`` /
    ``freeze_slot``. Engine side (loop thread + submit path):
    ``burn_active`` / ``burn_severe`` / ``on_dispatch`` /
    ``begin_iteration`` / ``slot_frozen``. ``snapshot()`` renders the
    current script state for ``stats()["qos"]["chaos"]``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._burn = False
        self._burn_severe = False
        #: dispatches until the scripted fault (None = disarmed)
        self._fail_in: Optional[int] = None
        #: slot id -> remaining frozen iterations
        self._frozen: Dict[int, int] = {}
        self._dispatches = 0
        self._iterations = 0
        self._faults_raised = 0

    # ---------------------------------------------------- control side
    def force_burn(self, active: bool = True,
                   severe: bool = False) -> None:
        """Assert (or clear) a synthetic TTFT SLO burn. ``severe``
        models a burn past twice the alert threshold — the engine
        escalates shedding from low-class-only to low+normal."""
        with self._lock:
            self._burn = bool(active)
            self._burn_severe = bool(active) and bool(severe)

    def fail_dispatch(self, nth: int = 1) -> None:
        """Arm a ``ChaosFault`` on the ``nth`` device dispatch from
        now (1 = the very next one)."""
        if nth < 1:
            raise ValueError(f"nth must be >= 1, got {nth}")
        with self._lock:
            self._fail_in = int(nth)

    def freeze_slot(self, sid: int, iterations: int) -> None:
        """Withhold slot ``sid`` from the fused decode for the next
        ``iterations`` loop iterations."""
        if iterations < 1:
            raise ValueError(
                f"iterations must be >= 1, got {iterations}")
        with self._lock:
            self._frozen[int(sid)] = int(iterations)

    # ----------------------------------------------------- engine side
    def burn_active(self) -> bool:
        with self._lock:
            return self._burn

    def burn_severe(self) -> bool:
        with self._lock:
            return self._burn_severe

    def on_dispatch(self) -> None:
        """Engine loop hook, once per device dispatch: raises the
        scripted ``ChaosFault`` when armed and due."""
        with self._lock:
            self._dispatches += 1
            if self._fail_in is None:
                return
            self._fail_in -= 1
            if self._fail_in > 0:
                return
            self._fail_in = None
            self._faults_raised += 1
            n = self._dispatches
        raise ChaosFault(
            f"scripted dispatch failure injected at dispatch #{n} "
            "(chaos drill — not a real device fault)")

    def begin_iteration(self) -> None:
        """Engine loop hook, once per iteration: ages the slot
        freezes."""
        with self._lock:
            self._iterations += 1
            done = [sid for sid, left in self._frozen.items()
                    if left <= 0]
            for sid in done:
                del self._frozen[sid]

    def slot_frozen(self, sid: int) -> bool:
        """True while slot ``sid`` must sit out the decode (consumes
        one iteration of the freeze per call from the loop)."""
        with self._lock:
            left = self._frozen.get(int(sid))
            if left is None or left <= 0:
                return False
            self._frozen[int(sid)] = left - 1
            return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "burn": self._burn,
                "burn_severe": self._burn_severe,
                "fail_dispatch_in": self._fail_in,
                "frozen_slots": dict(self._frozen),
                "dispatches_seen": self._dispatches,
                "iterations_seen": self._iterations,
                "faults_raised": self._faults_raised,
            }

    def __repr__(self):
        s = self.snapshot()
        return (f"ChaosInjector(burn={s['burn']}, "
                f"fail_in={s['fail_dispatch_in']}, "
                f"frozen={sorted(s['frozen_slots'])})")
