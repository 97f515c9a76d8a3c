"""SLO burn-rate alerts over latency histograms (port of the
``SloObjective`` / ``SloWatchdog`` half of
``bigdl_tpu/observability/watchdog.py``; its ``RecompileWatchdog`` counts
JAX compiles and has no counterpart here yet).

``SloWatchdog`` evaluates burn rates over latency histograms against
``SloObjective``s: for an objective "``target`` of requests under
``threshold_s``", the burn rate over the trailing ``window_s`` is
``bad_fraction / (1 - target)`` — 1.0 means spending error budget
exactly as fast as allowed, ``burn_threshold`` (default 2.0) trips the
alert. The evaluation is the JAX watchdog's, line for line; the port
sets no gauge and records no flight-recorder event (it has neither
yet), so ``state()`` and ``alerts()`` are the surfaces.

It is PULL-style: ``sample()`` is cheap (one histogram snapshot per
objective) and the caller picks the cadence — the continuous-batching
engine samples once per loop iteration. ``alerts()`` returns the active
alerts as plain dicts — what ``ContinuousBatchingEngine.stats()["alerts"]``
surfaces — and ``state()`` feeds the engine's load-shedding decision.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, List, Optional, Tuple


class SloObjective:
    """One latency objective: ``target`` (fraction) of observations
    under ``threshold_s``, evaluated as a burn rate over the trailing
    ``window_s``. ``metric`` names the engine histogram the objective
    binds to when handed to ``ContinuousBatchingEngine``
    (``"ttft"`` / ``"inter_token"`` / ``"queue_wait"``); standalone
    ``SloWatchdog.watch`` callers bind a histogram child directly and
    may leave it None."""

    __slots__ = ("name", "threshold_s", "target", "window_s",
                 "burn_threshold", "min_count", "metric")

    def __init__(self, name: str, threshold_s: float,
                 target: float = 0.99, window_s: float = 60.0,
                 burn_threshold: float = 2.0, min_count: int = 20,
                 metric: Optional[str] = None):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if threshold_s <= 0:
            raise ValueError(
                f"threshold_s must be > 0, got {threshold_s}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if min_count < 1:
            raise ValueError(f"min_count must be >= 1, got {min_count}")
        self.name = name
        self.threshold_s = float(threshold_s)
        self.target = float(target)
        self.window_s = float(window_s)
        self.burn_threshold = float(burn_threshold)
        self.min_count = int(min_count)
        self.metric = metric

    def __repr__(self):
        return (f"SloObjective({self.name!r}, "
                f"{self.target:.0%} < {self.threshold_s}s, "
                f"window={self.window_s}s, "
                f"burn>={self.burn_threshold})")


class _ObjectiveState:
    __slots__ = ("obj", "child", "good_idx", "snaps", "active", "since",
                 "burn", "detail")

    def __init__(self, obj: SloObjective, child):
        import bisect

        self.obj = obj
        self.child = child
        # the histogram edge the objective counts "good" against: the
        # LARGEST bucket edge <= threshold. A threshold between edges
        # therefore rounds PESSIMISTICALLY (observations in
        # (edge, threshold] count bad) — a watchdog must over-alert on
        # quantization, never sit silent through a real breach. A
        # threshold BELOW the smallest edge has no good bucket at all
        # (None): every observation counts bad, same principle.
        buckets = child._metric.buckets
        idx = bisect.bisect_right(buckets, obj.threshold_s) - 1
        self.good_idx = idx if idx >= 0 else None
        #: trailing (ts, good_cum, total_cum) snapshots
        self.snaps: Deque[Tuple[float, int, int]] = collections.deque()
        self.active = False
        self.since: Optional[float] = None
        self.burn = 0.0
        self.detail: dict = {}


class SloWatchdog:
    """Burn-rate evaluation of ``SloObjective``s over live latency
    histograms. ``watch(objective, histogram_child)`` binds each
    objective; ``sample()`` snapshots every bound histogram, computes
    the trailing-window burn rate, and raises/clears alerts.
    ``registry`` and ``recorder`` are accepted for the JAX watchdog's
    signature and unused."""

    def __init__(self, service: str = "engine", registry=None,
                 recorder=None):
        self.service = service
        self._states: List[_ObjectiveState] = []

    def watch(self, objective: SloObjective, histogram_child
              ) -> "SloWatchdog":
        """Bind ``objective`` to a histogram with the
        ``observability.histogram.Histogram`` interface."""
        self._states.append(_ObjectiveState(objective, histogram_child))
        return self

    @property
    def objectives(self) -> List[SloObjective]:
        return [s.obj for s in self._states]

    @property
    def active(self) -> bool:
        return any(s.active for s in self._states)

    def sample(self, now: Optional[float] = None) -> bool:
        """Snapshot every objective's histogram and re-evaluate its
        burn rate; returns whether ANY alert is active afterwards."""
        now = time.monotonic() if now is None else now
        for st in self._states:
            cum, _sum, count = st.child.get()
            good = cum[st.good_idx] if st.good_idx is not None else 0
            # the deque is bounded by SPACING, not by sampling rate: a
            # decode loop sampling every millisecond must not retain
            # window_s/1ms snapshots — one per window_s/256 keeps the
            # burn-rate resolution while capping the deque at ~257
            # entries. The CURRENT reading always evaluates against the
            # baseline, appended or not.
            if (not st.snaps
                    or now - st.snaps[-1][0] >= st.obj.window_s / 256):
                st.snaps.append((now, good, count))
            # keep exactly one snapshot at-or-beyond the window edge as
            # the delta baseline
            while (len(st.snaps) > 1
                   and st.snaps[1][0] <= now - st.obj.window_s):
                st.snaps.popleft()
            base_ts, base_good, base_count = st.snaps[0]
            d_total = count - base_count
            d_good = good - base_good
            if d_total < st.obj.min_count:
                # not enough traffic in the window to judge; an alert
                # stays up until contradicted by real traffic
                continue
            bad_frac = (d_total - d_good) / d_total
            burn = bad_frac / max(1.0 - st.obj.target, 1e-9)
            st.burn = burn
            if not st.active and burn >= st.obj.burn_threshold:
                st.active = True
                st.since = time.time()  # wall clock: exported field
                st.detail = {
                    "objective": st.obj.name,
                    "burn_rate": round(burn, 3),
                    "bad": d_total - d_good, "observations": d_total,
                    "threshold_s": st.obj.threshold_s,
                    "target": st.obj.target,
                    "window_s": st.obj.window_s,
                }
            elif st.active and burn < st.obj.burn_threshold:
                st.active = False
        return self.active

    def alerts(self) -> List[dict]:
        """Every active SLO alert as a plain dict."""
        return [{"alert": f"slo:{st.obj.name}", "service": self.service,
                 "severity": "warning", "since": st.since, **st.detail}
                for st in self._states if st.active]

    def state(self) -> List[dict]:
        """Every bound objective's CURRENT evaluation — active or not
        — keyed for decisions, not display: the engine's load-shedding
        policy reads the ``metric == "ttft"`` rows to decide whether
        (and how hard) admission is burning its TTFT budget.
        ``burn_rate`` is the last ``sample()``'s figure (0.0 before
        traffic clears ``min_count``); ``severe`` marks a burn at or
        past twice the alert threshold — the escalation point where
        shedding widens from low-class to low+normal."""
        return [{
            "objective": st.obj.name,
            "metric": st.obj.metric,
            "active": st.active,
            "burn_rate": round(st.burn, 3),
            "burn_threshold": st.obj.burn_threshold,
            "severe": st.active
            and st.burn >= 2.0 * st.obj.burn_threshold,
            "threshold_s": st.obj.threshold_s,
            "target": st.obj.target,
            "window_s": st.obj.window_s,
        } for st in self._states]
