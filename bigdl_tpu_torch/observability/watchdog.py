"""Watchdogs: recompile-storm detection and SLO burn-rate alerts (port of
``bigdl_tpu/observability/watchdog.py``).

Two failure modes kill a serving deployment silently today: a
RECOMPILE STORM (a shape leak makes every request dispatch a program
signature never seen before — under JAX a fresh compile each, here a
fresh set of kernel selections, allocator growth and, once CUDA graphs
come, a fresh capture; throughput collapses while every individual
metric still "works"), and a slow SLO bleed (the TTFT/inter-token histograms drift
past their objectives long before anyone reads them). Both watchdogs
turn the telemetry the stack already records into ACTIONABLE alert
state:

- ``RecompileWatchdog`` samples a cumulative compile-count probe (the
  engine's ``_compile_total``, the distinct dispatch signatures —
  program name, argument shapes and dtypes — its programs launched;
  the train loops' step signatures). A
  bounded number of warmup compiles is expected; growth that KEEPS
  happening after warmup raises a ``watchdog/recompile_storm``
  flight-recorder event and sets the
  ``bdt_watchdog_alert_active{alert="recompile_storm"}`` gauge.
- ``SloWatchdog`` evaluates burn rates over latency histograms against
  ``SloObjective``s: for an objective "``target`` of requests under
  ``threshold_s``", the burn rate over the trailing ``window_s`` is
  ``bad_fraction / (1 - target)`` — 1.0 means spending error budget
  exactly as fast as allowed, ``burn_threshold`` (default 2.0) trips
  the alert. Alerts raise ``watchdog/slo_burn`` events, the per-
  objective ``bdt_watchdog_slo_burn_rate`` gauge, and the shared
  alert-active gauge.

Both are PULL-style: ``sample()`` is cheap (reads a counter / one
histogram snapshot) and the caller picks the cadence — the continuous-
batching engine samples once per loop iteration; a standalone runner
can call it from any timer. ``alerts()`` returns the active alerts as
plain dicts — what ``ContinuousBatchingEngine.stats()["alerts"]`` and
the degraded-``/healthz`` body surface.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, List, Optional, Tuple


class RecompileWatchdog:
    """Detect post-warmup growth of a cumulative compile counter.

    ``probe`` is a zero-argument callable returning the CURRENT
    cumulative compiled-executable count. The first ``warmup_growths``
    samples that show growth are free (cold-start compiles are
    expected); after that, each growth sample is remembered for
    ``window`` samples — ``storm_growths`` of them within the window
    means compiles keep happening under steady shapes, which is the
    storm. The alert clears after ``clear_after`` consecutive
    growth-free samples."""

    ALERT = "recompile_storm"

    def __init__(self, probe: Callable[[], Optional[int]],
                 service: str = "engine", warmup_growths: int = 8,
                 window: int = 64, storm_growths: int = 3,
                 clear_after: int = 128, registry=None, recorder=None):
        from bigdl_tpu_torch.observability.events import default_recorder
        from bigdl_tpu_torch.observability.instruments import (
            watchdog_instruments,
        )

        if storm_growths < 1:
            raise ValueError(
                f"storm_growths must be >= 1, got {storm_growths}")
        self.probe = probe
        self.service = service
        self.warmup_growths = warmup_growths
        self.window = window
        self.storm_growths = storm_growths
        self.clear_after = clear_after
        self._ins = watchdog_instruments(registry)
        self._rec = recorder if recorder is not None \
            else default_recorder()
        self._gauge = self._ins.alert_active.labels(self.ALERT, service)
        self._last: Optional[int] = None
        self._samples = 0
        self._growths_total = 0
        self._marks: Deque[int] = collections.deque()  # sample indices
        #: sample index of the most recent growth of ANY kind — the
        #: clear countdown runs against this, not against the
        #: window-pruned marks (clear_after may exceed window)
        self._last_growth_idx: Optional[int] = None
        self._active = False
        self._since: Optional[float] = None
        self._detail: dict = {}

    @property
    def active(self) -> bool:
        return self._active

    def sample(self, now: Optional[float] = None) -> bool:
        """Read the probe once; returns whether the storm alert is
        active afterwards. Never raises on a failing probe (a broken
        probe must not take the serving loop down)."""
        now = time.monotonic() if now is None else now
        try:
            v = self.probe()
        except Exception:
            v = None
        if v is None:
            return self._active
        v = int(v)
        self._samples += 1
        if self._last is not None and v > self._last:
            self._growths_total += 1
            self._last_growth_idx = self._samples
            self._ins.recompile_growth.labels(self.service).inc()
            if self._growths_total > self.warmup_growths:
                self._marks.append(self._samples)
        self._last = v
        while self._marks and self._marks[0] <= self._samples - self.window:
            self._marks.popleft()
        if not self._active and len(self._marks) >= self.storm_growths:
            self._active = True
            # wall clock: "since" is exported to operators (healthz
            # bodies, alert dicts) — a monotonic reading would be
            # process-relative noise there
            self._since = time.time()
            self._detail = {"compiles": v,
                            "growths_in_window": len(self._marks),
                            "window_samples": self.window}
            self._gauge.set(1)
            self._ins.alerts_fired.labels(self.ALERT, self.service).inc()
            self._rec.record("watchdog/recompile_storm",
                             service=self.service, **self._detail)
        elif self._active and (
                self._last_growth_idx is None
                or self._samples - self._last_growth_idx
                >= self.clear_after):
            self._active = False
            # the storm is over: stale marks must not re-trigger it on
            # the very next sample
            self._marks.clear()
            self._gauge.set(0)
            self._rec.record("watchdog/recompile_cleared",
                             service=self.service, compiles=v)
        return self._active

    def alert(self) -> Optional[dict]:
        """The active alert as a plain dict, or None."""
        if not self._active:
            return None
        return {"alert": self.ALERT, "service": self.service,
                "severity": "critical", "since": self._since,
                **self._detail}


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
                 "burn", "detail", "burn_gauge", "alert_gauge")

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
        # gauge children bound once here — sample() runs on the decode
        # loop's hot path and must not pay a registry lookup per call
        self.burn_gauge = None
        self.alert_gauge = None
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
    the trailing-window burn rate, and raises/clears alerts."""

    def __init__(self, service: str = "engine", registry=None,
                 recorder=None):
        from bigdl_tpu_torch.observability.events import default_recorder
        from bigdl_tpu_torch.observability.instruments import (
            watchdog_instruments,
        )

        self.service = service
        self._ins = watchdog_instruments(registry)
        self._rec = recorder if recorder is not None \
            else default_recorder()
        self._states: List[_ObjectiveState] = []

    def watch(self, objective: SloObjective, histogram_child
              ) -> "SloWatchdog":
        st = _ObjectiveState(objective, histogram_child)
        st.burn_gauge = self._ins.slo_burn_rate.labels(
            objective.name, self.service)
        st.alert_gauge = self._ins.alert_active.labels(
            f"slo:{objective.name}", self.service)
        self._states.append(st)
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
            st.burn_gauge.set(burn)
            gauge = st.alert_gauge
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
                gauge.set(1)
                self._ins.alerts_fired.labels(
                    f"slo:{st.obj.name}", self.service).inc()
                self._rec.record("watchdog/slo_burn",
                                 service=self.service, **st.detail)
            elif st.active and burn < st.obj.burn_threshold:
                st.active = False
                gauge.set(0)
                self._rec.record("watchdog/slo_cleared",
                                 service=self.service,
                                 objective=st.obj.name,
                                 burn_rate=round(burn, 3))
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
