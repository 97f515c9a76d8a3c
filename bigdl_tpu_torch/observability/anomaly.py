"""Online anomaly detection over timeseries rings.

Detectors observe the same ``(ts, value)`` stream the
:class:`~bigdl_tpu_torch.observability.timeseries.TimeSeriesSampler` appends
to its rings — evaluation happens at sample time on the sampler
thread, costs a handful of floats per metric, and never touches a
device program.  Each detector is a small state machine::

    warmup ──(seen >= warmup)──> ok ──(breach)──> firing
                                  ^                  │
                                  └──(clear_after────┘
                                      consecutive calm samples)

Triggers only fire on the *rising edge* into ``firing`` and are
further rate-limited by a per-detector cooldown, so a sustained
breach produces one incident, not one per sample.  Hysteresis: the
detector leaves ``firing`` only after ``clear_after`` consecutive
calm samples — samples in the dead band between "calm" and "breached"
reset the calm streak without clearing.

:class:`DetectorBank` is the aggregation point: the sampler feeds it
per-metric observations, the engine loop drains pending triggers and
feeds watchdog alerts (``SloWatchdog`` / ``RecompileWatchdog``)
through :meth:`DetectorBank.alert_triggers` so burn-rate state and
ring anomalies converge on one capture path.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "AnomalyDetector",
    "EwmaZScoreDetector",
    "ThresholdDetector",
    "RateOfChangeDetector",
    "StallDetector",
    "DetectorBank",
    "default_detector_bank",
]


class AnomalyDetector:
    """Base class: warmup suppression, hysteresis, cooldown.

    Subclasses implement ``_evaluate(ts, value) -> (score, breached,
    calm)`` where ``breached`` means the sample is anomalous and
    ``calm`` means it is comfortably normal; a sample may be neither
    (the dead band), which holds the current state.
    """

    kind = "anomaly"

    def __init__(self, metric: str, *, name: Optional[str] = None,
                 warmup: int = 0, clear_after: int = 3,
                 cooldown_s: float = 60.0):
        self.metric = metric
        self.name = name or f"{type(self).__name__}:{metric}"
        self.warmup = int(warmup)
        self.clear_after = max(1, int(clear_after))
        self.cooldown_s = float(cooldown_s)
        self.state = "warmup" if self.warmup > 0 else "ok"
        self._seen = 0
        self._calm_streak = 0
        self._last_fire_ts = -math.inf

    # -- subclass hook ----------------------------------------------
    def _evaluate(self, ts: float,
                  value: float) -> Tuple[float, bool, bool]:
        raise NotImplementedError

    # -- lifecycle --------------------------------------------------
    def observe(self, ts: float, value: float) -> Optional[dict]:
        """Feed one sample; returns a trigger dict on the rising edge
        into ``firing`` (cooldown permitting), else None."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            return None
        if not math.isfinite(v):
            return None
        score, breached, calm = self._evaluate(ts, v)
        self._seen += 1
        if self._seen <= self.warmup:
            # model state still updates during warmup (EWMA learns the
            # baseline) but no transitions or triggers happen
            self.state = "warmup"
            return None
        if self.state == "warmup":
            self.state = "ok"
        if self.state == "firing":
            if calm:
                self._calm_streak += 1
                if self._calm_streak >= self.clear_after:
                    self.state = "ok"
                    self._calm_streak = 0
            else:
                self._calm_streak = 0
            return None
        # state == "ok"
        if breached:
            self.state = "firing"
            self._calm_streak = 0
            if ts - self._last_fire_ts >= self.cooldown_s:
                self._last_fire_ts = ts
                return {
                    "detector": self.name,
                    "metric": self.metric,
                    "kind": self.kind,
                    "reason": self._reason(v, score),
                    "ts_s": ts,
                    "value": v,
                    "score": score,
                }
        return None

    def _reason(self, value: float, score: float) -> str:
        return (f"{self.metric} anomalous "
                f"(value={value:.4g}, score={score:.3g})")


class EwmaZScoreDetector(AnomalyDetector):
    """Flags samples whose z-score against an exponentially-weighted
    mean/variance exceeds ``threshold``.  The score is computed
    against history *before* folding the sample in, so a step change
    is judged against the old baseline."""

    def __init__(self, metric: str, *, threshold: float = 4.0,
                 alpha: float = 0.1, min_std: float = 1e-6,
                 warmup: int = 30, **kw):
        super().__init__(metric, warmup=warmup, **kw)
        self.threshold = float(threshold)
        self.alpha = float(alpha)
        self.min_std = float(min_std)
        self._mean: Optional[float] = None
        self._var = 0.0

    def _evaluate(self, ts, value):
        if self._mean is None:
            self._mean = value
            return 0.0, False, True
        std = max(math.sqrt(self._var), self.min_std)
        z = (value - self._mean) / std
        # EWMA update (West 1979 incremental form)
        delta = value - self._mean
        self._mean += self.alpha * delta
        self._var = (1.0 - self.alpha) * (
            self._var + self.alpha * delta * delta)
        breached = abs(z) > self.threshold
        calm = abs(z) <= self.threshold / 2.0
        return z, breached, calm

    def _reason(self, value, score):
        return (f"{self.metric} z-score {score:.2f} beyond "
                f"±{self.threshold:g} (value={value:.4g}, "
                f"ewma={self._mean:.4g})")


class ThresholdDetector(AnomalyDetector):
    """Fires after ``sustain`` consecutive samples beyond a fixed
    threshold — a sustained-breach detector, immune to single-sample
    blips by construction."""

    def __init__(self, metric: str, *, threshold: float,
                 sustain: int = 3, direction: str = "above",
                 warmup: int = 0, **kw):
        super().__init__(metric, warmup=warmup, **kw)
        if direction not in ("above", "below"):
            raise ValueError(f"direction must be above|below: "
                             f"{direction!r}")
        self.threshold = float(threshold)
        self.sustain = max(1, int(sustain))
        self.direction = direction
        self._streak = 0

    def _evaluate(self, ts, value):
        over = (value > self.threshold if self.direction == "above"
                else value < self.threshold)
        self._streak = self._streak + 1 if over else 0
        breached = self._streak >= self.sustain
        return float(self._streak), breached, not over

    def _reason(self, value, score):
        return (f"{self.metric} {self.direction} {self.threshold:g} "
                f"for {self._streak} consecutive samples "
                f"(value={value:.4g})")


class RateOfChangeDetector(AnomalyDetector):
    """Fires when |dv/dt| between consecutive samples exceeds
    ``max_rate`` (units per second)."""

    def __init__(self, metric: str, *, max_rate: float,
                 warmup: int = 2, **kw):
        super().__init__(metric, warmup=warmup, **kw)
        self.max_rate = float(max_rate)
        self._prev: Optional[Tuple[float, float]] = None

    def _evaluate(self, ts, value):
        prev = self._prev
        self._prev = (ts, value)
        if prev is None or ts <= prev[0]:
            return 0.0, False, True
        rate = abs(value - prev[1]) / (ts - prev[0])
        return rate, rate > self.max_rate, rate <= self.max_rate / 2.0

    def _reason(self, value, score):
        return (f"{self.metric} changing at {score:.4g}/s, "
                f"max {self.max_rate:g}/s")


class StallDetector:
    """Iteration-fed liveness detector: a slot that stays live without
    advancing for ``threshold`` consecutive engine iterations is
    stalled.  Fed from the engine loop (not the sampler — the 1 s
    sampler cadence is far too coarse for iteration-scale freezes).
    Fires once per slot at the streak crossing, with a per-slot
    cooldown so a long freeze mints one trigger."""

    kind = "stall"

    def __init__(self, threshold: int = 200, *,
                 cooldown_s: float = 60.0, name: str = "stall"):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.name = name
        self._streaks: Dict[int, int] = {}
        self._last_fire: Dict[int, float] = {}

    @property
    def state(self) -> str:
        return ("firing"
                if any(s >= self.threshold
                       for s in self._streaks.values()) else "ok")

    def observe_iteration(self, now: float, live: Sequence[int],
                          advanced: Sequence[int]) -> List[dict]:
        adv = set(advanced)
        live_set = set(live)
        for sid in list(self._streaks):
            if sid not in live_set:
                self._streaks.pop(sid, None)
        triggers: List[dict] = []
        for sid in live_set:
            if sid in adv:
                self._streaks[sid] = 0
                continue
            streak = self._streaks.get(sid, 0) + 1
            self._streaks[sid] = streak
            if streak == self.threshold \
                    and now - self._last_fire.get(sid, -math.inf) \
                    >= self.cooldown_s:
                self._last_fire[sid] = now
                triggers.append({
                    "detector": self.name,
                    "metric": f"slot/{sid}",
                    "kind": self.kind,
                    "reason": (f"slot {sid} live but not advancing "
                               f"for {streak} iterations"),
                    "ts_s": now,
                    "value": float(streak),
                    "score": float(streak),
                })
        return triggers


class DetectorBank:
    """Routes sampled metrics to their detectors and converges
    watchdog alerts onto the same trigger stream.

    The sampler thread calls :meth:`observe` (which only appends to a
    pending list under a private lock — no capture work happens on the
    sampler thread); the engine loop calls :meth:`drain` +
    :meth:`alert_triggers` once per iteration and hands the combined
    triggers to the incident manager."""

    def __init__(self, detectors: Sequence[AnomalyDetector] = (), *,
                 stall: Optional[StallDetector] = None,
                 alert_cooldown_s: float = 60.0):
        self._by_metric: Dict[str, List[AnomalyDetector]] = {}
        self._detectors: List[AnomalyDetector] = []
        for d in detectors:
            self.add(d)
        self.stall = stall
        self.alert_cooldown_s = float(alert_cooldown_s)
        self._alert_last: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._pending: List[dict] = []

    def add(self, detector: AnomalyDetector) -> "DetectorBank":
        self._detectors.append(detector)
        self._by_metric.setdefault(detector.metric, []).append(detector)
        return self

    @property
    def metrics(self) -> Tuple[str, ...]:
        return tuple(self._by_metric)

    # -- sampler-thread side ----------------------------------------
    def observe(self, metric: str, ts: float, value) -> None:
        dets = self._by_metric.get(metric)
        if not dets:
            return
        fired = []
        for d in dets:
            t = d.observe(ts, value)
            if t is not None:
                fired.append(t)
        if fired:
            with self._lock:
                self._pending.extend(fired)

    # -- engine-loop side -------------------------------------------
    def drain(self) -> List[dict]:
        with self._lock:
            if not self._pending:
                return []
            out, self._pending = self._pending, []
        return out

    def alert_triggers(self, alerts: Sequence[dict],
                       now: float) -> List[dict]:
        """Map watchdog alert dicts to triggers, deduped per alert
        name under the bank-level cooldown."""
        out: List[dict] = []
        for a in alerts or ():
            name = str(a.get("alert", "alert"))
            if now - self._alert_last.get(name, -math.inf) \
                    < self.alert_cooldown_s:
                continue
            self._alert_last[name] = now
            kind = "recompile" if name == "recompile_storm" else "slo"
            out.append({
                "detector": f"watchdog:{name}",
                "metric": name,
                "kind": kind,
                "reason": (f"watchdog alert {name} "
                           f"(severity={a.get('severity', '?')})"),
                "ts_s": now,
                "value": 1.0,
                "score": 1.0,
                "alert": dict(a),
            })
        return out

    def observe_iteration(self, now: float, live: Sequence[int],
                          advanced: Sequence[int]) -> List[dict]:
        if self.stall is None:
            return []
        return self.stall.observe_iteration(now, live, advanced)

    def states(self) -> Dict[str, str]:
        st = {d.name: d.state for d in self._detectors}
        if self.stall is not None:
            st[self.stall.name] = self.stall.state
        return st


def default_detector_bank() -> DetectorBank:
    """Conservative defaults: long warmups and high thresholds so a
    calm short bench storm never leaves warmup, plus an iteration-fed
    stall detector with a threshold far above any legitimate
    no-progress window (admission-blocked iterations on a saturated
    pool clear within a handful of steps)."""
    return DetectorBank(
        [
            EwmaZScoreDetector("queue_depth", threshold=8.0,
                               warmup=45),
            EwmaZScoreDetector("mfu", threshold=8.0, warmup=45),
        ],
        stall=StallDetector(threshold=200),
    )
