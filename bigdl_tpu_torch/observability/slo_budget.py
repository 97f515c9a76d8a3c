"""Multi-window SLO error-budget accounting over live histograms.

``SloWatchdog`` answers "is the objective burning RIGHT NOW" — one
window, one threshold, a boolean alert. Operating a fleet needs the
complementary, Google-SRE-style ledger view: how much of the error
budget is LEFT over the budget window, how fast it is being spent
over a fast/slow window pair (page on fast, ticket on slow), and when
it runs out at the current rate. :class:`SloBudgetTracker` computes
exactly that from the same histogram children the watchdog reads:

- Per objective ("``target`` of observations under ``threshold_s``"),
  the trailing ``budget_window_s`` allows ``(1 - target)`` of the
  window's observations to be bad; ``budget_remaining`` is the
  unspent fraction of that allowance, ``exhaustion_eta_s`` divides
  what is left by the current (fastest-window) burn rate.
- Each configured window reports its own burn rate
  (``bad_fraction / (1 - target)``) so alerting policy can pair a
  fast window (catches cliffs) with a slow one (catches bleeds).
- Per priority class: latency histograms are not class-labelled, so
  the engine feeds first-token latencies straight in via
  :meth:`SloBudgetTracker.observe_class` and the tracker keeps a
  per-class good/total ledger against the TTFT threshold — the view
  that shows a QoS storm spending the low class's budget while the
  high class's stays whole.
- Chaos drills: ``sample(forced=True)`` (the engine passes its
  ``ChaosInjector.burn_active()`` flag) spends budget synthetically
  at ``forced_burn_rate`` so the exhaustion path — budget to zero,
  gauges pinned, then recovery as the spend ages out of the window —
  is drillable without torturing real latencies.

Everything is host-side Python on snapshot deltas — no jax, no device
work, safe on the decode loop's observe phase. Exported as the
``bdt_slo_budget_remaining{objective,service}`` and
``bdt_slo_budget_burn_rate{objective,service,window}`` gauges,
``stats()["slo_budget"]``, and budget bars on both dashboards.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, List, Optional, Tuple

from .watchdog import SloObjective

__all__ = ["SloBudgetTracker", "DEFAULT_BURN_WINDOWS"]

#: Google-SRE-style fast/slow pairing, scaled to serving-loop time:
#: the fast window catches cliffs within a minute, the slow window
#: catches bleeds that individual spikes hide.
DEFAULT_BURN_WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("fast", 60.0), ("slow", 480.0))


class _BudgetState:
    """One objective's snapshot ledger (mirrors the watchdog's
    ``_ObjectiveState`` bucket-edge pessimism: the good edge is the
    largest histogram edge <= threshold, so quantization over-spends
    budget rather than hiding a breach)."""

    __slots__ = ("obj", "child", "good_idx", "snaps",
                 "remaining_gauge", "burn_gauges",
                 "burns", "remaining", "eta", "observations", "bad")

    def __init__(self, obj: SloObjective, child):
        import bisect

        self.obj = obj
        self.child = child
        buckets = child._metric.buckets
        idx = bisect.bisect_right(buckets, obj.threshold_s) - 1
        self.good_idx = idx if idx >= 0 else None
        #: trailing (ts, good_cum, total_cum) snapshots
        self.snaps: Deque[Tuple[float, int, int]] = collections.deque()
        self.remaining_gauge = None
        self.burn_gauges: Dict[str, object] = {}
        self.burns: Dict[str, float] = {}
        self.remaining = 1.0
        self.eta: Optional[float] = None
        self.observations = 0
        self.bad = 0


class SloBudgetTracker:
    """Error-budget ledger over watched :class:`SloObjective`s.

    ``windows`` is the ordered ``(name, seconds)`` burn-window pairing
    (first = fastest, used for the exhaustion ETA when it burns
    hottest); ``budget_window_s`` is the period the budget amortizes
    over; ``forced_burn_rate`` is the synthetic burn multiple a chaos
    drill spends at while ``sample(forced=True)``.
    """

    def __init__(self, service: str = "engine",
                 windows: Tuple[Tuple[str, float], ...]
                 = DEFAULT_BURN_WINDOWS,
                 budget_window_s: float = 3600.0,
                 forced_burn_rate: float = 12.0,
                 registry=None, recorder=None):
        from bigdl_tpu_torch.observability.events import default_recorder
        from bigdl_tpu_torch.observability.instruments import (
            watchdog_instruments,
        )

        if budget_window_s <= 0:
            raise ValueError(
                f"budget_window_s must be > 0, got {budget_window_s}")
        self.service = service
        self.windows = tuple((str(n), float(s)) for n, s in windows)
        if not self.windows:
            raise ValueError("windows must name at least one window")
        self.budget_window_s = float(budget_window_s)
        self.forced_burn_rate = float(forced_burn_rate)
        self._ins = watchdog_instruments(registry)
        self._rec = recorder if recorder is not None \
            else default_recorder()
        self._states: List[_BudgetState] = []
        # snapshot spacing: fine enough for the fastest window, deque
        # bounded over the whole budget window (~4k entries worst case)
        fastest = min(s for _, s in self.windows)
        self._spacing = max(fastest / 128.0,
                            self.budget_window_s / 4096.0)
        #: synthetic chaos spend as (ts, fraction) — pruned past the
        #: budget window so an ended drill RECOVERS on its own
        self._forced_spend: Deque[Tuple[float, float]] = \
            collections.deque()
        self._forced_last: Optional[float] = None
        self._forced_active = False
        #: per-priority-class cumulative (good, total) vs the TTFT
        #: threshold, fed by observe_class (histograms carry no class
        #: label, so the engine feeds first-token latencies directly)
        self._class_threshold_s: Optional[float] = None
        self._class_cum: Dict[str, List[int]] = {}
        self._class_snaps: Dict[str, Deque[Tuple[float, int, int]]] = {}

    # -- binding -------------------------------------------------------
    def watch(self, objective: SloObjective, histogram_child
              ) -> "SloBudgetTracker":
        """Bind one objective to a live histogram child (same
        signature as ``SloWatchdog.watch``)."""
        st = _BudgetState(objective, histogram_child)
        st.remaining_gauge = self._ins.budget_remaining.labels(
            objective.name, self.service)
        st.remaining_gauge.set(1.0)
        for wname, _ in self.windows:
            st.burn_gauges[wname] = self._ins.budget_burn_rate.labels(
                objective.name, self.service, wname)
        self._states.append(st)
        if self._class_threshold_s is None and (
                objective.metric in (None, "ttft")):
            self._class_threshold_s = objective.threshold_s
        return self

    @property
    def objectives(self) -> List[SloObjective]:
        return [s.obj for s in self._states]

    # -- per-class feed ------------------------------------------------
    def observe_class(self, priority: str, value_s: float) -> None:
        """Record one first-token latency for a priority class; judged
        against the TTFT objective's threshold."""
        thr = self._class_threshold_s
        if thr is None:
            return
        cum = self._class_cum.setdefault(str(priority), [0, 0])
        cum[1] += 1
        if value_s <= thr:
            cum[0] += 1

    # -- sampling ------------------------------------------------------
    def sample(self, now: Optional[float] = None,
               forced: bool = False) -> None:
        """Snapshot every objective and re-evaluate burns + budget.
        ``forced=True`` (a live chaos burn drill) additionally spends
        budget synthetically at ``forced_burn_rate``."""
        now = time.monotonic() if now is None else float(now)
        self._accrue_forced(now, forced)
        for st in self._states:
            cum, _sum, count = st.child.get()
            good = cum[st.good_idx] if st.good_idx is not None else 0
            if (not st.snaps
                    or now - st.snaps[-1][0] >= self._spacing):
                st.snaps.append((now, good, count))
            # keep one snapshot at-or-beyond the budget-window edge as
            # the oldest baseline any window can need
            while (len(st.snaps) > 1
                   and st.snaps[1][0] <= now - self.budget_window_s):
                st.snaps.popleft()
            self._evaluate(st, now, good, count)
        for cls, cum in self._class_cum.items():
            snaps = self._class_snaps.setdefault(
                cls, collections.deque())
            if not snaps:
                # seed a zero baseline: the class's first
                # observations land BEFORE its first snapshot, and a
                # baseline that already contains them would hide them
                # from the delta forever
                snaps.append((now, 0, 0))
            elif now - snaps[-1][0] >= self._spacing:
                snaps.append((now, cum[0], cum[1]))
            while (len(snaps) > 1
                   and snaps[1][0] <= now - self.budget_window_s):
                snaps.popleft()

    def _accrue_forced(self, now: float, forced: bool) -> None:
        if forced:
            last = self._forced_last if self._forced_active else None
            dt = max(0.0, now - last) if last is not None else 0.0
            if dt > 0.0:
                self._forced_spend.append(
                    (now, dt * self.forced_burn_rate
                     / self.budget_window_s))
            if not self._forced_active:
                self._rec.record("slo_budget/forced_burn_start",
                                 service=self.service,
                                 burn_rate=self.forced_burn_rate)
        elif self._forced_active:
            self._rec.record("slo_budget/forced_burn_end",
                             service=self.service)
        self._forced_active = forced
        self._forced_last = now
        while (self._forced_spend
               and self._forced_spend[0][0]
               <= now - self.budget_window_s):
            self._forced_spend.popleft()

    @staticmethod
    def _baseline(snaps, edge: float):
        """Newest snapshot at-or-before ``edge`` (falls back to the
        oldest retained — a window longer than history measures what
        history there is)."""
        base = snaps[0]
        for snap in snaps:
            if snap[0] <= edge:
                base = snap
            else:
                break
        return base

    def _evaluate(self, st: _BudgetState, now: float,
                  good: int, count: int) -> None:
        err = max(1.0 - st.obj.target, 1e-9)
        burns = {}
        for wname, wsecs in self.windows:
            _ts, bgood, bcount = self._baseline(st.snaps, now - wsecs)
            d_total = count - bcount
            d_good = good - bgood
            if d_total < st.obj.min_count:
                burn = 0.0
            else:
                burn = ((d_total - d_good) / d_total) / err
            burns[wname] = burn
            st.burn_gauges[wname].set(burn)
        forced_spend = sum(a for _, a in self._forced_spend)
        if self._forced_active:
            # the drill's synthetic rate dominates the reported burn
            # so the ETA points at the drill, not at calm traffic
            for wname in burns:
                burns[wname] = max(burns[wname], self.forced_burn_rate)
        st.burns = burns
        _ts, bgood, bcount = self._baseline(
            st.snaps, now - self.budget_window_s)
        d_total = count - bcount
        d_good = good - bgood
        st.observations = d_total
        st.bad = d_total - d_good
        allowed = err * max(d_total, st.obj.min_count)
        spent = (st.bad / allowed if allowed > 0 else 0.0) \
            + forced_spend
        st.remaining = max(0.0, min(1.0, 1.0 - spent))
        st.remaining_gauge.set(st.remaining)
        peak = max(burns.values()) if burns else 0.0
        st.eta = (st.remaining * self.budget_window_s / peak
                  if peak > 0.0 and st.remaining > 0.0 else None)

    # -- reads ---------------------------------------------------------
    def state(self) -> dict:
        """JSON-ready ledger: the ``stats()["slo_budget"]`` block."""
        objectives = []
        for st in self._states:
            objectives.append({
                "objective": st.obj.name,
                "metric": st.obj.metric,
                "target": st.obj.target,
                "threshold_s": st.obj.threshold_s,
                "windows": {
                    wname: {"window_s": wsecs,
                            "burn_rate": round(
                                st.burns.get(wname, 0.0), 4)}
                    for wname, wsecs in self.windows},
                "budget_remaining": round(st.remaining, 4),
                "exhausted": st.remaining <= 0.0,
                "exhaustion_eta_s":
                    round(st.eta, 1) if st.eta is not None else None,
                "observations": st.observations,
                "bad": st.bad,
            })
        classes = {}
        thr = self._class_threshold_s
        for cls in sorted(self._class_cum):
            cgood, ctotal = self._class_cum[cls]
            snaps = self._class_snaps.get(cls)
            bgood, bcount = (snaps[0][1], snaps[0][2]) if snaps \
                else (0, 0)
            d_total = ctotal - bcount
            d_good = cgood - bgood
            # per-class budget reuses the tightest watched target (the
            # classes share the fleet's objective, not private ones)
            target = (self._states[0].obj.target if self._states
                      else 0.99)
            err = max(1.0 - target, 1e-9)
            min_count = (self._states[0].obj.min_count
                         if self._states else 20)
            allowed = err * max(d_total, min_count)
            bad = d_total - d_good
            remaining = max(0.0, min(1.0, 1.0 - (
                bad / allowed if allowed > 0 else 0.0)))
            classes[cls] = {
                "threshold_s": thr,
                "observations": d_total,
                "bad": bad,
                "budget_remaining": round(remaining, 4),
            }
        remaining_min = min(
            [o["budget_remaining"] for o in objectives] or [1.0])
        return {
            "service": self.service,
            "budget_window_s": self.budget_window_s,
            "forced_burn_active": self._forced_active,
            "objectives": objectives,
            "classes": classes,
            "remaining_min": remaining_min,
        }

    def budget_bars(self) -> List[dict]:
        """The ``budgets=`` payload both dashboard renderers take."""
        bars = []
        for st in self._states:
            bars.append({"objective": st.obj.name,
                         "budget_remaining": st.remaining,
                         "exhaustion_eta_s": st.eta})
        for cls, ledger in sorted(self.state()["classes"].items()):
            bars.append({"objective": "class:%s" % cls,
                         "budget_remaining":
                             ledger["budget_remaining"]})
        return bars
