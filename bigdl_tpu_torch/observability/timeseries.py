"""Bounded in-process time series + the stdlib HTML dashboard, and their
fleet halves (port of ``bigdl_tpu/observability/timeseries.py``).

:class:`TimeSeriesSampler` runs one daemon thread that, every
``interval_s``, reads a set of named zero-arg sources (gauge getters,
derived rates, anything cheap and thread-safe) and appends
``(monotonic_ts, value)`` points into per-metric bounded rings.  The
engine serves the rings as JSON at ``GET /debug/timeseries?metric=&n=``
and renders them at ``GET /debug/dashboard`` via
:func:`render_dashboard` — one self-contained HTML document with inline
SVG sparklines, no external assets, viewable from ``curl`` output saved
to a file on an air-gapped pod.

Design points:

* **Bounded**: each ring is a ``deque(maxlen=capacity)`` — a week-long
  soak holds the same memory as a minute-long smoke test.
* **Counter rates**: a source registered with ``rate=True`` is read as
  a cumulative counter and stored as its per-second first difference
  (first sample primes the baseline and stores nothing).  A raw value
  that *decreases* means the counter reset underneath us (engine
  restart, registry swap, worker respawn behind the same name); the
  baseline re-primes and the point is dropped instead of emitting a
  large negative rate.
* **Disabled-registry no-op**: when the associated registry is
  disabled the sampler thread stays parked and ``sample()`` records
  nothing, matching the zero-overhead contract of the rest of the
  observability stack.
* **Lifecycle**: ``start()``/``stop()`` are idempotent; the engine
  starts the sampler with its loop thread and joins it in ``stop()``,
  so tests can assert no leaked threads.
"""

from __future__ import annotations

import html
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

__all__ = ["TimeSeriesSampler", "render_dashboard",
           "merge_fleet_timeseries", "render_fleet_dashboard"]


class TimeSeriesSampler:
    """Background sampler: named sources -> bounded (ts, value) rings.

    ``registry`` is optional; ``None`` resolves to the process default
    at sample time, and a disabled registry makes sampling a no-op.
    Sources must be cheap, thread-safe, and may return ``None`` to
    skip a point (e.g. MFU before the first warm dispatch).
    """

    def __init__(self, interval_s: float = 1.0, capacity: int = 600,
                 registry=None):
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self._registry = registry
        self._sources: Dict[str, tuple] = {}  # name -> (fn, rate)
        self._rings: Dict[str, deque] = {}
        self._last_raw: Dict[str, tuple] = {}  # rate baseline (ts, raw)
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._observer: Optional[Callable] = None
        #: samples an observer raised on — a torn detector must not
        #: kill the sampler thread, but the failures stay countable
        self.observer_errors = 0
        #: source reads that raised — a broken getter must not kill
        #: the pass, but silence would hide it forever
        self.source_errors = 0
        #: rate points dropped because the raw counter went backwards
        #: (the source restarted); each drop re-primed the baseline
        self.counter_resets = 0

    def set_observer(self, fn: Optional[Callable]
                     ) -> "TimeSeriesSampler":
        """Register ``fn(name, ts, value)`` to see every appended
        point (anomaly detectors hook in here).  Called OUTSIDE the
        ring lock — an observer may call ``snapshot()`` — and on the
        sampler thread, so it must stay cheap and must not raise
        (exceptions are swallowed).  Returns self for chaining."""
        self._observer = fn
        return self

    # -- sources -------------------------------------------------------
    def add_source(self, name: str, fn: Callable[[], Optional[float]],
                   rate: bool = False) -> "TimeSeriesSampler":
        """Register ``name``; ``rate=True`` differentiates a cumulative
        counter into per-second deltas.  Returns self for chaining."""
        with self._lock:
            self._sources[name] = (fn, bool(rate))
            self._rings.setdefault(name, deque(maxlen=self.capacity))
        return self

    @property
    def enabled(self) -> bool:
        reg = self._registry
        if reg is None:  # resolve the process default at use time
            from .metrics import default_registry
            reg = default_registry()
        return bool(getattr(reg, "enabled", True)) if reg is not None \
            else True

    # -- sampling ------------------------------------------------------
    def sample(self, now: Optional[float] = None) -> None:
        """Take one pass over every source (no-op when disabled)."""
        if not self.enabled:
            return
        ts = time.monotonic() if now is None else float(now)
        with self._lock:
            items = list(self._sources.items())
        appended = []
        for name, (fn, rate) in items:
            try:
                raw = fn()
            except Exception:
                self.source_errors += 1
                continue
            if raw is None:
                continue
            raw = float(raw)
            if rate:
                prev = self._last_raw.get(name)
                self._last_raw[name] = (ts, raw)
                if prev is None:
                    continue
                if raw < prev[1]:
                    # counter reset: the source restarted behind the
                    # same name — the delta is meaningless, so drop
                    # the point (the new baseline is already primed)
                    self.counter_resets += 1
                    continue
                dt = ts - prev[0]
                if dt <= 0.0:
                    continue
                value = (raw - prev[1]) / dt
            else:
                value = raw
            with self._lock:
                self._rings[name].append((ts, value))
            appended.append((name, value))
        obs = self._observer
        if obs is not None:
            # outside the ring lock on purpose: the observer may read
            # snapshot(), and _lock is not reentrant
            for name, value in appended:
                try:
                    obs(name, ts, value)
                except Exception:
                    self.observer_errors += 1

    # -- lifecycle -----------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "TimeSeriesSampler":
        if self.running:
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="bdt-timeseries", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            self.sample()

    # -- reads ---------------------------------------------------------
    def snapshot(self, metric: Optional[str] = None,
                 n: Optional[int] = None) -> dict:
        """JSON-ready view: ``{"interval_s", "capacity", "metrics":
        {name: {"points": [[ts, value], ...], "last": value}}}``.
        ``metric`` filters to one ring; ``n`` keeps the newest n
        points."""
        with self._lock:
            names = ([metric] if metric is not None
                     else sorted(self._rings))
            out = {}
            for name in names:
                ring = self._rings.get(name)
                if ring is None:
                    continue
                pts = list(ring)
                if n is not None and n >= 0:
                    pts = pts[-n:]
                out[name] = {
                    "points": [[round(t, 3), v] for t, v in pts],
                    "last": pts[-1][1] if pts else None,
                }
        return {"interval_s": self.interval_s, "capacity": self.capacity,
                "metrics": out}


def merge_fleet_timeseries(exports, fleet: str = "fleet") -> dict:
    """Fold per-replica sampler exports onto ONE clock-aligned fleet
    timeline.

    ``exports`` is a list of ``{"replica", "clock_offset_s",
    "export": <snapshot()>}`` entries (failed replicas carry
    ``{"replica", "error"}`` instead).  Each replica's points are
    shifted by its measured ``clock_offset_s`` — the min-RTT offset
    from :func:`fleettrace.estimate_clock_offset` that maps the
    worker's monotonic clock into the supervisor's — so one metric's
    rings from every replica land on a shared time axis.  The shift
    is a constant per export, so within-replica monotonic order is
    preserved by construction.

    Returns ``{"fleet", "interval_s", "replicas", "clock": {replica:
    offset_s}, "errors": {replica: msg}, "metrics": {name:
    {"replicas": {replica: {"points", "last"}}, "fleet": {"sum":
    [[ts, v], ...], "mean": ...}}}}``.  The derived fleet series bin
    aligned timestamps at the sampler interval and take, per bin, the
    newest value each replica contributed; non-finite values are
    dropped so one NaN ring cannot poison the fleet sum.
    """
    interval = 0.0
    clock: Dict[str, float] = {}
    errors: Dict[str, str] = {}
    metrics: Dict[str, dict] = {}
    replicas = []
    for ent in exports or []:
        rid = str(ent.get("replica", "?"))
        if ent.get("error"):
            errors[rid] = str(ent["error"])
            continue
        exp = ent.get("export") or {}
        off = float(ent.get("clock_offset_s") or 0.0)
        clock[rid] = off
        replicas.append(rid)
        interval = max(interval, float(exp.get("interval_s") or 0.0))
        for name, series in (exp.get("metrics") or {}).items():
            pts = []
            for p in series.get("points") or []:
                try:
                    t, v = float(p[0]), p[1]
                except (TypeError, ValueError, IndexError):
                    continue
                if v is None:
                    continue
                v = float(v)
                if not math.isfinite(v):
                    continue
                pts.append([round(t + off, 3), v])
            slot = metrics.setdefault(name, {"replicas": {}})
            slot["replicas"][rid] = {
                "points": pts,
                "last": pts[-1][1] if pts else None,
            }
    step = interval or 1.0
    for slot in metrics.values():
        # bin -> {replica: (aligned_ts, newest value in bin)}
        bins: Dict[int, dict] = {}
        for rid, series in slot["replicas"].items():
            for t, v in series["points"]:
                bins.setdefault(int(t // step), {})[rid] = (t, v)
        sum_pts, mean_pts = [], []
        for b in sorted(bins):
            per = bins[b]
            ts = round(max(t for t, _ in per.values()), 3)
            vals = [v for _, v in per.values()]
            sum_pts.append([ts, sum(vals)])
            mean_pts.append([ts, sum(vals) / len(vals)])
        slot["fleet"] = {"sum": sum_pts, "mean": mean_pts}
    return {"fleet": fleet, "interval_s": step,
            "replicas": sorted(replicas), "clock": clock,
            "errors": errors, "metrics": metrics}


#: marker stroke by event kind (unknown kinds fall back to "alert")
_MARKER_COLORS = {"incident": "#c53030", "alert": "#dd6b20",
                  "drain": "#6b46c1", "rejoin": "#2f855a"}

#: per-replica polyline strokes for the fleet dashboard overlays
_REPLICA_PALETTE = ("#2b6cb0", "#2f855a", "#b7791f", "#6b46c1",
                    "#c05621", "#2c7a7b", "#97266d", "#4a5568")


def _sparkline(points, width: int = 280, height: int = 48,
               markers=None) -> str:
    """One inline-SVG sparkline for a [[ts, value], ...] series.
    ``markers`` is an optional list of ``{"ts_s": .., "kind": ..}``
    dicts; each one whose timestamp lies inside the series' time span
    draws a vertical rule (red for incidents, orange for alerts)."""
    vals = [p[1] for p in points if p[1] is not None]
    if len(vals) < 2:
        return ("<svg width='%d' height='%d'><text x='4' y='%d' "
                "class='empty'>no data yet</text></svg>"
                % (width, height, height // 2 + 4))
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    pad = 3
    step = (width - 2 * pad) / (len(vals) - 1)
    pts = " ".join(
        "%.1f,%.1f" % (pad + i * step,
                       height - pad - (v - lo) / span * (height - 2 * pad))
        for i, v in enumerate(vals))
    rules = []
    t0, t1 = points[0][0], points[-1][0]
    if markers and t1 > t0:
        for mk in markers:
            ts = mk.get("ts_s")
            if ts is None or not (t0 <= ts <= t1):
                continue
            x = pad + (ts - t0) / (t1 - t0) * (width - 2 * pad)
            color = _MARKER_COLORS.get(
                mk.get("kind"), _MARKER_COLORS["alert"])
            rules.append(
                "<line x1='%.1f' y1='0' x2='%.1f' y2='%d' "
                "stroke='%s' stroke-width='1' "
                "stroke-dasharray='2,2'/>" % (x, x, height, color))
    return ("<svg width='%d' height='%d' viewBox='0 0 %d %d'>%s"
            "<polyline fill='none' stroke='#2b6cb0' stroke-width='1.5' "
            "points='%s'/></svg>" % (width, height, width, height,
                                     "".join(rules), pts))


def _marker_rules(markers, t0: float, t1: float, width: int,
                  height: int, pad: int = 3) -> str:
    """Vertical dashed rules for every marker inside [t0, t1]."""
    if not markers or t1 <= t0:
        return ""
    rules = []
    for mk in markers:
        ts = mk.get("ts_s")
        if ts is None or not (t0 <= ts <= t1):
            continue
        x = pad + (ts - t0) / (t1 - t0) * (width - 2 * pad)
        color = _MARKER_COLORS.get(mk.get("kind"),
                                   _MARKER_COLORS["alert"])
        rules.append(
            "<line x1='%.1f' y1='0' x2='%.1f' y2='%d' stroke='%s' "
            "stroke-width='1' stroke-dasharray='2,2'/>"
            % (x, x, height, color))
    return "".join(rules)


def _multi_sparkline(series, width: int = 280, height: int = 48,
                     markers=None) -> str:
    """One inline-SVG sparkline overlaying several replicas' series.
    ``series`` is an ordered list of ``(color, [[ts, value], ...])``
    pairs (an optional third ``dasharray`` element styles derived
    series like the fleet mean) sharing one time axis and one value
    scale, so diverging replicas are visible at a glance."""
    flat = [(t, v) for entry in series for t, v in entry[1]
            if v is not None]
    if len(flat) < 2:
        return ("<svg width='%d' height='%d'><text x='4' y='%d' "
                "class='empty'>no data yet</text></svg>"
                % (width, height, height // 2 + 4))
    lo = min(v for _, v in flat)
    hi = max(v for _, v in flat)
    span = (hi - lo) or 1.0
    t0 = min(t for t, _ in flat)
    t1 = max(t for t, _ in flat)
    tspan = (t1 - t0) or 1.0
    pad = 3
    lines = []
    for entry in series:
        color, pts = entry[0], entry[1]
        dash = entry[2] if len(entry) > 2 else None
        pts = [p for p in pts if p[1] is not None]
        if len(pts) < 2:
            continue
        poly = " ".join(
            "%.1f,%.1f" % (
                pad + (t - t0) / tspan * (width - 2 * pad),
                height - pad - (v - lo) / span * (height - 2 * pad))
            for t, v in pts)
        style = (" stroke-dasharray='%s'" % dash) if dash else ""
        lines.append(
            "<polyline fill='none' stroke='%s' stroke-width='1.2'%s "
            "points='%s'/>" % (color, style, poly))
    rules = _marker_rules(markers, t0, t1, width, height, pad)
    return ("<svg width='%d' height='%d' viewBox='0 0 %d %d'>%s%s"
            "</svg>" % (width, height, width, height, rules,
                        "".join(lines)))


def _budget_bars(budgets) -> str:
    """Horizontal SLO budget bars: ``budgets`` is a list of dicts with
    at least ``objective`` and ``budget_remaining`` (0..1); optional
    ``replica`` and ``exhaustion_eta_s`` enrich the label.  Green
    above half a budget, orange down to a quarter, red below."""
    rows = []
    for b in budgets or []:
        rem = b.get("budget_remaining")
        if rem is None:
            continue
        rem = max(0.0, min(1.0, float(rem)))
        color = ("#2f855a" if rem >= 0.5
                 else "#dd6b20" if rem >= 0.25 else "#c53030")
        label = str(b.get("objective") or b.get("name") or "slo")
        if b.get("replica"):
            label = "%s · %s" % (b["replica"], label)
        eta = b.get("exhaustion_eta_s")
        if rem <= 0.0:
            tail = " — EXHAUSTED"
        elif eta is not None:
            tail = " — exhausts in %.0fs" % float(eta)
        else:
            tail = ""
        rows.append(
            "<div class='budget'><span class='bname'>%s</span>"
            "<svg width='180' height='12'>"
            "<rect width='180' height='12' fill='#eee'/>"
            "<rect width='%.1f' height='12' fill='%s'/></svg>"
            "<span class='bval'>%.0f%%%s</span></div>"
            % (html.escape(label), 180 * rem, color, 100 * rem,
               html.escape(tail)))
    if not rows:
        return ""
    return ("<details open><summary>SLO error budgets</summary>"
            "<div class='budgets'>%s</div></details>" % "".join(rows))


def _fmt(v) -> str:
    if v is None:
        return "–"
    if isinstance(v, float):
        if v != 0 and (abs(v) >= 1e5 or abs(v) < 1e-3):
            return "%.3e" % v
        return "%.4g" % v
    return str(v)


def render_dashboard(snapshot: dict, title: str = "engine",
                     extra: Optional[dict] = None,
                     markers=None, budgets=None) -> str:
    """Render a sampler snapshot (plus optional ``extra`` blocks like
    alerts / cost / loop summaries) into ONE self-contained HTML page:
    stdlib string formatting, inline CSS, inline SVG sparklines, zero
    external assets.  ``markers`` (``[{"ts_s", "kind", "label"}]`` —
    captured incidents and fired alerts) draw vertical rules on every
    sparkline at the moment each event happened; ``budgets`` (the
    per-objective list from ``SloBudgetTracker.state()``) draws error
    budget bars under the sparkline grid."""
    extra = extra or {}
    cards = []
    for name in sorted(snapshot.get("metrics", {})):
        series = snapshot["metrics"][name]
        cards.append(
            "<div class='card'><div class='name'>%s</div>"
            "<div class='last'>%s</div>%s</div>"
            % (html.escape(name), _fmt(series.get("last")),
               _sparkline(series.get("points", []), markers=markers)))
    if markers:
        legend = "; ".join(
            "%s@%.1fs (%s)" % (html.escape(str(
                mk.get("label") or mk.get("kind") or "event")),
                mk.get("ts_s") or 0.0,
                html.escape(str(mk.get("kind") or "alert")))
            for mk in markers[-12:])
        extra = dict(extra)
        extra.setdefault("markers", legend)
    blocks = []
    for key in sorted(extra):
        val = extra[key]
        if val is None:
            continue
        try:
            import json as _json
            body = html.escape(_json.dumps(val, indent=2, default=str))
        except Exception:
            body = html.escape(repr(val))
        blocks.append("<details open><summary>%s</summary><pre>%s</pre>"
                      "</details>" % (html.escape(str(key)), body))
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<meta http-equiv='refresh' content='5'>"
        "<title>bigdl_tpu_torch dashboard — %(title)s</title><style>"
        "body{font-family:system-ui,sans-serif;margin:1.2em;"
        "background:#fafafa;color:#222}"
        "h1{font-size:1.2em}"
        ".grid{display:flex;flex-wrap:wrap;gap:12px}"
        ".card{background:#fff;border:1px solid #ddd;border-radius:6px;"
        "padding:8px 12px}"
        ".name{font-size:.8em;color:#555}"
        ".last{font-size:1.3em;font-weight:600}"
        ".empty{fill:#999;font-size:.7em}"
        ".budget{display:flex;align-items:center;gap:8px;"
        "padding:2px 0;font-size:.85em}"
        ".bname{min-width:14em;color:#555}"
        "pre{background:#fff;border:1px solid #ddd;border-radius:6px;"
        "padding:8px;font-size:.8em;overflow-x:auto}"
        "</style></head><body>"
        "<h1>bigdl_tpu_torch dashboard — %(title)s</h1>"
        "<div class='grid'>%(cards)s</div>%(budgets)s%(blocks)s"
        "<p style='color:#888;font-size:.75em'>self-contained page, "
        "auto-refreshes every 5s; raw data at "
        "<code>/debug/timeseries</code></p>"
        "</body></html>"
        % {"title": html.escape(title), "cards": "".join(cards),
           "budgets": _budget_bars(budgets),
           "blocks": "".join(blocks)})


def render_fleet_dashboard(merged: dict, title: Optional[str] = None,
                           extra: Optional[dict] = None,
                           markers=None, budgets=None) -> str:
    """Render a :func:`merge_fleet_timeseries` result into one
    self-contained HTML page: one row per metric with every replica's
    ring overlaid on the shared clock-aligned axis (plus the dashed
    fleet mean), incident/drain markers as vertical rules, and SLO
    budget bars.  Same zero-asset contract as
    :func:`render_dashboard` — viewable from saved ``curl`` output."""
    extra = dict(extra or {})
    replicas = list(merged.get("replicas") or [])
    color_of = {rid: _REPLICA_PALETTE[i % len(_REPLICA_PALETTE)]
                for i, rid in enumerate(replicas)}
    legend = " ".join(
        "<span class='chip' style='border-color:%s;color:%s'>%s"
        "</span>" % (color_of[rid], color_of[rid], html.escape(rid))
        for rid in replicas)
    rows = []
    for name in sorted(merged.get("metrics", {})):
        slot = merged["metrics"][name]
        series = [(color_of.get(rid, "#888"),
                   (slot["replicas"].get(rid) or {}).get("points", []))
                  for rid in replicas]
        mean = (slot.get("fleet") or {}).get("mean") or []
        if len(replicas) > 1:
            series.append(("#718096", mean, "4,3"))
        last = mean[-1][1] if mean else None
        cells = "".join(
            "<td class='rlast' style='color:%s'>%s</td>"
            % (color_of.get(rid, "#888"),
               _fmt((slot["replicas"].get(rid) or {}).get("last")))
            for rid in replicas)
        rows.append(
            "<tr><td class='name'>%s</td>"
            "<td>%s</td><td class='last'>%s</td>%s</tr>"
            % (html.escape(name),
               _multi_sparkline(series, markers=markers),
               _fmt(last), cells))
    head = "".join("<th style='color:%s'>%s</th>"
                   % (color_of[rid], html.escape(rid))
                   for rid in replicas)
    if merged.get("errors"):
        extra.setdefault("replica_errors", merged["errors"])
    if markers:
        extra.setdefault("markers", "; ".join(
            "%s@%.1fs (%s)" % (html.escape(str(
                mk.get("label") or mk.get("kind") or "event")),
                mk.get("ts_s") or 0.0,
                html.escape(str(mk.get("kind") or "alert")))
            for mk in markers[-12:]))
    blocks = []
    for key in sorted(extra):
        val = extra[key]
        if val is None:
            continue
        try:
            import json as _json
            body = html.escape(_json.dumps(val, indent=2, default=str))
        except Exception:
            body = html.escape(repr(val))
        blocks.append("<details><summary>%s</summary><pre>%s</pre>"
                      "</details>" % (html.escape(str(key)), body))
    title = title or str(merged.get("fleet") or "fleet")
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<meta http-equiv='refresh' content='5'>"
        "<title>bigdl_tpu_torch fleet — %(title)s</title><style>"
        "body{font-family:system-ui,sans-serif;margin:1.2em;"
        "background:#fafafa;color:#222}"
        "h1{font-size:1.2em}"
        "table{border-collapse:collapse;background:#fff;"
        "border:1px solid #ddd;border-radius:6px}"
        "td,th{padding:4px 10px;border-bottom:1px solid #eee;"
        "font-size:.85em;text-align:left}"
        ".name{color:#555}"
        ".last{font-weight:600}"
        ".empty{fill:#999;font-size:.7em}"
        ".chip{border:1px solid;border-radius:4px;padding:1px 6px;"
        "font-size:.8em;margin-right:4px}"
        ".budget{display:flex;align-items:center;gap:8px;"
        "padding:2px 0;font-size:.85em}"
        ".bname{min-width:14em;color:#555}"
        "pre{background:#fff;border:1px solid #ddd;border-radius:6px;"
        "padding:8px;font-size:.8em;overflow-x:auto}"
        "</style></head><body>"
        "<h1>bigdl_tpu_torch fleet dashboard — %(title)s</h1>"
        "<p>%(legend)s</p>"
        "<table><tr><th>metric</th><th>clock-aligned overlay</th>"
        "<th>fleet mean</th>%(head)s</tr>%(rows)s</table>"
        "%(budgets)s%(blocks)s"
        "<p style='color:#888;font-size:.75em'>self-contained page, "
        "auto-refreshes every 5s; raw data at "
        "<code>/debug/fleet/timeseries</code></p>"
        "</body></html>"
        % {"title": html.escape(title), "legend": legend,
           "head": head, "rows": "".join(rows),
           "budgets": _budget_bars(budgets),
           "blocks": "".join(blocks)})
