"""Thread-safe metrics registry: Counter / Gauge / Histogram with labels
(port of ``bigdl_tpu/observability/metrics.py``).

The analog of the reference's first-class metrics subsystem
(optim/Metrics.scala:31-121 — Spark-accumulator counters with local
atomics): one process-wide registry of named instruments that every
layer (train loop, serving services, parallel engine) feeds, and every
exporter (Prometheus text, HTTP endpoint, TensorBoard bridge —
``observability/exporters.py``) reads uniformly.

Design points:

- **Get-or-create**: ``registry.counter(name, ...)`` returns the
  existing instrument when the name is already registered (type and
  label names must match — a mismatch raises), so independent call
  sites share one time series without coordination.
- **Labels**: an instrument declared with ``labelnames`` is a family;
  ``family.labels(v1, ...)`` / ``labels(name=value)`` returns the child
  holding the actual value. Children are cached per label tuple.
- **Near-zero cost when disabled**: every mutation checks one boolean
  before taking any lock; ``registry.disable()`` turns the whole
  subsystem into no-ops (the acceptance bar: < 2% of step time with
  exporters off — disabled it is a dict-attribute read per call).
- **Thread safety**: one lock per child; the registry lock only guards
  registration and collection, never the hot path.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

#: Prometheus's default duration buckets (seconds) — right edges; +Inf is
#: implicit in every histogram.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


_METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")


def _check_name(name: str) -> str:
    """Prometheus metric-name charset — fail at registration, not with a
    scraper-side parse error of the whole /metrics page."""
    if not isinstance(name, str) or not _METRIC_NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r} (expected "
                         "[a-zA-Z_:][a-zA-Z0-9_:]*)")
    return name


def _check_label_name(name: str) -> str:
    if not isinstance(name, str) or not _LABEL_NAME_RE.match(name):
        raise ValueError(f"invalid label name {name!r} (expected "
                         "[a-zA-Z_][a-zA-Z0-9_]*)")
    return name


class _Child:
    """One (instrument, label values) time series."""

    __slots__ = ("_metric", "_lock", "labels_kv")

    def __init__(self, metric: "Metric", labels_kv: Tuple[Tuple[str, str], ...]):
        self._metric = metric
        self._lock = threading.Lock()
        self.labels_kv = labels_kv

    @property
    def _enabled(self) -> bool:
        return self._metric._registry._enabled


class CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, metric, labels_kv):
        super().__init__(metric, labels_kv)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        # validate BEFORE the enabled check: a negative-increment caller
        # bug must not pass silently with metrics off only to raise in a
        # hot loop once they are turned on
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        if not self._enabled:
            return
        with self._lock:
            self._value += amount

    def get(self) -> float:
        with self._lock:
            return self._value


class GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, metric, labels_kv):
        super().__init__(metric, labels_kv)
        self._value = 0.0

    def set(self, value: float, force: bool = False) -> None:
        """``force=True`` records even while the registry is disabled —
        for one-shot topology/config gauges set at init, which would
        otherwise freeze at 0 if observability were enabled later."""
        if not force and not self._enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_to_current_time(self) -> None:
        self.set(time.time())

    def track(self, amount: float = 1.0):
        """Context manager: inc on entry, dec on exit. The exit mutation
        mirrors the ENTRY's enabled decision, so a disable()/enable()
        toggle straddling the block can never leave the gauge skewed
        (the paired inc/dec would otherwise each check the flag
        independently)."""
        return _GaugeTracker(self, amount)

    def get(self) -> float:
        with self._lock:
            return self._value


class _GaugeTracker:
    __slots__ = ("_child", "_amount", "_did")

    def __init__(self, child: "GaugeChild", amount: float):
        self._child = child
        self._amount = amount

    def __enter__(self):
        self._did = self._child._enabled
        if self._did:
            with self._child._lock:
                self._child._value += self._amount
        return self

    def __exit__(self, *exc):
        if self._did:
            with self._child._lock:
                self._child._value -= self._amount
        return False


class HistogramChild(_Child):
    __slots__ = ("_counts", "_sum", "_count")

    def __init__(self, metric, labels_kv):
        super().__init__(metric, labels_kv)
        self._counts = [0] * (len(metric.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        if not self._enabled:
            return
        value = float(value)
        buckets = self._metric.buckets
        i = 0
        n = len(buckets)
        while i < n and value > buckets[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def time(self):
        """Context manager observing the wall time of the with-block."""
        return _HistogramTimer(self)

    def get(self):
        """(cumulative bucket counts aligned to buckets + (+Inf), sum,
        count) — cumulative per the Prometheus exposition contract."""
        with self._lock:
            counts = list(self._counts)
            total_sum, count = self._sum, self._count
        cum = []
        running = 0
        for c in counts:
            running += c
            cum.append(running)
        return cum, total_sum, count


class _HistogramTimer:
    __slots__ = ("_child", "_t0")

    def __init__(self, child: HistogramChild):
        self._child = child

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.perf_counter() - self._t0)
        return False


_CHILD_CLASSES = {"counter": CounterChild, "gauge": GaugeChild,
                  "histogram": HistogramChild}


class Metric:
    """One named instrument family: its children are the actual time
    series (one per label-value tuple; the no-label family has exactly
    one child, and the family itself proxies its mutators)."""

    def __init__(self, registry: "MetricRegistry", mtype: str, name: str,
                 help: str, labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self._registry = registry
        self.type = mtype
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            _check_label_name(ln)
        if mtype == "histogram":
            bs = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
            if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
                raise ValueError(f"histogram buckets must be sorted and "
                                 f"unique, got {bs}")
            self.buckets = bs
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:  # the single anonymous child
            self._default = self._make_child(())

    def _make_child(self, values: Tuple[str, ...]) -> _Child:
        kv = tuple(zip(self.labelnames, values))
        return _CHILD_CLASSES[self.type](self, kv)

    def labels(self, *values, **kv) -> _Child:
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "name, not both")
            try:
                values = tuple(str(kv[ln]) for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}; "
                                 f"expected {self.labelnames}") from e
            if len(kv) != len(self.labelnames):
                raise ValueError(f"unexpected labels for {self.name}: "
                                 f"{sorted(set(kv) - set(self.labelnames))}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label value(s) "
                f"{self.labelnames}, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child(values)
                self._children[values] = child
            return child

    def children(self):
        """Snapshot of (label-values tuple, child) pairs (the anonymous
        child shows as ``()``)."""
        if not self.labelnames:
            return [((), self._default)]
        with self._lock:
            return sorted(self._children.items())

    # The no-label family proxies its single child so ``registry.counter
    # ("x", "...").inc()`` works without a labels() hop.
    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             "call .labels(...) first")
        return self._default

    def inc(self, amount: float = 1.0):
        self._only().inc(amount)

    def dec(self, amount: float = 1.0):
        self._only().dec(amount)

    def set(self, value: float, force: bool = False):
        self._only().set(value, force=force)

    def observe(self, value: float):
        self._only().observe(value)

    def time(self):
        return self._only().time()

    def track(self, amount: float = 1.0):
        return self._only().track(amount)

    def get(self):
        return self._only().get()


class MetricRegistry:
    """Process-wide instrument table. ``counter``/``gauge``/``histogram``
    get-or-create by name; ``collect()`` snapshots for exporters."""

    def __init__(self, enabled: bool = True):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self._enabled = enabled

    # ------------------------------------------------------------- switch
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        """Turn every instrument mutation into a no-op (one boolean check,
        no locks — the 'near-zero cost when disabled' contract)."""
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    # ------------------------------------------------------- registration
    def _get_or_create(self, mtype: str, name: str, help: str,
                       labelnames: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.type != mtype:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.type}, "
                        f"requested {mtype}")
                if m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{m.labelnames}, requested {tuple(labelnames)}")
                if (mtype == "histogram" and buckets is not None
                        and tuple(float(b) for b in buckets) != m.buckets):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m.buckets}, requested "
                        f"{tuple(float(b) for b in buckets)}")
                return m
            m = Metric(self, mtype, name, help, labelnames, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Metric:
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Metric:
        return self._get_or_create("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Metric:
        return self._get_or_create("histogram", name, help, labelnames,
                                   buckets)

    # --------------------------------------------------------- inspection
    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self):
        """Registration-ordered snapshot of the registered metrics."""
        with self._lock:
            return list(self._metrics.values())

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        """Drop every instrument (tests / embedding apps). Live holders
        of child references keep mutating orphans harmlessly."""
        with self._lock:
            self._metrics.clear()


#: The process default registry — what every built-in integration
#: (Optimizer, serving services, parallel engine, bench) feeds unless
#: handed an explicit one.
REGISTRY = MetricRegistry()

_default_lock = threading.Lock()
_default: MetricRegistry = REGISTRY


def default_registry() -> MetricRegistry:
    return _default


def set_default_registry(reg: MetricRegistry) -> MetricRegistry:
    """Swap the process default (returns the previous one). Integrations
    resolve the default at use time, so a swap redirects everything that
    has not captured child references yet."""
    global _default
    with _default_lock:
        prev = _default
        _default = reg
        return prev
