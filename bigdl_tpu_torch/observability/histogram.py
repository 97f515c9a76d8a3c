"""A cumulative latency histogram that belongs to no registry.

The serving engine observes TTFT, the inter-token gap and the queue wait
into three of these, and ``SloWatchdog`` evaluates its objectives over
them. The interface is the slice of the JAX package's registry histogram
child (``bigdl_tpu/observability/metrics.py``) that the watchdog reads:
``observe(value)``, ``get()`` returning ``(cumulative counts aligned to
buckets + (+Inf), sum, count)``, and ``_metric.buckets``. No Prometheus
name is minted here: the port exports no metric yet.
"""

from __future__ import annotations

import threading
from typing import Sequence

#: Step/latency buckets (100 µs .. 60 s), the JAX package's
#: ``TIME_BUCKETS`` (``bigdl_tpu/observability/instruments.py``)
TIME_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                60.0)


class Histogram:
    """Thread-safe le-bucket histogram: ``observe`` from the loop thread
    or the queue, ``get`` from the watchdog or a client."""

    def __init__(self, buckets: Sequence[float] = TIME_BUCKETS):
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram buckets must be sorted and "
                             f"unique, got {bs}")
        self.buckets = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0

    @property
    def _metric(self) -> "Histogram":
        # the registry child's family carries the buckets; this
        # histogram is its own family
        return self

    def observe(self, value: float) -> None:
        value = float(value)
        i = 0
        n = len(self.buckets)
        while i < n and value > self.buckets[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def get(self):
        """(cumulative bucket counts aligned to buckets + (+Inf), sum,
        count)."""
        with self._lock:
            counts = list(self._counts)
            total_sum, count = self._sum, self._count
        cum = []
        running = 0
        for c in counts:
            running += c
            cum.append(running)
        return cum, total_sum, count
