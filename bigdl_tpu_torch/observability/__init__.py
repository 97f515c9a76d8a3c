"""bigdl_tpu_torch.observability: usage metering and SLO burn detection
for the serving engine (port of parts of ``bigdl_tpu/observability``).

- ``UsageLedger`` / ``UsageRecord`` (``accounting``): per-request and
  per-tenant usage (queue wait, prefilled and prefix-reused tokens,
  delivered tokens, KV byte-seconds, device-seconds attributed pro-rata
  per dispatch) and the engine's goodput block;
- ``SloObjective`` / ``SloWatchdog`` (``watchdog``): burn-rate alerts
  over latency histograms, the input of the engine's load shedding;
- ``Histogram`` / ``TIME_BUCKETS`` (``histogram``): the unregistered
  cumulative histogram the engine observes latencies into.

The JAX package's metric registry, Prometheus instruments, flight
recorder, budget tracker, recompile watchdog and incident capture are
not ported yet (ROADMAP.md, Queue 1 item 11).
"""

from bigdl_tpu_torch.observability.accounting import (
    KINDS, UsageLedger, UsageRecord,
)
from bigdl_tpu_torch.observability.histogram import TIME_BUCKETS, Histogram
from bigdl_tpu_torch.observability.watchdog import SloObjective, SloWatchdog

__all__ = ["KINDS", "UsageLedger", "UsageRecord", "Histogram",
           "TIME_BUCKETS", "SloObjective", "SloWatchdog"]
