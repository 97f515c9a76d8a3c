"""bigdl_tpu_torch.observability — runtime telemetry (port of
``bigdl_tpu/observability``).

- **Metrics registry** (``metrics``): thread-safe ``Counter`` /
  ``Gauge`` / ``Histogram`` instruments with labels, near-zero cost when
  disabled. The process default is ``REGISTRY``. Every instrument is
  minted in ``instruments`` under the ``bdt_`` head (the JAX package's
  names with ``bigdl_`` replaced; kind, labels and buckets unchanged).
  ``Histogram`` is a registry histogram child that belongs to no shared
  registry (a standalone SLO probe).
- **Span tracer** (``tracing``): ``with trace.span("train/step"):``
  wall-time trees, nested per thread, entering a
  ``torch.profiler.record_function`` while a profiler capture runs.
- **Flight recorder** (``events``): a bounded ring of per-request
  structured events (submitted → admitted → prefill → first token →
  per-token decode → finished).
- **Chrome trace export** (``chrometrace``) and **postmortems**
  (``postmortem``): span trees + recorder events as one Perfetto JSON;
  on an engine crash, one JSON artifact from host state only.
- **Device memory** (``memory``): a ``DeviceMemoryMonitor`` over
  ``torch.cuda``'s allocator counters with per-pool byte attribution
  (``register_pool`` hooks fed by the serving engine's KV pools, the
  prefix cache, and the optimizers), behind ``GET /debug/memory``.
- **Profiler** (``profiler``): bounded on-demand ``torch.profiler``
  capture — ``capture(seconds)`` or ``GET /debug/profile?seconds=N``.
- **Usage accounting** (``accounting``): the per-request
  ``UsageLedger`` and the engine's goodput block.
- **Watchdogs** (``watchdog``): ``RecompileWatchdog`` (post-warmup
  growth of the distinct dispatch signatures) and ``SloWatchdog``
  (burn rates over the latency histograms).
- **SLO error budgets** (``slo_budget``), **cost model**
  (``costmodel``: analytic FLOPs/bytes per dispatch kind, the H100 peak
  rows, ``LoopPhaseAccumulator``), **time series** (``timeseries``:
  ``TimeSeriesSampler``, ``render_dashboard``), **anomaly detection**
  (``anomaly``), **incidents** (``incidents``) and the **capacity
  model** (``capacity``).
- **Exporters** (``exporters``): Prometheus text, the stdlib
  ``/metrics`` + ``/healthz`` + ``/debug/*`` HTTP endpoint, and a
  bridge into ``visualization`` TensorBoard writers.

- **Fleet halves**: ``fleettrace`` (trace ids, the min-RTT clock
  offset, the hop breakdown, the merged fleet trace), the fleet
  time-series merge and dashboard, the fleet capacity aggregate, the
  replica-labelled snapshot rendering and ``fleet_instruments``, read by
  ``bigdl_tpu_torch.serving.fleet``.

The benchmark's instruments wait for the benchmark (ROADMAP.md, Queue 1
item 11).

``disable()`` turns every built-in instrument mutation into a no-op
(one boolean check). ``enable()`` / ``disable()`` act on the process
default registry, tracer and recorder.
"""

from bigdl_tpu_torch.observability.metrics import (
    DEFAULT_BUCKETS, Metric, MetricRegistry, REGISTRY,
    default_registry, set_default_registry,
)
from bigdl_tpu_torch.observability.tracing import Span, Tracer, trace
from bigdl_tpu_torch.observability.events import (
    Event, FlightRecorder, RECORDER, default_recorder, next_request_id,
    percentile_summary, record, set_default_recorder,
)
from bigdl_tpu_torch.observability.chrometrace import (
    chrome_trace_events, render_chrome_trace, write_chrome_trace,
)
from bigdl_tpu_torch.observability.fleettrace import (
    FLEET_HOPS, estimate_clock_offset, hop_breakdown,
    merge_fleet_trace, merge_request_timelines, mint_trace_id,
    parse_traceparent, render_fleet_trace, write_fleet_trace,
)
from bigdl_tpu_torch.observability.postmortem import (
    build_postmortem, registry_snapshot, write_postmortem,
)
from bigdl_tpu_torch.observability.exporters import (
    MetricsHTTPServer, PROMETHEUS_CONTENT_TYPE, TensorBoardBridge,
    render_prometheus, render_snapshot_prometheus, start_http_server,
    write_prometheus,
)
from bigdl_tpu_torch.observability.instruments import (
    FRACTION_BUCKETS, Histogram, OCCUPANCY_BUCKETS, OccupancyStats,
    TIME_BUCKETS, engine_instruments, fleet_instruments,
    generation_instruments,
    incident_instruments, memory_instruments, parallel_instruments,
    qos_instruments, serving_engine_instruments, serving_instruments,
    tenant_usage_instruments, train_instruments, watchdog_instruments,
)
from bigdl_tpu_torch.observability.accounting import (
    KINDS, UsageLedger, UsageRecord,
)
from bigdl_tpu_torch.observability.costmodel import (
    DispatchCostModel, LoopPhaseAccumulator, device_peaks, peak_flops,
)
from bigdl_tpu_torch.observability.timeseries import (
    TimeSeriesSampler, merge_fleet_timeseries, render_dashboard,
    render_fleet_dashboard,
)
from bigdl_tpu_torch.observability.slo_budget import (
    DEFAULT_BURN_WINDOWS, SloBudgetTracker,
)
from bigdl_tpu_torch.observability.capacity import (
    aggregate_fleet_capacity, estimate_capacity, replicas_needed,
)
from bigdl_tpu_torch.observability.memory import (
    DeviceMemoryMonitor, default_monitor, pool_sizes, register_pool,
    register_owned_pools, static_pools, tree_bytes, tree_device_bytes,
    unregister_pool,
)
from bigdl_tpu_torch.observability.profiler import (
    ProfilerBusy, ProfilerUnavailable, capture,
)
from bigdl_tpu_torch.observability.watchdog import (
    RecompileWatchdog, SloObjective, SloWatchdog,
)
from bigdl_tpu_torch.observability.anomaly import (
    AnomalyDetector, DetectorBank, EwmaZScoreDetector,
    RateOfChangeDetector, StallDetector, ThresholdDetector,
    default_detector_bank,
)
from bigdl_tpu_torch.observability.incidents import (
    INCIDENT_SCHEMA, IncidentManager, classify_timeline, load_incident,
)

__all__ = [
    "DEFAULT_BUCKETS", "Metric", "MetricRegistry", "REGISTRY",
    "default_registry", "set_default_registry",
    "Span", "Tracer", "trace",
    "Event", "FlightRecorder", "RECORDER", "default_recorder",
    "set_default_recorder", "record", "next_request_id",
    "percentile_summary",
    "chrome_trace_events", "render_chrome_trace", "write_chrome_trace",
    "FLEET_HOPS", "estimate_clock_offset", "hop_breakdown",
    "merge_fleet_trace", "merge_request_timelines", "mint_trace_id",
    "parse_traceparent", "render_fleet_trace", "write_fleet_trace",
    "build_postmortem", "registry_snapshot", "write_postmortem",
    "MetricsHTTPServer", "PROMETHEUS_CONTENT_TYPE", "TensorBoardBridge",
    "render_prometheus", "render_snapshot_prometheus",
    "start_http_server", "write_prometheus",
    "FRACTION_BUCKETS", "Histogram", "OCCUPANCY_BUCKETS",
    "OccupancyStats", "TIME_BUCKETS",
    "engine_instruments", "fleet_instruments", "generation_instruments",
    "incident_instruments", "memory_instruments", "parallel_instruments",
    "qos_instruments", "serving_engine_instruments",
    "serving_instruments", "tenant_usage_instruments",
    "train_instruments", "watchdog_instruments",
    "KINDS", "UsageLedger", "UsageRecord",
    "DispatchCostModel", "LoopPhaseAccumulator", "device_peaks",
    "peak_flops",
    "TimeSeriesSampler", "merge_fleet_timeseries", "render_dashboard",
    "render_fleet_dashboard",
    "DEFAULT_BURN_WINDOWS", "SloBudgetTracker",
    "aggregate_fleet_capacity", "estimate_capacity", "replicas_needed",
    "DeviceMemoryMonitor", "default_monitor", "pool_sizes",
    "register_pool", "register_owned_pools", "static_pools",
    "tree_bytes", "tree_device_bytes", "unregister_pool",
    "ProfilerBusy", "ProfilerUnavailable", "capture",
    "RecompileWatchdog", "SloObjective", "SloWatchdog",
    "AnomalyDetector", "DetectorBank", "EwmaZScoreDetector",
    "RateOfChangeDetector", "StallDetector", "ThresholdDetector",
    "default_detector_bank",
    "INCIDENT_SCHEMA", "IncidentManager", "classify_timeline",
    "load_incident",
    "enable", "disable", "enabled",
]


def enable() -> None:
    """Re-enable metric recording, span tracing, and the flight
    recorder process-wide."""
    default_registry().enable()
    trace.enable()
    default_recorder().enable()


def disable() -> None:
    """Disable metric recording, span tracing, and the flight recorder
    process-wide (every instrument mutation becomes a boolean check
    and an early return)."""
    default_registry().disable()
    trace.disable()
    default_recorder().disable()


def enabled() -> bool:
    return default_registry().enabled
