"""Canonical instrument families for the built-in integrations (port of
``bigdl_tpu/observability/instruments.py``).

One place defines every metric name, type, help string, and bucket
layout, so the train loops, both serving services and the parallel
engine all speak one schema. The port's names are the JAX package's
with the ``bigdl_`` head replaced by ``bdt_`` (``bigdl_tpu_torch``):
kind, label names and buckets are the JAX ones, so one dashboard reads
both, and a host running both packages exports distinct series. The
benchmark's families are not ported yet.

Each ``*_instruments`` helper is get-or-create against the CURRENT
default registry (resolved at call time, so tests can swap registries),
returning a plain namespace of bound instruments.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

from bigdl_tpu_torch.observability.metrics import (
    HistogramChild, MetricRegistry, default_registry,
)

#: Step/latency buckets tuned for training steps and serving dispatches
#: (100µs .. 60s: a train step and a first-call warmup both land).
TIME_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                60.0)

#: Batch-occupancy buckets: powers of two up to a generous serving
#: max_batch (a request count is integral; le-buckets still apply).
OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

#: Fraction buckets (0..1) for ratio-valued histograms — the
#: per-dispatch padding-waste distribution lands here.
FRACTION_BUCKETS = (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                    0.95, 1.0)


def train_instruments(registry: Optional[MetricRegistry] = None
                      ) -> SimpleNamespace:
    """Training-path instruments (Local + Distri optimizer loops)."""
    r = registry or default_registry()
    return SimpleNamespace(
        step_seconds=r.histogram(
            "bdt_train_step_seconds",
            "Wall time of one training step (dispatch + host sync)",
            buckets=TIME_BUCKETS),
        records_total=r.counter(
            "bdt_train_records_total",
            "Training records consumed"),
        throughput=r.gauge(
            "bdt_train_throughput_records_per_sec",
            "Training throughput over the last logging window"),
        loss=r.gauge("bdt_train_loss", "Last synced training loss"),
        learning_rate=r.gauge(
            "bdt_train_learning_rate",
            "Current learning rate (optimizer group 0)"),
        grad_norm=r.gauge(
            "bdt_train_grad_norm",
            "Global (pre-clip) gradient L2 norm of the last synced step"),
        epoch=r.gauge("bdt_train_epoch", "Current epoch (1-based)"),
        jit_compiles=r.gauge(
            "bdt_train_jit_compiles",
            "Distinct compiled train-step executables (signature cache "
            "size)"),
        checkpoint_seconds=r.histogram(
            "bdt_train_checkpoint_seconds",
            "Checkpoint latency as seen by the train loop (async mode: "
            "snapshot + handoff, not the background write)",
            buckets=TIME_BUCKETS),
    )


def parallel_instruments(registry: Optional[MetricRegistry] = None
                         ) -> SimpleNamespace:
    """Per-host SPMD loop instruments (labelled by JAX process index —
    each host's registry carries its own rank's series)."""
    r = registry or default_registry()
    return SimpleNamespace(
        step_seconds=r.histogram(
            "bdt_parallel_step_seconds",
            "Per-iteration wall time of the SPMD step (window average "
            "at each host sync), per host", labelnames=("host",),
            buckets=TIME_BUCKETS),
        sync_window_seconds=r.histogram(
            "bdt_parallel_sync_window_seconds",
            "Wall time between host syncs (log_interval iterations of "
            "pipelined dispatch), per host", labelnames=("host",),
            buckets=TIME_BUCKETS),
    )


def serving_instruments(service: str,
                        registry: Optional[MetricRegistry] = None
                        ) -> SimpleNamespace:
    """Serving-path instruments, shared by GenerationService and
    PredictionService under a ``service`` label."""
    r = registry or default_registry()
    lbl = ("service",)
    return SimpleNamespace(
        requests_total=r.counter(
            "bdt_serve_requests_total",
            "Requests accepted (before batching)", labelnames=lbl
        ).labels(service),
        dispatches_total=r.counter(
            "bdt_serve_dispatches_total",
            "Device dispatches launched", labelnames=lbl).labels(service),
        errors_total=r.counter(
            "bdt_serve_errors_total",
            "Requests that failed", labelnames=lbl).labels(service),
        batch_occupancy=r.histogram(
            "bdt_serve_batch_occupancy",
            "Real (pre-padding) requests per launched batch",
            labelnames=lbl, buckets=OCCUPANCY_BUCKETS).labels(service),
        queue_wait_seconds=r.histogram(
            "bdt_serve_queue_wait_seconds",
            "Per-request wait from submit to batch launch",
            labelnames=lbl, buckets=TIME_BUCKETS).labels(service),
        dispatch_seconds=r.histogram(
            "bdt_serve_dispatch_seconds",
            "Device dispatch wall time per launched batch",
            labelnames=lbl, buckets=TIME_BUCKETS).labels(service),
        inflight=r.gauge(
            "bdt_serve_inflight_requests",
            "Requests currently inside the service", labelnames=lbl
        ).labels(service),
    )


def generation_instruments(service: str = "generation",
                           registry: Optional[MetricRegistry] = None
                           ) -> SimpleNamespace:
    """GenerationService extras on top of serving_instruments — same
    ``service`` label, so side-by-side services stay separated here
    too."""
    r = registry or default_registry()
    lbl = ("service",)
    return SimpleNamespace(
        tokens_total=r.counter(
            "bdt_generation_tokens_total",
            "Tokens delivered per served request (up to and including "
            "the first eos — the eos-padding tail is not counted)",
            labelnames=lbl).labels(service),
        tokens_per_sec=r.gauge(
            "bdt_generation_tokens_per_sec",
            "Delivered throughput of the last dispatch (real requests' "
            "delivered tokens, eos-truncated, / dispatch wall time)",
            labelnames=lbl).labels(service),
    )


def serving_engine_instruments(service: str = "engine",
                               registry: Optional[MetricRegistry] = None
                               ) -> SimpleNamespace:
    """Continuous-batching engine instruments (``bigdl_tpu_torch.serving``),
    labelled by ``service`` like the batch services' families. The
    latency pair every serving SLO is written against — TTFT and
    inter-token latency — plus slot-pool occupancy, admission/eviction
    flow counters, loop-iteration timing, and the compiled-executable
    gauge (flat after warmup is the engine's shape-stability
    contract)."""
    r = registry or default_registry()
    lbl = ("service",)
    return SimpleNamespace(
        slots=r.gauge(
            "bdt_serving_slots",
            "KV-cache slot pool capacity (max_slots)",
            labelnames=lbl).labels(service),
        active_slots=r.gauge(
            "bdt_serving_active_slots",
            "Slots currently decoding a request", labelnames=lbl
        ).labels(service),
        queue_depth=r.gauge(
            "bdt_serving_queue_depth",
            "Requests waiting in the admission queue", labelnames=lbl
        ).labels(service),
        admitted_total=r.counter(
            "bdt_serving_admitted_total",
            "Requests admitted to a slot (prefill started)",
            labelnames=lbl).labels(service),
        finished_total=r.counter(
            "bdt_serving_finished_total",
            "Requests that completed (eos or token budget)",
            labelnames=lbl).labels(service),
        evicted_total=r.counter(
            "bdt_serving_evicted_total",
            "Slots freed for reuse (finish, timeout, or cancellation)",
            labelnames=lbl).labels(service),
        timed_out_total=r.counter(
            "bdt_serving_timed_out_total",
            "Requests that hit their deadline (queued or mid-decode)",
            labelnames=lbl).labels(service),
        cancelled_total=r.counter(
            "bdt_serving_cancelled_total",
            "Requests cancelled by the client", labelnames=lbl
        ).labels(service),
        prefill_tokens_total=r.counter(
            "bdt_serving_prefill_tokens_total",
            "Prompt tokens prefilled (chunked admission work)",
            labelnames=lbl).labels(service),
        decode_tokens_total=r.counter(
            "bdt_serving_decode_tokens_total",
            "Tokens delivered by the fused decode step", labelnames=lbl
        ).labels(service),
        iterations_total=r.counter(
            "bdt_serving_iterations_total",
            "Engine loop iterations", labelnames=lbl).labels(service),
        iteration_seconds=r.histogram(
            "bdt_serving_iteration_seconds",
            "Wall time of one engine loop iteration (admission sweep + "
            "prefill budget + fused decode)", labelnames=lbl,
            buckets=TIME_BUCKETS).labels(service),
        ttft_seconds=r.histogram(
            "bdt_serving_ttft_seconds",
            "Time to first token: submit to first delivered token",
            labelnames=lbl, buckets=TIME_BUCKETS).labels(service),
        inter_token_seconds=r.histogram(
            "bdt_serving_inter_token_seconds",
            "Per-slot gap between consecutive delivered tokens",
            labelnames=lbl, buckets=TIME_BUCKETS).labels(service),
        queue_wait_seconds=r.histogram(
            "bdt_serving_queue_wait_seconds",
            "Per-request wait from submit to admission (prefill "
            "started) in the continuous-batching engine",
            labelnames=lbl, buckets=TIME_BUCKETS).labels(service),
        jit_compiles=r.gauge(
            "bdt_serving_jit_compiles",
            "Compiled executables across the engine's jitted programs "
            "(decode step, ragged prefill chunk, slot insert, first-"
            "token sample, prefix stage/donate copies) — flat after "
            "warmup: compiled shapes depend only on max_slots/"
            "prefill_rows/pool rows, never on load", labelnames=lbl
        ).labels(service),
        prefix_hits_total=r.counter(
            "bdt_serving_prefix_hits_total",
            "Admissions whose prompt head was served from the prefix "
            "cache (prefill skipped for the matched, chunk-aligned "
            "head)", labelnames=lbl).labels(service),
        prefix_misses_total=r.counter(
            "bdt_serving_prefix_misses_total",
            "Admissions with no usable cached prefix (full prompt "
            "prefilled)", labelnames=lbl).labels(service),
        prefix_reused_tokens_total=r.counter(
            "bdt_serving_prefix_reused_tokens_total",
            "Prompt tokens served from the prefix cache instead of "
            "being prefilled (the work the cache eliminated; compare "
            "against bdt_serving_prefill_tokens_total)",
            labelnames=lbl).labels(service),
        prefix_evicted_total=r.counter(
            "bdt_serving_prefix_evicted_total",
            "Prefix-cache entries evicted (LRU among unpinned) to make "
            "room under the byte budget", labelnames=lbl).labels(service),
        prefix_cache_bytes=r.gauge(
            "bdt_serving_prefix_cache_bytes",
            "Device bytes of KV currently retained by the prefix "
            "cache (occupied pool rows x per-row footprint)",
            labelnames=lbl).labels(service),
        prefix_cache_entries=r.gauge(
            "bdt_serving_prefix_cache_entries",
            "Prefix-cache entries currently retained", labelnames=lbl
        ).labels(service),
        prefix_host_hits_total=r.counter(
            "bdt_serving_prefix_host_hits_total",
            "Prefix-cache hits served from the host tier (row demoted "
            "to host RAM, promoted back to the device pool before "
            "admission) — the hits the device budget alone would have "
            "missed", labelnames=lbl).labels(service),
        prefix_host_demoted_total=r.counter(
            "bdt_serving_prefix_host_demoted_total",
            "Device-pool LRU victims demoted into pinned host buffers "
            "(one bulk d2h copy per row) instead of dropped",
            labelnames=lbl).labels(service),
        prefix_host_promoted_total=r.counter(
            "bdt_serving_prefix_host_promoted_total",
            "Host-tier rows copied back into the device pool on a "
            "trie hit (async device_put overlapped with the request's "
            "queue wait)", labelnames=lbl).labels(service),
        prefix_host_evicted_total=r.counter(
            "bdt_serving_prefix_host_evicted_total",
            "Host-tier entries evicted (LRU among unpinned) to make "
            "room under the host byte budget — only here does a "
            "prefix truly leave the cache", labelnames=lbl
        ).labels(service),
        prefix_host_cache_bytes=r.gauge(
            "bdt_serving_prefix_host_cache_bytes",
            "Host RAM bytes of KV currently retained by the prefix "
            "cache's host tier (demoted rows x per-row footprint)",
            labelnames=lbl).labels(service),
        prefix_host_cache_entries=r.gauge(
            "bdt_serving_prefix_host_cache_entries",
            "Prefix-cache entries currently resident in the host tier",
            labelnames=lbl).labels(service),
        page_allocated_total=r.counter(
            "bdt_serving_page_allocated_total",
            "KV pages claimed from the paged block pool (refcount "
            "0 -> 1; 0 for a dense engine)", labelnames=lbl
        ).labels(service),
        page_shared_total=r.counter(
            "bdt_serving_page_shared_total",
            "KV page reference bumps (prefix-hit shares, donations, "
            "copy-on-write forks taking a reference) — each one is a "
            "row copy the dense engine would have dispatched",
            labelnames=lbl).labels(service),
        page_cow_forks_total=r.counter(
            "bdt_serving_page_cow_forks_total",
            "Shared KV pages privatized by a copy-on-write single-page "
            "device copy before a write (0 on the engine's own paths — "
            "chunk/page alignment keeps shared pages read-only)",
            labelnames=lbl).labels(service),
        page_freed_total=r.counter(
            "bdt_serving_page_freed_total",
            "KV pages returned to the free list (last reference "
            "dropped) — allocated minus freed is the live page count",
            labelnames=lbl).labels(service),
        page_pool_bytes=r.gauge(
            "bdt_serving_page_pool_bytes",
            "Device bytes of paged-KV pool pages currently referenced "
            "(pages_in_use x per-page footprint, scale sidecars "
            "included; target + draft pools summed)", labelnames=lbl
        ).labels(service),
        page_pool_pages_in_use=r.gauge(
            "bdt_serving_page_pool_pages_in_use",
            "Paged-KV pool pages with at least one live reference "
            "(slot tables, in-flight admissions, prefix entries; "
            "target + draft pools summed)", labelnames=lbl
        ).labels(service),
        page_pool_fragmentation=r.gauge(
            "bdt_serving_page_pool_fragmentation",
            "Internal fragmentation of live request reservations: 1 - "
            "covered token positions / reserved page capacity — the "
            "over-allocation a dense full-length row pays on every "
            "request, bounded here by the eager page reservation",
            labelnames=lbl).labels(service),
        quantized_kv=r.gauge(
            "bdt_serving_quantized_kv",
            "1 when every persistent KV pool (slots, staging, prefix "
            "pool + host tier, draft pools) stores int8 rows with f32 "
            "scale sidecars (engine kv_dtype='int8'); 0 full precision",
            labelnames=lbl).labels(service),
        quantized_weights=r.gauge(
            "bdt_serving_quantized_weights",
            "1 when the target model serves through the int8 "
            "Quantizer clone (engine weights_dtype='int8'); 0 full "
            "precision", labelnames=lbl).labels(service),
        kv_row_bytes=r.gauge(
            "bdt_serving_kv_row_bytes",
            "Physical bytes of ONE slot's KV row across all layers — "
            "including the scale sidecars under kv_dtype='int8' — the "
            "honest per-row cost behind pool budgets and the "
            "quantized-capacity claim", labelnames=lbl).labels(service),
        spec_proposed_tokens_total=r.counter(
            "bdt_serving_spec_proposed_tokens_total",
            "Draft tokens proposed by the speculative decode loop "
            "(gamma per live slot per iteration; 0 without a draft)",
            labelnames=lbl).labels(service),
        spec_accepted_tokens_total=r.counter(
            "bdt_serving_spec_accepted_tokens_total",
            "Draft proposals the target's verify pass accepted (the "
            "extra tokens speculation bought; compare against "
            "bdt_serving_spec_proposed_tokens_total for the "
            "acceptance rate)", labelnames=lbl).labels(service),
        spec_acceptance_ratio=r.histogram(
            "bdt_serving_spec_acceptance_ratio",
            "Per-iteration draft acceptance fraction (accepted / "
            "proposed across the live slots of one speculative decode "
            "round) — near 1 says raise gamma, near 0 says the draft "
            "disagrees with the target", labelnames=lbl,
            buckets=FRACTION_BUCKETS).labels(service),
        device_prefill_seconds_total=r.counter(
            "bdt_serving_device_seconds_total",
            "Host-measured wall seconds spent driving engine device "
            "dispatches, by kind (ragged prefill rounds vs fused "
            "decode steps) — the goodput denominator and the pool the "
            "usage ledger attributes pro-rata across requests",
            labelnames=("service", "kind")).labels(service, "prefill"),
        device_decode_seconds_total=r.counter(
            "bdt_serving_device_seconds_total",
            "Host-measured wall seconds spent driving engine device "
            "dispatches, by kind (ragged prefill rounds vs fused "
            "decode steps) — the goodput denominator and the pool the "
            "usage ledger attributes pro-rata across requests",
            labelnames=("service", "kind")).labels(service, "decode"),
        padding_waste_prefill=r.histogram(
            "bdt_serving_dispatch_padding_waste",
            "Per-dispatch padded-idle fraction: rows the compiled "
            "shape paid for but no request advanced, over the dispatch "
            "width (max_slots for decode, prefill_rows for prefill) — "
            "0 is a full dispatch, near 1 is mostly padding",
            labelnames=("service", "kind"),
            buckets=FRACTION_BUCKETS).labels(service, "prefill"),
        padding_waste_decode=r.histogram(
            "bdt_serving_dispatch_padding_waste",
            "Per-dispatch padded-idle fraction: rows the compiled "
            "shape paid for but no request advanced, over the dispatch "
            "width (max_slots for decode, prefill_rows for prefill) — "
            "0 is a full dispatch, near 1 is mostly padding",
            labelnames=("service", "kind"),
            buckets=FRACTION_BUCKETS).labels(service, "decode"),
        utilization=r.gauge(
            "bdt_serving_occupancy_weighted_utilization",
            "Dispatch-wall-weighted occupancy fraction (advanced rows "
            "x wall / capacity rows x wall, cumulative): how much of "
            "the compiled batch shape has carried real work",
            labelnames=lbl).labels(service),
        tokens_per_device_second=r.gauge(
            "bdt_serving_tokens_per_device_second",
            "Delivered tokens per host-measured device-dispatch "
            "second, cumulative — the engine's goodput headline",
            labelnames=lbl).labels(service),
        mesh_devices=r.gauge(
            "bdt_serving_mesh_devices",
            "Devices in the engine's SPMD mesh (1 for a single-device "
            "engine): every compiled dispatch occupies all of them, "
            "and usage device-seconds scale by this factor",
            labelnames=lbl).labels(service),
        mesh_model_shards=r.gauge(
            "bdt_serving_mesh_model_shards",
            "Size of the mesh's model (tensor-parallel) axis — the "
            "way count KV heads and Megatron column/row weights are "
            "split (1 when unsharded)", labelnames=lbl).labels(service),
        mfu_prefill=r.gauge(
            "bdt_serving_mfu",
            "Model FLOPs utilization by dispatch kind: achieved "
            "FLOP/s per device (cost-model FLOPs per dispatch x warm "
            "dispatches / warm wall / mesh devices) over the device "
            "kind's peak — the 'how close to the hardware ceiling' "
            "headline the roofline classification reads",
            labelnames=("service", "kind")).labels(service, "prefill"),
        mfu_decode=r.gauge(
            "bdt_serving_mfu",
            "Model FLOPs utilization by dispatch kind: achieved "
            "FLOP/s per device (cost-model FLOPs per dispatch x warm "
            "dispatches / warm wall / mesh devices) over the device "
            "kind's peak — the 'how close to the hardware ceiling' "
            "headline the roofline classification reads",
            labelnames=("service", "kind")).labels(service, "decode"),
        membw_util_prefill=r.gauge(
            "bdt_serving_membw_util",
            "HBM bandwidth utilization by dispatch kind: achieved "
            "bytes/s per device over the device kind's peak HBM "
            "bandwidth — near 1 with low MFU is the memory-bound "
            "signature",
            labelnames=("service", "kind")).labels(service, "prefill"),
        membw_util_decode=r.gauge(
            "bdt_serving_membw_util",
            "HBM bandwidth utilization by dispatch kind: achieved "
            "bytes/s per device over the device kind's peak HBM "
            "bandwidth — near 1 with low MFU is the memory-bound "
            "signature",
            labelnames=("service", "kind")).labels(service, "decode"),
        loop_idle_fraction=r.gauge(
            "bdt_serving_loop_device_idle_fraction",
            "Share of accounted engine-loop wall the device sat idle "
            "(1 - warm dispatch wall / accounted loop wall) — the "
            "total the stats()['loop'] phase breakdown decomposes "
            "into named host-side bubbles", labelnames=lbl
        ).labels(service),
        # UNBOUND family: the engine binds (service, phase) per named
        # loop phase it times
        loop_phase_seconds=r.counter(
            "bdt_serving_loop_phase_seconds_total",
            "Cumulative engine-loop wall attributed to one named "
            "host-side phase (sweep, admission, prefill_dispatch, "
            "decode_dispatch, deliver, observe) — the denominator of "
            "the stats()['loop'] fractions",
            labelnames=("service", "phase")),
        # UNBOUND family: the engine binds (service, pool) per
        # persistent buffer set it owns
        mesh_pool_bytes_per_device=r.gauge(
            "bdt_serving_mesh_pool_bytes_per_device",
            "Per-device byte footprint of one engine device pool "
            "(physical shard bytes / mesh devices): what ONE chip's "
            "HBM actually pays for the pool — a replicated pool "
            "reports its full size, an evenly model-sharded pool "
            "reports 1/Nth", labelnames=("service", "pool")),
    )


def tenant_usage_instruments(registry: Optional[MetricRegistry] = None
                             ) -> SimpleNamespace:
    """Per-tenant usage counters fed by ``accounting.UsageLedger`` at
    request finalization. Returned UNBOUND (families, not children):
    the ledger binds ``(service, tenant)`` per finalized request, and
    its cardinality cap (overflow tenants fold into ``"other"``) is
    what keeps the tenant label space bounded."""
    r = registry or default_registry()
    lbl = ("service", "tenant")
    return SimpleNamespace(
        requests_total=r.counter(
            "bdt_serving_tenant_requests_total",
            "Requests finalized per tenant (all outcomes)",
            labelnames=lbl),
        prefill_tokens_total=r.counter(
            "bdt_serving_tenant_prefill_tokens_total",
            "Prompt tokens actually prefilled per tenant",
            labelnames=lbl),
        decode_tokens_total=r.counter(
            "bdt_serving_tenant_decode_tokens_total",
            "Tokens delivered per tenant", labelnames=lbl),
        prefix_reused_tokens_total=r.counter(
            "bdt_serving_tenant_prefix_reused_tokens_total",
            "Prompt tokens served from the prefix cache per tenant "
            "(prefill work the cache saved them)", labelnames=lbl),
        queue_seconds_total=r.counter(
            "bdt_serving_tenant_queue_seconds_total",
            "Admission-queue wait seconds accumulated per tenant",
            labelnames=lbl),
        device_seconds_total=r.counter(
            "bdt_serving_tenant_device_seconds_total",
            "Device-dispatch seconds attributed pro-rata per tenant "
            "(sums across tenants to "
            "bdt_serving_device_seconds_total)", labelnames=lbl),
        kv_byte_seconds_total=r.counter(
            "bdt_serving_tenant_kv_byte_seconds_total",
            "KV byte-seconds held per tenant (staging/slot row bytes "
            "x residency — HBM occupancy over time)", labelnames=lbl),
    )


def qos_instruments(registry: Optional[MetricRegistry] = None
                    ) -> SimpleNamespace:
    """QoS flow counters fed by the engine's overload machinery.
    Returned UNBOUND (families, not children): the engine binds
    ``(service, class, tenant)`` per event — ``class`` is the
    affected request's priority class (the preemption VICTIM's class,
    the shed request's class), ``tenant`` the cardinality-capped
    tenant label the usage ledger resolved."""
    r = registry or default_registry()
    lbl = ("service", "class", "tenant")
    return SimpleNamespace(
        preempted_total=r.counter(
            "bdt_serving_preempted_total",
            "Slot preemptions: the victim's KV was donated to the "
            "prefix pool and the request automatically requeued "
            "(resumes token-identical, re-prefilling only the "
            "uncached tail)", labelnames=lbl),
        shed_total=r.counter(
            "bdt_serving_shed_total",
            "Requests shed at admission by burn-rate load shedding "
            "(TTFT SLO burning; lowest class first)", labelnames=lbl),
        rate_limited_total=r.counter(
            "bdt_serving_rate_limited_total",
            "Requests refused by the tenant's device-second token "
            "bucket (Retry-After = exact refill time)",
            labelnames=lbl),
    )


class Histogram(HistogramChild):
    """A cumulative histogram that belongs to no shared registry: the
    child of a family in a registry of its own, always enabled (a
    standalone SLO probe, or a test's fake histogram). ``observe``,
    ``get`` and ``_metric.buckets`` are the registry child's."""

    def __init__(self, buckets=TIME_BUCKETS):
        family = MetricRegistry().histogram("histogram", buckets=buckets)
        super().__init__(family, ())


class OccupancyStats:
    """The serving ``stats()`` façade, shared by both services: served /
    dispatches / mean occupancy as the DELTA of a bound batch-occupancy
    histogram child (sum = requests launched, count = dispatches) since
    construction.

    Registry-backed by design: ``observability.disable()`` stops the
    underlying series, and these numbers with it — and two live services
    sharing a ``service_name`` share the series, so the delta is exact
    only for the sole live holder of the label."""

    def __init__(self, occupancy_child):
        self._occ = occupancy_child
        _, occ_sum, occ_count = occupancy_child.get()
        self._base = (occ_sum, occ_count)

    def snapshot(self) -> dict:
        _, occ_sum, occ_count = self._occ.get()
        served = int(occ_sum - self._base[0])
        disp = occ_count - self._base[1]
        return {"served": served, "dispatches": disp,
                "mean_batch_occupancy": round(served / disp, 3)
                if disp else 0.0}


def memory_instruments(registry: Optional[MetricRegistry] = None
                       ) -> SimpleNamespace:
    """Device-memory gauges fed by ``memory.DeviceMemoryMonitor`` —
    per-device HBM accounting plus per-pool byte attribution (KV slot
    pool, prefix-cache pool, staging cache, params, optimizer slots)."""
    r = registry or default_registry()
    dev = ("device",)
    return SimpleNamespace(
        bytes_in_use=r.gauge(
            "bdt_device_hbm_bytes_in_use",
            "Device memory currently in use (backend memory_stats, or "
            "live-array accounting where the backend reports none)",
            labelnames=dev),
        peak_bytes=r.gauge(
            "bdt_device_hbm_peak_bytes",
            "Backend-reported peak device memory in use", labelnames=dev),
        limit_bytes=r.gauge(
            "bdt_device_hbm_limit_bytes",
            "Device memory capacity available to this process",
            labelnames=dev),
        headroom_bytes=r.gauge(
            "bdt_device_hbm_headroom_bytes",
            "limit - bytes_in_use: how close the process is to an OOM",
            labelnames=dev),
        pool_bytes=r.gauge(
            "bdt_device_pool_bytes",
            "Per-pool device-byte attribution (register_pool hooks: KV "
            "slot pool, prefix-cache pool, prefill staging, model "
            "params, optimizer slots, ...)", labelnames=("pool",)),
    )


def watchdog_instruments(registry: Optional[MetricRegistry] = None
                         ) -> SimpleNamespace:
    """Alert-state instruments shared by ``RecompileWatchdog`` and
    ``SloWatchdog`` — the Prometheus side of ``stats()['alerts']``."""
    r = registry or default_registry()
    return SimpleNamespace(
        alert_active=r.gauge(
            "bdt_watchdog_alert_active",
            "1 while the named alert is firing, 0 otherwise (alert= "
            "'recompile_storm' or 'slo:<objective>')",
            labelnames=("alert", "service")),
        alerts_fired=r.counter(
            "bdt_watchdog_alerts_fired_total",
            "Alert activations (rising edges) per alert name",
            labelnames=("alert", "service")),
        recompile_growth=r.counter(
            "bdt_watchdog_recompile_growth_total",
            "Watchdog samples that observed the compile counter grow "
            "(warmup included; the storm alert only counts post-warmup "
            "growth)", labelnames=("service",)),
        slo_burn_rate=r.gauge(
            "bdt_watchdog_slo_burn_rate",
            "Error-budget burn rate of the objective over its trailing "
            "window (1.0 = spending budget exactly as fast as the "
            "target allows)", labelnames=("objective", "service")),
        budget_remaining=r.gauge(
            "bdt_slo_budget_remaining",
            "Fraction of the objective's error budget left over the "
            "trailing budget window (1.0 = untouched, 0.0 = "
            "exhausted; chaos burn drills spend it synthetically)",
            labelnames=("objective", "service")),
        budget_burn_rate=r.gauge(
            "bdt_slo_budget_burn_rate",
            "Multi-window burn rate of the objective (window='fast' / "
            "'slow' Google-SRE pairing; 1.0 = spending budget exactly "
            "as fast as the target allows)",
            labelnames=("objective", "service", "window")),
    )


def incident_instruments(registry: Optional[MetricRegistry] = None
                         ) -> SimpleNamespace:
    """Anomaly-detection and incident-capture instruments, fed by
    ``observability.anomaly`` / ``observability.incidents``. Returned
    UNBOUND (families, not children): the incident manager binds
    ``(service, kind)`` per captured bundle and the engine binds
    ``(service, detector)`` per detector it hosts — kinds and
    detector names are dynamic."""
    r = registry or default_registry()
    return SimpleNamespace(
        incidents_total=r.counter(
            "bdt_serving_incidents_total",
            "Incident bundles captured, by classified kind (slo / "
            "stall / crash / recompile / anomaly) — cooldown-deduped "
            "rising edges, not per-sample breaches", labelnames=(
                "service", "kind")),
        detector_state=r.gauge(
            "bdt_anomaly_detector_state",
            "One anomaly detector's state: 0 ok (or warming up), 1 "
            "firing — hysteresis holds it at 1 until clear_after "
            "consecutive calm samples", labelnames=(
                "service", "detector")),
        triggers_total=r.counter(
            "bdt_anomaly_triggers_total",
            "Detector trigger firings (rising edges past warmup and "
            "cooldown) per detector — each one hands a capture "
            "request to the incident manager",
            labelnames=("service", "detector")),
    )


def fleet_instruments(fleet: str = "fleet",
                      registry: Optional[MetricRegistry] = None
                      ) -> SimpleNamespace:
    """Multi-replica serving-fleet instruments
    (``bigdl_tpu_torch.serving.fleet``), labelled by ``fleet`` — the
    control plane's view: how many replicas are taking traffic vs draining,
    where the router sent each request (affinity hit vs spill vs
    round-robin), the drain/rejoin flow, and each replica's admission
    backlog as the router's load signal. The per-replica families are
    returned UNBOUND (``.labels(fleet, replica)`` at the call site) —
    replica ids are dynamic."""
    r = registry or default_registry()
    lbl = ("fleet",)
    return SimpleNamespace(
        replicas_live=r.gauge(
            "bdt_fleet_replicas_live",
            "Replicas currently accepting routed traffic",
            labelnames=lbl).labels(fleet),
        replicas_draining=r.gauge(
            "bdt_fleet_replicas_draining",
            "Replicas draining (in-flight finishing, new traffic "
            "routed away)", labelnames=lbl).labels(fleet),
        requests_total=r.counter(
            "bdt_fleet_requests_total",
            "Requests accepted by the fleet front door / supervisor",
            labelnames=lbl).labels(fleet),
        routed_total=r.counter(
            "bdt_fleet_routed_total",
            "Routing decisions by kind: affinity (consistent-hash "
            "target took it), spilled (target saturated or the forced-"
            "spill bound fired -> least-loaded), round_robin (affinity "
            "disabled)", labelnames=("fleet", "route")),
        rerouted_total=r.counter(
            "bdt_fleet_rerouted_total",
            "Submissions re-routed after the chosen replica refused "
            "(drain/stop race)", labelnames=lbl).labels(fleet),
        drains_total=r.counter(
            "bdt_fleet_drains_total",
            "Replica drains by reason (degraded watchdog alerts / "
            "crashed 503 / operator)", labelnames=("fleet", "reason")),
        rejoins_total=r.counter(
            "bdt_fleet_rejoins_total",
            "Drained replicas returned to rotation", labelnames=lbl
        ).labels(fleet),
        disconnects_total=r.counter(
            "bdt_fleet_client_disconnects_total",
            "Streaming clients that vanished mid-response (request "
            "cancelled, slot freed)", labelnames=lbl).labels(fleet),
        replica_queue_depth=r.gauge(
            "bdt_fleet_replica_queue_depth",
            "One replica's admission-queue depth as last polled (the "
            "router's least-loaded signal)",
            labelnames=("fleet", "replica")),
        replica_active_slots=r.gauge(
            "bdt_fleet_replica_active_slots",
            "One replica's occupied decode slots as last polled",
            labelnames=("fleet", "replica")),
        hop_seconds=r.histogram(
            "bdt_fleet_hop_seconds",
            "Per-request wall seconds by fleet hop (route / "
            "rpc_submit / queue / prefill / first_token / decode / "
            "stream) — the components sum to the client-observed "
            "total, so any hop's histogram is its share of end-to-end "
            "latency", buckets=TIME_BUCKETS,
            labelnames=("fleet", "hop")),
        rpc_timeouts_total=r.counter(
            "bdt_fleet_rpc_timeouts_total",
            "Worker pipe-RPC control calls (healthz/stats/ping) that "
            "hit their deadline — the wedged-child signal that "
            "degrades the replica to auto-drain",
            labelnames=("fleet", "replica")),
        clock_offset_seconds=r.gauge(
            "bdt_fleet_clock_offset_seconds",
            "Estimated monotonic-clock offset of one replica vs the "
            "supervisor (min-RTT ping estimate; added to replica "
            "timestamps when merging fleet traces)",
            labelnames=("fleet", "replica")),
        capacity_headroom=r.gauge(
            "bdt_fleet_capacity_headroom",
            "Fleet-wide headroom fraction from the capacity model: "
            "1 - offered/sustainable request rate across live "
            "replicas (0 = saturated, negative = overloaded)",
            labelnames=lbl).labels(fleet),
        capacity_replicas_needed=r.gauge(
            "bdt_fleet_capacity_replicas_needed",
            "Replicas the capacity model estimates the current "
            "offered load needs at each replica's measured "
            "sustainable rate", labelnames=lbl).labels(fleet),
    )


def engine_instruments(registry: Optional[MetricRegistry] = None
                       ) -> SimpleNamespace:
    """Topology gauges set by Engine.init / create_mesh."""
    r = registry or default_registry()
    return SimpleNamespace(
        processes=r.gauge(
            "bdt_engine_processes", "JAX process (host) count"),
        local_devices=r.gauge(
            "bdt_engine_local_devices", "Devices on this host"),
        total_devices=r.gauge(
            "bdt_engine_total_devices", "Devices across the pod"),
    )
