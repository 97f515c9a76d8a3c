"""Per-request usage accounting and engine goodput attribution (port of
``bigdl_tpu/observability/accounting.py``).

Health observability (flight recorder, HBM attribution, watchdogs)
answers "is the engine OK"; this module answers the question a
millions-of-users deployment asks first: **who consumed the device,
and how much of each dispatch was useful work?** BigDL's production
heritage (Dai et al., 2018, arxiv 1804.05839; BigDL 2.0, arxiv
2204.01715) treats per-workload resource accounting as a first-class
capability — this is the inference-side equivalent, and the input
signal SLO-aware scheduling and multi-replica routing bill against.

Two host-side pieces, zero device programs (the dispatch-signature
gauge must stay flat with accounting on):

- ``UsageRecord`` — one request's metered consumption: queue seconds,
  prompt tokens actually prefilled vs served from the prefix cache
  (plus the KV bytes that reuse saved), tokens delivered, **KV
  byte-seconds held** (staging/slot row bytes x residency — the HBM a
  request occupied, over time), and **device-seconds attributed
  pro-rata** from every ragged prefill round and fused decode step
  across the rows each dispatch actually advanced.
- ``UsageLedger`` — the thread-safe engine-side meter: resolves
  ``tenant=`` labels under a cardinality cap (overflow tenants fold
  into ``"other"`` so a tenant-id typo storm cannot mint unbounded
  label series), accumulates per-tenant aggregates, keeps a bounded
  ring of finished records for top-N-by-device-seconds queries, and
  maintains the engine's **goodput** figures: per-dispatch
  padding-waste fraction, occupancy-weighted utilization, and
  delivered tokens per device-second.

CONSERVATION is the design contract (tested): a finished request's
ledgered token counts equal its delivered tokens exactly, its
``prefill_tokens + prefix_reused_tokens`` equal its prompt length, and
the device-seconds summed across all tenants equal the measured
dispatch busy time (every dispatch's wall clock is split across the
rows it advanced with weights summing to 1 — nothing is double-billed,
nothing vanishes).

Device-seconds are HOST-measured dispatch walls (the same clock the
iteration span uses), chosen so accounting adds NO synchronization
point to the hot path. Two deliberate consequences: (1) COLD
dispatches (the first call of each of the engine's programs, which
pays for library handles and allocator growth on the card) are
excluded from both attribution and the busy tally — billing that
set-up to whichever tenant arrived first would poison its
device-seconds forever, and conservation holds because both sides
skip; (2) on an asynchronously-dispatching backend
a prefill round that finishes no prompt measures only its enqueue
cost — the device compute it launched surfaces inside the next
BLOCKING dispatch's wall (usually the same iteration's decode step),
so per-kind splits and per-tenant shares are exact per iteration but
approximate per dispatch. The alternative (block on every chunk)
would trade the engine's measured inter-token latency for accounting
precision; this ledger refuses that trade.

Surfaces: ``RequestHandle.usage()``, ``engine.stats()["usage"]``,
``engine.debug_usage()`` behind ``GET /debug/usage``, a
``request/usage_final`` flight-recorder event per finished request,
and ``bdt_serving_tenant_*`` Prometheus counters.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Iterable, List, Optional, Tuple

#: dispatch kinds the ledger meters (the engine's two device loops)
KINDS = ("prefill", "decode")


class UsageRecord:
    """One request's metered resource consumption.

    Engine-side accumulator AND client-facing snapshot
    (``RequestHandle.usage()`` returns ``to_dict()``). Written by the
    engine loop thread; reads from client threads see a consistent
    per-field (float/int) picture — final once the request is done.
    """

    __slots__ = ("request_id", "tenant", "trace_id", "prompt_tokens",
                 "max_new_tokens", "submitted_at", "queue_wait_s",
                 "prefill_tokens", "prefix_reused_tokens",
                 "prefix_bytes_saved", "decode_tokens",
                 "device_prefill_s", "device_decode_s",
                 "kv_byte_seconds", "outcome", "preemptions",
                 "_staging_since", "_slot_since", "_requeued_at")

    def __init__(self, request_id: str, tenant: str,
                 prompt_tokens: int, max_new_tokens: int,
                 submitted_at: float = 0.0):
        self.request_id = request_id
        self.tenant = tenant
        #: distributed-trace correlation id (engine-stamped from
        #: ``submit(trace_id=...)``; None outside a traced fleet)
        self.trace_id: Optional[str] = None
        self.prompt_tokens = int(prompt_tokens)
        self.max_new_tokens = int(max_new_tokens)
        self.submitted_at = submitted_at
        #: submit -> admission (prefill started); queue-dropped
        #: requests get their full submit -> drop wait here instead
        self.queue_wait_s: Optional[float] = None
        #: prompt tokens this engine actually prefilled for the request
        self.prefill_tokens = 0
        #: prompt tokens served from the prefix cache (prefill skipped)
        self.prefix_reused_tokens = 0
        #: device KV bytes the cache hit avoided recomputing+writing
        self.prefix_bytes_saved = 0
        #: tokens delivered to the client (first token + decode steps)
        self.decode_tokens = 0
        #: pro-rata share of ragged prefill dispatch walls
        self.device_prefill_s = 0.0
        #: pro-rata share of fused decode dispatch walls
        self.device_decode_s = 0.0
        #: staging/slot row bytes x residency seconds (HBM held x time)
        self.kv_byte_seconds = 0.0
        #: terminal outcome once finalized (finished/cancelled/...)
        self.outcome: Optional[str] = None
        #: times this request's slot was preempted (residency up to
        #: the eviction stays billed to this record — preemption never
        #: un-bills the device time the victim already consumed)
        self.preemptions = 0
        # open residency intervals (row-bytes charged at close)
        self._staging_since: Optional[float] = None
        self._slot_since: Optional[float] = None
        # set while preempted-and-requeued: the next ``admitted`` adds
        # the requeue→re-admission span to queue_wait_s instead of
        # restarting the figure from submit
        self._requeued_at: Optional[float] = None

    @property
    def device_s(self) -> float:
        return self.device_prefill_s + self.device_decode_s

    def to_dict(self) -> dict:
        """The record as the plain dict every surface renders
        (``usage()``, ``/debug/usage`` top-N rows, the finished
        ring)."""
        return {
            "request_id": self.request_id,
            "tenant": self.tenant,
            "trace_id": self.trace_id,
            "outcome": self.outcome,
            "prompt_tokens": self.prompt_tokens,
            "queue_wait_s": (round(self.queue_wait_s, 6)
                             if self.queue_wait_s is not None else None),
            "prefill_tokens": self.prefill_tokens,
            "prefix_reused_tokens": self.prefix_reused_tokens,
            "prefix_bytes_saved": self.prefix_bytes_saved,
            "decode_tokens": self.decode_tokens,
            "device_prefill_s": round(self.device_prefill_s, 6),
            "device_decode_s": round(self.device_decode_s, 6),
            "device_s": round(self.device_s, 6),
            "kv_byte_seconds": round(self.kv_byte_seconds, 3),
            "preemptions": self.preemptions,
        }


def _zero_aggregate() -> dict:
    return {"requests": 0, "finished": 0, "preemptions": 0,
            "queue_wait_s": 0.0,
            "prefill_tokens": 0, "prefix_reused_tokens": 0,
            "prefix_bytes_saved": 0, "decode_tokens": 0,
            "device_s": 0.0, "kv_byte_seconds": 0.0}


class UsageLedger:
    """Thread-safe per-request / per-tenant usage meter for one
    serving engine.

    Flow (engine loop thread unless noted): ``begin`` at submit (any
    thread), ``admitted`` when prefill starts (closes the queue wait,
    opens the staging-row residency), ``add_prefill`` per chunk,
    ``slot_acquired`` when the staged prompt is inserted (staging
    residency closes, slot residency opens), ``delivered`` per token,
    ``charge_dispatch`` once per device dispatch with the rows it
    advanced, and ``finalize`` exactly once per request (any thread —
    the engine's ``_finish_handle`` arbitration guarantees a single
    finalizer) — which closes open residencies, folds the record into
    its tenant's aggregate, increments the
    ``bdt_serving_tenant_*`` counters, and records the
    ``request/usage_final`` flight-recorder event.

    TENANT CARDINALITY: the first ``max_tenants`` distinct tenant
    names each get their own aggregate (and label series); every
    later new name resolves to ``overflow_tenant`` — per-tenant
    Prometheus series stay bounded no matter what clients send.

    ``instruments`` is the engine's bound instrument namespace
    (``serving_engine_instruments``); the ledger feeds its goodput
    members when present (padding-waste histograms, device-second
    counters, utilization and tokens-per-device-second gauges) and
    works without them (unit tests meter bare).
    """

    def __init__(self, service: str = "engine", registry=None,
                 recorder=None, instruments=None,
                 max_tenants: int = 32, recent: int = 256,
                 slot_row_bytes: int = 0, staging_row_bytes: int = 0,
                 token_bytes: float = 0.0,
                 default_tenant: str = "default",
                 overflow_tenant: str = "other",
                 devices: int = 1):
        if max_tenants < 1:
            raise ValueError(
                f"max_tenants must be >= 1, got {max_tenants}")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        from bigdl_tpu_torch.observability.events import default_recorder
        from bigdl_tpu_torch.observability.instruments import (
            tenant_usage_instruments,
        )

        self.service = service
        self.max_tenants = max_tenants
        self.default_tenant = default_tenant
        self.overflow_tenant = overflow_tenant
        self.slot_row_bytes = int(slot_row_bytes)
        self.staging_row_bytes = int(staging_row_bytes)
        #: device KV bytes one cached token position occupies
        #: (row_bytes / cache_len) — the prefix-savings exchange rate
        self.token_bytes = float(token_bytes)
        #: devices one dispatch occupies (the SPMD mesh size for a
        #: tensor-parallel engine, 1 otherwise): every charged wall
        #: second becomes ``devices`` device-seconds on BOTH the
        #: per-tenant and the busy side, so conservation holds and
        #: tokens-per-device-second honestly divides by the hardware
        #: the sharded dispatch actually occupied
        self.devices = int(devices)
        self._rec = recorder if recorder is not None \
            else default_recorder()
        self._ins = instruments
        self._tins = tenant_usage_instruments(registry)
        self._lock = threading.Lock()
        #: tenant names that own their own aggregate (capped)
        self._known: set = set()
        self._tenants: Dict[str, dict] = {}
        self._recent: collections.deque = collections.deque(
            maxlen=recent)
        self._open = 0
        # goodput accumulators
        self._busy = {k: 0.0 for k in KINDS}
        self._weighted_rows = 0.0
        self._weighted_capacity = 0.0
        self._waste_sum = 0.0
        self._dispatches = 0
        self._tokens_delivered = 0

    # --------------------------------------------------------- lifecycle
    def resolve_tenant(self, tenant: Optional[str]) -> str:
        """Map a client-supplied tenant name to its billed label:
        ``default_tenant`` when unset, itself while the cardinality
        budget lasts, ``overflow_tenant`` afterwards (stable: a name
        admitted once keeps resolving to itself)."""
        t = str(tenant) if tenant else self.default_tenant
        with self._lock:
            if t in self._known:
                return t
            if len(self._known) >= self.max_tenants:
                return self.overflow_tenant
            self._known.add(t)
            return t

    def begin(self, request_id: str, tenant: Optional[str],
              prompt_tokens: int, max_new_tokens: int,
              submitted_at: float = 0.0) -> UsageRecord:
        """Open one request's record (submit time, any thread)."""
        rec = UsageRecord(request_id, self.resolve_tenant(tenant),
                          prompt_tokens, max_new_tokens, submitted_at)
        with self._lock:
            self._open += 1
        return rec

    def admitted(self, rec: UsageRecord, now: float,
                 reused_tokens: int = 0) -> None:
        """Prefill starts: close the queue wait, credit the prefix
        reuse (tokens and the KV bytes not recomputed), and open the
        staging-row residency. A RE-admission after preemption adds
        the requeue→now span to the accumulated queue wait instead of
        restarting the figure from submit (the first wait was already
        closed — double-billing it would inflate the tenant's queue
        seconds)."""
        if rec._requeued_at is not None:
            rec.queue_wait_s = ((rec.queue_wait_s or 0.0)
                                + max(0.0, now - rec._requeued_at))
            rec._requeued_at = None
        else:
            rec.queue_wait_s = max(0.0, now - rec.submitted_at)
        if reused_tokens:
            rec.prefix_reused_tokens += int(reused_tokens)
            rec.prefix_bytes_saved += int(reused_tokens
                                          * self.token_bytes)
        rec._staging_since = now

    def add_prefill(self, rec: UsageRecord, tokens: int) -> None:
        rec.prefill_tokens += int(tokens)

    def slot_acquired(self, rec: UsageRecord, now: float) -> None:
        """Staged prompt inserted into its pool slot: the staging-row
        residency closes into ``kv_byte_seconds`` and the slot-row
        residency opens."""
        if rec._staging_since is not None:
            # graftlint: ok[lock-discipline] — staging_row_bytes is immutable after __init__
            rec.kv_byte_seconds += (self.staging_row_bytes
                                    * max(0.0, now - rec._staging_since))
            rec._staging_since = None
        rec._slot_since = now

    def delivered(self, rec: UsageRecord, tokens: int = 1) -> None:
        rec.decode_tokens += int(tokens)
        with self._lock:
            self._tokens_delivered += int(tokens)

    def preempted(self, rec: UsageRecord, now: float) -> None:
        """The request's slot was preempted (NOT terminal — the
        request requeues and resumes): close the open slot/staging
        residency into ``kv_byte_seconds`` — the HBM it held up to the
        eviction stays billed to this record — and stamp the requeue
        time so the next ``admitted`` accumulates the second queue
        wait. Device-seconds already attributed are untouched:
        preemption never un-bills consumed device time."""
        if rec._staging_since is not None:
            # graftlint: ok[lock-discipline] — staging_row_bytes is immutable after __init__
            rec.kv_byte_seconds += (self.staging_row_bytes
                                    * max(0.0, now - rec._staging_since))
            rec._staging_since = None
        if rec._slot_since is not None:
            # graftlint: ok[lock-discipline] — slot_row_bytes is immutable after __init__
            rec.kv_byte_seconds += (self.slot_row_bytes
                                    * max(0.0, now - rec._slot_since))
            rec._slot_since = None
        rec.preemptions += 1
        rec._requeued_at = now

    def accrue_kv(self, rec: UsageRecord, byte_seconds: float) -> None:
        """Paged-KV billing: add ``byte_seconds`` of device KV
        residency measured externally. A paged engine integrates each
        holder's pro-rata page footprint (``PagePool.holder_bytes`` —
        a page shared by r requests bills 1/r to each, so the sum over
        holders equals the pool's live bytes) over every loop
        iteration and feeds it here; its ledger is constructed with
        ``slot_row_bytes=staging_row_bytes=0`` so the dense
        row-residency bookkeeping above contributes nothing and the
        two billing models never double-count. Loop thread only."""
        rec.kv_byte_seconds += max(0.0, float(byte_seconds))

    # --------------------------------------------------------- dispatch
    def charge_dispatch(self, kind: str, wall_s: float,
                        shares: Iterable[Tuple[Optional[UsageRecord],
                                               float]],
                        rows_advanced: int, capacity_rows: int) -> None:
        """Meter one device dispatch: attribute its FULL host wall
        pro-rata across the rows it advanced (``shares`` weights sum
        to 1 — conservation), and fold the padded-idle fraction into
        the goodput accumulators + instruments. Loop thread only."""
        # graftlint: ok[lock-discipline] — key-membership only; _busy's keys are fixed at __init__
        if kind not in self._busy:
            raise ValueError(f"unknown dispatch kind {kind!r}; "
                             f"expected one of {KINDS}")
        # one SPMD dispatch occupies every mesh device for its wall:
        # the billable quantity is wall x devices, on both sides
        wall_s = max(0.0, float(wall_s)) * self.devices
        attr = ("device_prefill_s" if kind == "prefill"
                else "device_decode_s")
        for rec, w in shares:
            if rec is not None:
                setattr(rec, attr, getattr(rec, attr) + wall_s * w)
        capacity_rows = max(1, int(capacity_rows))
        waste = max(0.0, (capacity_rows - rows_advanced)
                    / capacity_rows)
        with self._lock:
            self._busy[kind] += wall_s
            self._weighted_rows += rows_advanced * wall_s
            self._weighted_capacity += capacity_rows * wall_s
            self._waste_sum += waste
            self._dispatches += 1
            busy_total = sum(self._busy.values())
            tokens = self._tokens_delivered
            util = (self._weighted_rows / self._weighted_capacity
                    if self._weighted_capacity else 0.0)
        ins = self._ins
        if ins is not None:
            ctr = getattr(ins, f"device_{kind}_seconds_total", None)
            if ctr is not None:
                ctr.inc(wall_s)
            hist = getattr(ins, f"padding_waste_{kind}", None)
            if hist is not None:
                hist.observe(waste)
            gauge = getattr(ins, "utilization", None)
            if gauge is not None:
                gauge.set(util)
            gauge = getattr(ins, "tokens_per_device_second", None)
            if gauge is not None and busy_total > 0:
                gauge.set(tokens / busy_total)

    # --------------------------------------------------------- terminal
    def finalize(self, rec: UsageRecord, outcome: str,
                 now: float) -> None:
        """Terminal accounting for one request (exactly once — later
        calls are no-ops): close open residencies, aggregate under the
        tenant, bump the tenant counters, ring the record, and record
        ``request/usage_final``."""
        with self._lock:
            if rec.outcome is not None:
                return
            rec.outcome = outcome
            self._open -= 1
            if rec.queue_wait_s is None:
                # never admitted (queue-dropped / rejected): its whole
                # life was queue wait — billed, not vanished
                rec.queue_wait_s = max(0.0, now - rec.submitted_at)
            if rec._staging_since is not None:
                rec.kv_byte_seconds += (
                    self.staging_row_bytes
                    * max(0.0, now - rec._staging_since))
                rec._staging_since = None
            if rec._slot_since is not None:
                rec.kv_byte_seconds += (
                    self.slot_row_bytes
                    * max(0.0, now - rec._slot_since))
                rec._slot_since = None
            agg = self._tenants.setdefault(rec.tenant,
                                           _zero_aggregate())
            agg["requests"] += 1
            if outcome == "finished":
                agg["finished"] += 1
            agg["preemptions"] += rec.preemptions
            if rec.queue_wait_s is not None:
                agg["queue_wait_s"] += rec.queue_wait_s
            agg["prefill_tokens"] += rec.prefill_tokens
            agg["prefix_reused_tokens"] += rec.prefix_reused_tokens
            agg["prefix_bytes_saved"] += rec.prefix_bytes_saved
            agg["decode_tokens"] += rec.decode_tokens
            agg["device_s"] += rec.device_s
            agg["kv_byte_seconds"] += rec.kv_byte_seconds
            self._recent.append(rec.to_dict())
        t = self._tins
        lbl = (self.service, rec.tenant)
        t.requests_total.labels(*lbl).inc()
        t.prefill_tokens_total.labels(*lbl).inc(rec.prefill_tokens)
        t.decode_tokens_total.labels(*lbl).inc(rec.decode_tokens)
        t.prefix_reused_tokens_total.labels(*lbl).inc(
            rec.prefix_reused_tokens)
        t.queue_seconds_total.labels(*lbl).inc(rec.queue_wait_s or 0.0)
        t.device_seconds_total.labels(*lbl).inc(rec.device_s)
        t.kv_byte_seconds_total.labels(*lbl).inc(rec.kv_byte_seconds)
        self._rec.record("request/usage_final", rec.request_id,
                         service=self.service, tenant=rec.tenant,
                         outcome=outcome,
                         prefill_tokens=rec.prefill_tokens,
                         prefix_reused_tokens=rec.prefix_reused_tokens,
                         decode_tokens=rec.decode_tokens,
                         device_s=round(rec.device_s, 6),
                         kv_byte_seconds=round(rec.kv_byte_seconds, 3))

    # -------------------------------------------------------- snapshots
    def device_time(self) -> dict:
        """Measured dispatch busy seconds by kind — the conservation
        reference the per-tenant device-second sums must match.
        Nanosecond (9dp) rounding: these figures are compared against
        independently-rounded sums at 1e-6 relative tolerance, and
        microsecond rounding noise across a handful of terms is the
        same order as that budget."""
        with self._lock:
            out = {k: round(v, 9) for k, v in self._busy.items()}
            total = sum(self._busy.values())
        out["total"] = round(total, 9)
        return out

    def goodput(self) -> dict:
        """The engine-level efficiency figures: measured busy time,
        wall-weighted occupancy utilization, mean per-dispatch padding
        waste, and delivered tokens per device-second."""
        with self._lock:
            busy = {k: round(v, 9) for k, v in self._busy.items()}
            total = sum(self._busy.values())
            util = (self._weighted_rows / self._weighted_capacity
                    if self._weighted_capacity else 0.0)
            waste = (self._waste_sum / self._dispatches
                     if self._dispatches else 0.0)
            tokens = self._tokens_delivered
            dispatches = self._dispatches
        return {
            "device_seconds": {**busy, "total": round(total, 9)},
            "dispatches": dispatches,
            "utilization": round(util, 4),
            "padding_waste_mean": round(waste, 4),
            "tokens_delivered": tokens,
            "tokens_per_device_second": (round(tokens / total, 2)
                                         if total > 0 else 0.0),
        }

    def tenants(self) -> Dict[str, dict]:
        """Per-tenant aggregates over FINALIZED requests, with the
        derived tokens-per-device-second each tenant achieved."""
        with self._lock:
            snap = {t: dict(agg) for t, agg in self._tenants.items()}
        for agg in snap.values():
            agg["queue_wait_s"] = round(agg["queue_wait_s"], 6)
            # 9dp: per-tenant device_s sums are conservation-checked
            # against device_time() at 1e-6 relative — see there
            agg["device_s"] = round(agg["device_s"], 9)
            agg["kv_byte_seconds"] = round(agg["kv_byte_seconds"], 3)
            agg["tokens_per_device_second"] = (
                round(agg["decode_tokens"] / agg["device_s"], 2)
                if agg["device_s"] > 0 else 0.0)
        return snap

    def totals(self) -> dict:
        """The tenant aggregates summed — engine-wide flow totals plus
        the in-flight (not yet finalized) request count."""
        out = _zero_aggregate()
        with self._lock:
            for agg in self._tenants.values():
                for k in out:
                    out[k] += agg[k]
            out["in_flight"] = self._open
        out["queue_wait_s"] = round(out["queue_wait_s"], 6)
        out["device_s"] = round(out["device_s"], 9)
        out["kv_byte_seconds"] = round(out["kv_byte_seconds"], 3)
        return out

    def top_requests(self, n: int = 10) -> List[dict]:
        """The ``n`` most device-expensive recently finished requests
        (from the bounded ring) — "who is eating the engine", by
        name."""
        with self._lock:
            recent = list(self._recent)
        recent.sort(key=lambda r: r["device_s"], reverse=True)
        return recent[:max(0, int(n))]

    def summary(self, top_n: int = 0) -> dict:
        """The ``stats()["usage"]`` / ``/debug/usage`` payload:
        per-tenant table, engine totals, goodput block, and (when
        ``top_n``) the top-N requests by attributed device-seconds."""
        out = {
            "tenants": self.tenants(),
            "totals": self.totals(),
            "goodput": self.goodput(),
            # graftlint: ok[lock-discipline] — max_tenants is immutable after __init__
            "max_tenants": self.max_tenants,
            "devices": self.devices,
        }
        if top_n:
            out["top_requests"] = self.top_requests(top_n)
        return out
