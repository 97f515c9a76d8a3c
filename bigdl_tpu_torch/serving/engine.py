"""Continuous-batching decode engine over a slot-pooled or paged KV cache
(port of ``bigdl_tpu/serving/engine.py``: dense slots, paged KV,
speculative decoding, int8 KV and weights, the prefix host tier, QoS,
chaos drills, usage metering and SLO burn detection).

The batch-at-a-time ``GenerationService`` runs each batch to completion:
one long request holds every co-batched short one. This engine keeps a
persistent decode loop instead:

- ONE pooled KV cache of shape ``(max_slots, H_kv, cache_len, D)`` per
  layer lives on the device for the engine's whole life, beside a
  ``prefill_rows``-wide staging cache and the prefix cache's pool. The
  JAX engine threads these through donated programs; here they are
  persistent tensors written in place (``index_put_`` / ``copy_``), in
  stream order, so a row copy always reads before a later write of its
  source row.
- a loop thread runs one fused ragged ``decode_step`` over ALL slots per
  iteration (each row at its own position; free slots ride along at
  position 0 and write junk only into their own row, which the next
  insert overwrites), so requests join and leave the batch at token
  granularity. One host sync per iteration reads the next tokens.
- admission happens mid-flight: queued requests prefill in fixed chunks
  into the staging cache under a per-iteration token budget
  (``PrefillPolicy``); each prefill round advances every staged
  admission by one chunk through one ragged ``prefill_chunk_at`` (idle
  staging rows ride along at offset 0), and a finished staging row is
  copied into its reserved slot.
- prompts are prefix-cached: a host-side radix trie (``PrefixCache``)
  indexes retained pool rows by token prefix. A hit copies the pool row
  into the staging row and prefills only the tail from the reuse base,
  which is aligned down to a chunk multiple and capped at ``t0 - 1`` so
  the tail's chunk geometry (and with it the numerics) matches a cold
  prefill's. A finishing slot donates its KV before the slot is freed.
- with ``page_size`` (paged KV, ``serving/paging.py``) every KV surface
  becomes one refcounted page pool of ``(max_pages, H_kv, page_size,
  D)`` tensors a layer: an admission reserves its whole span (prompt +
  new tokens + the draft's verify headroom) as a ``BlockTable`` and
  prefills straight through it, a prefix hit SHARES the entry's
  page-aligned head (no row copy), donation shares the slot's pages
  into the index, and a request the pool cannot hold waits at the
  queue head. Idle lanes carry all-scratch tables, so their junk
  writes land on page 0.
- with ``draft`` (speculative decoding) each iteration is draft-propose
  / target-verify: the draft proposes ``spec_gamma`` tokens for every
  live slot (gamma draft decode steps), the target scores them all in
  one ragged ``verify_chunk``, and each row accepts its own 1..gamma+1
  token burst; one host sync reads the accepted counts and tokens
  together. The draft owns its slot pool and staging (or its own page
  pool), in lockstep with the target's, and prefills the full prompt
  beside the target's chunks.

- with ``kv_dtype="int8"`` every KV surface (slots, staging, prefix
  pool, page pool, the draft's pools) holds int8 codes and f32 scales
  per (row, head, position), quantized where they are written and
  dequantized inside attention; ``weights_dtype="int8"`` serves through
  ``Quantizer.quantize(model)``, the int8 clone (``nn/quantized.py``).
- with ``prefix_host_bytes`` / ``prefix_host_rows`` the prefix cache has
  a host tier: a device entry the LRU evicts is DEMOTED (its pool row,
  or its pages, copied to pinned host tensors, int8 codes and scales as
  they are) instead of dropped, and a hit on a host entry PROMOTES it
  back before the admission reads it. Every copy runs on the engine's
  stream, so a demotion's copy reads the row before the write that
  reuses it, and a promotion's copy lands before the prefill that reads
  it. Dense promotions start at scoring time (``_begin_promotion``), to
  overlap the request's queue wait.

Greedy output is token-identical to a lone ``model.generate`` per
request, with the prefix cache cold or warm, paged or dense, with a
draft or without (tested against the JAX engine on the same weights).
Under int8 weights each Linear's activation scale spans the whole batch,
idle lanes included: rows equal the JAX engine's in the same
configuration, with the prefix cache and its host tier or without, but
not a lone ``generate``'s, and paged idle lanes (other junk) or a
verify chunk (gamma + 1 positions a row) can move the scale, and a
token, against plain dense decode.
Sampling draws from a ``torch.Generator`` on the engine's device seeded
by ``seed``; with a draft it runs speculative sampling (accept
min(1, p/q), the residual on rejection) from the same generator.

- QoS: a ``high``-class request queued past ``preempt_slack_s`` with
  every slot busy PREEMPTS the lowest-class, longest-remaining slot: the
  victim's KV (prompt + generated) is donated to the prefix cache and
  pinned, the victim requeues at the head, and its re-admission
  re-prefills only what the donated entry does not cover, so it resumes
  token-identical. Under a TTFT burn (an active ``SloWatchdog`` alert on
  a ``metric="ttft"`` objective, or the ``ChaosInjector``'s synthetic
  one) ``submit`` refuses the ``shed_classes`` with ``RequestShed``, and
  a tenant past its device-second ``TokenBucket`` with
  ``RequestRateLimited``; both carry ``retry_after_s``.
- every request is metered by a ``UsageLedger``
  (``observability/accounting.py``): queue wait, prefilled and reused
  prompt tokens, delivered tokens, KV byte-seconds, and device-seconds
  split pro-rata across the rows each dispatch advanced (host walls
  from the launch to the host read that ends the dispatch; no sync is
  added for the bill). The token buckets debit what it measured.
- ``chaos`` (``serving/chaos.py``) scripts a TTFT burn, a dispatch fault
  (the loop crashes; every waiting handle fails with ``EngineStopped``)
  or a frozen slot (it sits out the decode while the others stream).

Tensor-parallel serving (``mesh`` / ``tp_rules``) raises
``NotImplementedError`` naming its ``ROADMAP.md`` item; the rest of the
observability hooks (recorder, metric instruments, memory pools, budget
tracker, recompile watchdog, time series, incidents, cost model,
loop-phase accounting) are not ported yet, and ``registry=`` /
``recorder=`` are accepted and unused.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.models.transformer import (
    _draw, _filter_logits, _spec_accept, _validate_sampling,
)
from bigdl_tpu_torch.nn.quantized import Quantizer
from bigdl_tpu_torch.observability import (
    Histogram, SloObjective, SloWatchdog, UsageLedger,
)
from bigdl_tpu_torch.serving.paging import (
    BlockTable, PagedPrefixIndex, PagePool,
)
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.scheduler import (
    AdmissionQueue, PrefillPolicy, SpeculationPolicy, TokenBucket,
    page_fit_score, pages_needed,
)
from bigdl_tpu_torch.serving.streams import (
    PRIORITY_RANK, EngineDraining, EngineStopped, RequestCancelled,
    RequestHandle, RequestRateLimited, RequestShed, RequestTimedOut,
)

#: options of the JAX engine that a later step of this port brings: the
#: ROADMAP.md Queue 1 item that brings each, and the step's name
_LATER = {
    "mesh": (10, "tensor-parallel serving"),
    "tp_rules": (10, "tensor-parallel serving"),
}

#: the flow counters ``stats()`` reports (the JAX engine's
#: ``_stats_base``), then this port's loop tallies
_FLOW = ("admitted", "finished", "evicted", "timed_out", "cancelled")
_TALLIES = ("iterations", "prefill_rounds", "decode_steps")


def _later(what: str) -> NotImplementedError:
    item, step = _LATER[what]
    return NotImplementedError(
        f"{what} belongs to a later step of the engine's port "
        f"(ROADMAP.md, Queue 1 item {item}: {step}); this engine serves "
        "one device: dense or paged KV, float or int8, with or without a "
        "draft and a prefix host tier")


def _percentile_summary(values) -> dict:
    """Nearest-rank ``{count, mean, p50, p90, p99}`` of a small sample
    (None entries skipped), as the JAX engine's ``stats()`` reports each
    timeline phase."""
    xs = sorted(v for v in values if v is not None)
    if not xs:
        return {"count": 0, "mean": None, "p50": None, "p90": None,
                "p99": None}

    def q(p: float) -> float:
        return xs[min(len(xs) - 1, int(round(p * (len(xs) - 1))))]

    return {"count": len(xs), "mean": sum(xs) / len(xs),
            "p50": q(0.50), "p90": q(0.90), "p99": q(0.99)}


class _Admission:
    """Host-side progress of one chunked prefill: up to ``prefill_rows``
    are in flight at once, each owning one staging row (in paged mode, a
    lane of the prefill call) and one reserved slot; every prefill round
    advances all of them by one chunk."""

    __slots__ = ("handle", "slot", "row", "ids", "t0", "base", "tail",
                 "n_chunks", "next_chunk", "entry", "d_ids", "d_n_chunks",
                 "d_next_chunk", "table", "d_table")

    def __init__(self, handle: RequestHandle, slot: int, row: int,
                 ids: np.ndarray, t0: int, base: int, n_chunks: int,
                 entry=None, d_ids=None, d_n_chunks: int = 0):
        self.handle = handle
        self.slot = slot          # reserved pool slot (insert target)
        self.row = row            # staging row this prefill owns
        self.ids = ids            # (n_chunks * chunk,) right-padded tail
        self.t0 = t0              # full prompt length
        self.base = base          # chunk-aligned cached-prefix offset
        self.tail = t0 - base     # tokens actually prefilled
        self.n_chunks = n_chunks
        self.next_chunk = 0
        self.entry = entry        # pinned PrefixEntry on a dense hit
        #: speculative decoding: the draft prefills the FULL prompt (the
        #: prefix cache holds target KV only), so its cursor lags the
        #: target's on a hit; the admission completes when both caches
        #: hold the prompt
        self.d_ids = d_ids        # (d_n_chunks * chunk,) full prompt
        self.d_n_chunks = d_n_chunks
        self.d_next_chunk = 0
        #: paged mode: the BlockTables this admission writes through
        #: (its full span, reserved at admission), handed to the slot on
        #: completion and freed on abort
        self.table: Optional[BlockTable] = None
        self.d_table: Optional[BlockTable] = None


class _SlotState:
    """Host-side view of one occupied KV slot."""

    __slots__ = ("handle", "pos", "last_token", "last_token_at",
                 "delivered")

    def __init__(self, handle: RequestHandle, pos: int, last_token: int,
                 now: float):
        self.handle = handle
        #: cache position the next decode step writes: the slot's KV
        #: covers [0, pos), the last delivered token's KV is not cached
        #: yet (generate()'s host-loop invariant, which donation and
        #: preemption use); a speculative burst of m tokens moves pos by
        #: m and keeps it
        self.pos = pos
        self.last_token = last_token
        self.last_token_at = now
        self.delivered = 1


class ContinuousBatchingEngine:
    """Token-granular continuous batching over ``TransformerLM``'s
    incremental-decoding API (``init_cache`` / ``prefill_chunk_at`` /
    ``decode_step`` and their paged twins), with prefix-cached, batched
    multi-row prefill and optional speculative decoding.

    ``submit()`` returns a ``RequestHandle`` at once (bounded queue;
    ``QueueFull`` is the backpressure signal) and the loop thread streams
    tokens into it. The sampling config is fixed per engine; the default
    is greedy. ``prefix_cache_bytes`` sets the prefix pool's byte budget
    (None: two pool rows per slot; 0 disables the cache),
    ``prefix_cache_rows`` its row count directly (in paged mode, its
    entry count: the page pool bounds its bytes), ``prefix_min_tokens``
    (default one chunk) the shortest reusable head; with
    ``admission_window > 1`` the queue pops the candidate with the
    longest usable cached prefix among the first ``admission_window``
    (bounded bypass, see ``AdmissionQueue.pop_ready``).
    ``prefill_rows`` widens the staging cache so that that many
    admissions prefill together through one ragged call a round.

    ``page_size`` switches every KV surface to one refcounted page pool
    of ``max_pages`` pages (default ``1 + 2 * max_slots * table_len``,
    room for every slot at full length plus as much again for retained
    prefixes; page 0 is the scratch page); ``prefill_chunk`` must be a
    multiple of ``page_size``, so a prefix hit's shared pages are never
    written. ``draft`` (a smaller ``TransformerLM`` over the same
    vocabulary, on the same device) turns each decode iteration into
    ``spec_gamma`` draft proposals and one target verify; greedy rows
    stay exact, and ``top_k`` / ``top_p`` are refused with a draft (the
    acceptance identity needs the unfiltered distributions).

    The engine runs on ``device`` (default: the model's device; a device
    that differs from the model's raises).

    QoS: ``priority`` (``"high"`` / ``"normal"`` / ``"low"``) orders the
    admission queue. With every slot busy, a high-class request queued
    past ``preempt_slack_s`` (None disables) preempts the lowest-class,
    longest-remaining slot, which resumes token-identical; high slots
    are never preempted. While the TTFT SLO burns, ``shed_classes``
    (``"low"`` on any burn, ``"normal"`` too once the burn is severe,
    never ``"high"``) are refused with ``RequestShed``;
    ``tenant_rate_limits`` (``{tenant: (rate, burst)}`` or ``{"rate":,
    "burst":}`` in device-seconds, ``"*"`` the default) meter each
    tenant through a post-paid ``TokenBucket`` (``RequestRateLimited``).
    ``slo_objectives`` (``SloObjective``s or their keyword dicts, each
    naming the ``"ttft"``, ``"inter_token"`` or ``"queue_wait"``
    histogram) drive an ``SloWatchdog`` sampled once an iteration;
    ``chaos`` is a ``ChaosInjector``. ``usage_tenants`` caps the
    ledger's tenant table (later names bill to ``"other"``) and
    ``usage_recent`` bounds its ring of finished records.

    ``kv_dtype="int8"`` stores every KV pool as int8 codes plus f32
    scales (a row costs (D + 4) / (D * itemsize) of the float row, so a
    byte budget holds that many more prefix rows); ``weights_dtype=
    "int8"`` serves through the int8 ``Quantizer`` clone of ``model``
    (the model itself is left as it was). ``prefix_host_bytes`` (or
    ``prefix_host_rows``) sizes the prefix cache's host tier in
    full-length rows: evicted entries demote to pinned host memory and
    promote back on a hit (0 or None: eviction drops)."""

    def __init__(self, model, max_slots: int = 4,
                 max_len: Optional[int] = None, prefill_chunk: int = 16,
                 prefill_budget_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k=None, top_p=None, queue_capacity: int = 64,
                 seed: int = 0, registry=None,
                 service_name: str = "engine",
                 idle_wait_s: float = 0.5, recorder=None,
                 recent_timelines: int = 256,
                 prefill_rows: int = 1,
                 prefix_cache_bytes: Optional[int] = None,
                 prefix_cache_rows: Optional[int] = None,
                 prefix_host_bytes: Optional[int] = None,
                 prefix_host_rows: Optional[int] = None,
                 prefix_min_tokens: Optional[int] = None,
                 admission_window: int = 4,
                 slo_objectives=None, usage_tenants: int = 32,
                 usage_recent: int = 256,
                 draft=None, spec_gamma: int = 4, mesh=None, tp_rules=None,
                 kv_dtype: Optional[str] = None,
                 weights_dtype: Optional[str] = None,
                 preempt_slack_s: Optional[float] = 0.25,
                 shed_classes=("low",),
                 tenant_rate_limits=None, chaos=None,
                 page_size: Optional[int] = None,
                 max_pages: Optional[int] = None, device=None):
        for name, val in (("mesh", mesh), ("tp_rules", tp_rules)):
            if val is not None:
                raise _later(name)
        if preempt_slack_s is not None and preempt_slack_s < 0:
            raise ValueError(f"preempt_slack_s must be >= 0 or None, "
                             f"got {preempt_slack_s}")
        for p in tuple(shed_classes or ()):
            if p not in PRIORITY_RANK or p == "high":
                raise ValueError(
                    f"shed_classes may contain 'low'/'normal', "
                    f"got {p!r}")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if admission_window < 1:
            raise ValueError(
                f"admission_window must be >= 1, got {admission_window}")
        _validate_sampling(temperature > 0.0, top_k, top_p)
        for name, val in (("kv_dtype", kv_dtype),
                          ("weights_dtype", weights_dtype)):
            if val is not None and str(val) != "int8":
                raise ValueError(
                    f"{name} must be None (full precision) or 'int8', "
                    f"got {val!r}")
        self.kv_dtype = "int8" if kv_dtype is not None else None
        self.weights_dtype = "int8" if weights_dtype is not None else None
        if device is None:
            dev = model.device
        else:
            dev = resolve_device(device)
            if dev.type != model.device.type or (
                    dev.index is not None
                    and dev.index != model.device.index):
                raise ValueError(
                    f"the model lives on {model.device}, not on {dev}: "
                    "build the model on the engine's device")
        self.device = model.device
        if self.weights_dtype == "int8":
            # serve through the int8 clone: every Linear's weight becomes
            # int8 codes and per-channel scales (buffers)
            model = Quantizer.quantize(model)
        model.evaluate()
        self.model = model
        self.max_slots = max_slots
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        self.draft = draft
        self._spec: Optional[SpeculationPolicy] = None
        if draft is not None:
            if draft.vocab_size != model.vocab_size:
                raise ValueError(
                    f"draft vocab ({draft.vocab_size}) must match the "
                    f"target's ({model.vocab_size}): acceptance compares "
                    "distributions token for token")
            if temperature > 0.0 and (top_k is not None
                                      or top_p is not None):
                raise ValueError(
                    "speculative sampling accepts with min(1, p/q) over "
                    "the UNFILTERED tempered distributions; top_k/top_p "
                    "would break the acceptance identity: drop them or "
                    "drop the draft")
            if draft.device != model.device:
                raise ValueError(
                    f"the draft lives on {draft.device}, the model on "
                    f"{model.device}: build both on the engine's device")
            draft.evaluate()
            self._spec = SpeculationPolicy(spec_gamma)
        self.idle_wait_s = idle_wait_s
        self.service_name = service_name
        self.admission_window = admission_window
        #: bounded ring of finished-request timelines: the source of the
        #: stats() percentiles; the lock covers append vs. snapshot
        self._timelines: collections.deque = collections.deque(
            maxlen=recent_timelines)
        self._timelines_lock = threading.Lock()
        self._policy = PrefillPolicy(prefill_chunk, prefill_budget_tokens,
                                     prefill_rows)
        c = self._policy.chunk
        # the cache length rounds the serving window UP to a chunk
        # multiple (the last prefill chunk is padded, and forward_chunk's
        # caller contract is pos0 + chunk <= cache length); if that
        # overflows the model's own context, the window rounds DOWN
        # instead and admission caps t0 + n at the reduced window
        cap = min(max_len or model.max_len, model.max_len)
        cache_len = -(-cap // c) * c
        if cache_len > model.max_len:
            cache_len = (model.max_len // c) * c
            cap = cache_len
        if cache_len < c:
            raise ValueError(
                f"prefill_chunk {c} exceeds the usable context {cap}")
        self.max_len = cap
        self._cache_len = cache_len
        # speculation pads every KV row by gamma positions: a verify
        # round launched at the window's last decodable position still
        # writes gamma (possibly rejected) proposal positions past it.
        # JAX clamps such a write (corrupting the row's prefix); on CUDA
        # an out-of-range index is a device assert. The padding is
        # position-masked until overwritten
        phys_len = cache_len + (self._spec.kv_headroom
                                if self._spec is not None else 0)
        self._phys_len = phys_len
        if draft is not None and draft.max_len < cap:
            raise ValueError(
                f"draft context ({draft.max_len}) is shorter than the "
                f"engine's serving window ({cap}); shrink max_len or "
                "bring a longer-context draft")

        self.paged = page_size is not None
        if max_pages is not None and not self.paged:
            raise ValueError("max_pages requires page_size (paged mode)")
        self.page_size: Optional[int] = None
        self._table_len = 0
        if self.paged:
            page_size = int(page_size)
            if page_size < 1:
                raise ValueError(
                    f"page_size must be >= 1, got {page_size}")
            if c % page_size != 0:
                raise ValueError(
                    f"prefill_chunk ({c}) must be a multiple of "
                    f"page_size ({page_size}): the chunk-aligned reuse "
                    "boundary must land on a page boundary, or a hit's "
                    "shared pages would be written under a live share "
                    "(the copy-on-write invariant paging.py documents)")
            self.page_size = page_size
            #: fixed block-table width: every table is padded to the
            #: worst-case page count, so dispatch shapes never depend on
            #: any one request's length
            self._table_len = -(-phys_len // page_size)
            if max_pages is None:
                max_pages = 1 + 2 * max_slots * self._table_len
            max_pages = int(max_pages)
            if max_pages < 1 + self._table_len:
                raise ValueError(
                    f"max_pages ({max_pages}) cannot hold one "
                    f"full-length request ({self._table_len} pages) "
                    "plus the reserved scratch page")

        # the persistent device tensors, allocated as inference tensors:
        # the loop writes them in place under inference_mode
        self._caches = self._staging = self._kv_pool = None
        self._pages: Optional[PagePool] = None
        self._tables: Optional[List[Optional[BlockTable]]] = None
        self._d_caches = self._d_staging = self._d_kv_pool = None
        self._d_pages: Optional[PagePool] = None
        self._d_tables: Optional[List[Optional[BlockTable]]] = None
        dtype = model.tok_embed.dtype
        kv = self.kv_dtype
        with torch.inference_mode():
            if self.paged:
                # THE page pool: no staging cache (admissions prefill
                # straight through their reserved tables) and no prefix
                # pool (retained prefixes share these same pages)
                self._kv_pool = model.init_page_pool(max_pages, page_size,
                                                     dtype, kv)
                self._pages = PagePool(self._kv_pool, page_size)
                self._tables = [None] * max_slots
                # a dense slot of this geometry: the exchange rate of
                # the prefix budget and the reuse credits
                row_bytes = self._table_len * self._pages.page_bytes
            else:
                self._caches = model.init_cache(max_slots, phys_len, dtype,
                                                kv)
                self._staging = model.init_cache(self._policy.prefill_rows,
                                                 phys_len, dtype, kv)
                # summed over every leaf: under int8 the codes AND the
                # scales, the true physical cost of a row
                row_bytes = sum(int(t.nbytes) for layer in self._caches
                                for t in layer) // max_slots
            if draft is not None and self.paged:
                # the draft's own page pool: it never shares pages (the
                # prefix index retains target KV only), so at most
                # max_slots tables: a draft reservation cannot fail once
                # the target's succeeded
                self._d_kv_pool = draft.init_page_pool(
                    1 + max_slots * self._table_len, page_size,
                    draft.tok_embed.dtype, kv)
                self._d_pages = PagePool(self._d_kv_pool, page_size)
                self._d_tables = [None] * max_slots
            elif draft is not None:
                # the draft's slot pool and staging mirror the target's
                # geometry row for row (same phys_len)
                d_dtype = draft.tok_embed.dtype
                self._d_caches = draft.init_cache(max_slots, phys_len,
                                                  d_dtype, kv)
                self._d_staging = draft.init_cache(
                    self._policy.prefill_rows, phys_len, d_dtype, kv)
            self._row_bytes = row_bytes
            #: the same row at full precision: the capacity multiplier
            #: int8 KV buys is fp_row_bytes / row_bytes
            attn = model.blocks()[0].attn
            self._fp_row_bytes = (2 * model.num_layers * attn.num_kv_heads
                                  * phys_len * attn.head_dim
                                  * dtype.itemsize)
            #: device KV bytes one cached token position costs
            self._token_bytes = row_bytes / phys_len
            if prefix_cache_rows is not None:
                pool_rows = max(0, int(prefix_cache_rows))
            elif prefix_cache_bytes is None:
                pool_rows = 2 * max_slots
            else:
                pool_rows = max(0, int(prefix_cache_bytes) // row_bytes)
            # the host tier behind the device pool, in full-length rows
            # (0: eviction drops)
            if prefix_host_rows is not None:
                host_rows = max(0, int(prefix_host_rows))
            elif prefix_host_bytes is None:
                host_rows = 0
            else:
                host_rows = max(0, int(prefix_host_bytes) // row_bytes)
            self._pool = None
            min_tokens = (prefix_min_tokens if prefix_min_tokens is not None
                          else c)
            if pool_rows > 0 and self.paged:
                # pages as the retention currency: pool_rows bounds the
                # entry count, the shared page pool bounds the bytes
                self._prefix = PagedPrefixIndex(
                    self._pages, max_entries=pool_rows,
                    min_tokens=min_tokens, token_bytes=self._token_bytes,
                    host_pages=host_rows * self._table_len)
            elif pool_rows > 0:
                self._pool = model.init_cache(pool_rows, phys_len, dtype,
                                              kv)
                self._prefix = PrefixCache(
                    pool_rows, row_bytes, min_tokens=min_tokens,
                    token_bytes=self._token_bytes, host_rows=host_rows)
            else:
                self._prefix = None
        #: dense host-to-device promotions in flight, by entry identity:
        #: {"entry", "tree" (the device copy), "touched" (monotonic
        #: stamp)}; each record pins its entry, so the host buffer cannot
        #: be evicted while its copy runs
        self._promotions: dict = {}
        self._promotions_max = max(4, 2 * self._policy.prefill_rows)
        #: prompt tokens this engine actually prefilled (the reused
        #: fraction's denominator)
        self._prefilled_tokens = 0
        #: speculative tallies behind stats()["speculation"]
        self._spec_proposed = 0
        self._spec_accepted = 0
        #: paged: set when the pool refused the queue head this
        #: iteration (re-probed next iteration instead of thrashing
        #: pop/requeue within one); ``_page_waits`` counts the refusals
        self._adm_blocked = False
        self._page_waits = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        # the latency histograms the JAX engine feeds its ttft /
        # inter-token / queue-wait instruments with: the SLO watchdog's
        # inputs (unregistered: the port exports no metric yet)
        self._hists = {"ttft": Histogram(), "inter_token": Histogram(),
                       "queue_wait": Histogram()}
        #: per-request / per-tenant usage meter. Paged mode bills KV
        #: byte-seconds per actually-held page (``_accrue_paged_kv``),
        #: so the dense row-residency terms are zero there
        self._usage = UsageLedger(
            service=service_name, registry=registry, recorder=recorder,
            max_tenants=usage_tenants, recent=usage_recent,
            slot_row_bytes=0 if self.paged else row_bytes,
            staging_row_bytes=0 if self.paged else row_bytes,
            token_bytes=self._token_bytes)
        #: the programs that have run once: a program's first call pays
        #: for library handles and allocator growth, so its wall is not
        #: billed (the JAX engine's warm set, whose cold call compiles)
        self._warm: set = set()
        self._last_kv_accrue: Optional[float] = None
        self._slo_wd = SloWatchdog(service=service_name, registry=registry,
                                   recorder=recorder)
        for obj in (slo_objectives or ()):
            if isinstance(obj, dict):
                obj = SloObjective(**obj)
            if obj.metric not in self._hists:
                raise ValueError(
                    f"SloObjective {obj.name!r} names unknown engine "
                    f"metric {obj.metric!r}; expected one of "
                    f"{sorted(self._hists)}")
            self._slo_wd.watch(obj, self._hists[obj.metric])

        # ---- QoS: preemption, burn-rate shedding, token buckets
        self.preempt_slack_s = preempt_slack_s
        self.shed_classes = tuple(shed_classes or ())
        #: per-tenant device-second token buckets (post-paid): resolved
        #: tenant names, "*" the default; None = unlimited
        self._rate_limits = dict(tenant_rate_limits or {})
        self._buckets: dict = {}
        #: per rate-limited tenant, the usage records of its requests
        #: past the bucket gate and not yet settled (debited)
        self._unsettled: dict = {}
        self._buckets_lock = threading.Lock()
        for tenant in self._rate_limits:
            if tenant != "*":
                self._tenant_bucket(self._usage.resolve_tenant(tenant))
        #: scripted fault injector (``serving/chaos.py``), or None
        self._chaos = chaos
        self._qos_counts = {"preempted": 0, "shed": 0, "rate_limited": 0}

        self._queue = AdmissionQueue(
            queue_capacity, wait_histogram=self._hists["queue_wait"])
        self._slots: List[Optional[_SlotState]] = [None] * max_slots
        self._adms: List[_Admission] = []
        self._counts = dict.fromkeys(_FLOW + _TALLIES, 0)
        self._counts_lock = threading.Lock()

        self._wake = threading.Condition()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lifecycle = threading.Lock()
        self._crashed: Optional[BaseException] = None
        self._draining = False

    # ----------------------------------------------- the device programs
    # (the JAX engine's jitted step / chunk / copies / sample0 and, with a
    # draft, d_chunk / d_sync / propose / spec_verify, as eager calls on
    # the persistent tensors)
    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        """The next token of every row (the JAX engine's ``sample0``, and
        the choice inside its ``step``): argmax, or a draw from the
        engine's generator over the tempered, filtered softmax."""
        if self.temperature > 0.0:
            probs = torch.softmax(_filter_logits(
                logits, self.temperature, self.top_k, self.top_p), -1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return logits.argmax(-1)

    def _step(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One fused ragged decode over ALL slots: (S,) tokens at (S,)
        per-row positions, written into the slot pool (or through the
        slot tables into the page pool) in place."""
        if self.paged:
            logits, _ = self.model.decode_step_paged(
                tok, pos, self._kv_pool, self._slot_tables())
        else:
            logits, _ = self.model.decode_step(tok, pos, self._caches)
        return self._pick(logits)

    def _chunk(self, ids: torch.Tensor, pos0: torch.Tensor,
               last: torch.Tensor) -> torch.Tensor:
        """One ragged prefill round over the whole staging cache (or over
        the admissions' tables): row r writes its chunk at its own offset
        ``pos0[r]``; ``last`` picks each row's true last prompt position
        (the final chunk is right-padded)."""
        if self.paged:
            logits, _ = self.model.prefill_chunk_at_paged(
                ids, self._kv_pool, self._adm_tables(), pos0, last)
        else:
            logits, _ = self.model.prefill_chunk_at(ids, self._staging,
                                                    pos0, last)
        return logits

    def _d_chunk(self, ids: torch.Tensor, pos0: torch.Tensor) -> None:
        """The draft's mirror of the ragged prefill round, into its own
        staging (or through its admission tables); its logits are
        dropped: the first token comes from the target's."""
        last = torch.zeros_like(pos0)
        if self.paged:
            self.draft.prefill_chunk_at_paged(
                ids, self._d_kv_pool, self._adm_tables(draft=True), pos0,
                last)
        else:
            self.draft.prefill_chunk_at(ids, self._d_staging, pos0, last)

    def _d_sync(self, tok: torch.Tensor, pos: torch.Tensor) -> None:
        """One ragged draft step re-writing each row's last accepted
        token's KV at its own position: for a row that accepted all gamma
        proposals it fills the one position the proposals never wrote;
        every other row rewrites identical values in place."""
        if self.paged:
            self.draft.decode_step_paged(tok, pos, self._d_kv_pool,
                                         self._slot_tables(draft=True))
        else:
            self.draft.decode_step(tok, pos, self._d_caches)

    def _propose(self, tok: torch.Tensor, pos: torch.Tensor):
        """gamma draft decode steps over ALL slots: (gamma, S) proposals
        and their (gamma, S, V) logits."""
        g = self._spec.gamma
        sampled = self.temperature > 0.0
        temp = self.temperature if sampled else 1.0
        if self.paged:
            toks, qlogits, _ = self.draft._propose(
                tok, pos, self._d_kv_pool, g, sampled, temp, self._gen,
                tables=self._slot_tables(draft=True))
        else:
            toks, qlogits, _ = self.draft._propose(
                tok, pos, self._d_caches, g, sampled, temp, self._gen)
        return toks, qlogits

    def _spec_verify(self, tok: torch.Tensor, props: torch.Tensor,
                     qlogits: torch.Tensor, pos: torch.Tensor):
        """ONE ragged target forward scoring every row's proposals: chunk
        column 0 is the row's pending token (its KV is written first),
        columns 1..g its proposals; logits column j predicts the token at
        position pos + j + 1. Acceptance is decided per row on the device,
        so the host reads only the (S, g + 1) emit matrix and the (S,)
        accepted counts."""
        g = self._spec.gamma
        chunk = torch.cat([tok[:, None], props.T], 1)
        if self.paged:
            logits, _ = self.model.verify_chunk_paged(
                chunk, self._kv_pool, self._slot_tables(), pos)
        else:
            logits, _ = self.model.verify_chunk(chunk, self._caches, pos)
        if self.temperature > 0.0:
            accept, resid, bonus = _spec_accept(
                logits, qlogits.transpose(0, 1), chunk[:, 1:],
                self.temperature, self._gen)
            n_acc = accept.long().cumprod(1).sum(1)
            # emit column j: the proposal while accepted; at the first
            # rejection the residual draw, on full acceptance the bonus
            # (columns past n_acc are never read)
            fix = torch.cat([resid, bonus[:, None]], 1).gather(
                1, n_acc[:, None])
            cols = torch.arange(g + 1, device=tok.device)[None]
            padded = torch.cat([chunk[:, 1:], torch.zeros_like(tok)[:, None]],
                               1)
            emit = torch.where(cols < n_acc[:, None], padded, fix)
        else:
            v_tok = logits.argmax(-1)
            n_acc = (chunk[:, 1:] == v_tok[:, :g]).long().cumprod(1).sum(1)
            # matched proposals ARE the target's argmax, so the burst is
            # v_tok[:, :n_acc + 1] verbatim
            emit = v_tok
        return emit, n_acc

    @staticmethod
    def _copy_row(dst, src, dst_row: int, src_row: int) -> None:
        """Row ``src_row`` of cache list ``src`` into row ``dst_row`` of
        ``dst``, every layer's tensors (k and v, and the int8 form's
        scales), in place: staging → slot on insert, pool → staging on a
        hit, slot → pool on donation, page → page on a fork."""
        for dst_layer, src_layer in zip(dst, src):
            for d, s in zip(dst_layer, src_layer):
                d[dst_row].copy_(s[src_row])

    def _copy_page(self, dst: int, src: int) -> None:
        """``BlockTable.ensure_writable``'s copy callback: page ``src``
        into page ``dst`` of the target pool, every layer's k and v, in
        place. The engine's own paths never fork a table (each admission
        reserves its full span), so this serves API users' forks, from
        any thread (inference mode is thread-local)."""
        with torch.inference_mode():
            self._copy_row(self._kv_pool, self._kv_pool, dst, src)

    def _adm_tables(self, draft: bool = False) -> torch.Tensor:
        """The prefill call's (prefill_rows, table_len) block tables:
        each admission lane's reserved table, idle lanes all-scratch
        (their padding writes land on page 0, never attended)."""
        t = np.zeros((self._policy.prefill_rows, self._table_len), np.int64)
        for a in self._adms:
            tbl = a.d_table if draft else a.table
            if tbl is not None:
                t[a.row] = tbl.as_array(self._table_len)
        return self._h2d(t)

    def _slot_tables(self, draft: bool = False) -> torch.Tensor:
        """The decode call's (max_slots, table_len) block tables (idle
        slots all-scratch, as above)."""
        t = np.zeros((self.max_slots, self._table_len), np.int64)
        for sid, tbl in enumerate(self._d_tables if draft
                                  else self._tables):
            if tbl is not None:
                t[sid] = tbl.as_array(self._table_len)
        return self._h2d(t)

    def _free_slot_table(self, sid: int) -> None:
        """Drop slot ``sid``'s page references (target and draft):
        refcount moves only; pages shared into the prefix index survive
        under its references."""
        if not self.paged:
            return
        tbl = self._tables[sid]
        if tbl is not None:
            tbl.free()
            self._tables[sid] = None
        if self._d_tables is not None and self._d_tables[sid] is not None:
            self._d_tables[sid].free()
            self._d_tables[sid] = None

    # ------------------------------------------------------- lifecycle
    def start(self) -> "ContinuousBatchingEngine":
        """Start the loop thread (idempotent; ``submit`` auto-starts)."""
        with self._lifecycle:
            if self._crashed is not None:
                raise EngineStopped(
                    "engine loop crashed; construct a new engine"
                ) from self._crashed
            if self._thread is None or not self._thread.is_alive():
                self._stop_evt.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="serving-engine", daemon=True)
                self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0) -> None:
        """Stop the loop thread. ``drain=True`` first waits (up to
        ``timeout``) for queued and running requests to finish; any
        request still unfinished when the loop halts fails with
        ``EngineStopped``."""
        if drain and self._thread is not None and self._thread.is_alive():
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while self._has_work():
                if self._crashed is not None or (
                        deadline is not None
                        and time.monotonic() > deadline):
                    break
                time.sleep(0.002)
        self._stop_evt.set()
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # the loop is inside a device call: leave its state
                # alone; it exits when the call returns, and a second
                # stop() then fails the leftovers
                return
        err = EngineStopped("engine stopped before the request finished")
        for h in self._queue.drain():
            self._finish_handle(h, err, "stopped")
        self._fail_in_flight(err, "stopped")

    def drain(self) -> None:
        """Stop admitting NEW requests while everything already
        submitted runs to completion; ``submit`` raises
        ``EngineDraining`` until ``resume()``. Idempotent."""
        self._draining = True

    def resume(self) -> None:
        """Lift a ``drain()``: the engine admits new requests again."""
        self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop(drain=exc_type is None)

    def _has_work(self) -> bool:
        return (len(self._queue) > 0 or len(self._adms) > 0
                or any(s is not None for s in self._slots))

    # ---------------------------------------------------------- client
    def submit(self, prompt_ids, max_new_tokens: int,
               timeout_s: Optional[float] = None, block: bool = True,
               queue_timeout_s: Optional[float] = None,
               tenant: Optional[str] = None,
               priority: str = "normal",
               trace_id: Optional[str] = None) -> RequestHandle:
        """Queue one request (1-D prompt) and return its handle at once;
        stream with ``handle.tokens()`` or block on ``handle.result()``.
        ``timeout_s`` is a wall deadline over queue, prefill and decode
        (``RequestTimedOut``, also while blocked on a full queue); a full
        queue blocks (``block=True``, up to ``queue_timeout_s``) or
        raises ``QueueFull``.

        ``tenant`` names the workload the request's usage is billed to
        (``None`` bills to ``"default"``; past ``usage_tenants`` distinct
        names, new ones bill to ``"other"``); ``handle.usage()`` returns
        the metered record. ``priority`` (``"high"`` / ``"normal"`` /
        ``"low"``) is the QoS class: a shed class under a TTFT burn
        raises ``RequestShed``, a tenant past its token bucket
        ``RequestRateLimited``, both with ``retry_after_s``; the handle
        is then finished with that outcome. ``trace_id`` is stored on
        the handle and its usage record."""
        if self._crashed is not None:
            raise EngineStopped("engine loop crashed") from self._crashed
        if self._draining:
            raise EngineDraining(
                "engine is draining: in-flight requests are finishing "
                "but new submissions are refused (resume() to rejoin)")
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1:
            raise ValueError("submit takes ONE request (1-D prompt), "
                             f"got shape {prompt.shape}")
        t0, n = prompt.shape[0], int(max_new_tokens)
        if n < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if t0 < 1 or t0 + n > self.max_len:
            raise ValueError(
                f"prompt ({t0}) + max_new_tokens ({n}) exceeds the "
                f"engine's serving window {self.max_len}")
        if self.paged:
            # admission reserves the FULL span (no mid-flight
            # allocation), so it must fit the pool with every other page
            # free
            need = pages_needed(min(t0 + n + self._gamma(), self._phys_len),
                                self.page_size)
            usable = self._pages.max_pages - 1    # page 0 is scratch
            if need > usable:
                raise ValueError(
                    f"request needs {need} KV pages but the pool only "
                    f"has {usable} allocatable (max_pages="
                    f"{self._pages.max_pages} minus the scratch page): "
                    "raise max_pages or shorten the request")
        self.start()
        h = RequestHandle(prompt, n, timeout_s, priority=priority)
        h.trace_id = trace_id
        h._usage = self._usage.begin(h.request_id, tenant, t0, n,
                                     submitted_at=h.submitted_at)
        h._usage.trace_id = trace_id
        h.tenant = h._usage.tenant
        # QoS gates, the JAX engine's order: burn-rate shedding, then the
        # tenant's token bucket. Both finish the handle with their
        # outcome (the ledger bills its queue-side life) and raise
        shed = self._shed_state()
        if shed["active"] and priority in shed["classes"]:
            retry = self._shed_retry_after_s(shed)
            err = RequestShed(
                f"shed at admission: TTFT SLO burning at "
                f"{shed['burn_rate']:.1f}x budget "
                f"({shed['source']}), class {priority!r} is in the "
                f"shed set; retry in {retry:.2f}s",
                retry_after_s=retry)
            self._reject_qos(h, err, "shed")
            raise err
        bucket = self._tenant_bucket(h.tenant)
        if bucket is not None:
            # the bucket is debited when a request ends, so what the
            # tenant's requests in flight have been metered so far counts
            # against the balance here: without it, concurrent submits
            # all pass a bucket nothing has been debited from yet (the
            # JAX engine admits them, ROADMAP.md Queue 3)
            with self._buckets_lock:
                open_recs = self._unsettled.setdefault(h.tenant, set())
                pending = sum(r.device_s for r in open_recs)
                admit = bucket.try_admit(pending=pending)
                if admit:
                    open_recs.add(h._usage)
            if not admit:
                retry = bucket.retry_after(pending=pending)
                err = RequestRateLimited(
                    f"tenant {h.tenant!r} exhausted its device-second "
                    f"budget (bucket {bucket.level():.3f}s, "
                    f"{pending:.3f}s unsettled, refill "
                    f"{bucket.rate:.3f}/s); retry in {retry:.2f}s",
                    retry_after_s=retry)
                self._reject_qos(h, err, "rate_limited")
                raise err
        try:
            self._queue.put(h, block=block, timeout=queue_timeout_s)
        except Exception as e:
            # a backpressure rejection still closes the request's record
            self._usage.finalize(h._usage, "rejected", time.monotonic())
            self._settle(h._usage)
            if isinstance(e, RequestTimedOut):
                self._count("timed_out")
            raise
        with self._wake:
            self._wake.notify_all()
        # submit can race stop() or a loop crash: both drain the queue
        # from the dying side, so a put landing after that drain would
        # strand the handle; drain and fail now instead
        if self._crashed is not None or (
                self._stop_evt.is_set()
                and (self._thread is None
                     or not self._thread.is_alive())):
            err = EngineStopped("engine stopped while the request was "
                                "being submitted")
            if self._crashed is not None:
                err.__cause__ = self._crashed
            for dropped in self._queue.drain():
                self._finish_handle(dropped, err, "stopped")
            self._finish_handle(h, err, "stopped")
            raise err
        return h

    def _finish_handle(self, h: RequestHandle,
                       err: Optional[BaseException],
                       outcome: str) -> None:
        """Terminal bookkeeping for ONE request: the stream sentinel, the
        usage ledger's finalize (and the tenant bucket's post-paid debit
        of the measured device-seconds), the release of a preemption
        pin the request never consumed, and the finished-timeline ring
        entry. ``_finish`` arbitrates racing finishers (a stopping
        submitter against the loop): only the winner records."""
        if not h._finish(err):
            return
        rec = h._usage
        if rec is not None:
            self._usage.finalize(rec, outcome, h.finished_at)
            self._settle(rec)
        # a victim that finished, timed out or was cancelled while
        # requeued must not leak its pinned prefix entry
        pin = h.__dict__.pop("_preempt_pin", None)
        if pin is not None and self._prefix is not None:
            self._prefix.release(pin)
        tl = h.timeline()
        tl["request_id"] = h.request_id
        tl["outcome"] = outcome
        tl["tenant"] = h.tenant
        tl["trace_id"] = h.trace_id
        with self._timelines_lock:
            self._timelines.append(tl)

    def _count(self, key: str, n: int = 1) -> None:
        with self._counts_lock:
            self._counts[key] += n

    # ------------------------------------------------------ QoS plumbing
    def _shed_state(self) -> dict:
        """The load-shedding decision input: is the TTFT SLO burning
        (an active ``SloWatchdog`` alert on a ``metric="ttft"``
        objective, or the chaos injector's synthetic burn), how hard,
        and which classes shed as a result: ``low`` on any burn,
        ``normal`` (when in ``shed_classes``) only once the burn is
        severe (>= 2x its alert threshold), ``high`` never."""
        active = severe = False
        burn = 0.0
        source = None
        if self._chaos is not None and self._chaos.burn_active():
            active = True
            severe = self._chaos.burn_severe()
            burn = 4.0 if severe else 2.0
            source = "chaos"
        else:
            for row in self._slo_wd.state():
                if row["metric"] != "ttft" or not row["active"]:
                    continue
                active = True
                burn = max(burn, row["burn_rate"])
                severe = severe or row["severe"]
                source = "slo:" + row["objective"]
        classes = ()
        if active:
            classes = (self.shed_classes if severe else
                       tuple(p for p in self.shed_classes if p == "low"))
        return {"active": active and bool(classes), "severe": severe,
                "burn_rate": burn, "source": source, "classes": classes}

    @staticmethod
    def _shed_retry_after_s(shed: dict) -> float:
        """Back-off hint for a shed rejection: long enough for the
        trailing burn window to move, doubled under a severe burn."""
        return 2.0 if shed["severe"] else 1.0

    def _tenant_bucket(self, tenant: str) -> Optional[TokenBucket]:
        """The tenant's device-second token bucket, created lazily from
        ``tenant_rate_limits`` (exact name first, then the ``"*"``
        default); None = unlimited."""
        if not self._rate_limits:
            return None
        with self._buckets_lock:
            b = self._buckets.get(tenant)
            if b is not None:
                return b
            cfg = self._rate_limits.get(tenant, self._rate_limits.get("*"))
            if cfg is None:
                return None
            if isinstance(cfg, dict):
                b = TokenBucket(cfg["rate"], cfg["burst"])
            else:
                rate, burst = cfg
                b = TokenBucket(rate, burst)
            self._buckets[tenant] = b
            return b

    def _settle(self, rec) -> None:
        """The tenant bucket's post-paid debit of a finalized record's
        measured device-seconds; the record leaves the unsettled set in
        the same step, so the gate never counts it twice or not at
        all."""
        bucket = self._tenant_bucket(rec.tenant)
        if bucket is None:
            return
        with self._buckets_lock:
            self._unsettled.get(rec.tenant, set()).discard(rec)
            if rec.device_s > 0:
                bucket.debit(rec.device_s)

    def _reject_qos(self, h: RequestHandle, err: Exception,
                    outcome: str) -> None:
        """Terminal bookkeeping for a structured QoS rejection (shed /
        rate_limited), through the ``_finish_handle`` funnel; the
        caller raises ``err`` to the submitter."""
        with self._counts_lock:
            self._qos_counts[outcome] += 1
        self._finish_handle(h, err, outcome)

    def stats(self) -> dict:
        """The flow counters since construction (admitted, finished,
        evicted, timed_out, cancelled), the loop's iterations, prefill
        rounds and decode steps, ``active_slots``, ``queue_depth``,
        ``latency`` (``{count, mean, p50, p90, p99}`` of queue wait,
        prefill, TTFT, decode and total over the recent finished
        requests), ``prefix_cache`` (hit rate, reused tokens, bytes, and
        the host tier's demotions, promotions and host hits),
        ``quantization`` (the KV and weight dtypes, a row's bytes beside
        the float row's), ``speculation`` (proposed and accepted draft
        tokens, acceptance rate), ``usage`` (the ledger's per-tenant
        table, totals and goodput block), ``qos`` (shedding state, the
        preempted / shed / rate-limited tallies, queue depth by class,
        each tenant bucket's balance, and the chaos injector's script),
        ``alerts`` (the active SLO alerts) and, in paged mode,
        ``paging`` (the page pools' stats, the reservations'
        fragmentation, the page waits). A decode step of a speculative
        engine is one propose / verify round."""
        with self._counts_lock:
            out = dict(self._counts)
        out["active_slots"] = sum(s is not None for s in self._slots)
        out["queue_depth"] = len(self._queue)
        out["latency"] = self._latency_summary()
        out["prefix_cache"] = self._prefix_summary()
        out["speculation"] = self._spec_summary()
        out["quantization"] = self._quant_summary()
        out["usage"] = self._usage.summary()
        out["qos"] = self._qos_summary()
        if self.paged:
            out["paging"] = self._paging_summary()
        out["alerts"] = self.alerts()
        return out

    def _qos_summary(self) -> dict:
        """The ``stats()["qos"]`` block (the JAX engine's keys)."""
        shed = self._shed_state()
        with self._buckets_lock:
            buckets = {t: b.snapshot()
                       for t, b in sorted(self._buckets.items())}
        with self._counts_lock:
            counts = dict(self._qos_counts)
        out = {
            "shedding": {"active": shed["active"],
                         "severe": shed["severe"],
                         "burn_rate": round(shed["burn_rate"], 3),
                         "source": shed["source"],
                         "classes": list(shed["classes"])},
            "shed_classes_configured": list(self.shed_classes),
            "preempt_slack_s": self.preempt_slack_s,
            "queue_by_class": self._queue.depth_by_class(),
            "rate_limits": buckets,
            **counts,
        }
        if self._chaos is not None:
            out["chaos"] = self._chaos.snapshot()
        return out

    def alerts(self) -> List[dict]:
        """The active SLO alerts as plain dicts (empty while healthy);
        the same list rides in ``stats()["alerts"]``."""
        return self._slo_wd.alerts()

    def debug_usage(self, top_n: int = 10) -> dict:
        """The usage payload the JAX engine serves at ``/debug/usage``:
        the per-tenant table, engine-wide totals, the goodput block and
        the ``top_n`` recently finished requests by device-seconds."""
        return {"service": self.service_name,
                **self._usage.summary(top_n=top_n)}

    def _quant_summary(self) -> dict:
        """Which numerics the hot path runs and what one KV row costs:
        ``kv_row_bytes`` (scales included) beside ``fp_row_bytes``, the
        same geometry at full precision; their ratio is what int8 KV
        buys in rows per byte."""
        return {
            "kv_dtype": self.kv_dtype or "fp",
            "weights_dtype": self.weights_dtype or "fp",
            "kv_row_bytes": int(self._row_bytes),
            "fp_row_bytes": int(self._fp_row_bytes),
            "row_bytes_ratio": (round(self._row_bytes
                                      / self._fp_row_bytes, 4)
                                if self._fp_row_bytes else 1.0),
        }

    def _gamma(self) -> int:
        return self._spec.gamma if self._spec is not None else 0

    def _spec_summary(self) -> dict:
        """Proposed and accepted draft tokens and the acceptance rate
        (near 1: raise gamma; near 0: every round yields one token)."""
        if self._spec is None:
            return {"enabled": False}
        prop = self._spec_proposed
        return {
            "enabled": True,
            "gamma": self._spec.gamma,
            "proposed_tokens": prop,
            "accepted_tokens": self._spec_accepted,
            "acceptance_rate": (round(self._spec_accepted / prop, 4)
                                if prop else 0.0),
        }

    def _fragmentation(self) -> float:
        """Internal fragmentation of the live reservations: 1 - covered
        tokens / (held pages x page_size) over every slot table (covered:
        the slot's KV cursor) and admission table (covered: reuse base +
        prefill cursor). 0.0 when nothing is held."""
        ps, c = self.page_size, self._policy.chunk
        held = covered = 0
        for st, tbl in zip(self._slots, self._tables):
            if st is None or tbl is None:
                continue
            held += len(tbl.pages)
            covered += min(st.pos, len(tbl.pages) * ps)
        for a in list(self._adms):
            tbl = a.table      # read once: the loop may hand it off
            if tbl is None:
                continue
            held += len(tbl.pages)
            covered += min(a.base + a.next_chunk * c, a.t0,
                           len(tbl.pages) * ps)
        return 1.0 - covered / (held * ps) if held else 0.0

    def _paging_summary(self) -> dict:
        out = {"page_size": self.page_size,
               "table_len": self._table_len,
               "fragmentation": self._fragmentation(),
               "page_waits": self._page_waits,
               "pool": self._pages.stats()}
        if self._d_pages is not None:
            out["draft_pool"] = self._d_pages.stats()
        if self._prefix is not None:
            out["prefix_device_pages"] = self._prefix.device_pages
        return out

    def _prefix_summary(self) -> dict:
        if self._prefix is None:
            return {"enabled": False}
        ps = self._prefix.stats()
        prefilled = self._prefilled_tokens
        denom = ps["reused_tokens"] + prefilled
        return {
            "enabled": True,
            **ps,
            "prefilled_tokens": prefilled,
            "reused_fraction": (round(ps["reused_tokens"] / denom, 4)
                                if denom else 0.0),
        }

    def _latency_summary(self) -> dict:
        with self._timelines_lock:
            snap = list(self._timelines)
        tls = [t for t in snap if t.get("outcome") == "finished"]
        return {phase: _percentile_summary(t[phase + "_s"] for t in tls)
                for phase in ("queue_wait", "prefill", "ttft", "decode",
                              "total")}

    # ------------------------------------------------------------ loop
    def _loop(self):
        try:
            # inference_mode is thread-local: the loop thread sets its own
            with torch.inference_mode():
                while not self._stop_evt.is_set():
                    # an idle engine blocks (submit/stop notify; the
                    # timeout is only a lost-wakeup safety net)
                    with self._wake:
                        while (not self._stop_evt.is_set()
                               and not self._has_work()):
                            self._wake.wait(self.idle_wait_s)
                    if self._stop_evt.is_set():
                        break
                    self._iterate()
                    self._count("iterations")
        except BaseException as e:
            self._crash(e)

    def _crash(self, e: BaseException) -> None:
        with self._lifecycle:
            self._crashed = e
        print(f"[bigdl_tpu_torch.serving] engine {self.service_name!r} "
              f"crashed: {e!r}", file=sys.stderr)
        err = EngineStopped(f"engine loop crashed: {e!r}")
        err.__cause__ = e
        self._fail_in_flight(err, "crashed")
        for h in self._queue.drain():
            self._finish_handle(h, err, "crashed")

    def _fail_in_flight(self, err: Exception, outcome: str) -> None:
        """Fail every admission and occupied slot with ``err`` and drop
        every reference they hold. In paged mode the prefix index then
        drops its entries too, so every page is back on the free list
        (the leak invariant: ``pages_in_use == 0``)."""
        for key in list(self._promotions):
            self._drop_promotion(key)
        for a in self._adms:
            self._drop_admission_refs(a)
            self._finish_handle(a.handle, err, outcome)
        self._adms = []
        for sid, st in enumerate(self._slots):
            if st is not None:
                self._finish_handle(st.handle, err, outcome)
                self._slots[sid] = None
            self._free_slot_table(sid)
        if self.paged and self._prefix is not None:
            self._prefix.drop_all()

    def _drop_admission_refs(self, a: _Admission) -> None:
        """Release an unfinished admission's prefix pin and tables."""
        if a.entry is not None:
            self._prefix.release(a.entry)
            a.entry = None
        for tbl in (a.table, a.d_table):
            if tbl is not None:
                tbl.free()
        a.table = a.d_table = None

    def _iterate(self) -> bool:
        now = time.monotonic()
        worked = False
        # paged: a fresh iteration may admit again (pages freed since
        # can satisfy what the pool refused before)
        self._adm_blocked = False
        if self._chaos is not None:
            self._chaos.begin_iteration()
        # 1. running slots: cancellation and deadline eviction
        for sid, st in enumerate(self._slots):
            if st is None:
                continue
            h = st.handle
            if h.cancelled:
                self._release(sid, RequestCancelled(
                    f"cancelled after {st.delivered} tokens"),
                    "cancelled")
            elif h.deadline is not None and now > h.deadline:
                self._release(sid, RequestTimedOut(
                    f"deadline passed mid-decode after {st.delivered} "
                    "tokens (partial output in tokens_so_far())"),
                    "timed_out")
        # ... and the admissions in progress
        for a in list(self._adms):
            h = a.handle
            err = kind = None
            if h.cancelled:
                err, kind = RequestCancelled(
                    "cancelled during prefill"), "cancelled"
            elif h.deadline is not None and now > h.deadline:
                err, kind = RequestTimedOut(
                    "deadline passed during prefill"), "timed_out"
            if err is not None:
                self._abort_admission(a, err, kind)

        # 2. queued requests: mid-queue deadline/cancel sweep
        for h, err in self._queue.sweep(now):
            self._finish_dropped(h, err)

        # 3. admission: prefix-aware intake, then batched chunked-prefill
        #    rounds under this iteration's budget
        self._policy.begin_iteration()
        while True:
            self._fill_admissions(now)
            if not self._adms or not self._policy.take_chunk():
                break
            self._prefill_round()
            worked = True

        # 4. one fused decode step over every occupied slot but the
        #    ones a chaos freeze holds out (a simulated straggler: its KV
        #    and handle wait untouched until the freeze expires)
        active = [sid for sid, st in enumerate(self._slots)
                  if st is not None]
        if self._chaos is not None:
            active = [sid for sid in active
                      if not self._chaos.slot_frozen(sid)]
        if active:
            self._decode_all(active)
            worked = True

        # 5. paged KV billing and the SLO watchdog's sample
        if self.paged:
            self._accrue_paged_kv()
        self._slo_wd.sample()
        return worked

    # ------------------------------------------------ admission stages
    def _free_slot(self) -> Optional[int]:
        # free: no running request occupies it AND no in-flight
        # admission has reserved it as its insert target
        reserved = {a.slot for a in self._adms}
        for sid, st in enumerate(self._slots):
            if st is None and sid not in reserved:
                return sid
        return None

    def _free_staging_row(self) -> Optional[int]:
        used = {a.row for a in self._adms}
        for r in range(self._policy.prefill_rows):
            if r not in used:
                return r
        return None

    def _need_tokens(self, t0: int, h: RequestHandle) -> int:
        """KV positions a paged admission reserves: the effective prompt,
        the tokens still to deliver and the verify headroom."""
        remaining = h.max_new_tokens - len(h._tokens)
        return min(t0 + remaining + self._gamma(), self._phys_len)

    def _fill_admissions(self, now: float) -> None:
        """Start new admissions until the staging cache is full, the slot
        pool is exhausted, the page pool refuses the queue head, or the
        queue runs dry. With a prefix cache and ``admission_window > 1``
        the pop prefers the queued candidate with the longest usable
        cached prefix (bounded bypass); in paged mode a candidate whose
        fresh pages the pool could not supply even after a full prefix
        reclaim scores below every admittable one."""
        if self._adm_blocked:
            return
        scorer = None
        if self._prefix is not None and self.admission_window > 1:
            c = self._policy.chunk
            if self._promotions:
                self._prune_promotions(now)

            def scorer(h):
                # the usable (capped, chunk-aligned) reuse, exactly what
                # _start_admission will skip; the raw lookup is stamped
                # on the handle (generation-guarded) for the winner
                p = self._effective_prompt(h)
                e, m = self._prefix.lookup(p)
                h._prefix_probe = (e, m, self._prefix.generation)
                base = (min(m, p.shape[0] - 1) // c) * c
                if not self.paged:
                    if e is not None and e.tier == "host":
                        # start the host-to-device copy now: it overlaps
                        # the candidate's remaining queue wait
                        self._begin_promotion(e)
                    return base
                if e is not None and e.tier != "device":
                    base = 0    # a promotion may still land it: score cold
                ps = self.page_size
                fresh = (pages_needed(self._need_tokens(p.shape[0], h), ps)
                         - base // ps)
                avail = self._pages.free_pages + self._prefix.device_pages
                return page_fit_score(base, fresh, avail)
        while len(self._adms) < self._policy.prefill_rows:
            row = self._free_staging_row()
            if row is None:
                return
            slot = self._free_slot()
            h = None
            if slot is None:
                # slot pool exhausted: a high-class request waiting past
                # its slack may preempt a lower-class victim
                if not self._maybe_preempt(now):
                    return
                slot = self._free_slot()
                if slot is None:
                    return
                # the freed slot goes to the longest-waiting high-class
                # request. The JAX engine pops with the scored window
                # here, which misses that request once requeued victims
                # fill the window, and re-admits a victim: the next
                # iteration preempts again, a loop that under a storm
                # preempts over and over while the high request waits
                h = self._queue.pop_oldest("high", now)
            if h is None:
                h, dropped = self._queue.pop_ready(
                    now, scorer=scorer, window=self.admission_window)
                for hd, err in dropped:
                    self._finish_dropped(hd, err)
            if h is None:
                return
            try:
                started = self._start_admission(h, slot, row)
            except BaseException:
                # the loop is about to crash: put the popped request back
                # so the crash's queue drain fails it, instead of leaving
                # its handle waiting for a result that never comes
                self._queue.requeue(h)
                raise
            if not started:
                return

    @staticmethod
    def _effective_prompt(h: RequestHandle) -> np.ndarray:
        """What an admission must have in the KV cache before decode can
        continue: the prompt plus every already-generated token (a
        preempted request's resume re-prefills them, past what its
        donated prefix entry covers)."""
        if h._tokens:
            return np.concatenate(
                [h.prompt, np.asarray(h._tokens, np.int32)])
        return h.prompt

    def _lookup_base(self, h: RequestHandle, prompt: np.ndarray):
        """The usable cached prefix of ``prompt``: (entry, base) with
        ``base`` capped at ``t0 - 1`` (the last prompt position must be
        computed: its logits seed the first token) and aligned DOWN to a
        chunk multiple, so the tail's chunk geometry, and with it the
        numerics, matches a cold prefill's (in paged mode the base is
        then page-aligned too). Reuses the scorer's lookup while the
        generation guard says it is still valid (a stale entry may hold
        other tokens' KV)."""
        probe = h.__dict__.pop("_prefix_probe", None)
        if probe is not None and probe[2] == self._prefix.generation:
            e, matched = probe[0], probe[1]
        else:
            e, matched = self._prefix.lookup(prompt)
        if e is None:
            return None, 0
        c = self._policy.chunk
        return e, (min(matched, prompt.shape[0] - 1) // c) * c

    def _start_admission(self, h: RequestHandle, slot: int,
                         row: int) -> bool:
        """Stage one popped request for chunked prefill, copying its
        usable cached prefix into its staging row on a hit. Returns False
        (paged mode only) when the page pool could not cover the
        request's reservation: the request is back at the queue head and
        the caller stops filling for this iteration."""
        if self.paged:
            return self._start_admission_paged(h, slot, row)
        prompt = self._effective_prompt(h)
        base, entry = 0, None
        if self._prefix is not None:
            e, base = self._lookup_base(h, prompt)
            from_host = base > 0 and e.tier == "host"
            if from_host and not self._promote_entry(e):
                # the host row could not be made device-resident: a clean
                # miss, never a copy from a reused or unfilled row
                e, base = None, 0
            if base > 0:
                entry = e
                self._prefix.record_hit(entry, base, host=from_host)
                self._prefix.acquire(entry)
                self._copy_row(self._staging, self._pool, row, entry.row)
            else:
                self._prefix.record_miss()
        self._stage(h, slot, row, prompt, base, entry)
        return True

    def _start_admission_paged(self, h: RequestHandle, slot: int,
                               row: int) -> bool:
        """Paged admission: reserve the request's FULL span up front (a
        shared prefix head by refcount bump, a fresh tail from the free
        list, with a reclaim of unpinned prefix entries under pressure)
        and copy nothing. A hit's shared pages are read through the
        block table while the prefill writes land only in the fresh tail
        (chunk alignment implies page alignment). Admission is the only
        allocation point, so decode never runs out of pages mid-flight
        and ``ensure_writable`` never fires on an engine path. When the
        pool cannot cover the reservation even after reclaim, the
        request goes back to the queue HEAD and the ``_adm_blocked``
        latch stops the fill loop until the next iteration."""
        ps = self.page_size
        prompt = self._effective_prompt(h)
        t0 = prompt.shape[0]
        entry, base = (self._lookup_base(h, prompt)
                       if self._prefix is not None else (None, 0))
        from_host = base > 0 and entry.tier == "host"
        if from_host and not self._promote_entry_paged(entry):
            entry, base, from_host = None, 0, False
        shared = tuple(entry.pages[:base // ps]) if base > 0 else ()
        need = pages_needed(self._need_tokens(t0, h), ps)
        n_fresh = need - len(shared)
        table = BlockTable.build(self._pages, shared, n_fresh)
        if table is None and self._prefix is not None:
            # a hit's entry is pinned through the reclaim: as the LRU
            # victim it would free (or demote) the very pages ``shared``
            # names. The JAX engine leaves it unpinned and then shares
            # freed pages (``share() of free page``) when the entry's
            # pages have no other holder
            pin = entry if base > 0 else None
            if pin is not None:
                self._prefix.acquire(pin)
            try:
                self._prefix.reclaim(n_fresh, self._spill)
            finally:
                if pin is not None:
                    self._prefix.release(pin)
            table = BlockTable.build(self._pages, shared, n_fresh)
        d_table = None
        if table is not None and self.draft is not None:
            # sized never to fail once the target's reservation held;
            # the unwind keeps a failure from leaking the target's pages
            d_table = BlockTable.build(self._d_pages, (), need)
            if d_table is None:
                table.free()
                table = None
        if table is None:
            self._queue.requeue(h)
            self._adm_blocked = True
            self._page_waits += 1
            h._page_waited = True
            return False
        if self._prefix is not None:
            if base > 0:
                # no staging copy and no entry pin: the shared
                # refcounts keep the pages alive even if the entry is
                # evicted while this admission prefills
                self._prefix.record_hit(entry, base, host=from_host)
            else:
                self._prefix.record_miss()
        a = self._stage(h, slot, row, prompt, base, None)
        a.table, a.d_table = table, d_table
        return True

    def _stage(self, h: RequestHandle, slot: int, row: int,
               prompt: np.ndarray, base: int, entry) -> _Admission:
        """Queue the admission's chunks: the tail from ``base`` for the
        target and, with a draft, the FULL prompt for the draft."""
        c = self._policy.chunk
        t0 = prompt.shape[0]
        tail = t0 - base
        n_chunks = self._policy.n_chunks(tail)
        ids = np.zeros((n_chunks * c,), np.int64)   # right-pad final chunk
        ids[:tail] = prompt[base:]
        d_ids, d_n_chunks = None, 0
        if self.draft is not None:
            d_n_chunks = self._policy.n_chunks(t0)
            d_ids = np.zeros((d_n_chunks * c,), np.int64)
            d_ids[:t0] = prompt
        a = _Admission(h, slot, row, ids, t0, base, n_chunks, entry, d_ids,
                       d_n_chunks)
        self._adms.append(a)
        # the preemption pin held the donated entry across the queue
        # wait; the admission now holds its own reference (a dense hit's
        # pin, a paged hit's shared pages) or took a clean miss
        pin = h.__dict__.pop("_preempt_pin", None)
        if pin is not None:
            self._prefix.release(pin)
        h.prefix_tokens = base
        t_adm = time.monotonic()
        if h.admitted_at is None:
            # set-once: a resumed request keeps its first admission stamp
            h.admitted_at = t_adm
        if h._usage is not None:
            # queue wait closes (a re-admission accumulates from its
            # requeue), staging residency opens, the reuse is credited
            self._usage.admitted(h._usage, t_adm, reused_tokens=base)
        self._count("admitted")
        return a

    def _prefill_round(self) -> None:
        """Advance EVERY in-flight admission by one chunk through one
        ragged call (plus, with a draft, one mirrored call for the
        draft), then complete those whose prompt is fully staged in every
        cache that needs it (slot insert and first-token sample).

        A prefix hit can leave the target's cursor finished while the
        draft still prefills the reused head: such rows REPLAY their
        final target chunk each round (an idempotent rewrite: same ids,
        same offset, same KV), so the call needs no per-row liveness
        flag and the final round's logits are fresh for the first
        token."""
        c = self._policy.chunk
        rows = self._policy.prefill_rows
        spec = self.draft is not None
        ids = np.zeros((rows, c), np.int64)
        pos0 = np.zeros((rows,), np.int64)
        last = np.full((rows,), c - 1, np.int64)
        finals: List[_Admission] = []
        for a in self._adms:
            k = min(a.next_chunk, a.n_chunks - 1)
            ids[a.row] = a.ids[k * c:(k + 1) * c]
            pos0[a.row] = a.base + k * c
            if a.next_chunk >= a.n_chunks - 1:
                # the true last prompt position within the final chunk:
                # the pads behind it are written but never attended
                last[a.row] = a.tail - 1 - (a.n_chunks - 1) * c
                if not spec or a.d_next_chunk >= a.d_n_chunks - 1:
                    finals.append(a)
        # a program's first call is set-up, not work: unbilled
        was_warm = "chunk" in self._warm and (
            not spec or "d_chunk" in self._warm) and (
            not finals or "sample0" in self._warm)
        if self._chaos is not None:
            self._chaos.on_dispatch()
        t_disp = time.monotonic()
        logits = self._chunk(self._h2d(ids), self._h2d(pos0),
                             self._h2d(last))
        self._warm.add("chunk")
        if spec:
            d_ids = np.zeros((rows, c), np.int64)
            d_pos0 = np.zeros((rows,), np.int64)
            for a in self._adms:
                dk = a.d_next_chunk
                d_ids[a.row] = a.d_ids[dk * c:(dk + 1) * c]
                d_pos0[a.row] = dk * c
            self._d_chunk(self._h2d(d_ids), self._h2d(d_pos0))
            self._warm.add("d_chunk")
        toks = None
        if finals:
            # the host read blocks on the chunk's logits, so a round that
            # finishes a prompt measures the device work; one that does
            # not measures its launches (the JAX ledger's rule: no sync
            # is added for the bill)
            toks = self._pick(logits).tolist()
            self._warm.add("sample0")
        wall = time.monotonic() - t_disp
        self._count("prefill_rounds")
        # pro-rata by the real tokens each row advanced (a final chunk's
        # pads and a replayed chunk earn nothing; draft chunks are real
        # mirrored work); the weights sum to 1
        done_by = []
        for a in self._adms:
            t_done = (min(c, a.tail - a.next_chunk * c)
                      if a.next_chunk < a.n_chunks else 0)
            d_done = min(c, a.t0 - a.d_next_chunk * c) if spec else 0
            done_by.append((a, t_done, d_done))
        if was_warm:
            total_done = sum(t + d for _, t, d in done_by) or 1
            self._usage.charge_dispatch(
                "prefill", wall,
                [(a.handle._usage, (t + d) / total_done)
                 for a, t, d in done_by],
                rows_advanced=len(self._adms),
                capacity_rows=self._policy.prefill_rows)
        for a, t_done, _ in done_by:
            if t_done:
                self._prefilled_tokens += t_done
                if a.handle._usage is not None:
                    self._usage.add_prefill(a.handle._usage, t_done)
                a.next_chunk += 1
            if spec:
                a.d_next_chunk += 1
        for a in finals:
            self._complete_admission(a, int(toks[a.row]))

    def _complete_admission(self, a: _Admission, tok: int) -> None:
        # prompt fully staged. Paged: the admission's tables BECOME the
        # slot's (its pages hold the prompt KV). Dense: copy the staging
        # row (and the draft's) into the reserved slot, then unpin the
        # prefix entry (the staged copy no longer needs it). Then deliver
        # the first token
        if self.paged:
            self._free_slot_table(a.slot)
            self._tables[a.slot], a.table = a.table, None
            if self.draft is not None:
                self._d_tables[a.slot], a.d_table = a.d_table, None
        else:
            self._copy_row(self._caches, self._staging, a.slot, a.row)
            if self.draft is not None:
                self._copy_row(self._d_caches, self._d_staging, a.slot,
                               a.row)
        if a.entry is not None:
            self._prefix.release(a.entry)
            a.entry = None
        self._adms.remove(a)
        now = time.monotonic()
        h = a.handle
        first = h.first_token_at is None
        h._deliver(tok, now)
        if h._usage is not None:
            # staging residency closes, the slot row's opens; the first
            # token counts as delivered
            self._usage.slot_acquired(h._usage, now)
            self._usage.delivered(h._usage, 1)
        if first:
            # a resumed request's first token shipped long ago: one TTFT
            # observation per request
            self._hists["ttft"].observe(now - h.submitted_at)
        if (self.eos_id is not None and tok == self.eos_id) \
                or len(h._tokens) >= h.max_new_tokens:
            # instant finisher: the slot holds the prompt's KV; donate it
            # before the slot identity is lost
            self._maybe_donate(a.slot, np.concatenate(
                [h.prompt, np.asarray(h._tokens[:-1], np.int32)]))
            self._free_slot_table(a.slot)
            self._finish_handle(h, None, "finished")
            self._count("finished")
            return
        # a resumed request picks up where it was preempted: pos is the
        # effective prompt's length, its KV covers [0, pos) as for a
        # fresh one
        st = _SlotState(h, a.t0, tok, now)
        st.delivered = len(h._tokens)
        self._slots[a.slot] = st

    def _abort_admission(self, a: _Admission, err: Exception,
                         kind: str) -> None:
        self._drop_admission_refs(a)
        self._adms.remove(a)
        self._count(kind)
        self._finish_handle(a.handle, err, kind)

    def _maybe_donate(self, sid: int, tokens: np.ndarray) -> None:
        """Offer a finishing slot's KV to the prefix cache. ``tokens`` are
        exactly the ids whose KV the slot holds (positions
        ``0..len-1``); the index decides (covered / LRU-evict /
        decline). Dense: an accepted row is filled by one row copy.
        Paged: the covering pages are SHARED into the new entry (a
        refcount move; the slot's own references are freed by the
        caller)."""
        if self._prefix is None:
            return
        if self.paged:
            tbl = self._tables[sid]
            if tbl is not None and tokens.shape[0] > 0:
                self._prefix.donate_pages(
                    tokens, tbl.covering(int(tokens.shape[0])))
            return
        row = self._prefix.donate(tokens)
        if row is not None:
            # the claimed row may still hold a demoted victim's KV: its
            # copy to host is enqueued before this copy overwrites it
            self._resolve_pending_demotion()
            self._copy_row(self._pool, self._caches, row, sid)

    # ------------------------------------------------------ preemption
    def _maybe_preempt(self, now: float) -> bool:
        """With the slot pool exhausted and a high-class request waiting
        past ``preempt_slack_s``, evict one lower-class slot: lowest
        class first, then the most decode left (the victim loses the
        least sunk progress per unit of freed time). High-class slots
        are never preempted. True when a slot was freed."""
        if self.preempt_slack_s is None:
            return False
        wait = self._queue.oldest_waiting("high", now)
        if wait is None or wait <= self.preempt_slack_s:
            return False
        victim_sid, victim_key = None, None
        for sid, st in enumerate(self._slots):
            if st is None:
                continue
            rank = PRIORITY_RANK.get(st.handle.priority, 1)
            if rank <= 0:
                continue
            key = (rank, st.handle.max_new_tokens - st.delivered)
            if victim_key is None or key > victim_key:
                victim_sid, victim_key = sid, key
        if victim_sid is None:
            return False
        self._preempt_slot(victim_sid, now)
        return True

    def _preempt_slot(self, sid: int, now: float) -> None:
        """Donate the slot's KV (prompt + generated[:-1], what a
        finishing slot donates), pin the entry covering it so the LRU
        cannot evict or demote it while the victim waits (released at
        re-admission or by ``_finish_handle``), free the slot (in paged
        mode its target and draft tables), and requeue the victim at
        the head. A declined donation leaves no pin: the resume then
        re-prefills from scratch, still token-identical."""
        st = self._slots[sid]
        h = st.handle
        tokens = np.concatenate(
            [h.prompt, np.asarray(h._tokens[:-1], np.int32)])
        self._maybe_donate(sid, tokens)
        if self._prefix is not None:
            pin = self._prefix.pin_covering(tokens)
            if pin is not None:
                stale = h.__dict__.pop("_preempt_pin", None)
                if stale is not None:
                    self._prefix.release(stale)
                h._preempt_pin = pin
        self._free_slot_table(sid)
        self._slots[sid] = None
        self._count("evicted")
        h.preempted += 1
        if h._usage is not None:
            # residency closes and a second queue wait opens; the
            # device-seconds already charged stay charged
            self._usage.preempted(h._usage, now)
        with self._counts_lock:
            self._qos_counts["preempted"] += 1
        self._queue.requeue(h)

    def _accrue_paged_kv(self) -> None:
        """Per-iteration paged-KV billing: each request's actually-held
        page bytes (``holder_bytes``: a page shared by k holders bills
        1/k to each) integrated over the interval since the last call,
        target and draft pools, slots and admissions."""
        now = time.monotonic()
        last, self._last_kv_accrue = self._last_kv_accrue, now
        if last is None or now <= last:
            return
        dt = now - last

        def bill(h, tbl, d_tbl):
            if h._usage is None:
                return
            b = (self._pages.holder_bytes(tbl.pages)
                 if tbl is not None else 0.0)
            if d_tbl is not None:
                b += self._d_pages.holder_bytes(d_tbl.pages)
            if b > 0.0:
                self._usage.accrue_kv(h._usage, b * dt)

        for sid, st in enumerate(self._slots):
            if st is not None:
                bill(st.handle, self._tables[sid],
                     self._d_tables[sid]
                     if self._d_tables is not None else None)
        for a in self._adms:
            bill(a.handle, a.table, a.d_table)

    # ------------------------------------------------ host-tier moves
    # Every copy below is enqueued on the engine's (current) stream, as
    # the decode and prefill calls are: a demotion's device-to-host copy
    # reads its row before any later write to that row, and a
    # promotion's host-to-device copy lands before any later prefill
    # reads it. On the card the host side is pinned memory and the
    # copies are asynchronous; PyTorch's pinned-memory allocator keeps a
    # freed host buffer until the copies that use it have run.
    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cpu":
            return t.clone()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    def _host_copy(self, tree, row: int) -> list:
        """Row (or page) ``row`` of every tensor of a cache list, copied
        to host tensors: int8 codes and f32 scales as they are."""
        return [tuple(self._to_host(t[row]) for t in layer)
                for layer in tree]

    def _land(self, tree, row: int, src) -> None:
        """Copy a per-layer list of row tensors ``src`` (host or device)
        into row (or page) ``row`` of ``tree``."""
        for layer, src_layer in zip(tree, src):
            for d, s in zip(layer, src_layer):
                d[row].copy_(s, non_blocking=True)

    def _resolve_pending_demotion(self) -> None:
        """Complete the demotion a row claim left open: copy the victim's
        pool row to host and attach it. Runs before the claimed row is
        overwritten (its KV is the source). A failed host allocation
        drops the entry instead."""
        pend = self._prefix.pop_pending_demotion()
        if pend is None:
            return
        victim, vrow = pend
        try:
            buf = self._host_copy(self._pool, vrow)
        except RuntimeError:
            buf = None
        self._prefix.complete_demotion(victim, buf)

    def _begin_promotion(self, entry) -> None:
        """Start (or touch) the host-to-device copy of a host-tier entry
        a queued candidate's lookup landed on. The copy is enqueued at
        once and overlaps the request's queue wait; the record pins the
        entry, so its host buffer stays while the copy runs."""
        key = id(entry)
        now = time.monotonic()
        rec = self._promotions.get(key)
        if rec is not None:
            rec["touched"] = now
            return
        if entry.host_buf is None:
            return
        if len(self._promotions) >= self._promotions_max:
            # bound the copies in flight (device bytes and host pins):
            # drop the stalest record and its pin
            stalest = min(self._promotions,
                          key=lambda k: self._promotions[k]["touched"])
            self._drop_promotion(stalest)
        self._prefix.acquire(entry)
        tree = [tuple(h.to(self.device, non_blocking=True) for h in layer)
                for layer in entry.host_buf]
        self._promotions[key] = {"entry": entry, "tree": tree,
                                 "touched": now}

    def _drop_promotion(self, key) -> None:
        rec = self._promotions.pop(key, None)
        if rec is not None:
            self._prefix.release(rec["entry"])

    def _prune_promotions(self, now: float) -> None:
        """Retire promotion records whose entry left the host tier
        (promoted by another admission, or dropped) and ones no scorer
        touched for 30 s (their request was cancelled or timed out), so
        no pin outlives its use and the host LRU can evict."""
        for key in [k for k, r in self._promotions.items()
                    if r["entry"].tier != "host"
                    or now - r["touched"] > 30.0]:
            self._drop_promotion(key)

    def _promote_entry(self, entry) -> bool:
        """Make a host-tier entry device-resident for the admission that
        consumes it: claim a pool row (evict-or-demote, as a donation
        does), land the entry's KV there (the copy the scorer started,
        else one started here) and flip the entry's tier. False: the
        promotion fell through and the caller takes a clean miss."""
        rec = self._promotions.pop(id(entry), None)
        if entry.tier != "host":
            # another admission promoted it first: its row is live
            if rec is not None:
                self._prefix.release(entry)
            return entry.tier == "device"
        if rec is None:
            if entry.host_buf is None:
                return False
            # pin for the promotion: allocate_row's evict-or-demote sweep
            # must not reclaim this entry's host buffer
            self._prefix.acquire(entry)
        try:
            src = rec["tree"] if rec is not None else entry.host_buf
            row = self._prefix.allocate_row()
            if row is None:
                return False        # every device row pinned: clean miss
            # the claimed row may hold a freshly demoted victim's KV:
            # enqueue its copy to host before this copy overwrites it
            self._resolve_pending_demotion()
            self._land(self._pool, row, src)
            self._prefix.promote(entry, row)
            return True
        finally:
            self._prefix.release(entry)

    def _promote_entry_paged(self, entry) -> bool:
        """Host-to-device promotion of a paged host-tier entry at
        admission: allocate fresh pages (reclaiming unpinned prefix
        entries under pressure), land each host page in one, flip the
        entry's tier. False: a clean miss (the pool is exhausted, or the
        buffer was evicted)."""
        if entry.tier != "host":
            return entry.tier == "device"
        buf = entry.host_buf
        if buf is None:
            return False
        pages = self._pages.alloc(len(buf))
        if pages is None:
            self._prefix.reclaim(len(buf), self._spill)
            pages = self._pages.alloc(len(buf))
        if pages is None:
            return False
        for dst, host_page in zip(pages, buf):
            self._land(self._kv_pool, dst, host_page)
        self._prefix.promote_pages(entry, pages)
        return True

    def _spill(self, pages):
        """``PagedPrefixIndex.reclaim``'s demotion callback (the index
        calls it only with a host tier): each victim page of every layer
        copied to host (one host tree a page), or None when a host
        allocation fails, to drop the victim instead."""
        try:
            return [self._host_copy(self._kv_pool, p) for p in pages]
        except RuntimeError:
            return None

    # --------------------------------------------------------- decode
    def _ride_along(self):
        """The decode call's (max_slots,) tokens and positions: every
        occupied slot at its own (last token, pos), free slots at (0,
        0). An occupied slot held out of the round (a chaos freeze) thus
        writes only at its own position ``pos``, which its KV does not
        cover yet and its next real round rewrites before attending; at
        (0, 0) it would overwrite its own first prompt position (the
        JAX engine's frozen rows do, and in paged mode that position
        may sit on a page shared with the prefix index)."""
        tok = np.zeros((self.max_slots,), np.int64)
        pos = np.zeros((self.max_slots,), np.int64)
        for sid, st in enumerate(self._slots):
            if st is not None:
                tok[sid] = st.last_token
                pos[sid] = st.pos
        return tok, pos

    def _decode_all(self, active: List[int]) -> None:
        if self.draft is not None:
            return self._decode_all_spec(active)
        tok, pos = self._ride_along()
        was_warm = "step" in self._warm
        if self._chaos is not None:
            self._chaos.on_dispatch()
        t_disp = time.monotonic()
        nxt = self._step(self._h2d(tok), self._h2d(pos)).tolist()
        self._warm.add("step")
        now = time.monotonic()
        self._count("decode_steps")
        # every advanced row got one token: the wall splits evenly (idle
        # and frozen rows ride along as padding waste, unbilled)
        if was_warm:
            w = 1.0 / len(active)
            self._usage.charge_dispatch(
                "decode", now - t_disp,
                [(self._slots[sid].handle._usage, w) for sid in active],
                rows_advanced=len(active), capacity_rows=self.max_slots)
        for sid in active:
            self._deliver_burst(sid, nxt[sid:sid + 1], now)

    def _decode_all_spec(self, active: List[int]) -> None:
        """Speculative decode over every occupied slot: gamma draft steps,
        one ragged target verify, and (when some row accepted all gamma)
        one draft sync step; one host sync reads the accepted counts and
        the emitted tokens together. Acceptance is per row, and eos or
        the request's token budget can cut a burst short."""
        g = self._spec.gamma
        tok, pos = self._ride_along()
        was_warm = "spec" in self._warm
        if self._chaos is not None:
            self._chaos.on_dispatch()
        t_disp = time.monotonic()
        tok_d, pos_d = self._h2d(tok), self._h2d(pos)
        props, qlogits = self._propose(tok_d, pos_d)
        emit, n_acc = self._spec_verify(tok_d, props, qlogits, pos_d)
        host = torch.cat([emit, n_acc[:, None]], 1).cpu().numpy()
        wall = time.monotonic() - t_disp
        self._warm.add("spec")
        emit_np, n_np = host[:, :-1], host[:, -1]
        self._count("decode_steps")
        # a row that accepted all gamma proposals lacks the draft KV of
        # its last one: re-write each row's last accepted token at its
        # own position (no-ops for the others, a held-out row's own
        # pos included); launched after the sync, ordered before the
        # next propose by the stream
        if any(int(n_np[sid]) == g for sid in active):
            sync_tok, sync_pos = tok.copy(), pos.copy()
            for sid in active:
                n_r = int(n_np[sid])
                if n_r:
                    sync_tok[sid] = emit_np[sid, n_r - 1]
                    sync_pos[sid] = pos[sid] + n_r
            self._d_sync(self._h2d(sync_tok), self._h2d(sync_pos))
        now = time.monotonic()
        bursts = {}
        for sid in active:
            st = self._slots[sid]
            n_r = int(n_np[sid])
            self._spec_proposed += g
            self._spec_accepted += n_r
            st.handle.spec_proposed += g
            st.handle.spec_accepted += n_r
            room = st.handle.max_new_tokens - st.delivered
            toks = emit_np[sid, :min(n_r + 1, room)]
            if self.eos_id is not None:
                hits = np.flatnonzero(toks == self.eos_id)
                if hits.size:     # eos mid-burst: stop AT it
                    toks = toks[:hits[0] + 1]
            bursts[sid] = toks
        if was_warm:
            # the round's wall splits by each row's delivered tokens,
            # billed before any row can finalize
            total = sum(len(b) for b in bursts.values()) or 1
            self._usage.charge_dispatch(
                "decode", wall,
                [(self._slots[sid].handle._usage, len(b) / total)
                 for sid, b in bursts.items()],
                rows_advanced=len(active), capacity_rows=self.max_slots)
        for sid in active:
            self._deliver_burst(sid, bursts[sid], now)

    def _deliver_burst(self, sid: int, toks, now: float) -> None:
        """Stream one decode round's tokens (one, or a speculative burst
        of 1..gamma+1, in order) into the slot's handle and advance the
        slot's position by the delivered count: afterwards its KV covers
        ``[0, pos)`` and the last token's KV is not cached yet, as after
        a one-token step. Observes the inter-token histogram per token
        (the round's gap split evenly across its burst) and finishes the
        row at eos or its token budget."""
        st = self._slots[sid]
        h = st.handle
        m = len(toks)
        gap = (now - st.last_token_at) / m
        for t in toks:
            st.delivered += 1
            h._deliver(int(t), now)
            self._hists["inter_token"].observe(gap)
        st.pos += m
        st.last_token = int(toks[-1])
        st.last_token_at = now
        if h._usage is not None:
            self._usage.delivered(h._usage, m)
        if (self.eos_id is not None and st.last_token == self.eos_id) \
                or st.delivered >= h.max_new_tokens:
            self._release(sid, None, "finished")

    def _release(self, sid: int, error: Optional[Exception],
                 reason: str) -> None:
        st = self._slots[sid]
        # donate BEFORE the slot is surrendered: its KV covers [0, pos),
        # the prompt plus every delivered token but the last. Cancelled
        # and timed-out slots donate too (a retry then pays only its
        # novel suffix)
        self._maybe_donate(sid, np.concatenate(
            [st.handle.prompt,
             np.asarray(st.handle._tokens[:-1], np.int32)]))
        self._free_slot_table(sid)
        self._slots[sid] = None
        self._count("evicted")
        self._count("finished" if reason == "finished" else reason)
        self._finish_handle(st.handle, error, reason)

    def _finish_dropped(self, h: RequestHandle, err: Exception) -> None:
        kind = ("cancelled" if isinstance(err, RequestCancelled)
                else "timed_out")
        self._count(kind)
        self._finish_handle(h, err, kind)
