"""Continuous-batching decode engine over a slot-pooled KV cache (port of
``bigdl_tpu/serving/engine.py``, dense slots).

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

Greedy output is token-identical to a lone ``model.generate`` per
request, with the prefix cache cold or warm (tested against the JAX
engine on the same weights). Sampling draws from a ``torch.Generator``
on the engine's device seeded by ``seed``.

Later steps of the JAX engine (paged KV, speculative decoding, int8 KV
and weights, the prefix host tier, QoS shedding / rate limits /
preemption, chaos drills, tensor-parallel serving) raise
``NotImplementedError`` naming their ``ROADMAP.md`` item; the
observability hooks (recorder, metric instruments, memory pools, usage
ledger, watchdogs, time series, incidents, cost model, loop-phase
accounting) are not ported yet, and ``registry=`` / ``recorder=`` are
accepted and unused.
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
    _filter_logits, _validate_sampling,
)
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.scheduler import AdmissionQueue, PrefillPolicy
from bigdl_tpu_torch.serving.streams import (
    EngineDraining, EngineStopped, RequestCancelled, RequestHandle,
    RequestTimedOut,
)

#: options of the JAX engine that later steps of this port bring, by
#: the sub-step of ROADMAP.md Queue 1 item 3 that brings them
_LATER = {
    "page_size": "paged KV",
    "max_pages": "paged KV",
    "draft": "speculative decoding",
    "kv_dtype": "int8 KV and weights",
    "weights_dtype": "int8 KV and weights",
    "prefix_host_bytes": "the prefix host tier",
    "prefix_host_rows": "the prefix host tier",
    "tenant_rate_limits": "QoS shedding, rate limits and preemption",
    "chaos": "chaos.py",
    "mesh": "tensor-parallel serving",
    "tp_rules": "tensor-parallel serving",
}

#: the flow counters ``stats()`` reports (the JAX engine's
#: ``_stats_base``), then this port's loop tallies
_FLOW = ("admitted", "finished", "evicted", "timed_out", "cancelled")
_TALLIES = ("iterations", "prefill_rounds", "decode_steps")


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} belongs to a later step of the engine's port "
        f"(ROADMAP.md, Queue 1 item 3: {_LATER[what]}); this "
        "engine serves dense slots")


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
    are in flight at once, each owning one staging row and one reserved
    slot; every prefill round advances all of them by one chunk."""

    __slots__ = ("handle", "slot", "row", "ids", "t0", "base", "tail",
                 "n_chunks", "next_chunk", "entry")

    def __init__(self, handle: RequestHandle, slot: int, row: int,
                 ids: np.ndarray, t0: int, base: int, n_chunks: int,
                 entry=None):
        self.handle = handle
        self.slot = slot          # reserved pool slot (insert target)
        self.row = row            # staging row this prefill owns
        self.ids = ids            # (n_chunks * chunk,) right-padded tail
        self.t0 = t0              # full prompt length
        self.base = base          # chunk-aligned cached-prefix offset
        self.tail = t0 - base     # tokens actually prefilled
        self.n_chunks = n_chunks
        self.next_chunk = 0
        self.entry = entry        # pinned PrefixEntry on a hit, else None


class _SlotState:
    """Host-side view of one occupied KV slot."""

    __slots__ = ("handle", "pos", "last_token", "delivered")

    def __init__(self, handle: RequestHandle, pos: int, last_token: int):
        self.handle = handle
        #: cache position the next decode step writes: the slot's KV
        #: covers [0, pos), the last delivered token's KV is not cached
        #: yet (generate()'s host-loop invariant, which donation uses)
        self.pos = pos
        self.last_token = last_token
        self.delivered = 1


class ContinuousBatchingEngine:
    """Token-granular continuous batching over ``TransformerLM``'s
    incremental-decoding API (``init_cache`` / ``prefill_chunk_at`` /
    ``decode_step``), with prefix-cached, batched multi-row prefill.

    ``submit()`` returns a ``RequestHandle`` at once (bounded queue;
    ``QueueFull`` is the backpressure signal) and the loop thread streams
    tokens into it. The sampling config is fixed per engine; the default
    is greedy. ``prefix_cache_bytes`` sets the prefix pool's byte budget
    (None: two pool rows per slot; 0 disables the cache),
    ``prefix_cache_rows`` its row count directly, ``prefix_min_tokens``
    (default one chunk) the shortest reusable head; with
    ``admission_window > 1`` the queue pops the candidate with the
    longest usable cached prefix among the first ``admission_window``
    (bounded bypass, see ``AdmissionQueue.pop_ready``).
    ``prefill_rows`` widens the staging cache so that that many
    admissions prefill together through one ragged call a round.

    The engine runs on ``device`` (default: the model's device; a device
    that differs from the model's raises). ``priority`` ``"normal"`` and
    ``"low"`` are ordered by the admission queue; ``"high"`` raises until
    preemption is ported."""

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
                 draft=None, mesh=None, tp_rules=None,
                 kv_dtype: Optional[str] = None,
                 weights_dtype: Optional[str] = None,
                 tenant_rate_limits=None, chaos=None,
                 page_size: Optional[int] = None,
                 max_pages: Optional[int] = None, device=None):
        for name, val in (("page_size", page_size),
                          ("max_pages", max_pages), ("draft", draft),
                          ("mesh", mesh), ("tp_rules", tp_rules),
                          ("kv_dtype", kv_dtype),
                          ("weights_dtype", weights_dtype),
                          ("prefix_host_bytes", prefix_host_bytes),
                          ("prefix_host_rows", prefix_host_rows),
                          ("tenant_rate_limits", tenant_rate_limits),
                          ("chaos", chaos)):
            if val is not None:
                raise _later(name)
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if admission_window < 1:
            raise ValueError(
                f"admission_window must be >= 1, got {admission_window}")
        _validate_sampling(temperature > 0.0, top_k, top_p)
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
        model.evaluate()
        self.model = model
        self.max_slots = max_slots
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
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

        # the persistent device tensors, allocated as inference tensors:
        # the loop writes them in place under inference_mode
        with torch.inference_mode():
            self._caches = model.init_cache(max_slots, cache_len)
            self._staging = model.init_cache(self._policy.prefill_rows,
                                             cache_len)
            row_bytes = sum(int(k.nbytes) + int(v.nbytes)
                            for k, v in self._caches) // max_slots
            self._row_bytes = row_bytes
            #: device KV bytes one cached token position costs
            self._token_bytes = row_bytes / cache_len
            if prefix_cache_rows is not None:
                pool_rows = max(0, int(prefix_cache_rows))
            elif prefix_cache_bytes is None:
                pool_rows = 2 * max_slots
            else:
                pool_rows = max(0, int(prefix_cache_bytes) // row_bytes)
            if pool_rows > 0:
                self._pool = model.init_cache(pool_rows, cache_len)
                self._prefix = PrefixCache(
                    pool_rows, row_bytes,
                    min_tokens=(prefix_min_tokens
                                if prefix_min_tokens is not None else c),
                    token_bytes=self._token_bytes)
            else:
                self._pool = None
                self._prefix = None
        #: prompt tokens this engine actually prefilled (the reused
        #: fraction's denominator)
        self._prefilled_tokens = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        self._queue = AdmissionQueue(queue_capacity)
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

    # ------------------------------------------- the four device programs
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
        per-row positions, written into the slot pool in place."""
        logits, _ = self.model.decode_step(tok, pos, self._caches)
        return self._pick(logits)

    def _chunk(self, ids: torch.Tensor, pos0: torch.Tensor,
               last: torch.Tensor) -> torch.Tensor:
        """One ragged prefill round over the whole staging cache: row r
        writes its chunk at its own offset ``pos0[r]``; ``last`` picks
        each row's true last prompt position (the final chunk is
        right-padded)."""
        logits, _ = self.model.prefill_chunk_at(ids, self._staging, pos0,
                                                last)
        return logits

    @staticmethod
    def _copy_row(dst, src, dst_row: int, src_row: int) -> None:
        """Row ``src_row`` of cache list ``src`` into row ``dst_row`` of
        ``dst``, every layer's k and v, in place: staging → slot on
        insert, pool → staging on a hit, slot → pool on donation."""
        for (dk, dv), (sk, sv) in zip(dst, src):
            dk[dst_row].copy_(sk[src_row])
            dv[dst_row].copy_(sv[src_row])

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
        for a in self._adms:
            if a.entry is not None:
                self._prefix.release(a.entry)
                a.entry = None
            self._finish_handle(a.handle, err, "stopped")
        self._adms = []
        for sid, st in enumerate(self._slots):
            if st is not None:
                self._finish_handle(st.handle, err, "stopped")
                self._slots[sid] = None

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
        raises ``QueueFull``. ``tenant`` (default ``"default"``),
        ``priority`` and ``trace_id`` are stored on the handle."""
        if priority == "high":
            raise NotImplementedError(
                "priority='high' belongs to a later step of the engine's "
                "port (ROADMAP.md, Queue 1 item 3: QoS shedding, rate "
                "limits and preemption); 'normal' and 'low' are served")
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
        h = RequestHandle(prompt, n, timeout_s, priority=priority)
        h.tenant = tenant if tenant is not None else "default"
        h.trace_id = trace_id
        self.start()
        try:
            self._queue.put(h, block=block, timeout=queue_timeout_s)
        except RequestTimedOut:
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
        """Terminal bookkeeping for ONE request: the stream sentinel and
        the finished-timeline ring entry. ``_finish`` arbitrates racing
        finishers (a stopping submitter against the loop): only the
        winner records."""
        if not h._finish(err):
            return
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

    def stats(self) -> dict:
        """The flow counters since construction (admitted, finished,
        evicted, timed_out, cancelled), the loop's iterations, prefill
        rounds and decode steps, ``active_slots``, ``queue_depth``,
        ``latency`` (``{count, mean, p50, p90, p99}`` of queue wait,
        prefill, TTFT, decode and total over the recent finished
        requests) and ``prefix_cache`` (hit rate, reused tokens, bytes)."""
        with self._counts_lock:
            out = dict(self._counts)
        out["active_slots"] = sum(s is not None for s in self._slots)
        out["queue_depth"] = len(self._queue)
        out["latency"] = self._latency_summary()
        out["prefix_cache"] = self._prefix_summary()
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
        for a in self._adms:
            if a.entry is not None:
                self._prefix.release(a.entry)
                a.entry = None
            self._finish_handle(a.handle, err, "crashed")
        self._adms = []
        for sid, st in enumerate(self._slots):
            if st is not None:
                self._finish_handle(st.handle, err, "crashed")
                self._slots[sid] = None
        for h in self._queue.drain():
            self._finish_handle(h, err, "crashed")

    def _iterate(self) -> bool:
        now = time.monotonic()
        worked = False
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

        # 4. one fused decode step over every occupied slot
        active = [sid for sid, st in enumerate(self._slots)
                  if st is not None]
        if active:
            self._decode_all(active)
            worked = True
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

    def _fill_admissions(self, now: float) -> None:
        """Start new admissions until the staging cache is full, the slot
        pool is exhausted, or the queue runs dry. With a prefix cache and
        ``admission_window > 1`` the pop prefers the queued candidate
        with the longest usable cached prefix (bounded bypass)."""
        scorer = None
        if self._prefix is not None and self.admission_window > 1:
            c = self._policy.chunk

            def scorer(h):
                # the usable (capped, chunk-aligned) reuse, exactly what
                # _start_admission will skip; the raw lookup is stamped
                # on the handle (generation-guarded) for the winner
                p = self._effective_prompt(h)
                e, m = self._prefix.lookup(p)
                h._prefix_probe = (e, m, self._prefix.generation)
                return (min(m, p.shape[0] - 1) // c) * c
        while len(self._adms) < self._policy.prefill_rows:
            slot = self._free_slot()
            if slot is None:
                return
            row = self._free_staging_row()
            if row is None:
                return
            h, dropped = self._queue.pop_ready(
                now, scorer=scorer, window=self.admission_window)
            for hd, err in dropped:
                self._finish_dropped(hd, err)
            if h is None:
                return
            self._start_admission(h, slot, row)

    @staticmethod
    def _effective_prompt(h: RequestHandle) -> np.ndarray:
        """What an admission must have in the KV cache before decode can
        continue: the prompt plus every already-generated token (none,
        until preemption is ported)."""
        if h._tokens:
            return np.concatenate(
                [h.prompt, np.asarray(h._tokens, np.int32)])
        return h.prompt

    def _start_admission(self, h: RequestHandle, slot: int,
                         row: int) -> None:
        """Stage one popped request for chunked prefill, copying its
        usable cached prefix into its staging row on a hit."""
        c = self._policy.chunk
        prompt = self._effective_prompt(h)
        t0 = prompt.shape[0]
        base, entry = 0, None
        if self._prefix is not None:
            # reuse the scorer's lookup while it is still valid: the
            # generation guard rejects probes older than any donation or
            # eviction (a stale entry's row may hold other tokens' KV)
            probe = h.__dict__.pop("_prefix_probe", None)
            if probe is not None and probe[2] == self._prefix.generation:
                e, matched = probe[0], probe[1]
            else:
                e, matched = self._prefix.lookup(prompt)
            if e is not None:
                # cap at t0 - 1 (the last prompt position must be
                # computed: its logits seed the first token), then align
                # DOWN to a chunk multiple so the tail's chunk geometry
                # matches a cold prefill's and its padded writes stay in
                # the cache
                base = (min(matched, t0 - 1) // c) * c
            if base > 0:
                entry = e
                self._prefix.record_hit(entry, base)
                self._prefix.acquire(entry)
                self._copy_row(self._staging, self._pool, row, entry.row)
            else:
                self._prefix.record_miss()
        tail = t0 - base
        n_chunks = self._policy.n_chunks(tail)
        ids = np.zeros((n_chunks * c,), np.int64)   # right-pad final chunk
        ids[:tail] = prompt[base:]
        self._adms.append(_Admission(h, slot, row, ids, t0, base,
                                     n_chunks, entry))
        h.prefix_tokens = base
        if h.admitted_at is None:
            h.admitted_at = time.monotonic()
        self._count("admitted")

    def _prefill_round(self) -> None:
        """Advance EVERY in-flight admission by one chunk through one
        ragged call, then complete those whose prompt is fully staged
        (slot insert and first-token sample)."""
        c = self._policy.chunk
        rows = self._policy.prefill_rows
        ids = np.zeros((rows, c), np.int64)
        pos0 = np.zeros((rows,), np.int64)
        last = np.full((rows,), c - 1, np.int64)
        finals: List[_Admission] = []
        for a in self._adms:
            k = a.next_chunk
            ids[a.row] = a.ids[k * c:(k + 1) * c]
            pos0[a.row] = a.base + k * c
            if k == a.n_chunks - 1:
                # the true last prompt position within the final chunk:
                # the pads behind it are written but never attended
                last[a.row] = a.tail - 1 - k * c
                finals.append(a)
        logits = self._chunk(self._h2d(ids), self._h2d(pos0),
                             self._h2d(last))
        toks = self._pick(logits).tolist() if finals else None
        self._count("prefill_rounds")
        for a in self._adms:
            self._prefilled_tokens += min(c, a.tail - a.next_chunk * c)
            a.next_chunk += 1
        for a in finals:
            self._complete_admission(a, int(toks[a.row]))

    def _complete_admission(self, a: _Admission, tok: int) -> None:
        # prompt fully staged: copy the staging row into the reserved
        # slot, unpin the prefix entry (the staged copy no longer needs
        # it), deliver the first token
        self._copy_row(self._caches, self._staging, a.slot, a.row)
        if a.entry is not None:
            self._prefix.release(a.entry)
            a.entry = None
        self._adms.remove(a)
        now = time.monotonic()
        h = a.handle
        h._deliver(tok, now)
        if (self.eos_id is not None and tok == self.eos_id) \
                or len(h._tokens) >= h.max_new_tokens:
            # instant finisher: the slot row holds the prompt's KV;
            # donate it before the slot identity is lost
            self._maybe_donate(a.slot, np.concatenate(
                [h.prompt, np.asarray(h._tokens[:-1], np.int32)]))
            self._finish_handle(h, None, "finished")
            self._count("finished")
            return
        st = _SlotState(h, a.t0, tok)
        st.delivered = len(h._tokens)
        self._slots[a.slot] = st

    def _abort_admission(self, a: _Admission, err: Exception,
                         kind: str) -> None:
        if a.entry is not None:
            self._prefix.release(a.entry)
            a.entry = None
        self._adms.remove(a)
        self._count(kind)
        self._finish_handle(a.handle, err, kind)

    def _maybe_donate(self, sid: int, tokens: np.ndarray) -> None:
        """Offer a finishing slot's KV to the prefix pool. ``tokens`` are
        exactly the ids whose KV the slot holds (positions
        ``0..len-1``); the index decides (covered / LRU-evict / decline)
        and an accepted row is filled by one row copy."""
        if self._prefix is None:
            return
        row = self._prefix.donate(tokens)
        if row is not None:
            self._copy_row(self._pool, self._caches, row, sid)

    # --------------------------------------------------------- decode
    def _decode_all(self, active: List[int]) -> None:
        tok = np.zeros((self.max_slots,), np.int64)
        pos = np.zeros((self.max_slots,), np.int64)
        for sid in active:
            st = self._slots[sid]
            tok[sid] = st.last_token
            pos[sid] = st.pos
        nxt = self._step(self._h2d(tok), self._h2d(pos)).tolist()
        self._count("decode_steps")
        now = time.monotonic()
        for sid in active:
            self._deliver_burst(sid, nxt[sid], now)

    def _deliver_burst(self, sid: int, tok: int, now: float) -> None:
        """Stream one decode round's token into the slot's handle and
        advance the slot by one position; finishes the row at eos or its
        token budget. (Dense decode delivers one token a round; the
        multi-token burst of speculative decoding waits for that step.)"""
        st = self._slots[sid]
        h = st.handle
        st.delivered += 1
        h._deliver(int(tok), now)
        st.pos += 1
        st.last_token = int(tok)
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
        self._slots[sid] = None
        self._count("evicted")
        self._count("finished" if reason == "finished" else reason)
        self._finish_handle(st.handle, error, reason)

    def _finish_dropped(self, h: RequestHandle, err: Exception) -> None:
        kind = ("cancelled" if isinstance(err, RequestCancelled)
                else "timed_out")
        self._count(kind)
        self._finish_handle(h, err, kind)
