"""Admission control for the continuous-batching engine (port of
``bigdl_tpu/serving/scheduler.py``, a copy: the JAX package's module is
framework-free, but importing it would import JAX).

Two policies live here, deliberately separate from the device loop:

- ``AdmissionQueue`` — a bounded FCFS queue with BACKPRESSURE
  (``put`` blocks or raises ``QueueFull`` when the bound is hit, so an
  overloaded engine pushes back instead of buffering unboundedly) plus
  deadline/cancellation sweeps: expired or cancelled requests are
  dropped from the queue without ever costing a prefill. ``pop_ready``
  reorders within a bounded window by ``(priority class, deadline
  slack, -prefix score)`` — high-class and deadline-tight requests
  admit first, the caller-supplied scorer (the engine scores by
  cached-prefix length) breaks ties, and a per-class forced-FCFS
  starvation bound keeps even best-effort traffic finite-wait.
  ``requeue`` re-heads a preempted handle past the capacity bound.
- ``TokenBucket`` — per-tenant post-paid device-second rate limiting:
  admit while positive, debit the UsageLedger's measured cost at
  finalize, refuse with an exact ``retry_after()`` once negative.
- ``PrefillPolicy`` — the prefill-vs-decode interleave: how many
  prompt tokens each loop iteration may spend on admission before the
  shared decode step runs (``budget_tokens``), and how many admissions
  prefill TOGETHER through one ragged dispatch (``prefill_rows``).
  Chunked prefill under a per-iteration token budget means admitting a
  10k-token prompt never stalls the decode of already-running requests
  for more than one round's worth of work.
- ``SpeculationPolicy`` — the draft-propose/target-verify decode
  config (``engine(draft=..., spec_gamma=...)``): how many tokens the
  draft model proposes per fused decode round (``gamma``), and the
  derived shapes the engine's compiled programs depend on (the
  ``gamma + 1``-wide verify chunk, the extra KV positions every pool
  row must carry for rejected-proposal scratch writes).

The reference's serving story (optim/PredictionService.scala) bounds
concurrency with an instance queue; this is the generative analog where
the bounded resource is KV-cache slots, not model clones.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

from bigdl_tpu_torch.observability.events import default_recorder
from bigdl_tpu_torch.serving.streams import (
    PRIORITIES, PRIORITY_RANK, QueueFull, RequestCancelled,
    RequestHandle, RequestTimedOut,
)


def _rank(h: RequestHandle) -> int:
    return PRIORITY_RANK.get(getattr(h, "priority", "normal"), 1)


class AdmissionQueue:
    """Bounded FCFS admission queue with backpressure.

    Thread contract: any thread may ``put``; only the engine loop calls
    ``pop_ready`` / ``sweep``. Dropped handles (cancelled or past their
    deadline while queued) are returned to the caller as
    ``(handle, error)`` pairs — the ENGINE finishes them, so all
    terminal bookkeeping (metrics, stream sentinels) stays in one
    place."""

    def __init__(self, capacity: int = 64, recorder=None,
                 wait_histogram=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._q: "deque[RequestHandle]" = deque()
        self._lock = threading.Condition()
        #: optional histogram child observing each popped handle's
        #: submit→admission wait (anything with ``observe(seconds)``)
        self._wait_hist = wait_histogram
        # queue transitions land in the flight recorder (request/queued
        # on put, request/queue_dropped for sweep/pop casualties) so a
        # request's timeline starts before it ever reaches a slot
        if recorder is None:
            recorder = default_recorder()
        self._rec = recorder
        #: consecutive scorer-driven head bypasses (pop_ready fairness)
        self._head_bypasses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def snapshot(self) -> List[RequestHandle]:
        """The queued handles, FCFS order (a copy — ``/debug/requests``
        reads it without racing the loop thread's pops)."""
        with self._lock:
            return list(self._q)

    def put(self, handle: RequestHandle, block: bool = True,
            timeout: Optional[float] = None) -> None:
        """Enqueue FCFS. When full: raise ``QueueFull`` immediately
        (``block=False``), or wait up to ``timeout`` (None = forever)
        for space — the backpressure path.

        A handle with its own request deadline never out-sleeps it: the
        wait is bounded by the deadline too, and a request whose
        deadline expired while it was blocked here is rejected with
        ``RequestTimedOut`` at wake-up — admitting it would hand a slot
        (and a prefill) to a request that can only ever time out."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._lock:
            while len(self._q) >= self.capacity:
                now = time.monotonic()
                if handle.deadline is not None and now > handle.deadline:
                    self._rec.record("request/queue_dropped",
                                     handle.request_id,
                                     reason="RequestTimedOut",
                                     tenant=getattr(handle, "tenant",
                                                    None))
                    raise RequestTimedOut(
                        f"deadline passed after "
                        f"{now - handle.submitted_at:.3f}s blocked on a "
                        f"full admission queue ({self.capacity} queued) "
                        "— rejected instead of admitted with a dead "
                        "deadline")
                if not block:
                    raise QueueFull(
                        f"admission queue full ({self.capacity} queued); "
                        "retry later or raise queue_capacity")
                remaining = None if deadline is None else deadline - now
                if remaining is not None and remaining <= 0:
                    raise QueueFull(
                        f"admission queue still full ({self.capacity} "
                        f"queued) after {timeout}s")
                if handle.deadline is not None:
                    dl_left = handle.deadline - now
                    remaining = (dl_left if remaining is None
                                 else min(remaining, dl_left))
                if (not self._lock.wait(timeout=remaining)
                        and handle.deadline is None):
                    raise QueueFull(
                        f"admission queue still full ({self.capacity} "
                        f"queued) after {timeout}s")
            self._q.append(handle)
            # recorded while still holding the queue lock: pop_ready
            # takes the same lock, so the loop thread cannot record
            # request/admitted before request/queued exists (the
            # recorder has its own independent lock — no ordering
            # between the two is ever taken in reverse)
            self._rec.record("request/queued", handle.request_id,
                             depth=len(self._q),
                             tenant=getattr(handle, "tenant", None))
            self._lock.notify_all()

    def pop_ready(self, now: Optional[float] = None, scorer=None,
                  window: int = 1
                  ) -> Tuple[Optional[RequestHandle],
                             List[Tuple[RequestHandle, Exception]]]:
        """Pop the next LIVE handle, skipping over — and returning —
        any cancelled/expired ones encountered on the way. Returns
        ``(handle_or_None, dropped)``.

        QoS ordering: with ``window > 1`` the pop considers the first
        ``window`` live handles and takes the best by the composite
        key ``(priority class, deadline slack, -score)`` — high class
        beats tight deadline beats cached-prefix length (``scorer``:
        handle → number, e.g. the cached-prefix length of the handle's
        prompt). Ties keep strict FCFS — the key only ever REORDERS
        within the window on a strict improvement, so all-default
        traffic (same class, no deadlines, no scorer) stays exactly
        FCFS and admission stays work-conserving.

        Starvation is bounded PER CLASS: after ``window`` consecutive
        pops bypass a high/normal queue head — or ``2 * window`` for a
        low-class head — the next pop is forced FCFS, so even a
        best-effort request under a priority storm waits at most a
        bounded number of extra admissions, never forever.

        The scorer MAY carry side effects: the engine's prefix scorer
        starts the async host→device promotion the moment a candidate's
        trie walk lands on a host-tier row, so the transfer overlaps
        the rest of the candidate's QUEUE WAIT (``pop_ready`` calls the
        scorer once per live windowed candidate per pop — candidates
        put back at the head keep their in-flight transfer and are
        re-scored, not re-started, on the next pop). By the admission
        that finally consumes the entry, the copy has usually landed
        and the reuse path proceeds exactly as a device-tier hit."""
        now = time.monotonic() if now is None else now
        dropped: List[Tuple[RequestHandle, Exception]] = []
        with self._lock:
            if window <= 1:
                # plain FCFS fast path: O(1) popleft per live pop —
                # a deep queue must not pay a full rebuild per
                # admission when nothing reorders
                while self._q:
                    h = self._q.popleft()
                    err = self._terminal(h, now)
                    if err is None:
                        self._head_bypasses = 0
                        if self._wait_hist is not None:
                            self._wait_hist.observe(
                                max(0.0, now - h.submitted_at))
                        self._lock.notify_all()
                        return h, dropped
                    dropped.append((h, err))
                self._lock.notify_all()
                return None, dropped
            # scored path: materialize only the first `window` live
            # candidates off the head; the tail never moves
            live: List[RequestHandle] = []
            while self._q and len(live) < window:
                h = self._q.popleft()
                err = self._terminal(h, now)
                (live.append(h) if err is None
                 else dropped.append((h, err)))
            if not live:
                self._lock.notify_all()
                return None, dropped
            pick = live[0]
            # the head's class sets its own starvation tolerance: a
            # low-class head may be bypassed twice as long before the
            # forced-FCFS pop, but the bound stays finite — low never
            # starves completely, it just yields longer under load
            budget = window * (2 if _rank(live[0]) >= 2 else 1)
            if len(live) > 1 and self._head_bypasses < budget:
                # one scorer call per candidate (each is a trie walk)
                keys = [(_rank(h),
                         (h.deadline - now) if h.deadline is not None
                         else float("inf"),
                         -(scorer(h) if scorer is not None else 0))
                        for h in live]
                best = min(range(len(live)), key=keys.__getitem__)
                if keys[best] < keys[0]:
                    pick = live[best]
            self._head_bypasses = (self._head_bypasses + 1
                                   if pick is not live[0] else 0)
            for h in reversed(live):
                if h is not pick:
                    self._q.appendleft(h)
            if self._wait_hist is not None:
                self._wait_hist.observe(
                    max(0.0, now - pick.submitted_at))
            self._lock.notify_all()
            return pick, dropped

    def requeue(self, handle: RequestHandle) -> None:
        """Put a PREEMPTED handle back at the queue head, bypassing
        the capacity bound — the handle already held a slot, and
        re-admission must not deadlock behind the very backlog that
        caused the preemption. Bounded in practice by the engine's
        slot count (at most one preemption per occupied slot).
        Priority ordering still applies on the next pop: a requeued
        best-effort victim yields to the high-class request whose
        wait triggered the preemption."""
        with self._lock:
            self._q.appendleft(handle)
            self._rec.record("request/requeued", handle.request_id,
                             depth=len(self._q),
                             preempted=getattr(handle, "preempted", 0),
                             tenant=getattr(handle, "tenant", None))
            self._lock.notify_all()

    def pop_oldest(self, priority: str, now: Optional[float] = None
                   ) -> Optional[RequestHandle]:
        """Remove and return the longest-waiting live handle of one
        priority class (None when none is queued): the engine's pop
        right after a preemption, which frees the slot for the
        high-class request whose wait triggered it. ``pop_ready``'s
        window could miss that request behind requeued victims (the
        JAX queue has no such pop; see the engine's
        ``_fill_admissions``)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            pick = None
            for h in self._q:
                if (getattr(h, "priority", "normal") == priority
                        and self._terminal(h, now) is None
                        and (pick is None
                             or h.submitted_at < pick.submitted_at)):
                    pick = h
            if pick is None:
                return None
            self._q.remove(pick)
            if self._wait_hist is not None:
                self._wait_hist.observe(max(0.0, now - pick.submitted_at))
            self._lock.notify_all()
            return pick

    def oldest_waiting(self, priority: str,
                       now: Optional[float] = None) -> Optional[float]:
        """Longest current submit→now wait (seconds) among live queued
        handles of the given priority class, or None when none are
        queued — the engine's preemption trigger reads the high-class
        figure every iteration."""
        now = time.monotonic() if now is None else now
        with self._lock:
            waits = [now - h.submitted_at for h in self._q
                     if getattr(h, "priority", "normal") == priority
                     and not h.cancelled]
        return max(waits) if waits else None

    def depth_by_class(self) -> dict:
        """Queued handle count per priority class (``stats()["qos"]``
        composition figure)."""
        with self._lock:
            out = {p: 0 for p in PRIORITIES}
            for h in self._q:
                p = getattr(h, "priority", "normal")
                out[p] = out.get(p, 0) + 1
            return out

    def sweep(self, now: Optional[float] = None
              ) -> List[Tuple[RequestHandle, Exception]]:
        """Drop every cancelled/expired handle anywhere in the queue
        (not just the head) — a deep queue must not let a mid-queue
        deadline rot until it reaches the front."""
        now = time.monotonic() if now is None else now
        dropped: List[Tuple[RequestHandle, Exception]] = []
        with self._lock:
            keep: "deque[RequestHandle]" = deque()
            for h in self._q:
                err = self._terminal(h, now)
                (keep.append(h) if err is None
                 else dropped.append((h, err)))
            self._q = keep
            if dropped:
                self._lock.notify_all()
        return dropped

    def drain(self) -> List[RequestHandle]:
        """Remove and return everything (engine shutdown)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            self._lock.notify_all()
            return out

    def _terminal(self, h: RequestHandle, now: float
                  ) -> Optional[Exception]:
        err: Optional[Exception] = None
        if h.cancelled:
            err = RequestCancelled("cancelled while queued")
        elif h.deadline is not None and now > h.deadline:
            waited = now - h.submitted_at
            err = RequestTimedOut(
                f"deadline passed after {waited:.3f}s in the admission "
                "queue (never admitted to a slot)")
        if err is not None:
            self._rec.record("request/queue_dropped", h.request_id,
                             reason=type(err).__name__,
                             tenant=getattr(h, "tenant", None))
        return err


class TokenBucket:
    """Per-tenant device-second token bucket (POST-PAID): a request is
    admitted while the balance is positive and its measured
    device-seconds are debited at finalize — the balance may go
    negative (the in-flight request could not know its cost up
    front), at which point further admissions are refused until the
    refill brings it back above zero. ``retry_after()`` is therefore
    the exact refill time to a positive balance — the honest
    ``Retry-After`` figure the front door forwards.

    Post-paid was chosen over pre-paid reservation because a
    generation request's device cost is unknowable at submit (early
    eos, speculative acceptance, preemption all change it) and the
    UsageLedger already meters the true figure — the bucket just
    consumes ``UsageRecord.device_s`` at the same finalize point.
    ``pending`` is what the tenant's requests still in flight have
    already been metered: the caller counts it against the balance at
    admission, so concurrent submits cannot all pass a bucket that
    nothing has been debited from yet (the JAX bucket has no such
    argument).

    Thread-safe; monotonic-clock based; rate and burst are in
    device-seconds (per wall second / absolute)."""

    def __init__(self, rate_per_s: float, burst: float):
        if rate_per_s <= 0:
            raise ValueError(
                f"rate_per_s must be > 0, got {rate_per_s}")
        if burst <= 0:
            raise ValueError(f"burst must be > 0, got {burst}")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._level = float(burst)
        self._last: Optional[float] = None
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        if self._last is not None and now > self._last:
            self._level = min(self.burst,
                              self._level + (now - self._last)
                              * self.rate)
        self._last = now

    def try_admit(self, now: Optional[float] = None,
                  pending: float = 0.0) -> bool:
        """True while the balance less ``pending`` is positive (admit);
        no tokens are taken here — the debit lands at finalize with the
        measured cost."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._refill(now)
            return self._level - pending > 0.0

    def retry_after(self, now: Optional[float] = None,
                    pending: float = 0.0) -> float:
        """Seconds until the balance less ``pending`` refills back
        above zero (0.0 when already positive)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._refill(now)
            if self._level - pending > 0.0:
                return 0.0
            return (pending - self._level) / self.rate + 1e-9

    def debit(self, amount: float,
              now: Optional[float] = None) -> None:
        """Consume ``amount`` device-seconds (finalize-time, measured
        — may push the balance negative)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._refill(now)
            self._level -= float(amount)

    def level(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._refill(now)
            return self._level

    def snapshot(self, now: Optional[float] = None) -> dict:
        # graftlint: ok[lock-discipline] — rate/burst are immutable after __init__
        rate, burst = self.rate, self.burst
        return {"rate_device_s_per_s": rate,
                "burst_device_s": burst,
                "level_device_s": round(self.level(now), 9)}


class PrefillPolicy:
    """The prefill-vs-decode interleave: each loop iteration may spend
    at most ``budget_tokens`` prompt tokens (per staged row) on chunked
    prefill before the shared decode step runs. ``chunk`` is the
    compiled prefill chunk length (ONE program serves every offset —
    pos0 is traced), so the budget is consumed ``chunk`` tokens at a
    time — one *round* per take.

    ``prefill_rows`` is the second lever: the width of the engine's
    staging cache. Each prefill round advances up to ``prefill_rows``
    queued admissions by one chunk THROUGH ONE ragged dispatch (each
    row at its own offset), instead of one admission at a time — under
    a burst of arrivals, admission cost per request amortizes across
    the batch while the decode stall per iteration stays bounded by
    the same per-row token budget.

    Defaults: ``budget_tokens = 2 * chunk``, ``prefill_rows = 1`` —
    admission makes steady progress (a C-token prompt admits in one
    iteration) while a running decode never waits more than two
    rounds' worth of prefill."""

    def __init__(self, chunk: int = 16,
                 budget_tokens: Optional[int] = None,
                 prefill_rows: int = 1):
        if chunk < 1:
            raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
        if prefill_rows < 1:
            raise ValueError(
                f"prefill_rows must be >= 1, got {prefill_rows}")
        self.chunk = chunk
        self.prefill_rows = prefill_rows
        self.budget_tokens = (2 * chunk if budget_tokens is None
                              else budget_tokens)
        if self.budget_tokens < chunk:
            raise ValueError(
                f"budget_tokens ({self.budget_tokens}) must cover at "
                f"least one chunk ({chunk}) or admission never advances")
        self._left = 0

    def begin_iteration(self) -> None:
        self._left = self.budget_tokens

    def take_chunk(self) -> bool:
        """Spend one round (``chunk`` tokens per staged row) of this
        iteration's budget; False once the iteration's prefill
        allowance is exhausted."""
        if self._left < self.chunk:
            return False
        self._left -= self.chunk
        return True

    def n_chunks(self, prompt_len: int) -> int:
        """Chunks a prompt of this length needs (last chunk padded)."""
        return -(-prompt_len // self.chunk)


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages a ``tokens``-position KV span occupies (ceil division) —
    the paged engine's reservation unit for admission sizing, submit
    validation, and the admission scorer's fit check."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    return -(-int(tokens) // int(page_size))


def page_fit_score(reuse_tokens: int, fresh_pages: int,
                   available_pages: int) -> int:
    """Admission-window score for a paged engine: candidates are
    ranked by the prefill work their cached prefix skips (exactly the
    dense scorer's currency), but a candidate whose FRESH page need
    cannot currently be met — free pages plus everything the prefix
    LRU could reclaim — scores strictly below every admittable one
    (negative, by its shortfall), so the bounded bypass never elects a
    request the allocator would immediately bounce back to the queue
    head while an admittable neighbor waits behind it."""
    if fresh_pages > available_pages:
        return available_pages - fresh_pages
    return int(reuse_tokens)


class SpeculationPolicy:
    """Speculative-decoding config for the engine's fused decode loop:
    per round the DRAFT model proposes ``gamma`` tokens for every live
    slot in one ``lax.scan`` dispatch and the TARGET scores all of
    them in one ragged ``verify_chunk`` forward — each row then
    accepts a variable-length extension (1..gamma+1 tokens: the
    matched proposal prefix plus the target's correction/bonus token).

    Compiled-shape contract: every speculative program's shape depends
    only on ``(max_slots, gamma)`` — the verify chunk is always
    ``gamma + 1`` wide and the propose scan always ``gamma`` long, so
    acceptance raggedness is a HOST-side slice, never a recompile.

    ``kv_headroom`` is the extra KV positions every pool row must
    carry beyond the serving window: a verify round starting at the
    window's last decodable position still writes ``gamma`` scratch
    positions of (possibly rejected) proposal KV past it. Rejected
    scratch is overwritten by the next round before any query can
    attend it (the same position-mask argument as slot reuse)."""

    def __init__(self, gamma: int = 4):
        if gamma < 1:
            raise ValueError(
                f"spec_gamma must be >= 1 (one proposed token), "
                f"got {gamma}")
        self.gamma = gamma

    @property
    def verify_len(self) -> int:
        """Width of the ragged verify chunk: the pending token whose
        KV the round writes first, plus the ``gamma`` proposals."""
        return self.gamma + 1

    @property
    def kv_headroom(self) -> int:
        """Extra cache positions each KV row needs for the scratch
        writes of a verify round launched at the window edge."""
        return self.gamma
