"""Per-request handles for the continuous-batching engine (port of
``bigdl_tpu/serving/streams.py``, a copy: the JAX package's module is
framework-free, but importing it would import JAX).

A ``RequestHandle`` is the client's side of one generation request: a
streaming token iterator (``tokens()``), a blocking ``result()``, and
``cancel()``. The engine's loop thread is the only writer; clients only
read — all cross-thread state goes through a queue and events, so no
client ever touches the engine's slot pool.

Greedy output is token-identical to a lone ``model.generate`` call on
the same prompt (the engine's acceptance contract, tested); with an
``eos_id`` the stream ends at (and includes) the first eos instead of
carrying ``generate``'s eos padding tail.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from bigdl_tpu_torch.observability.events import next_request_id

#: admission priority classes, best-first. Rank (the tuple index) is
#: the primary ordering key in ``AdmissionQueue.pop_ready`` and the
#: shed/preemption order under overload: ``low`` is shed first and
#: preempted first, ``high`` is never shed.
PRIORITIES = ("high", "normal", "low")
PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


class RequestError(RuntimeError):
    """Base class for per-request terminal failures."""


class RequestCancelled(RequestError):
    """The request was cancelled via ``handle.cancel()``."""


class RequestTimedOut(RequestError):
    """The request's deadline passed while queued or mid-decode."""


class RequestShed(RequestError):
    """The request was shed at admission by burn-rate load shedding:
    the engine's TTFT SLO is burning error budget and this request's
    priority class is in the shed set. Carries ``retry_after_s`` — the
    client should back off at least that long (the front door maps it
    to HTTP 429 with a ``Retry-After`` header)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class RequestRateLimited(RequestError):
    """The request's tenant exhausted its device-second token bucket.
    ``retry_after_s`` is the bucket's refill time back to a positive
    balance — the honest ``Retry-After`` figure, not a guess."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class QueueFull(RuntimeError):
    """The bounded admission queue rejected the request (backpressure)."""


class EngineStopped(RuntimeError):
    """The engine stopped (or crashed) before the request completed."""


class EngineDraining(RuntimeError):
    """The engine is draining: new submissions are refused while the
    requests already in flight run to completion (``engine.drain()``;
    a fleet router treats this as "route elsewhere and retry")."""


#: terminal sentinel on the token stream
_DONE = object()


class RequestHandle:
    """One in-flight generation request.

    Client API: ``tokens()`` (streaming iterator over generated token
    ids, in generation order), ``result()`` (blocking: the full
    ``prompt + generated`` row), ``cancel()``, ``done()``,
    ``tokens_so_far()``. A terminal failure (timeout, cancellation,
    engine stop) raises from ``result()`` and from the iterator AFTER
    every already-delivered token has been yielded — partial output is
    never silently dropped.

    Every handle carries a process-unique ``request_id`` — the
    correlation key the flight recorder, the ``/debug/*`` endpoints,
    and the Chrome trace all share — and, once ``result()`` returns or
    the token iterator ends, ``timeline()`` reports the final
    per-phase breakdown (queue wait, prefill, TTFT, decode, total).

    Engine API (loop thread only): ``_deliver`` / ``_finish``.
    """

    def __init__(self, prompt, max_new_tokens: int,
                 timeout_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 priority: str = "normal"):
        if priority not in PRIORITY_RANK:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}")
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new_tokens = int(max_new_tokens)
        #: admission priority class (``high``/``normal``/``low``) —
        #: the queue's primary ordering key and the shed/preempt order
        self.priority = priority
        #: times this request was PREEMPTED (slot evicted with its KV
        #: donated to the prefix pool, then automatically requeued) —
        #: each resume re-prefills only the uncached tail, and the
        #: final output stays token-identical to an unpreempted run
        self.preempted: int = 0
        #: the request's correlation id (flight recorder events, the
        #: /debug endpoints, and Chrome traces all key on it)
        self.request_id = request_id or next_request_id()
        #: distributed-trace id (engine-stamped from
        #: ``submit(trace_id=...)``): the CROSS-process correlation
        #: key — the fleet front door mints it, every replica-side
        #: recorder event and usage record carries it, and the merged
        #: fleet trace joins the per-process arcs on it. None when
        #: the request never crossed a traced front door.
        self.trace_id: Optional[str] = None
        self.submitted_at = time.monotonic()
        self.deadline = (self.submitted_at + timeout_s
                         if timeout_s is not None else None)
        #: set by the engine when prefill starts (queue-wait boundary)
        self.admitted_at: Optional[float] = None
        #: prompt tokens served from the engine's prefix cache instead
        #: of being prefilled (0 on a miss or with the cache disabled);
        #: stamped at admission alongside the ``request/prefix_hit``
        #: flight-recorder event
        self.prefix_tokens: int = 0
        #: the tenant this request's usage is billed to — stamped by
        #: ``engine.submit(tenant=...)`` after cardinality-cap
        #: resolution (None outside an engine)
        self.tenant: Optional[str] = None
        #: the engine's UsageRecord for this request (engine-stamped;
        #: read through ``usage()``)
        self._usage = None
        #: speculative decoding tallies (engine-stamped per decode
        #: round; both stay 0 without a draft): draft tokens proposed
        #: for this request vs accepted by the target's verify — the
        #: per-request acceptance rate, surfaced in ``timeline()``.
        #: Multi-token acceptances reach the stream as in-order BURSTS
        #: (one ``request/decode_token`` recorder event per round,
        #: carrying ``accepted=``), so ``timeline()``'s ``decode_s /
        #: (tokens - 1)`` mean inter-token gap stays the true figure
        self.spec_proposed: int = 0
        self.spec_accepted: int = 0
        #: set by the engine when the first token lands (TTFT source)
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._tokens: list = []
        self._stream: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._finish_once = threading.Lock()
        self._cancelled = threading.Event()
        self._error: Optional[BaseException] = None

    # ---------------------------------------------------- engine side
    def _deliver(self, token: int, now: float) -> None:
        if self.first_token_at is None:
            self.first_token_at = now
        self._tokens.append(int(token))
        self._stream.put(int(token))

    def _finish(self, error: Optional[BaseException] = None) -> bool:
        """Mark terminal; returns True only for the ONE caller that
        actually performed the transition (the loop thread and a
        stopping submitter can race here — terminal bookkeeping keyed
        on the return value must happen exactly once)."""
        with self._finish_once:
            if self._done.is_set():
                return False
            self._error = error
            self.finished_at = time.monotonic()
            self._done.set()
        self._stream.put(_DONE)
        return True

    # ---------------------------------------------------- client side
    def cancel(self) -> None:
        """Ask the engine to drop this request. Queued requests are
        dropped before admission; running requests are evicted at the
        next loop iteration. ``result()`` then raises
        ``RequestCancelled`` (unless the request already finished)."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def done(self) -> bool:
        return self._done.is_set()

    def error(self) -> Optional[BaseException]:
        """The terminal failure, or None (while running / on success)."""
        return self._error

    def tokens_so_far(self) -> np.ndarray:
        """Generated tokens delivered so far (a snapshot — the useful
        partial output after a timeout or cancellation)."""
        return np.asarray(list(self._tokens), np.int32)

    def timeline(self) -> dict:
        """The request's per-phase wall-time breakdown (monotonic
        seconds; phases the request never reached are None):

        - ``queue_wait_s`` — submitted → admitted (prefill started)
        - ``prefill_s``    — admitted → first token
        - ``ttft_s``       — submitted → first token
        - ``decode_s``     — first token → finished
        - ``total_s``      — submitted → finished
        - ``tokens``       — tokens delivered
        - ``prefix_tokens`` — prompt tokens reused from the prefix
          cache (prefill skipped for them; 0 on a miss)
        - ``spec_proposed`` / ``spec_accepted`` — draft tokens
          proposed vs accepted for this request (0 without a draft);
          accepted extensions arrive as multi-token bursts, so
          ``decode_s / (tokens - 1)`` remains the honest mean
          inter-token gap either way
        - ``priority`` / ``preempted`` — the request's admission
          class and how many times it was preempted (slot evicted,
          KV donated, automatically resumed) — preemption cost is
          attributable per request in ``/debug/requests``

        Final once the request is ``done()`` (the engine stamps each
        boundary as the lifecycle advances), partial before that."""
        def gap(a, b):
            return (b - a) if (a is not None and b is not None) else None

        return {
            "queue_wait_s": gap(self.submitted_at, self.admitted_at),
            "prefill_s": gap(self.admitted_at, self.first_token_at),
            "ttft_s": gap(self.submitted_at, self.first_token_at),
            "decode_s": gap(self.first_token_at, self.finished_at),
            "total_s": gap(self.submitted_at, self.finished_at),
            "tokens": len(self._tokens),
            "prefix_tokens": self.prefix_tokens,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "priority": self.priority,
            "preempted": self.preempted,
        }

    def usage(self) -> Optional[dict]:
        """The request's metered resource consumption from the
        engine's usage ledger (``observability.accounting``): tenant,
        queue wait, prefilled vs prefix-reused prompt tokens (and KV
        bytes the reuse saved), delivered tokens, pro-rata
        device-seconds by dispatch kind, and KV byte-seconds held.
        Final once the request is ``done()`` (the ``outcome`` field is
        set); a live snapshot before that. None when the handle never
        entered an engine."""
        rec = self._usage
        return rec.to_dict() if rec is not None else None

    def tokens(self) -> Iterator[int]:
        """Stream generated token ids in order as the engine produces
        them; ends when the request finishes — at which point
        ``request_id`` / ``timeline()`` hold the final per-phase
        breakdown. A terminal failure raises AFTER the delivered
        prefix has been yielded. Single consumer."""
        while True:
            item = self._stream.get()
            if item is _DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request finishes; return the 1-D
        ``prompt + generated`` row (with ``eos_id`` configured on the
        engine, generation stops at — and includes — the first eos).
        On return, ``request_id`` and ``timeline()`` surface the
        request's identity and final phase breakdown. Raises the
        terminal error on timeout/cancellation/engine-stop, or
        ``TimeoutError`` if ``timeout`` expires first."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request not finished after {timeout}s (still "
                f"{'cancelled' if self.cancelled else 'in flight'})")
        if self._error is not None:
            raise self._error
        return np.concatenate(
            [self.prompt, np.asarray(self._tokens, np.int32)])

    def __repr__(self):
        state = ("done" if self._done.is_set() else
                 "cancelled" if self.cancelled else "pending")
        return (f"RequestHandle({self.request_id}, "
                f"prompt={self.prompt.shape[0]} toks, "
                f"n={self.max_new_tokens}, {state}, "
                f"delivered={len(self._tokens)})")
