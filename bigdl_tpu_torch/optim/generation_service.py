"""Concurrent autoregressive LM serving (port of
``bigdl_tpu/optim/generation_service.py``).

Concurrent ``generate()`` requests micro-batch into one
``TransformerLM.generate_ragged`` call per (prompt bucket, decode bucket)
group:

- prompts right-pad up to a multiple of ``prompt_bucket`` (capped by the
  context); requests whose padded widths match share a batch even with
  different true lengths, each row decoding at its own depth;
- ``max_new_tokens`` rounds up to a multiple of ``bucket_tokens`` for the
  grouping key, and ``max_len`` is pinned per group;
- every row's tokens are those of ``model.generate`` on that request
  alone (greedy decoding is batch-, padding- and length-invariant per
  row).

``stats()`` keeps the service's own counters and the latency
percentiles of its recent requests. Telemetry lands in ``registry`` (the
process default unless given) under ``bdt_serve_*`` and
``bdt_generation_*{service=service_name}``; every request's
``request/submitted`` and terminal event, and its batch's
``batch/enqueue`` / ``batch/dispatch``, go to the flight recorder.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from bigdl_tpu_torch.models.transformer import _validate_sampling
from bigdl_tpu_torch.observability.events import (
    default_recorder, next_request_id, percentile_summary,
)
from bigdl_tpu_torch.observability.instruments import (
    generation_instruments, serving_instruments,
)
from bigdl_tpu_torch.optim.prediction_service import _MicroBatcher
from bigdl_tpu_torch.utils.random import RandomGenerator


def _delivered_tokens(gen_row, n: int, eos_id) -> int:
    """Tokens served out of a generated row: ``n``, or up to and
    including the first eos when ``eos_id`` stopped the row early."""
    if eos_id is None:
        return n
    hits = np.flatnonzero(np.asarray(gen_row[:n]) == eos_id)
    return int(hits[0]) + 1 if hits.size else n


class GenerationService:
    """Thread-safe generative serving over a ``TransformerLM``.

    ``generate(prompt_ids, max_new_tokens)`` blocks until its batch lands
    and returns the 1-D ``prompt + tokens`` row of this request. The
    sampling config (temperature/top_k/top_p/eos_id) is fixed per
    service; sampled batches draw from generators seeded by ``seed``."""

    def __init__(self, model, max_batch: int = 8,
                 batch_timeout_ms: float = 5.0, bucket_tokens: int = 32,
                 prompt_bucket: int = 32, eos_id=None,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 max_len=None, seed: int = 0, registry=None,
                 service_name: str = "generation", submit_timeout_s=None):
        if bucket_tokens < 1:
            raise ValueError(f"bucket_tokens must be >= 1, got "
                             f"{bucket_tokens}")
        if prompt_bucket < 1:
            raise ValueError(f"prompt_bucket must be >= 1, got "
                             f"{prompt_bucket}")
        _validate_sampling(temperature > 0.0, top_k, top_p)
        self.model = model
        self.max_batch = max_batch
        self.batch_timeout_ms = batch_timeout_ms
        self.bucket_tokens = bucket_tokens
        self.prompt_bucket = prompt_bucket
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        self.max_len = max_len
        self.submit_timeout_s = submit_timeout_s
        self._rng = RandomGenerator(seed)
        self._lock = threading.Lock()
        # one model call at a time: the card runs one batch at a time, and
        # the concurrency value lives in the batching
        self._dispatch = threading.Lock()
        self._counts = {"served": 0, "dispatches": 0, "tokens": 0}
        self.service_name = service_name
        self._ins = serving_instruments(service_name, registry)
        self._gen_ins = generation_instruments(service_name, registry)
        self._rec = default_recorder()
        #: recent per-request timelines: the stats() percentiles' source
        self._recent: collections.deque = collections.deque(maxlen=256)
        # one batcher for every (tpad, bucket[, "tight", n]) key: its drain
        # thread runs the batches in turn and hosts profiler captures
        self._batcher = _MicroBatcher(
            self._run_batch, max_batch, batch_timeout_ms,
            on_batch=self._count_batch, submit_timeout_s=submit_timeout_s,
            telemetry=self._ins, recorder=self._rec, name=service_name)
        # the batcher calls on_batch then run_batch on its drain thread:
        # the real request count reaches the tokens/sec gauge through it
        self._tl = threading.local()

    def _cap(self) -> int:
        return min(self.max_len or self.model.max_len, self.model.max_len)

    def _run_batch(self, stacked, key):
        bucket = key[1]
        # layout per row: [padded prompt | true length | n]
        prompts = stacked[:, :-2]
        lengths = stacked[:, -2]
        n_req = int(stacked[:, -1].max())
        pinned = min(self._cap(), prompts.shape[1] + bucket)
        kw = {}
        if self.temperature > 0.0:
            with self._lock:
                gen = self._rng.next_generator(self.model.device)
            kw = dict(temperature=self.temperature, top_k=self.top_k,
                      top_p=self.top_p, generator=gen)
        with self._dispatch:
            t0 = time.monotonic()
            toks = self.model.generate_ragged(
                prompts, lengths, n_req, eos_id=self.eos_id,
                max_len=pinned, **kw).cpu().numpy()
            dt = time.monotonic() - t0
            # the real rows come first in the stacked batch; a row that
            # eos stopped early delivers up to and including its eos
            real = getattr(self._tl, "real", stacked.shape[0])
            delivered = sum(_delivered_tokens(toks[i], int(stacked[i, -1]),
                                              self.eos_id)
                            for i in range(real))
            self._gen_ins.tokens_per_sec.set(delivered / max(dt, 1e-9))
        return toks

    def _count_batch(self, size: int):
        self._tl.real = size
        with self._lock:
            self._counts["served"] += size
            self._counts["dispatches"] += 1

    def generate(self, prompt_ids, max_new_tokens: int) -> np.ndarray:
        """One request: 1-D ``prompt_ids`` in, 1-D ``prompt + generated``
        out (exactly ``max_new_tokens`` tokens; with ``eos_id`` the tail
        after the first eos is eos padding)."""
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1:
            raise ValueError("GenerationService.generate takes ONE request "
                             f"(1-D prompt), got shape {prompt.shape}")
        t0 = prompt.shape[0]
        n = max_new_tokens
        if n < 1:
            raise ValueError("max_new_tokens must be >= 1")
        cap = self._cap()
        if t0 < 1 or t0 + n > cap:
            raise ValueError(f"prompt ({t0}) + max_new_tokens ({n}) "
                             f"exceeds the context length {cap}")
        tpad = min(-(-t0 // self.prompt_bucket) * self.prompt_bucket, cap)
        bucket = -(-n // self.bucket_tokens) * self.bucket_tokens
        # every batch of a key fits tpad + bucket; where that exceeds the
        # context (the tight region), mixed n could jointly overflow, so
        # tight requests group by their exact n
        key = (tpad, bucket) if tpad + bucket <= cap \
            else (tpad, bucket, "tight", n)
        row = np.zeros((tpad + 2,), np.int32)
        row[:t0] = prompt
        row[-2], row[-1] = t0, n
        self._ins.requests_total.inc()
        rid = next_request_id()
        t_sub = time.monotonic()
        self._rec.record("request/submitted", rid, service=self.service_name,
                         prompt_tokens=t0, max_new_tokens=n)
        detail: dict = {}
        try:
            with self._ins.inflight.track():
                toks = self._batcher.submit(row, request_id=rid,
                                            detail=detail, key=key)
        except Exception as e:
            # the batcher's telemetry counted the failure; the recorder
            # still needs a terminal event
            t_done = time.monotonic()
            self._rec.record("request/failed", rid,
                             service=self.service_name,
                             error=type(e).__name__)
            self._timeline(rid, "failed", t_sub, detail.get("t_launch"),
                           t_done, 0)
            raise
        t_done = time.monotonic()
        gen = np.asarray(toks[:n])
        delivered = _delivered_tokens(gen, n, self.eos_id)
        with self._lock:
            self._counts["tokens"] += delivered
        self._gen_ins.tokens_total.inc(delivered)
        self._rec.record("request/finished", rid, service=self.service_name,
                         tokens=delivered)
        self._timeline(rid, "finished", t_sub, detail.get("t_launch"),
                       t_done, delivered)
        return np.concatenate([prompt, gen.astype(np.int32)])

    def _timeline(self, rid, outcome, t_sub, t_launch, t_done, tokens):
        """One request's timeline: every token lands with its batch, so
        TTFT equals the total and the prefill is inside the dispatch."""
        done = outcome == "finished"
        tl = {"request_id": rid, "outcome": outcome,
              "queue_wait_s": (t_launch - t_sub)
              if t_launch is not None else None,
              "decode_s": (t_done - t_launch)
              if done and t_launch is not None else None,
              "ttft_s": t_done - t_sub if done else None,
              "total_s": t_done - t_sub, "tokens": tokens}
        with self._lock:
            self._recent.append(tl)

    def stats(self) -> dict:
        """Requests served, model dispatches, mean requests per dispatch
        and delivered tokens since construction, and ``latency``: the
        percentile summaries of queue wait, TTFT, decode and total over
        the recent finished requests."""
        with self._lock:
            c = dict(self._counts)
            tls = [t for t in self._recent if t["outcome"] == "finished"]
        c["mean_batch_occupancy"] = round(
            c["served"] / c["dispatches"], 3) if c["dispatches"] else 0.0
        c["latency"] = {
            phase: percentile_summary(t.get(phase + "_s") for t in tls)
            for phase in ("queue_wait", "ttft", "decode", "total")}
        return c
