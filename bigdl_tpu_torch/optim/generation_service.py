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

``stats()`` keeps plain counters; the metrics registry, flight recorder
and latency percentiles wait for the observability slice.
"""

from __future__ import annotations

import threading

import numpy as np

from bigdl_tpu_torch.models.transformer import _validate_sampling
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
                 max_len=None, seed: int = 0, submit_timeout_s=None):
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
        self._batchers = {}  # (tpad, bucket[, "tight", n]) -> _MicroBatcher
        self._counts = {"served": 0, "dispatches": 0, "tokens": 0}

    def _cap(self) -> int:
        return min(self.max_len or self.model.max_len, self.model.max_len)

    def _run_batch(self, stacked, bucket: int):
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
            toks = self.model.generate_ragged(
                prompts, lengths, n_req, eos_id=self.eos_id,
                max_len=pinned, **kw)
        return toks.cpu().numpy()

    def _count_batch(self, size: int):
        with self._lock:
            self._counts["served"] += size
            self._counts["dispatches"] += 1

    def _batcher(self, key) -> _MicroBatcher:
        with self._lock:
            b = self._batchers.get(key)
            if b is None:
                b = _MicroBatcher(
                    lambda stacked, bucket=key[1]: self._run_batch(stacked,
                                                                   bucket),
                    self.max_batch, self.batch_timeout_ms,
                    on_batch=self._count_batch,
                    submit_timeout_s=self.submit_timeout_s)
                self._batchers[key] = b
            return b

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
        gen = np.asarray(self._batcher(key).submit(row)[:n])
        with self._lock:
            self._counts["tokens"] += _delivered_tokens(gen, n, self.eos_id)
        return np.concatenate([prompt, gen.astype(np.int32)])

    def stats(self) -> dict:
        """Requests served, model dispatches, mean requests per dispatch
        and delivered tokens since construction."""
        with self._lock:
            c = dict(self._counts)
        c["mean_batch_occupancy"] = round(
            c["served"] / c["dispatches"], 3) if c["dispatches"] else 0.0
        return c
