"""Transformer language model (port of ``bigdl_tpu/models/transformer.py``).

Decoder-only, causal, pre-norm, tanh-GELU MLP, learned positions or
RoPE, tied output head (logits = x @ tok_embed.T; the JAX package's
untied head and non-causal option are not ported yet). The inference
entry points of the JAX package are ported: the full-sequence
``forward`` (through the flash kernel with ``use_flash=True``),
``prefill`` / ``prefill_chunk`` / ``decode_step`` over a KV cache,
greedy or sampled ``generate`` and ``generate_ragged``. The JAX
package's one-dispatch ``lax.scan`` decode becomes a Python loop over
``decode_step``; eager PyTorch compiles nothing, so the JAX package's
shape buckets (``bucket_tokens``) have no counterpart here. With
``eos_id``, finished rows keep emitting eos and the loop stops once
every row has finished.

Sampling draws from an explicit ``torch.Generator`` on the model's
device (``None``: PyTorch's default generator). It never reproduces the
JAX package's draws: only greedy decoding is comparable token for token.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn import init as bt_init
from bigdl_tpu_torch.nn.attention import LayerNorm, TransformerBlock
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.random import RandomGenerator


def _filter_logits(logits, temperature, top_k, top_p):
    """Tempered f32 logits with top-k then nucleus (top-p) filtering;
    disallowed tokens get -inf."""
    x = logits.float() / temperature
    v = x.shape[-1]
    if top_k is not None and top_k < v:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = x.masked_fill(x < kth, -float("inf"))
    if top_p is not None and top_p < 1.0:
        probs = torch.softmax(x, -1)
        order = torch.argsort(-probs, dim=-1, stable=True)     # descending
        sp = torch.gather(probs, -1, order)
        cum = torch.cumsum(sp, -1)
        # the smallest prefix whose mass reaches top_p; the top token is
        # always kept so no top_p can mask the whole vocabulary
        keep_sorted = cum - sp < top_p
        keep_sorted[..., 0] = True
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        x = x.masked_fill(~keep, -float("inf"))
    return x


def _validate_sampling(sampled: bool, top_k, top_p):
    if not sampled and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p filter the SAMPLED distribution; pass "
            "temperature > 0 (greedy decoding would silently ignore them)")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _sample_next(logits, generator, done, sampled, temperature, eos_id,
                 top_k, top_p):
    """One sampling decision; rows already ``done`` keep emitting
    ``eos_id``."""
    if sampled:
        probs = torch.softmax(
            _filter_logits(logits, temperature, top_k, top_p), -1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = logits.argmax(-1)
    if eos_id is not None:
        nxt = torch.where(done, eos_id, nxt)
        done = done | (nxt == eos_id)
    return nxt, done


class TransformerLM(Module):
    """Decoder-only LM. Input: (batch, time) token ids (0-based). Output:
    (batch, time, vocab) logits. Weights are drawn from ``seed`` (the
    JAX package's init methods over a ``torch.Generator``) and live on
    ``device`` in ``dtype``."""

    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 num_heads: int = 8, num_layers: int = 4,
                 max_len: int = 1024, mlp_ratio: int = 4,
                 use_flash: bool = False,
                 num_kv_heads: Optional[int] = None,
                 use_rope: bool = False, *, seed: int = 1,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        rng = RandomGenerator(seed)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.use_rope = use_rope
        self.max_len = max_len
        self.num_layers = num_layers
        normal = bt_init.RandomNormal(0.0, 0.02)
        self.new_param("tok_embed", normal((vocab_size, embed_dim), rng),
                       dev, dtype)
        if not use_rope:
            self.new_param("pos_embed", normal((max_len, embed_dim), rng),
                           dev, dtype)
        for i in range(num_layers):
            setattr(self, f"block{i}", TransformerBlock(
                embed_dim, num_heads, mlp_ratio=mlp_ratio, use_flash=use_flash,
                num_kv_heads=num_kv_heads, rotary=use_rope, rng=rng,
                device=dev, dtype=dtype))
        self.ln_f = LayerNorm(embed_dim, device=dev, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def _ids(self, ids):
        """Token ids as a long tensor on the model's device."""
        if torch.is_tensor(ids):
            return ids.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _head(self, x):
        return F.linear(x, self.tok_embed)     # tied: x @ tok_embed.T

    def forward(self, input):
        ids = self._ids(input)
        t = ids.shape[1]
        x = F.embedding(ids, self.tok_embed)
        if not self.use_rope:  # RoPE rotates inside each attention layer
            x = x + self.pos_embed[:t][None]
        for blk in self.blocks():
            x = blk(x)
        return self._head(self.ln_f(x))

    # ------------------------------------------------- KV-cache decoding
    def init_cache(self, batch: int, max_len: int):
        """Per-block (k, v) caches, each (B, H_kv, max_len, D), in the
        parameters' dtype (bf16 serving -> bf16 KV cache)."""
        return [blk.attn.init_cache(batch, max_len) for blk in self.blocks()]

    def prefill(self, ids, caches, pos0: int = 0):
        """One causal pass over ids (B, T0) writing every block's cache at
        ``pos0``; returns the last position's logits (B, V) and the
        caches."""
        return self._prefill_impl(ids, caches, pos0, chunked=False)

    def prefill_chunk(self, ids, caches, pos0):
        """One chunk of a chunked prefill at offset ``pos0`` (an int or a
        (B,) tensor). Caller contract: ``pos0 + chunk <= cache length``."""
        return self._prefill_impl(ids, caches, pos0, chunked=True)

    @torch.no_grad()
    def _prefill_impl(self, ids, caches, pos0, chunked: bool,
                      gather_last=None):
        """``gather_last`` (B,) picks one hidden state per row before the
        head: the ragged prefill's last valid position."""
        ids = self._ids(ids)
        b, t = ids.shape
        x = F.embedding(ids, self.tok_embed)
        if not self.use_rope:
            ar = torch.arange(t, device=self.device)
            if torch.is_tensor(pos0) and pos0.dim() == 1:
                x = x + self.pos_embed[pos0[:, None] + ar[None]]
            else:
                x = x + self.pos_embed[int(pos0) + ar][None]
        for i, blk in enumerate(self.blocks()):
            x, caches[i] = (blk.forward_chunk(x, caches[i], pos0) if chunked
                            else blk.forward_prefill(x, caches[i], pos0))
        if gather_last is not None:
            x = x[torch.arange(b, device=self.device), gather_last][:, None]
        else:
            x = x[:, -1:]
        return self._head(self.ln_f(x))[:, 0], caches

    @torch.no_grad()
    def decode_step(self, ids_t, pos, caches):
        """One token per row in, next-token logits (B, V) out. ``pos`` is
        an int, or a (B,) tensor of per-row positions (ragged batch)."""
        ids_t = self._ids(ids_t)
        x = F.embedding(ids_t, self.tok_embed)[:, None, :]      # (B, 1, C)
        if not self.use_rope:
            if torch.is_tensor(pos) and pos.dim() == 1:
                x = x + self.pos_embed[pos][:, None]
            else:
                x = x + self.pos_embed[int(pos)][None, None]
        for i, blk in enumerate(self.blocks()):
            x, caches[i] = blk.forward_step(x, caches[i], pos)
        return self._head(self.ln_f(x))[:, 0], caches

    def _decode_loop(self, logits, pos0, caches, n: int, sampled: bool,
                     temperature: float, generator, eos_id, top_k, top_p,
                     on_token: Optional[Callable] = None,
                     return_logits: bool = False):
        """n tokens from the prefill ``logits``: sample, then step at
        ``pos0 + i``. Returns ((B, n) tokens, (B, n, V) f32 logits each
        token was chosen from, or None)."""
        b = logits.shape[0]
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        toks, seen = [], []
        for i in range(n):
            if return_logits:
                seen.append(logits.float())
            nxt, done = _sample_next(logits, generator, done, sampled,
                                     temperature, eos_id, top_k, top_p)
            toks.append(nxt)
            if on_token is not None:
                on_token(nxt)
            if eos_id is not None and bool(done.all()):
                # every row finished: the rest is eos padding
                toks.extend([torch.full_like(nxt, eos_id)] * (n - 1 - i))
                if return_logits:
                    seen.extend([torch.zeros_like(seen[-1])] * (n - 1 - i))
                break
            if i < n - 1:
                logits, caches = self.decode_step(nxt, pos0 + i, caches)
        out = torch.stack(toks, 1)
        return out, (torch.stack(seen, 1) if return_logits else None)

    def _decode_setup(self, prompt_ids, max_new_tokens, max_len,
                      prefill_chunk=None):
        """Validate the prompt, allocate the caches in the parameters'
        dtype and run the prefill (in ``prefill_chunk``-long chunks after
        a leading remainder, when given). Returns (prompt, logits,
        caches); logits and caches are None for ``max_new_tokens == 0``."""
        prompt = self._ids(prompt_ids)
        if prompt.dim() == 1:
            prompt = prompt[None]
        b, t0 = prompt.shape
        total = t0 + max_new_tokens
        max_len = max_len or total
        if total > max_len:
            raise ValueError(
                f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len {max_len}")
        if max_len > self.max_len:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"context length {self.max_len}")
        if max_new_tokens == 0:
            return prompt, None, None
        caches = self.init_cache(b, max_len)
        if prefill_chunk and t0 > prefill_chunk:
            rem = t0 % prefill_chunk
            pos = 0
            if rem:  # leading remainder: one-shot prefill at offset 0
                logits, caches = self.prefill(prompt[:, :rem], caches)
                pos = rem
            while pos < t0:
                logits, caches = self.prefill_chunk(
                    prompt[:, pos:pos + prefill_chunk], caches, pos)
                pos += prefill_chunk
        else:
            logits, caches = self.prefill(prompt, caches)
        return prompt, logits, caches

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 max_len=None, prefill_chunk=None, eos_id=None,
                 top_k=None, top_p=None, on_token=None,
                 return_logits: bool = False):
        """Autoregressive generation with a KV cache: a batched prefill
        over the prompt, then one ``decode_step`` per new token. Greedy
        for ``temperature == 0``, else sampled from the tempered softmax
        filtered by ``top_k`` / ``top_p``. Returns (B, len(prompt) +
        max_new_tokens) ids; with ``return_logits=True`` also the
        (B, max_new_tokens, V) f32 logits each token was chosen from.
        ``on_token(step_tokens)`` fires with each step's (B,) tokens."""
        sampled = temperature > 0.0
        _validate_sampling(sampled, top_k, top_p)
        prompt, logits, caches = self._decode_setup(
            prompt_ids, max_new_tokens, max_len, prefill_chunk)
        if max_new_tokens == 0:
            return (prompt, None) if return_logits else prompt
        toks, seen = self._decode_loop(
            logits, prompt.shape[1], caches, max_new_tokens, sampled,
            temperature if sampled else 1.0, generator, eos_id, top_k,
            top_p, on_token, return_logits)
        ids = torch.cat([prompt, toks], 1)
        return (ids, seen) if return_logits else ids

    @torch.no_grad()
    def generate_ragged(self, prompt_ids, prompt_lengths,
                        max_new_tokens: int, temperature: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        eos_id=None, top_k=None, top_p=None, max_len=None):
        """Mixed prompt lengths in one batch: ``prompt_ids`` (B, Tmax)
        right-padded, ``prompt_lengths`` (B,). Returns (B, max_new_tokens)
        generated tokens; row i continues its own length-``t0_i`` prompt
        exactly as ``generate`` would on that row alone. Pads sit after
        every valid query, so the causal prefill never attends them, and
        each row's first decode step overwrites its first pad's KV."""
        sampled = temperature > 0.0
        _validate_sampling(sampled, top_k, top_p)
        prompt = self._ids(prompt_ids)
        lengths = self._ids(prompt_lengths)
        if prompt.dim() != 2 or lengths.shape != prompt.shape[:1]:
            raise ValueError(
                f"generate_ragged takes (B, Tmax) padded prompts + (B,) "
                f"lengths, got {tuple(prompt.shape)} / "
                f"{tuple(lengths.shape)}")
        b, tmax = prompt.shape
        n = max_new_tokens
        if n < 1:
            raise ValueError("max_new_tokens must be >= 1")
        lmax, lmin = int(lengths.max()), int(lengths.min())
        if lmin < 1 or lmax > tmax:
            raise ValueError(f"prompt_lengths must be in [1, {tmax}], "
                             f"got [{lmin}, {lmax}]")
        window = min(self.max_len, max_len) if max_len else self.max_len
        if lmax + n > window or tmax > window:
            raise ValueError(
                f"longest prompt ({lmax}) + max_new_tokens ({n}) or the "
                f"padded width ({tmax}) exceeds the context length "
                f"{window}")
        caches = self.init_cache(b, window if max_len
                                 else min(window, tmax + n))
        logits, caches = self._prefill_impl(prompt, caches, 0, chunked=False,
                                            gather_last=lengths - 1)
        toks, _ = self._decode_loop(
            logits, lengths, caches, n, sampled,
            temperature if sampled else 1.0, generator, eos_id, top_k, top_p)
        return toks
