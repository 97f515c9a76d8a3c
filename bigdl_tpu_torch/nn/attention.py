"""Attention / transformer layers (port of ``bigdl_tpu/nn/attention.py``).

Fused-QKV multi-head attention with grouped-query heads, RoPE and a KV
cache, the pre-norm transformer block, and the dense attention math they
share. ``use_flash=True`` sends the full-sequence forward through the
port's flash kernel (``ops/flash_attention.py``); the KV-cache entry
points use dense attention, as in the JAX package.

Kept from the JAX package, where PyTorch's habits differ:

- ``dot_product_attention`` takes its scores in f32, masks causally
  aligned to the LAST query (``tril(k=tk-tq)``), gives 0 for a row that
  sees no key, and casts the softmax weights to ``v.dtype`` before the
  PV product;
- RoPE rotates interleaved pairs ``x[..., ::2], x[..., 1::2]``;
- LayerNorm computes in f32, casts back, then applies the affine;
- the MLP's GELU is the tanh approximation (``jax.nn.gelu``'s default);
- the fused projection splits q | k | v with ``kv_dim = h_kv * d``.

The KV caches are ``(k, v)`` tuples of (B, H_kv, max_len, D) tensors,
updated IN PLACE (the JAX package returns new buffers); the cache entry
points still return the cache so callers read the same either way.

``dropout > 0`` adds the JAX package's dropout layers to the
full-sequence ``forward`` (after the attention's output projection and
after the block's MLP); the KV-cache entry points never drop. Sequence
parallelism (ring attention), MoE and the int8 and paged cache forms are
not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.random import RandomGenerator


class LayerNorm(Module):
    """Layer normalization over the last dim, with an affine."""

    def __init__(self, n_output: int, eps: float = 1e-5, *,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.n_output = n_output
        self.eps = eps
        self.new_param("weight", torch.ones(n_output), dev, dtype)
        self.new_param("bias", torch.zeros(n_output), dev, dtype)

    def forward(self, input):
        x = input.float()
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = ((x - mean) * torch.rsqrt(var + self.eps)).to(input.dtype)
        return y * self.weight + self.bias


def dot_product_attention(q, k, v, causal: bool = False,
                          scale: Optional[float] = None):
    """(B, H, T, D) attention; scores and softmax in f32."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if not causal:
        return torch.matmul(torch.softmax(scores, -1).to(v.dtype), v)
    tq, tk = scores.shape[-2], scores.shape[-1]
    cm = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
    scores = scores.masked_fill(~cm, -math.inf)
    # a row with every key masked (tq > tk) softmaxes to NaN: run it through
    # a uniform softmax and zero its weights after (the flash kernel emits 0
    # for such rows too)
    dead = ~cm.any(-1, keepdim=True)
    w = torch.softmax(scores.masked_fill(dead, 0.0), -1)
    return torch.matmul(w.masked_fill(dead, 0.0).to(v.dtype), v)


def _rotate(x, ang):
    """Rotate interleaved feature pairs of ``x`` by angles ``ang``
    (broadcast against ``x[..., ::2]``), in f32, back to x's dtype."""
    sin, cos = ang.sin(), ang.cos()
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _angles(positions, d: int, base: float):
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=positions.device) / d))
    return positions.float()[..., None] * inv       # (..., T, D/2)


def rotary_embedding(x, positions, base: float = 10000.0):
    """RoPE over x (..., T, D) at absolute ``positions`` (T,)."""
    return _rotate(x, _angles(positions, x.shape[-1], base))


def rotary_embedding_rowwise(x, positions, base: float = 10000.0):
    """RoPE at per-row positions: x (B, H, T, D), ``positions`` (B,) for
    one decode token per row or (B, T) for a ragged chunk."""
    if positions.dim() == 1:
        positions = positions[:, None]
    return _rotate(x, _angles(positions, x.shape[-1], base)[:, None])


def _is_ragged(pos) -> bool:
    return torch.is_tensor(pos) and pos.dim() == 1


class MultiHeadAttention(Module):
    """Fused-QKV multi-head self attention with grouped-query heads
    (``num_kv_heads``), optional RoPE (``rotary``), the flash kernel
    (``use_flash``) and dropout of the output (``dropout``) on the
    full-sequence forward."""

    def __init__(self, embed_dim: int, num_heads: int,
                 causal: bool = False, use_flash: bool = False,
                 num_kv_heads: Optional[int] = None,
                 rotary: bool = False, rotary_base: float = 10000.0,
                 dropout: float = 0.0, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not a multiple of "
                             f"num_heads {num_heads}")
        if rotary and (embed_dim // num_heads) % 2:
            raise ValueError(
                f"rotary embeddings need an even head_dim, got "
                f"{embed_dim // num_heads}: RoPE rotates feature pairs")
        rng = rng or RandomGenerator()
        self.rotary = rotary
        self.rotary_base = rotary_base
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")
        self.causal = causal
        self.use_flash = use_flash
        self.dropout_p = dropout
        kv_dim = self.num_kv_heads * self.head_dim
        self.qkv = Linear(embed_dim, embed_dim + 2 * kv_dim, rng=rng,
                          device=device, dtype=dtype)
        self.out_proj = Linear(embed_dim, embed_dim, rng=rng, device=device,
                               dtype=dtype)
        if dropout > 0:
            self.drop = Dropout(dropout)

    def _split_heads(self, x, n_heads):
        b, t, _ = x.shape
        return x.reshape(b, t, n_heads, self.head_dim).transpose(1, 2)

    def _split_kv_step(self, qkv):
        c, kv_dim = self.embed_dim, self.num_kv_heads * self.head_dim
        q = self._split_heads(qkv[..., :c], self.num_heads)
        k = self._split_heads(qkv[..., c:c + kv_dim], self.num_kv_heads)
        v = self._split_heads(qkv[..., c + kv_dim:], self.num_kv_heads)
        return q, k, v

    def _expand_kv(self, k, v):
        """Materialize shared kv heads for the dense paths."""
        rep = self.num_heads // self.num_kv_heads
        if rep == 1:
            return k, v
        return k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)

    def _rope(self, x, positions):
        return rotary_embedding(x, positions, self.rotary_base) \
            if self.rotary else x

    def init_cache(self, batch: int, max_len: int):
        """Zero KV cache (k, v), each (B, H_kv, max_len, D), on this
        layer's device in its parameters' dtype."""
        w = self.qkv.weight
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        return (torch.zeros(shape, dtype=w.dtype, device=w.device),
                torch.zeros(shape, dtype=w.dtype, device=w.device))

    def _grouped_attention(self, q, cache, live):
        """q (B, H, T, D) against the un-expanded cache under the
        (B, T, L) or (T, L) mask ``live``; scores in f32, weights cast to
        the cache dtype. Returns (B, T, C)."""
        k_cache, v_cache = cache
        b, _, t, d = q.shape
        h_kv = self.num_kv_heads
        qg = q.reshape(b, h_kv, self.num_heads // h_kv, t, d)
        s = torch.matmul(qg.float(),
                         k_cache.float()[:, :, None].transpose(-1, -2))
        s = s * (1.0 / math.sqrt(d))                # (B, G, R, T, L)
        live = live[:, None, None] if live.dim() == 3 else live
        s = s.masked_fill(~live, -math.inf)
        p = torch.softmax(s, -1).to(v_cache.dtype)
        o = torch.matmul(p, v_cache[:, :, None])    # (B, G, R, T, D)
        return o.permute(0, 3, 1, 2, 4).reshape(b, t, self.embed_dim)

    @torch.no_grad()
    def forward_step(self, x_t, cache, pos):
        """One decode step: x_t (B, 1, C) attends over the cache up to
        ``pos`` (an int, or a (B,) tensor of per-row positions for a
        ragged batch), after writing its own K/V there."""
        b = x_t.shape[0]
        qkv = self.qkv(x_t.reshape(b, self.embed_dim)).reshape(b, 1, -1)
        q, k_t, v_t = self._split_kv_step(qkv)      # q (B, H, 1, D)
        k_cache, v_cache = cache
        length = k_cache.shape[2]
        ar = torch.arange(length, device=x_t.device)
        if _is_ragged(pos):
            if self.rotary:
                q = rotary_embedding_rowwise(q, pos, self.rotary_base)
                k_t = rotary_embedding_rowwise(k_t, pos, self.rotary_base)
            rows = torch.arange(b, device=x_t.device)
            k_cache[rows, :, pos] = k_t[:, :, 0].to(k_cache.dtype)
            v_cache[rows, :, pos] = v_t[:, :, 0].to(v_cache.dtype)
            live = (ar[None] <= pos[:, None])[:, None]          # (B, 1, L)
        else:
            pos = int(pos)
            positions = torch.tensor([pos], device=x_t.device)
            q, k_t = self._rope(q, positions), self._rope(k_t, positions)
            k_cache[:, :, pos:pos + 1] = k_t.to(k_cache.dtype)
            v_cache[:, :, pos:pos + 1] = v_t.to(v_cache.dtype)
            live = (ar <= pos)[None]                            # (1, L)
        o = self._grouped_attention(q, cache, live).to(x_t.dtype)
        return self.out_proj(o.reshape(b, self.embed_dim)).reshape(b, 1, -1), \
            cache

    @torch.no_grad()
    def forward_prefill(self, x, cache, pos0: int = 0):
        """Batched prompt prefill: one causal pass over x (B, T0, C) that
        writes K/V into the cache at ``pos0`` (an int); with ``pos0 > 0``
        the block's queries also attend over the cached ``[0, pos0)``."""
        if not isinstance(pos0, int):
            raise TypeError("forward_prefill pos0 must be an int")
        b, t, _ = x.shape
        qkv = self.qkv(x.reshape(b * t, self.embed_dim)).reshape(b, t, -1)
        q, k, v = self._split_kv_step(qkv)
        if self.rotary:
            positions = pos0 + torch.arange(t, device=x.device)
            q, k = self._rope(q, positions), self._rope(k, positions)
        k_cache, v_cache = cache
        if pos0 + t > k_cache.shape[2]:
            raise ValueError(
                f"prefill of {t} tokens at pos0={pos0} overflows the "
                f"{k_cache.shape[2]}-long KV cache")
        k_cache[:, :, pos0:pos0 + t] = k.to(k_cache.dtype)
        v_cache[:, :, pos0:pos0 + t] = v.to(v_cache.dtype)
        if pos0:
            # the causal mask's offset tk - tq = pos0 lets query i see
            # exactly keys [0, pos0 + i]
            k = k_cache[:, :, :pos0 + t].to(q.dtype)
            v = v_cache[:, :, :pos0 + t].to(q.dtype)
        kx, vx = self._expand_kv(k, v)
        o = dot_product_attention(q, kx, vx, causal=True)
        o = o.transpose(1, 2).reshape(b * t, self.embed_dim)
        return self.out_proj(o).reshape(b, t, -1), cache

    @torch.no_grad()
    def forward_chunk(self, x, cache, pos0):
        """Chunked continuation prefill at offset ``pos0`` (an int, or a
        (B,) tensor of per-row offsets for a ragged batch): the chunk's
        queries attend over the whole cache under a position mask.
        Caller contract: ``pos0 + T_chunk <= cache length`` per row."""
        b, t, _ = x.shape
        qkv = self.qkv(x.reshape(b * t, self.embed_dim)).reshape(b, t, -1)
        q, k, v = self._split_kv_step(qkv)
        k_cache, v_cache = cache
        ar_t = torch.arange(t, device=x.device)
        if _is_ragged(pos0):
            positions = pos0[:, None] + ar_t[None]                # (B, T)
            if self.rotary:
                q = rotary_embedding_rowwise(q, positions, self.rotary_base)
                k = rotary_embedding_rowwise(k, positions, self.rotary_base)
            rows = torch.arange(b, device=x.device)[:, None]
            # advanced indices at dims 0 and 2 put (B, T) in front
            k_cache[rows, :, positions] = k.transpose(1, 2).to(k_cache.dtype)
            v_cache[rows, :, positions] = v.transpose(1, 2).to(v_cache.dtype)
        else:
            pos0 = int(pos0)
            positions = pos0 + ar_t                               # (T,)
            q, k = self._rope(q, positions), self._rope(k, positions)
            k_cache[:, :, pos0:pos0 + t] = k.to(k_cache.dtype)
            v_cache[:, :, pos0:pos0 + t] = v.to(v_cache.dtype)
        ar = torch.arange(k_cache.shape[2], device=x.device)
        live = ar <= positions[..., None]               # (B, T, L) / (T, L)
        o = self._grouped_attention(q, cache, live)
        o = self.out_proj(o.reshape(b * t, self.embed_dim).to(x.dtype))
        return o.reshape(b, t, -1), cache

    def forward(self, input):
        b, t, _ = input.shape
        qkv = self.qkv(input.reshape(b * t, self.embed_dim)).reshape(b, t, -1)
        q, k, v = self._split_kv_step(qkv)
        if self.rotary:
            positions = torch.arange(t, device=input.device)
            q, k = self._rope(q, positions), self._rope(k, positions)
        if self.use_flash:
            from bigdl_tpu_torch.ops.flash_attention import flash_attention

            o = flash_attention(q, k, v, causal=self.causal)
        else:
            k, v = self._expand_kv(k, v)
            o = dot_product_attention(q, k, v, causal=self.causal)
        o = o.transpose(1, 2).reshape(b * t, self.embed_dim)
        o = self.out_proj(o).reshape(b, t, -1)
        if self.dropout_p > 0:
            o = self.drop(o)
        return o


class TransformerBlock(Module):
    """Pre-norm causal block: x + MHA(LN(x)); x + MLP(LN(x)), with a
    tanh-GELU MLP of ``mlp_ratio`` x embed; with ``dropout > 0`` the
    attention output and the MLP output are dropped in ``forward``."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 use_flash: bool = False,
                 num_kv_heads: Optional[int] = None, rotary: bool = False,
                 dropout: float = 0.0, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        rng = rng or RandomGenerator()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(embed_dim, **kw)
        self.attn = MultiHeadAttention(embed_dim, num_heads, causal=True,
                                       num_kv_heads=num_kv_heads,
                                       rotary=rotary, use_flash=use_flash,
                                       dropout=dropout, rng=rng, **kw)
        self.ln2 = LayerNorm(embed_dim, **kw)
        self.fc1 = Linear(embed_dim, mlp_ratio * embed_dim, rng=rng, **kw)
        self.fc2 = Linear(mlp_ratio * embed_dim, embed_dim, rng=rng, **kw)
        self.dropout_p = dropout
        if dropout > 0:
            self.drop = Dropout(dropout)

    def _mlp(self, x):
        b, t, c = x.shape
        h = self.fc1(self.ln2(x).reshape(b * t, c))
        return self.fc2(F.gelu(h, approximate="tanh")).reshape(b, t, c)

    def _mlp_residual(self, x):
        return x + self._mlp(x)

    def forward(self, input):
        x = input + self.attn(self.ln1(input))
        h = self._mlp(x)
        if self.dropout_p > 0:
            h = self.drop(h)
        return x + h

    def forward_step(self, x_t, cache, pos):
        h, cache = self.attn.forward_step(self.ln1(x_t), cache, pos)
        return self._mlp_residual(x_t + h), cache

    def forward_prefill(self, x, cache, pos0: int = 0):
        h, cache = self.attn.forward_prefill(self.ln1(x), cache, pos0)
        return self._mlp_residual(x + h), cache

    def forward_chunk(self, x, cache, pos0):
        h, cache = self.attn.forward_chunk(self.ln1(x), cache, pos0)
        return self._mlp_residual(x + h), cache
