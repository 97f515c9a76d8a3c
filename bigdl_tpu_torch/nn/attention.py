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
``init_cache(kv_dtype="int8")`` gives the quantized form ``(k_q, v_q,
k_scale, v_scale)``: int8 codes of the float shape and f32 scales of
shape (..., T, 1), one per (row, head, position). Every entry point
quantizes the block it writes (:func:`quantize_kv`) and attends the
dequantized STORED rows, cast to the block's dtype, so a cold pass and a
later read of the same rows see the same numbers.

``dropout > 0`` adds the JAX package's dropout layers to the
full-sequence ``forward`` (after the attention's output projection and
after the block's MLP); the KV-cache entry points never drop.

Paged KV (``*_paged``): a layer's KV lives in a page pool of
(max_pages, H_kv, page_size, D) tensors, and a (B, table_len) block
table names each row's pages; every paged step scatters its new K/V
through the table in place and attends the gathered row view under the
same position mask as the dense ragged paths; the int8 pool's scales
share their codes' page and offset. Sequence parallelism (ring
attention) and MoE are not ported yet.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.quantized import exact_div
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


def quantize_kv(x):
    """Symmetric int8 per (row, head, position) of a KV block ``x``
    (..., T, D): scale = max|x| over D / 127 (1/127 where the slice is
    all zero, so zeros come back as zeros), q = round(x / scale), half
    to even, clipped to [-127, 127]. Returns ``(q int8, scale f32)``
    with scale (..., T, 1). Deterministic: the same floats give the same
    bytes, which keeps prefix reuse and a spill to host exact."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = exact_div(torch.where(amax > 0, amax, 1.0), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: codes times their scales in f32,
    cast to ``dtype``."""
    return (q.float() * scale).to(dtype)


def _write_kv(cache, k_t, v_t, write):
    """Write one K/V block into ``cache`` IN PLACE through ``write(buf,
    block)`` and return ``(k_read, v_read)``, what attention attends: the
    float 2-tuple form writes the block in the cache's dtype and reads
    the buffers; the int8 4-tuple ``(k_q, v_q, k_scale, v_scale)``
    quantizes the block, writes codes and scales through the same index
    math, and reads the dequantized buffers in the block's dtype."""
    if len(cache) == 2:
        k_cache, v_cache = cache
        write(k_cache, k_t.to(k_cache.dtype))
        write(v_cache, v_t.to(v_cache.dtype))
        return k_cache, v_cache
    k_q, v_q, k_s, v_s = cache
    kq, ks = quantize_kv(k_t)
    vq, vs = quantize_kv(v_t)
    for buf, blk in ((k_q, kq), (v_q, vq), (k_s, ks), (v_s, vs)):
        write(buf, blk)
    return (dequantize_kv(k_q, k_s, k_t.dtype),
            dequantize_kv(v_q, v_s, v_t.dtype))


def _gather_pages(leaf, tables):
    """One logical KV row per batch entry from a page-pool tensor:
    ``leaf`` (max_pages, H, page_size, D), ``tables`` (B, table_len)
    page ids; position ``i`` of row ``b`` lives at ``leaf[tables[b, i //
    page_size], :, i % page_size]``. Returns the (B, H, table_len *
    page_size, D) view the attention math consumes. Table slots past a
    row's reservation name the scratch page: garbage the caller's
    position mask discards."""
    b, tlen = tables.shape
    g = leaf[tables]                            # (B, table_len, H, ps, D)
    _, _, h, ps, d = g.shape
    return g.transpose(1, 2).reshape(b, h, tlen * ps, d)


def _write_kv_paged(pool, k_t, v_t, tables, positions):
    """Scatter one K/V block into the page-pool tensors IN PLACE through
    per-row block tables, then gather the per-row views attention
    attends over. ``k_t`` / ``v_t`` are (B, H_kv, T, D); ``positions``
    is (B,) (one decode token per row) or (B, T) (a ragged chunk):
    token ``t`` of row ``b`` lands on page ``tables[b, positions[b, t] //
    page_size]`` at offset ``positions[b, t] % page_size``. Every
    ``positions // page_size`` must index the table (CUDA asserts on an
    out-of-range index where JAX clamps). Idle lanes carry all-scratch
    tables and may collide on page 0, and so may padded chunk tails past
    a reservation and one lane's positions wrapping onto the page. On
    CUDA the order of duplicate writes is undefined: a chunk (T > 1)
    therefore gives every duplicate the value of its LAST writer in
    (row, position) order, the CPU's sequential result, so what an idle
    lane reads back is the same on every device and run. Nothing
    gathered from the scratch page survives a live row's position mask,
    but an idle lane's output enters the batch's int8 activation scale
    under int8 weights. A decode step (T == 1) needs no such care: its
    only colliding writers are idle lanes, which write identical
    values. The int8 pool
    ``(k_q, v_q, k_scale, v_scale)`` writes codes and scales through
    the same (page, offset) and reads the dequantized gathered view.
    Returns ``(pool, k_read, v_read)``."""
    if positions.dim() == 1:
        positions = positions[:, None]          # decode step: T == 1
    ps = pool[0].shape[2]
    pg = torch.gather(tables, 1, positions // ps)           # (B, T)
    off = positions % ps
    src = None
    if positions.shape[1] > 1:
        flat = (pg * ps + off).reshape(-1)
        order = torch.arange(flat.numel(), device=flat.device)
        last = torch.full((pool[0].shape[0] * ps,), -1, dtype=order.dtype,
                          device=flat.device)
        src = last.scatter_reduce_(0, flat, order, "amax")[flat]

    def write(buf, blk):
        # advanced indices at dims 0 and 2 put (B, T) in front: the
        # value layout is (B, T, H, D)
        vals = blk.transpose(1, 2)
        if src is not None:
            vals = vals.reshape(-1, *vals.shape[2:])[src].reshape(
                vals.shape)
        buf[pg, :, off] = vals.to(buf.dtype)

    if len(pool) == 2:
        k_buf, v_buf = pool
        write(k_buf, k_t)
        write(v_buf, v_t)
        return (pool, _gather_pages(k_buf, tables),
                _gather_pages(v_buf, tables))
    k_q, v_q, k_s, v_s = pool
    kq, ks = quantize_kv(k_t)
    vq, vs = quantize_kv(v_t)
    for buf, blk in ((k_q, kq), (v_q, vq), (k_s, ks), (v_s, vs)):
        write(buf, blk)
    return (pool,
            dequantize_kv(_gather_pages(k_q, tables),
                          _gather_pages(k_s, tables), k_t.dtype),
            dequantize_kv(_gather_pages(v_q, tables),
                          _gather_pages(v_s, tables), v_t.dtype))


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

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   kv_dtype: Optional[str] = None):
        """Zero KV cache (k, v), each (B, H_kv, max_len, D), in ``dtype``
        on this layer's device. ``kv_dtype="int8"`` gives the quantized
        form ``(k_q, v_q, k_scale, v_scale)``: int8 codes of that shape
        and f32 scales (B, H_kv, max_len, 1)."""
        dev = next(itertools.chain(self.parameters(), self.buffers())).device
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        if kv_dtype is None:
            return (torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, device=dev))
        if str(kv_dtype) != "int8":
            raise ValueError(
                f"kv_dtype must be None (full precision) or 'int8', "
                f"got {kv_dtype!r}")
        sshape = shape[:-1] + (1,)
        return (torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(sshape, dtype=torch.float32, device=dev),
                torch.zeros(sshape, dtype=torch.float32, device=dev))

    def _grouped_attention(self, q, k_cache, v_cache, live):
        """q (B, H, T, D) against the un-expanded (read) cache under the
        (B, T, L) or (T, L) mask ``live``; scores in f32, weights cast to
        the cache dtype. Returns (B, T, C)."""
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
        ar = torch.arange(cache[0].shape[2], device=x_t.device)
        if _is_ragged(pos):
            if self.rotary:
                q = rotary_embedding_rowwise(q, pos, self.rotary_base)
                k_t = rotary_embedding_rowwise(k_t, pos, self.rotary_base)
            rows = torch.arange(b, device=x_t.device)

            def write(buf, blk):
                buf[rows, :, pos] = blk[:, :, 0]

            live = (ar[None] <= pos[:, None])[:, None]          # (B, 1, L)
        else:
            pos = int(pos)
            positions = torch.tensor([pos], device=x_t.device)
            q, k_t = self._rope(q, positions), self._rope(k_t, positions)

            def write(buf, blk):
                buf[:, :, pos:pos + 1] = blk

            live = (ar <= pos)[None]                            # (1, L)
        k_read, v_read = _write_kv(cache, k_t, v_t, write)
        o = self._grouped_attention(q, k_read, v_read, live).to(x_t.dtype)
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
        if pos0 + t > cache[0].shape[2]:
            raise ValueError(
                f"prefill of {t} tokens at pos0={pos0} overflows the "
                f"{cache[0].shape[2]}-long KV cache")

        def write(buf, blk):
            buf[:, :, pos0:pos0 + t] = blk

        k_read, v_read = _write_kv(cache, k, v, write)
        if pos0 or len(cache) == 4:
            # the causal mask's offset tk - tq = pos0 lets query i see
            # exactly keys [0, pos0 + i]. An int8 cache takes this branch
            # at pos0 == 0 too: attending the stored rows keeps the cold
            # pass equal to every later read of them
            k = k_read[:, :, :pos0 + t].to(q.dtype)
            v = v_read[:, :, :pos0 + t].to(q.dtype)
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
        ar_t = torch.arange(t, device=x.device)
        if _is_ragged(pos0):
            positions = pos0[:, None] + ar_t[None]                # (B, T)
            if self.rotary:
                q = rotary_embedding_rowwise(q, positions, self.rotary_base)
                k = rotary_embedding_rowwise(k, positions, self.rotary_base)
            rows = torch.arange(b, device=x.device)[:, None]

            def write(buf, blk):
                # advanced indices at dims 0 and 2 put (B, T) in front
                buf[rows, :, positions] = blk.transpose(1, 2)
        else:
            pos0 = int(pos0)
            positions = pos0 + ar_t                               # (T,)
            q, k = self._rope(q, positions), self._rope(k, positions)

            def write(buf, blk):
                buf[:, :, pos0:pos0 + t] = blk
        k_read, v_read = _write_kv(cache, k, v, write)
        ar = torch.arange(k_read.shape[2], device=x.device)
        live = ar <= positions[..., None]               # (B, T, L) / (T, L)
        o = self._grouped_attention(q, k_read, v_read, live)
        o = self.out_proj(o.reshape(b * t, self.embed_dim).to(x.dtype))
        return o.reshape(b, t, -1), cache

    def init_page_pool(self, max_pages: int, page_size: int,
                       dtype=torch.float32, kv_dtype: Optional[str] = None):
        """Zero page-pool tensors for paged serving: the ``init_cache``
        forms with the leading dim indexing pages, (max_pages, H_kv,
        page_size, D) each (and the int8 form's scales)."""
        return self.init_cache(max_pages, page_size, dtype, kv_dtype)

    @torch.no_grad()
    def forward_step_paged(self, x_t, pool, tables, pos):
        """One ragged decode step against a page pool: the math of
        :meth:`forward_step` with a (B,) ``pos``, but each row's KV row
        is the concatenation of the pages its ``tables`` row names; the
        write scatters and the read gathers through ``tables``. Rows on
        all-scratch tables are idle lanes whose output the caller
        ignores."""
        b = x_t.shape[0]
        qkv = self.qkv(x_t.reshape(b, self.embed_dim)).reshape(b, 1, -1)
        q, k_t, v_t = self._split_kv_step(qkv)      # q (B, H, 1, D)
        if self.rotary:
            q = rotary_embedding_rowwise(q, pos, self.rotary_base)
            k_t = rotary_embedding_rowwise(k_t, pos, self.rotary_base)
        pool, k_read, v_read = _write_kv_paged(pool, k_t, v_t, tables, pos)
        ar = torch.arange(k_read.shape[2], device=x_t.device)
        live = (ar[None] <= pos[:, None])[:, None]              # (B, 1, L)
        o = self._grouped_attention(q, k_read, v_read, live).to(x_t.dtype)
        return self.out_proj(o.reshape(b, self.embed_dim)).reshape(b, 1, -1), \
            pool

    @torch.no_grad()
    def forward_chunk_paged(self, x, pool, tables, pos0):
        """Ragged chunked prefill against a page pool (the paged twin of
        :meth:`forward_chunk` with a (B,) ``pos0``): each row's chunk
        scatters into its own pages and attends the gathered view under
        its own position mask. Caller contract: every written position
        ``pos0 + i`` falls inside the row's table, and positions past the
        row's reservation land on the scratch page."""
        b, t, _ = x.shape
        qkv = self.qkv(x.reshape(b * t, self.embed_dim)).reshape(b, t, -1)
        q, k, v = self._split_kv_step(qkv)
        positions = pos0[:, None] + torch.arange(t, device=x.device)[None]
        if self.rotary:
            q = rotary_embedding_rowwise(q, positions, self.rotary_base)
            k = rotary_embedding_rowwise(k, positions, self.rotary_base)
        pool, k_read, v_read = _write_kv_paged(pool, k, v, tables,
                                               positions)
        ar = torch.arange(k_read.shape[2], device=x.device)
        live = ar <= positions[..., None]                       # (B, T, L)
        o = self._grouped_attention(q, k_read, v_read, live)
        o = self.out_proj(o.reshape(b * t, self.embed_dim).to(x.dtype))
        return o.reshape(b, t, -1), pool

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
    """Pre-norm block: x + MHA(LN(x)); x + MLP(LN(x)), with a tanh-GELU
    MLP of ``mlp_ratio`` x embed; with ``dropout > 0`` the attention
    output and the MLP output are dropped in ``forward``. ``causal``
    masks the full-sequence ``forward`` only: the KV-cache paths are
    causal whatever it says, as in the JAX package."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 use_flash: bool = False,
                 num_kv_heads: Optional[int] = None, rotary: bool = False,
                 dropout: float = 0.0, *, causal: bool = True,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        rng = rng or RandomGenerator()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(embed_dim, **kw)
        self.attn = MultiHeadAttention(embed_dim, num_heads, causal=causal,
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

    def forward_step_paged(self, x_t, pool, tables, pos):
        h, pool = self.attn.forward_step_paged(self.ln1(x_t), pool, tables,
                                               pos)
        return self._mlp_residual(x_t + h), pool

    def forward_chunk_paged(self, x, pool, tables, pos0):
        h, pool = self.attn.forward_chunk_paged(self.ln1(x), pool, tables,
                                                pos0)
        return self._mlp_residual(x + h), pool
