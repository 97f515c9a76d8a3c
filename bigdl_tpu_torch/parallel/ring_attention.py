"""Sequence parallelism: ring attention and Ulysses all-to-all (port of
``bigdl_tpu/parallel/ring_attention.py``).

Each rank of ``group`` (a process group, or an axis name of
``Engine.default_mesh()``) holds one contiguous block of the sequence,
q / k / v (B, H, T/n, D), rank r the block at positions [r T/n,
(r + 1) T/n). The ring rotates K/V n - 1 times by
``collectives.ppermute`` (its backward sends the cotangents the other
way, JAX's transpose of ``lax.ppermute``) and merges each block's
attention into running statistics in f32, so the result equals softmax
attention over the whole sequence, forward and backward:

- the dense ring (:func:`_ring_dense`) scores each held block with
  einsums under the causal mask of global positions and keeps (max,
  denominator) statistics, with JAX's guards for rows a block masks
  wholly; K/V are expanded over a GQA group first;
- the flash ring (:func:`_ring_flash`, ``use_flash=True``) attends each
  held block through ``flash_attention_with_lse``, the port's flash
  kernel on CUDA tensors (its plain version on CPU tensors), and merges
  in logsumexp space with JAX's dead-row guards. Relative to this rank's
  block a block in the past is attended without a mask (one non-causal
  launch), the diagonal block causally (one causal launch), and a
  future block not at all (no launch): rank r of a causal ring launches
  r + 1 times, a non-causal ring n times. The lse output carries its
  cotangent into the kernel's backward. GQA K/V rotate un-expanded, and
  the kernel reads a shared head in place. Unlike the JAX wrapper (which
  takes the dense ring when T/n does not tile its kernel blocks), every
  length goes through the kernel, which guards its ragged tails.

K and V rotate together, stacked in one tensor, so every rank runs the
same single chain of point-to-point exchanges in its backward (two
chains could be drained in different orders on different ranks, and
point-to-point messages are matched by order). Every exchange's backward
must run on every rank, as JAX's transpose of its ``lax.switch`` runs
each ``ppermute``'s: a causal rank that skips the blocks it received
last ties the final block to its output with a zero cotangent
(:class:`_Keep`), so its backward still takes part in each exchange.

:func:`ulysses_attention` swaps the sequence shard for a head shard with
``collectives.all_to_all`` (differentiable: its transpose swaps back),
attends the whole sequence over H/n heads, and swaps back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.parallel import collectives as C


def _block_attend(q, k, v, scale, mask):
    """One block's unnormalized attention: (o f32, row sum, row max with
    masked rows at 0, row valid) of q (B, H, Tq, D) against k, v (B, H,
    Tk, D) under the (Tq, Tk) ``mask`` (None: none)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    m = s.amax(-1)
    valid = torch.isfinite(m)
    m_safe = torch.where(valid, m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    o = torch.matmul(p.to(v.dtype), v).float()
    return o, p.sum(-1), m_safe, valid


def _ring_dense(q, k, v, group, causal, scale):
    if k.shape[1] != q.shape[1]:       # the dense ring expands kv heads
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    n, my = C.group_size(group), C.group_rank(group)
    tq, tk = q.shape[2], k.shape[2]
    o_acc = q.new_zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32)
    l_acc = q.new_zeros(q.shape[:3], dtype=torch.float32)
    m_acc = q.new_full(q.shape[:3], -math.inf, dtype=torch.float32)
    kv = torch.stack([k, v])
    rows = my * tq + torch.arange(tq, device=q.device)[:, None]
    for t in range(n):
        src = (my - t) % n             # the block held after t rotations
        mask = None
        if causal:
            cols = src * tk + torch.arange(tk, device=q.device)[None, :]
            mask = rows >= cols
        o_b, l_b, m_b, valid = _block_attend(q, kv[0], kv[1], scale, mask)
        # rows with no valid key in this block contribute nothing
        m_b = torch.where(valid, m_b, torch.full_like(m_b, -math.inf))
        m_new = torch.maximum(m_acc, m_b)
        fin = torch.isfinite(m_new)
        m_new_safe = torch.where(fin, m_new, torch.zeros_like(m_new))
        c_old = torch.where(torch.isfinite(m_acc),
                            torch.exp(m_acc - m_new_safe),
                            torch.zeros_like(m_acc))
        c_b = torch.where(valid, torch.exp(m_b - m_new_safe),
                          torch.zeros_like(m_b))
        o_acc = o_acc * c_old[..., None] + o_b * c_b[..., None]
        l_acc = l_acc * c_old + l_b * c_b
        m_acc = m_new
        if t < n - 1:
            kv = C.ppermute(kv, group, 1)
    denom = torch.where(l_acc > 0, l_acc, torch.ones_like(l_acc))
    return (o_acc / denom[..., None]).to(q.dtype)


def _merge(o_a, lse_a, o_b, lse_b):
    """Two normalized partial attentions merged in logsumexp space, with
    JAX's guards for rows that saw nothing."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ca = torch.where(torch.isfinite(lse_a), torch.exp(lse_a - m_safe),
                     torch.zeros_like(lse_a))
    cb = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - m_safe),
                     torch.zeros_like(lse_b))
    denom = ca + cb
    safe = torch.clamp(denom, min=1e-37)
    o = (o_a * ca[..., None] + o_b * cb[..., None]) / safe[..., None]
    lse = torch.where(denom > 0, m_safe + torch.log(safe),
                      torch.full_like(m_safe, -math.inf))
    return o, lse


class _Keep(torch.autograd.Function):
    """``out`` unchanged, with ``dep`` in its graph: the backward gives
    ``dep`` a zero cotangent, so every exchange that made ``dep`` runs
    its backward."""

    @staticmethod
    def forward(ctx, out, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _ring_flash(q, k, v, group, causal, scale):
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_with_lse

    n, my = C.group_size(group), C.group_rank(group)
    o_acc = lse_acc = None
    kv = torch.stack([k, v])
    for step in range(n):
        src = (my - step) % n
        if not causal or src <= my:    # a future block is skipped
            o_b, lse_b = flash_attention_with_lse(
                q, kv[0], kv[1], causal=causal and src == my, scale=scale)
            o_b = o_b.float()
            if o_acc is None:
                o_acc, lse_acc = o_b, lse_b
            else:
                o_acc, lse_acc = _merge(o_acc, lse_acc, o_b, lse_b)
        if step < n - 1:
            kv = C.ppermute(kv, group, 1)
    if causal and n > 1 and kv.requires_grad:
        o_acc = _Keep.apply(o_acc, kv)
    return o_acc.to(q.dtype)


def ring_attention(q, k, v, group=None, causal: bool = False,
                   scale: Optional[float] = None, use_flash: bool = False):
    """Ring attention over ``group``: this rank's block of q (B, H, T, D)
    against every rank's k, v (B, H_kv, T, D), ``H % H_kv == 0``; returns
    this rank's (B, H, T, D) output in q's dtype. ``use_flash`` takes the
    flash ring (see the module docstring)."""
    group = C.resolve_group(group)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if use_flash:
        return _ring_flash(q, k, v, group, causal, scale)
    return _ring_dense(q, k, v, group, causal, scale)


def ulysses_attention(q, k, v, group=None, causal: bool = False,
                      scale: Optional[float] = None):
    """DeepSpeed-Ulysses attention over ``group``: the all-to-all turns
    the sequence shard (B, H, T/n, D) into a head shard (B, H/n, T, D)
    (rank i keeps head group i, the sequence blocks concatenated in rank
    order), attends the whole sequence, and turns it back. ``H`` (and
    ``H_kv``) must divide over the group."""
    from bigdl_tpu_torch.nn.attention import dot_product_attention

    group = C.resolve_group(group)

    def seq_to_heads(x):
        return C.all_to_all(x, group, split_dim=1, concat_dim=2)

    def heads_to_seq(x):
        return C.all_to_all(x, group, split_dim=2, concat_dim=1)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh, vh = kh.repeat_interleave(rep, 1), vh.repeat_interleave(rep, 1)
    oh = dot_product_attention(qh, kh, vh, causal=causal, scale=scale)
    return heads_to_seq(oh)
