"""Transformer language model (port of ``bigdl_tpu/models/transformer.py``).

Decoder-only, pre-norm, tanh-GELU MLP, learned positions or RoPE, a
tied output head (logits = x @ tok_embed.T) or, with
``tie_embeddings=False``, a bias-free ``head`` Linear; causal unless
``causal=False``, which masks nothing in the full-sequence ``forward``
(the flash kernel then runs with ``causal=False``) and, as in the JAX
package, leaves the KV-cache entry points causal. ``sequence_parallel``
names the mesh axis whose ranks each hold one block of the sequence:
the learned-position lookup starts at rank x T and every attention goes
through ring attention (the KV-cache paths ignore it, as in JAX).
``n_experts > 0`` gives every block a top-1 mixture of experts (over
``expert_parallel`` when given); the forward leaves the summed
load-balancing loss in ``l_aux`` (add a small multiple to the
objective) and the routing stats, averaged over the blocks, in
``last_moe_stats``. Training runs through the full-sequence ``forward``
with ``dropout`` and ``remat`` (each block under
``torch.utils.checkpoint``, its dropout masks replayed in the
recompute), differentiable through the flash kernel; ``param_count`` /
``matmul_param_count`` / ``analytic_flops`` / ``analytic_bytes`` are the
JAX package's analytic cost model. The inference
entry points of the JAX package are ported: the full-sequence
``forward`` (through the flash kernel with ``use_flash=True``),
``prefill`` / ``prefill_chunk`` / ``decode_step`` over a KV cache,
their paged twins over a page pool and block tables
(``prefill_chunk_at_paged`` / ``decode_step_paged``), the speculative
verifier ``verify_chunk`` (and ``verify_chunk_paged``), greedy or sampled
``generate``, ``generate_ragged``, ``speculative_generate`` and
``beam_search``. The JAX
package's one-dispatch ``lax.scan`` decode (``decode_scan``, and the
draft's proposal scan) becomes a Python loop over ``decode_step``; eager
PyTorch compiles nothing, so ``generate``'s ``host_loop`` and the shape
buckets (``bucket_tokens``) keep only their token semantics here. With
``eos_id``, finished rows keep emitting eos and the loop stops once
every row has finished.

A tensor-parallel shard (``parallel/tp.py::shard_model``) runs every
entry point on its share of the heads, the MLP and the vocabulary;
``kv_cache_sharding(mesh)`` names its caches' layout, which
``init_cache`` / ``init_page_pool`` (``sharding=``), ``generate`` /
``generate_ragged`` (``kv_cache_sharding=``) and ``verify_chunk``
(``cache_sharding=``) check.

Sampling draws from an explicit ``torch.Generator`` on the model's
device (``None``: PyTorch's default generator). It never reproduces the
JAX package's draws: only greedy decoding is comparable token for token.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn import init as bt_init
from bigdl_tpu_torch.nn.attention import (KVShards, LayerNorm,
                                         TransformerBlock, cache_len)
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
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


def _draw(logits, temperature: float, generator):
    """One token a row from the tempered, unfiltered softmax of
    ``logits`` (B, V): the speculative paths' draw (their acceptance
    identity needs the unfiltered distributions)."""
    probs = torch.softmax(logits.float() / temperature, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def _spec_accept(p_logits, q_logits, props, temperature: float, generator):
    """Speculative-sampling acceptance (Leviathan et al. 2023, Thm 1):
    given target logits ``p_logits`` (B, g+1, V) at positions
    pos..pos+g, draft logits ``q_logits`` (B, g, V) and sampled
    proposals ``props`` (B, g), return per-proposal acceptance
    (U < p(x)/q(x)), a residual sample from norm(max(p - q, 0)) for
    every position (used at each row's first rejection), and a bonus
    sample from p at position g (used on full acceptance). Taking the
    proposal where accepted and the residual where rejected is
    distributed exactly as p. The three draws come from ``generator`` in
    this fixed order: the uniforms, the residuals, the bonus."""
    b, g = props.shape
    p = torch.softmax(p_logits.float() / temperature, -1)
    q = torch.softmax(q_logits.float() / temperature, -1)
    p_at = p[:, :g].gather(-1, props[..., None])[..., 0]
    q_at = q.gather(-1, props[..., None])[..., 0]
    u = torch.rand((b, g), generator=generator, device=p.device)
    accept = u * q_at < p_at          # U < p/q without the 0/0 division
    resid = (p[:, :g] - q).clamp_min(0.0)
    mass = resid.sum(-1, keepdim=True)
    # p == q leaves an empty residual; that position always accepts, so
    # the fallback (p itself) is drawn from but never used
    resid = torch.where(mass > 0.0, resid / mass.clamp_min(1e-30),
                        p[:, :g])
    resid_toks = torch.multinomial(resid.reshape(b * g, -1), 1,
                                   generator=generator).reshape(b, g)
    bonus = torch.multinomial(p[:, g], 1, generator=generator)[:, 0]
    return accept, resid_toks, bonus


def _top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries of each row of
    ``x``, ties broken lowest index first as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order among ties): a stable descending
    sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _checkpointed(blk, x, fn=None, collective: bool = False):
    """``fn(x)`` (default: ``blk(x)``) under ``torch.utils.checkpoint``:
    the block's activations are recomputed in the backward. PyTorch
    restores its default generators for the recompute; a dropout layer
    drawing from an explicit generator gets that generator's state at the
    forward set back for the recompute, then restored, so the masks
    replay identically and the stream goes on as if no recompute had run.
    A block that exchanges messages with other ranks (``collective``:
    ring attention, expert-parallel MoE) is recomputed whole, never
    stopped early, so every rank runs the same exchanges."""
    fn = fn or blk
    gens = {id(m.generator): m.generator for m in blk.modules()
            if isinstance(m, Dropout) and m.generator is not None}
    if not gens:
        run = fn
    else:
        at_forward = [(g, g.get_state()) for g in gens.values()]
        calls = []

        def run(inp):
            if not calls:               # the forward itself
                calls.append(1)
                return fn(inp)
            now = [g.get_state() for g, _ in at_forward]
            for g, state in at_forward:
                g.set_state(state)
            try:
                return fn(inp)
            finally:
                for (g, _), state in zip(at_forward, now):
                    g.set_state(state)

    if collective:
        with set_checkpoint_early_stop(False):
            return checkpoint(run, x, use_reentrant=False)
    return checkpoint(run, x, use_reentrant=False)


class TransformerLM(Module):
    """Decoder-only LM. Input: (batch, time) token ids (0-based). Output:
    (batch, time, vocab) logits. Weights are drawn from ``seed`` (the
    JAX package's init methods over a ``torch.Generator``) and live on
    ``device`` in ``dtype``. ``remat`` recomputes each block in the
    backward (activation memory O(T·D) per block boundary instead of
    every intermediate, at about 1.3x the FLOPs; the flash kernel then
    launches twice per layer and step)."""

    #: the summed MoE load-balancing loss of the last forward (0.0 for a
    #: dense model)
    l_aux = 0.0
    #: the routing stats (drop_rate, expert_fraction) of the last forward,
    #: averaged over the MoE blocks
    last_moe_stats = None
    #: a tensor-parallel shard's mesh state (``parallel/tp.py::
    #: TensorParallel``), None for a whole model
    _tp = None

    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 num_heads: int = 8, num_layers: int = 4,
                 max_len: int = 1024, mlp_ratio: int = 4,
                 dropout: float = 0.0, use_flash: bool = False,
                 remat: bool = False,
                 num_kv_heads: Optional[int] = None,
                 use_rope: bool = False, tie_embeddings: bool = True,
                 sequence_parallel: Optional[str] = None,
                 n_experts: int = 0, expert_parallel: Optional[str] = None,
                 *, causal: bool = True, seed: int = 1,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        rng = RandomGenerator(seed)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.use_rope = use_rope
        self.max_len = max_len
        self.num_layers = num_layers
        self.remat = remat
        self.causal = causal
        self.tie_embeddings = tie_embeddings
        self.sequence_parallel = sequence_parallel
        self.n_experts = n_experts
        self.expert_parallel = expert_parallel
        normal = bt_init.RandomNormal(0.0, 0.02)
        self.new_param("tok_embed", normal((vocab_size, embed_dim), rng),
                       dev, dtype)
        if not use_rope:
            self.new_param("pos_embed", normal((max_len, embed_dim), rng),
                           dev, dtype)
        for i in range(num_layers):
            setattr(self, f"block{i}", TransformerBlock(
                embed_dim, num_heads, mlp_ratio=mlp_ratio, use_flash=use_flash,
                num_kv_heads=num_kv_heads, rotary=use_rope, dropout=dropout,
                sequence_parallel=sequence_parallel, n_experts=n_experts,
                expert_parallel=expert_parallel, causal=causal, rng=rng,
                device=dev, dtype=dtype))
        self.ln_f = LayerNorm(embed_dim, device=dev, dtype=dtype)
        if not tie_embeddings:
            self.head = Linear(embed_dim, vocab_size, with_bias=False,
                               rng=rng, device=dev, dtype=dtype)

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

    def _table(self, name: str):
        """The token or position table; on a shard split over a data axis
        too, its data-axis blocks gathered (a collective: only the compute
        paths call it, on every rank alike)."""
        if self._tp is not None:
            return self._tp.table(self, name)
        return getattr(self, name)

    def _embed(self, ids):
        """Token embeddings; on a tensor-parallel shard a masked lookup in
        the local vocabulary slice and an all-reduce."""
        if self._tp is not None:
            return self._tp.embed(ids, self._tp.table(self, "tok_embed"))
        return F.embedding(ids, self.tok_embed)

    def _head(self, x):
        if self.tie_embeddings:
            out = F.linear(x, self._table("tok_embed"))  # x @ tok_embed.T
        else:
            out = self.head(x.reshape(-1, x.shape[-1])).reshape(
                *x.shape[:-1], -1)
        if self._tp is not None and self._tp.head_sharded:
            # this rank's vocabulary slice, gathered into vocab order
            out = self._tp.gather_vocab(out)
        return out

    def forward(self, input):
        ids = self._ids(input)
        t = ids.shape[1]
        x = self._embed(ids)
        if not self.use_rope:  # RoPE rotates inside each attention layer
            pos0 = 0
            if self.sequence_parallel is not None:
                from bigdl_tpu_torch.parallel.collectives import group_rank

                # this rank's block of the sequence; the start clamps so
                # the slice fits the table, as lax.dynamic_slice does
                pos0 = min(group_rank(self.sequence_parallel) * t,
                           max(0, self.max_len - t))
            x = x + self._table("pos_embed")[pos0:pos0 + t][None]
        remat = self.remat and torch.is_grad_enabled()
        moe = self.n_experts > 0
        collective = (self.sequence_parallel is not None
                      or self.expert_parallel is not None)
        if not moe:
            for blk in self.blocks():
                x = (_checkpointed(blk, x, collective=collective) if remat
                     else blk(x))
            return self._head(self.ln_f(x))
        # MoE: the aux loss and the stats leave each (checkpointed) block
        # as outputs, never through module state set in the recompute
        aux_total, stats = 0.0, []
        for blk in self.blocks():
            x, aux, st = (_checkpointed(blk, x, blk.forward_with_aux_stats,
                                        collective) if remat
                          else blk.forward_with_aux_stats(x))
            aux_total = aux_total + aux
            stats.append(st)
        self.l_aux = aux_total
        self.last_moe_stats = {k: sum(st[k] for st in stats) / len(stats)
                               for k in stats[0]}
        return self._head(self.ln_f(x))

    # ------------------------------------------------ analytic cost model
    def param_count(self) -> int:
        """Total parameter count."""
        return sum(p.numel() for p in self.parameters())

    def matmul_param_count(self) -> int:
        """Parameters that take part in per-token matmuls: all but the
        learned position table (an add) and the token table's lookup (a
        gather); the tied head counts the token table once as the output
        projection."""
        pos = 0 if self.use_rope else self.max_len * self.embed_dim
        emb = 0 if self.tie_embeddings else self.vocab_size * self.embed_dim
        return self.param_count() - pos - emb

    def analytic_flops(self, tokens: int, context: int) -> float:
        """Analytic forward FLOPs for ``tokens`` positions attending over
        ``context`` positions: ``2 x matmul-params`` per token plus the
        attention score/value products ``4 x layers x embed_dim x
        context`` per token."""
        per_tok = (2.0 * self.matmul_param_count()
                   + 4.0 * self.num_layers * self.embed_dim
                   * max(0, int(context)))
        return float(per_tok * max(0, int(tokens)))

    @property
    def num_kv_heads(self) -> int:
        """KV head count of the attention stack (every block's; on a
        tensor-parallel shard the whole model's, not the local H_kv/n)."""
        n = self._tp.shards if self._tp is not None else 1
        return self.block0.attn.num_kv_heads * n

    def kv_cache_sharding(self, mesh, model_axis: str = "model"):
        """The ``NamedSharding`` of this model's ``init_cache`` buffers on
        a tensor-parallel ``mesh``: the (B, H_kv, T, D) caches shard their
        heads along ``model_axis``, the layout the column-parallel qkv
        writes with no collective. Raises ``ValueError`` when the KV head
        count does not divide the axis."""
        from bigdl_tpu_torch.parallel.tp import kv_pool_sharding

        return kv_pool_sharding(mesh, self.num_kv_heads,
                                model_axis=model_axis)

    def _check_sharding(self, sharding):
        """A cache ``sharding`` (B, H_kv, T, D) must be a layout this
        model computes. Heads: replicated for a whole model, the heads
        spec of its own mesh and axis for a tensor-parallel shard (whose
        caches then hold its local heads). The batch may be split over
        any other axis: each rank then holds and decodes only its own
        rows (the caller passes them, as ``parallel/tp.py::
        put_from_host`` cuts them) with no collective. The sequence or
        the head dim may be split too (one of them): returns ``(dim,
        group, block, blocks)`` of that split (else None), and each
        rank's caches hold its block of the positions or features."""
        from bigdl_tpu_torch.parallel.tp import _axes, kv_pool_spec

        if sharding is None:
            return None
        spec = tuple(sharding.spec) + (None,) * (4 - len(sharding.spec))
        tp = self._tp
        if tp is not None and sharding.mesh is not tp.mesh:
            raise ValueError(
                f"cache sharding {sharding.spec} is not on the mesh the "
                "model is sharded over (parallel/tp.py::shard_model)")
        heads_ok = (sharding.num_blocks(1) == 1 if tp is None
                    else spec[1] == kv_pool_spec(tp.model_axis)[1])
        if not heads_ok:
            raise ValueError(
                f"cache sharding {sharding.spec} does not match the model's "
                "layout: shard the model over that mesh and axis first "
                "(parallel/tp.py::shard_model), whose caches hold its local "
                "heads")
        if tp is not None and tp.model_axis in _axes(spec[0]):
            raise ValueError(f"cache sharding {sharding.spec} splits the "
                             f"batch over the model axis "
                             f"{tp.model_axis!r}, which holds the heads")
        split = [d for d in (2, 3) if sharding.num_blocks(d) > 1]
        if len(split) > 1:
            raise ValueError(f"cache sharding {sharding.spec} splits both "
                             "the sequence and the head dim: split one")
        if not split:
            return None
        d = split[0]
        if tp is not None and tp.model_axis in _axes(spec[d]):
            raise ValueError(f"cache sharding {sharding.spec} splits over "
                             f"the model axis {tp.model_axis!r}, which "
                             "holds the heads")
        axes = _axes(spec[d])
        return (d, sharding.mesh.group(axes), sharding.mesh.index(axes),
                sharding.num_blocks(d))

    def analytic_bytes(self, tokens: int, context: int,
                       dtype_bytes: int = 4) -> float:
        """Analytic device-memory traffic of the same pass: one read of
        every parameter, one K/V write per new token and a
        ``context``-deep K/V read per token, at ``dtype_bytes`` per
        cached element."""
        param_bytes = sum(p.numel() * p.element_size()
                          for p in self.parameters())
        head_dim = self.embed_dim // self.block0.attn.num_heads
        kv_tok = (2 * self.num_layers * self.num_kv_heads * head_dim
                  * dtype_bytes)
        t, c = max(0, int(tokens)), max(0, int(context))
        return float(param_bytes + kv_tok * t * (1 + c))

    # ------------------------------------------------- KV-cache decoding
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   kv_dtype: Optional[str] = None, sharding=None):
        """Per-block (k, v) caches, each (B, H_kv, max_len, D), in
        ``dtype`` (default: the token table's, so bf16 serving keeps a
        bf16 cache, also in the int8 clone); ``kv_dtype="int8"`` gives
        each block the quantized ``(k_q, v_q, k_scale, v_scale)`` form,
        which every prefill, decode and verify entry point takes.
        ``sharding`` (``kv_cache_sharding(mesh)``, or any layout
        ``_check_sharding`` takes) is checked against the model's
        layout: a tensor-parallel shard allocates its local heads, and a
        split of the sequence (the head dim) over ``n`` ranks gives each
        rank ``max_len / n`` positions (``D / n`` features) as
        ``nn/attention.py``'s ``KVShards``, which every cached entry point
        decodes with the other blocks."""
        split = self._check_sharding(sharding)
        dtype = dtype or self.tok_embed.dtype
        if split is None:
            return [blk.attn.init_cache(batch, max_len, dtype, kv_dtype)
                    for blk in self.blocks()]
        dim, group, block, blocks = split
        total = max_len if dim == 2 else self.block0.attn.head_dim
        if total % blocks:
            raise ValueError(f"{'max_len' if dim == 2 else 'head_dim'} "
                             f"{total} does not split into {blocks} blocks")
        local = total // blocks
        out = []
        for blk in self.blocks():
            bufs = (blk.attn.init_cache(batch, local, dtype, kv_dtype)
                    if dim == 2 else blk.attn.init_cache(
                        batch, max_len, dtype, kv_dtype, features=local))
            out.append(KVShards(bufs, dim, group, block * local, total))
        return out

    def prefill(self, ids, caches, pos0: int = 0):
        """One causal pass over ids (B, T0) writing every block's cache at
        ``pos0``; returns the last position's logits (B, V) and the
        caches."""
        return self._prefill_impl(ids, caches, pos0, chunked=False)

    def prefill_chunk(self, ids, caches, pos0):
        """One chunk of a chunked prefill at offset ``pos0`` (an int or a
        (B,) tensor). Caller contract: ``pos0 + chunk <= cache length``."""
        return self._prefill_impl(ids, caches, pos0, chunked=True)

    def verify_chunk(self, ids, caches, pos0, cache_sharding=None,
                     repl_sharding=None):
        """Chunked forward at offset ``pos0`` returning the logits at
        EVERY chunk position, (B, T, V): the speculative verifier, one
        pass scoring all draft proposals. ``pos0`` is an int (the
        lockstep ``speculative_generate``) or a (B,) tensor (the engine's
        ragged verify, each row at its own depth). Writes the chunk's KV
        as ``prefill_chunk`` does, with its caller contract per row.
        ``cache_sharding`` / ``repl_sharding`` pin the JAX program's
        output layouts; here the caches are written in place in their own
        layout, so the first is only checked and the second unused."""
        self._check_sharding(cache_sharding)
        return self._prefill_impl(ids, caches, pos0, chunked=True,
                                  all_logits=True)

    def prefill_chunk_at(self, ids, caches, pos0, last_idx):
        """``prefill_chunk`` returning the logits at the per-row position
        ``last_idx`` (B,) within the chunk instead of its last position:
        the continuous-batching engine's admission path, whose final
        chunk is right-padded. ``pos0`` is an int or a (B,) tensor of
        per-row offsets (each row an independent chunked prefill at its
        own depth). Returns (logits (B, V), caches)."""
        return self._prefill_impl(ids, caches, pos0, chunked=True,
                                  gather_last=self._ids(last_idx))

    def _table_pos(self, positions):
        """Per-row positions as rows of the learned position table. A
        position past the context (a rejected verify proposal, or a draft
        step, at the serving window's edge) reads the last row: its KV
        lands past every live position and is never attended. JAX's take
        does not raise there; CUDA asserts on an out-of-range index."""
        return positions.clamp_max(self.max_len - 1)

    def _embed_chunk(self, ids, pos0):
        """Token embeddings of a (B, T) chunk at offset ``pos0`` (an int or
        a (B,) tensor), plus the learned positions without RoPE."""
        x = self._embed(ids)
        if not self.use_rope:
            ar = torch.arange(ids.shape[1], device=self.device)
            if torch.is_tensor(pos0) and pos0.dim() == 1:
                x = x + self._table("pos_embed")[self._table_pos(
                    pos0[:, None] + ar[None])]
            else:
                x = x + self._table("pos_embed")[int(pos0) + ar][None]
        return x

    def _chunk_logits(self, x, all_logits: bool, gather_last):
        """The head over a chunk's hidden states: every position (B, T, V)
        with ``all_logits``, else one position a row (B, V), the row's
        ``gather_last`` (B,) or the chunk's last."""
        if all_logits and gather_last is None:
            return self._head(self.ln_f(x))
        if gather_last is not None:
            x = x[torch.arange(x.shape[0], device=self.device),
                  gather_last][:, None]
        else:
            x = x[:, -1:]
        return self._head(self.ln_f(x))[:, 0]

    @torch.no_grad()
    def _prefill_impl(self, ids, caches, pos0, chunked: bool,
                      all_logits: bool = False, gather_last=None):
        """``gather_last`` (B,) picks one hidden state per row before the
        head: the ragged prefill's last valid position; ``all_logits``
        keeps every position (the verify chunk)."""
        ids = self._ids(ids)
        x = self._embed_chunk(ids, pos0)
        for i, blk in enumerate(self.blocks()):
            x, caches[i] = (blk.forward_chunk(x, caches[i], pos0) if chunked
                            else blk.forward_prefill(x, caches[i], pos0))
        return self._chunk_logits(x, all_logits, gather_last), caches

    # ------------------------------------------------- paged KV decoding
    def init_page_pool(self, max_pages: int, page_size: int, dtype=None,
                       kv_dtype: Optional[str] = None, sharding=None):
        """Per-block page-pool tensors for paged serving: the
        ``init_cache`` forms with the leading dim indexing pool pages. One
        block table indexes every layer (page ``p`` names slice ``p`` of
        each block's tensors), so a request's pages are one id list. ``sharding`` as in
        ``init_cache``, but a pool splits only its heads: a split of the
        sequence or the head dim raises ``ValueError``."""
        if self._check_sharding(sharding) is not None:
            raise ValueError(f"page pool sharding {sharding.spec}: a pool "
                             "splits its heads only")
        dtype = dtype or self.tok_embed.dtype
        return [blk.attn.init_page_pool(max_pages, page_size, dtype,
                                        kv_dtype)
                for blk in self.blocks()]

    def prefill_chunk_at_paged(self, ids, pools, tables, pos0, last_idx):
        """Paged twin of :meth:`prefill_chunk_at` (``pos0`` (B,) only):
        each row's chunk scatters its KV into the pool pages its
        ``tables`` row names and attends the gathered view. Caller
        contract per row: every written position falls inside the row's
        table."""
        return self._prefill_impl_paged(ids, pools, tables, pos0,
                                        gather_last=self._ids(last_idx))

    def verify_chunk_paged(self, ids, pools, tables, pos0):
        """Paged twin of :meth:`verify_chunk` ((B,) ``pos0``): logits at
        every chunk position, KV written through the block tables."""
        return self._prefill_impl_paged(ids, pools, tables, pos0,
                                        all_logits=True)

    @torch.no_grad()
    def _prefill_impl_paged(self, ids, pools, tables, pos0,
                            all_logits: bool = False, gather_last=None):
        ids = self._ids(ids)
        x = self._embed_chunk(ids, pos0)
        for i, blk in enumerate(self.blocks()):
            x, pools[i] = blk.forward_chunk_paged(x, pools[i], tables, pos0)
        return self._chunk_logits(x, all_logits, gather_last), pools

    @torch.no_grad()
    def decode_step_paged(self, ids_t, pos, pools, tables):
        """Paged twin of :meth:`decode_step` ((B,) ``pos`` only): one
        token per row, KV scattered into and gathered from the page pool
        through ``tables``."""
        x = self._embed_chunk(self._ids(ids_t)[:, None], pos)  # (B, 1, C)
        for i, blk in enumerate(self.blocks()):
            x, pools[i] = blk.forward_step_paged(x, pools[i], tables, pos)
        return self._head(self.ln_f(x))[:, 0], pools

    @torch.no_grad()
    def decode_step(self, ids_t, pos, caches):
        """One token per row in, next-token logits (B, V) out. ``pos`` is
        an int, or a (B,) tensor of per-row positions (ragged batch)."""
        ids_t = self._ids(ids_t)
        x = self._embed(ids_t)[:, None, :]                     # (B, 1, C)
        if not self.use_rope:
            if torch.is_tensor(pos) and pos.dim() == 1:
                x = x + self._table("pos_embed")[self._table_pos(pos)][:, None]
            else:
                x = x + self._table("pos_embed")[int(pos)][None, None]
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
                      prefill_chunk=None, kv_cache_sharding=None):
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
        caches = self.init_cache(b, max_len, sharding=kv_cache_sharding)
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
    def decode_scan(self, logits, pos0, caches, generator, temperature,
                    n: int, sampled: bool = False, eos_id=None, top_k=None,
                    top_p=None):
        """``n`` tokens from the prefill ``logits`` (B, V): token 0
        samples from them, then ``n - 1`` decode steps at ``pos0``,
        ``pos0 + 1``, ... (an int or a (B,) tensor of per-row positions),
        each sampling its next token (greedy unless ``sampled``). Returns
        (n, B) tokens, the JAX package's layout. There the loop is one
        ``lax.scan`` dispatch; here it is a host loop over
        ``decode_step`` with the same tokens. With ``eos_id`` finished
        rows keep emitting eos, and the loop stops once every row has
        finished."""
        toks, _ = self._decode_loop(
            logits, pos0, caches, n, sampled,
            temperature if sampled else 1.0, generator, eos_id, top_k,
            top_p)
        return toks.T

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 max_len=None, prefill_chunk=None, host_loop: bool = False,
                 bucket_tokens=None, eos_id=None,
                 top_k=None, top_p=None, on_token=None,
                 return_logits: bool = False, kv_cache_sharding=None):
        """Autoregressive generation with a KV cache: a batched prefill
        over the prompt, then one ``decode_step`` per new token. Greedy
        for ``temperature == 0``, else sampled from the tempered softmax
        filtered by ``top_k`` / ``top_p``. Returns (B, len(prompt) +
        max_new_tokens) ids; with ``return_logits=True`` also the
        (B, max_new_tokens, V) f32 logits each token was chosen from.

        ``host_loop`` and ``bucket_tokens`` keep the JAX package's token
        semantics; there they choose between programs (one dispatch per
        token or one ``lax.scan``, one scan length per bucket), while
        here decoding is always a host loop. ``on_token(step_tokens)``
        fires with each step's (B,) tokens and, as in JAX, needs
        ``host_loop=True``. Without the host loop, ``bucket_tokens``
        rounds the decoded count up to a multiple of it (as far as the
        cache has room) and the result is cut back to
        ``max_new_tokens``: the first tokens are the same either way.
        ``kv_cache_sharding`` (``kv_cache_sharding(mesh)`` of a
        tensor-parallel shard) lays the caches out by heads; every rank
        of the model axis calls ``generate`` with the same arguments and
        gets the same tokens."""
        sampled = temperature > 0.0
        _validate_sampling(sampled, top_k, top_p)
        if on_token is not None and not host_loop:
            raise ValueError("on_token streams per-step tokens, which "
                             "only the host loop materializes; pass "
                             "host_loop=True")
        prompt, logits, caches = self._decode_setup(
            prompt_ids, max_new_tokens, max_len, prefill_chunk,
            kv_cache_sharding)
        if max_new_tokens == 0:
            return (prompt, None) if return_logits else prompt
        n = max_new_tokens
        if bucket_tokens and not host_loop:
            room = cache_len(caches[0]) - prompt.shape[1] + 1
            n = max(n, min(-(-n // bucket_tokens) * bucket_tokens, room))
        toks, seen = self._decode_loop(
            logits, prompt.shape[1], caches, n, sampled,
            temperature if sampled else 1.0, generator, eos_id, top_k,
            top_p, on_token, return_logits)
        ids = torch.cat([prompt, toks[:, :max_new_tokens]], 1)
        if not return_logits:
            return ids
        return ids, seen[:, :max_new_tokens]

    # ---------------------------------------------------- beam search
    @torch.no_grad()
    def beam_search(self, prompt_ids, max_new_tokens: int,
                    num_beams: int = 4, length_penalty: float = 1.0,
                    eos_id: Optional[int] = None, max_len=None,
                    host_loop: bool = False):
        """Deterministic beam search over the KV cache. Returns (B, t0 +
        max_new_tokens) ids of the best beam of each row. A finished beam
        (after ``eos_id``) may only emit eos, at log-prob 0; the step
        that emits eos is scored and counts toward the beam's length.
        Ranking: summed token log-probs / L ** ``length_penalty``, L the
        beam's own length. Candidates tied on score go lowest flat index
        first (``jax.lax.top_k``'s order; bf16 logits tie often).

        One loop keeps every piece of state on the device: each layer's
        cache is reordered with ``index_select`` over the B·K rows, each
        step's tokens and parent pointers go into preallocated tensors,
        and the winners are read back through the parent pointers at the
        end. Nothing is read on the host inside the loop. ``host_loop``
        is accepted: in the JAX package it picks between a per-step jit
        and one ``lax.scan`` program with the same results; eager
        PyTorch has only this one form."""
        prompt, logits, caches = self._decode_setup(
            prompt_ids, max_new_tokens, max_len)
        if max_new_tokens == 0:
            return prompt
        gen = self._beam_loop(logits, prompt.shape[1], caches, num_beams,
                              max_new_tokens, eos_id, length_penalty)
        return torch.cat([prompt, gen], 1)

    @torch.no_grad()
    def _beam_loop(self, logits, pos0: int, caches, k: int, n: int,
                   eos_id, length_penalty: float, with_scores: bool = False):
        """The beam loop from the prefill's last logits (B, V) and the
        prompt caches of B rows (any cache form: every tensor of a
        layer's cache, int8 codes and their scales alike, is tiled and
        reordered together). Returns the best beams' (B, n) tokens; with
        ``with_scores`` a dict of them (``tokens``), their summed
        log-probs and lengths (``score``, ``length``, (B,)) and the
        lineage of every step's beams (``first`` (B, K), ``toks`` and
        ``parents`` (n - 1, B, K))."""
        b, v = logits.shape
        dev = logits.device
        scores, first = _top_k(torch.log_softmax(logits.float(), -1), k)
        caches = [tuple(t.repeat_interleave(k, 0) for t in c)
                  for c in caches]
        alive = (torch.ones((b, k), dtype=torch.bool, device=dev)
                 if eos_id is None else first != eos_id)
        lengths = torch.ones((b, k), dtype=torch.float32, device=dev)
        frozen = None
        if eos_id is not None:
            frozen = torch.full((v,), -math.inf, device=dev)
            frozen[eos_id] = 0.0
        ident = torch.arange(k, device=dev).expand(b, k)
        base = (torch.arange(b, device=dev) * k)[:, None]
        toks_all = torch.empty((n - 1, b, k), dtype=torch.long, device=dev)
        parents = torch.empty_like(toks_all)
        tok = first
        for i in range(n - 1):
            if i:  # the first step's beams are in tile order
                rows = (base + parents[i - 1]).reshape(-1)
                caches = [tuple(t.index_select(0, rows) for t in c)
                          for c in caches]
            logits, caches = self.decode_step(tok.reshape(b * k), pos0 + i,
                                              caches)
            logp = torch.log_softmax(logits.float(), -1).reshape(b, k, v)
            if eos_id is not None:
                logp = torch.where(alive[..., None], logp, frozen)
            scores, flat = _top_k((scores[..., None] + logp).reshape(
                b, k * v), k)
            parent, tok = flat // v, flat % v
            was_alive = alive.gather(1, parent)
            lengths = lengths.gather(1, parent) + was_alive.float()
            alive = (was_alive if eos_id is None
                     else was_alive & (tok != eos_id))
            toks_all[i], parents[i] = tok, parent
        # backtrack from the final beams through the parent pointers
        idx = ident
        gen = [None] * n
        for i in range(n - 2, -1, -1):
            gen[i + 1] = toks_all[i].gather(1, idx)
            idx = parents[i].gather(1, idx)
        gen[0] = first.gather(1, idx)
        gen = torch.stack(gen, 0)                                # (n, B, K)
        best = (scores / lengths ** length_penalty).argmax(1)    # (B,)
        toks = gen.gather(2, best[None, :, None].expand(n, b, 1))[..., 0].T
        if not with_scores:
            return toks
        return {"tokens": toks, "score": scores.gather(1, best[:, None])[:, 0],
                "length": lengths.gather(1, best[:, None])[:, 0],
                "first": first, "toks": toks_all, "parents": parents}

    # --------------------------------------------- speculative decoding
    @torch.no_grad()
    def _propose(self, tok, pos0, caches, gamma: int, sampled: bool = False,
                 temperature: float = 1.0, generator=None, tables=None,
                 choose: Optional[Callable] = None):
        """The draft proposer: ``gamma`` decode steps of this model from
        ``tok`` (B,) at ``pos0`` (an int, or a (B,) tensor of per-row
        positions), each choosing its next input (argmax, or a draw from
        the tempered softmax when ``sampled``) and writing its input's KV
        as it goes; through the page pool when ``tables`` is given. The
        JAX package's one-dispatch ``lax.scan`` (``_propose_fn`` and its
        paged twin) as a Python loop. ``choose(logits)`` replaces the
        choice (a tensor-parallel engine's leader draws and broadcasts).
        Returns ((gamma, B) proposals,
        (gamma, B, V) step logits: the sampled verifier's q
        distributions, unused when greedy) and the caches."""
        toks, qlogits = [], []
        pos = pos0
        for _ in range(gamma):
            if tables is None:
                logits, caches = self.decode_step(tok, pos, caches)
            else:
                logits, caches = self.decode_step_paged(tok, pos, caches,
                                                        tables)
            if choose is not None:
                tok = choose(logits)
            else:
                tok = (_draw(logits, temperature, generator) if sampled
                       else logits.argmax(-1))
            toks.append(tok)
            qlogits.append(logits)
            pos = pos + 1
        return torch.stack(toks), torch.stack(qlogits), caches

    @torch.no_grad()
    def speculative_generate(self, prompt_ids, max_new_tokens: int,
                             draft, gamma: int = 4, max_len=None,
                             return_stats: bool = False,
                             temperature: float = 0.0,
                             generator: Optional[torch.Generator] = None):
        """Speculative decoding: ``draft`` (a smaller TransformerLM over
        the same vocabulary) proposes ``gamma`` tokens a round with its
        own KV cache; this model scores all of them in one chunked
        ``verify_chunk`` forward.

        ``temperature == 0``: greedy; accept the longest prefix matching
        this model's argmax and take its own token at the first mismatch,
        so the output is exactly greedy ``generate()``. ``temperature >
        0``: speculative sampling; each proposal is accepted with
        probability min(1, p/q), the first rejected position draws from
        the normalized residual max(p - q, 0), and full acceptance draws
        a bonus token from p, all from ``generator``. Acceptance is the
        minimum over the batch's rows. Returns (B, t0 + n) ids, or
        ``(ids, {"rounds", "accept_rate"})`` with ``return_stats``."""
        sampled = temperature > 0.0
        prompt = self._ids(prompt_ids)
        if prompt.dim() == 1:
            prompt = prompt[None]
        b, t0 = prompt.shape
        n = max_new_tokens
        if n == 0:
            return (prompt, {"rounds": 0, "accept_rate": 0.0}) \
                if return_stats else prompt
        ctx = min(self.max_len, draft.max_len)
        if max_len is not None:
            ctx = min(ctx, max_len)
        # a round starts at pos <= t0 + n - 2 and writes up to pos + gamma
        # (the verify chunk, the full-acceptance fill-in): gamma <=
        # ctx - t0 - n + 1 keeps every write inside the caches
        gamma = min(gamma, ctx - t0 - n + 1)
        if t0 + n > ctx or gamma < 1:
            ids = self.generate(prompt, n, max_len=max_len,
                                temperature=temperature, generator=generator)
            return (ids, {"rounds": n, "accept_rate": 0.0}) \
                if return_stats else ids
        t_caches = self.init_cache(b, ctx)
        d_caches = draft.init_cache(b, ctx)
        t_logits, t_caches = self.prefill(prompt, t_caches)
        _, d_caches = draft.prefill(prompt, d_caches)
        next_tok = (_draw(t_logits, temperature, generator) if sampled
                    else t_logits.argmax(-1))
        out = [next_tok]
        pos = t0            # next_tok's position; its KV is not cached yet
        rounds = accepted = 0
        while len(out) < n:
            toks, qlogits, d_caches = draft._propose(
                next_tok, pos, d_caches, gamma, sampled,
                temperature if sampled else 1.0, generator)
            props = toks.T                                      # (B, g)
            # chunk token j sits at position pos + j; logits row j
            # predicts the token at position pos + j + 1
            chunk = torch.cat([next_tok[:, None], props], 1)
            v_logits, t_caches = self.verify_chunk(chunk, t_caches, pos)
            if sampled:
                accept, resid, bonus = _spec_accept(
                    v_logits, qlogits.transpose(0, 1), props, temperature,
                    generator)
                a = int(accept.int().cumprod(1).sum(1).min())
                out.extend(props[:, j] for j in range(a))
                # rows still accepting at column a keep their proposal,
                # rejecting rows draw the residual: together exactly p
                next_tok = bonus if a == gamma else torch.where(
                    accept[:, a], props[:, a], resid[:, a])
            else:
                v_tok = v_logits.argmax(-1)
                match = (props == v_tok[:, :gamma]).int()
                a = int(match.cumprod(1).sum(1).min())
                out.extend(props[:, j] for j in range(a))
                next_tok = v_tok[:, a]      # the target's token at pos+a+1
            out.append(next_tok)
            if a == gamma:
                # full acceptance: the last proposal (position pos +
                # gamma) never went through the draft; write its KV
                _, d_caches = draft.decode_step(props[:, -1], pos + gamma,
                                                d_caches)
            pos += a + 1
            rounds += 1
            accepted += a
        ids = torch.cat([prompt, torch.stack(out[:n], 1)], 1)
        if return_stats:
            return ids, {"rounds": rounds,
                         "accept_rate": accepted / max(rounds * gamma, 1)}
        return ids

    @torch.no_grad()
    def generate_ragged(self, prompt_ids, prompt_lengths,
                        max_new_tokens: int, temperature: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        eos_id=None, top_k=None, top_p=None,
                        bucket_tokens=None, max_len=None,
                        kv_cache_sharding=None):
        """Mixed prompt lengths in one batch: ``prompt_ids`` (B, Tmax)
        right-padded, ``prompt_lengths`` (B,). Returns (B, max_new_tokens)
        generated tokens; row i continues its own length-``t0_i`` prompt
        exactly as ``generate`` would on that row alone. Pads sit after
        every valid query, so the causal prefill never attends them, and
        each row's first decode step overwrites its first pad's KV.
        ``bucket_tokens`` rounds the decoded count up (as far as the
        cache has room) and the result is cut back, as in ``generate``."""
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
                                 else min(window, tmax + n),
                                 sharding=kv_cache_sharding)
        logits, caches = self._prefill_impl(prompt, caches, 0, chunked=False,
                                            gather_last=lengths - 1)
        n_c = n
        if bucket_tokens:
            room = cache_len(caches[0]) - lmax + 1
            n_c = max(n, min(-(-n // bucket_tokens) * bucket_tokens, room))
        toks, _ = self._decode_loop(
            logits, lengths, caches, n_c, sampled,
            temperature if sampled else 1.0, generator, eos_id, top_k, top_p)
        return toks[:, :n]
