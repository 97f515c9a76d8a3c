"""Pipeline parallelism: the GPipe microbatch schedule over a group of
ranks (port of ``bigdl_tpu/parallel/pipeline.py``).

Rank i of ``group`` (a process group or an axis name of
``Engine.default_mesh()``) holds stage i's parameters; a tick runs every
stage once, and ``collectives.ppermute`` passes each stage's output to
the next stage between ticks; ``m + s - 1`` ticks push ``m``
microbatches through ``s`` stages. Stage 0 takes the fresh microbatch,
the last stage collects what leaves it, and a masked all-reduce hands
the collected outputs to every rank. The backward runs through the same
exchanges reversed (``ppermute``'s cotangent goes back a stage), so
autograd of a pipelined loss is the pipelined backward.

As in the JAX schedule every stage computes on every tick, the bubble
ticks included, and the selections are ``torch.where``s, which keep
both operands in the graph: each rank's output then depends on each of
its exchanges, so every rank runs the backward of every exchange, in
the same order (the messages of point-to-point exchanges are matched by
order). The exchange after the last tick, whose result nothing reads,
is left out. The collected outputs are the same on every rank, a
replicated output as in JAX's ``out_specs=P()``: each rank's cotangent
of them is its own and reaches the last stage unsummed.

Every stage maps activations to the same shape and dtype (transformer
blocks do).
"""

from __future__ import annotations

from typing import Callable, List

import torch
from torch.utils.checkpoint import checkpoint

from bigdl_tpu_torch.parallel import collectives as C


def stack_stage_params(stage_params: List[dict]) -> dict:
    """S dicts of the same keys -> one dict of leaves with a leading
    stage dim (rank i then takes entry i)."""
    return {k: (stack_stage_params([p[k] for p in stage_params])
                if isinstance(stage_params[0][k], dict)
                else torch.stack([p[k] for p in stage_params]))
            for k in stage_params[0]}


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank (an all-reduce of it and of
    the other ranks' zeros); the backward keeps this rank's cotangent
    where the tensor came from it, as a replicated output's does."""

    @staticmethod
    def forward(ctx, x, group, mine: bool):
        ctx.mine = mine
        return C.all_reduce(x if mine else torch.zeros_like(x), group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def _squeeze(params):
    if isinstance(params, dict):
        return {k: _squeeze(v) for k, v in params.items()}
    return params[0] if params.dim() and params.shape[0] == 1 else params


def pipeline_spmd(stage_fn: Callable, my_params, x, group,
                  n_microbatches: int, remat: bool = False):
    """The pipelined forward on this rank.

    ``stage_fn(params, x_micro) -> y_micro`` is one stage, ``my_params``
    this rank's stage parameters (a leading stage dim of 1 is squeezed),
    ``x`` the whole batch (B, ...), the same on every rank. Returns the
    (B, ...) output on every rank. ``remat`` checkpoints each tick's
    stage (``torch.utils.checkpoint``): the backward keeps only the
    exchanged activations and recomputes inside the stage."""
    group = C.resolve_group(group)
    s, idx = C.group_size(group), C.group_rank(group)
    m = n_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by n_microbatches {m}")
    my_params = _squeeze(my_params)
    xm = x.reshape((m, b // m) + tuple(x.shape[1:]))
    fn = ((lambda p, a: checkpoint(stage_fn, p, a, use_reentrant=False))
          if remat else stage_fn)
    first = torch.tensor(idx == 0, device=x.device)
    buf = torch.zeros_like(xm[0])
    ys = torch.zeros((m,) + tuple(xm.shape[1:]), dtype=x.dtype,
                     device=x.device)
    ticks = m + s - 1
    for t in range(ticks):
        feed = xm[t] if t < m else torch.zeros_like(xm[0])
        out = fn(my_params, torch.where(first, feed, buf))
        if out.shape != buf.shape or out.dtype != buf.dtype:
            raise ValueError(
                f"a stage maps {tuple(buf.shape)} {buf.dtype} to "
                f"{tuple(out.shape)} {out.dtype}: every stage must keep the "
                "activations' shape and dtype")
        # the microbatch leaving the LAST stage at this tick
        mb = t - (s - 1)
        if 0 <= mb < m:
            keep = torch.tensor(idx == s - 1, device=x.device)
            ys = torch.cat([ys[:mb], torch.where(keep, out, ys[mb])[None],
                            ys[mb + 1:]])
        if t < ticks - 1:
            buf = C.ppermute(out, group, 1)
    last = idx == s - 1
    out = _FromLast.apply(ys, group, last) if s > 1 else ys
    return out.reshape((b,) + tuple(out.shape[2:]))
