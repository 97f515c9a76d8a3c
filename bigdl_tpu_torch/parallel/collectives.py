"""Collectives over a process group, the differentiable ones as
``torch.autograd.Function``s (the port's counterparts of ``lax.psum``,
``psum_scatter``, ``all_gather``, ``ppermute`` and ``all_to_all`` inside
``shard_map``).

``group`` is a ``torch.distributed`` process group, an axis name (or a
tuple of names) of ``Engine.default_mesh()``, or None for the default
group. In a world without a process group every collective is the
identity, as a JAX collective over a one-device axis is; with one, the
backend runs even over a single rank (a world of one still goes through
NCCL), but for ``ppermute`` and ``all_to_all``, which over one rank
move nothing. ``calls`` counts the backend calls made, by name.

The transport follows the group's backend, never a caught error:

- ``"nccl"``: CUDA tensors move device to device;
- ``"gloo"``: CPU tensors move as they are, and a CUDA tensor (ranks
  that share one card, which NCCL refuses) is copied to the host, sent,
  and copied back to its device: gloo's point-to-point and reduce-scatter
  take host memory. :func:`transport` names the route a tensor takes.

Gradients follow JAX's transposes: ``ppermute`` by ``shift`` sends its
cotangent back by ``-shift``; ``all_to_all`` splitting dim a and
concatenating dim b transposes to the one splitting b and concatenating
a; ``psum`` sums the cotangents.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

import torch
import torch.distributed as dist

#: backend calls made since import (or since the caller reset it), by
#: collective: the messages a run sent
calls: Counter = Counter()


def resolve_group(group):
    """A process group (or None: the default group) from a group, an
    axis name or a tuple of names of the default mesh."""
    if isinstance(group, (str, tuple)):
        from bigdl_tpu_torch.parallel.engine import Engine

        return Engine.default_mesh().group(group)
    return group


def group_size(group) -> int:
    """``lax.psum(1, axis)``: the ranks of ``group`` (1 without a process
    group)."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(resolve_group(group))


def group_rank(group) -> int:
    """``lax.axis_index(axis)``: this rank's position in ``group``."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(resolve_group(group))


def transport(group, tensor: Optional[torch.Tensor] = None) -> str:
    """The route a collective over ``group`` takes for ``tensor``:
    ``"local"`` (no process group: no message), ``"nccl"``, ``"gloo"``,
    or ``"gloo-host"`` (a CUDA tensor staged through host memory)."""
    if not dist.is_initialized():
        return "local"
    backend = dist.get_backend(resolve_group(group))
    if backend == "gloo" and tensor is not None and tensor.is_cuda:
        return "gloo-host"
    return str(backend)


def _wire(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the group's backend takes it: contiguous, on the host
    when a gloo group carries a CUDA tensor."""
    if transport(group, t) == "gloo-host":
        return t.detach().cpu().contiguous()
    return t.detach().contiguous()


def _home(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t if t.device == like.device else t.to(like.device)


# ----------------------------------------------------- plain collectives
def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Sum (or ``op="mean"`` / ``"max"``) of ``x`` over ``group``, a new
    tensor; no gradient."""
    g = resolve_group(group)
    n = group_size(g)
    if not dist.is_initialized():
        return x.detach().clone()
    buf = _wire(g, x).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=g)
    calls["all_reduce"] += 1
    out = _home(buf, x)
    return out / n if op == "mean" else out


def reduce_scatter(flat: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum_scatter(flat, tiled=True)``: the sum over ``group`` of
    the 1-D ``flat``, this rank's ``len / n`` slice of it."""
    g = resolve_group(group)
    n = group_size(g)
    if not dist.is_initialized():
        return flat.detach().clone()
    src = _wire(g, flat)
    out = torch.empty(src.numel() // n, dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=g)
    calls["reduce_scatter"] += 1
    return _home(out, flat)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_gather(x, tiled=True)`` of a 1-D ``x``: every rank's
    slice, concatenated in rank order."""
    g = resolve_group(group)
    n = group_size(g)
    if not dist.is_initialized():
        return x.detach().clone()
    src = _wire(g, x)
    out = torch.empty(src.numel() * n, dtype=src.dtype, device=src.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, src, group=g)
    calls["all_gather"] += 1
    return _home(out, x)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``x`` of the group's rank ``src`` on every rank, a new tensor."""
    g = resolve_group(group)
    if not dist.is_initialized():
        return x.detach().clone()
    buf = _wire(g, x).clone()
    dist.broadcast(buf, dist.get_global_rank(g, src) if g is not None
                   else src, group=g)
    calls["broadcast"] += 1
    return _home(buf, x)


def barrier(group=None) -> None:
    g = resolve_group(group)
    if dist.is_initialized():
        dist.barrier(group=g)
        calls["barrier"] += 1


# ------------------------------------------------ differentiable: psum
class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum``: the sum over ``group``, differentiable (the
    cotangents are summed too)."""
    g = resolve_group(group)
    if not dist.is_initialized():
        return x
    return _AllReduceSum.apply(x, g)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmean``: :func:`psum` over the group's size."""
    return psum(x, group) / group_size(group)


# --------------------------------------------- differentiable: ppermute
def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``r + shift`` and receive from ``r -
    shift`` (mod n), in one batch of point-to-point operations."""
    g = resolve_group(group)
    n = group_size(g)
    r = group_rank(g)
    to, frm = (r + shift) % n, (r - shift) % n
    if g is not None:
        to, frm = dist.get_global_rank(g, to), dist.get_global_rank(g, frm)
    src = _wire(g, x)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, to, g),
           dist.P2POp(dist.irecv, out, frm, g)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    calls["ppermute"] += 1
    return _home(out, x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with the ring permutation ``[(i, (i + shift) %
    n)]``: this rank's ``x`` goes to group rank ``r + shift`` and the
    result is what rank ``r - shift`` sent; its gradient goes the other
    way. The identity over one rank."""
    g = resolve_group(group)
    if group_size(g) == 1 or shift % group_size(g) == 0:
        return x
    return _PPermute.apply(x, g, shift)


# ------------------------------------------- differentiable: all_to_all
def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    g = resolve_group(group)
    n = group_size(g)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all splits dim {split_dim} of "
                         f"{tuple(x.shape)} over {n} ranks: not divisible")
    chunks = torch.stack(x.chunk(n, dim=split_dim))   # (n, ...) to rank j
    src = _wire(g, chunks)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g)
    calls["all_to_all"] += 1
    got: List[torch.Tensor] = list(_home(out, x).unbind(0))  # from rank j
    return torch.cat(got, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group=None, split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``: dim
    ``split_dim`` is cut into n chunks, chunk j goes to group rank j, and
    the chunks received are concatenated in rank order along
    ``concat_dim``; differentiable (its transpose swaps the two dims)."""
    g = resolve_group(group)
    if group_size(g) == 1:
        return x
    split_dim %= x.dim()
    concat_dim %= x.dim()
    return _AllToAll.apply(x, g, split_dim, concat_dim)
