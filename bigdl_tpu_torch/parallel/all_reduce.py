"""Flat-parameter collectives: the AllReduceParameter (port of
``bigdl_tpu/parallel/all_reduce.py``).

The model's parameters flatten into one f32 vector, cut into one
contiguous slice per rank; an iteration reduce-scatters the (compressed)
gradient, updates the owned slice and all-gathers the weights: the
reference's putGradients -> aggregateGradientPartition -> update ->
getWeights, which is ZeRO-1.

The flat order is the JAX order: ``jax.tree.flatten``'s sorted keys over
the ``params_dict()`` tree (``nn/module.py::tree_leaves``), so rank r
owns the elements JAX device r owns. The reference's "FP16" wire keeps
the upper 16 bits of the f32 pattern, which is bfloat16:
``compress(t)`` casts to bf16 (round to nearest even, as XLA's convert
does).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from bigdl_tpu_torch.nn.module import tree_leaves, tree_unflatten
from bigdl_tpu_torch.parallel import collectives as C


def flatten_params(params) -> Tuple[torch.Tensor, tuple]:
    """A ``params_dict``-shaped tree (or a list of tensors in
    ``tree_leaves`` order) -> (flat f32 vector, spec)."""
    if isinstance(params, dict):
        leaves = [t for _, t in tree_leaves(params)]
        like = params
    else:
        leaves, like = list(params), None
    shapes = [tuple(t.shape) for t in leaves]
    dtypes = [t.dtype for t in leaves]
    sizes = [t.numel() for t in leaves]
    flat = (torch.cat([t.detach().float().reshape(-1) for t in leaves])
            if leaves else torch.zeros(0))
    return flat, (like, shapes, dtypes, sizes)


def unflatten_leaves(flat: torch.Tensor, spec) -> List[torch.Tensor]:
    """The leaves of ``spec`` cut from ``flat``, each in its own shape
    and dtype."""
    _, shapes, dtypes, sizes = spec
    out, off = [], 0
    for shape, dtype, size in zip(shapes, dtypes, sizes):
        out.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    return out


def unflatten_params(flat: torch.Tensor, spec):
    """Inverse of :func:`flatten_params`: the tree (or the list) again."""
    leaves = unflatten_leaves(flat, spec)
    like = spec[0]
    return tree_unflatten(like, leaves) if like is not None else leaves


def pad_to_multiple(flat: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad so the vector splits into ``n`` equal slices; returns
    (padded, padded size)."""
    size = flat.shape[0]
    padded = (size + n - 1) // n * n
    if padded != size:
        flat = torch.cat([flat, flat.new_zeros(padded - size)])
    return flat, padded


def compress(t: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The reference's FP16CompressedTensor.compress: bf16 of f32."""
    return t.to(dtype)


def decompress(t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return t.to(dtype)


class AllReduceParameter:
    """The sharded flat-parameter update over ``group`` (a process group
    or an axis name of the default mesh): each rank owns ``flat_size /
    n`` contiguous elements (one executor's weightPartition)."""

    def __init__(self, group="data", compress_dtype=torch.bfloat16):
        self.group = group
        self.compress_dtype = compress_dtype

    def _wire(self, t):
        return (compress(t, self.compress_dtype)
                if self.compress_dtype is not None else t)

    def aggregate(self, local_grad_flat: torch.Tensor) -> torch.Tensor:
        """putGradients + aggregateGradientPartition: the reduce-scatter of
        the (compressed) gradient, this rank's owned slice averaged over
        the group, in f32."""
        n = C.group_size(self.group)
        owned = C.reduce_scatter(self._wire(local_grad_flat), self.group)
        return decompress(owned) / n

    def all_gather_weights(self, owned_slice: torch.Tensor) -> torch.Tensor:
        """sendWeightPartition + getWeights: every rank's updated slice
        (compressed on the wire), the full vector in f32."""
        return decompress(C.all_gather(self._wire(owned_slice), self.group))


def slice_of(flat: torch.Tensor, group) -> torch.Tensor:
    """This rank's owned slice of ``flat`` (padded to a multiple of the
    group's size)."""
    per = flat.shape[0] // C.group_size(group)
    r = C.group_rank(group)
    return flat[r * per:(r + 1) * per].clone()
