"""Table-algebra layers: combine or split several tensors (port of
``bigdl_tpu/nn/table_ops.py``).

Dimensions are 1-based as in the JAX package, and each layer shifts
them the way its JAX twin does: ``n_input_dims`` / ``num_input_dims``
names the rank of one unbatched sample, and an input one rank larger
has its dimension moved past the batch. A negative dimension follows
the JAX expression of each layer (``JoinTable(-1)`` joins along the
second axis from the end, as there). Table inputs and outputs are the
port's :class:`~bigdl_tpu_torch.utils.table.Table`.

``Max`` / ``Min`` reduce with ``torch.amax`` / ``amin`` and ``CMaxTable``
/ ``CMinTable`` with ``torch.maximum`` / ``minimum``: like ``jnp.max``
and ``jnp.maximum`` they split the gradient evenly among tied values
(``torch.max(dim)`` would send it to one index).
"""

from __future__ import annotations

from functools import reduce

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


def _elems(input):
    return list(input) if isinstance(input, (Table, list, tuple)) else [input]


def _shifted(dim: int, n_input_dims: int, input) -> int:
    """``dim - 1``, moved past the batch dimension when ``input`` has one
    rank more than ``n_input_dims`` (> 0)."""
    ax = dim - 1
    if n_input_dims > 0 and input.dim() == n_input_dims + 1:
        ax += 1
    return ax


class CAddTable(Module):
    """Elementwise sum of the input table's entries, left to right."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, input):
        return reduce(torch.add, _elems(input))


class CMulTable(Module):
    def forward(self, input):
        return reduce(torch.mul, _elems(input))


class CSubTable(Module):
    def forward(self, input):
        a, b = _elems(input)[:2]
        return a - b


class CDivTable(Module):
    def forward(self, input):
        a, b = _elems(input)[:2]
        return a / b


class CMaxTable(Module):
    def forward(self, input):
        return reduce(torch.maximum, _elems(input))


class CMinTable(Module):
    def forward(self, input):
        return reduce(torch.minimum, _elems(input))


class CAveTable(Module):
    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, input):
        es = _elems(input)
        return reduce(torch.add, es) / len(es)


class JoinTable(Module):
    """Concatenate the table's entries along 1-based ``dimension``."""

    def __init__(self, dimension: int, n_input_dims: int = 0):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, input):
        es = _elems(input)
        return torch.cat(es, dim=_shifted(self.dimension, self.n_input_dims,
                                          es[0]))


class SplitTable(Module):
    """Split along 1-based ``dimension`` (negative: from the end) into a
    Table of slices, the dimension removed."""

    def __init__(self, dimension: int, n_input_dims: int = 0):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, input):
        if self.dimension < 0:
            ax = input.dim() + self.dimension
        else:
            ax = _shifted(self.dimension, self.n_input_dims, input)
        return Table(*torch.unbind(input, dim=ax))


class BifurcateSplitTable(Module):
    """Split into two halves along 1-based ``dimension`` (the second
    takes the odd element)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input):
        ax = self.dimension - 1
        half = input.shape[ax] // 2
        return Table(input.narrow(ax, 0, half),
                     input.narrow(ax, half, input.shape[ax] - half))


class NarrowTable(Module):
    """The ``length`` entries from 1-based ``offset``; a length <= 0
    counts from the end."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset, self.length = offset, length

    def forward(self, input):
        es = _elems(input)
        length = (self.length if self.length > 0
                  else len(es) - self.offset + self.length + 2)
        return Table(*es[self.offset - 1:self.offset - 1 + length])


class SelectTable(Module):
    """Entry ``index`` (1-based; negative: from the end)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, input):
        es = _elems(input)
        return es[self.index - 1 if self.index > 0 else self.index]


class FlattenTable(Module):
    """Nested tables as one flat Table, depth first."""

    def forward(self, input):
        out = []

        def rec(x):
            if isinstance(x, (Table, list, tuple)):
                for e in x:
                    rec(e)
            else:
                out.append(x)

        rec(input)
        return Table(*out)


class MixtureTable(Module):
    """Gater-weighted mixture of experts: input ``Table(gater (b, n),
    Table of n experts (b, ...))``."""

    def __init__(self, dim: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, input):
        gater, experts = input[1], input[2]
        stacked = torch.stack(_elems(experts), dim=1)       # (b, n, ...)
        g = gater.reshape(tuple(gater.shape) + (1,) * (stacked.dim() - 2))
        return (stacked * g).sum(dim=1)


class MM(Module):
    """Matrix product of a 2-tensor table (batched over leading dims)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, input):
        a, b = input[1], input[2]
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(Module):
    """Matrix-vector product of a (matrix, vector) table."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def forward(self, input):
        m, v = input[1], input[2]
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class DotProduct(Module):
    def forward(self, input):
        a, b = input[1], input[2]
        return (a * b).sum(dim=-1)


def _norm(x):
    """``jnp.linalg.norm`` over the last axis, written out as JAX
    evaluates it (its gradient at a zero vector is JAX's too)."""
    return torch.sqrt((x * x).sum(dim=-1))


class CosineDistance(Module):
    def forward(self, input):
        a, b = input[1], input[2]
        return (a * b).sum(dim=-1) / torch.clamp_min(_norm(a) * _norm(b),
                                                     1e-12)


class PairwiseDistance(Module):
    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def forward(self, input):
        a, b = input[1], input[2]
        d = ((a - b).abs() ** self.norm).sum(dim=-1)
        # clamped before the root, whose gradient is infinite at 0
        return torch.clamp_min(d, 1e-12) ** (1.0 / self.norm)


class CrossProduct(Module):
    """Dot products of every pair of the table's entries, (..., pairs)."""

    def __init__(self, num_tensor: int = 0, embedding_size: int = 0):
        super().__init__()

    def forward(self, input):
        es = _elems(input)
        outs = [(es[i] * es[j]).sum(dim=-1, keepdim=True)
                for i in range(len(es)) for j in range(i + 1, len(es))]
        return torch.cat(outs, dim=-1)


class Sum(Module):
    """Sum along 1-based ``dimension``; ``size_average`` divides by its
    size."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average
        self.squeeze = squeeze

    def forward(self, input):
        ax = _shifted(self.dimension, self.n_input_dims, input)
        out = input.sum(dim=ax, keepdim=not self.squeeze)
        if self.size_average:
            out = out / input.shape[ax]
        return out


class Mean(Module):
    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def forward(self, input):
        ax = _shifted(self.dimension, self.n_input_dims, input)
        return input.mean(dim=ax, keepdim=not self.squeeze)


class Max(Module):
    """Maximum along 1-based ``dim`` (values only)."""

    def __init__(self, dim: int = 1, num_input_dims: int = 0):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def forward(self, input):
        return torch.amax(input, dim=_shifted(self.dim, self.num_input_dims,
                                              input))


class Min(Module):
    def __init__(self, dim: int = 1, num_input_dims: int = 0):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def forward(self, input):
        return torch.amin(input, dim=_shifted(self.dim, self.num_input_dims,
                                              input))
