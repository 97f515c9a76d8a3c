"""Containers (port of ``Container``, ``Sequential``, ``Concat``,
``ConcatTable``, ``ParallelTable``, ``MapTable`` and ``Bottle`` in
``bigdl_tpu/nn/container.py``).

Children are registered as ``m0``, ``m1``, ... in the order they are
added, the names the JAX package gives them, so ``params_dict()`` and
``buffers_dict()`` match its trees key for key.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


class Container(Module):
    def __init__(self, *modules: Module):
        super().__init__()
        self._n_children = 0
        for m in modules:
            self.add(m)

    def add(self, module: Module) -> "Container":
        setattr(self, f"m{self._n_children}", module)
        self._n_children += 1
        return self

    def __getitem__(self, index: int) -> Module:
        return list(self._modules.values())[index]

    def __len__(self):
        return len(self._modules)


class Sequential(Container):
    """Feed-forward chain."""

    def forward(self, input):
        x = input
        for m in self._modules.values():
            x = m(x)
        return x


class Concat(Container):
    """Apply each child to the same input and concatenate the outputs
    along ``dimension`` (1-based, batch dimension included)."""

    def __init__(self, dimension: int, *modules: Module):
        super().__init__(*modules)
        self.dimension = dimension

    def forward(self, input):
        return torch.cat([m(input) for m in self._modules.values()],
                         dim=self.dimension - 1)


class ConcatTable(Container):
    """Apply each child to the same input; return a Table of outputs."""

    def forward(self, input):
        return Table(*[m(input) for m in self._modules.values()])


class ParallelTable(Container):
    """The i-th child applied to the i-th entry of the input table."""

    def forward(self, input):
        ins = list(input) if isinstance(input, (Table, list, tuple)) else [input]
        return Table(*[m(x) for m, x in zip(self._modules.values(), ins)])


class MapTable(Container):
    """The one child applied to every entry of the input table: its
    parameters are shared, so their gradients add up over the entries."""

    def __init__(self, module: Module):
        super().__init__(module)

    def forward(self, input):
        m = self[0]
        return Table(*[m(x) for x in input])


class Bottle(Container):
    """Fold the leading dims of the input into one batch dim, apply the
    child to inputs of ``n_input_dim`` dims, unfold."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: int = None):
        super().__init__(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = (n_output_dim if n_output_dim is not None
                             else n_input_dim)

    def forward(self, input):
        shape = tuple(input.shape)
        cut = len(shape) - self.n_input_dim + 1
        out = self[0](input.reshape((-1,) + shape[cut:]))
        return out.reshape(shape[:cut] + tuple(out.shape[1:]))
