"""Containers (port of ``Container``, ``Sequential``, ``Concat`` and
``ConcatTable`` in ``bigdl_tpu/nn/container.py``).

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
