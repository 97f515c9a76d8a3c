"""Table-algebra layers (port of ``CAddTable`` in
``bigdl_tpu/nn/table_ops.py``)."""

from __future__ import annotations

from functools import reduce

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


def _elems(input):
    return list(input) if isinstance(input, (Table, list, tuple)) else [input]


class CAddTable(Module):
    """Elementwise sum of the input table's entries, left to right."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, input):
        return reduce(torch.add, _elems(input))
