"""Dropout (port of ``Dropout`` in ``bigdl_tpu/nn/dropout.py``).

The JAX package draws its masks from a scoped key; here a layer draws
from an explicit ``torch.Generator`` on the input's device, its
``generator`` attribute (``None``: PyTorch's default generator there).
:func:`bind_generator` points every dropout layer of a model at one
generator, as the train step does with its ``rng``. The masks never
reproduce the JAX package's draws (threefry is not Philox): a dropout
layer is compared with the JAX one exactly only at p = 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


class Dropout(Module):
    """Inverted dropout: in training mode each element is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``; in evaluation
    mode (or at p = 0) the input passes unchanged."""

    draws_random = True

    def __init__(self, init_p: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = init_p
        self.generator = generator

    def forward(self, input):
        if not self.training or self.p <= 0.0:
            return input
        u = torch.rand(input.shape, generator=self.generator,
                       device=input.device)
        return input * (u < 1.0 - self.p).to(input.dtype) / (1.0 - self.p)


def bind_generator(model: torch.nn.Module,
                   generator: Optional[torch.Generator]) -> None:
    """Make every :class:`Dropout` in ``model`` draw from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
