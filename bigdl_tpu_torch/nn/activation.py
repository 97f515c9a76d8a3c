"""Activation layers (port of ``ReLU``, ``Tanh``, ``SoftMax``,
``LogSoftMax``, ``MulConstant`` and ``Identity`` in
``bigdl_tpu/nn/activation.py``).

Stateless elementwise maps. The reference's in-place flags (``ip``) are
accepted for API compatibility and ignored, as in the JAX package.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module


class ReLU(Module):
    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, input):
        return torch.relu(input)


class Tanh(Module):
    def forward(self, input):
        return torch.tanh(input)


class SoftMax(Module):
    """Softmax over the feature dim: the last for 1-2-D input, dim 1 for
    3-4-D (batched maps), as in the JAX package."""

    def forward(self, input):
        return torch.softmax(input, dim=-1 if input.dim() <= 2 else 1)


class LogSoftMax(Module):
    def forward(self, input):
        return torch.log_softmax(input, dim=-1)


class MulConstant(Module):
    def __init__(self, scalar: float, ip: bool = False):
        super().__init__()
        self.scalar = scalar

    def forward(self, input):
        return input * self.scalar


class Identity(Module):
    def forward(self, input):
        return input
