"""Keras layer adapter: lazy build + generic shape inference (port of
``bigdl_tpu/keras/engine.py``).

Reference: nn/keras/KerasLayer.scala (adapter holding a bigdl layer with
an InputSpec) + nn/abstractnn/InferShape.scala. ``build(input_shape)``
constructs the wrapped nn module on the layer's ``device``, and output
shapes come from running that module.

Shape inference: JAX reads shapes from ``jax.eval_shape`` over the
module's forward, which runs nothing, draws from a throwaway key and
restores every module's ``training`` flag. The port runs a real forward
on a batch of 2 zeros (``torch.int64`` for an integer layer such as
``Embedding``) under ``torch.no_grad()`` on the module's device: meta or
fake tensors would miss the layers whose forward reads a value on the
host (a ``Reshape`` of ``-1``, the recurrent loops), and a batch of 2
costs a few small launches once per layer at build time. The forward
runs in eval mode (no dropout draw) with every generator it may draw
from (the layers' own, the CPU's and the card's defaults) set back
afterwards, so it never advances the model's streams, and every
module's ``training`` flag is restored, so it leaves no module in eval
mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.module import Module, _generator_states, _replaying


def _module_device(module: torch.nn.Module, default) -> torch.device:
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return default


def _infer_output_shape(module: Module, input_shape: Tuple[int, ...],
                        dtype=torch.float32,
                        device=None) -> Tuple[int, ...]:
    """Shape after ``module`` for a (batch,)+input_shape input; the batch
    dim is left out."""
    dev = _module_device(module, device or torch.device("cpu"))
    x = torch.zeros((2,) + tuple(input_shape), dtype=dtype, device=dev)
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        with torch.no_grad(), _replaying(_generator_states(module)):
            out = module(x)
    finally:
        for m, was_training in modes:
            m.training = was_training
    return tuple(out.shape[1:])


class KerasLayer(Module):
    """Base wrapper: subclasses implement ``build_module(input_shape)``.

    The wrapped module is created on ``device`` on first call / when the
    preceding layer's output shape becomes known (Sequential drives
    this)."""

    #: dtype used for shape inference (int layers e.g. Embedding override)
    _infer_dtype = torch.float32

    def __init__(self, input_shape: Optional[Tuple[int, ...]] = None, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.device = resolve_device(device)
        self.input_shape = tuple(input_shape) if input_shape else None
        self.output_shape: Optional[Tuple[int, ...]] = None
        self.built = False

    def make(self, cls, *args, **kwargs):
        """``cls(*args, **kwargs)`` built on this layer's device."""
        from bigdl_tpu_torch.utils.serializer.serializer import takes_device

        if takes_device(cls):
            kwargs.setdefault("device", self.device)
        return cls(*args, **kwargs)

    # ---- subclass contract -------------------------------------------------
    def build_module(self, input_shape: Tuple[int, ...]) -> Module:
        raise NotImplementedError

    # ---- lifecycle ---------------------------------------------------------
    def build(self, input_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        if self.built:
            return self.output_shape
        self.input_shape = tuple(input_shape)
        self.layer = self.build_module(self.input_shape)  # registers child
        self.output_shape = _infer_output_shape(
            self.layer, self.input_shape, self._infer_dtype, self.device)
        self.built = True
        return self.output_shape

    def get_output_shape(self):
        return self.output_shape

    def forward(self, input):
        if not self.built:
            self.build(tuple(np.shape(input))[1:])
        return self.layer(input)


class InputLayer(KerasLayer):
    """≙ nn/keras/Input.scala — fixes the input shape of a Sequential."""

    def __init__(self, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)

    def build_module(self, input_shape):
        from bigdl_tpu_torch.nn.activation import Identity

        return Identity()
