"""Linear layer (port of ``bigdl_tpu/nn/linear.py``).

Weight layout (output_size, input_size), bias (output_size,): the
layer computes ``x @ weight.T + bias``, as both Torch and the JAX
package do, so weights cross between them without a transpose.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn import init as bt_init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.random import RandomGenerator


class Linear(Module):
    """``x @ weight.T + bias`` with weights drawn from ``rng`` by
    ``init_method`` (default Xavier) and a zero bias, or given by
    ``init_weight`` / ``init_bias``; ``with_bias=False`` registers no
    bias. ``w_regularizer`` / ``b_regularizer`` add their penalties to
    ``regularization_loss``. ``reset()`` draws the weight again from
    ``rng`` and zeroes the bias, in place."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, init_weight=None, init_bias=None,
                 init_method=None, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self._rng = rng or RandomGenerator()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self._init_method = init_method or bt_init.Xavier()
        shape = (output_size, input_size)
        w = (bt_init.given(init_weight, shape, "init_weight")
             if init_weight is not None else self._draw())
        self.new_param("weight", w, dev, dtype, w_regularizer)
        if with_bias:
            b = (bt_init.given(init_bias, (output_size,), "init_bias")
                 if init_bias is not None else torch.zeros(output_size))
            self.new_param("bias", b, dev, dtype, b_regularizer)

    def _draw(self) -> torch.Tensor:
        return self._init_method((self.output_size, self.input_size),
                                 self._rng, fan_in=self.input_size,
                                 fan_out=self.output_size)

    def reset(self) -> None:
        with torch.no_grad():
            self.weight.copy_(self._draw())
            if self.with_bias:
                self.bias.zero_()

    def forward(self, input):
        return F.linear(input, self.weight,
                        self.bias if self.with_bias else None)
