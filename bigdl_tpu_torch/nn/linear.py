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
    ``init_method`` (default Xavier) and a zero bias; ``with_bias=False``
    registers no bias. ``w_regularizer`` / ``b_regularizer`` add their
    penalties to ``regularization_loss``."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, *,
                 w_regularizer=None, b_regularizer=None, init_method=None,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        rng = rng or RandomGenerator()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        init_method = init_method or bt_init.Xavier()
        w = init_method((output_size, input_size), rng,
                        fan_in=input_size, fan_out=output_size)
        self.new_param("weight", w, dev, dtype, w_regularizer)
        if with_bias:
            self.new_param("bias", torch.zeros(output_size), dev, dtype,
                           b_regularizer)

    def forward(self, input):
        return F.linear(input, self.weight,
                        self.bias if self.with_bias else None)
