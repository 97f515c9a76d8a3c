"""Linear layers (port of ``bigdl_tpu/nn/linear.py``).

Weight layout (output_size, input_size), bias (output_size,): the
layer computes ``x @ weight.T + bias``, as both Torch and the JAX
package do, so weights cross between them without a transpose. The
other layers keep the JAX package's parameter names and shapes
(``Scale``'s under its children ``cmul`` and ``cadd``), so
``utils/weights.py::load_jax_params`` carries them across, and its
forms: ``Euclidean`` takes ``sqrt(sum + 1e-12)`` and ``Cosine`` divides
by ``norm + 1e-12``, written out rather than through ``torch.cdist`` or
``F.normalize``, which place their epsilons elsewhere.
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


def _uniform(shape, stdv: float, rng: RandomGenerator) -> torch.Tensor:
    return bt_init.RandomUniform(-stdv, stdv)(shape, rng)


class Bilinear(Module):
    """``out_k = x1^T W_k x2 + b_k`` over a Table ``(x1, x2)``; weight
    (output, input1, input2) and bias drawn from U(-1/sqrt(input1), ..)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        rng = rng or RandomGenerator()
        self.input_size1, self.input_size2 = input_size1, input_size2
        self.output_size = output_size
        self.bias_res = bias_res
        stdv = 1.0 / input_size1 ** 0.5
        shape = (output_size, input_size1, input_size2)
        self.new_param("weight", _uniform(shape, stdv, rng), dev, dtype)
        if bias_res:
            self.new_param("bias", _uniform((output_size,), stdv, rng), dev,
                           dtype)

    def forward(self, input):
        x1, x2 = input[1], input[2]
        out = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return out + self.bias if self.bias_res else out


class Add(Module):
    """A learned bias of ``input_size`` (0 at start)."""

    def __init__(self, input_size: int, *, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.new_param("bias", torch.zeros(input_size),
                       resolve_device(device), dtype)

    def forward(self, input):
        return input + self.bias


class Mul(Module):
    """One learned scalar gain (1 at start)."""

    def __init__(self, *, device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        self.new_param("weight", torch.ones(()), resolve_device(device),
                       dtype)

    def forward(self, input):
        return input * self.weight


class CMul(Module):
    """A learned componentwise gain of broadcastable ``size`` (ones at
    start)."""

    def __init__(self, size, *, device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        self.size = tuple(size)
        self.new_param("weight", torch.ones(self.size),
                       resolve_device(device), dtype)

    def forward(self, input):
        return input * self.weight


class CAdd(Module):
    """A learned componentwise bias of broadcastable ``size`` (zeros at
    start)."""

    def __init__(self, size, *, device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        self.size = tuple(size)
        self.new_param("bias", torch.zeros(self.size),
                       resolve_device(device), dtype)

    def forward(self, input):
        return input + self.bias


class Scale(Module):
    """``CMul`` then ``CAdd`` of the same ``size``."""

    def __init__(self, size, *, device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        self.cmul = CMul(size, device=device, dtype=dtype)
        self.cadd = CAdd(size, device=device, dtype=dtype)

    def forward(self, input):
        return self.cadd(self.cmul(input))


class Euclidean(Module):
    """Euclidean distance of each row of (batch, input) to each of the
    ``output_size`` learned centres (weight (output, input), drawn from
    U(-1/sqrt(input), ..))."""

    def __init__(self, input_size: int, output_size: int, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        w = _uniform((output_size, input_size), 1.0 / input_size ** 0.5,
                     rng or RandomGenerator())
        self.new_param("weight", w, resolve_device(device), dtype)

    def forward(self, input):
        diff = input[:, None, :] - self.weight[None, :, :]
        return torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)


def _norm(x):
    """``jnp.linalg.norm(x, axis=-1, keepdims=True)`` as JAX writes it."""
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


class Cosine(Module):
    """Cosine similarity of each row of (batch, input) to each of the
    ``output_size`` learned centres (weight as ``Euclidean``'s)."""

    def __init__(self, input_size: int, output_size: int, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        w = _uniform((output_size, input_size), 1.0 / input_size ** 0.5,
                     rng or RandomGenerator())
        self.new_param("weight", w, resolve_device(device), dtype)

    def forward(self, input):
        xn = input / (_norm(input) + 1e-12)
        wn = self.weight / (_norm(self.weight) + 1e-12)
        return xn @ wn.T
