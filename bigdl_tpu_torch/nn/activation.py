"""Activation layers (port of ``bigdl_tpu/nn/activation.py``).

Elementwise maps with the JAX package's formulas, edge rules included
(``x > th`` against ``x >= 0`` where the two differ). The reference's
in-place flags (``ip``) are accepted for API compatibility and ignored,
as in the JAX package. Layers with parameters (``PReLU``, ``SReLU``,
``Maxout``'s inner ``Linear``) register them under the JAX names.
``GradientReversal``, ``L1Penalty`` and ``NegativeEntropyPenalty`` are
the identity forward with the JAX custom VJP as a
``torch.autograd.Function``; ``RReLU`` draws its training-mode slopes
from its ``generator`` (see ``nn/dropout.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn import init as bt_init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.random import RandomGenerator


class ReLU(Module):
    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, input):
        return torch.relu(input)


class ReLU6(Module):
    def forward(self, input):
        return torch.clamp(input, 0.0, 6.0)


class Threshold(Module):
    """``x if x > th else v``."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.th, self.v = th, v

    def forward(self, input):
        return torch.where(input > self.th, input,
                           torch.full_like(input, self.v))


class BinaryThreshold(Module):
    def __init__(self, th: float = 1e-6, ip: bool = False):
        super().__init__()
        self.th = th

    def forward(self, input):
        return (input > self.th).to(input.dtype)


class Tanh(Module):
    def forward(self, input):
        return torch.tanh(input)


class TanhShrink(Module):
    def forward(self, input):
        return input - torch.tanh(input)


class Sigmoid(Module):
    def forward(self, input):
        return torch.sigmoid(input)


class HardSigmoid(Module):
    def forward(self, input):
        return torch.clamp(0.2 * input + 0.5, 0.0, 1.0)


class HardTanh(Module):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 ip: bool = False):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def forward(self, input):
        return torch.clamp(input, self.min_value, self.max_value)


class Clamp(HardTanh):
    def __init__(self, min_v: float, max_v: float):
        super().__init__(min_v, max_v)


class ELU(Module):
    def __init__(self, alpha: float = 1.0, ip: bool = False):
        super().__init__()
        self.alpha = alpha

    def forward(self, input):
        return F.elu(input, alpha=self.alpha)


class LeakyReLU(Module):
    def __init__(self, negval: float = 0.01, ip: bool = False):
        super().__init__()
        self.negval = negval

    def forward(self, input):
        return torch.where(input >= 0, input, self.negval * input)


class PReLU(Module):
    """Leaky ReLU with a learned slope (``weight``, 0.25 at start): one
    per channel with ``n_output_plane > 0``, on the channel axis by rank
    (4-D NCHW and 2-D (batch, feature): 1; 3-D unbatched and 1-D: 0),
    else one shared slope."""

    def __init__(self, n_output_plane: int = 0, *, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        super().__init__()
        self.n_output_plane = n_output_plane
        n = max(1, n_output_plane)
        self.new_param("weight", torch.full((n,), 0.25),
                       resolve_device(device), dtype)

    def forward(self, input):
        w = self.weight
        if self.n_output_plane > 0:
            ch = 1 if input.dim() in (2, 4) else 0
            shape = [1] * input.dim()
            shape[ch] = w.shape[0]
            w = w.reshape(shape)
        return torch.where(input > 0, input, w * input)


class RReLU(Module):
    """Randomized leaky ReLU: in training mode each negative element's
    slope is drawn from U(lower, upper) (from ``generator``); in
    evaluation mode the slope is their mean."""

    draws_random = True

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 ip: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = generator

    def forward(self, input):
        if self.training:
            u = torch.rand(input.shape, generator=self.generator,
                           device=input.device)
            a = (u * (self.upper - self.lower) + self.lower).to(input.dtype)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(input >= 0, input, a * input)


class SReLU(Module):
    """S-shaped ReLU with four learned tensors of ``shape``: ``t_left``
    (0), ``a_left`` (1), ``t_right`` (Xavier at fan 1 + 1, from ``rng``)
    and ``a_right`` (1)."""

    def __init__(self, shape, *, rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        shape = tuple(shape)
        dev = resolve_device(device)
        rng = rng or RandomGenerator()
        self.new_param("t_left", torch.zeros(shape), dev, dtype)
        self.new_param("a_left", torch.ones(shape), dev, dtype)
        self.new_param("t_right", bt_init.Xavier()(shape, rng, fan_in=1,
                                                   fan_out=1) + 1.0,
                       dev, dtype)
        self.new_param("a_right", torch.ones(shape), dev, dtype)

    def forward(self, input):
        y_left = self.t_left + self.a_left * (input - self.t_left)
        y_right = self.t_right + self.a_right * (input - self.t_right)
        return torch.where(input >= self.t_right, y_right,
                           torch.where(input > self.t_left, input, y_left))


class SoftPlus(Module):
    """``log(1 + exp(beta * x)) / beta``."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta

    def forward(self, input):
        bx = self.beta * input
        return torch.logaddexp(bx, torch.zeros_like(bx)) / self.beta


class SoftSign(Module):
    def forward(self, input):
        return input / (1.0 + input.abs())


class SoftShrink(Module):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, input):
        return torch.sign(input) * torch.clamp(input.abs() - self.lambd,
                                               min=0.0)


class HardShrink(Module):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, input):
        return torch.where(input.abs() > self.lambd, input,
                           torch.zeros_like(input))


class SoftMax(Module):
    """Softmax over the feature dim: the last for 1-2-D input, dim 1 for
    3-4-D (batched maps), as in the JAX package."""

    def forward(self, input):
        return torch.softmax(input, dim=-1 if input.dim() <= 2 else 1)


class SoftMin(Module):
    def forward(self, input):
        return torch.softmax(-input, dim=-1 if input.dim() <= 2 else 1)


class LogSoftMax(Module):
    def forward(self, input):
        return torch.log_softmax(input, dim=-1)


class LogSigmoid(Module):
    def forward(self, input):
        return F.logsigmoid(input)


class Exp(Module):
    def forward(self, input):
        return torch.exp(input)


class Log(Module):
    def forward(self, input):
        return torch.log(input)


class Log1p(Module):
    def forward(self, input):
        return torch.log1p(input)


class Sqrt(Module):
    def forward(self, input):
        return torch.sqrt(input)


class Square(Module):
    def forward(self, input):
        return input * input


class Power(Module):
    """``(shift + scale * x) ** power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, input):
        return torch.pow(self.shift + self.scale * input, self.power)


class Abs(Module):
    def forward(self, input):
        return input.abs()


class Negative(Module):
    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, input):
        return -input


class AddConstant(Module):
    def __init__(self, constant_scalar: float, ip: bool = False):
        super().__init__()
        self.constant_scalar = constant_scalar

    def forward(self, input):
        return input + self.constant_scalar


class MulConstant(Module):
    def __init__(self, scalar: float, ip: bool = False):
        super().__init__()
        self.scalar = scalar

    def forward(self, input):
        return input * self.scalar


class _Reverse(torch.autograd.Function):
    """Identity forward; the backward multiplies by ``-lam``."""

    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(Module):
    """Identity forward, ``-lambda * grad`` backward."""

    def __init__(self, lambda_: float = 1.0):
        super().__init__()
        self.lambda_ = lambda_

    def forward(self, input):
        return _Reverse.apply(input, self.lambda_)


class _L1Penalty(torch.autograd.Function):
    """Identity forward; the backward is ``g + m * sign(x)``, or
    ``m * sign(x)`` alone without ``provide``."""

    @staticmethod
    def forward(ctx, x, m, provide):
        ctx.save_for_backward(x)
        ctx.m, ctx.provide = m, provide
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        extra = ctx.m * torch.sign(x)
        return (g + extra if ctx.provide else extra), None, None


class L1Penalty(Module):
    """Inline L1 sparsity penalty: the forward is the identity and
    records ``self.loss = m * ||input||_1`` (a detached tensor); the
    backward adds ``m * sign(input)`` to the incoming gradient, with
    ``m = l1weight / nElement`` when ``size_average``.
    ``provide_output=False`` drops the incoming gradient and propagates
    the penalty term alone."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True):
        super().__init__()
        self.l1weight = l1weight
        self.size_average = size_average
        self.provide_output = provide_output
        self.loss = 0.0

    def forward(self, input):
        m = self.l1weight / (input.numel() if self.size_average else 1)
        self.loss = (m * input.detach().abs().sum())
        return _L1Penalty.apply(input, m, self.provide_output)


class _EntropyPenalty(torch.autograd.Function):
    """Identity forward; the backward is ``g + beta * (log x + 1)``."""

    @staticmethod
    def forward(ctx, x, beta):
        ctx.save_for_backward(x)
        ctx.beta = beta
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.beta * (torch.log(x) + 1.0), None


class NegativeEntropyPenalty(Module):
    """Inline penalty on low-entropy distributions: the identity forward,
    recording ``self.loss = beta * sum(p * log p)`` (detached); the
    backward adds ``beta * (1 + log p)`` to the incoming gradient."""

    def __init__(self, beta: float = 0.01):
        super().__init__()
        self.beta = beta
        self.loss = 0.0

    def forward(self, input):
        x = input.detach()
        self.loss = self.beta * (x * torch.log(x)).sum()
        return _EntropyPenalty.apply(input, self.beta)


class Identity(Module):
    def forward(self, input):
        return input


def _shapes(activity):
    if torch.is_tensor(activity):
        return tuple(activity.shape)
    if isinstance(activity, dict):
        return {k: _shapes(v) for k, v in activity.items()}
    if isinstance(activity, (list, tuple)):
        return type(activity)(_shapes(v) for v in activity)
    return activity


class Echo(Module):
    """The identity, printing its input's shapes."""

    def forward(self, input):
        print(f"{self.get_name()}: {_shapes(input)}")
        return input


class Maxout(Module):
    """A ``Linear`` (``self.linear``) to ``maxout_number * output_size``
    units, then the max over each unit's ``maxout_number`` pieces."""

    def __init__(self, input_size: int, output_size: int, maxout_number: int,
                 with_bias: bool = True, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        from bigdl_tpu_torch.nn.linear import Linear

        self.output_size = output_size
        self.maxout_number = maxout_number
        self.linear = Linear(input_size, output_size * maxout_number,
                             with_bias=with_bias, rng=rng, device=device,
                             dtype=dtype)

    def forward(self, input):
        out = self.linear(input)
        out = out.reshape(tuple(out.shape[:-1])
                          + (self.maxout_number, self.output_size))
        return out.amax(dim=-2)
