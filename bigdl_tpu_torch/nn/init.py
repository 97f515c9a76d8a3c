"""Weight initialization methods (port of ``bigdl_tpu/nn/init.py``).

Each method is a callable ``init(shape, rng, fan_in, fan_out)`` that
returns an f32 CPU tensor, drawing from the explicit
:class:`~bigdl_tpu_torch.utils.random.RandomGenerator` it is given where
it draws at all; the module that owns the parameter casts and moves it.
"""

from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.utils.random import RandomGenerator


class InitializationMethod:
    def __call__(self, shape, rng: RandomGenerator, fan_in=None,
                 fan_out=None):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def __call__(self, shape, rng=None, fan_in=None, fan_out=None):
        return torch.zeros(tuple(shape))


class Ones(InitializationMethod):
    def __call__(self, shape, rng=None, fan_in=None, fan_out=None):
        return torch.ones(tuple(shape))


class ConstInitMethod(InitializationMethod):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, shape, rng=None, fan_in=None, fan_out=None):
        return torch.full(tuple(shape), float(self.value))


class RandomUniform(InitializationMethod):
    """U(lower, upper); by default Torch's U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""

    def __init__(self, lower=None, upper=None):
        self.lower = lower
        self.upper = upper

    def __call__(self, shape, rng: RandomGenerator, fan_in=None,
                 fan_out=None):
        if self.lower is None:
            stdv = 1.0 / math.sqrt(max(1, fan_in or 1))
            lo, hi = -stdv, stdv
        else:
            lo, hi = self.lower, self.upper
        return rng.uniform(shape, minval=lo, maxval=hi)


class RandomNormal(InitializationMethod):
    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean = mean
        self.stdv = stdv

    def __call__(self, shape, rng: RandomGenerator, fan_in=None,
                 fan_out=None):
        return rng.normal(shape, mean=self.mean, stdv=self.stdv)


class Xavier(InitializationMethod):
    """Glorot uniform (the reference's default for Linear)."""

    def __call__(self, shape, rng: RandomGenerator, fan_in=None,
                 fan_out=None):
        fi = fan_in or shape[-1]
        fo = fan_out or shape[0]
        limit = math.sqrt(6.0 / (fi + fo))
        return rng.uniform(shape, minval=-limit, maxval=limit)


class MsraFiller(InitializationMethod):
    """He initialization: normal with std sqrt(2 / n), n the mean of
    fan-in and fan-out (``variance_norm_average``, the default) or the
    fan-in alone (ResNet passes False)."""

    def __init__(self, variance_norm_average: bool = True):
        self.variance_norm_average = variance_norm_average

    def __call__(self, shape, rng: RandomGenerator, fan_in=None,
                 fan_out=None):
        fi = fan_in or shape[-1]
        fo = fan_out or shape[0]
        n = (fi + fo) / 2.0 if self.variance_norm_average else fi
        return rng.normal(shape, mean=0.0, stdv=math.sqrt(2.0 / max(1.0, n)))


class BilinearFiller(InitializationMethod):
    """The bilinear upsampling kernel over the last two dims (kh, kw),
    broadcast over the leading ones (full / transposed convolutions)."""

    def __call__(self, shape, rng=None, fan_in=None, fan_out=None):
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = math.ceil(kh / 2.0), math.ceil(kw / 2.0)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        ys = torch.arange(kh, dtype=torch.float32)[:, None]
        xs = torch.arange(kw, dtype=torch.float32)[None, :]
        k = (1 - (ys / f_h - c_h).abs()) * (1 - (xs / f_w - c_w).abs())
        return k.expand(tuple(shape)).contiguous()


def given(value, shape, what: str) -> torch.Tensor:
    """An explicit initial value (``init_weight=`` / ``init_bias=``, a
    numpy array, tensor or nested list) as an f32 CPU tensor copy;
    raises unless it has ``shape``."""
    t = torch.as_tensor(value.detach().cpu() if torch.is_tensor(value)
                        else value, dtype=torch.float32).clone()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, the layer "
                         f"needs {tuple(shape)}")
    return t


zeros = Zeros()
ones = Ones()
xavier = Xavier()
msra = MsraFiller()
