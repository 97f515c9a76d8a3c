"""Weight initialization methods (port of ``bigdl_tpu/nn/init.py``:
``RandomNormal``, ``Xavier`` and ``MsraFiller``).

Each method is a callable ``init(shape, rng, fan_in, fan_out)`` that
draws an f32 CPU tensor from the explicit
:class:`~bigdl_tpu_torch.utils.random.RandomGenerator` it is given; the
module that owns the parameter casts and moves it.
"""

from __future__ import annotations

import math

from bigdl_tpu_torch.utils.random import RandomGenerator


class RandomNormal:
    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean = mean
        self.stdv = stdv

    def __call__(self, shape, rng: RandomGenerator, fan_in=None,
                 fan_out=None):
        return rng.normal(shape, mean=self.mean, stdv=self.stdv)


class Xavier:
    """Glorot uniform (the reference's default for Linear)."""

    def __call__(self, shape, rng: RandomGenerator, fan_in=None,
                 fan_out=None):
        fi = fan_in or shape[-1]
        fo = fan_out or shape[0]
        limit = math.sqrt(6.0 / (fi + fo))
        return rng.uniform(shape, minval=-limit, maxval=limit)


class MsraFiller:
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
