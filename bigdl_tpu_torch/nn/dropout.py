"""Dropout and noise layers (port of ``bigdl_tpu/nn/dropout.py``:
``Dropout``, ``SpatialDropout1D`` / ``2D`` / ``3D``, ``GaussianDropout``,
``GaussianNoise`` and ``GaussianSampler``).

The JAX package draws its masks and noise from a scoped key; here a
layer draws from an explicit ``torch.Generator`` on the input's device,
its ``generator`` attribute (``None``: PyTorch's default generator
there). :func:`bind_generator` points every layer of a model that draws
(``draws_random``: these, and ``RReLU``) at one generator, as the train
step does with its ``rng``. The draws never reproduce the JAX package's
(threefry is not Philox): a layer is compared with the JAX one exactly
only at p = 0, at stddev 0 or in evaluation mode.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


class _Random(Module):
    """A layer that draws from ``self.generator`` on the input's
    device."""

    draws_random = True

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.generator = generator

    def _uniform(self, shape, like):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=like.device)

    def _normal(self, shape, like, mean=0.0, stdv=1.0):
        z = torch.randn(tuple(shape), generator=self.generator,
                        device=like.device)
        return mean + stdv * z

    def _keep(self, shape, like, p):
        """A 0/1 mask in ``like``'s dtype, each element 1 with
        probability ``1 - p``."""
        return (self._uniform(shape, like) < 1.0 - p).to(like.dtype)


class Dropout(_Random):
    """Dropout: in training mode each element is kept with probability
    ``1 - p`` and, with ``scale`` (the default), scaled by ``1 / (1 -
    p)``; in evaluation mode (or at p = 0) the input passes unchanged.
    ``inplace`` is accepted and, as in the JAX package, changes
    nothing."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.p = init_p
        self.scale = scale

    def set_p(self, p: float) -> "Dropout":
        self.p = p
        return self

    def forward(self, input):
        if not self.training or self.p <= 0.0:
            return input
        out = input * self._keep(input.shape, input, self.p)
        if self.scale:
            out = out / (1.0 - self.p)
        return out


class SpatialDropout2D(_Random):
    """Drops whole channels: of NCHW (``data_format="NCHW"``, the mask
    is 1 over the last two dims) or of NHWC (1 over the spatial dims)."""

    def __init__(self, init_p: float = 0.5, data_format: str = "NCHW",
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.p = init_p
        self.data_format = data_format

    def forward(self, input):
        if not self.training or self.p <= 0.0:
            return input
        shape = list(input.shape)
        if self.data_format == "NCHW":
            for i in range(len(shape) - 2, len(shape)):
                shape[i] = 1
        else:
            for i in range(1 if input.dim() == 4 else 0, len(shape) - 1):
                shape[i] = 1
        return input * self._keep(shape, input, self.p)


class SpatialDropout1D(_Random):
    """Drops whole feature maps across time (the mask is 1 over dim
    -2)."""

    def __init__(self, init_p: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.p = init_p

    def forward(self, input):
        if not self.training or self.p <= 0.0:
            return input
        shape = list(input.shape)
        shape[-2] = 1
        return input * self._keep(shape, input, self.p)


class SpatialDropout3D(_Random):
    """Drops whole channels of NCDHW (``data_format="NCHW"``: the mask is
    (b, c, 1, 1, 1)) or of NDHWC volumes ((b, 1, 1, 1, c))."""

    def __init__(self, init_p: float = 0.5, data_format: str = "NCHW",
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.p = init_p
        self.data_format = data_format

    def forward(self, input):
        if not self.training or self.p <= 0.0:
            return input
        shape = list(input.shape)
        if self.data_format == "NCHW":
            shape[-1] = shape[-2] = shape[-3] = 1
        else:
            shape[-2] = shape[-3] = shape[-4] = 1
        return input * self._keep(shape, input, self.p)


class GaussianDropout(_Random):
    """Multiplicative N(1, rate / (1 - rate)) noise in training mode."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.rate = rate

    def forward(self, input):
        if not self.training:
            return input
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        return input * self._normal(input.shape, input, 1.0, stddev)


class GaussianNoise(_Random):
    """Additive N(0, stddev) noise in training mode."""

    def __init__(self, stddev: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.stddev = stddev

    def forward(self, input):
        if not self.training:
            return input
        return input + self._normal(input.shape, input, 0.0, self.stddev)


class GaussianSampler(_Random):
    """The VAE's reparameterized sample ``mean + exp(log_var / 2) * eps``
    of a Table(mean, log_var), in either mode."""

    def forward(self, input):
        mean, log_var = input[1], input[2]
        eps = self._normal(mean.shape, mean)
        return mean + torch.exp(0.5 * log_var) * eps


def bind_generator(model: torch.nn.Module,
                   generator: Optional[torch.Generator]) -> None:
    """Make every layer of ``model`` that draws random numbers (a
    ``draws_random`` module: the dropouts, the noise layers, ``RReLU``)
    draw from ``generator``."""
    for m in model.modules():
        if getattr(m, "draws_random", False):
            m.generator = generator
