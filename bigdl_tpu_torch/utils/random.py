"""Reproducible random number generation over explicit generators.

Port of ``bigdl_tpu/utils/random.py``. The JAX package keeps one global
splittable key; here every stream is a :class:`RandomGenerator` object
that owns a CPU ``torch.Generator`` and is passed to whoever draws from
it (weight init, sampling). There is no module-level generator.

``torch.Generator`` and ``jax.random`` give different numbers from the
same seed, so the port's draws never match the JAX package's: parity
tests carry weights across with ``utils.weights.load_jax_params``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device

_SEED_BOUND = 2 ** 63 - 1


class RandomGenerator:
    """A seeded stream of random numbers on the CPU."""

    def __init__(self, seed: int = 1):
        self._gen = torch.Generator().manual_seed(seed)

    def next_generator(self, device=DEFAULT_DEVICE) -> torch.Generator:
        """A fresh generator on ``device``, seeded from this stream (the
        counterpart of ``next_key``): sampling on the card needs a
        generator that lives there. Follows the device rule: the card
        unless the caller passes ``device="cpu"``."""
        dev = resolve_device(device)
        seed = int(torch.randint(0, _SEED_BOUND, (), generator=self._gen))
        return torch.Generator(device=dev).manual_seed(seed)

    # -- samplers (eager use: weight init) --------------------------------
    def uniform(self, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self._gen)
        return u * (maxval - minval) + minval

    def normal(self, shape, mean=0.0, stdv=1.0) -> torch.Tensor:
        return mean + stdv * torch.randn(tuple(shape), generator=self._gen)
