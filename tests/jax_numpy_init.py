"""Numpy weight draws for the JAX reference models of the port's tests.

The JAX package draws every initial weight with ``jax.random`` through
``bigdl_tpu.utils.random.RNG``; on the CPU each new parameter shape
compiles its own sampler, which makes building a large JAX model take
tens of seconds (Inception v1: 34 s, 0.2 s once compiled). A parity test
needs the JAX model's weights to be random and then carried across to
the port, not to be threefry draws: inside ``numpy_weight_draws`` the
generator's ``uniform`` / ``normal`` draw from a seeded
``numpy.random.RandomState`` instead (same bounds, same shapes and
dtypes), and the generator is restored on exit. Nothing in the JAX
package changes.
"""

from __future__ import annotations

import contextlib
import zlib

import jax.numpy as jnp
import numpy as np

from bigdl_tpu.utils import random as bt_random


def seed_of(name: str) -> int:
    """A stable seed from a fixture's name."""
    return zlib.crc32(name.encode())


@contextlib.contextmanager
def numpy_weight_draws(seed: int):
    rng = bt_random.RNG
    rs = np.random.RandomState(seed)

    def uniform(shape, minval=0.0, maxval=1.0, dtype="float32"):
        return jnp.asarray(rs.uniform(float(minval), float(maxval), shape),
                           dtype=dtype)

    def normal(shape, mean=0.0, stdv=1.0, dtype="float32"):
        return jnp.asarray(float(mean) + float(stdv)
                           * rs.standard_normal(shape), dtype=dtype)

    rng.uniform, rng.normal = uniform, normal
    try:
        yield
    finally:
        del rng.uniform, rng.normal
