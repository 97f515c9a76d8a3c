"""LeNet-5 for MNIST (port of ``bigdl_tpu/models/lenet/model.py``; the
Sequential form, the graph form is not ported)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.activation import LogSoftMax, Tanh
from bigdl_tpu_torch.nn.container import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling
from bigdl_tpu_torch.nn.shape_ops import Reshape
from bigdl_tpu_torch.utils.random import RandomGenerator


class LeNet5:
    """``LeNet5(class_num)``: 28 x 28 images (or 784-vectors) to
    log-probabilities; weights drawn from ``seed`` on ``device`` in
    ``dtype``."""

    def __new__(cls, class_num: int = 10, *, seed: int = 1,
                device=DEFAULT_DEVICE, dtype=torch.float32):
        return cls.build(class_num, seed=seed, device=device, dtype=dtype)

    @staticmethod
    def build(class_num: int = 10, *, seed: int = 1, device=DEFAULT_DEVICE,
              dtype=torch.float32) -> Sequential:
        kw = dict(rng=RandomGenerator(seed), device=resolve_device(device),
                  dtype=dtype)
        return (Sequential()
                .add(Reshape((1, 28, 28)))
                .add(SpatialConvolution(1, 6, 5, 5, **kw).set_name("conv1_5x5"))
                .add(Tanh())
                .add(SpatialMaxPooling(2, 2, 2, 2))
                .add(SpatialConvolution(6, 12, 5, 5, **kw).set_name("conv2_5x5"))
                .add(Tanh())
                .add(SpatialMaxPooling(2, 2, 2, 2))
                .add(Reshape((12 * 4 * 4,)))
                .add(Linear(12 * 4 * 4, 100, **kw).set_name("fc1"))
                .add(Tanh())
                .add(Linear(100, class_num, **kw).set_name("fc2"))
                .add(LogSoftMax()))
