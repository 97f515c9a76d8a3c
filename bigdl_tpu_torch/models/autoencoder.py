"""The MNIST autoencoder (port of ``bigdl_tpu/models/autoencoder.py``):
784 pixels to ``class_num`` units (ReLU) and back (Sigmoid)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.activation import ReLU, Sigmoid
from bigdl_tpu_torch.nn.container import Sequential
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.shape_ops import Reshape
from bigdl_tpu_torch.utils.random import RandomGenerator

ROW_N = 28
COL_N = 28
FEATURE_SIZE = ROW_N * COL_N


class Autoencoder:
    """``Autoencoder(class_num)``: (B, 28, 28) images to (B, 784)
    reconstructions; weights drawn from ``seed`` on ``device`` in
    ``dtype``."""

    def __new__(cls, class_num: int = 32, *, seed: int = 1,
                device=DEFAULT_DEVICE, dtype=torch.float32) -> Sequential:
        kw = dict(rng=RandomGenerator(seed), device=resolve_device(device),
                  dtype=dtype)
        return (Sequential()
                .add(Reshape((FEATURE_SIZE,)))
                .add(Linear(FEATURE_SIZE, class_num, **kw))
                .add(ReLU())
                .add(Linear(class_num, FEATURE_SIZE, **kw))
                .add(Sigmoid()))

    @staticmethod
    def graph(class_num: int = 32):
        raise NotImplementedError(
            "the graph container (nn/graph.py) is not ported yet: see "
            "ROADMAP.md, Queue 1 item 12; Autoencoder(class_num) builds "
            "the same layers as a Sequential")
