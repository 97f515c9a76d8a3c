"""VGG (port of ``bigdl_tpu/models/vgg/model.py``).

``VggForCifar10``: thirteen 3 x 3 conv / BN(eps 1e-3) / ReLU stages with
dropout between them and a ceil-mode 2 x 2 max pool closing each block,
then a 512-wide head (dropout, Linear, BN, ReLU, dropout, Linear,
LogSoftMax). ``Vgg16``: the ImageNet VGG-16, plain conv / ReLU (no BN),
five 2 x 2 pools and the 4096-wide head. Both are the JAX package's
graphs layer for layer, with weights drawn from ``seed`` on ``device``
in ``dtype`` (Xavier convolutions and linears, zero biases).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.container import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling
from bigdl_tpu_torch.nn.shape_ops import View
from bigdl_tpu_torch.utils.random import RandomGenerator

# (in, out, dropout after the stage or None: the block's last stage,
# followed by the pool)
CIFAR_PLAN = [
    (3, 64, 0.3), (64, 64, None),
    (64, 128, 0.4), (128, 128, None),
    (128, 256, 0.4), (256, 256, 0.4), (256, 256, None),
    (256, 512, 0.4), (512, 512, 0.4), (512, 512, None),
    (512, 512, 0.4), (512, 512, 0.4), (512, 512, None),
]

VGG16_PLAN = [(3, 64), (64, 64), "M",
              (64, 128), (128, 128), "M",
              (128, 256), (256, 256), (256, 256), "M",
              (256, 512), (512, 512), (512, 512), "M",
              (512, 512), (512, 512), (512, 512), "M"]


def _kw(seed, device, dtype):
    return dict(rng=RandomGenerator(seed), device=resolve_device(device),
                dtype=dtype)


class VggForCifar10:
    """``VggForCifar10(class_num, has_dropout)``: (B, 3, 32, 32) to
    log-probabilities."""

    def __new__(cls, class_num: int = 10, has_dropout: bool = True, *,
                seed: int = 1, device=DEFAULT_DEVICE, dtype=torch.float32):
        return cls.build(class_num, has_dropout, seed=seed, device=device,
                         dtype=dtype)

    @staticmethod
    def build(class_num: int = 10, has_dropout: bool = True, *,
              seed: int = 1, device=DEFAULT_DEVICE,
              dtype=torch.float32) -> Sequential:
        kw = _kw(seed, device, dtype)
        bn = dict(device=kw["device"], dtype=dtype)
        m = Sequential()
        for n_in, n_out, drop in CIFAR_PLAN:
            m.add(SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1, **kw))
            m.add(SpatialBatchNormalization(n_out, 1e-3, **bn))
            m.add(ReLU())
            if drop is not None and has_dropout:
                m.add(Dropout(drop))
            elif drop is None:
                m.add(SpatialMaxPooling(2, 2, 2, 2).ceil())
        m.add(View(512))
        head = Sequential()
        if has_dropout:
            head.add(Dropout(0.5))
        head.add(Linear(512, 512, **kw))
        head.add(BatchNormalization(512, **bn))
        head.add(ReLU())
        if has_dropout:
            head.add(Dropout(0.5))
        head.add(Linear(512, class_num, **kw))
        head.add(LogSoftMax())
        m.add(head)
        return m


class Vgg16:
    """``Vgg16(class_num, has_dropout)``: (B, 3, 224, 224) to
    log-probabilities."""

    def __new__(cls, class_num: int = 1000, has_dropout: bool = True, *,
                seed: int = 1, device=DEFAULT_DEVICE, dtype=torch.float32):
        kw = _kw(seed, device, dtype)
        m = Sequential()
        for item in VGG16_PLAN:
            if item == "M":
                m.add(SpatialMaxPooling(2, 2, 2, 2))
            else:
                n_in, n_out = item
                m.add(SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1, **kw))
                m.add(ReLU())
        m.add(View(512 * 7 * 7))
        m.add(Linear(512 * 7 * 7, 4096, **kw)).add(ReLU())
        if has_dropout:
            m.add(Dropout(0.5))
        m.add(Linear(4096, 4096, **kw)).add(ReLU())
        if has_dropout:
            m.add(Dropout(0.5))
        m.add(Linear(4096, class_num, **kw))
        m.add(LogSoftMax())
        return m
