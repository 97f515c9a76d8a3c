"""ResNet for CIFAR-10 and ImageNet (port of
``bigdl_tpu/models/resnet/model.py``).

The same graph as the JAX package's, layer for layer and name for name:
basic blocks (depths 18 and 34, and the CIFAR depths 6n + 2) or
bottlenecks (50, 101, 152, 200), shortcut types A (a strided 1x1 average
pool concatenated with zeros on the new channels), B (a 1x1 conv and BN
where the shape changes, the default) and C (always the conv), MSRA
init and L2(1e-4) on every conv and on the ImageNet head, BN with eps
1e-3, and gamma 0 on the last BN of every bottleneck, so that each
residual branch starts as 0. ``format="NHWC"`` builds the channels-last
variant, which takes (B, H, W, C) images.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn import init
from bigdl_tpu_torch.nn.activation import Identity, MulConstant, ReLU
from bigdl_tpu_torch.nn.container import Concat, ConcatTable, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.shape_ops import View
from bigdl_tpu_torch.nn.table_ops import CAddTable
from bigdl_tpu_torch.optim.regularizer import L2Regularizer
from bigdl_tpu_torch.utils.random import RandomGenerator


class ShortcutType:
    A = "A"  # identity + zero channels on a channel increase
    B = "B"  # 1x1 conv projection only where the shape changes
    C = "C"  # always a 1x1 conv projection


class DatasetType:
    CIFAR10 = "CIFAR10"
    ImageNet = "ImageNet"


IMAGENET_DEPTHS = {
    18: ((2, 2, 2, 2), 512, "basic"),
    34: ((3, 4, 6, 3), 512, "basic"),
    50: ((3, 4, 6, 3), 2048, "bottleneck"),
    101: ((3, 4, 23, 3), 2048, "bottleneck"),
    152: ((3, 8, 36, 3), 2048, "bottleneck"),
    200: ((3, 24, 36, 3), 2048, "bottleneck"),
}


class ResNet:
    """``ResNet(class_num, {"depth": 50, "dataSet": DatasetType.ImageNet,
    "shortcutType": "B", "format": "NCHW"})``; weights drawn from
    ``seed`` on ``device`` in ``dtype`` (BN statistics stay f32)."""

    def __new__(cls, class_num: int, opt: dict = None, *, seed: int = 1,
                device=DEFAULT_DEVICE, dtype=torch.float32):
        return cls.build(class_num, opt, seed=seed, device=device,
                         dtype=dtype)

    @staticmethod
    def build(class_num: int, opt: dict = None, *, seed: int = 1,
              device=DEFAULT_DEVICE, dtype=torch.float32) -> Sequential:
        opt = opt or {}
        depth = opt.get("depth", 18)
        shortcut_type = opt.get("shortcutType", ShortcutType.B)
        dataset = opt.get("dataSet", DatasetType.CIFAR10)
        fmt = opt.get("format", "NCHW")
        dev = resolve_device(device)
        rng = RandomGenerator(seed)
        kw = dict(device=dev, dtype=dtype)

        def conv(n_in, n_out, k, stride=1, pad=0, propagate_back=True):
            return SpatialConvolution(
                n_in, n_out, k, k, stride, stride, pad, pad,
                propagate_back=propagate_back,
                w_regularizer=L2Regularizer(1e-4),
                b_regularizer=L2Regularizer(1e-4),
                init_method=init.MsraFiller(False), format=fmt, rng=rng, **kw)

        def sbn(n_out, init_weight=None):
            return SpatialBatchNormalization(n_out, 1e-3,
                                             init_weight=init_weight,
                                             format=fmt, **kw)

        def shortcut(n_in, n_out, stride):
            use_conv = shortcut_type == ShortcutType.C or (
                shortcut_type == ShortcutType.B and n_in != n_out)
            if use_conv:
                return Sequential(conv(n_in, n_out, 1, stride), sbn(n_out))
            if n_in != n_out:
                # the channel dim, 1-based with the batch: 2 NCHW, 4 NHWC
                return Sequential(
                    SpatialAveragePooling(1, 1, stride, stride, format=fmt),
                    Concat(4 if fmt == "NHWC" else 2, Identity(),
                           MulConstant(0.0)))
            return Identity()

        state = {"ichannels": 0}

        def residual(branch, n_in, n_out, stride):
            return Sequential(
                ConcatTable(branch, shortcut(n_in, n_out, stride)),
                CAddTable(), ReLU())

        def basic_block(n, stride):
            n_in, state["ichannels"] = state["ichannels"], n
            s = Sequential(conv(n_in, n, 3, stride, 1), sbn(n), ReLU(),
                           conv(n, n, 3, 1, 1), sbn(n))
            return residual(s, n_in, n, stride)

        def bottleneck(n, stride):
            n_in, state["ichannels"] = state["ichannels"], n * 4
            s = Sequential(conv(n_in, n, 1), sbn(n), ReLU(),
                           conv(n, n, 3, stride, 1), sbn(n), ReLU(),
                           conv(n, n * 4, 1),
                           sbn(n * 4, init_weight=torch.zeros(n * 4)))
            return residual(s, n_in, n * 4, stride)

        def layer(block, features, count, stride=1):
            return Sequential(*[block(features, stride if i == 0 else 1)
                                for i in range(count)])

        model = Sequential()
        if dataset == DatasetType.ImageNet:
            if depth not in IMAGENET_DEPTHS:
                raise ValueError(f"Invalid depth {depth}")
            loop, n_features, kind = IMAGENET_DEPTHS[depth]
            block = bottleneck if kind == "bottleneck" else basic_block
            state["ichannels"] = 64
            (model.add(conv(3, 64, 7, 2, 3, propagate_back=False))
                  .add(sbn(64))
                  .add(ReLU())
                  .add(SpatialMaxPooling(3, 3, 2, 2, 1, 1, format=fmt))
                  .add(layer(block, 64, loop[0]))
                  .add(layer(block, 128, loop[1], 2))
                  .add(layer(block, 256, loop[2], 2))
                  .add(layer(block, 512, loop[3], 2))
                  .add(SpatialAveragePooling(7, 7, 1, 1, format=fmt))
                  .add(View(n_features))
                  .add(Linear(n_features, class_num,
                              w_regularizer=L2Regularizer(1e-4),
                              b_regularizer=L2Regularizer(1e-4),
                              init_method=init.RandomNormal(0.0, 0.01),
                              rng=rng, **kw)))
        elif dataset == DatasetType.CIFAR10:
            if (depth - 2) % 6 != 0:
                raise ValueError(
                    "depth should be one of 20, 32, 44, 56, 110, 1202")
            n = (depth - 2) // 6
            state["ichannels"] = 16
            (model.add(conv(3, 16, 3, 1, 1, propagate_back=False))
                  .add(sbn(16))
                  .add(ReLU())
                  .add(layer(basic_block, 16, n))
                  .add(layer(basic_block, 32, n, 2))
                  .add(layer(basic_block, 64, n, 2))
                  .add(SpatialAveragePooling(8, 8, 1, 1, format=fmt))
                  .add(View(64))
                  .add(Linear(64, class_num, rng=rng, **kw)))
        else:
            raise ValueError(f"Invalid dataset {dataset}")
        return model
