"""Inception v1 / GoogLeNet (port of
``bigdl_tpu/models/inception/model.py``).

The JAX package's graphs, layer for layer and name for name:
``inception_layer_v1`` is the four-branch ``Concat(2)`` block (1x1;
1x1 then 3x3; 1x1 then 5x5; a ceil-mode 3x3 stride-1 max pool then a
1x1), the stem is conv 7x7/2, a ceil-mode 3x3/2 pool, LRN(5, 1e-4,
0.75), conv 1x1 and 3x3, LRN and a ceil-mode pool.
``InceptionV1NoAuxClassifier`` is the single-head model; ``InceptionV1``
adds the two auxiliary heads and returns ONE (B, 3 * class_num)
tensor whose columns are ``[main (loss3), aux2 (loss2, after 4d), aux1
(loss1, after 4a)]`` log-probabilities, as the JAX model's nested
``Concat(2)``s give it. The aux heads' 5x5/3 average pools are ceil-mode
for loss1 and floor-mode for loss2, as there. Weights are drawn from
``seed`` on ``device`` in ``dtype`` (Xavier, the JAX layers' default,
and zero biases).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.container import Concat, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import SpatialCrossMapLRN
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.shape_ops import View
from bigdl_tpu_torch.utils.random import RandomGenerator

# (input planes, config, name) of each block; config is ((1x1,),
# (3x3 reduce, 3x3), (5x5 reduce, 5x5), (pool proj,))
BLOCKS = {
    "3a": (192, ((64,), (96, 128), (16, 32), (32,))),
    "3b": (256, ((128,), (128, 192), (32, 96), (64,))),
    "4a": (480, ((192,), (96, 208), (16, 48), (64,))),
    "4b": (512, ((160,), (112, 224), (24, 64), (64,))),
    "4c": (512, ((128,), (128, 256), (24, 64), (64,))),
    "4d": (512, ((112,), (144, 288), (32, 64), (64,))),
    "4e": (528, ((256,), (160, 320), (32, 128), (128,))),
    "5a": (832, ((256,), (160, 320), (32, 128), (128,))),
    "5b": (832, ((384,), (192, 384), (48, 128), (128,))),
}


class _Factory:
    """The layer constructors of one model: every weight drawn from one
    stream, on one device, in one dtype."""

    def __init__(self, seed, device, dtype):
        self.kw = dict(rng=RandomGenerator(seed),
                       device=resolve_device(device), dtype=dtype)

    def conv(self, n_in, n_out, k, stride=1, pad=0, **extra):
        return SpatialConvolution(n_in, n_out, k, k, stride, stride, pad, pad,
                                  **extra, **self.kw)

    def linear(self, n_in, n_out):
        return Linear(n_in, n_out, **self.kw)

    def block(self, name):
        n_in, config = BLOCKS[name]
        return inception_layer_v1(n_in, config, f"inception_{name}/",
                                  factory=self)

    def stem(self) -> Sequential:
        return (Sequential()
                .add(self.conv(3, 64, 7, 2, 3, propagate_back=False)
                     .set_name("conv1/7x7_s2"))
                .add(ReLU().set_name("conv1/relu_7x7"))
                .add(SpatialMaxPooling(3, 3, 2, 2).ceil()
                     .set_name("pool1/3x3_s2"))
                .add(SpatialCrossMapLRN(5, 0.0001, 0.75)
                     .set_name("pool1/norm1"))
                .add(self.conv(64, 64, 1).set_name("conv2/3x3_reduce"))
                .add(ReLU().set_name("conv2/relu_3x3_reduce"))
                .add(self.conv(64, 192, 3, 1, 1).set_name("conv2/3x3"))
                .add(ReLU().set_name("conv2/relu_3x3"))
                .add(SpatialCrossMapLRN(5, 0.0001, 0.75)
                     .set_name("conv2/norm2"))
                .add(SpatialMaxPooling(3, 3, 2, 2).ceil()
                     .set_name("pool2/3x3_s2")))

    def aux_head(self, n, n_in, class_num, has_dropout, ceil):
        """loss{n}: a 5x5/3 average pool, 1x1 conv, fc 1024, the
        classifier."""
        pool = SpatialAveragePooling(5, 5, 3, 3)
        if ceil:
            pool = pool.ceil()
        out = (Sequential()
               .add(pool.set_name(f"loss{n}/ave_pool"))
               .add(self.conv(n_in, 128, 1).set_name(f"loss{n}/conv"))
               .add(ReLU().set_name(f"loss{n}/relu_conv"))
               .add(View(128 * 4 * 4))
               .add(self.linear(128 * 4 * 4, 1024).set_name(f"loss{n}/fc"))
               .add(ReLU().set_name(f"loss{n}/relu_fc")))
        if has_dropout:
            out.add(Dropout(0.7).set_name(f"loss{n}/drop_fc"))
        out.add(self.linear(1024, class_num).set_name(f"loss{n}/classifier"))
        out.add(LogSoftMax().set_name(f"loss{n}/loss"))
        return out

    def main_head(self, seq, class_num, has_dropout):
        seq.add(SpatialAveragePooling(7, 7, 1, 1).set_name("pool5/7x7_s1"))
        if has_dropout:
            seq.add(Dropout(0.4).set_name("pool5/drop_7x7_s1"))
        seq.add(View(1024))
        seq.add(self.linear(1024, class_num).set_name("loss3/classifier"))
        seq.add(LogSoftMax().set_name("loss3/loss3"))
        return seq


def inception_layer_v1(input_size: int, config, name_prefix: str = "", *,
                       seed: int = 1, device=DEFAULT_DEVICE,
                       dtype=torch.float32, factory=None) -> Concat:
    """The four parallel branches concatenated on channels; ``config`` is
    ((c1x1,), (c3x3_reduce, c3x3), (c5x5_reduce, c5x5), (pool_proj,)).
    A model passes its ``factory``; alone, the block draws from
    ``seed``."""
    b = factory or _Factory(seed, device, dtype)
    p = name_prefix
    concat = Concat(2)
    concat.add(Sequential()
               .add(b.conv(input_size, config[0][0], 1).set_name(p + "1x1"))
               .add(ReLU().set_name(p + "relu_1x1")))
    concat.add(Sequential()
               .add(b.conv(input_size, config[1][0], 1)
                    .set_name(p + "3x3_reduce"))
               .add(ReLU().set_name(p + "relu_3x3_reduce"))
               .add(b.conv(config[1][0], config[1][1], 3, 1, 1)
                    .set_name(p + "3x3"))
               .add(ReLU().set_name(p + "relu_3x3")))
    concat.add(Sequential()
               .add(b.conv(input_size, config[2][0], 1)
                    .set_name(p + "5x5_reduce"))
               .add(ReLU().set_name(p + "relu_5x5_reduce"))
               .add(b.conv(config[2][0], config[2][1], 5, 1, 2)
                    .set_name(p + "5x5"))
               .add(ReLU().set_name(p + "relu_5x5")))
    concat.add(Sequential()
               .add(SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()
                    .set_name(p + "pool"))
               .add(b.conv(input_size, config[3][0], 1)
                    .set_name(p + "pool_proj"))
               .add(ReLU().set_name(p + "relu_pool_proj")))
    return concat.set_name(p + "output")


class InceptionV1NoAuxClassifier:
    """Single-head GoogLeNet: (B, 3, 224, 224) to log-probabilities."""

    def __new__(cls, class_num: int = 1000, has_dropout: bool = True, *,
                seed: int = 1, device=DEFAULT_DEVICE, dtype=torch.float32):
        b = _Factory(seed, device, dtype)
        m = b.stem()
        m.add(b.block("3a")).add(b.block("3b"))
        m.add(SpatialMaxPooling(3, 3, 2, 2).ceil().set_name("pool3/3x3_s2"))
        for name in ("4a", "4b", "4c", "4d", "4e"):
            m.add(b.block(name))
        m.add(SpatialMaxPooling(3, 3, 2, 2).ceil().set_name("pool4/3x3_s2"))
        m.add(b.block("5a")).add(b.block("5b"))
        return b.main_head(m, class_num, has_dropout)


class InceptionV1:
    """Training GoogLeNet with the two auxiliary heads: (B, 3, 224, 224)
    to one (B, 3 * class_num) tensor, columns [main, aux2, aux1]."""

    def __new__(cls, class_num: int = 1000, has_dropout: bool = True, *,
                seed: int = 1, device=DEFAULT_DEVICE, dtype=torch.float32):
        b = _Factory(seed, device, dtype)
        feature1 = b.stem()
        feature1.add(b.block("3a")).add(b.block("3b"))
        feature1.add(SpatialMaxPooling(3, 3, 2, 2).ceil()
                     .set_name("pool3/3x3_s2"))
        feature1.add(b.block("4a"))
        output1 = b.aux_head(1, 512, class_num, has_dropout, ceil=True)

        feature2 = Sequential()
        for name in ("4b", "4c", "4d"):
            feature2.add(b.block(name))
        output2 = b.aux_head(2, 528, class_num, has_dropout, ceil=False)

        output3 = Sequential()
        output3.add(b.block("4e"))
        output3.add(SpatialMaxPooling(3, 3, 2, 2).ceil()
                    .set_name("pool4/3x3_s2"))
        output3.add(b.block("5a")).add(b.block("5b"))
        b.main_head(output3, class_num, has_dropout)

        split2 = Concat(2).add(output3).add(output2)
        main_branch = Sequential().add(feature2).add(split2)
        split1 = Concat(2).add(main_branch).add(output1)
        return Sequential().add(feature1).add(split1)
