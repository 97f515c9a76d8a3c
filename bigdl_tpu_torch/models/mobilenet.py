"""MobileNetV1 (port of ``bigdl_tpu/models/mobilenet.py``).

A 3 x 3 stride-2 stem, then thirteen depthwise-separable blocks (a
depthwise 3 x 3 convolution, ``n_group`` equal to its channels, and a
pointwise 1 x 1, each followed by BN and ReLU6; convolutions without
bias), a global average pool, ``View(-1)`` and the Linear head. ``width``
multiplies every channel count (at least 8). ``format="NHWC"`` builds
the channels-last model, which takes (B, H, W, C) images; the weights
keep their (out, in / groups, kH, kW) shape in both formats, so the two
load each other's trees.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.activation import ReLU6
from bigdl_tpu_torch.nn.container import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling
from bigdl_tpu_torch.nn.shape_ops import View
from bigdl_tpu_torch.utils.random import RandomGenerator

# (out channels, stride) of each depthwise-separable block after the stem
BLOCKS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
          (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
          (1024, 2), (1024, 1)]


def MobileNetV1(class_num: int = 1000, width: float = 1.0,
                format: str = "NCHW", *, seed: int = 1,
                device=DEFAULT_DEVICE, dtype=torch.float32) -> Sequential:
    """(B, 3, 224, 224) NCHW or (B, 224, 224, 3) NHWC images to logits;
    weights drawn from ``seed`` on ``device`` in ``dtype``."""
    dev = resolve_device(device)
    rng = RandomGenerator(seed)

    def c(ch):
        return max(8, int(ch * width))

    seq = Sequential()

    def conv_bn(cin, cout, k, stride, pad, n_group=1):
        seq.add(SpatialConvolution(cin, cout, k, k, stride, stride, pad, pad,
                                   n_group=n_group, with_bias=False,
                                   format=format, rng=rng, device=dev,
                                   dtype=dtype))
        seq.add(SpatialBatchNormalization(cout, format=format, device=dev,
                                          dtype=dtype))
        seq.add(ReLU6())

    conv_bn(3, c(32), 3, 2, 1)
    cin = c(32)
    for cout, stride in BLOCKS:
        cout = c(cout)
        conv_bn(cin, cin, 3, stride, 1, n_group=cin)
        conv_bn(cin, cout, 1, 1, 0)
        cin = cout
    seq.add(SpatialAveragePooling(7, 7, global_pooling=True, format=format))
    seq.add(View(-1))
    seq.add(Linear(cin, class_num, rng=rng, device=dev, dtype=dtype))
    return seq
