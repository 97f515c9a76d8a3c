"""Layers of the port (counterparts of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.nn.activation import (
    ELU, Abs, AddConstant, BinaryThreshold, Clamp, Echo, Exp,
    GradientReversal, HardShrink, HardSigmoid, HardTanh, Identity, L1Penalty,
    LeakyReLU, Log, Log1p, LogSigmoid, LogSoftMax, Maxout, MulConstant,
    Negative, NegativeEntropyPenalty, Power, PReLU, ReLU, ReLU6, RReLU,
    Sigmoid, SoftMax, SoftMin, SoftPlus, SoftShrink, SoftSign, Sqrt, Square,
    SReLU, Tanh, TanhShrink, Threshold,
)
from bigdl_tpu_torch.nn.attention import (
    LayerNorm, MultiHeadAttention, TransformerBlock, dot_product_attention,
    rotary_embedding, rotary_embedding_rowwise,
)
from bigdl_tpu_torch.nn.container import (
    Concat, ConcatTable, Container, Sequential,
)
from bigdl_tpu_torch.nn.conv import (
    LocallyConnected1D, LocallyConnected2D, SpatialConvolution,
    SpatialConvolutionMap, SpatialDilatedConvolution, SpatialFullConvolution,
    SpatialSeparableConvolution, SpatialShareConvolution,
    TemporalConvolution, VolumetricConvolution, VolumetricFullConvolution,
)
from bigdl_tpu_torch.nn.criterion import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.criterion import __all__ as _CRITERIONS
from bigdl_tpu_torch.nn.dropout import (
    Dropout, GaussianDropout, GaussianNoise, GaussianSampler,
    SpatialDropout1D, SpatialDropout2D, SpatialDropout3D, bind_generator,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, Normalize, NormalizeScale, SpatialBatchNormalization,
    SpatialContrastiveNormalization, SpatialCrossMapLRN,
    SpatialDivisiveNormalization, SpatialSubtractiveNormalization,
    SpatialWithinChannelLRN, VolumetricBatchNormalization,
)
from bigdl_tpu_torch.nn.pooling import (
    SpatialAveragePooling, SpatialMaxPooling, SpatialMaxPoolingWithIndices,
    SpatialUnpooling, TemporalMaxPooling, VolumetricAveragePooling,
    VolumetricMaxPooling,
)
from bigdl_tpu_torch.nn.quantized import Quantizer
from bigdl_tpu_torch.nn.shape_ops import Reshape, View
from bigdl_tpu_torch.nn.table_ops import CAddTable

__all__ = ["Abs", "AddConstant", "BatchNormalization", "BinaryThreshold",
           "CAddTable", "Clamp", "Concat", "ConcatTable",
           "Container", "Dropout", "ELU", "Echo", "Exp",
           "GaussianDropout", "GaussianNoise", "GaussianSampler",
           "GradientReversal", "HardShrink", "HardSigmoid",
           "HardTanh", "Identity", "L1Penalty", "LayerNorm",
           "LeakyReLU", "Linear", "LocallyConnected1D",
           "LocallyConnected2D", "Log", "Log1p", "LogSigmoid",
           "LogSoftMax", "Maxout", "Module", "MulConstant",
           "MultiHeadAttention", "Negative",
           "NegativeEntropyPenalty", "Normalize", "NormalizeScale",
           "PReLU", "Power", "Quantizer", "RReLU", "ReLU", "ReLU6",
           "Reshape", "SReLU", "Sequential", "Sigmoid", "SoftMax",
           "SoftMin", "SoftPlus", "SoftShrink", "SoftSign",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialContrastiveNormalization", "SpatialConvolution",
           "SpatialConvolutionMap", "SpatialCrossMapLRN",
           "SpatialDilatedConvolution",
           "SpatialDivisiveNormalization", "SpatialDropout1D",
           "SpatialDropout2D", "SpatialDropout3D",
           "SpatialFullConvolution", "SpatialMaxPooling",
           "SpatialMaxPoolingWithIndices",
           "SpatialSeparableConvolution", "SpatialShareConvolution",
           "SpatialSubtractiveNormalization", "SpatialUnpooling",
           "SpatialWithinChannelLRN", "Sqrt", "Square", "Tanh",
           "TanhShrink", "TemporalConvolution",
           "TemporalMaxPooling", "Threshold", "TransformerBlock",
           "View", "VolumetricAveragePooling",
           "VolumetricBatchNormalization", "VolumetricConvolution",
           "VolumetricFullConvolution", "VolumetricMaxPooling",
           "bind_generator", "dot_product_attention",
           "rotary_embedding", "rotary_embedding_rowwise"] + _CRITERIONS
