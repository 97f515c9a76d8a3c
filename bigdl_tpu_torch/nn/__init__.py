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
    Bottle, Concat, ConcatTable, Container, MapTable, ParallelTable,
    Sequential,
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
from bigdl_tpu_torch.nn.linear import (
    Add, Bilinear, CAdd, CMul, Cosine, Euclidean, Linear, Mul, Scale,
)
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
from bigdl_tpu_torch.nn.recurrent import TimeDistributed
from bigdl_tpu_torch.nn.shape_ops import (
    Contiguous, Cropping2D, Cropping3D, Index, InferReshape, MaskedSelect,
    Masking, Narrow, Pack, Padding, Replicate, Reshape, ResizeBilinear,
    Reverse, Select, SpatialZeroPadding, Squeeze, Tile, Transpose,
    Unsqueeze, UpSampling1D, UpSampling2D, UpSampling3D, View,
)
from bigdl_tpu_torch.nn.table_ops import (
    MM, MV, BifurcateSplitTable, CAddTable, CAveTable, CDivTable, CMaxTable,
    CMinTable, CMulTable, CosineDistance, CrossProduct, CSubTable,
    DotProduct, FlattenTable, JoinTable, Max, Mean, Min, MixtureTable,
    NarrowTable, PairwiseDistance, SelectTable, SplitTable, Sum,
)

# the reference's add()-based container base: ``Container`` has add()
DynamicContainer = Container

__all__ = ["Abs", "Add", "AddConstant", "BatchNormalization",
           "BifurcateSplitTable", "Bilinear", "BinaryThreshold", "Bottle",
           "CAdd", "CAddTable", "CAveTable", "CDivTable", "CMaxTable",
           "CMinTable", "CMul", "CMulTable", "CSubTable", "Clamp", "Concat",
           "ConcatTable", "Container", "Contiguous", "Cosine",
           "CosineDistance", "Cropping2D", "Cropping3D", "CrossProduct",
           "DotProduct", "Dropout", "DynamicContainer", "ELU", "Echo",
           "Euclidean", "Exp", "FlattenTable", "GaussianDropout",
           "GaussianNoise", "GaussianSampler", "GradientReversal",
           "HardShrink", "HardSigmoid", "HardTanh", "Identity", "Index",
           "InferReshape", "JoinTable", "L1Penalty", "LayerNorm",
           "LeakyReLU", "Linear", "LocallyConnected1D", "LocallyConnected2D",
           "Log", "Log1p", "LogSigmoid", "LogSoftMax", "MM", "MV",
           "MapTable", "MaskedSelect", "Masking", "Max", "Maxout", "Mean",
           "Min", "MixtureTable", "Module", "Mul", "MulConstant",
           "MultiHeadAttention", "Narrow", "NarrowTable", "Negative",
           "NegativeEntropyPenalty", "Normalize", "NormalizeScale", "PReLU",
           "Pack", "Padding", "PairwiseDistance", "ParallelTable", "Power",
           "Quantizer", "RReLU", "ReLU", "ReLU6", "Replicate", "Reshape",
           "ResizeBilinear", "Reverse", "SReLU", "Scale", "Select",
           "SelectTable", "Sequential", "Sigmoid", "SoftMax", "SoftMin",
           "SoftPlus", "SoftShrink", "SoftSign", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialContrastiveNormalization",
           "SpatialConvolution", "SpatialConvolutionMap",
           "SpatialCrossMapLRN", "SpatialDilatedConvolution",
           "SpatialDivisiveNormalization", "SpatialDropout1D",
           "SpatialDropout2D", "SpatialDropout3D", "SpatialFullConvolution",
           "SpatialMaxPooling", "SpatialMaxPoolingWithIndices",
           "SpatialSeparableConvolution", "SpatialShareConvolution",
           "SpatialSubtractiveNormalization", "SpatialUnpooling",
           "SpatialWithinChannelLRN", "SpatialZeroPadding", "SplitTable",
           "Sqrt", "Square", "Squeeze", "Sum", "Tanh", "TanhShrink",
           "TemporalConvolution", "TemporalMaxPooling", "Threshold", "Tile",
           "TimeDistributed", "TransformerBlock", "Transpose", "Unsqueeze",
           "UpSampling1D", "UpSampling2D", "UpSampling3D", "View",
           "VolumetricAveragePooling", "VolumetricBatchNormalization",
           "VolumetricConvolution", "VolumetricFullConvolution",
           "VolumetricMaxPooling", "bind_generator", "dot_product_attention",
           "rotary_embedding", "rotary_embedding_rowwise"] + _CRITERIONS
