"""Layers of the port (counterparts of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.nn.activation import (
    Identity, LogSoftMax, MulConstant, ReLU, Tanh,
)
from bigdl_tpu_torch.nn.attention import (
    LayerNorm, MultiHeadAttention, TransformerBlock, dot_product_attention,
    rotary_embedding, rotary_embedding_rowwise,
)
from bigdl_tpu_torch.nn.container import (
    Concat, ConcatTable, Container, Sequential,
)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (
    ClassNLLCriterion, Criterion, CrossEntropyCriterion,
)
from bigdl_tpu_torch.nn.dropout import Dropout, bind_generator
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, SpatialBatchNormalization,
)
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.shape_ops import Reshape, View
from bigdl_tpu_torch.nn.table_ops import CAddTable

__all__ = ["BatchNormalization", "CAddTable", "ClassNLLCriterion", "Concat",
           "ConcatTable", "Container", "Criterion", "CrossEntropyCriterion",
           "Dropout", "Identity", "LayerNorm", "Linear", "LogSoftMax",
           "Module", "MulConstant", "MultiHeadAttention", "ReLU", "Reshape",
           "Sequential", "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialMaxPooling", "Tanh",
           "TransformerBlock", "View", "bind_generator",
           "dot_product_attention", "rotary_embedding",
           "rotary_embedding_rowwise"]
