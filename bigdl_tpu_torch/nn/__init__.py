"""Layers of the port (counterparts of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.nn.attention import (
    LayerNorm, MultiHeadAttention, TransformerBlock, dot_product_attention,
    rotary_embedding, rotary_embedding_rowwise,
)
from bigdl_tpu_torch.nn.criterion import (
    ClassNLLCriterion, Criterion, CrossEntropyCriterion,
)
from bigdl_tpu_torch.nn.dropout import Dropout, bind_generator
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module

__all__ = ["ClassNLLCriterion", "Criterion", "CrossEntropyCriterion",
           "Dropout", "LayerNorm", "Linear", "Module", "MultiHeadAttention",
           "TransformerBlock", "bind_generator", "dot_product_attention",
           "rotary_embedding", "rotary_embedding_rowwise"]
