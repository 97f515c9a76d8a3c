"""Layers of the port (counterparts of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.nn.attention import (
    LayerNorm, MultiHeadAttention, TransformerBlock, dot_product_attention,
    rotary_embedding, rotary_embedding_rowwise,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module

__all__ = ["LayerNorm", "Linear", "Module", "MultiHeadAttention",
           "TransformerBlock", "dot_product_attention", "rotary_embedding",
           "rotary_embedding_rowwise"]
