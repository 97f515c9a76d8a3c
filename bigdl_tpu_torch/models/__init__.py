"""Models of the port (counterparts of ``bigdl_tpu.models``)."""

from bigdl_tpu_torch.models.transformer import TransformerLM

__all__ = ["TransformerLM"]
