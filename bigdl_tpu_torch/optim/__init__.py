"""Serving of the port (counterparts of ``bigdl_tpu.optim``'s services)."""

from bigdl_tpu_torch.optim.generation_service import GenerationService

__all__ = ["GenerationService"]
