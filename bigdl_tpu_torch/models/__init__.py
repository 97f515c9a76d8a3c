"""Models of the port (counterparts of ``bigdl_tpu.models``)."""

from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import DatasetType, ResNet, ShortcutType
from bigdl_tpu_torch.models.transformer import TransformerLM

__all__ = ["DatasetType", "LeNet5", "ResNet", "ShortcutType",
           "TransformerLM"]
