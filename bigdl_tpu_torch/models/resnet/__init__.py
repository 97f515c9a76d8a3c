from bigdl_tpu_torch.models.resnet.model import DatasetType, ResNet, ShortcutType

__all__ = ["DatasetType", "ResNet", "ShortcutType"]
