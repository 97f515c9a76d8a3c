"""Models of the port (counterparts of ``bigdl_tpu.models``)."""

from bigdl_tpu_torch.models.autoencoder import Autoencoder
from bigdl_tpu_torch.models.inception import (InceptionV1,
                                              InceptionV1NoAuxClassifier)
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.mobilenet import MobileNetV1
from bigdl_tpu_torch.models.resnet import DatasetType, ResNet, ShortcutType
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.vgg import Vgg16, VggForCifar10

__all__ = ["Autoencoder", "DatasetType", "InceptionV1",
           "InceptionV1NoAuxClassifier", "LeNet5", "MobileNetV1", "ResNet",
           "ShortcutType", "TransformerLM", "Vgg16", "VggForCifar10"]
