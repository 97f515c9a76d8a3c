from bigdl_tpu_torch.models.vgg.model import Vgg16, VggForCifar10

__all__ = ["Vgg16", "VggForCifar10"]
