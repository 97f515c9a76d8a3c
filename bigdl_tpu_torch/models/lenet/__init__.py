from bigdl_tpu_torch.models.lenet.model import LeNet5

__all__ = ["LeNet5"]
