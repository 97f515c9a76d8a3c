from bigdl_tpu_torch.models.inception.model import (
    InceptionV1, InceptionV1NoAuxClassifier, inception_layer_v1,
)

__all__ = ["InceptionV1", "InceptionV1NoAuxClassifier", "inception_layer_v1"]
