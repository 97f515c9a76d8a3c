from bigdl_tpu_torch.dlframes.dlframes import (
    DLClassifier, DLClassifierModel, DLEstimator, DLImageReader, DLModel,
)

__all__ = ["DLEstimator", "DLModel", "DLClassifier", "DLClassifierModel",
           "DLImageReader"]
