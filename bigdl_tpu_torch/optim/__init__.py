"""Training and serving of the port (counterparts of ``bigdl_tpu.optim``)."""

from bigdl_tpu_torch.optim.generation_service import GenerationService
from bigdl_tpu_torch.optim.optim_method import (
    SGD, Adam, AdamW, CosineDecay, Default, EpochSchedule,
    EpochStep, Exponential, LearningRateSchedule, MultiStep, NaturalExp,
    OptimMethod, Plateau, Poly, SequentialSchedule, Step, Warmup,
)
from bigdl_tpu_torch.optim.optimizer import TrainStep, make_train_step
from bigdl_tpu_torch.optim.regularizer import (
    L1L2Regularizer, L1Regularizer, L2Regularizer, Regularizer,
)

__all__ = ["Adam", "AdamW", "CosineDecay", "Default", "EpochSchedule",
           "EpochStep", "Exponential", "GenerationService",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "LearningRateSchedule", "MultiStep", "NaturalExp", "OptimMethod",
           "Plateau", "Poly", "Regularizer", "SGD", "SequentialSchedule",
           "Step", "TrainStep", "Warmup", "make_train_step"]
