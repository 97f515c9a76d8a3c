"""Training and serving of the port (counterparts of ``bigdl_tpu.optim``)."""

from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.generation_service import GenerationService
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (
    SGD, Adam, AdamW, CosineDecay, Default, EpochSchedule,
    EpochStep, Exponential, LearningRateSchedule, MultiStep, NaturalExp,
    OptimMethod, Plateau, Poly, SequentialSchedule, Step, Warmup,
)
from bigdl_tpu_torch.optim.optimizer import (
    LocalOptimizer, Optimizer, TrainStep, make_train_step,
)
from bigdl_tpu_torch.optim.regularizer import (
    L1L2Regularizer, L1Regularizer, L2Regularizer, Regularizer,
)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (
    Loss, Top1Accuracy, Top5Accuracy, ValidationMethod, ValidationResult,
)

__all__ = ["Adam", "AdamW", "CosineDecay", "Default", "EpochSchedule",
           "EpochStep", "Evaluator", "Exponential", "GenerationService",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "LearningRateSchedule", "LocalOptimizer", "Loss", "Metrics",
           "MultiStep", "NaturalExp", "OptimMethod", "Optimizer", "Plateau",
           "Poly", "Regularizer", "SGD", "SequentialSchedule", "Step",
           "Top1Accuracy", "Top5Accuracy", "TrainStep", "Trigger",
           "ValidationMethod", "ValidationResult", "Warmup",
           "make_train_step"]
