"""Training and serving of the port (counterparts of ``bigdl_tpu.optim``)."""

from bigdl_tpu_torch.optim.ema import EMA
from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.generation_service import GenerationService
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (
    LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, CosineDecay,
    Default, EpochDecay, EpochSchedule, EpochStep, Exponential, Ftrl,
    LearningRateSchedule, MultiStep, NaturalExp, OptimMethod, ParallelAdam,
    Plateau, Poly, RMSprop, SequentialSchedule, Step, Warmup,
)
from bigdl_tpu_torch.optim.optimizer import (
    LocalOptimizer, Optimizer, TrainStep, load_latest_checkpoint,
    make_train_step,
)
from bigdl_tpu_torch.optim.prediction_service import PredictionService
from bigdl_tpu_torch.optim.predictor import LocalPredictor
from bigdl_tpu_torch.optim.regularizer import (
    L1L2Regularizer, L1Regularizer, L2Regularizer, Regularizer,
)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (
    AUC, MAE, BinaryAccuracy, Loss, Top1Accuracy, Top5Accuracy,
    TreeNNAccuracy, ValidationMethod, ValidationResult,
)

__all__ = ["AUC", "BinaryAccuracy", "MAE", "TreeNNAccuracy", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "CosineDecay",
           "Default", "EMA", "EpochDecay", "EpochSchedule", "EpochStep",
           "Evaluator", "Exponential", "Ftrl", "GenerationService",
           "LBFGS", "LocalPredictor", "ParallelAdam", "PredictionService",
           "RMSprop",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "LearningRateSchedule", "LocalOptimizer", "Loss", "Metrics",
           "MultiStep", "NaturalExp", "OptimMethod", "Optimizer", "Plateau",
           "Poly", "Regularizer", "SGD", "SequentialSchedule", "Step",
           "Top1Accuracy", "Top5Accuracy", "TrainStep", "Trigger",
           "ValidationMethod", "ValidationResult", "Warmup",
           "load_latest_checkpoint", "make_train_step"]
