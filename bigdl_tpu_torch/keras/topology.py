"""Keras Sequential/Model with compile/fit/evaluate/predict (port of
``bigdl_tpu/keras/topology.py``).

Reference: nn/keras/Topology.scala:35-262 — ``compile`` resolves
optimizer/loss/metrics (strings or objects), ``fit`` is sugar over the
port's Optimizer with Trigger.maxEpoch (a ``LocalOptimizer`` on the
in-memory samples), ``evaluate``/``predict`` delegate to the
``Evaluator`` / ``LocalPredictor``. A ``Sequential``'s layers are its
children ``layer0``, ``layer1``, ... and a functional ``Model`` carries
its ``Graph``'s topology, so both round-trip through ``save_module``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.keras.engine import KerasLayer, _infer_output_shape
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.optim import (
    SGD, Adam, Adagrad, Adadelta, Adamax, RMSprop, Top1Accuracy, Top5Accuracy,
    Loss, Trigger,
)
from bigdl_tpu_torch.optim.optimizer import Optimizer

_OPTIMIZERS = {
    "sgd": lambda: SGD(learning_rate=0.01),
    "adam": Adam, "adagrad": Adagrad, "adadelta": Adadelta,
    "adamax": Adamax, "rmsprop": RMSprop,
}

_LOSSES = {
    "categorical_crossentropy": nn.CategoricalCrossEntropy,
    "sparse_categorical_crossentropy": nn.CrossEntropyCriterion,
    "mse": nn.MSECriterion, "mean_squared_error": nn.MSECriterion,
    "mae": nn.AbsCriterion, "mean_absolute_error": nn.AbsCriterion,
    "binary_crossentropy": nn.BCECriterion,
    "hinge": nn.MarginCriterion,
    "poisson": nn.PoissonCriterion,
    "cosine_proximity": nn.CosineProximityCriterion,
    "kullback_leibler_divergence": nn.KullbackLeiblerDivergenceCriterion,
    "mean_absolute_percentage_error": nn.MeanAbsolutePercentageCriterion,
    "mean_squared_logarithmic_error": nn.MeanSquaredLogarithmicCriterion,
}


def _resolve_metric(m):
    if isinstance(m, str):
        m = m.lower()
        if m in ("accuracy", "acc", "top1accuracy"):
            return Top1Accuracy()
        if m in ("top5accuracy", "top5"):
            return Top5Accuracy()
        if m == "loss":
            return Loss()
        raise ValueError(f"unknown metric {m!r}")
    return m


class KerasModel(Module):
    """compile/fit/evaluate/predict mixin over the module tree."""

    def compile(self, optimizer, loss, metrics: Optional[List] = None) -> "KerasModel":
        if isinstance(optimizer, str):
            optimizer = _OPTIMIZERS[optimizer.lower()]()
        if isinstance(loss, str):
            loss = _LOSSES[loss.lower()]()
        self.optim_method = optimizer
        self.criterion = loss
        self.metrics = [_resolve_metric(m) for m in (metrics or [])]
        return self

    # ------------------------------------------------------------------ fit
    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None) -> "KerasModel":
        """x: ndarray (or list of Samples); y: ndarray of targets.
        ≙ KerasModel.fit (Topology.scala:89-108)."""
        if not hasattr(self, "criterion"):
            raise RuntimeError("call compile(...) before fit")
        samples = self._to_samples(x, y)
        opt = Optimizer(model=self, dataset=samples,
                        criterion=self.criterion, batch_size=batch_size,
                        end_when=Trigger.max_epoch(nb_epoch))
        opt.set_optim_method(self.optim_method)
        if validation_data is not None:
            vx, vy = validation_data
            opt.set_validation(Trigger.every_epoch(), self._to_samples(vx, vy),
                               self.metrics or [Top1Accuracy()],
                               batch_size=batch_size)
        opt.optimize()
        return self

    def evaluate(self, x=None, y=None, batch_size: int = 32):
        """Validation metrics on (x, y). With no args: parity with
        Module.evaluate() switching to eval mode."""
        if x is None:
            return super().evaluate()
        from bigdl_tpu_torch.optim.evaluator import Evaluator

        samples = self._to_samples(x, y)
        results = Evaluator(self).test(
            DataSet.array(samples), self.metrics or [Top1Accuracy()],
            batch_size=batch_size)
        return [(m.name(), r.result()[0]) for m, r in results]

    def predict(self, x, batch_size: int = 32):
        from bigdl_tpu_torch.optim.predictor import LocalPredictor

        if isinstance(x, (list, tuple)) and x and isinstance(x[0], Sample):
            samples = list(x)
        else:
            samples = [Sample(np.asarray(xi)) for xi in np.asarray(x)]
        return LocalPredictor(self, batch_size=batch_size).predict(samples)

    def predict_classes(self, x, batch_size: int = 32, zero_based_label: bool = True):
        out = np.asarray(self.predict(x, batch_size=batch_size))
        cls = out.argmax(-1)
        return cls if zero_based_label else cls + 1

    @staticmethod
    def _to_samples(x, y=None):
        if isinstance(x, (list, tuple)) and x and isinstance(x[0], Sample):
            return list(x)
        x = np.asarray(x)
        if y is None:
            return [Sample(xi) for xi in x]
        y = np.asarray(y)
        return [Sample(x[i], y[i]) for i in range(len(x))]


class Sequential(KerasModel):
    """Keras Sequential: shape-inferred chain (≙ nn/keras/Topology.scala
    Sequential); the layers are the children ``layer0``, ``layer1``, ..."""

    def __init__(self):
        super().__init__()
        self.next_shape = None

    @property
    def _layers(self) -> List[Module]:
        return [m for k, m in self._modules.items() if k.startswith("layer")]

    def add(self, layer) -> "Sequential":
        if not self._layers:
            shape = getattr(layer, "input_shape", None)
            if shape is None:
                raise ValueError("first layer needs input_shape=...")
            self.next_shape = tuple(shape)
        if isinstance(layer, KerasLayer):
            self.next_shape = layer.build(self.next_shape)
        else:
            # plain nn.Module: advance the inferred shape chain generically
            self.next_shape = _infer_output_shape(layer, self.next_shape)
        setattr(self, f"layer{len(self._layers)}", layer)
        return self

    def get_output_shape(self):
        return self.next_shape

    def forward(self, input):
        x = input
        for l in self._layers:
            x = l(x)
        return x


class Model(KerasModel):
    """Functional keras Model over graph Nodes: reuse the Graph engine
    (layers are plain nn modules or built keras layers wired with
    ``.inputs``; ≙ nn/keras Model)."""

    def __init__(self, input, output):
        super().__init__()
        self.graph = nn.Graph(input, output)

    def __serialize_spec__(self, ser_module, ser_tensor):
        return {"graph": ser_module(self.graph)}

    @classmethod
    def __deserialize_spec__(cls, spec, get_module, get_tensor):
        graph = get_module(spec["graph"])
        return cls(graph.input_nodes if len(graph.input_nodes) > 1
                   else graph.input_nodes[0],
                   graph.output_nodes if len(graph.output_nodes) > 1
                   else graph.output_nodes[0])

    def forward(self, input):
        return self.graph(input)
