"""Train from an UNFROZEN TF graphdef: variables become trainable params
(port of ``bigdl_tpu/utils/tf_session.py``).

Reference: utils/tf/Session.scala:54-330 (BigDLSessionImpl.train): loads a
TF training graph, turns VariableV2 nodes + their Assign initializers into
BigDL weights, and drives the standard Optimizer against a chosen loss
endpoint.

``TensorflowLoader`` resolves each VariableV2's initial value from its
``Assign(var, Const)`` initializer (the tf.compat.v1 initializer pattern);
the variable becomes an ``nn.tf_ops.Variable`` whose ``value`` is a
trainable parameter of the imported Graph on ``device``, so the whole
model trains under the port's ``Optimizer`` (a ``LocalOptimizer`` on an
in-memory dataset). The optimizer writes its result back into the same
``Parameter`` objects, so ``Session._loader.variables`` show the trained
values.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.tf_import import TensorflowLoader


class Session:
    """≙ BigDLSessionImpl (utils/tf/Session.scala:54). ``inputs`` are
    placeholder names; ``outputs`` the prediction endpoint(s). The model
    lives on ``device`` (default the card); ``predict`` runs there."""

    def __init__(self, graph_pb_path: str, inputs: List[str],
                 outputs: List[str], *, device=DEFAULT_DEVICE):
        self._loader = TensorflowLoader(graph_pb_path, device=device)
        self.model: Module = self._loader.load(list(inputs), list(outputs))
        self.device = self._loader.device

    def train(self, dataset, criterion, optim_method: Optional[OptimMethod] = None,
              end_when: Optional[Trigger] = None, batch_size: int = 32) -> Module:
        """≙ Session.train(endpoints, rdd, optMethod, criterion, endTrigger):
        imported variables update in place on the returned model."""
        from bigdl_tpu_torch.optim.optimizer import Optimizer

        opt = Optimizer(model=self.model, dataset=dataset,
                        criterion=criterion, batch_size=batch_size,
                        end_when=end_when or Trigger.max_epoch(1))
        opt.set_optim_method(optim_method or SGD())
        return opt.optimize()

    def predict(self, x):
        """The model's output for ``x`` (moved to the session's device)."""
        self.model.evaluate()
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        with torch.no_grad():
            return self.model(x.to(self.device))
