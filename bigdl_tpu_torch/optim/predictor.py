"""Local inference over a dataset (port of ``LocalPredictor`` in
``bigdl_tpu/optim/predictor.py``).

Samples are grouped by the port's ``SampleToMiniBatch`` with a last
partial batch (MiniBatches pass as they are); each batch runs the
model's evaluation-mode forward under ``torch.inference_mode`` on the
device of its parameters, a Table input keeping its structure, and
comes back to the host one row per sample. ``predict_class`` is
1-based, as in BigDL.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import as_dataset, minibatches
from bigdl_tpu_torch.optim.evaluator import batch_to_device, model_device


def _host(out) -> np.ndarray:
    out = out.detach()
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.cpu().numpy()


class LocalPredictor:
    def __init__(self, model: torch.nn.Module, batch_size: int = 32):
        self.model = model
        self.batch_size = batch_size

    def predict(self, dataset) -> List[np.ndarray]:
        """The model's output for every record, in order, one host array
        per record."""
        dev = model_device(self.model)
        modes = [(m, m.training) for m in self.model.modules()]
        self.model.eval()
        outs: List[np.ndarray] = []
        try:
            with torch.inference_mode():
                for batch in minibatches(as_dataset(dataset),
                                         self.batch_size, train=False,
                                         partial_batch=True):
                    out = _host(self.model(batch_to_device(
                        batch.get_input(), dev)))
                    outs.extend(out[i] for i in range(out.shape[0]))
        finally:
            for m, mode in modes:
                m.training = mode
        return outs

    def predict_class(self, dataset) -> np.ndarray:
        """1 + the argmax of each record's output."""
        return np.asarray([int(np.argmax(p)) + 1
                           for p in self.predict(dataset)])
