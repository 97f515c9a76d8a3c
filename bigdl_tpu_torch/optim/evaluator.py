"""Model evaluation (port of ``bigdl_tpu/optim/evaluator.py``).

:meth:`Evaluator.test` runs the model's evaluation-mode forward under
``torch.inference_mode`` over the dataset in batches (Samples are
grouped by ``SampleToMiniBatch``, a last partial batch included) and
adds up each validation method's results. Inputs go to the device of
the model's parameters; the model's modes are restored afterwards.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import as_dataset, minibatches
from bigdl_tpu_torch.dataset.prefetch import to_device
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.utils.table import Table


def model_device(model: torch.nn.Module) -> torch.device:
    """The device of ``model``'s first parameter or buffer."""
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    raise ValueError("model has no parameters or buffers to place it")


def no_lone_row(x: np.ndarray) -> np.ndarray:
    """``x`` (a stack of rows) with its one row repeated where it holds
    only one: a layer that infers the batch from the element count
    (LeNet-5's ``Reshape``) takes a stack of one for one unbatched
    sample. The JAX package never gives it one, since it pads every
    batch to one shape for ``jit``; the caller keeps the first
    ``len(x)`` rows of the output."""
    return np.concatenate([x, x]) if len(x) == 1 else x


def batch_to_device(value, device):
    """A batch's input or target (an array or a Table of them) on
    ``device``, the Table structure kept for multi-input models."""
    if isinstance(value, Table):
        return Table(*[to_device(v, device) for v in value])
    return to_device(value, device)


class Evaluator:
    def __init__(self, model: torch.nn.Module):
        self.model = model

    def test(self, dataset, methods: Sequence[ValidationMethod],
             batch_size: Optional[int] = 32
             ) -> List[Tuple[ValidationMethod, ValidationResult]]:
        dev = model_device(self.model)
        results: List[Optional[ValidationResult]] = [None] * len(methods)
        batches = minibatches(as_dataset(dataset), batch_size or 32,
                              train=False, partial_batch=True)
        modes = [(m, m.training) for m in self.model.modules()]
        self.model.eval()
        try:
            with torch.inference_mode():
                for batch in batches:
                    out = self.model(batch_to_device(batch.get_input(), dev))
                    y = batch.get_target()
                    for i, m in enumerate(methods):
                        r = m(out, y)
                        results[i] = r if results[i] is None else results[i] + r
        finally:
            for m, mode in modes:
                m.training = mode
        return [(m, r) for m, r in zip(methods, results) if r is not None]
