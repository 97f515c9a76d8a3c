"""Validation methods with mergeable results (port of ``Top1Accuracy``,
``Top5Accuracy`` and ``Loss`` in ``bigdl_tpu/optim/validation.py``).

Each method maps (output, target) of one batch to a result that adds to
the results of other batches. Class targets and predictions are 1-based.
Outputs and targets may be tensors (on any device) or numpy arrays; the
accuracies count on the host, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


class ValidationResult:
    def result(self):
        """(value, count)."""
        raise NotImplementedError

    def __add__(self, other: "ValidationResult") -> "ValidationResult":
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: int, count: int):
        self.correct = int(correct)
        self.count = int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        acc, n = self.result()
        return f"Accuracy(correct: {self.correct}, count: {n}, accuracy: {acc})"


class LossResult(ValidationResult):
    def __init__(self, loss: float, count: int):
        self.loss = float(loss)
        self.count = int(count)

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        avg, n = self.result()
        return f"Loss(loss: {self.loss}, count: {n}, average: {avg})"


class ValidationMethod:
    def __call__(self, output, target) -> ValidationResult:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


def _class_targets(target) -> np.ndarray:
    return _numpy(target).reshape(-1).astype(np.int64)


def _rows(output) -> np.ndarray:
    out = _numpy(output)
    return out[None] if out.ndim == 1 else out


class Top1Accuracy(ValidationMethod):
    def __call__(self, output, target):
        out, t = _rows(output), _class_targets(target)
        pred = np.argmax(out, axis=-1) + 1
        return AccuracyResult(int(np.sum(pred == t)), t.shape[0])


class Top5Accuracy(ValidationMethod):
    def __call__(self, output, target):
        out, t = _rows(output), _class_targets(target)
        top5 = np.argsort(out, axis=-1)[:, -5:] + 1
        correct = int(np.sum(np.any(top5 == t[:, None], axis=-1)))
        return AccuracyResult(correct, t.shape[0])


class Loss(ValidationMethod):
    """The criterion's loss over the validation set (default
    ``ClassNLLCriterion``), averaged over the records."""

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion

        self.criterion = (criterion if criterion is not None
                          else ClassNLLCriterion())

    def __call__(self, output, target):
        t = _numpy(target)
        n = int(t.reshape(-1).shape[0]) if t.ndim else 1
        output = torch.as_tensor(output)
        loss = float(self.criterion.forward(
            output, torch.as_tensor(t, device=output.device)))
        return LossResult(loss * n, n)

    def name(self):
        return "Loss"
