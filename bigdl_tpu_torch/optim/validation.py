"""Validation methods with mergeable results (port of ``Top1Accuracy``,
``Top5Accuracy``, ``Loss``, ``MAE``, ``TreeNNAccuracy``,
``BinaryAccuracy`` and ``AUC`` in ``bigdl_tpu/optim/validation.py``).

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


class MAE(ValidationMethod):
    """Mean absolute error: the batch's summed |output - target| over
    one record's element count, counted as one batch of records."""

    def __call__(self, output, target):
        out, t = _numpy(output), _numpy(target)
        n = out.shape[0] if out.ndim else 1
        return LossResult(float(np.sum(np.abs(out - t))
                                / max(out[0].size, 1)), n)


class TreeNNAccuracy(ValidationMethod):
    """Accuracy at the root (first node) of a tree model's output
    (batch, n_nodes, n_classes) against ``target[:, 0]`` (a (n_nodes,
    n_classes) output is one tree): the 1-based argmax, or, for a single
    logit, 1 where it is at least 0.5 and 0 below."""

    def __call__(self, output, target):
        out, tgt = _numpy(output), _numpy(target)
        if out.ndim == 3:
            root = out[:, 0]
            t = tgt[:, 0] if tgt.ndim > 1 else tgt
        elif out.ndim == 2:
            root = out[0][None]
            t = np.asarray([tgt.reshape(-1)[0]])
        else:
            raise ValueError(f"unexpected output rank {out.ndim}")
        if root.shape[-1] == 1:
            pred = (root[:, 0] >= 0.5).astype(np.int64)
        else:
            pred = np.argmax(root, axis=-1) + 1
        return AccuracyResult(int(np.sum(pred == t.astype(np.int64))),
                              root.shape[0])


class BinaryAccuracy(ValidationMethod):
    """Accuracy of scores thresholded at ``threshold`` against {0, 1}
    targets (binarized at 0.5)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def __call__(self, output, target):
        pred = _numpy(output).reshape(-1) > self.threshold
        want = _numpy(target).reshape(-1) > 0.5
        return AccuracyResult(int((pred == want).sum()), pred.size)

    def name(self):
        return "BinaryAccuracy"


class AUCResult(ValidationResult):
    """ROC AUC from fixed-bin score histograms of the positives and the
    negatives, which add across batches (an exact pairwise AUC does
    not)."""

    def __init__(self, pos_hist, neg_hist):
        self.pos_hist = np.asarray(pos_hist, np.int64)
        self.neg_hist = np.asarray(neg_hist, np.int64)

    def result(self):
        p, n = self.pos_hist.sum(), self.neg_hist.sum()
        if p == 0 or n == 0:
            return (0.5, int(p + n))
        pos_above = p - np.cumsum(self.pos_hist)
        # a negative in bin i is beaten by the positives of higher bins;
        # ties (the same bin) count half
        wins = (self.neg_hist * (pos_above + 0.5 * self.pos_hist)).sum()
        return (float(wins / (p * n)), int(p + n))

    def __add__(self, other):
        return AUCResult(self.pos_hist + other.pos_hist,
                         self.neg_hist + other.neg_hist)

    def __repr__(self):
        auc, n = self.result()
        return f"AUC(auc: {auc:.4f}, count: {n})"


class AUC(ValidationMethod):
    """Area under the ROC curve of scores in [0, 1] (clipped), from
    ``n_bins`` histogram bins; targets above 0.5 are the positives.
    Raises on a non-finite score."""

    def __init__(self, n_bins: int = 1000):
        self.n_bins = n_bins

    def __call__(self, output, target):
        scores = _numpy(output).astype(np.float64).reshape(-1)
        if not np.isfinite(scores).all():
            raise ValueError(
                "AUC got non-finite scores (diverged model?); refusing to "
                "bin NaN/inf")
        scores = np.clip(scores, 0, 1)
        labels = _numpy(target).reshape(-1) > 0.5
        bins = np.minimum((scores * self.n_bins).astype(np.int64),
                          self.n_bins - 1)
        pos = np.bincount(bins[labels], minlength=self.n_bins)
        neg = np.bincount(bins[~labels], minlength=self.n_bins)
        return AUCResult(pos, neg)

    def name(self):
        return "AUC"
