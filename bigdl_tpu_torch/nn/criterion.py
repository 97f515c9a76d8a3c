"""Loss functions (port of the 38 criterions of
``bigdl_tpu/nn/criterion.py``).

Kept from the JAX package, where PyTorch's habits differ:

- class targets are **1-based** (labels 1..n_classes, as in BigDL);
  a target equal to ``padding_value`` (-1) marks a padding row, which
  counts neither in the loss nor in its normalizer;
- the loss is computed in the input's dtype: ``log_softmax`` runs on
  bf16 logits and the NLL sums and normalizes in bf16 (with class
  ``weights``, which stay f32, the weighted sums promote to f32 as in
  the JAX package);
- ``size_average`` divides by the summed target weights of the valid
  rows, not by the row count.

``forward(input, target) -> scalar``; ``backward`` is the gradient of
the summed ``forward`` in ``input`` through autograd, shaped as the
input (a Table input gets a Table of gradients). Every criterion
reduces as its JAX twin: ``size_average`` means a mean where the JAX
package takes one (and, for the NLL, the summed target weights).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import activity_tensors, with_tensors
from bigdl_tpu_torch.utils.config_capture import ConfigCaptured
from bigdl_tpu_torch.utils.table import Table

__all__ = ["AbsCriterion", "ActivityRegularization", "BCECriterion",
           "CategoricalCrossEntropy", "ClassNLLCriterion",
           "ClassSimplexCriterion", "CosineDistanceCriterion",
           "CosineEmbeddingCriterion", "CosineProximityCriterion",
           "Criterion", "CrossEntropyCriterion", "DiceCoefficientCriterion",
           "DistKLDivCriterion", "DotProductCriterion", "GaussianCriterion",
           "HingeEmbeddingCriterion", "KLDCriterion",
           "KullbackLeiblerDivergenceCriterion", "L1Cost",
           "L1HingeEmbeddingCriterion", "MSECriterion", "MarginCriterion",
           "MarginRankingCriterion", "MeanAbsolutePercentageCriterion",
           "MeanSquaredLogarithmicCriterion", "MultiCriterion",
           "MultiLabelMarginCriterion", "MultiLabelSoftMarginCriterion",
           "MultiMarginCriterion", "PGCriterion", "ParallelCriterion",
           "PoissonCriterion", "SmoothL1Criterion",
           "SmoothL1CriterionWithWeights", "SoftMarginCriterion",
           "SoftmaxWithCriterion", "TimeDistributedCriterion",
           "TimeDistributedMaskCriterion", "TransformerCriterion"]


class Criterion(ConfigCaptured):
    """Base: ``forward(input, target) -> scalar``."""

    def __init__(self):
        self.output = None
        self.grad_input = None
        self.size_average = True

    def forward(self, input, target):
        raise NotImplementedError

    def __call__(self, input, target):
        self.output = self.forward(input, target)
        return self.output

    def backward(self, input, target):
        """d sum(forward) / d input, shaped as ``input``."""
        xs = [x.detach().requires_grad_(x.is_floating_point())
              for x in activity_tensors(input)]
        wrt = [x for x in xs if x.requires_grad]
        with torch.enable_grad():
            loss = self.forward(with_tensors(input, iter(xs)), target)
            grads = torch.autograd.grad(torch.as_tensor(loss).sum(), wrt,
                                        allow_unused=True)
        by_id = {id(x): g for x, g in zip(wrt, grads)}
        self.grad_input = with_tensors(input, iter(
            torch.zeros_like(x) if by_id.get(id(x)) is None
            else by_id[id(x)] for x in xs))
        return self.grad_input


def _reduce(x, size_average: bool):
    return x.mean() if size_average else x.sum()


def _as(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (an array, tensor or number) as a tensor on ``like``'s
    device; floats take ``like``'s dtype."""
    t = torch.as_tensor(value, device=like.device)
    return t.to(like.dtype) if t.is_floating_point() else t


def _weights(weights):
    return (None if weights is None
            else torch.as_tensor(np.asarray(weights), dtype=torch.float32))


class ClassNLLCriterion(Criterion):
    """NLL over log-probabilities (``log_prob_as_input``, the pairing
    with LogSoftMax; else probabilities, logged with a 1e-8 floor) with
    1-based integer targets, optional per-class ``weights``."""

    def __init__(self, weights=None, size_average: bool = True,
                 log_prob_as_input: bool = True, padding_value: int = -1):
        super().__init__()
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=torch.float32))
        self.size_average = size_average
        self.log_prob_as_input = log_prob_as_input
        self.padding_value = padding_value

    def _target_mask_weights(self, logp, target):
        """(logp2d, valid mask, 0-based class index, per-row target
        weight times the mask): the one place that owns the padding and
        weight contract."""
        target = torch.as_tensor(target, device=logp.device)
        if logp.dim() == 1:
            logp = logp[None]
        t = target.reshape(-1).long()
        logp2 = logp.reshape(t.shape[0], -1)
        valid = t != self.padding_value
        idx = (t - 1).clamp(0, logp2.shape[-1] - 1)
        w = (torch.ones(t.shape, dtype=logp2.dtype, device=logp2.device)
             if self.weights is None
             else self.weights.to(logp2.device)[idx])
        w = w * valid.to(logp2.dtype)
        return logp2, valid, idx, w

    def forward(self, input, target):
        logp = input if self.log_prob_as_input else torch.log(input + 1e-8)
        logp2, _, idx, w = self._target_mask_weights(logp, target)
        picked = logp2.gather(-1, idx[:, None])[:, 0]
        loss = -(w * picked).sum()
        if self.size_average:
            loss = loss / w.sum().clamp_min(1e-8)
        return loss


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL fused. ``label_smoothing`` mixes the one-hot
    target with the uniform distribution, ``(1 - eps) * NLL + eps *
    mean_c(-logp_c)``, the eps/C mass on class c carrying that class's
    weight, padding rows masked, normalized as the NLL."""

    def __init__(self, weights=None, size_average: bool = True,
                 label_smoothing: float = 0.0):
        super().__init__()
        if not 0.0 <= label_smoothing < 1.0:
            raise ValueError(f"label_smoothing must be in [0, 1), got "
                             f"{label_smoothing}")
        self.label_smoothing = label_smoothing
        self.size_average = size_average
        self.nll = ClassNLLCriterion(weights, size_average,
                                     log_prob_as_input=True)

    def forward(self, input, target):
        logp = torch.log_softmax(input, -1)
        loss = self.nll.forward(logp, target)
        if self.label_smoothing:
            nll = self.nll
            logp2, valid, _, w_t = nll._target_mask_weights(logp, target)
            n_cls = logp2.shape[-1]
            class_w = (torch.ones(n_cls, dtype=logp2.dtype,
                                  device=logp2.device)
                       if nll.weights is None
                       else nll.weights.to(logp2.device, logp2.dtype))
            row = -(logp2 * class_w[None]).sum(-1) / n_cls
            uniform = (row * valid.to(logp2.dtype)).sum()
            if self.size_average:
                uniform = uniform / w_t.sum().clamp_min(1e-8)
            loss = ((1.0 - self.label_smoothing) * loss
                    + self.label_smoothing * uniform)
        return loss


class CategoricalCrossEntropy(Criterion):
    """Cross entropy of one-hot targets over probabilities."""

    def forward(self, input, target):
        logp = torch.log(input.clamp(1e-8, 1.0))
        return -(_as(target, input) * logp).sum(-1).mean()


class MSECriterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce((input - _as(target, input)) ** 2, self.size_average)


class AbsCriterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce((input - _as(target, input)).abs(), self.size_average)


class BCECriterion(Criterion):
    """Binary cross entropy over probabilities, clamped to [eps, 1 - eps]
    of the input's dtype (the JAX package's guard against log(0))."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def forward(self, input, target):
        eps = torch.finfo(input.dtype).eps
        x = input.clamp(eps, 1.0 - eps)
        t = _as(target, input)
        loss = -(t * torch.log(x) + (1.0 - t) * torch.log(1.0 - x))
        if self.weights is not None:
            loss = loss * self.weights.to(input.device)
        return _reduce(loss, self.size_average)


class SmoothL1Criterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        d = (input - _as(target, input)).abs()
        loss = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
        return _reduce(loss, self.size_average)


class DistKLDivCriterion(Criterion):
    """KL(target || input) with the input in log-probabilities; with
    ``size_average`` on a batch, the mean over rows of the row sums."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        t = _as(target, input)
        loss = torch.where(t > 0, t * (torch.log(t.clamp_min(1e-12))
                                       - input), torch.zeros_like(input))
        if self.size_average and input.dim() > 1:
            return loss.sum(-1).mean()
        return loss.sum()


class KLDCriterion(Criterion):
    """KL(q(z|x) || N(0, 1)) of a VAE; input Table(mean, log_var)."""

    def forward(self, input, target=None):
        mean, log_var = input[1], input[2]
        kl = 0.5 * (mean ** 2 + torch.exp(log_var) - 1.0 - log_var).sum(-1)
        return kl.mean()


class GaussianCriterion(Criterion):
    """-log N(target; mean, exp(log_var)); input Table(mean, log_var)."""

    def forward(self, input, target):
        mean, log_var = input[1], input[2]
        t = _as(target, mean)
        nll = 0.5 * (log_var + (t - mean) ** 2 / torch.exp(log_var)
                     + math.log(2 * math.pi))
        return nll.sum()


class MarginCriterion(Criterion):
    """Hinge loss with targets +-1; ``squared`` gives the L2-SVM."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        super().__init__()
        self.margin = margin
        self.size_average = size_average
        self.squared = squared

    def forward(self, input, target):
        loss = (self.margin - input * _as(target, input)).clamp_min(0.0)
        if self.squared:
            loss = loss * loss
        return _reduce(loss, self.size_average)


class HingeEmbeddingCriterion(Criterion):
    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        loss = torch.where(_as(target, input) > 0, input,
                           (self.margin - input).clamp_min(0.0))
        return _reduce(loss, self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """Hinge on the L1 distance of a Table pair."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = margin

    def forward(self, input, target):
        d = (input[1] - input[2]).abs().sum()
        return torch.where(_as(target, d) > 0, d,
                           (self.margin - d).clamp_min(0.0))


def _cosine(a, b):
    return (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1)
                              * torch.linalg.norm(b, dim=-1)).clamp_min(1e-12)


class CosineEmbeddingCriterion(Criterion):
    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        cos = _cosine(input[1], input[2])
        t = _as(target, cos)
        t = t.reshape(cos.shape) if t.dim() else t
        loss = torch.where(t > 0, 1.0 - cos,
                           (cos - self.margin).clamp_min(0.0))
        return _reduce(loss, self.size_average)


class MarginRankingCriterion(Criterion):
    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        x1, x2 = input[1], input[2]
        y = _as(target[1] if isinstance(target, Table) else target, x1)
        loss = (-y * (x1 - x2) + self.margin).clamp_min(0.0)
        return _reduce(loss, self.size_average)


class MultiMarginCriterion(Criterion):
    """Multiclass hinge over 1-based targets."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__()
        self.p, self.margin = p, margin
        self.weights = _weights(weights)
        self.size_average = size_average

    def forward(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = torch.as_tensor(target, device=x.device).reshape(-1).long() - 1
        correct = x.gather(-1, t[:, None])
        loss = (self.margin - correct + x).clamp_min(0.0) ** self.p
        if self.weights is not None:
            loss = loss * self.weights.to(x.device)[t][:, None]
        mask = F.one_hot(t, x.shape[-1]).to(x.dtype)
        per_sample = (loss * (1.0 - mask)).sum(-1) / x.shape[-1]
        return _reduce(per_sample, self.size_average)


class MultiLabelMarginCriterion(Criterion):
    """Multi-label hinge: targets hold 1-based labels, 0 ends a row's
    list."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = torch.as_tensor(target, device=x.device)
        t = (t if t.dim() == 2 else t[None]).long()
        n, c = x.shape
        is_label = torch.zeros((n, c), dtype=torch.bool, device=x.device)
        for j in range(t.shape[1]):
            idx = (t[:, j] - 1).clamp(0, c - 1)
            is_label = is_label | (F.one_hot(idx, c).bool()
                                   & (t[:, j] > 0)[:, None])
        inf = torch.full_like(x, math.inf)
        pos = torch.where(is_label, x, inf)[:, :, None]
        neg = torch.where(is_label, -inf, x)[:, None, :]
        margin = (1.0 - (pos - neg)).clamp_min(0.0)
        margin = torch.where(torch.isfinite(margin), margin,
                             torch.zeros_like(margin))
        per_sample = margin.sum((1, 2)) / c
        return _reduce(per_sample, self.size_average)


class MultiLabelSoftMarginCriterion(Criterion):
    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def forward(self, input, target):
        t = _as(target, input)
        loss = F.softplus(-input) * t + F.softplus(input) * (1 - t)
        if self.weights is not None:
            loss = loss * self.weights.to(input.device)
        return _reduce(loss.mean(-1), self.size_average)


class SoftMarginCriterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce(F.softplus(-input * _as(target, input)),
                       self.size_average)


class L1Cost(Criterion):
    def forward(self, input, target=None):
        return input.abs().sum()


class DotProductCriterion(Criterion):
    def __init__(self, size_average: bool = False):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        dot = (input * _as(target, input)).sum()
        if self.size_average and input.dim() > 1:
            dot = dot / input.shape[0]
        return dot


class CosineDistanceCriterion(Criterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce(1.0 - _cosine(input, _as(target, input)),
                       self.size_average)


class CosineProximityCriterion(Criterion):
    def forward(self, input, target):
        t = _as(target, input)
        xn = input / torch.linalg.norm(input, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
        tn = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-12)
        return -(xn * tn).sum(-1).mean()


class PoissonCriterion(Criterion):
    def forward(self, input, target):
        return (input - _as(target, input) * torch.log(input + 1e-8)).mean()


class MeanAbsolutePercentageCriterion(Criterion):
    def forward(self, input, target):
        t = _as(target, input)
        return 100.0 * ((t - input).abs() / t.abs().clamp_min(1e-7)).mean()


class MeanSquaredLogarithmicCriterion(Criterion):
    def forward(self, input, target):
        a = torch.log(input.clamp_min(1e-7) + 1.0)
        b = torch.log(_as(target, input).clamp_min(1e-7) + 1.0)
        return ((a - b) ** 2).mean()


class KullbackLeiblerDivergenceCriterion(Criterion):
    def forward(self, input, target):
        t = _as(target, input).clamp(1e-7, 1.0)
        x = input.clamp(1e-7, 1.0)
        return (t * torch.log(t / x)).sum(-1).mean()


class DiceCoefficientCriterion(Criterion):
    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, input, target):
        x = input.reshape(input.shape[0], -1)
        t = _as(target, input).reshape(x.shape[0], -1)
        inter = (x * t).sum(-1)
        union = x.sum(-1) + t.sum(-1)
        return (1.0 - (2.0 * inter + self.epsilon)
                / (union + self.epsilon)).mean()


class ClassSimplexCriterion(Criterion):
    """MSE against the simplex embedding of 1-based class targets (the
    JAX package's centered scaled identity)."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        a = np.eye(n_classes, dtype=np.float32)
        if n_classes > 1:
            a = a * np.sqrt(n_classes / (n_classes - 1.0))
        mean = a.mean(axis=0, keepdims=True)
        self.simplex = torch.from_numpy(a - mean + mean * 0)
        self.mse = MSECriterion()

    def forward(self, input, target):
        t = torch.as_tensor(target, device=input.device).reshape(-1).long() - 1
        return self.mse.forward(input, self.simplex.to(input.device)[t])


class ParallelCriterion(Criterion):
    """Weighted sum of criterions, the i-th on the i-th entries of a
    Table input and target (the whole target with ``repeat_target``)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.criterions = []
        self.weights = []
        self.repeat_target = repeat_target

    def add(self, criterion: Criterion, weight: float = 1.0
            ) -> "ParallelCriterion":
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        ins = list(input)
        tgts = [target] * len(ins) if self.repeat_target else list(target)
        total = 0.0
        for c, w, x, t in zip(self.criterions, self.weights, ins, tgts):
            total = total + w * c.forward(x, t)
        return total


class MultiCriterion(Criterion):
    """Weighted sum of criterions on the same input and target."""

    def __init__(self):
        super().__init__()
        self.criterions = []
        self.weights = []

    def add(self, criterion: Criterion, weight: float = 1.0
            ) -> "MultiCriterion":
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        total = 0.0
        for c, w in zip(self.criterions, self.weights):
            total = total + w * c.forward(input, target)
        return total


class TimeDistributedCriterion(Criterion):
    """``critrn`` at every step of the (1-based) ``dimension``, summed,
    or averaged over the steps with ``size_average``."""

    def __init__(self, critrn: Criterion, size_average: bool = False,
                 dimension: int = 2):
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average
        self.dimension = dimension

    def forward(self, input, target):
        ax = self.dimension - 1
        steps = input.shape[ax]
        stepped = hasattr(target, "ndim") and target.ndim > ax
        if stepped:
            target = torch.as_tensor(target, device=input.device)
        total = 0.0
        for i in range(steps):
            t = target.select(ax, i) if stepped else target
            total = total + self.critrn.forward(input.select(ax, i), t)
        return total / steps if self.size_average else total


class PGCriterion(Criterion):
    """Policy gradient: -sum(log(probability of the action) * reward)."""

    def __init__(self, sizeAverage: bool = False):
        super().__init__()

    def forward(self, input, target):
        logp = torch.log(input.clamp(1e-8, 1.0))
        return -(logp * _as(target, input)).sum()


class ActivityRegularization(Criterion):
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        super().__init__()
        self.l1, self.l2 = l1, l2

    def forward(self, input, target=None):
        return (self.l1 * input.abs().sum()
                + self.l2 * (input * input).sum())


class SmoothL1CriterionWithWeights(Criterion):
    """Smooth-L1 with inside and outside weights (the Fast-RCNN box
    loss): target Table(t, w_in, w_out) or a tensor."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__()
        self.sigma2 = sigma * sigma
        self.num = num

    def forward(self, input, target):
        if isinstance(target, Table):
            t, w_in, w_out = (_as(target[i], input) for i in (1, 2, 3))
        else:
            t, w_in, w_out = _as(target, input), 1.0, 1.0
        d = w_in * (input - t)
        ad = d.abs()
        loss = torch.where(ad < 1.0 / self.sigma2, 0.5 * d * d * self.sigma2,
                           ad - 0.5 / self.sigma2)
        loss = (w_out * loss).sum()
        return loss / self.num if self.num > 0 else loss


class SoftmaxWithCriterion(Criterion):
    """Softmax and multinomial logistic loss over score maps: input (N,
    C, [H, W]) raw scores, target (N, [H, W]) 1-based labels;
    ``ignore_label`` entries add nothing; ``normalize_mode`` (VALID,
    FULL, BATCH_SIZE, NONE) picks the normalizer."""

    def __init__(self, ignore_label=None, normalize_mode: str = "VALID"):
        super().__init__()
        if normalize_mode not in ("VALID", "FULL", "BATCH_SIZE", "NONE"):
            raise ValueError(f"bad normalize_mode {normalize_mode!r}")
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def forward(self, input, target):
        x = input
        t = torch.as_tensor(target, device=x.device).long()
        if t.dim() == x.dim():
            t = t.squeeze(1)
        logp = torch.log_softmax(x, dim=1)
        idx = (t - 1).clamp(0, x.shape[1] - 1)
        picked = logp.gather(1, idx[:, None])[:, 0]
        mask = (torch.ones_like(picked, dtype=torch.bool)
                if self.ignore_label is None else t != self.ignore_label)
        loss = -torch.where(mask, picked, torch.zeros_like(picked)).sum()
        if self.normalize_mode == "VALID":
            norm = mask.sum().clamp_min(1)
        elif self.normalize_mode == "FULL":
            norm = picked.numel()
        elif self.normalize_mode == "BATCH_SIZE":
            norm = x.shape[0]
        else:
            norm = 1
        return loss / norm


class TimeDistributedMaskCriterion(Criterion):
    """A time-distributed ClassNLL or MSE that skips the entries whose
    target equals ``padding_value`` and divides by the count of the
    others."""

    def __init__(self, criterion, padding_value: int = 0):
        super().__init__()
        self.criterion = criterion
        self.padding_value = padding_value

    def forward(self, input, target):
        x = input
        t = torch.as_tensor(target, device=x.device)
        if isinstance(self.criterion, ClassNLLCriterion):
            ti = t.long()
            mask = ti != self.padding_value
            idx = (ti - 1).clamp(0, x.shape[-1] - 1)
            picked = x.gather(-1, idx[..., None])[..., 0]
            loss = -torch.where(mask, picked, torch.zeros_like(picked)).sum()
            return loss / mask.sum().clamp_min(1)
        if isinstance(self.criterion, MSECriterion):
            t = t.to(x.dtype)
            mask = t != self.padding_value
            se = torch.where(mask, (x - t) ** 2, torch.zeros_like(x))
            return se.sum() / mask.sum().clamp_min(1)
        raise ValueError(
            "TimeDistributedMaskCriterion supports ClassNLL/MSE inner "
            f"criterions, got {type(self.criterion).__name__}")


class TransformerCriterion(Criterion):
    """``criterion`` on the input and target after their transformers
    (modules); the gradient flows back through the input transformer,
    none through the target's."""

    def __init__(self, criterion, input_transformer=None,
                 target_transformer=None):
        super().__init__()
        self.criterion = criterion
        self.input_transformer = input_transformer
        self.target_transformer = target_transformer

    def _transformed_target(self, target):
        if self.target_transformer is None:
            return target
        with torch.no_grad():
            return self.target_transformer(target)

    def forward(self, input, target):
        x = (self.input_transformer(input) if self.input_transformer
             else input)
        return self.criterion.forward(x, self._transformed_target(target))
