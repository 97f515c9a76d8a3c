"""Loss functions (port of ``Criterion``, ``ClassNLLCriterion`` and
``CrossEntropyCriterion`` in ``bigdl_tpu/nn/criterion.py``).

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
``forward`` in ``input`` through autograd.
"""

from __future__ import annotations

import torch


class Criterion:
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
        """d forward / d input."""
        x = input.detach().requires_grad_(True)
        with torch.enable_grad():
            (self.grad_input,) = torch.autograd.grad(
                self.forward(x, target).sum(), x)
        return self.grad_input


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
