"""Batch normalization (port of ``BatchNormalization`` and
``SpatialBatchNormalization`` in ``bigdl_tpu/nn/normalization.py``).

BatchNorm is XLA ops in the JAX package, so it is torch ops here, with
the JAX package's numerics rather than ``F.batch_norm``'s:

- batch statistics in f32 (from ``x.float()``), the biased variance for
  the normalization;
- the running variance takes the unbiased variance, ``n = numel / C``;
  each running statistic moves as ``(1 - momentum) * run + momentum *
  stat`` and keeps its buffer's dtype (f32 statistics stay f32 under
  bf16 compute);
- scale and shift are folded per channel in f32, then applied in the
  input's dtype, so a bf16 activation stays bf16;
- the channel axis is 1 for NCHW (0 unbatched) and last for NHWC;
- in evaluation mode the running statistics normalize.

In training mode the forward assigns new running statistics to its
buffers (never in place), so the train step reads them back from the
model. The JAX package's sync-BN (``global_stats_axis``) belongs to the
distributed slice and is not ported.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.conv import check_format
from bigdl_tpu_torch.nn.module import Module


class BatchNormalization(Module):
    """BN over (batch, feature); ``init_weight`` / ``init_bias`` set
    gamma and beta (default ones and zeros)."""

    n_dim = 2

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None, format: str = "NCHW", *,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.format = check_format(format)
        if affine:
            w = (torch.ones(n_output) if init_weight is None
                 else torch.as_tensor(init_weight, dtype=torch.float32))
            b = (torch.zeros(n_output) if init_bias is None
                 else torch.as_tensor(init_bias, dtype=torch.float32))
            self.new_param("weight", w, dev, dtype)
            self.new_param("bias", b, dev, dtype)
        self.new_buffer("running_mean", torch.zeros(n_output), dev)
        self.new_buffer("running_var", torch.ones(n_output), dev)

    def forward(self, input):
        x = input
        if self.format == "NHWC":
            ch = x.dim() - 1
        else:
            ch = 1 if x.dim() >= self.n_dim else 0
        axes = tuple(i for i in range(x.dim()) if i != ch)
        if self.training:
            var, mean = torch.var_mean(x.float(), dim=axes, correction=0)
            n = x.numel() / x.shape[ch]
            with torch.no_grad():
                unbiased = var * n / max(1.0, n - 1)
                m = self.momentum
                self.running_mean = ((1 - m) * self.running_mean
                                     + m * mean).to(self.running_mean.dtype)
                self.running_var = ((1 - m) * self.running_var
                                    + m * unbiased).to(self.running_var.dtype)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var.float() + self.eps)
        if self.affine:
            scale = self.weight.float() * inv
            shift = self.bias.float() - mean * scale
        else:
            scale = inv
            shift = -mean * inv
        shape = [1] * x.dim()
        shape[ch] = x.shape[ch]
        return (x * scale.reshape(shape).to(x.dtype)
                + shift.reshape(shape).to(x.dtype))


class SpatialBatchNormalization(BatchNormalization):
    """BN per channel over (B, C, H, W), or (B, H, W, C) for NHWC."""

    n_dim = 4
