"""Normalization layers (port of ``bigdl_tpu/nn/normalization.py``:
``BatchNormalization``, ``SpatialBatchNormalization``,
``VolumetricBatchNormalization``, ``Normalize``, ``NormalizeScale``, the
two LRNs and the subtractive, divisive and contrastive normalizations).

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
model. Sync-BN: ``global_stats_axis`` names an axis of
``Engine.default_mesh()`` (or tuple of axes), and the batch statistics
are those of the global batch over its ranks, as JAX's ``pmean`` gives
them: the mean and E[x - mean]^2 + mean^2 are averaged over the group
(``parallel/collectives.py::pmean``, differentiable, so the backward
sees the global statistics), the variance is the average second moment
less the squared global mean, and the unbiased count is the global n.

The LRNs, as in the JAX package, sum the squares over a window padded
with ``(size - 1) // 2`` zeros before and ``size - 1 - (size - 1) // 2``
after (``F.local_response_norm`` pads ``size // 2`` before, which
differs for an even ``size``), and compute ``(k + alpha / size *
sum) ** beta`` in the input's dtype. The window sums are
``F.avg_pool2d`` with a divisor of 1 over the padded squares (across
channels: a (size, 1) window over each image's (C, H * W) plane). The
subtractive normalization's kernel is a plain tensor on the
layer's device (not a buffer: the JAX layer keeps it outside its
``buffers_dict`` too).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.conv import check_format
from bigdl_tpu_torch.nn.module import Module


class BatchNormalization(Module):
    """BN over (batch, feature); ``init_weight`` / ``init_bias`` set
    gamma and beta (default ones and zeros)."""

    n_dim = 2

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None,
                 global_stats_axis: str = None, format: str = "NCHW", *,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.global_stats_axis = global_stats_axis
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
            if self.global_stats_axis is not None:
                from bigdl_tpu_torch.parallel import collectives as C

                # the global variance needs the spread of the per-rank
                # means too: E[x^2] - E[x]^2 over the whole batch
                axis = self.global_stats_axis
                mean_g = C.pmean(mean, axis)
                var = C.pmean(var + mean ** 2, axis) - mean_g ** 2
                mean = mean_g
                n = n * C.group_size(axis)
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


class VolumetricBatchNormalization(BatchNormalization):
    """BN per channel over (B, C, D, H, W)."""

    n_dim = 5


def _feature_axis(input) -> int:
    return 1 if input.dim() > 1 else 0


class Normalize(Module):
    """Lp-normalize along the feature dim (1, or 0 for 1-D input):
    ``x / (||x||_p + eps)``, the max norm for ``p = inf``."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10):
        super().__init__()
        self.p = p
        self.eps = eps

    def forward(self, input):
        ax = _feature_axis(input)
        if self.p == float("inf"):
            norm = input.abs().amax(dim=ax, keepdim=True)
        else:
            norm = (input.abs() ** self.p).sum(dim=ax, keepdim=True) \
                ** (1.0 / self.p)
        return input / (norm + self.eps)


class NormalizeScale(Module):
    """L_p-normalize over dim 1, then multiply by a learned ``weight`` of
    ``size`` (filled with ``scale``; SSD's layer)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10, scale: float = 1.0,
                 size=None, w_regularizer=None, *, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        super().__init__()
        self.p, self.eps = p, eps
        size = tuple(size) if size is not None else (1,)
        self.new_param("weight", torch.full(size, float(scale)),
                       resolve_device(device), dtype, w_regularizer)

    def forward(self, input):
        norm = (input.abs() ** self.p).sum(dim=1, keepdim=True) \
            ** (1.0 / self.p)
        return input / (norm + self.eps) * self.weight


def _window(size: int):
    """(low, high) zero padding of a ``size`` window, as the JAX LRNs pad."""
    half = (size - 1) // 2
    return half, size - 1 - half


def _batched(fn, input):
    """``fn`` over a 4-D view of a 3-D (unbatched) or 4-D input."""
    if input.dim() == 3:
        return fn(input[None])[0]
    return fn(input)


class SpatialCrossMapLRN(Module):
    """Local response normalization across channels:
    ``x / (k + alpha / size * sum of x^2 over size channels) ** beta``."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def _lrn(self, x):
        lo, hi = _window(self.size)
        b, c, h, w = x.shape
        # channels as the rows of one plane per image: a (size, 1) window
        sq = F.pad((x * x).reshape(b, 1, c, h * w), (0, 0, lo, hi))
        s = F.avg_pool2d(sq, (self.size, 1), stride=1,
                         divisor_override=1).reshape(b, c, h, w)
        return x / (self.k + self.alpha / self.size * s) ** self.beta

    def forward(self, input):
        return _batched(self._lrn, input)


class SpatialWithinChannelLRN(Module):
    """LRN over a ``size`` x ``size`` spatial window within each channel:
    ``x / (1 + alpha / size^2 * sum of x^2) ** beta``."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75):
        super().__init__()
        self.size, self.alpha, self.beta = size, alpha, beta

    def _lrn(self, x):
        lo, hi = _window(self.size)
        sq = F.pad(x * x, (lo, hi, lo, hi))
        s = F.avg_pool2d(sq, self.size, stride=1, divisor_override=1)
        return x / (1.0 + self.alpha / (self.size * self.size) * s) \
            ** self.beta

    def forward(self, input):
        return _batched(self._lrn, input)


class SpatialSubtractiveNormalization(Module):
    """Subtract the kernel-weighted local mean over all planes (the
    kernel, default 9 x 9 ones, normalized to sum 1), each position
    divided by the kernel's coverage there (less at the borders)."""

    def __init__(self, n_input_plane: int = 1, kernel=None, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.n_input_plane = n_input_plane
        k = (torch.ones(9, 9) if kernel is None
             else torch.as_tensor(kernel, dtype=torch.float32))
        self.kernel = (k / k.sum()).to(resolve_device(device))

    def _local_mean(self, x):
        k = self.kernel.to(x.dtype)
        kh, kw = k.shape
        (hl, hh), (wl, wh) = _window(kh), _window(kw)
        w = k.expand(1, self.n_input_plane, kh, kw) / self.n_input_plane
        mean = F.conv2d(F.pad(x, (wl, wh, hl, hh)), w)
        ones = torch.ones_like(x[:, :1])
        coef = F.conv2d(F.pad(ones, (wl, wh, hl, hh)), k[None, None])
        return mean / coef

    def forward(self, input):
        return _batched(lambda x: x - self._local_mean(x), input)


class SpatialDivisiveNormalization(Module):
    """Divide by the local standard deviation (the subtractive layer's
    weighted mean of x^2, square-rooted), floored at its per-image mean
    and replaced by ``thresval`` at or below ``threshold``."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel,
                                                   device=device)
        self.threshold, self.thresval = threshold, thresval

    def _divide(self, x):
        std = torch.sqrt(torch.clamp(self.sub._local_mean(x * x), min=0.0))
        mean_std = std.mean(dim=(2, 3), keepdim=True)
        denom = torch.maximum(std, mean_std)
        denom = torch.where(denom > self.threshold, denom,
                            torch.full_like(denom, self.thresval))
        return x / denom

    def forward(self, input):
        return _batched(self._divide, input)


class SpatialContrastiveNormalization(Module):
    """The subtractive, then the divisive normalization."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel,
                                                   device=device)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                threshold, thresval,
                                                device=device)

    def forward(self, input):
        return self.div(self.sub(input))
