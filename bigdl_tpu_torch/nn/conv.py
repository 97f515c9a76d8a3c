"""2-D convolution (port of ``SpatialConvolution`` in
``bigdl_tpu/nn/conv.py``).

The JAX package lowers every convolution to ``lax.conv_general_dilated``,
an XLA op, not a Pallas kernel; here it is ``F.conv2d``, the ordinary
torch op (cuDNN on the card). Kept from the JAX package:

- constructor arguments in the reference's order, W before H
  (``kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h``);
- ``pad_w == -1`` or ``pad_h == -1`` means SAME padding, XLA's rule:
  output ``ceil(in / stride)``, the odd pad element on the high side;
- ``n_group`` groups, an optional bias, unbatched 3-D input;
- the weight is (out, in / groups, kH, kW) in both formats.

``format="NHWC"`` takes and returns (B, H, W, C) tensors, as the JAX
layer does. Inside, ``x.permute(0, 3, 1, 2)`` is a channels-last NCHW
view of the same memory, the weight is stored channels-last, and the
result is permuted back: cuDNN runs its NHWC kernels with no transpose
of its own, and the NHWC output is contiguous.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn import init as bt_init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.random import RandomGenerator


def check_format(format: str) -> str:
    if format not in ("NCHW", "NHWC"):
        raise ValueError(f"format must be 'NCHW' or 'NHWC', got {format!r}")
    return format


def _same_pad(size: int, k: int, stride: int):
    """(low, high) padding of XLA's SAME rule along one dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SpatialConvolution(Module):
    """2-D convolution over NCHW (default) or NHWC input. The weight is
    drawn from ``rng`` by ``init_method`` (default Xavier), the bias is
    zero; ``propagate_back`` is accepted and, as in the JAX package,
    changes nothing (autograd computes an input gradient only where one
    is needed)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 with_bias: bool = True, init_method=None,
                 format: str = "NCHW", *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"not divisible by n_group {n_group}")
        dev = resolve_device(device)
        rng = rng or RandomGenerator()
        self.format = check_format(format)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.with_bias = with_bias
        init_method = init_method or bt_init.Xavier()
        w = init_method(
            (n_output_plane, n_input_plane // n_group, kernel_h, kernel_w),
            rng, fan_in=(n_input_plane // n_group) * kernel_h * kernel_w,
            fan_out=(n_output_plane // n_group) * kernel_h * kernel_w)
        if self.format == "NHWC":
            w = w.contiguous(memory_format=torch.channels_last)
        self.new_param("weight", w, dev, dtype, w_regularizer)
        if with_bias:
            self.new_param("bias", torch.zeros(n_output_plane), dev, dtype,
                           b_regularizer)

    def _conv(self, x):
        """F.conv2d over NCHW ``x`` (a channels-last view for NHWC)."""
        w = self.weight
        if self.format == "NHWC":
            w = w.contiguous(memory_format=torch.channels_last)
        bias = self.bias if self.with_bias else None
        padding = (self.pad_h, self.pad_w)
        if self.pad_h == -1 or self.pad_w == -1:
            ph = _same_pad(x.shape[2], self.kernel_h, self.stride_h)
            pw = _same_pad(x.shape[3], self.kernel_w, self.stride_w)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                padding = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
                padding = (0, 0)
        return F.conv2d(x, w, bias, (self.stride_h, self.stride_w), padding,
                        1, self.n_group)

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        if self.format == "NHWC":
            out = self._conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            out = self._conv(x)
        return out[0] if squeeze else out
