"""Convolutions (port of ``bigdl_tpu/nn/conv.py``): ``SpatialConvolution``
and its variants, dilated, full (transposed), separable, share, locally
connected (1-D and 2-D), temporal, volumetric (plain and full) and the
connection-table ``SpatialConvolutionMap``.

The JAX package lowers every convolution to ``lax.conv_general_dilated``,
an XLA op, not a Pallas kernel; here each is an ordinary torch op
(``F.conv1d`` / ``conv2d`` / ``conv3d``, ``F.conv_transpose2d`` /
``conv_transpose3d``, ``F.unfold``; cuDNN on the card). Kept from the
JAX package:

- constructor arguments in the reference's order, W before H
  (``kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h``), T before
  both in the volumetric layers;
- ``pad_w == -1`` or ``pad_h == -1`` means SAME padding, XLA's rule:
  output ``ceil(in / stride)``, the odd pad element on the high side
  (over the dilated kernel's extent for the dilated convolution);
- ``n_group`` groups, an optional bias, unbatched input;
- the weight is (out, in / groups, kH, kW) in both formats; a full
  convolution's is (in, out / groups, kH, kW), as ``conv_transpose2d``
  takes it; the full convolutions' ``adj`` adds output rows on the high
  side (below the stride this is ``output_padding``; at or above it the
  input is dilated with zeros and convolved with the flipped kernel, the
  JAX construction);
- the locally connected layers' weights, one (out, in x kernel) matrix
  per output position, over patches in the JAX order (channel-major for
  the 2-D layer, time-major for the 1-D one).

``format="NHWC"`` (``SpatialConvolution`` and the dilated and share
forms) takes and returns (B, H, W, C) tensors, as the JAX layer does.
Inside, ``x.permute(0, 3, 1, 2)`` is a channels-last NCHW view of the
same memory, the weight is stored channels-last, and the result is
permuted back: cuDNN runs its NHWC kernels with no transpose of its own,
and the NHWC output is contiguous.

``init_weight`` / ``init_bias`` give ``SpatialConvolution`` its initial
values, and its ``reset()`` draws the weight again from its ``rng`` and
zeroes the bias.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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
    zero, unless ``init_weight`` / ``init_bias`` give them;
    ``propagate_back`` is accepted and, as in the JAX package, changes
    nothing (autograd computes an input gradient only where one is
    needed)."""

    dilation = (1, 1)

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 w_regularizer=None, b_regularizer=None, init_weight=None,
                 init_bias=None, with_bias: bool = True, init_method=None,
                 format: str = "NCHW", *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"not divisible by n_group {n_group}")
        dev = resolve_device(device)
        self._rng = rng or RandomGenerator()
        self.format = check_format(format)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.with_bias = with_bias
        self._init_method = init_method or bt_init.Xavier()
        w = (bt_init.given(init_weight, self._wshape(), "init_weight")
             if init_weight is not None else self._draw())
        if self.format == "NHWC":
            w = w.contiguous(memory_format=torch.channels_last)
        self.new_param("weight", w, dev, dtype, w_regularizer)
        if with_bias:
            b = (bt_init.given(init_bias, (n_output_plane,), "init_bias")
                 if init_bias is not None else torch.zeros(n_output_plane))
            self.new_param("bias", b, dev, dtype, b_regularizer)

    def _wshape(self):
        return (self.n_output_plane, self.n_input_plane // self.n_group,
                self.kernel_h, self.kernel_w)

    def _draw(self) -> torch.Tensor:
        area = self.kernel_h * self.kernel_w
        return self._init_method(
            self._wshape(), self._rng,
            fan_in=self.n_input_plane // self.n_group * area,
            fan_out=self.n_output_plane // self.n_group * area)

    def reset(self) -> None:
        with torch.no_grad():
            self.weight.copy_(self._draw())
            if self.with_bias:
                self.bias.zero_()

    def _conv(self, x):
        """F.conv2d over NCHW ``x`` (a channels-last view for NHWC)."""
        w = self.weight
        if self.format == "NHWC":
            w = w.contiguous(memory_format=torch.channels_last)
        bias = self.bias if self.with_bias else None
        dh, dw = self.dilation
        padding = (self.pad_h, self.pad_w)
        if self.pad_h == -1 or self.pad_w == -1:
            ph = _same_pad(x.shape[2], (self.kernel_h - 1) * dh + 1,
                           self.stride_h)
            pw = _same_pad(x.shape[3], (self.kernel_w - 1) * dw + 1,
                           self.stride_w)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                padding = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
                padding = (0, 0)
        return F.conv2d(x, w, bias, (self.stride_h, self.stride_w), padding,
                        (dh, dw), self.n_group)

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        if self.format == "NHWC":
            out = self._conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            out = self._conv(x)
        return out[0] if squeeze else out


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous convolution: the kernel's taps ``dilation_w`` /
    ``dilation_h`` apart; the other arguments as
    :class:`SpatialConvolution`'s."""

    def __init__(self, n_input_plane, n_output_plane, kw, kh, dw=1, dh=1,
                 pad_w=0, pad_h=0, dilation_w=1, dilation_h=1, **kwargs):
        super().__init__(n_input_plane, n_output_plane, kw, kh, dw, dh,
                         pad_w, pad_h, **kwargs)
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        self.dilation = (dilation_h, dilation_w)


class SpatialShareConvolution(SpatialConvolution):
    """The same computation as :class:`SpatialConvolution` (the reference
    variant only shares its im2col buffers)."""


def _rng_device(rng, device):
    return rng or RandomGenerator(), resolve_device(device)


def _transposed(x, weight, bias, stride, pad, adj, n_group: int, nd: int):
    """Transposed convolution over ``nd`` spatial dims of NC... ``x`` with
    a (in, out / groups, k...) ``weight``: ``conv_transpose`` where every
    ``adj`` is below its stride, else the JAX construction (the input
    dilated by the stride with zeros, padded by ``k - 1 - pad`` low and
    ``k - 1 - pad + adj`` high, convolved with the flipped kernel)."""
    if all(a < s for a, s in zip(adj, stride)):
        fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
        return fn(x, weight, bias, stride, pad, adj, n_group)
    n, c = x.shape[:2]
    size = [(d - 1) * s + 1 for d, s in zip(x.shape[2:], stride)]
    z = x.new_zeros((n, c, *size))
    z[(slice(None), slice(None)) + tuple(slice(None, None, s)
                                         for s in stride)] = x
    k = weight.shape[2:]
    pads = []
    for kk, p, a in reversed(list(zip(k, pad, adj))):
        pads += [kk - 1 - p, kk - 1 - p + a]
    z = F.pad(z, pads)
    g = n_group
    c_in, c_out_g = weight.shape[:2]
    w = weight.flip(tuple(range(2, 2 + nd)))
    w = w.reshape(g, c_in // g, c_out_g, *k).transpose(1, 2).reshape(
        g * c_out_g, c_in // g, *k)
    fn = F.conv2d if nd == 2 else F.conv3d
    return fn(z, w, bias, 1, 0, 1, g)


class SpatialFullConvolution(Module):
    """Transposed 2-D convolution over NCHW: output size ``(in - 1) *
    stride - 2 * pad + kernel + adj``; weight (in, out / n_group, kH,
    kW)."""

    def __init__(self, n_input_plane, n_output_plane, kw, kh, dw=1, dh=1,
                 pad_w=0, pad_h=0, adj_w=0, adj_h=0, n_group=1,
                 with_bias=True, w_regularizer=None, b_regularizer=None, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        rng, dev = _rng_device(rng, device)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel_w, self.kernel_h = kw, kh
        self.stride_w, self.stride_h = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.with_bias = with_bias
        w = bt_init.Xavier()((n_input_plane, n_output_plane // n_group, kh,
                              kw), rng, fan_in=n_output_plane * kh * kw,
                             fan_out=n_input_plane * kh * kw)
        self.new_param("weight", w, dev, dtype, w_regularizer)
        if with_bias:
            self.new_param("bias", torch.zeros(n_output_plane), dev, dtype,
                           b_regularizer)

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        out = _transposed(x, self.weight,
                          self.bias if self.with_bias else None,
                          (self.stride_h, self.stride_w),
                          (self.pad_h, self.pad_w),
                          (self.adj_h, self.adj_w), self.n_group, 2)
        return out[0] if squeeze else out


class SpatialSeparableConvolution(Module):
    """Depthwise (``depth_multiplier`` filters per input channel, no
    bias) then pointwise 1 x 1 convolution."""

    def __init__(self, n_input_channel, n_output_channel, depth_multiplier,
                 kw, kh, sw=1, sh=1, pw=0, ph=0, with_bias=True, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        opts = dict(rng=rng or RandomGenerator(), device=device, dtype=dtype)
        self.depthwise = SpatialConvolution(
            n_input_channel, n_input_channel * depth_multiplier, kw, kh, sw,
            sh, pw, ph, n_group=n_input_channel, with_bias=False, **opts)
        self.pointwise = SpatialConvolution(
            n_input_channel * depth_multiplier, n_output_channel, 1, 1, 1, 1,
            0, 0, with_bias=with_bias, **opts)

    def forward(self, input):
        return self.pointwise(self.depthwise(input))


class LocallyConnected2D(Module):
    """Unshared 2-D convolution over NCHW: each output position owns its
    own (n_output_plane, n_input_plane * kH * kW) weight and bias."""

    def __init__(self, n_input_plane, input_w, input_h, n_output_plane, kw,
                 kh, sw=1, sh=1, pw=0, ph=0, with_bias=True, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        rng, dev = _rng_device(rng, device)
        self.args = (n_input_plane, input_w, input_h, n_output_plane, kw, kh,
                     sw, sh, pw, ph)
        self.with_bias = with_bias
        self.out_h = (input_h + 2 * ph - kh) // sh + 1
        self.out_w = (input_w + 2 * pw - kw) // sw + 1
        positions = self.out_h * self.out_w
        w = bt_init.Xavier()((positions, n_output_plane,
                              n_input_plane * kh * kw), rng,
                             fan_in=n_input_plane * kh * kw,
                             fan_out=n_output_plane * kh * kw)
        self.new_param("weight", w, dev, dtype)
        if with_bias:
            self.new_param("bias", torch.zeros(positions, n_output_plane),
                           dev, dtype)

    def forward(self, input):
        _, _, _, n_out, kw, kh, sw, sh, pw, ph = self.args
        x = input[None] if input.dim() == 3 else input
        b = x.shape[0]
        patches = F.unfold(F.pad(x, (pw, pw, ph, ph)), (kh, kw),
                           stride=(sh, sw))           # (b, C*kh*kw, P)
        out = torch.einsum("bkp,pok->bpo", patches, self.weight)
        if self.with_bias:
            out = out + self.bias
        out = out.transpose(1, 2).reshape(b, n_out, self.out_h, self.out_w)
        return out[0] if input.dim() == 3 else out


class TemporalConvolution(Module):
    """1-D convolution over (batch, time, features), valid windows;
    weight (out, in, kW)."""

    def __init__(self, input_frame_size, output_frame_size, kernel_w,
                 stride_w=1, w_regularizer=None, b_regularizer=None, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        rng, dev = _rng_device(rng, device)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w, self.stride_w = kernel_w, stride_w
        w = bt_init.Xavier()((output_frame_size, input_frame_size, kernel_w),
                             rng, fan_in=input_frame_size * kernel_w,
                             fan_out=output_frame_size * kernel_w)
        self.new_param("weight", w, dev, dtype, w_regularizer)
        self.new_param("bias", torch.zeros(output_frame_size), dev, dtype,
                       b_regularizer)

    def forward(self, input):
        squeeze = input.dim() == 2
        x = input[None] if squeeze else input
        out = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                       self.stride_w).transpose(1, 2)
        return out[0] if squeeze else out


class VolumetricConvolution(Module):
    """3-D convolution over NCDHW; weight (out, in, kT, kH, kW)."""

    def __init__(self, n_input_plane, n_output_plane, kt, kw, kh, dt=1, dw=1,
                 dh=1, pad_t=0, pad_w=0, pad_h=0, with_bias=True, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        rng, dev = _rng_device(rng, device)
        self.strides = (dt, dh, dw)
        self.pads = (pad_t, pad_h, pad_w)
        self.with_bias = with_bias
        w = bt_init.Xavier()((n_output_plane, n_input_plane, kt, kh, kw), rng,
                             fan_in=n_input_plane * kt * kh * kw,
                             fan_out=n_output_plane * kt * kh * kw)
        self.new_param("weight", w, dev, dtype)
        if with_bias:
            self.new_param("bias", torch.zeros(n_output_plane), dev, dtype)

    def forward(self, input):
        squeeze = input.dim() == 4
        x = input[None] if squeeze else input
        out = F.conv3d(x, self.weight, self.bias if self.with_bias else None,
                       self.strides, self.pads)
        return out[0] if squeeze else out


class VolumetricFullConvolution(Module):
    """Transposed 3-D convolution over NCDHW, as
    :class:`SpatialFullConvolution` with a depth axis; weight (in, out /
    n_group, kT, kH, kW)."""

    def __init__(self, n_input_plane, n_output_plane, kt, kw, kh, dt=1, dw=1,
                 dh=1, pad_t=0, pad_w=0, pad_h=0, adj_t=0, adj_w=0, adj_h=0,
                 n_group=1, with_bias=True, w_regularizer=None,
                 b_regularizer=None, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        rng, dev = _rng_device(rng, device)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel = (kt, kh, kw)
        self.strides = (dt, dh, dw)
        self.pads = (pad_t, pad_h, pad_w)
        self.adjs = (adj_t, adj_h, adj_w)
        self.n_group = n_group
        self.with_bias = with_bias
        w = bt_init.Xavier()((n_input_plane, n_output_plane // n_group, kt, kh,
                              kw), rng, fan_in=n_output_plane * kt * kh * kw,
                             fan_out=n_input_plane * kt * kh * kw)
        self.new_param("weight", w, dev, dtype, w_regularizer)
        if with_bias:
            self.new_param("bias", torch.zeros(n_output_plane), dev, dtype,
                           b_regularizer)

    def forward(self, input):
        squeeze = input.dim() == 4
        x = input[None] if squeeze else input
        out = _transposed(x, self.weight,
                          self.bias if self.with_bias else None,
                          self.strides, self.pads, self.adjs, self.n_group, 3)
        return out[0] if squeeze else out


class SpatialConvolutionMap(Module):
    """Convolution over NCHW with an explicit connection table:
    ``conn_table`` (n_pairs, 2) of 1-based (input plane, output plane)
    pairs, each pair owning a (kH, kW) kernel (weight (n_pairs, kH, kW),
    bias per output plane). The pairs' kernels are summed into a dense
    (out, in, kH, kW) weight, absent pairs zero, and one convolution
    runs. ``full``, ``one_to_one`` and ``random`` build the classic
    tables (``random`` draws from numpy's ``RandomState(seed)``, as the
    JAX package does)."""

    def __init__(self, conn_table, kw: int, kh: int, dw: int = 1,
                 dh: int = 1, pad_w: int = 0, pad_h: int = 0, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        rng, dev = _rng_device(rng, device)
        table = np.asarray(conn_table, np.int64)
        if table.ndim != 2 or table.shape[1] != 2:
            raise ValueError(f"conn_table must be (n_pairs, 2), got "
                             f"{table.shape}")
        self.conn_table = table
        self.kernel_w, self.kernel_h = kw, kh
        self.stride_w, self.stride_h = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_input_plane = int(table[:, 0].max())
        self.n_output_plane = int(table[:, 1].max())
        n_pairs = table.shape[0]
        fan_in = kh * kw * max(1, n_pairs // self.n_output_plane)
        self.new_param("weight", bt_init.Xavier()((n_pairs, kh, kw), rng,
                                                  fan_in=fan_in,
                                                  fan_out=fan_in), dev, dtype)
        self.new_param("bias", torch.zeros(self.n_output_plane), dev, dtype)

    @staticmethod
    def full(n_in: int, n_out: int):
        ins, outs = np.meshgrid(np.arange(1, n_in + 1),
                                np.arange(1, n_out + 1))
        return np.stack([ins.reshape(-1), outs.reshape(-1)], axis=1)

    @staticmethod
    def one_to_one(n: int):
        r = np.arange(1, n + 1)
        return np.stack([r, r], axis=1)

    @staticmethod
    def random(n_in: int, n_out: int, n_from: int, seed: int = 1):
        rs = np.random.RandomState(seed)
        rows = []
        for o in range(1, n_out + 1):
            for i in rs.choice(np.arange(1, n_in + 1), size=n_from,
                               replace=False):
                rows.append([int(i), o])
        return np.asarray(rows, np.int64)

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        dev = self.weight.device
        outs = torch.as_tensor(self.conn_table[:, 1] - 1, device=dev)
        ins = torch.as_tensor(self.conn_table[:, 0] - 1, device=dev)
        w = torch.zeros((self.n_output_plane, self.n_input_plane,
                         self.kernel_h, self.kernel_w), dtype=x.dtype,
                        device=dev).index_put(
            (outs, ins), self.weight.to(x.dtype), accumulate=True)
        out = F.conv2d(x, w, self.bias, (self.stride_h, self.stride_w),
                       (self.pad_h, self.pad_w))
        return out[0] if squeeze else out


class LocallyConnected1D(Module):
    """Unshared 1-D convolution over (batch, n_input_frame,
    input_frame_size): each output frame owns its own (output_frame_size,
    kW * input_frame_size) weight and bias."""

    def __init__(self, n_input_frame: int, input_frame_size: int,
                 output_frame_size: int, kernel_w: int, stride_w: int = 1,
                 propagate_back: bool = True, w_regularizer=None,
                 b_regularizer=None, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        rng, dev = _rng_device(rng, device)
        self.n_input_frame = n_input_frame
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w, self.stride_w = kernel_w, stride_w
        self.propagate_back = propagate_back
        n_out = (n_input_frame - kernel_w) // stride_w + 1
        self.n_output_frame = n_out
        w = bt_init.Xavier()((n_out, output_frame_size,
                              input_frame_size * kernel_w), rng,
                             fan_in=input_frame_size * kernel_w,
                             fan_out=output_frame_size * kernel_w)
        self.new_param("weight", w, dev, dtype, w_regularizer)
        self.new_param("bias", torch.zeros(n_out, output_frame_size), dev,
                       dtype, b_regularizer)

    def forward(self, input):
        squeeze = input.dim() == 2
        x = input[None] if squeeze else input            # (b, t, c)
        patches = x.unfold(1, self.kernel_w, self.stride_w)  # (b, n, c, k)
        patches = patches.transpose(2, 3).reshape(
            x.shape[0], self.n_output_frame, -1)         # time-major
        out = torch.einsum("btk,tok->bto", patches, self.weight) + self.bias
        return out[0] if squeeze else out
