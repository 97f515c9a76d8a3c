"""Int8 inference layers (port of ``bigdl_tpu/nn/quantized.py``).

``Quantizer.quantize(model)`` returns a clone of a trained model in which
every ``Linear`` and ``SpatialConvolution`` is an int8 layer; the float
model is left as it was. Weights are quantized once per output channel,
symmetric (scale = max|w| / 127) or, the ``Linear`` default, asymmetric
min/max with an int32 zero point (w ~ (w_q - zp) * scale); activations
are quantized on every call with one dynamic scale over the whole input
tensor. The products accumulate in int32, as the JAX package's
``lax.dot_general`` / ``lax.conv_general_dilated`` do:

- the Linear's product is ``torch._int_mm`` on the card (int8 x int8 ->
  int32; it takes more than 16 rows, so a decode step's few rows are
  padded with zero rows and the result sliced) and an int32
  ``torch.matmul`` on the CPU. The zero point comes off as
  ``acc - rowsum(x_q) * zp``, still in int32;
- the convolution is an int32 ``F.conv2d`` on the CPU. The card has no
  integer convolution: there the codes go through an f32 convolution
  with TF32 off, which equals the int32 result exactly while every
  partial sum stays below 2**24 in magnitude (127 * 127 * K < 2**24 holds
  for any data when K = in_channels / groups * kh * kw < 1040; past that
  it holds only while the sums of products stay small).

The rounding matches the JAX package byte for byte: ``torch.round``
rounds half to even as ``jnp.round`` does, the code is ``round(x /
scale)`` by true division (also where the divisor is a constant: see
:func:`exact_div`), an all-zero weight or activation slice gets
scale 1 (``where(amax > 0, amax / 127, 1)``, in the input's dtype, then
f32), and the output is ``acc_f32 * (x_scale * w_scale)``, the scales
multiplied first. The per-tensor activation scale depends on the whole
batch: a row's output depends on the other rows fed with it.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import conv as bt_conv
from bigdl_tpu_torch.nn import linear as bt_linear
from bigdl_tpu_torch.nn.module import Module

#: ``torch._int_mm`` on CUDA takes more than this many rows
_INT_MM_MIN_ROWS = 16


def exact_div(x, c: float):
    """``x / c`` by true division on every device. PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which can
    differ from the quotient in the last bit (and then flip a rounded
    code); dividing by a 0-dim tensor on ``x``'s device divides."""
    return x / x.new_full((), c)


def quantize_weight(w, axis: Tuple[int, ...]):
    """Symmetric per-channel int8: ``(w_q int8, scale f32)``, the scale
    shaped like ``w`` reduced over ``axis`` (dims kept)."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, exact_div(amax, 127.0), 1.0).float()
    w_q = torch.clamp(torch.round(w.float() / scale), -127, 127)
    return w_q.to(torch.int8), scale


def quantize_activation(x, amax=None):
    """Dynamic symmetric per-tensor int8: ``(x_q int8, scale f32)``, one
    scale over the whole of ``x``; ``amax`` (a 0-dim tensor in ``x``'s
    dtype) gives the max |x| when ``x`` is one shard of the tensor the
    scale spans (a row-parallel layer's all-reduced max)."""
    if amax is None:
        amax = x.abs().amax()
    scale = torch.where(amax > 0, exact_div(amax, 127.0), 1.0).float()
    x_q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return x_q.to(torch.int8), scale


def quantize_weight_minmax(w, axis: Tuple[int, ...]):
    """Asymmetric per-channel min/max int8: ``(w_q int8, scale f32,
    zero_point int32)``, each of scale and zero point shaped like ``w``
    reduced over ``axis`` (dims kept); w ~ (w_q - zp) * scale."""
    wmin = w.amin(dim=axis, keepdim=True)
    wmax = w.amax(dim=axis, keepdim=True)
    rng = torch.clamp(wmax - wmin, min=1e-8)
    scale = exact_div(rng, 255.0).float()
    zp = torch.round(-wmin.float() / scale) - 128.0
    w_q = torch.clamp(torch.round(w.float() / scale) + zp, -128, 127)
    return w_q.to(torch.int8), scale, zp.to(torch.int32)


def int8_matmul(x_q, w_q):
    """``x_q`` (M, K) int8 times ``w_q`` (N, K) int8 transposed, summed
    in int32: (M, N) int32. An int32 ``torch.matmul`` on the CPU;
    ``torch._int_mm`` on the card, with the rows padded past its
    16-row floor (K and N must be multiples of 8 there; it raises
    otherwise). The codes are never cast to a float type."""
    if x_q.device.type == "cpu":
        return torch.matmul(x_q.int(), w_q.int().t())
    m = x_q.shape[0]
    rows = max(_INT_MM_MIN_ROWS + 1, m)
    rows = -(-rows // 8) * 8
    if rows != m:
        x_q = F.pad(x_q, (0, 0, 0, rows - m))
    return torch._int_mm(x_q, w_q.t())[:m]


def int8_conv2d(x_q, w_q, stride, padding, dilation, groups: int):
    """NCHW int8 ``x_q`` convolved with OIHW int8 ``w_q``, summed exactly
    as int32 (see the module notes for the card's 2**24 bound);
    ``padding`` (pad_h, pad_w), -1 meaning XLA's SAME rule."""
    pad_h, pad_w = padding
    if pad_h == -1 or pad_w == -1:
        kh = (w_q.shape[2] - 1) * dilation[0] + 1
        kw = (w_q.shape[3] - 1) * dilation[1] + 1
        ph = bt_conv._same_pad(x_q.shape[2], kh, stride[0])
        pw = bt_conv._same_pad(x_q.shape[3], kw, stride[1])
        x_q = F.pad(x_q, (pw[0], pw[1], ph[0], ph[1]))
        pad_h = pad_w = 0
    if x_q.device.type == "cpu":
        w = w_q.int()
        if tuple(dilation) != (1, 1):
            # the CPU has no dilated integer convolution: spread the taps
            # over a zero-filled kernel instead (exact, zeros add nothing)
            o, i, kh, kw = w.shape
            wd = w.new_zeros((o, i, (kh - 1) * dilation[0] + 1,
                              (kw - 1) * dilation[1] + 1))
            wd[:, :, ::dilation[0], ::dilation[1]] = w
            w = wd
        return F.conv2d(x_q.int(), w, None, tuple(stride), (pad_h, pad_w),
                        1, groups)
    args = (None, tuple(stride), (pad_h, pad_w), tuple(dilation), groups)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        acc = F.conv2d(x_q.float(), w_q.float(), *args)
    return acc.round().int()


class Linear(Module):
    """Int8 linear layer; build it from a float ``Linear`` with
    :meth:`from_float`. Buffers ``weight_q`` (out, in) int8, ``w_scale``
    (out, 1) f32, with the min/max scheme ``w_zp`` (out, 1) int32, and
    the float ``bias`` where the float layer has one."""

    def __init__(self, weight_q, w_scale, bias=None, w_zp=None):
        super().__init__()
        self.register_buffer("weight_q", weight_q.to(torch.int8))
        self.register_buffer("w_scale", w_scale.float())
        self.has_zp = w_zp is not None
        if self.has_zp:
            self.register_buffer("w_zp", w_zp.to(torch.int32))
        self.has_bias = bias is not None
        if self.has_bias:
            self.register_buffer("bias", bias.detach().clone())

    @classmethod
    def from_float(cls, m: bt_linear.Linear,
                   scheme: str = "minmax") -> "Linear":
        w = m.weight.detach()
        bias = m.bias if m.with_bias else None
        if scheme == "minmax":
            w_q, scale, zp = quantize_weight_minmax(w, axis=(1,))
            return cls(w_q, scale, bias, w_zp=zp).set_name(m.get_name())
        w_q, scale = quantize_weight(w, axis=(1,))      # per out-channel
        return cls(w_q, scale, bias).set_name(m.get_name())

    def forward(self, input):
        squeeze = input.dim() == 1
        x = input[None] if squeeze else input
        lead = x.shape[:-1]
        x_q, x_scale = quantize_activation(x.reshape(-1, x.shape[-1]))
        acc = int8_matmul(x_q, self.weight_q)
        if self.has_zp:
            # (w_q - zp) unrolls to acc - zp * rowsum(x_q)
            row = x_q.sum(1, keepdim=True, dtype=torch.int32)
            acc = acc - row * self.w_zp[:, 0][None, :]
        out = acc.float() * (x_scale * self.w_scale[:, 0])[None, :]
        if self.has_bias:
            out = out + self.bias
        out = out.to(input.dtype).reshape(*lead, -1)
        return out[0] if squeeze else out


class SpatialConvolution(Module):
    """Int8 convolution over NCHW or NHWC input (the float layer's
    ``format`` carries over), with SAME padding (-1), groups and
    dilation. Buffers ``weight_q`` (out, in / groups, kh, kw) int8,
    ``w_scale`` (out, 1, 1, 1) f32 and the float ``bias``."""

    def __init__(self, weight_q, w_scale, bias, stride, padding,
                 n_group: int, dilation=(1, 1), format: str = "NCHW"):
        super().__init__()
        self.register_buffer("weight_q",
                             weight_q.to(torch.int8).contiguous())
        self.register_buffer("w_scale", w_scale.float())
        self.has_bias = bias is not None
        if self.has_bias:
            self.register_buffer("bias", bias.detach().clone())
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.n_group = n_group
        self.dilation = tuple(dilation)
        self.format = bt_conv.check_format(format)

    @classmethod
    def from_float(cls, m: bt_conv.SpatialConvolution
                   ) -> "SpatialConvolution":
        # per output channel over (in / groups, kh, kw)
        w_q, scale = quantize_weight(m.weight.detach(), axis=(1, 2, 3))
        dil = (getattr(m, "dilation_h", 1), getattr(m, "dilation_w", 1))
        return cls(w_q, scale, m.bias if m.with_bias else None,
                   (m.stride_h, m.stride_w), (m.pad_h, m.pad_w), m.n_group,
                   dil, format=m.format).set_name(m.get_name())

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        x_q, x_scale = quantize_activation(x)
        nhwc = self.format == "NHWC"
        acc = int8_conv2d(x_q.permute(0, 3, 1, 2) if nhwc else x_q,
                          self.weight_q, self.stride, self.padding,
                          self.dilation, self.n_group)
        if nhwc:
            acc = acc.permute(0, 2, 3, 1)
        ch = ((None, None, None, slice(None)) if nhwc
              else (None, slice(None), None, None))
        out = acc.float() * (x_scale * self.w_scale[:, 0, 0, 0])[ch]
        if self.has_bias:
            out = out + self.bias[ch]
        out = out.to(input.dtype)
        return out[0] if squeeze else out


_SWAP = {
    bt_linear.Linear: Linear.from_float,
    bt_conv.SpatialConvolution: SpatialConvolution.from_float,
}


class Quantizer:
    """Swap the supported layers of a trained model for int8 ones.
    :meth:`quantize` returns a modified CLONE; the original keeps its
    float weights."""

    @staticmethod
    def quantize(model: Module) -> Module:
        clone = copy.deepcopy(model)
        Quantizer._walk(clone)
        return Quantizer._maybe_swap(clone)

    @staticmethod
    def _maybe_swap(m: Module) -> Module:
        fn = _SWAP.get(type(m))
        return fn(m) if fn is not None else m

    @staticmethod
    def _walk(m: Module) -> None:
        for name, child in list(m.named_children()):
            Quantizer._walk(child)
            new = Quantizer._maybe_swap(child)
            if new is not child:
                setattr(m, name, new)
