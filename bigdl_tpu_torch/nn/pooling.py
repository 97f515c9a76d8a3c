"""Pooling (port of ``SpatialMaxPooling`` and ``SpatialAveragePooling``
in ``bigdl_tpu/nn/pooling.py``).

The JAX package pools with ``lax.reduce_window`` (XLA) over explicit
padding: ``pad`` on the low side and whatever the output size needs on
the high side, the output size being the reference's (floor, or ceil
after ``.ceil()``, minus one where the last window would start in the
padding). Here that padding feeds ``F.max_pool2d`` / ``F.avg_pool2d``:
as their own symmetric ``padding`` where it gives the same windows,
else written out with ``F.pad``. Average pooling with
``count_include_pad`` divides every window by ``kH * kW``, over a
ceil-mode overhang too, as the JAX package does; without it, by the
window's count of input elements. NHWC input is pooled as a
channels-last NCHW view, like the convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import check_format
from bigdl_tpu_torch.nn.module import Module


def _pool_out_size(in_size, k, stride, pad, ceil_mode):
    if ceil_mode:
        out = -(-(in_size + 2 * pad - k) // stride) + 1
    else:
        out = (in_size + 2 * pad - k) // stride + 1
    if pad > 0 and (out - 1) * stride >= in_size + pad:
        out -= 1
    return out


def _pool_padding(in_size, out_size, k, stride, pad):
    """Explicit (lo, hi) padding realizing the requested output size."""
    needed = (out_size - 1) * stride + k - in_size
    return pad, max(0, needed - pad)


def _padded(x, k, stride, pad, ceil_mode, fill):
    """(NCHW ``x``, symmetric padding for the pool op): the JAX package's
    windows over ``x``, written out with ``F.pad`` where the pool op's
    own symmetric padding would place them elsewhere."""
    sym, lo_hi = [], []
    for size, kk, s, p in zip(x.shape[2:], k, stride, pad):
        out = _pool_out_size(size, kk, s, p, ceil_mode)
        lo, hi = _pool_padding(size, out, kk, s, p)
        sym.append(lo <= kk // 2 and (size + 2 * lo - kk) // s + 1 == out)
        lo_hi.append((lo, hi))
    if all(sym):
        return x, (lo_hi[0][0], lo_hi[1][0])
    (hl, hh), (wl, wh) = lo_hi
    return F.pad(x, (wl, wh, hl, hh), value=fill), (0, 0)


def _as_nchw(module, input):
    """(4-D NCHW view of ``input``, function mapping a result back)."""
    squeeze = input.dim() == 3
    x = input[None] if squeeze else input
    nhwc = module.format == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)

    def back(out):
        if nhwc:
            out = out.permute(0, 2, 3, 1)
        return out[0] if squeeze else out

    return x, back


class SpatialMaxPooling(Module):
    """Max pooling over NCHW or NHWC; ``.ceil()`` switches to ceil-mode
    output sizes."""

    def __init__(self, kw: int, kh: int, dw: int = None, dh: int = None,
                 pad_w: int = 0, pad_h: int = 0, format: str = "NCHW"):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False
        self.format = check_format(format)

    def ceil(self) -> "SpatialMaxPooling":
        self.ceil_mode = True
        return self

    def forward(self, input):
        x, back = _as_nchw(self, input)
        k, s = (self.kh, self.kw), (self.dh, self.dw)
        x, padding = _padded(x, k, s, (self.pad_h, self.pad_w),
                             self.ceil_mode, -float("inf"))
        return back(F.max_pool2d(x, k, s, padding))


class SpatialAveragePooling(Module):
    """Average pooling; ``global_pooling`` pools the whole plane,
    ``divide=False`` returns the window sums."""

    def __init__(self, kw: int, kh: int, dw: int = None, dh: int = None,
                 pad_w: int = 0, pad_h: int = 0, global_pooling: bool = False,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divide: bool = True, format: str = "NCHW"):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide
        self.format = check_format(format)

    def ceil(self) -> "SpatialAveragePooling":
        self.ceil_mode = True
        return self

    def forward(self, input):
        x, back = _as_nchw(self, input)
        if self.global_pooling:
            k, s = tuple(x.shape[2:]), (1, 1)
        else:
            k, s = (self.kh, self.kw), (self.dh, self.dw)
        pad = (self.pad_h, self.pad_w)
        xp, padding = _padded(x, k, s, pad, self.ceil_mode, 0.0)
        # every window lies inside the padded input, so this divides by
        # kH * kW everywhere
        out = F.avg_pool2d(xp, k, s, padding, count_include_pad=True)
        if not self.divide:
            out = out * (k[0] * k[1])
        elif not self.count_include_pad:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            op, _ = _padded(ones, k, s, pad, self.ceil_mode, 0.0)
            out = out / F.avg_pool2d(op, k, s, padding,
                                     count_include_pad=True)
        return back(out)
