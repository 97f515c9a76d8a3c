"""Pooling (port of ``bigdl_tpu/nn/pooling.py``): spatial max and average
pooling, the temporal and volumetric variants, max pooling with indices
and the unpooling that consumes them.

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

The temporal and volumetric pools take valid windows over symmetric
padding (-inf for max, 0 for the average), with no ceil mode, as in the
JAX package; the volumetric average divides by ``kT * kH * kW``
everywhere, ``count_include_pad`` or not (the JAX layer stores the flag
and does not read it). ``SpatialMaxPoolingWithIndices`` returns
``Table(pooled, indices)``, the indices 1-based flat positions in the
unpadded H x W plane (0 for a window that saw only padding), as floats;
``SpatialUnpooling`` adds each pooled value back at its index in a plane
of ``((outH - 1) * dH - 2 * padH + kH, ...)``, an index past that plane
adding nothing (JAX's scatter drops it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import check_format
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


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
    output sizes, ``.floor()`` back."""

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

    def floor(self) -> "SpatialMaxPooling":
        self.ceil_mode = False
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


def _symmetric(x, k, stride, pad, fill, pool):
    """``pool(x, k, stride, padding)`` over symmetric ``pad``: the op's own
    padding where torch allows it (at most half the window), else
    written out with ``F.pad`` filled with ``fill``; every window is then
    a valid window of the padded input, as in ``reduce_window``."""
    if all(2 * p <= kk for p, kk in zip(pad, k)):
        return pool(x, k, stride, pad)
    pads = []
    for p in reversed(pad):
        pads += [p, p]
    return pool(F.pad(x, pads, value=fill), k, stride, 0)


class TemporalMaxPooling(Module):
    """1-D max pooling over (batch, time, features), valid windows of
    ``k_w`` frames every ``d_w`` (default ``k_w``)."""

    def __init__(self, k_w: int, d_w: int = None):
        super().__init__()
        self.k_w = k_w
        self.d_w = d_w if d_w is not None else k_w

    def forward(self, input):
        squeeze = input.dim() == 2
        x = input[None] if squeeze else input
        out = F.max_pool1d(x.transpose(1, 2), self.k_w,
                           self.d_w).transpose(1, 2)
        return out[0] if squeeze else out


class VolumetricMaxPooling(Module):
    """3-D max pooling over NCDHW; strides default to the window (0 or
    None), symmetric -inf padding."""

    def __init__(self, kt, kw, kh, dt=None, dw=None, dh=None, pad_t=0,
                 pad_w=0, pad_h=0):
        super().__init__()
        self.k = (kt, kh, kw)
        self.d = (dt or kt, dh or kh, dw or kw)
        self.pad = (pad_t, pad_h, pad_w)

    def forward(self, input):
        squeeze = input.dim() == 4
        x = input[None] if squeeze else input
        out = _symmetric(x, self.k, self.d, self.pad, -float("inf"),
                         F.max_pool3d)
        return out[0] if squeeze else out


class VolumetricAveragePooling(Module):
    """3-D average pooling over NCDHW: window sums over symmetric zero
    padding divided by ``kT * kH * kW`` (``count_include_pad`` is kept
    and, as in the JAX package, not read). The CPU has no bf16
    ``avg_pool3d``: there a bf16 input pools in f32 and is cast back (on
    the card it pools in its own dtype)."""

    def __init__(self, kt, kw, kh, dt=None, dw=None, dh=None, pad_t=0,
                 pad_w=0, pad_h=0, count_include_pad: bool = True):
        super().__init__()
        self.k = (kt, kh, kw)
        self.d = (dt or kt, dh or kh, dw or kw)
        self.pad = (pad_t, pad_h, pad_w)
        self.count_include_pad = count_include_pad

    def forward(self, input):
        squeeze = input.dim() == 4
        x = input[None] if squeeze else input
        cpu_bf16 = x.device.type == "cpu" and x.dtype == torch.bfloat16
        xin = x.float() if cpu_bf16 else x

        def pool(v, k, s, p):
            return F.avg_pool3d(v, k, s, p, count_include_pad=True)

        out = _symmetric(xin, self.k, self.d, self.pad, 0.0, pool)
        if cpu_bf16:
            out = out.to(x.dtype)
        return out[0] if squeeze else out


class SpatialMaxPoolingWithIndices(Module):
    """Max pooling over NCHW that also returns where each maximum came
    from: ``Table(pooled, indices)``, the indices 1-based flat positions
    in the H x W plane (floats; the first maximum of a window in
    row-major order, as ``argmax`` picks it), for
    :class:`SpatialUnpooling`. Windows as :class:`SpatialMaxPooling`'s,
    ``.ceil()`` included."""

    def __init__(self, kw: int, kh: int, dw: int = None, dh: int = None,
                 pad_w: int = 0, pad_h: int = 0, format: str = "NCHW"):
        super().__init__()
        if format != "NCHW":
            raise ValueError("indices pooling supports NCHW only")
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False

    def ceil(self) -> "SpatialMaxPoolingWithIndices":
        self.ceil_mode = True
        return self

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        n, c, h, w = x.shape
        out_h = _pool_out_size(h, self.kh, self.dh, self.pad_h,
                               self.ceil_mode)
        out_w = _pool_out_size(w, self.kw, self.dw, self.pad_w,
                               self.ceil_mode)
        ph = _pool_padding(h, out_h, self.kh, self.dh, self.pad_h)
        pw = _pool_padding(w, out_w, self.kw, self.dw, self.pad_w)
        xp = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=-float("inf"))
        # the 1-based flat position of every padded cell in the unpadded
        # plane, 0 on the padding
        hs = torch.arange(xp.shape[2], device=x.device) - ph[0]
        ws = torch.arange(xp.shape[3], device=x.device) - pw[0]
        valid = ((hs[:, None] >= 0) & (hs[:, None] < h)
                 & (ws[None, :] >= 0) & (ws[None, :] < w))
        flat = torch.where(valid, hs[:, None] * w + ws[None, :] + 1, 0)
        k, s = (self.kh, self.kw), (self.dh, self.dw)
        patches = F.unfold(xp.reshape(n * c, 1, *xp.shape[2:]), k,
                           stride=s)                          # (nc, k, L)
        cells = F.unfold(flat.to(torch.float64)[None, None], k,
                         stride=s)[0]                         # (k, L)
        arg = patches.argmax(1)                                # (nc, L)
        idx = cells.gather(0, arg).reshape(n, c, out_h, out_w)
        pooled = patches.amax(1).reshape(n, c, out_h, out_w)
        idx = idx.to(torch.float32)
        if squeeze:
            return Table(pooled[0], idx[0])
        return Table(pooled, idx)


class SpatialUnpooling(Module):
    """The inverse of max pooling with indices: ``Table(pooled,
    indices)`` -> each pooled value added at its 1-based flat index in
    an NCHW plane of ((outH - 1) * dH - 2 * padH + kH, (outW - 1) * dW
    - 2 * padW + kW), zeros elsewhere."""

    def __init__(self, kw: int, kh: int, dw: int = None, dh: int = None,
                 pad_w: int = 0, pad_h: int = 0, format: str = "NCHW"):
        super().__init__()
        if format != "NCHW":
            raise ValueError("unpooling supports NCHW only")
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h

    def forward(self, input):
        pooled, indices = list(input)[:2]
        squeeze = pooled.dim() == 3
        p = pooled[None] if squeeze else pooled
        idx = (indices[None] if squeeze else indices).long()
        n, c, oh, ow = p.shape
        h = (oh - 1) * self.dh - 2 * self.pad_h + self.kh
        w = (ow - 1) * self.dw - 2 * self.pad_w + self.kw
        idx = idx.reshape(n, c, -1)
        # slot 0 sinks the padding's marker; an index past the plane adds
        # nothing
        keep = (idx >= 0) & (idx <= h * w)
        flat = p.new_zeros((n, c, h * w + 1)).scatter_add(
            2, torch.where(keep, idx, 0),
            torch.where(keep, p.reshape(n, c, -1), 0))
        out = flat[:, :, 1:].reshape(n, c, h, w)
        return out[0] if squeeze else out
