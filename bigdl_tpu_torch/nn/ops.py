"""TF-style operation modules (port of ``bigdl_tpu/nn/ops.py``).

Each op is a forward-only :class:`Operation` module under the JAX
package's name and constructor signature, so imported TF graphs can be
lowered onto it. ``backward`` raises; autograd through the torch ops
stays available, as JAX's ``pure_apply`` is.

Devices: an op given tensors computes on their device (numpy arrays and
Python numbers join the first tensor). An op that makes a tensor from
nothing or from host values (``RangeOps``, ``RandomUniform``,
``TruncatedNormal``, ``Kv2Tensor``, the hashing columns and
``CategoricalColVocaList``) takes ``device=``, the card unless the caller
passes ``"cpu"``. String work (hashing, ``Kv2Tensor``, ``MkString``,
``Substr``, the vocabulary lists) runs on the host, as in JAX.

Where torch's plain call parts from ``jax.numpy``, the op is written to
JAX's semantics:

- ``TopK`` breaks ties lowest index first (a stable descending sort;
  ``torch.topk`` promises no order among ties);
- ``OneHot`` and ``IndicatorCol`` give zero rows for ids out of range
  (``F.one_hot`` raises, and on the card trips a device-side assert);
- ``Gather`` wraps a negative index once and fills an index out of range
  with NaN (floats), the type's minimum (signed ints), its maximum
  (unsigned) or True (bool), as ``jnp.take`` does; no index out of
  bounds ever reaches the device;
- ``SegmentSum`` drops ids out of range, as ``jax.ops.segment_sum``;
- ``Sign`` keeps NaN and -0.0; ``Digamma`` is NaN at 0; ``Maximum`` of
  -0.0 and +0.0 is +0.0 and ``Minimum`` -0.0, in either order (torch's
  sign of that zero follows the argument order, and the card's differs
  from the CPU's);
- ``Cast`` from a float to an integer type, and ``TruncateDiv`` on
  integers, saturate at the type's bounds and map NaN to 0, as XLA's
  convert does (a plain ``.to(int32)`` gives the minimum for both);
- ``Mod`` and ``FloorMod`` are ``torch.remainder`` (the divisor's sign),
  not ``torch.fmod``;
- ``ResizeBilinearOp`` antialiases along a dimension it shrinks, as
  ``jax.image.resize`` does;
- ``BucketizedCol`` is ``searchsorted(side="right")``;
- hashing reads ``str()`` of numpy elements (a tensor element would
  print as ``tensor(3)`` and move every bucket).

Dtypes: JAX runs with 64-bit types off, so it returns int32 indices
(``ArgMax``, ``TopK``, ``Rank``, ``Shape``, the buckets) and computes
float64 inputs in float32. The port returns torch's int64 indices and
keeps its input's float dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


# ------------------------------------------------------------ helpers
def _tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, anything else (numpy, a
    Python number or list) on ``device`` (default the host)."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


def _tensors(*xs):
    """The inputs as tensors on the device of the first that is one."""
    dev = next((x.device for x in xs if torch.is_tensor(x)), None)
    return [_tensor(x, dev) for x in xs]


def _host_array(x) -> np.ndarray:
    """``x`` as a numpy array on the host (one copy from the card for a
    device tensor), so ``str()`` of an element prints its value."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_ints(x):
    return [int(v) for v in _host_array(x).reshape(-1)]


def _fill_value(dtype: torch.dtype):
    """What ``jnp.take`` puts at an index out of range."""
    if dtype.is_floating_point or dtype.is_complex:
        return math.nan
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


def _take(params: torch.Tensor, indices, axis: int = 0) -> torch.Tensor:
    """``jnp.take(params, indices, axis)`` in its default mode: a negative
    index wraps once, an index still out of range reads the fill value.
    Every index that reaches ``index_select`` is in bounds."""
    axis %= params.dim()
    idx = _tensor(indices, params.device).to(torch.int64)
    n = params.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = params.index_select(axis, torch.where(valid, idx, 0).reshape(-1))
    out = out.reshape(params.shape[:axis] + idx.shape
                      + params.shape[axis + 1:])
    mask = valid.reshape((1,) * axis + idx.shape
                         + (1,) * (params.dim() - axis - 1))
    return torch.where(mask, out, torch.full((), _fill_value(out.dtype),
                                             dtype=out.dtype,
                                             device=out.device))


def _take_rows(x: torch.Tensor, idx) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx[:, None], axis=1)[:, 0]``: the entry of
    each row at its index, wrapped and filled as :func:`_take`."""
    idx = _tensor(idx, x.device).to(torch.int64)
    n = x.shape[1]
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = x.gather(1, torch.where(valid, idx, 0)[:, None])[:, 0]
    return torch.where(valid, out, torch.full((), _fill_value(x.dtype),
                                              dtype=x.dtype, device=x.device))


def _one_hot(indices, depth: int, axis: int = -1) -> torch.Tensor:
    """``jax.nn.one_hot``: f32, a zero row for an id out of range."""
    idx = _tensor(indices).to(torch.int64)
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)).to(
        torch.float32)
    return oh if axis == -1 else torch.movedim(oh, -1, axis)


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype (or its name, or a torch dtype) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _saturating_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)`` as XLA converts: a float into an integer type
    saturates at the type's bounds and NaN becomes 0."""
    if not x.is_floating_point() or dtype.is_floating_point \
            or dtype.is_complex or dtype == torch.bool:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = float(info.min), float(info.max) + 1.0   # both exact in f32
    inside = (x >= lo) & (x < hi)
    out = torch.where(inside, x, 0).to(dtype)
    return out.masked_fill(x >= hi, info.max).masked_fill(x < lo, info.min)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN and -0.0 kept (``torch.sign`` gives 0 for both)."""
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where((x == 0) | x.isnan(), x, torch.sign(x))


def _digamma(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.digamma``: NaN at 0 (``torch.digamma`` gives
    -inf at 0.0 and inf at -0.0)."""
    return torch.digamma(x).masked_fill(x == 0, math.nan)


def _maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``: max(-0.0, +0.0) is +0.0 in either order (torch's
    sign of a zero result depends on the argument order and the device)."""
    out = torch.maximum(a, b)
    if not out.is_floating_point():
        return out
    return torch.where((a == 0) & (b == 0), torch.where(
        torch.signbit(a), b, a).to(out.dtype), out)


def _minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum``: min(-0.0, +0.0) is -0.0 in either order."""
    out = torch.minimum(a, b)
    if not out.is_floating_point():
        return out
    return torch.where((a == 0) & (b == 0), torch.where(
        torch.signbit(a), a, b).to(out.dtype), out)


def _truncate_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``trunc(a / b)`` in ``a``'s dtype; on integers the quotient is a
    float first and saturates as :func:`_saturating_cast` (7 // 0 gives
    the type's maximum, as in JAX)."""
    q = torch.trunc(a / b)
    return q if a.is_floating_point() else _saturating_cast(q, a.dtype)


class Operation(Module):
    """Forward-only module (≙ nn/ops/Operation.scala: gradInput undefined)."""

    def backward(self, input, grad_output):
        raise RuntimeError(
            f"{type(self).__name__} is a forward-only Operation "
            "(reference: nn/ops/Operation.scala); differentiate through "
            "autograd instead")

    update_grad_input = backward

    @staticmethod
    def _pair(input):
        if isinstance(input, Table):
            return input[1], input[2]
        a, b = input
        return a, b


class ModuleToOperation(Operation):
    """Wrap any Module as a forward-only Operation
    (≙ nn/ops/ModuleToOperation.scala)."""

    def __init__(self, module: Module):
        super().__init__()
        self.module = module

    def forward(self, input):
        return self.module.forward(input)


def _unary(name, fn, doc):
    def forward(self, x, _fn=fn):
        return _fn(_tensor(x))

    return type(name, (Operation,), {"forward": forward, "__doc__": doc,
                                     "__module__": __name__})


Ceil = _unary("Ceil", torch.ceil, "≙ nn/ops/Ceil.scala")
Floor = _unary("Floor", torch.floor, "≙ nn/ops/Floor.scala")
Round = _unary("Round", torch.round, "≙ nn/ops/Round.scala (half to even)")
Rint = _unary("Rint", torch.round, "≙ nn/ops/Rint.scala (half to even)")
Exp = _unary("Exp", torch.exp, "≙ nn/ops/Exp.scala")
Expm1 = _unary("Expm1", torch.expm1, "≙ nn/ops/Expm1.scala")
Inv = _unary("Inv", lambda x: 1.0 / x, "≙ nn/ops/Inv.scala (reciprocal)")
Sign = _unary("Sign", _sign, "≙ nn/ops/Sign.scala")
Erf = _unary("Erf", torch.special.erf, "≙ nn/ops/Erf.scala")
Erfc = _unary("Erfc", torch.special.erfc, "≙ nn/ops/Erfc.scala")
Lgamma = _unary("Lgamma", torch.lgamma, "≙ nn/ops/Lgamma.scala")
Digamma = _unary("Digamma", _digamma, "≙ nn/ops/Digamma.scala")
IsFinite = _unary("IsFinite", torch.isfinite, "≙ nn/ops/IsFinite.scala")
IsInf = _unary("IsInf", torch.isinf, "≙ nn/ops/IsInf.scala")
IsNan = _unary("IsNan", torch.isnan, "≙ nn/ops/IsNan.scala")
LogicalNot = _unary("LogicalNot", torch.logical_not,
                    "≙ nn/ops/LogicalNot.scala")


class Cast(Operation):
    """≙ nn/ops/Cast.scala; ``dtype`` a numpy dtype, its name or a torch
    dtype. Float to integer saturates (see the module's docstring)."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = _torch_dtype(dtype)

    def forward(self, x):
        return _saturating_cast(_tensor(x), self.dtype)


def _binary(name, fn, doc):
    def forward(self, input, _fn=fn):
        return _fn(*_tensors(*self._pair(input)))

    return type(name, (Operation,), {"forward": forward, "__doc__": doc,
                                     "__module__": __name__})


# Integer division by zero (FloorDiv, Mod, FloorMod) is undefined in both
# packages: JAX gives -1 / -2 and 0, torch on the CPU raises
# ZeroDivisionError. No sync is spent to check for it.
Pow = _binary("Pow", torch.pow, "≙ nn/ops/Pow.scala")
FloorDiv = _binary("FloorDiv", torch.floor_divide, "≙ nn/ops/FloorDiv.scala")
FloorMod = _binary("FloorMod", torch.remainder, "≙ nn/ops/FloorMod.scala")
Mod = _binary("Mod", torch.remainder, "≙ nn/ops/Mod.scala")
TruncateDiv = _binary("TruncateDiv", _truncate_div,
                      "≙ nn/ops/TruncateDiv.scala")
SquaredDifference = _binary("SquaredDifference", lambda a, b: (a - b) ** 2,
                            "≙ nn/ops/SquaredDifference.scala")
Maximum = _binary("Maximum", _maximum, "≙ nn/ops/Maximum.scala")
Minimum = _binary("Minimum", _minimum, "≙ nn/ops/Minimum.scala")
Equal = _binary("Equal", torch.eq, "≙ nn/ops/Equal.scala")
NotEqual = _binary("NotEqual", torch.ne, "≙ nn/ops/NotEqual.scala")
Greater = _binary("Greater", torch.gt, "≙ nn/ops/Greater.scala")
GreaterEqual = _binary("GreaterEqual", torch.ge,
                       "≙ nn/ops/GreaterEqual.scala")
Less = _binary("Less", torch.lt, "≙ nn/ops/Less.scala")
LessEqual = _binary("LessEqual", torch.le, "≙ nn/ops/LessEqual.scala")
LogicalAnd = _binary("LogicalAnd", torch.logical_and,
                     "≙ nn/ops/LogicalAnd.scala")
LogicalOr = _binary("LogicalOr", torch.logical_or, "≙ nn/ops/LogicalOr.scala")


class ApproximateEqual(Operation):
    """≙ nn/ops/ApproximateEqual.scala."""

    def __init__(self, tolerance: float = 1e-5):
        super().__init__()
        self.tolerance = tolerance

    def forward(self, input):
        a, b = _tensors(*self._pair(input))
        return torch.abs(a - b) < self.tolerance


class _Reduce(Operation):
    def __init__(self, axis: Optional[Sequence[int]] = None,
                 keep_dims: bool = False):
        super().__init__()
        self.axis = tuple(axis) if axis is not None else None
        self.keep_dims = keep_dims

    def forward(self, x):
        x = _tensor(x)
        if x.dim() == 0:
            return self._red(x.reshape(1), 0, False)
        dims = range(x.dim()) if self.axis is None else self.axis
        for d in sorted({d % x.dim() for d in dims}, reverse=True):
            x = self._red(x, d, self.keep_dims)
        return x


class All(_Reduce):
    """≙ nn/ops/All.scala."""
    _red = staticmethod(lambda x, d, k: torch.all(x, dim=d, keepdim=k))


class Any(_Reduce):
    """≙ nn/ops/Any.scala."""
    _red = staticmethod(lambda x, d, k: torch.any(x, dim=d, keepdim=k))


class Max(_Reduce):
    """≙ nn/ops/Max.scala."""
    _red = staticmethod(lambda x, d, k: torch.amax(x, dim=d, keepdim=k))


class Prod(_Reduce):
    """≙ nn/ops/Prod.scala."""
    _red = staticmethod(lambda x, d, k: torch.prod(x, dim=d, keepdim=k))


class Sum(_Reduce):
    """≙ nn/ops/Sum.scala."""
    _red = staticmethod(lambda x, d, k: torch.sum(x, dim=d, keepdim=k))


class ArgMax(Operation):
    """≙ nn/ops/ArgMax.scala — axis comes with the input (TF style) or at
    construction."""

    def __init__(self, axis: Optional[int] = None):
        super().__init__()
        self.axis = axis

    def forward(self, input):
        if self.axis is not None:
            return torch.argmax(_tensor(input), dim=self.axis)
        x, axis = self._pair(input)
        return torch.argmax(_tensor(x), dim=_host_ints(axis)[0])


class BatchMatMul(Operation):
    """≙ nn/ops/BatchMatMul.scala (adj_x/adj_y transposes)."""

    def __init__(self, adj_x: bool = False, adj_y: bool = False):
        super().__init__()
        self.adj_x, self.adj_y = adj_x, adj_y

    def forward(self, input):
        a, b = _tensors(*self._pair(input))
        if self.adj_x:
            a = a.transpose(-1, -2)
        if self.adj_y:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class Gather(Operation):
    """≙ nn/ops/Gather.scala (TF Gather, ``jnp.take``'s wrap and fill)."""

    def __init__(self, axis: int = 0):
        super().__init__()
        self.axis = axis

    def forward(self, input):
        params, indices = _tensors(*self._pair(input))
        return _take(params, indices, self.axis)


class OneHot(Operation):
    """≙ nn/ops/OneHot.scala; an id out of range gives ``off_value``
    everywhere."""

    def __init__(self, depth: int, on_value: float = 1.0,
                 off_value: float = 0.0, axis: int = -1):
        super().__init__()
        self.depth, self.on, self.off, self.axis = (depth, on_value,
                                                    off_value, axis)

    def forward(self, indices):
        oh = _one_hot(indices, self.depth, self.axis)
        return oh * (self.on - self.off) + self.off


class TopK(Operation):
    """≙ nn/ops/TopK.scala — returns Table(values, indices), ties lowest
    index first as ``jax.lax.top_k`` (the model's stable descending
    sort)."""

    def __init__(self, k: int, sorted: bool = True):
        super().__init__()
        self.k = k

    def forward(self, x):
        from bigdl_tpu_torch.models.transformer import _top_k

        return Table(*_top_k(_tensor(x), self.k))


class InTopK(Operation):
    """≙ nn/ops/InTopK.scala — predictions (N, C), 0-based targets (N,)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, input):
        preds, targets = _tensors(*self._pair(input))
        target_scores = _take_rows(preds, targets)
        rank = torch.sum(preds > target_scores[:, None], dim=1)
        return rank < self.k


class Rank(Operation):
    """≙ nn/ops/Rank.scala."""

    def forward(self, x):
        x = _tensor(x)
        return torch.tensor(x.dim(), device=x.device)


class Shape(Operation):
    """Static shape as an integer vector (≙ nn/tf/Shape)."""

    def forward(self, x):
        x = _tensor(x)
        return torch.tensor(list(x.shape), dtype=torch.int64,
                            device=x.device)


class Select(Operation):
    """≙ nn/ops/Select.scala: (condition, then, else) elementwise pick."""

    def forward(self, input):
        if isinstance(input, Table):
            c, t, e = input[1], input[2], input[3]
        else:
            c, t, e = input
        c, t, e = _tensors(c, t, e)
        return torch.where(c.to(torch.bool), t, e)


class Slice(Operation):
    """≙ nn/ops/Slice.scala (begin/size, -1 size = to end)."""

    def __init__(self, begin: Sequence[int], size: Sequence[int]):
        super().__init__()
        self.begin, self.size = list(begin), list(size)

    def forward(self, x):
        x = _tensor(x)
        idx = tuple(
            slice(b, x.shape[d] if s == -1 else b + s)
            for d, (b, s) in enumerate(zip(self.begin, self.size)))
        return x[idx]


class Tile(Operation):
    """≙ nn/ops/Tile.scala."""

    def __init__(self, multiples: Optional[Sequence[int]] = None):
        super().__init__()
        self.multiples = multiples

    def forward(self, input):
        if self.multiples is not None:
            return torch.tile(_tensor(input), tuple(self.multiples))
        x, m = self._pair(input)
        return torch.tile(_tensor(x), tuple(_host_ints(m)))


class Pad(Operation):
    """≙ nn/ops/Pad.scala (constant padding)."""

    def __init__(self, paddings: Sequence[Sequence[int]], value: float = 0.0):
        super().__init__()
        self.paddings = tuple((int(a), int(b)) for a, b in paddings)
        self.value = value

    def forward(self, x):
        flat = [p for pair in reversed(self.paddings) for p in pair]
        return F.pad(_tensor(x), flat, value=self.value)


class RangeOps(Operation):
    """≙ nn/ops/RangeOps.scala, made on ``device``."""

    def __init__(self, start, limit, delta=1, *, device=DEFAULT_DEVICE):
        super().__init__()
        self.start, self.limit, self.delta = start, limit, delta
        self.device = resolve_device(device)

    def forward(self, input=None):
        return torch.arange(self.start, self.limit, self.delta,
                            device=self.device)


class L2Loss(Operation):
    """sum(x^2)/2 (≙ nn/ops/L2Loss.scala)."""

    def forward(self, x):
        x = _tensor(x)
        return torch.sum(x * x) / 2


class SegmentSum(Operation):
    """≙ nn/ops/SegmentSum.scala: rows of ``x`` summed by segment id, ids
    out of ``[0, num_segments)`` dropped (``jax.ops.segment_sum``).
    Without ``num_segments`` the largest id is read: one host sync."""

    def __init__(self, num_segments: Optional[int] = None):
        super().__init__()
        self.num_segments = num_segments

    def forward(self, input):
        x, ids = _tensors(*self._pair(input))
        ids = ids.to(torch.int64)
        n = self.num_segments or int(ids.max()) + 1
        valid = (ids >= 0) & (ids < n)
        rest = x.shape[ids.dim():]
        xm = torch.where(valid.reshape(valid.shape + (1,) * len(rest)), x, 0)
        return x.new_zeros((n,) + rest).index_add(
            0, torch.where(valid, ids, 0).reshape(-1),
            xm.reshape((-1,) + rest))


class CrossEntropy(Operation):
    """Softmax cross-entropy per row on (logits, 0-based labels)
    (≙ nn/ops/CrossEntropy.scala); NaN for a label out of range."""

    def forward(self, input):
        logits, labels = _tensors(*self._pair(input))
        logp = F.log_softmax(logits, dim=-1)
        return -_take_rows(logp, labels)


class _RandomOp(Operation):
    """A draw on ``device`` from ``generator`` (built from ``seed`` when
    given; else the device's default stream). ``bind_generator`` reaches
    it. JAX draws from threefry and the port from Philox (or the CPU's
    Mersenne Twister), so the two never give the same values."""

    draws_random = True

    def __init__(self, seed, generator, device):
        super().__init__()
        self.device = resolve_device(device)
        if generator is None and seed is not None:
            generator = torch.Generator(self.device).manual_seed(seed)
        self.seed = seed
        self.generator = generator

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(_host_ints(shape)), generator=self.generator,
                          device=self.device)


class RandomUniform(_RandomOp):
    """≙ nn/ops/RandomUniform.scala: ``minval + U[0, 1) * (maxval -
    minval)`` of the shape given as input, f32."""

    def __init__(self, minval: float = 0.0, maxval: float = 1.0, seed=None,
                 *, generator: Optional[torch.Generator] = None,
                 device=DEFAULT_DEVICE):
        super().__init__(seed, generator, device)
        self.minval, self.maxval = minval, maxval

    def forward(self, shape):
        return self._uniform(shape) * (self.maxval - self.minval) \
            + self.minval


_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))


class TruncatedNormal(_RandomOp):
    """≙ nn/ops/TruncatedNormal.scala (±2σ truncation): the inverse CDF of
    a uniform draw between Φ(-2) and Φ(2)."""

    def __init__(self, mean: float = 0.0, stddev: float = 1.0, seed=None,
                 *, generator: Optional[torch.Generator] = None,
                 device=DEFAULT_DEVICE):
        super().__init__(seed, generator, device)
        self.mean, self.stddev = mean, stddev

    def forward(self, shape):
        u = self._uniform(shape) * (-2.0 * _TRUNC_LO) + _TRUNC_LO
        z = (math.sqrt(2.0) * torch.erfinv(u)).clamp(-2.0, 2.0)
        return self.mean + self.stddev * z


class ResizeBilinearOp(Operation):
    """NHWC bilinear resize (≙ nn/ops/ResizeBilinear.scala):
    ``jax.image.resize``'s half-pixel form, antialiased along a dimension
    it shrinks; ``align_corners`` maps the corners onto each other by
    explicit gathers, as the JAX op does."""

    def __init__(self, out_height: int, out_width: int,
                 align_corners: bool = False):
        super().__init__()
        self.oh, self.ow = out_height, out_width
        self.align = align_corners

    def forward(self, x):
        x = _tensor(x)
        n, h, w, c = x.shape
        if self.align and h > 1 and w > 1:
            dt = x.dtype if x.is_floating_point() else torch.float32
            ys = torch.linspace(0, h - 1, self.oh, device=x.device, dtype=dt)
            xs = torch.linspace(0, w - 1, self.ow, device=x.device, dtype=dt)
            y0 = torch.floor(ys).to(torch.int64).clamp(0, h - 2)
            x0 = torch.floor(xs).to(torch.int64).clamp(0, w - 2)
            wy = (ys - y0)[None, :, None, None]
            wx = (xs - x0)[None, None, :, None]

            def g(yy, xx):
                return x[:, yy][:, :, xx]

            top = g(y0, x0) * (1 - wx) + g(y0, x0 + 1) * wx
            bot = g(y0 + 1, x0) * (1 - wx) + g(y0 + 1, x0 + 1) * wx
            return top * (1 - wy) + bot * wy
        from bigdl_tpu_torch.nn.shape_ops import ResizeBilinear as NCHW

        return NCHW(self.oh, self.ow)(x.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)


# ------------------------------------------------------------ feature columns

def _fnv1a(data: bytes) -> int:
    """Deterministic 64-bit FNV-1a (the reference relies on Scala
    MurmurHash; any fixed hash works as long as it is stable across runs)."""
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class BucketizedCol(Operation):
    """Continuous → bucket index by boundaries (≙ nn/ops/BucketizedCol.scala):
    ``searchsorted(boundaries, x, side="right")``, a value on a boundary in
    the bucket above it. The boundaries are f32, as in JAX, compared in
    the input's float dtype."""

    def __init__(self, boundaries: Sequence[float]):
        super().__init__()
        self.boundaries = torch.tensor(list(boundaries), dtype=torch.float32)

    def forward(self, x):
        x = _tensor(x)
        if not x.is_floating_point():
            x = x.to(torch.float32)
        return torch.bucketize(x, self.boundaries.to(x.device, x.dtype),
                               right=True)


class CategoricalColHashBucket(Operation):
    """String/int category → stable hash bucket
    (≙ nn/ops/CategoricalColHashBucket.scala). Hashes on the host; the
    buckets are made on ``device``."""

    def __init__(self, hash_bucket_size: int, *, device=DEFAULT_DEVICE):
        super().__init__()
        self.hash_bucket_size = hash_bucket_size
        self.device = resolve_device(device)

    def forward(self, values):
        arr = _host_array(values)
        out = [_fnv1a(str(v).encode()) % self.hash_bucket_size
               for v in arr.reshape(-1)]
        return torch.tensor(out, dtype=torch.int64,
                            device=self.device).reshape(arr.shape)


class IndicatorCol(Operation):
    """Category indices → multi-hot vector (≙ nn/ops/IndicatorCol.scala);
    an id out of range sets nothing."""

    def __init__(self, feat_len: int):
        super().__init__()
        self.feat_len = feat_len

    def forward(self, indices):
        oh = _one_hot(indices, self.feat_len)
        return oh.sum(dim=-2).clamp(0, 1) if oh.dim() > 2 else oh


class CrossCol(Operation):
    """Hash-crossed categorical columns (≙ nn/ops/CrossCol.scala): a list
    of equal-length string/int columns, hashed on the host; the buckets
    are made on ``device``."""

    def __init__(self, hash_bucket_size: int, *, device=DEFAULT_DEVICE):
        super().__init__()
        self.hash_bucket_size = hash_bucket_size
        self.device = resolve_device(device)

    def forward(self, columns):
        cols = [_host_array(c).reshape(-1) for c in
                (columns if isinstance(columns, (list, tuple))
                 else list(columns))]
        out = [_fnv1a("_X_".join(str(c[i]) for c in cols).encode())
               % self.hash_bucket_size for i in range(len(cols[0]))]
        return torch.tensor(out, dtype=torch.int64, device=self.device)


class Kv2Tensor(Operation):
    """'k:v' string pairs → dense vector (≙ nn/ops/Kv2Tensor.scala),
    parsed on the host, made on ``device``."""

    def __init__(self, kv_delimiter: str = ",", item_delimiter: str = ":",
                 feat_len: int = 0, *, device=DEFAULT_DEVICE):
        super().__init__()
        self.kv_delimiter = kv_delimiter
        self.item_delimiter = item_delimiter
        self.feat_len = feat_len
        self.device = resolve_device(device)

    def forward(self, rows):
        rows = _host_array(rows).reshape(-1)
        out = np.zeros((len(rows), self.feat_len), np.float32)
        for i, row in enumerate(rows):
            for item in str(row).split(self.kv_delimiter):
                if not item:
                    continue
                k, v = item.split(self.item_delimiter)
                out[i, int(k)] = float(v)
        return torch.from_numpy(out).to(self.device)


class MkString(Operation):
    """Sparse row → joined string (≙ nn/ops/MkString.scala), on the host:
    a numpy array of strings."""

    def __init__(self, str_delimiter: str = ","):
        super().__init__()
        self.str_delimiter = str_delimiter

    def forward(self, rows):
        arr = _host_array(rows)
        return np.asarray([self.str_delimiter.join(str(v) for v in row)
                           for row in arr.reshape(arr.shape[0], -1)])


class CategoricalColVocaList(Operation):
    """Delimited category strings → (rows, cols) sparse-layout indices
    (≙ nn/ops/CategoricalColVocaList.scala). Parsed on the host; returns a
    :class:`~bigdl_tpu_torch.nn.sparse.SparseTensor` of per-row vocabulary
    ids on ``device``. Out-of-vocabulary handling: filtered when
    ``is_set_default=False`` and ``num_oov_buckets=0``, mapped to the
    default id ``len(voca)`` when ``is_set_default``, or hashed into
    ``[len(voca), len(voca)+num_oov_buckets)`` otherwise."""

    def __init__(self, voca_list: Sequence[str], str_delimiter: str = ",",
                 is_set_default: bool = False, num_oov_buckets: int = 0, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        if num_oov_buckets < 0:
            raise ValueError("num_oov_buckets is a negative integer")
        if is_set_default and num_oov_buckets:
            raise ValueError(
                "default value and num_oov_buckets are both specified")
        if not voca_list:
            raise ValueError("the vocabulary list is empty")
        self.voca = {v: i for i, v in enumerate(voca_list)}
        if len(self.voca) != len(voca_list):
            raise ValueError("the vocabulary list has duplicates")
        self.str_delimiter = str_delimiter
        self.is_set_default = is_set_default
        self.num_oov_buckets = num_oov_buckets
        self.device = resolve_device(device)

    def forward(self, values):
        from bigdl_tpu_torch.nn.sparse import SparseTensor

        voca_len = len(self.voca)
        rows_in = [str(v) for v in _host_array(values).reshape(-1)]
        cols = (voca_len + self.num_oov_buckets if self.num_oov_buckets
                else voca_len + (1 if self.is_set_default else 0))
        idx, vals = [], []
        for i, row in enumerate(rows_in):
            feats = row.split(self.str_delimiter)
            if not self.is_set_default and not self.num_oov_buckets:
                feats = [f for f in feats if f in self.voca]
            if len(feats) > cols:
                raise ValueError(
                    f"row {i} has {len(feats)} features but the output shape "
                    f"allows at most {cols} per row")
            for j, f in enumerate(feats):
                if self.num_oov_buckets:
                    v = self.voca.get(
                        f, _fnv1a(f.encode()) % self.num_oov_buckets + voca_len)
                else:
                    v = self.voca.get(f, voca_len)
                idx.append([i, j])
                vals.append(v)
        return SparseTensor.coo(np.asarray(idx, np.int64).reshape(-1, 2).T,
                                np.asarray(vals, np.int64),
                                (len(rows_in), cols), device=self.device)


class Compare(Operation):
    """Base elementwise comparison against the reference's abstract
    nn/ops/Compare.scala; concrete subclasses pin ``compare_fn``. The
    factory-built Greater/Less/Equal/... ops above are the instances
    imported TF graphs use; this class exists for user subclassing."""

    compare_fn = None

    def forward(self, input):
        a, b = _tensors(*self._pair(input))
        if self.compare_fn is None:
            raise NotImplementedError("subclass Compare with compare_fn")
        return type(self).compare_fn(a, b)


class DepthwiseConv2D(Operation):
    """Depthwise conv taking (input, filter) as runtime activations
    (≙ nn/ops/DepthwiseConv2D.scala). Filter is HWIM (kh, kw, in_channels,
    channel_multiplier), the TF convention; data_format NHWC or NCHW.
    Output channel ``c * mult + m`` is input channel ``c`` under filter
    ``[:, :, c, m]``."""

    def __init__(self, stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0, data_format: str = "NHWC"):
        super().__init__()
        self.strides = (stride_h, stride_w)
        self.pads = (pad_h, pad_w)
        self.data_format = data_format

    def forward(self, input):
        x, filt = _tensors(*self._pair(input))
        kh, kw, cin, mult = filt.shape
        w = filt.permute(2, 3, 0, 1).reshape(cin * mult, 1, kh, kw)
        nhwc = self.data_format == "NHWC"
        if nhwc:
            x = x.permute(0, 3, 1, 2)
        out = F.conv2d(x, w, stride=self.strides, padding=self.pads,
                       groups=cin)
        return out.permute(0, 2, 3, 1) if nhwc else out


class Dilation2D(Operation):
    """Grayscale morphological dilation (≙ nn/ops/Dilation2D.scala, the TF
    op): ``out[y, x, c] = max_{dy, dx} in[y*s + dy*r, x*s + dx*r, c]
    + filter[dy, dx, c]`` over NHWC input, padded with -inf; SAME pads as
    TF (the smaller half first)."""

    def __init__(self, strides: Sequence[int], rates: Sequence[int],
                 padding: str = "SAME"):
        super().__init__()
        self.strides = list(strides)  # (1, sh, sw, 1), TF layout
        self.rates = list(rates)
        self.padding = padding.upper()

    def forward(self, input):
        x, filt = _tensors(*self._pair(input))
        n, h, w, c = x.shape
        kh, kw, _ = filt.shape
        sh, sw = self.strides[1], self.strides[2]
        rh, rw = self.rates[1], self.rates[2]
        eff_kh, eff_kw = (kh - 1) * rh + 1, (kw - 1) * rw + 1
        if self.padding == "SAME":
            oh = -(-h // sh)
            ow = -(-w // sw)
            pad_h = max((oh - 1) * sh + eff_kh - h, 0)
            pad_w = max((ow - 1) * sw + eff_kw - w, 0)
            pads = ((pad_h // 2, pad_h - pad_h // 2),
                    (pad_w // 2, pad_w - pad_w // 2))
        else:
            oh = (h - eff_kh) // sh + 1
            ow = (w - eff_kw) // sw + 1
            pads = ((0, 0), (0, 0))
        xp = F.pad(x, (0, 0, *pads[1], *pads[0]), value=-math.inf)
        out = None
        for dy in range(kh):
            for dx in range(kw):
                patch = xp[:, dy * rh:dy * rh + (oh - 1) * sh + 1:sh,
                           dx * rw:dx * rw + (ow - 1) * sw + 1:sw, :]
                cand = patch + filt[dy, dx][None, None, None, :]
                out = cand if out is None else torch.maximum(out, cand)
        return out


class Substr(Operation):
    """Scalar-string substring (≙ nn/ops/Substr.scala), on the host: input
    Table(data, pos, len) of scalar values."""

    def forward(self, input):
        data, pos, ln = list(input)[:3]
        s = data if isinstance(data, (str, bytes)) else \
            _host_array(data).item()
        p, n = _host_ints(pos)[0], _host_ints(ln)[0]
        return s[p:p + n]


class TensorOp(Operation):
    """Composable tensor-function op (≙ nn/ops/TensorOp.scala): wraps a
    ``fn(tensor) -> tensor`` and supports the reference's combinator
    algebra (``+ - * /`` with scalars/tensors, chained transformations)."""

    def __init__(self, fn=None):
        super().__init__()
        self._fn = fn or (lambda x: x)

    def forward(self, x):
        return self._fn(_tensor(x))

    # ---------------------------------------------------------- combinators
    def then(self, g) -> "TensorOp":
        f = self._fn
        return TensorOp(lambda x: g(f(x)))

    def __add__(self, other):
        return self.then(lambda y: y + other)

    def __sub__(self, other):
        return self.then(lambda y: y - other)

    def __mul__(self, other):
        return self.then(lambda y: y * other)

    def __truediv__(self, other):
        return self.then(lambda y: y / other)

    def __pow__(self, p):
        return self.then(lambda y: y ** p)

    # named transforms from the reference's TensorOp object
    def abs(self):
        return self.then(torch.abs)

    def sqrt(self):
        return self.then(torch.sqrt)

    def log(self):
        return self.then(torch.log)

    def exp(self):
        return self.then(torch.exp)

    def sigmoid(self):
        return self.then(torch.sigmoid)

    def tanh(self):
        return self.then(torch.tanh)


# the TF graph importer and the reference's docs use the bare name
ResizeBilinear = ResizeBilinearOp
