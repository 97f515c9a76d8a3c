"""Shape and indexing layers (port of ``bigdl_tpu/nn/shape_ops.py``).

Dimensions are 1-based and a negative one counts from the end, each
layer mapping them to an axis with the JAX expression of its twin
(``_axis``, or ``dim - 1`` where the JAX layer writes that). ``Reshape``
and ``View`` keep the JAX package's batch inference: the leading
dimension is kept as a batch dimension when the element count does not
match the requested shape. ``Index`` takes 1-based indices.

Two layers keep a JAX form on purpose: ``MaskedSelect`` returns a dense
copy with the unmasked entries zeroed (JAX's static-shape form, not
``torch.masked_select``'s packed vector), and ``ResizeBilinear`` resizes
as ``jax.image.resize(method="bilinear")`` does, half-pixel centres with
a triangle filter widened when it shrinks (antialiased). With
``align_corners=True``, which the JAX layer stores and ignores, it
resizes as the reference does, the corner pixels' centres aligned.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


def _axis(dim: int, ndim: int, batched: bool = False) -> int:
    """1-based (possibly negative) dim -> 0-based axis."""
    if dim > 0:
        return dim - 1 + (1 if batched else 0)
    return ndim + dim


def _batched(input, num_input_dims: int) -> bool:
    return bool(num_input_dims) and input.dim() == num_input_dims + 1


class Reshape(Module):
    """Reshape the non-batch dims. ``batch_mode`` None infers: dim 0 is
    the batch iff the element count does not match ``size``."""

    def __init__(self, size, batch_mode=None):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, input):
        numel = math.prod(self.size)
        if self.batch_mode is True or (
                self.batch_mode is None and input.numel() != numel):
            return input.reshape((input.shape[0],) + self.size)
        return input.reshape(self.size)


class View(Module):
    """Reshape with -1 support and batch passthrough.
    ``set_num_input_dims`` records the count, as the JAX layer does; the
    batch inference above does not read it there either."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def forward(self, input):
        numel = math.prod(s for s in self.sizes if s != -1)
        infer = -1 in self.sizes
        if input.numel() == numel or (
                infer and input.numel() % max(1, numel) == 0
                and input.dim() <= len(self.sizes)):
            return input.reshape(self.sizes)
        return input.reshape((input.shape[0],) + self.sizes)


class Squeeze(Module):
    """Drop size-1 ``dim`` (an int or a sequence; None: every size-1
    dim)."""

    def __init__(self, dim=None, num_input_dims: int = 0):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def forward(self, input):
        if self.dim is None:
            return input.squeeze()
        batched = _batched(input, self.num_input_dims)
        dims = self.dim if isinstance(self.dim, (tuple, list)) else (self.dim,)
        return input.squeeze(tuple(_axis(d, input.dim(), batched)
                                   for d in dims))


class Unsqueeze(Module):
    def __init__(self, pos: int, num_input_dims: int = 0):
        super().__init__()
        self.pos = pos
        self.num_input_dims = num_input_dims

    def forward(self, input):
        batched = _batched(input, self.num_input_dims)
        return input.unsqueeze(_axis(self.pos, input.dim() + 1, batched))


class Transpose(Module):
    """A sequence of pairwise swaps of 1-based dims."""

    def __init__(self, permutations):
        super().__init__()
        self.permutations = list(permutations)

    def forward(self, input):
        x = input
        for d1, d2 in self.permutations:
            x = x.transpose(_axis(d1, x.dim()), _axis(d2, x.dim()))
        return x


class Select(Module):
    """Index ``index`` (1-based; negative: from the end) along ``dim``,
    which is removed."""

    def __init__(self, dim: int, index: int):
        super().__init__()
        self.dim, self.index = dim, index

    def forward(self, input):
        ax = _axis(self.dim, input.dim())
        idx = self.index - 1 if self.index > 0 else input.shape[ax] + self.index
        return input.select(ax, idx)


class Narrow(Module):
    """``length`` entries from 1-based ``offset`` along ``dimension``;
    a negative offset counts from the end, a length <= 0 up to the end."""

    def __init__(self, dimension: int, offset: int, length: int = 1):
        super().__init__()
        self.dimension, self.offset, self.length = dimension, offset, length

    def forward(self, input):
        ax = _axis(self.dimension, input.dim())
        size = input.shape[ax]
        start = self.offset - 1 if self.offset > 0 else size + self.offset
        length = (self.length if self.length > 0
                  else size - start + self.length + 1)
        idx = [slice(None)] * input.dim()
        idx[ax] = slice(start, start + length)
        return input[tuple(idx)]


class Replicate(Module):
    """Insert a dim of size ``n_features`` at 1-based ``dim``."""

    def __init__(self, n_features: int, dim: int = 1,
                 n_dim: int = float("inf")):
        super().__init__()
        self.n_features, self.dim = n_features, dim

    def forward(self, input):
        x = input.unsqueeze(self.dim - 1)
        reps = [1] * x.dim()
        reps[self.dim - 1] = self.n_features
        return x.repeat(reps)


class Tile(Module):
    """Repeat ``copies`` times along 1-based ``dim``."""

    def __init__(self, dim: int = 1, copies: int = 2):
        super().__init__()
        self.dim, self.copies = dim, copies

    def forward(self, input):
        reps = [1] * input.dim()
        reps[_axis(self.dim, input.dim())] = self.copies
        return input.repeat(reps)


class Padding(Module):
    """Pad ``|pad|`` entries of ``value`` along 1-based ``dim`` (after
    it, before it when ``pad`` < 0); the dim moves past a batch dim
    when the input has ``n_input_dim`` + 1 dims."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim, self.pad, self.n_input_dim, self.value = (
            dim, pad, n_input_dim, value)

    def forward(self, input):
        batched = input.dim() == self.n_input_dim + 1
        ax = self.dim - 1 + (1 if batched else 0)
        ax = ax % input.dim()
        before, after = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        pads = [0, 0] * (input.dim() - 1 - ax) + [before, after]
        return F.pad(input, pads, value=self.value)


class SpatialZeroPadding(Module):
    """Zero-pad the last two dims (H, W of NCHW)."""

    def __init__(self, pad_left: int, pad_right: int = None,
                 pad_top: int = None, pad_bottom: int = None):
        super().__init__()
        self.pl = pad_left
        self.pr = pad_right if pad_right is not None else pad_left
        self.pt = pad_top if pad_top is not None else pad_left
        self.pb = pad_bottom if pad_bottom is not None else pad_left

    def forward(self, input):
        return F.pad(input, (self.pl, self.pr, self.pt, self.pb))


class Contiguous(Module):
    def forward(self, input):
        return input.contiguous()


class Index(Module):
    """``index_select`` of ``input[1]`` along ``dimension`` (``dimension
    - 1`` as an axis, as in JAX) at the 1-based indices ``input[2]``."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input):
        t, idx = input[1], input[2]
        return torch.index_select(t, self.dimension - 1, idx.long() - 1)


class MaskedSelect(Module):
    """``input[1]`` where the mask ``input[2]`` is set, 0 elsewhere: a
    dense copy of the input's shape, as the JAX layer returns."""

    def forward(self, input):
        t, mask = input[1], input[2]
        return torch.where(mask.bool(), t, 0.0)


class Masking(Module):
    """Zero the time steps whose features all equal ``mask_value``."""

    def __init__(self, mask_value: float = 0.0):
        super().__init__()
        self.mask_value = mask_value

    def forward(self, input):
        keep = (input != self.mask_value).any(dim=-1, keepdim=True)
        return input * keep.to(input.dtype)


class Reverse(Module):
    """Flip along 1-based ``dimension``."""

    def __init__(self, dimension: int = 1, is_inplace: bool = False):
        super().__init__()
        self.dimension = dimension

    def forward(self, input):
        return input.flip(_axis(self.dimension, input.dim()))


class InferReshape(Module):
    """Reshape with -1 (inferred) and 0 (the input's dim) entries;
    ``batch_mode`` keeps dim 0 as the batch."""

    def __init__(self, size, batch_mode: bool = False):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, input):
        in_shape = input.shape[1:] if self.batch_mode else input.shape
        out = tuple(in_shape[i] if s == 0 else s
                    for i, s in enumerate(self.size))
        if self.batch_mode:
            return input.reshape((input.shape[0],) + out)
        return input.reshape(out)


class Cropping2D(Module):
    """Crop (before, after) entries of H and W (NCHW, or NHWC)."""

    def __init__(self, height_crop=(0, 0), width_crop=(0, 0),
                 data_format: str = "NCHW"):
        super().__init__()
        self.hc, self.wc = tuple(height_crop), tuple(width_crop)
        self.data_format = data_format

    def forward(self, input):
        h0, h1 = self.hc
        w0, w1 = self.wc
        if self.data_format == "NCHW":
            return input[..., h0:input.shape[-2] - h1,
                         w0:input.shape[-1] - w1]
        return input[..., h0:input.shape[-3] - h1,
                     w0:input.shape[-2] - w1, :]


class Cropping3D(Module):
    def __init__(self, dim1_crop=(0, 0), dim2_crop=(0, 0),
                 dim3_crop=(0, 0)):
        super().__init__()
        self.crops = (tuple(dim1_crop), tuple(dim2_crop), tuple(dim3_crop))

    def forward(self, input):
        (a0, a1), (b0, b1), (c0, c1) = self.crops
        return input[..., a0:input.shape[-3] - a1,
                     b0:input.shape[-2] - b1, c0:input.shape[-1] - c1]


class UpSampling1D(Module):
    """Repeat each step of (batch, time, features) ``length`` times."""

    def __init__(self, length: int):
        super().__init__()
        self.length = length

    def forward(self, input):
        return input.repeat_interleave(self.length, dim=1)


class UpSampling2D(Module):
    """Nearest-neighbour upsampling of the last two dims."""

    def __init__(self, size=(2, 2)):
        super().__init__()
        self.size = tuple(size)

    def forward(self, input):
        x = input.repeat_interleave(self.size[0], dim=-2)
        return x.repeat_interleave(self.size[1], dim=-1)


class UpSampling3D(Module):
    def __init__(self, size=(2, 2, 2)):
        super().__init__()
        self.size = tuple(size)

    def forward(self, input):
        x = input.repeat_interleave(self.size[0], dim=-3)
        x = x.repeat_interleave(self.size[1], dim=-2)
        return x.repeat_interleave(self.size[2], dim=-1)


class ResizeBilinear(Module):
    """Bilinear resize of NCHW (or CHW) to (``output_height``,
    ``output_width``): ``jax.image.resize``'s half-pixel form,
    antialiased along a dimension it shrinks; ``align_corners=True``
    the corner-aligned form."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False):
        super().__init__()
        self.oh, self.ow = output_height, output_width
        self.align_corners = align_corners

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        size = (self.oh, self.ow)
        if self.align_corners:
            out = F.interpolate(x, size=size, mode="bilinear",
                                align_corners=True)
        else:
            shrinks = self.oh < x.shape[-2] or self.ow < x.shape[-1]
            out = F.interpolate(x, size=size, mode="bilinear",
                                align_corners=False, antialias=shrinks)
        return out[0] if squeeze else out


class Pack(Module):
    """Stack a table of tensors along a new 1-based ``dimension``."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input):
        ts = list(input) if isinstance(input, (Table, list, tuple)) else [input]
        return torch.stack(ts, dim=self.dimension - 1)
