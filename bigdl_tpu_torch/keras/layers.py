"""Keras-1.2.2-style layers (port of ``bigdl_tpu/keras/layers.py``;
reference: nn/keras/ — Appendix A.4 list).

Each wrapper lazily builds the underlying ``bigdl_tpu_torch.nn`` module(s)
from the inferred input shape ('th' channel-first ordering, as the
reference's keras API uses) on the layer's ``device``.
``activation=`` strings map to nn activations. The small modules the
JAX package defines inside ``build_module`` (the permute, the global
pools, the 1-D and 3-D pads and crops) are module-level classes here, so
a keras model saves with ``save_module`` and loads back; each computes
what the JAX one's ``jnp`` call does. ``AveragePooling2D`` takes
``border_mode`` ("valid" only): the JAX converter passes it, and JAX's
layer has no such parameter.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.keras.engine import KerasLayer
from bigdl_tpu_torch.nn.module import Module

_ACTIVATIONS = {
    "relu": nn.ReLU, "tanh": nn.Tanh, "sigmoid": nn.Sigmoid,
    "hard_sigmoid": nn.HardSigmoid, "softmax": nn.SoftMax,
    "softplus": nn.SoftPlus, "softsign": nn.SoftSign,
    "log_softmax": nn.LogSoftMax, "linear": nn.Identity,
}


def get_activation(name):
    if name is None:
        return None
    if isinstance(name, Module):
        return name
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]()


def _with_activation(module: Module, activation) -> Module:
    act = get_activation(activation)
    if act is None:
        return module
    return nn.Sequential(module, act)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


# ------------------------------------------ the inline modules, module-level
class _Permute(Module):
    """Keras ``Permute``: 1-based dims over the non-batch axes."""

    def __init__(self, dims):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute((0,) + self.dims)


class _HighwayModule(Module):
    """y = T(x)*H(x) + (1-T(x))*x (reference: nn/Highway.scala)."""

    def __init__(self, size: int, activation=None, with_bias: bool = True, *,
                 device=None):
        super().__init__()
        kw = {} if device is None else {"device": device}
        self.proj = nn.Linear(size, size, with_bias=with_bias, **kw)
        self.gate = nn.Linear(size, size, with_bias=with_bias, **kw)
        self.act = get_activation(activation) or nn.Tanh()

    def forward(self, x):
        t = 1.0 / (1.0 + torch.exp(-self.gate(x)))
        h = self.act(self.proj(x))
        return t * h + (1 - t) * x


class _AvgPool1D(Module):
    """Average pooling over the time axis of (B, T, F)."""

    def __init__(self, pool_length: int, stride: int):
        super().__init__()
        self.pool_length, self.stride = pool_length, stride

    def forward(self, x):
        y = x.permute(0, 2, 1)[:, :, None, :]            # (B, F, 1, T)
        p = nn.SpatialAveragePooling(self.pool_length, 1, self.stride, 1)(y)
        return p[:, :, 0, :].permute(0, 2, 1)


class _Reduce(Module):
    """Max or mean over ``dims`` (the global pools)."""

    def __init__(self, kind: str, dims):
        super().__init__()
        self.kind, self.dims = kind, tuple(dims)

    def forward(self, x):
        if self.kind == "max":
            return torch.amax(x, dim=self.dims)
        return torch.mean(x, dim=self.dims)


class _ConcatMerge(Module):
    """Concatenate a table along a keras (full-tensor) axis, -1 the last."""

    def __init__(self, axis: int):
        super().__init__()
        self.axis = axis

    def forward(self, table):
        return torch.cat(list(table), dim=self.axis)


class _ZeroPad(Module):
    """Zeros before and after each of the trailing axes: ``pads`` per axis,
    outermost first (``jnp.pad`` of the JAX 1-D and 3-D pads)."""

    def __init__(self, pads):
        super().__init__()
        self.pads = tuple(int(p) for p in pads)

    def forward(self, x):
        flat = []
        for p in reversed(self.pads):
            flat += [p, p]
        return F.pad(x, flat)


class _Crop1D(Module):
    def __init__(self, cropping):
        super().__init__()
        self.cropping = tuple(cropping)

    def forward(self, x):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b]


class _Atrous1D(Module):
    """(B, T, F) -> (B, F, T, 1) -> dilated conv -> (B, T', nb)."""

    def __init__(self, conv: Module):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        y = self.conv(x.permute(0, 2, 1)[:, :, :, None])
        return y[:, :, :, 0].permute(0, 2, 1)


class Dense(KerasLayer):
    """≙ nn/keras/Dense.scala. Applies to the last dim of N-D input."""

    def __init__(self, output_dim: int, activation=None, bias: bool = True,
                 W_regularizer=None, b_regularizer=None, input_shape=None,
                 input_dim=None, **kw):
        if input_dim is not None and input_shape is None:
            input_shape = (input_dim,)
        super().__init__(input_shape=input_shape, **kw)
        self.output_dim = output_dim
        self.activation = activation
        self.bias = bias
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer

    def build_module(self, input_shape):
        linear = self.make(nn.Linear, input_shape[-1], self.output_dim,
                           with_bias=self.bias,
                           w_regularizer=self.W_regularizer,
                           b_regularizer=self.b_regularizer)
        if len(input_shape) > 1:
            linear = nn.Bottle(linear, n_input_dim=2)
        return _with_activation(linear, self.activation)


class Activation(KerasLayer):
    def __init__(self, activation, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.activation = activation

    def build_module(self, input_shape):
        return get_activation(self.activation)


class Dropout(KerasLayer):
    def __init__(self, p: float, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.p = p

    def build_module(self, input_shape):
        return nn.Dropout(self.p)


class Flatten(KerasLayer):
    def build_module(self, input_shape):
        n = 1
        for s in input_shape:
            n *= s
        return nn.Reshape((n,))


class Reshape(KerasLayer):
    def __init__(self, target_shape, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.target_shape = tuple(target_shape)

    def build_module(self, input_shape):
        return nn.Reshape(self.target_shape)


class Permute(KerasLayer):
    def __init__(self, dims, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.dims = tuple(dims)

    def build_module(self, input_shape):
        return _Permute(self.dims)


class RepeatVector(KerasLayer):
    def __init__(self, n: int, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.n = n

    def build_module(self, input_shape):
        return nn.Replicate(self.n, dim=2)


class Masking(KerasLayer):
    def __init__(self, mask_value: float = 0.0, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.mask_value = mask_value

    def build_module(self, input_shape):
        return nn.Masking(self.mask_value)


class Highway(KerasLayer):
    def __init__(self, activation=None, bias: bool = True, input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.activation, self.bias_flag = activation, bias

    def build_module(self, input_shape):
        return _HighwayModule(input_shape[-1], self.activation,
                              self.bias_flag, device=self.device)


class MaxoutDense(KerasLayer):
    def __init__(self, output_dim: int, nb_feature: int = 4, input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.output_dim, self.nb_feature = output_dim, nb_feature

    def build_module(self, input_shape):
        return self.make(nn.Maxout, input_shape[-1], self.output_dim,
                         self.nb_feature)


# ------------------------------------------------------------ convolution
class Convolution2D(KerasLayer):
    """≙ nn/keras/Convolution2D.scala — th ordering (C, H, W)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode: str = "valid",
                 subsample=(1, 1), bias: bool = True,
                 W_regularizer=None, b_regularizer=None, input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = _pair(subsample)
        self.bias = bias
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer

    def build_module(self, input_shape):
        c = input_shape[0]
        if self.border_mode == "same":
            pw, ph = (self.nb_col - 1) // 2, (self.nb_row - 1) // 2
        else:
            pw = ph = 0
        conv = self.make(
            nn.SpatialConvolution, c, self.nb_filter, self.nb_col,
            self.nb_row, self.subsample[1], self.subsample[0], pw, ph,
            with_bias=self.bias, w_regularizer=self.W_regularizer,
            b_regularizer=self.b_regularizer)
        return _with_activation(conv, self.activation)


class Convolution1D(KerasLayer):
    """(B, T, F) temporal conv (≙ nn/keras/Convolution1D.scala)."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 subsample_length: int = 1, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.nb_filter, self.filter_length = nb_filter, filter_length
        self.activation = activation
        self.subsample_length = subsample_length

    def build_module(self, input_shape):
        conv = self.make(nn.TemporalConvolution, input_shape[-1],
                         self.nb_filter, self.filter_length,
                         self.subsample_length)
        return _with_activation(conv, self.activation)


class SeparableConvolution2D(KerasLayer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 depth_multiplier: int = 1, activation=None,
                 subsample=(1, 1), bias: bool = True, input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.depth_multiplier = depth_multiplier
        self.activation = activation
        self.subsample = _pair(subsample)
        self.bias = bias

    def build_module(self, input_shape):
        conv = self.make(
            nn.SpatialSeparableConvolution, input_shape[0], self.nb_filter,
            self.depth_multiplier, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], with_bias=self.bias)
        return _with_activation(conv, self.activation)


class Deconvolution2D(KerasLayer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.subsample = _pair(subsample)

    def build_module(self, input_shape):
        conv = self.make(
            nn.SpatialFullConvolution, input_shape[0], self.nb_filter,
            self.nb_col, self.nb_row, self.subsample[1], self.subsample[0])
        return _with_activation(conv, self.activation)


class AtrousConvolution2D(KerasLayer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 atrous_rate=(1, 1), activation=None, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.atrous_rate = _pair(atrous_rate)
        self.activation = activation

    def build_module(self, input_shape):
        conv = self.make(
            nn.SpatialDilatedConvolution, input_shape[0], self.nb_filter,
            self.nb_col, self.nb_row, dilation_w=self.atrous_rate[1],
            dilation_h=self.atrous_rate[0])
        return _with_activation(conv, self.activation)


class LocallyConnected2D(KerasLayer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation

    def build_module(self, input_shape):
        c, h, w = input_shape
        conv = self.make(nn.LocallyConnected2D, c, w, h, self.nb_filter,
                         self.nb_col, self.nb_row)
        return _with_activation(conv, self.activation)


# ---------------------------------------------------------------- pooling
class MaxPooling2D(KerasLayer):
    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool_size
        self.border_mode = border_mode

    def build_module(self, input_shape):
        p = nn.SpatialMaxPooling(self.pool_size[1], self.pool_size[0],
                                 self.strides[1], self.strides[0])
        if self.border_mode == "same":
            p.ceil()
        return p


class AveragePooling2D(KerasLayer):
    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 input_shape=None, **kw):
        if border_mode != "valid":
            raise ValueError(
                f"AveragePooling2D border_mode={border_mode!r}: only 'valid' "
                "is supported")
        super().__init__(input_shape=input_shape, **kw)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool_size

    def build_module(self, input_shape):
        return nn.SpatialAveragePooling(self.pool_size[1], self.pool_size[0],
                                        self.strides[1], self.strides[0])


class MaxPooling1D(KerasLayer):
    def __init__(self, pool_length: int = 2, stride=None, input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.pool_length = pool_length
        self.stride = stride if stride is not None else pool_length

    def build_module(self, input_shape):
        return nn.TemporalMaxPooling(self.pool_length, self.stride)


class AveragePooling1D(KerasLayer):
    def __init__(self, pool_length: int = 2, stride=None, input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.pool_length = pool_length
        self.stride = stride if stride is not None else pool_length

    def build_module(self, input_shape):
        return _AvgPool1D(self.pool_length, self.stride)


class GlobalMaxPooling2D(KerasLayer):
    def build_module(self, input_shape):
        return _Reduce("max", (2, 3))


class GlobalAveragePooling2D(KerasLayer):
    def build_module(self, input_shape):
        return _Reduce("mean", (2, 3))


class GlobalMaxPooling1D(KerasLayer):
    def build_module(self, input_shape):
        return _Reduce("max", (1,))


class GlobalAveragePooling1D(KerasLayer):
    def build_module(self, input_shape):
        return _Reduce("mean", (1,))


# ---------------------------------------------------------- normalization
class BatchNormalization(KerasLayer):
    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.epsilon, self.momentum = epsilon, momentum

    def build_module(self, input_shape):
        if len(input_shape) == 3:
            return self.make(nn.SpatialBatchNormalization, input_shape[0],
                             self.epsilon, 1.0 - self.momentum)
        return self.make(nn.BatchNormalization, input_shape[-1],
                         self.epsilon, 1.0 - self.momentum)


# -------------------------------------------------------------- embedding
class Embedding(KerasLayer):
    """0-based int ids -> dense vectors (≙ nn/keras/Embedding.scala,
    which shifts to the 1-based LookupTable)."""

    _infer_dtype = torch.int64

    def __init__(self, input_dim: int, output_dim: int, input_shape=None,
                 input_length=None, **kw):
        if input_length is not None and input_shape is None:
            input_shape = (input_length,)
        super().__init__(input_shape=input_shape, **kw)
        self.input_dim, self.output_dim = input_dim, output_dim

    def build_module(self, input_shape):
        return nn.Sequential(nn.AddConstant(1.0), self.make(
            nn.LookupTable, self.input_dim, self.output_dim))


# ------------------------------------------------------------------ noise
class GaussianNoise(KerasLayer):
    def __init__(self, sigma: float, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.sigma = sigma

    def build_module(self, input_shape):
        return nn.GaussianNoise(self.sigma)


class GaussianDropout(KerasLayer):
    def __init__(self, p: float, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.p = p

    def build_module(self, input_shape):
        return nn.GaussianDropout(self.p)


class SpatialDropout1D(KerasLayer):
    def __init__(self, p: float = 0.5, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.p = p

    def build_module(self, input_shape):
        return nn.SpatialDropout1D(self.p)


class SpatialDropout2D(KerasLayer):
    def __init__(self, p: float = 0.5, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.p = p

    def build_module(self, input_shape):
        return nn.SpatialDropout2D(self.p)


# -------------------------------------------------------------- recurrent
class _KerasRecurrent(KerasLayer):
    cell_cls = None

    def __init__(self, output_dim: int, activation=None,
                 inner_activation=None, return_sequences: bool = False,
                 go_backwards: bool = False, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.output_dim = output_dim
        self.activation = activation
        self.inner_activation = inner_activation
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def make_cell(self, input_size):
        raise NotImplementedError

    def build_module(self, input_shape):
        seq = nn.Sequential()
        if self.go_backwards:
            seq.add(nn.Reverse(2))
        seq.add(nn.Recurrent().add(self.make_cell(input_shape[-1])))
        if not self.return_sequences:
            seq.add(nn.Select(2, -1))
        return seq


class SimpleRNN(_KerasRecurrent):
    def make_cell(self, input_size):
        act = get_activation(self.activation) or nn.Tanh()
        return self.make(nn.RnnCell, input_size, self.output_dim, act)


class LSTM(_KerasRecurrent):
    def make_cell(self, input_size):
        act = get_activation(self.activation) or nn.Tanh()
        inner = get_activation(self.inner_activation) or nn.Sigmoid()
        return self.make(nn.LSTM, input_size, self.output_dim,
                         activation=act, inner_activation=inner)


class GRU(_KerasRecurrent):
    def make_cell(self, input_size):
        act = get_activation(self.activation) or nn.Tanh()
        inner = get_activation(self.inner_activation) or nn.Sigmoid()
        return self.make(nn.GRU, input_size, self.output_dim,
                         activation=act, inner_activation=inner)


class Bidirectional(KerasLayer):
    """≙ nn/keras/Bidirectional.scala: wraps a keras recurrent layer."""

    def __init__(self, layer: _KerasRecurrent, merge_mode: str = "concat",
                 input_shape=None, **kw):
        kw.setdefault("device", layer.device)
        super().__init__(input_shape=input_shape or layer.input_shape, **kw)
        self.inner = layer
        self.merge_mode = merge_mode

    def build_module(self, input_shape):
        merge = nn.JoinTable(3) if self.merge_mode == "concat" else nn.CAddTable()
        bi = nn.BiRecurrent(merge=merge,
                            cell=self.inner.make_cell(input_shape[-1]))
        if self.inner.return_sequences:
            return bi
        return nn.Sequential(bi, nn.Select(2, -1))


class TimeDistributed(KerasLayer):
    def __init__(self, layer: KerasLayer, input_shape=None, **kw):
        kw.setdefault("device", layer.device)
        super().__init__(input_shape=input_shape, **kw)
        self.inner = layer

    def build_module(self, input_shape):
        inner_module_shape = tuple(input_shape[1:])
        self.inner.build(inner_module_shape)
        return nn.TimeDistributed(self.inner.layer)


# ------------------------------------------------------------------ merge
class Merge(KerasLayer):
    """Merge branch outputs (≙ nn/keras/Merge.scala). Input is a Table of
    branch inputs; each branch is applied to its element, then merged."""

    def __init__(self, layers: Sequence, mode: str = "sum",
                 concat_axis: int = -1, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.branches = list(layers)
        self.mode = mode
        self.concat_axis = concat_axis

    def build_module(self, input_shape):
        par = nn.ParallelTable()
        for b in self.branches:
            par.add(b)
        mode = self.mode
        if mode == "sum":
            merge = nn.CAddTable()
        elif mode == "mul":
            merge = nn.CMulTable()
        elif mode == "max":
            merge = nn.CMaxTable()
        elif mode == "ave":
            merge = nn.CAveTable()
        elif mode == "concat":
            # keras semantics: full-tensor axis, -1 = last
            merge = _ConcatMerge(self.concat_axis)
        elif mode == "dot":
            merge = nn.DotProduct()
        else:
            raise ValueError(f"unsupported merge mode {mode!r}")
        return nn.Sequential(par, merge)


# ---------------------------------------------------------------- padding
class ZeroPadding2D(KerasLayer):
    def __init__(self, padding=(1, 1), input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.padding = _pair(padding)

    def build_module(self, input_shape):
        return nn.SpatialZeroPadding(self.padding[1], self.padding[1],
                                     self.padding[0], self.padding[0])


class ZeroPadding1D(KerasLayer):
    def __init__(self, padding: int = 1, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.padding = padding

    def build_module(self, input_shape):
        return _ZeroPad((self.padding, 0))     # (B, T, F): T only


class Cropping2D(KerasLayer):
    def __init__(self, cropping=((0, 0), (0, 0)), input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.cropping = cropping

    def build_module(self, input_shape):
        (t, b), (l, r) = self.cropping
        return nn.Cropping2D((t, b), (l, r))


class Cropping1D(KerasLayer):
    def __init__(self, cropping=(1, 1), input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.cropping = _pair(cropping)

    def build_module(self, input_shape):
        return _Crop1D(self.cropping)


class UpSampling2D(KerasLayer):
    def __init__(self, size=(2, 2), input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.size = _pair(size)

    def build_module(self, input_shape):
        return nn.UpSampling2D(self.size)


class UpSampling1D(KerasLayer):
    def __init__(self, length: int = 2, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.length = length

    def build_module(self, input_shape):
        return nn.UpSampling1D(self.length)


# ----------------------------------------------------- advanced activations
class LeakyReLU(KerasLayer):
    def __init__(self, alpha: float = 0.3, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.alpha = alpha

    def build_module(self, input_shape):
        return nn.LeakyReLU(self.alpha)


class ELU(KerasLayer):
    def __init__(self, alpha: float = 1.0, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.alpha = alpha

    def build_module(self, input_shape):
        return nn.ELU(self.alpha)


class PReLU(KerasLayer):
    def build_module(self, input_shape):
        return self.make(nn.PReLU, input_shape[0] if len(input_shape) > 1
                         else input_shape[-1])


class SReLU(KerasLayer):
    def build_module(self, input_shape):
        return self.make(nn.SReLU, input_shape)


class ThresholdedReLU(KerasLayer):
    def __init__(self, theta: float = 1.0, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.theta = theta

    def build_module(self, input_shape):
        return nn.Threshold(self.theta, 0.0)


# ------------------------------------------------------------------- 3-D set
class Convolution3D(KerasLayer):
    """≙ nn/keras/Convolution3D.scala — th ordering (C, D1, D2, D3)."""

    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, activation=None, border_mode: str = "valid",
                 subsample=(1, 1, 1), bias: bool = True, input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.nb_filter = nb_filter
        self.kernel = (kernel_dim1, kernel_dim2, kernel_dim3)
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = _triple(subsample)
        self.bias = bias

    def build_module(self, input_shape):
        c = input_shape[0]
        kt, kh, kw = self.kernel
        if self.border_mode == "same":
            pt, ph, pw = (kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
        else:
            pt = ph = pw = 0
        conv = self.make(
            nn.VolumetricConvolution, c, self.nb_filter, kt, kw, kh,
            self.subsample[0], self.subsample[2], self.subsample[1],
            pt, pw, ph, with_bias=self.bias)
        return _with_activation(conv, self.activation)


class MaxPooling3D(KerasLayer):
    def __init__(self, pool_size=(2, 2, 2), strides=None, input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.pool_size = _triple(pool_size)
        self.strides = _triple(strides) if strides is not None else self.pool_size

    def build_module(self, input_shape):
        kt, kh, kw = self.pool_size
        dt, dh, dw = self.strides
        return nn.VolumetricMaxPooling(kt, kw, kh, dt, dw, dh)


class AveragePooling3D(KerasLayer):
    def __init__(self, pool_size=(2, 2, 2), strides=None, input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.pool_size = _triple(pool_size)
        self.strides = _triple(strides) if strides is not None else self.pool_size

    def build_module(self, input_shape):
        kt, kh, kw = self.pool_size
        dt, dh, dw = self.strides
        return nn.VolumetricAveragePooling(kt, kw, kh, dt, dw, dh)


class GlobalMaxPooling3D(KerasLayer):
    def build_module(self, input_shape):
        return _Reduce("max", (2, 3, 4))       # (B, C, D, H, W)


class GlobalAveragePooling3D(KerasLayer):
    def build_module(self, input_shape):
        return _Reduce("mean", (2, 3, 4))


class Cropping3D(KerasLayer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), input_shape=None,
                 **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.cropping = tuple(tuple(c) for c in cropping)

    def build_module(self, input_shape):
        return nn.Cropping3D(*self.cropping)


class ZeroPadding3D(KerasLayer):
    def __init__(self, padding=(1, 1, 1), input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.padding = _triple(padding)

    def build_module(self, input_shape):
        return _ZeroPad(self.padding)          # (B, C, D, H, W): D, H, W


class UpSampling3D(KerasLayer):
    def __init__(self, size=(2, 2, 2), input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.size = _triple(size)

    def build_module(self, input_shape):
        return nn.UpSampling3D(self.size)


class SpatialDropout3D(KerasLayer):
    def __init__(self, p: float = 0.5, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.p = p

    def build_module(self, input_shape):
        return nn.SpatialDropout3D(self.p)


class AtrousConvolution1D(KerasLayer):
    """Dilated temporal conv over (B, T, F) (≙ nn/keras/AtrousConvolution1D
    .scala), through SpatialDilatedConvolution with the time axis as
    height."""

    def __init__(self, nb_filter: int, filter_length: int,
                 atrous_rate: int = 1, activation=None,
                 subsample_length: int = 1, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.nb_filter, self.filter_length = nb_filter, filter_length
        self.atrous_rate = atrous_rate
        self.activation = activation
        self.subsample_length = subsample_length

    def build_module(self, input_shape):
        f = input_shape[-1]
        conv = self.make(
            nn.SpatialDilatedConvolution, f, self.nb_filter, 1,
            self.filter_length, dw=1, dh=self.subsample_length,
            dilation_w=1, dilation_h=self.atrous_rate)
        return _with_activation(_Atrous1D(conv), self.activation)


class LocallyConnected1D(KerasLayer):
    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 subsample_length: int = 1, input_shape=None, **kw):
        super().__init__(input_shape=input_shape, **kw)
        self.nb_filter, self.filter_length = nb_filter, filter_length
        self.activation = activation
        self.subsample_length = subsample_length

    def build_module(self, input_shape):
        t, f = input_shape
        conv = self.make(nn.LocallyConnected1D, t, f, self.nb_filter,
                         self.filter_length, self.subsample_length)
        return _with_activation(conv, self.activation)


class ConvLSTM2D(_KerasRecurrent):
    """≙ nn/keras/ConvLSTM2D.scala: ConvLSTMPeephole cell over (B, T, C, H, W)
    sequences; square ``nb_kernel`` kernels, SAME padding."""

    def __init__(self, nb_filter: int, nb_kernel: int, activation=None,
                 inner_activation=None, return_sequences: bool = False,
                 go_backwards: bool = False, border_mode: str = "same",
                 subsample=(1, 1), input_shape=None, **kw):
        super().__init__(nb_filter, activation=activation,
                         inner_activation=inner_activation,
                         return_sequences=return_sequences,
                         go_backwards=go_backwards, input_shape=input_shape,
                         **kw)
        self.nb_kernel = nb_kernel
        if border_mode != "same":
            raise ValueError("ConvLSTM2D supports only border_mode='same' "
                             "(the reference keras layer has the same limit)")
        self.subsample = _pair(subsample)
        if self.subsample != (1, 1):
            raise ValueError(
                "ConvLSTM2D supports only subsample=(1, 1): the underlying "
                "ConvLSTMPeephole cell uses stride-1 SAME gate convolutions")
        if activation not in (None, "tanh") or \
                inner_activation not in (None, "sigmoid"):
            raise ValueError(
                "ConvLSTM2D gate activations are fixed to tanh/sigmoid "
                "(ConvLSTMPeephole); pass activation='tanh', "
                "inner_activation='sigmoid' or leave them unset")

    def build_module(self, input_shape):
        c = input_shape[1]  # (T, C, H, W)
        seq = nn.Sequential()
        if self.go_backwards:
            seq.add(nn.Reverse(2))
        cell = self.make(nn.ConvLSTMPeephole, c, self.output_dim,
                         self.nb_kernel, self.nb_kernel,
                         stride=self.subsample[0])
        seq.add(nn.Recurrent().add(cell))
        if not self.return_sequences:
            seq.add(nn.Select(2, -1))
        return seq


class SoftMax(KerasLayer):
    """≙ nn/keras/SoftMax.scala — the keras-API softmax activation layer."""

    def build_module(self, input_shape):
        return nn.SoftMax()


def Input(shape=None, name: str = ""):
    """Functional-API input node (≙ nn/keras/Input.scala's Input object):
    returns a Graph Node to wire keras ``Model(input, output)`` graphs."""
    node = nn.Input()
    if name:
        node.module.set_name(name)
    node.module.input_shape = tuple(shape) if shape else None
    return node
