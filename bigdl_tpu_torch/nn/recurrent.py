"""The recurrent stack (port of ``bigdl_tpu/nn/recurrent.py``): the cells
``RnnCell`` (``RNN``), ``LSTM``, ``LSTMPeephole``, ``GRU``,
``ConvLSTMPeephole``, ``ConvLSTMPeephole3D`` and ``MultiRNNCell`` over
the ``Cell`` base, and the unrolls ``Recurrent``, ``BiRecurrent``,
``RecurrentDecoder`` and ``TimeDistributed``.

The parameters keep the JAX layouts and names, so ``load_jax_params``
carries them across: the gate projections are fused, ``i2g`` (in, 4h)
and ``h2g`` (h, 4h) in gate order i, f, g, o with the forget-gate bias at
1.0; GRU's ``i2g`` / ``h2g`` / ``gate_bias`` (r, z) and ``i2c`` / ``h2c``
/ ``cand_bias``; the peepholes ``w_ci`` / ``w_cf`` / ``w_co``. The cell
math is written in torch ops (``torch.nn.LSTM`` and cuDNN's RNN lay out
their weights and biases otherwise and have no peepholes or per-gate
dropout). An activation given as a Module (``activation=``,
``inner_activation=``) is applied through its ``forward`` and is not a
child: it has no parameters, as in ``params_dict()`` of the JAX cell.

``Recurrent`` unrolls a cell's ``step`` over the time axis in a Python
loop (the JAX ``lax.scan``), batch first: ``(batch, time, ...)`` in and
out. A cell with dropout (``p > 0``) in training mode draws one keep
mask per gate per step from its ``generator`` (``bind_generator`` sets
it; ``None`` is PyTorch's default generator on the input's device):
masks differ between steps, kept inputs are scaled by ``1 / (1 - p)``,
and nothing is dropped in evaluation mode. The draws never reproduce the
JAX package's (threefry is not Philox).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn import init as bt_init
from bigdl_tpu_torch.nn.activation import Tanh
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.table_ops import CAddTable
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.table import Table


class _UniformStdv:
    """U(-1/sqrt(hidden), 1/sqrt(hidden)) of ``shape``."""

    def __init__(self, shape, hidden_size):
        self.shape, self.hidden_size = tuple(shape), hidden_size

    def __call__(self, rng: RandomGenerator) -> torch.Tensor:
        stdv = 1.0 / math.sqrt(self.hidden_size)
        return bt_init.RandomUniform(-stdv, stdv)(self.shape, rng)


class _HeNormal:
    """N(0, sqrt(2 / fan)) of ``shape`` (the convolutional cells)."""

    def __init__(self, shape, fan):
        self.shape, self.fan = tuple(shape), fan

    def __call__(self, rng: RandomGenerator) -> torch.Tensor:
        return bt_init.RandomNormal(0.0, math.sqrt(2.0 / self.fan))(
            self.shape, rng)


class _Zeros:
    def __init__(self, shape):
        self.shape = tuple(shape)

    def __call__(self, rng=None) -> torch.Tensor:
        return torch.zeros(self.shape)


class _LSTMBias:
    """Zeros of (4h,) with the forget gate's slice at 1.0."""

    def __init__(self, hidden_size):
        self.hidden_size = hidden_size

    def __call__(self, rng=None) -> torch.Tensor:
        h = self.hidden_size
        b = torch.zeros(4 * h)
        b[h:2 * h] = 1.0
        return b


def _unregistered(module: Module, name: str, value) -> None:
    """``module.name = value`` without registering a Module ``value`` as
    a child (an activation: no parameters, not in ``params_dict()``)."""
    object.__setattr__(module, name, value)


def _gate_dropout(x, p: float, n_gates: int, training: bool, generator):
    """(batch, n_gates, in): the step input once per gate, each copy with
    its own inverted-dropout mask in training mode."""
    xg = x[:, None].expand((x.shape[0], n_gates) + tuple(x.shape[1:]))
    if not training or p <= 0.0:
        return xg
    keep = torch.rand(xg.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, xg / (1.0 - p), torch.zeros_like(xg))


class Cell(Module):
    """Base of the recurrent cells.

    ``step(x_t, state) -> (out_t, new_state)``; ``init_state(batch,
    dtype, device)`` is the zero state and ``state_for(x_t)`` the zero
    state for one step's input (the convolutional cells need its spatial
    shape). ``forward`` runs one step on ``Table(x, state)`` (or on ``x``
    from the zero state) and returns ``Table(out, new_state)``. A cell
    registers its parameters with their initializers
    (``register_random_parameter``), so ``reset()`` draws each again from
    its construction-time distribution, from the cell's ``rng``."""

    #: the dropout probability of the step input (0: none)
    p = 0.0

    def __init__(self, *, rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        self._param_inits = {}
        self._rng = rng or RandomGenerator()
        self._device, self._dtype = device, dtype
        self.generator: Optional[torch.Generator] = None

    @property
    def draws_random(self) -> bool:
        return self.p > 0.0

    def register_random_parameter(self, name: str, init_fn,
                                  regularizer=None) -> None:
        self._param_inits[name] = init_fn
        self.new_param(name, init_fn(self._rng),
                       resolve_device(self._device), self._dtype, regularizer)

    def init_state(self, batch: int, dtype=torch.float32, device="cpu"):
        raise NotImplementedError

    def state_for(self, x_t):
        return self.init_state(x_t.shape[0], x_t.dtype, x_t.device)

    def step(self, x, state):
        raise NotImplementedError

    def reset(self) -> None:
        with torch.no_grad():
            for name, fn in self._param_inits.items():
                getattr(self, name).copy_(fn(self._rng))
        super().reset()

    def forward(self, input):
        if isinstance(input, (Table, tuple, list)):
            seq = list(input)
            x, state = seq[0], seq[1]
        else:
            x, state = input, self.state_for(input)
        out, new_state = self.step(x, state)
        return Table(out, new_state)


def _zeros(batch, size, dtype, device):
    return torch.zeros((batch, size), dtype=dtype, device=device)


class RnnCell(Cell):
    """``h' = act(x @ i2h + h @ h2h + bias)`` (default act ``Tanh``)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation: Optional[Module] = None,
                 is_input_with_bias: bool = True,
                 is_hidden_with_bias: bool = True, w_regularizer=None,
                 u_regularizer=None, b_regularizer=None, **kw):
        super().__init__(**kw)
        self.input_size = input_size
        self.hidden_size = hidden_size
        _unregistered(self, "activation",
                      activation if activation is not None else Tanh())
        self.register_random_parameter(
            "i2h", _UniformStdv((input_size, hidden_size), hidden_size),
            w_regularizer)
        self.register_random_parameter(
            "h2h", _UniformStdv((hidden_size, hidden_size), hidden_size),
            u_regularizer)
        self.with_bias = is_input_with_bias or is_hidden_with_bias
        if self.with_bias:
            self.register_random_parameter("bias", _Zeros((hidden_size,)),
                                           b_regularizer)

    def init_state(self, batch, dtype=torch.float32, device="cpu"):
        return _zeros(batch, self.hidden_size, dtype, device)

    def step(self, x, h):
        z = x @ self.i2h + h @ self.h2h
        if self.with_bias:
            z = z + self.bias
        h_new = self.activation.forward(z)
        return h_new, h_new


class _GatedCell(Cell):
    """The shared init of the LSTM cells: fused (in, 4h) / (h, 4h) gate
    projections and the (4h,) bias with the forget gate at 1.0."""

    def __init__(self, input_size, hidden_size, p, w_regularizer,
                 u_regularizer, b_regularizer, **kw):
        super().__init__(**kw)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.p = p
        h = hidden_size
        self.register_random_parameter(
            "i2g", _UniformStdv((input_size, 4 * h), h), w_regularizer)
        self.register_random_parameter(
            "h2g", _UniformStdv((h, 4 * h), h), u_regularizer)
        self.register_random_parameter("bias", _LSTMBias(h), b_regularizer)

    def init_state(self, batch, dtype=torch.float32, device="cpu"):
        return (_zeros(batch, self.hidden_size, dtype, device),
                _zeros(batch, self.hidden_size, dtype, device))

    def _gates(self, x, h):
        """(batch, 4h): the four gates' pre-activations."""
        hs = self.hidden_size
        if self.training and self.p > 0.0:
            xg = _gate_dropout(x, self.p, 4, True, self.generator)
            w = self.i2g.reshape(self.input_size, 4, hs)
            zi = torch.einsum("bgi,igh->bgh", xg, w).reshape(x.shape[0],
                                                             4 * hs)
        else:
            zi = x @ self.i2g
        return zi + h @ self.h2g + self.bias


class LSTM(_GatedCell):
    """The LSTM: gates i, f, g, o; ``activation`` (default tanh) on g and
    the cell, ``inner_activation`` (default sigmoid) on i, f and o;
    dropout ``p`` on the step input, one mask per gate."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation: Optional[Module] = None,
                 inner_activation: Optional[Module] = None,
                 w_regularizer=None, u_regularizer=None,
                 b_regularizer=None, **kw):
        super().__init__(input_size, hidden_size, p, w_regularizer,
                         u_regularizer, b_regularizer, **kw)
        _unregistered(self, "_act", activation)
        _unregistered(self, "_inner", inner_activation)

    def _activate(self, z):
        return self._act.forward(z) if self._act is not None \
            else torch.tanh(z)

    def _inner_activate(self, z):
        return self._inner.forward(z) if self._inner is not None \
            else torch.sigmoid(z)

    def step(self, x, state):
        h, c = state
        hs = self.hidden_size
        z = self._gates(x, h)
        i = self._inner_activate(z[:, 0 * hs:1 * hs])
        f = self._inner_activate(z[:, 1 * hs:2 * hs])
        g = self._activate(z[:, 2 * hs:3 * hs])
        o = self._inner_activate(z[:, 3 * hs:4 * hs])
        c_new = f * c + i * g
        h_new = o * self._activate(c_new)
        return h_new, (h_new, c_new)


class LSTMPeephole(_GatedCell):
    """The LSTM with peepholes from the cell into the gates: ``w_ci`` and
    ``w_cf`` read the old cell, ``w_co`` the new one."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 w_regularizer=None, u_regularizer=None,
                 b_regularizer=None, **kw):
        super().__init__(input_size, hidden_size, p, w_regularizer,
                         u_regularizer, b_regularizer, **kw)
        h = hidden_size
        for name in ("w_ci", "w_cf", "w_co"):
            self.register_random_parameter(name, _UniformStdv((h,), h))

    def step(self, x, state):
        h, c = state
        hs = self.hidden_size
        z = self._gates(x, h)
        i = torch.sigmoid(z[:, 0 * hs:1 * hs] + self.w_ci * c)
        f = torch.sigmoid(z[:, 1 * hs:2 * hs] + self.w_cf * c)
        g = torch.tanh(z[:, 2 * hs:3 * hs])
        c_new = f * c + i * g
        o = torch.sigmoid(z[:, 3 * hs:4 * hs] + self.w_co * c_new)
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRU(Cell):
    """The GRU: r and z from ``i2g`` / ``h2g`` / ``gate_bias``, the
    candidate from ``i2c`` and the reset-gated hidden state through
    ``h2c``; ``h' = (1 - z) * cand + z * h``. Dropout ``p`` gives the r,
    z and candidate inputs one mask each."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation: Optional[Module] = None,
                 inner_activation: Optional[Module] = None,
                 w_regularizer=None, u_regularizer=None,
                 b_regularizer=None, **kw):
        super().__init__(**kw)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.p = p
        _unregistered(self, "_act", activation)
        _unregistered(self, "_inner", inner_activation)
        h = hidden_size
        self.register_random_parameter(
            "i2g", _UniformStdv((input_size, 2 * h), h), w_regularizer)
        self.register_random_parameter(
            "h2g", _UniformStdv((h, 2 * h), h), u_regularizer)
        self.register_random_parameter("gate_bias", _Zeros((2 * h,)),
                                       b_regularizer)
        self.register_random_parameter(
            "i2c", _UniformStdv((input_size, h), h), w_regularizer)
        self.register_random_parameter(
            "h2c", _UniformStdv((h, h), h), u_regularizer)
        self.register_random_parameter("cand_bias", _Zeros((h,)),
                                       b_regularizer)

    def init_state(self, batch, dtype=torch.float32, device="cpu"):
        return _zeros(batch, self.hidden_size, dtype, device)

    def step(self, x, h):
        hs = self.hidden_size
        if self.training and self.p > 0.0:
            xg = _gate_dropout(x, self.p, 3, True, self.generator)
            wg = self.i2g.reshape(self.input_size, 2, hs)
            zg = torch.einsum("bgi,igh->bgh", xg[:, :2], wg).reshape(
                x.shape[0], 2 * hs) + h @ self.h2g + self.gate_bias
            x_cand = xg[:, 2]
        else:
            zg = x @ self.i2g + h @ self.h2g + self.gate_bias
            x_cand = x
        inner = self._inner.forward if self._inner is not None \
            else torch.sigmoid
        act = self._act.forward if self._act is not None else torch.tanh
        r = inner(zg[:, :hs])
        z = inner(zg[:, hs:])
        cand = act(x_cand @ self.i2c + (r * h) @ self.h2c + self.cand_bias)
        h_new = (1 - z) * cand + z * h
        return h_new, h_new


def _same_conv(x, w, nd: int):
    """Stride-1 convolution padded as XLA's "SAME": ``k - 1`` in all,
    ``(k - 1) // 2`` before and the rest after (one more after for an
    even kernel)."""
    pad = []
    for k in reversed(w.shape[2:]):
        lo = (k - 1) // 2
        pad += [lo, k - 1 - lo]
    conv = F.conv2d if nd == 2 else F.conv3d
    return conv(F.pad(x, pad), w)


class ConvLSTMPeephole(Cell):
    """The convolutional LSTM with peepholes over (C, H, W) maps: the
    four gates' input and hidden convolutions fused into ``w_in`` (4n,
    C, k, k) and ``w_hid`` (4n, n, k, k), SAME-padded at stride 1, so
    the state keeps the input's spatial shape. ``stride != 1`` raises:
    the JAX cell accepts it and convolves at stride 1 all the same."""

    _nd = 2

    def __init__(self, input_size: int, output_size: int, kernel_i: int = 3,
                 kernel_c: int = 3, stride: int = 1,
                 with_peephole: bool = True, **kw):
        if stride != 1:
            raise NotImplementedError(
                f"{type(self).__name__}(stride={stride}) is not supported: "
                "the JAX cell accepts a stride and ignores it (its gate "
                "convolutions run at stride 1), and the port never drops "
                "an option silently")
        super().__init__(**kw)
        nd = self._nd
        self.input_size = input_size
        self.output_size = output_size
        self.kernel_i = kernel_i
        self.kernel_c = kernel_c
        self.with_peephole = with_peephole
        n = output_size
        self.register_random_parameter("w_in", _HeNormal(
            (4 * n, input_size) + (kernel_i,) * nd,
            input_size * kernel_i ** nd))
        self.register_random_parameter("w_hid", _HeNormal(
            (4 * n, n) + (kernel_c,) * nd, n * kernel_c ** nd))
        self.register_random_parameter("bias", _Zeros((4 * n,)))
        if with_peephole:
            for name in ("w_ci", "w_cf", "w_co"):
                self.register_random_parameter(
                    name, _Zeros((n,) + (1,) * nd))

    def init_state(self, batch, dtype=torch.float32, device="cpu",
                   spatial=None):
        if spatial is None:
            raise ValueError(f"{type(self).__name__} state needs the "
                             "spatial shape; use Recurrent, which passes "
                             "it from the input")
        h = torch.zeros((batch, self.output_size) + tuple(spatial),
                        dtype=dtype, device=device)
        return (h, h)

    def state_for(self, x_t):
        return self.init_state(x_t.shape[0], x_t.dtype, x_t.device,
                               spatial=x_t.shape[2:])

    def step(self, x, state):
        h, c = state
        nd = self._nd
        z = _same_conv(x, self.w_in, nd) + _same_conv(h, self.w_hid, nd) \
            + self.bias.reshape((1, -1) + (1,) * nd)
        n = self.output_size
        zi, zf, zg, zo = (z[:, 0 * n:1 * n], z[:, 1 * n:2 * n],
                          z[:, 2 * n:3 * n], z[:, 3 * n:4 * n])
        if self.with_peephole:
            zi = zi + self.w_ci * c
            zf = zf + self.w_cf * c
        i = torch.sigmoid(zi)
        f = torch.sigmoid(zf)
        g = torch.tanh(zg)
        c_new = f * c + i * g
        if self.with_peephole:
            zo = zo + self.w_co * c_new
        o = torch.sigmoid(zo)
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class ConvLSTMPeephole3D(ConvLSTMPeephole):
    """``ConvLSTMPeephole`` over (C, D, H, W) volumes: volumetric SAME
    convolutions, weights (4n, C, k, k, k)."""

    _nd = 3


class MultiRNNCell(Cell):
    """Cells applied in turn at each step, each feeding the next; the
    state is the tuple of the cells' states. Each cell with dropout
    draws its own masks."""

    def __init__(self, cells: Sequence[Cell]):
        super().__init__()
        for i, c in enumerate(cells):
            setattr(self, f"cell{i}", c)
        self.cells = list(cells)

    @property
    def draws_random(self) -> bool:
        return False

    def init_state(self, batch, dtype=torch.float32, device="cpu"):
        return tuple(c.init_state(batch, dtype, device) for c in self.cells)

    def state_for(self, x_t):
        # as in the JAX cell: every cell's zero state from the step input
        # (the dense cells read only its batch size, dtype and device)
        return tuple(c.state_for(x_t) for c in self.cells)

    def step(self, x, state):
        new_states = []
        out = x
        for c, s in zip(self.cells, state):
            out, ns = c.step(out, s)
            new_states.append(ns)
        return out, tuple(new_states)


def _detached(state):
    if isinstance(state, (tuple, list)):
        return type(state)(_detached(s) for s in state)
    return state.detach()


class Recurrent(Module):
    """A cell unrolled over the time axis: (batch, time, ...) in, (batch,
    time, out...) out, from the zero state or the one given to
    ``set_hidden_state``; ``get_hidden_state()`` is the last forward's
    final state (detached)."""

    def __init__(self, cell: Optional[Cell] = None):
        super().__init__()
        self.cell: Optional[Cell] = None
        self._init_state_override = None
        self._last_state = None
        if cell is not None:
            self.add(cell)

    def add(self, cell: Cell) -> "Recurrent":
        self.cell = cell
        return self

    def set_hidden_state(self, state) -> "Recurrent":
        self._init_state_override = state
        return self

    def get_hidden_state(self):
        return self._last_state

    def _initial_state(self, x0):
        if self._init_state_override is not None:
            return self._init_state_override
        return self.cell.state_for(x0)

    def forward(self, input):
        cell = self.cell
        state = self._initial_state(input[:, 0])
        outs = []
        for t in range(input.shape[1]):
            out, state = cell.step(input[:, t], state)
            outs.append(out)
        self._last_state = _detached(state)
        return torch.stack(outs, 1)


class BiRecurrent(Module):
    """Both directions of a cell: ``fwd`` over the sequence, ``bwd`` (a
    clone of the cell drawn again by ``reset()``: its own weights) over
    it reversed, its output flipped back; ``merge`` (default
    ``CAddTable``) combines ``Table(out_fwd, out_bwd)``."""

    def __init__(self, merge: Optional[Module] = None,
                 cell: Optional[Cell] = None):
        super().__init__()
        self.merge = merge if merge is not None else CAddTable()
        self.fwd: Optional[Recurrent] = None
        self.bwd: Optional[Recurrent] = None
        if cell is not None:
            self.add(cell)

    def add(self, cell: Cell) -> "BiRecurrent":
        rev = cell.clone_module()
        rev.reset()
        self.fwd = Recurrent(cell)
        self.bwd = Recurrent(rev)
        return self

    def forward(self, input):
        out_f = self.fwd(input)
        out_b = torch.flip(self.bwd(torch.flip(input, (1,))), (1,))
        return self.merge(Table(out_f, out_b))


class RecurrentDecoder(Module):
    """An autoregressive unroll: ``input`` is the first step's input and
    each step's output is the next one's; (batch, seq_length, ...)
    out."""

    def __init__(self, seq_length: int, cell: Optional[Cell] = None):
        super().__init__()
        self.seq_length = seq_length
        self.cell: Optional[Cell] = None
        if cell is not None:
            self.add(cell)

    def add(self, cell: Cell) -> "RecurrentDecoder":
        self.cell = cell
        return self

    def forward(self, input):
        cell = self.cell
        x, state = input, cell.state_for(input)
        outs = []
        for _ in range(self.seq_length):
            x, state = cell.step(x, state)
            outs.append(x)
        return torch.stack(outs, 1)


class TimeDistributed(Module):
    """Apply ``layer`` to every time step of (batch, time, ...) by
    folding time into the batch: one batched call, no time loop."""

    def __init__(self, layer: Module):
        super().__init__()
        self.layer = layer

    def forward(self, input):
        b, t = input.shape[0], input.shape[1]
        out = self.layer(input.reshape((b * t,) + tuple(input.shape[2:])))
        return out.reshape((b, t) + tuple(out.shape[1:]))


#: the reference's name of the simple recurrent cell
RNN = RnnCell
