"""The port's convolutional LSTM cells (``ConvLSTMPeephole``,
``ConvLSTMPeephole3D`` in bigdl_tpu_torch/nn/recurrent.py) against the
JAX package's: the conv cases of tests/test_recurrent.py on JAX weights
carried across, forward and input and parameter gradients within rtol
1e-5 / atol 1e-6 (``tests/test_torch_graph.py::like_jax``; the 2-D case,
whose kernel gradients sum 960 products, in float64 on both sides), an
even kernel's SAME padding (one more on the high side) as JAX pads it,
the ``stride`` JAX ignores raising, and ``reset`` drawing again from the
construction-time distribution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn as tnn
from tests.test_torch_graph import TOL, like_jax
from tests.test_torch_recurrent import (B, CPU, H, I, T, _manual_unroll,
                                        _pair, _x)


def test_conv_lstm():
    jm, tm = _pair(lambda nn, kw: nn.Recurrent(nn.ConvLSTMPeephole(
        2, 3, kernel_i=3, kernel_c=3, **kw)), 6)
    # random peepholes: the JAX cell starts them at zero
    rs = np.random.RandomState(7)
    for name in ("w_ci", "w_cf", "w_co"):
        jm.cell._set_param(name, jnp.asarray(
            rs.randn(3, 1, 1).astype(np.float32)))
    x = _x(shape=(B, T, 2, 8, 8))
    # each kernel gradient sums 960 products: held in float64 (like_jax)
    out = like_jax(jm, tm, x, f64=True)[0]
    assert tuple(out.shape) == (B, T, 3, 8, 8)
    with torch.no_grad():
        want, _ = _manual_unroll(tm.cell,
                                 torch.tensor(x, dtype=torch.float64))
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("kernels", [(4, 2), (2, 4)],
                         ids=["even_input_kernel", "even_hidden_kernel"])
def test_even_kernel_same_padding_matches_jax(kernels):
    """XLA's SAME pads an even kernel one more on the high side."""
    ki, kc = kernels
    jm, tm = _pair(lambda nn, kw: nn.Recurrent(nn.ConvLSTMPeephole(
        2, 3, kernel_i=ki, kernel_c=kc, **kw)), 8)
    out = like_jax(jm, tm, _x(2, (2, 3, 2, 5, 6)))[0]
    assert tuple(out.shape) == (2, 3, 3, 5, 6)


def test_conv_lstm_3d_matches_jax_in_f32():
    jm, tm = _pair(lambda nn, kw: nn.Recurrent(nn.ConvLSTMPeephole3D(
        2, 3, kernel_i=2, kernel_c=3, **kw)), 9)
    out = like_jax(jm, tm, _x(3, (1, 2, 2, 4, 5, 5)))[0]
    assert tuple(out.shape) == (1, 2, 3, 4, 5, 5)


@pytest.mark.parametrize("cls", ["ConvLSTMPeephole", "ConvLSTMPeephole3D"])
def test_conv_cell_stride_jax_ignores_raises(cls):
    with pytest.raises(NotImplementedError, match="stride=2.*ignores"):
        getattr(tnn, cls)(2, 3, stride=2, **CPU)
    getattr(tnn, cls)(2, 3, stride=1, **CPU)


def test_cell_reset_redraws_same_distribution():
    cell = tnn.ConvLSTMPeephole(2, 3, **CPU)
    w0 = cell.w_in.detach().clone()
    cell.reset()
    w1 = cell.w_in.detach()
    assert not torch.allclose(w0, w1)
    assert abs(float(w0.std()) - float(w1.std())) < 0.1 * float(w0.std())
    lstm = tnn.LSTM(I, H, **CPU)
    with torch.no_grad():
        lstm.bias.fill_(3.0)
    lstm.reset()
    assert float(lstm.i2g.detach().abs().max()) <= 1 / H ** 0.5
    assert torch.equal(lstm.bias[H:2 * H], torch.ones(H))
    assert float(lstm.bias[:H].detach().abs().sum()) == 0.0


def test_conv_cell_single_step_forward():
    cell = tnn.ConvLSTMPeephole(2, 3, **CPU)
    out = cell(torch.ones(2, 2, 8, 8))
    assert tuple(out[1].shape) == (2, 3, 8, 8)
    assert tuple(out[2][1].shape) == (2, 3, 8, 8)
