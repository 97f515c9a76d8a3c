"""The port's recurrent stack (bigdl_tpu_torch/nn/recurrent.py) and the
SimpleRNN model against the JAX package's.

Each case of tests/test_recurrent.py has a counterpart here on JAX
weights carried across by ``load_jax_params``: the same numpy input goes
through the JAX module and the port's, and the forward and the input and
parameter gradients for one random output cotangent agree within f32
rtol 1e-5 / atol 1e-6 (``tests/test_torch_graph.py::like_jax``;
SimpleRNN, whose head gradients sum hundreds of terms, is held at that
tolerance in float64 on both sides). Dropout is checked for validity
only (threefry is not Philox): one mask per gate, masks that differ
between steps, kept inputs scaled by ``1 / (1 - p)``, none in
evaluation mode. The convolutional cells' cases are in
tests/test_torch_conv_lstm.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.recurrent import _gate_dropout
from bigdl_tpu_torch.nn.module import tree_leaves
from tests.jax_numpy_init import numpy_weight_draws
from tests.test_torch_graph import TOL, like_jax

B, T, I, H = 3, 5, 4, 6
CPU = dict(device="cpu")


def _x(seed=0, shape=(B, T, I)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(build, seed):
    """(JAX module with numpy-drawn weights, port module) of ``build(nn,
    kw)``, the port's on the CPU."""
    with numpy_weight_draws(seed):
        jm = build(jnn, {})
    return jm, build(tnn, CPU)


def _manual_unroll(cell, x):
    """The port cell's steps by hand: the oracle of the time loop."""
    state = cell.state_for(x[:, 0])
    outs = []
    for t in range(x.shape[1]):
        out, state = cell.step(x[:, t], state)
        outs.append(out)
    return torch.stack(outs, 1), state


CELLS = {
    "rnn": lambda nn, kw: nn.RnnCell(I, H, **kw),
    "lstm": lambda nn, kw: nn.LSTM(I, H, **kw),
    "lstm_peephole": lambda nn, kw: nn.LSTMPeephole(I, H, **kw),
    "gru": lambda nn, kw: nn.GRU(I, H, **kw),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_scan_matches_python_loop(name):
    jm, tm = _pair(lambda nn, kw: nn.Recurrent(CELLS[name](nn, kw)), 1)
    x = _x()
    got = like_jax(jm, tm, x)[0]
    assert tuple(got.shape) == (B, T, H)
    with torch.no_grad():
        want, _ = _manual_unroll(tm.cell, torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)


def test_lstm_gradients_flow():
    jm, tm = _pair(lambda nn, kw: nn.Recurrent(nn.LSTM(I, H, **kw)), 2)
    like_jax(jm, tm, _x())
    out = tm(torch.tensor(_x()))
    grads = torch.autograd.grad((out ** 2).sum(), list(tm.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().sum()) > 0 for g in grads)


def test_multi_rnn_cell_stacks():
    jm, tm = _pair(lambda nn, kw: nn.Recurrent(nn.MultiRNNCell(
        [nn.LSTM(I, H, **kw), nn.GRU(H, H, **kw)])), 3)
    out = like_jax(jm, tm, _x())[0]
    assert tuple(out.shape) == (B, T, H)
    with torch.no_grad():
        want, _ = _manual_unroll(tm.cell, torch.tensor(_x()))
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), **TOL)


def test_birecurrent_merges_directions():
    jm, tm = _pair(lambda nn, kw: nn.BiRecurrent(
        cell=nn.RnnCell(I, H, **kw)), 4)
    x = _x()
    out = like_jax(jm, tm, x)[0]
    assert tuple(out.shape) == (B, T, H)
    xt = torch.tensor(x)
    f = tm.fwd(xt)
    b = torch.flip(tm.bwd(torch.flip(xt, (1,))), (1,))
    np.testing.assert_allclose(out.detach().numpy(),
                               (f + b).detach().numpy(), **TOL)
    # a fresh BiRecurrent: the reverse cell has its own (other) weights
    fresh = tnn.BiRecurrent(cell=tnn.RnnCell(I, H, **CPU))
    assert not torch.allclose(fresh.fwd.cell.i2h, fresh.bwd.cell.i2h)
    assert sorted(dict(fresh.named_children())) == ["bwd", "fwd", "merge"]


def test_recurrent_decoder_feeds_back():
    jm, tm = _pair(lambda nn, kw: nn.RecurrentDecoder(
        seq_length=4, cell=nn.LSTM(H, H, **kw)), 5)
    x0 = _x(1, (B, H))
    out = like_jax(jm, tm, x0)[0]
    assert tuple(out.shape) == (B, 4, H)
    cell = tm.cell
    state = cell.init_state(B)
    cur, outs = torch.tensor(x0), []
    with torch.no_grad():
        for _ in range(4):
            cur, state = cell.step(cur, state)
            outs.append(cur)
    np.testing.assert_allclose(out.detach().numpy(),
                               torch.stack(outs, 1).numpy(), **TOL)


def test_time_distributed():
    td = tnn.TimeDistributed(tnn.Linear(I, 2, **CPU))
    x = torch.tensor(_x())
    out = td(x)
    assert tuple(out.shape) == (B, T, 2)
    np.testing.assert_allclose(out[:, 2].detach().numpy(),
                               td.layer(x[:, 2]).detach().numpy(), **TOL)


def test_recurrent_under_jit():
    """The JAX case jits the unroll; the port's counterpart runs it
    through ``torch.func.functional_call`` on the JAX weights (the train
    step's way of binding parameters), equal to the eager forward and
    to the jitted JAX forward."""
    jm, tm = _pair(lambda nn, kw: nn.Recurrent(nn.GRU(I, H, **kw)), 10)
    x = _x()
    eager = like_jax(jm, tm, x)[0]
    params = {k: v.detach().clone() for k, v in tm.named_parameters()}
    bound = torch.func.functional_call(tm, params, (torch.tensor(x),))
    np.testing.assert_allclose(bound.detach().numpy(),
                               eager.detach().numpy(), **TOL)


@pytest.mark.parametrize("name", ["lstm", "lstm_peephole", "gru"])
def test_dropout_active_in_training_only(name):
    cell = {"lstm": tnn.LSTM, "lstm_peephole": tnn.LSTMPeephole,
            "gru": tnn.GRU}[name](I, H, p=0.5, **CPU)
    rec = tnn.Recurrent(cell)
    assert cell.draws_random
    x = torch.tensor(_x())
    a, b = rec(x), rec(x)
    assert not torch.allclose(a, b)            # fresh masks every pass
    rec.evaluate()
    c, d = rec(x), rec(x)
    assert torch.equal(c, d)
    # without dropout the evaluation-mode forward is the JAX cell's
    with numpy_weight_draws(11):
        jm = jnn.Recurrent(getattr(jnn, type(cell).__name__)(I, H, p=0.5))
    like_jax(jm, rec, _x())
    rec.training_mode()
    # a seeded generator gives the same masks again
    g = torch.Generator().manual_seed(3)
    tnn.bind_generator(rec, g)
    e = rec(x)
    g.manual_seed(3)
    assert torch.equal(rec(x), e)


def test_gate_dropout_masks_per_gate_and_step_with_the_scale():
    p = 0.4
    x = torch.rand(64, 32) + 0.5                # no zero inputs
    g = torch.Generator().manual_seed(0)
    a = _gate_dropout(x, p, 4, True, g)
    b = _gate_dropout(x, p, 4, True, g)         # the next step's draw
    assert tuple(a.shape) == (64, 4, 32)
    kept = a != 0
    # kept inputs scaled by 1 / (1 - p), dropped ones zero
    np.testing.assert_allclose(
        a[kept].numpy(), (x[:, None].expand_as(a) / (1 - p))[kept].numpy(),
        rtol=1e-6)
    # one mask a gate: the gates' masks differ; and they differ by step
    assert not torch.equal(kept[:, 0], kept[:, 1])
    assert not torch.equal(kept, b != 0)
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.02
    # evaluation mode and p = 0: every gate sees the input itself
    assert torch.equal(_gate_dropout(x, p, 4, False, g),
                       x[:, None].expand(64, 4, 32))
    assert torch.equal(_gate_dropout(x, 0.0, 3, True, g),
                       x[:, None].expand(64, 3, 32))


def test_multi_rnn_cell_dropout_draws_per_cell():
    cells = [tnn.LSTM(I, H, p=0.5, **CPU), tnn.LSTM(H, H, p=0.5, **CPU)]
    multi = tnn.MultiRNNCell(cells)
    rec = tnn.Recurrent(multi)
    g = torch.Generator().manual_seed(5)
    tnn.bind_generator(rec, g)
    assert all(c.generator is g for c in cells)
    masks = []
    real = torch.rand

    def spy(*args, **kw):
        out = real(*args, **kw)
        masks.append(out)
        return out

    torch.rand = spy
    try:
        rec(torch.tensor(_x()))
    finally:
        torch.rand = real
    # one draw a cell a step, each of the cell's own (batch, 4, in) shape
    assert [tuple(m.shape) for m in masks] == \
        [(B, 4, I), (B, 4, H)] * T
    assert not torch.equal(masks[0], masks[2])


def test_birecurrent_works_with_multirnncell():
    jm, tm = _pair(lambda nn, kw: nn.BiRecurrent(cell=nn.MultiRNNCell(
        [nn.LSTM(I, H, **kw), nn.GRU(H, H, **kw)])), 12)
    assert tuple(like_jax(jm, tm, _x())[0].shape) == (B, T, H)


def test_set_hidden_state():
    jm, tm = _pair(lambda nn, kw: nn.Recurrent(nn.RnnCell(I, H, **kw)), 13)
    h0 = np.ones((B, H), np.float32)
    jm.set_hidden_state(jnp.asarray(h0))
    tm.set_hidden_state(torch.tensor(h0))
    x = _x()
    out = like_jax(jm, tm, x)[0]
    state, outs = torch.tensor(h0), []
    with torch.no_grad():
        for t in range(T):
            o, state = tm.cell.step(torch.tensor(x[:, t]), state)
            outs.append(o)
    np.testing.assert_allclose(out.detach().numpy(),
                               torch.stack(outs, 1).numpy(), **TOL)
    assert torch.equal(tm.get_hidden_state(), state)


def test_activations_are_not_children():
    cell = tnn.RnnCell(I, H, tnn.Tanh(), **CPU)
    assert [n for n, _ in cell.named_children()] == []
    lstm = tnn.LSTM(I, H, activation=tnn.SoftSign(),
                    inner_activation=tnn.HardSigmoid(), **CPU)
    assert [n for n, _ in lstm.named_children()] == []
    with numpy_weight_draws(14):
        jm = jnn.Recurrent(jnn.LSTM(I, H, activation=jnn.SoftSign(),
                                    inner_activation=jnn.HardSigmoid()))
    like_jax(jm, tnn.Recurrent(lstm), _x())
    assert tnn.RNN is tnn.RnnCell
    assert len(tree_leaves(tnn.RNN(I, H, is_input_with_bias=False,
                                   is_hidden_with_bias=False, **CPU)
                           .params_dict())) == 2


def test_cells_follow_the_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the rule is checked on a machine without a card")
    for cls in (tnn.RnnCell, tnn.LSTM, tnn.GRU, tnn.LSTMPeephole):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(I, H)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.SimpleRNN(12, 24, 12)


# ------------------------------------------ tests/test_models.py, ported
def test_simple_rnn_forward():
    with numpy_weight_draws(15):
        jm = jmodels.SimpleRNN(input_size=12, hidden_size=24, output_size=12)
    tm = tmodels.SimpleRNN(input_size=12, hidden_size=24, output_size=12,
                           **CPU)
    # the head's gradients sum 21 steps' products: held in float64
    out = like_jax(jm, tm, _x(4, (3, 7, 12)), f64=True)[0]
    assert tuple(out.shape) == (3, 7, 12)
    f32 = tmodels.SimpleRNN(12, 24, 12, **CPU)
    assert tuple(f32(torch.ones(3, 7, 12)).shape) == (3, 7, 12)
