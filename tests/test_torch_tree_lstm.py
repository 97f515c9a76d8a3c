"""The port's BinaryTreeLSTM (bigdl_tpu_torch/nn/tree_lstm.py) and
TreeNNAccuracy against the JAX package's (tests/test_tree_lstm.py).

On JAX weights carried across by ``load_jax_params``, the same
embeddings and trees give the same node states, and for one random
cotangent the same embedding and parameter gradients (the trees are host
data the recursion reads; their gradient is zeros on both sides), within
f32 rtol 1e-5 / atol 1e-6. The eager ``backward`` gives the JAX layer's
result. The learning case runs the hand-driven loop of the sentiment
main at the JAX test's sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim.validation import TreeNNAccuracy as JaxTreeNNAccuracy
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.optim import TreeNNAccuracy
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.weights import load_jax_params
from tests.jax_numpy_init import numpy_weight_draws

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")


def _tiny_tree():
    """node 1 = root (children 2, 3); nodes 2, 3 = leaves over embeddings
    1 and 2 (rows [left, right, leaf_index])."""
    return np.asarray([[[2, 3, 0], [0, 0, 1], [0, 0, 2]]], np.float32)


def _deep_trees():
    """Two rows of five nodes: a left-leaning tree over three leaves, and
    a padded row (a 3-node tree, then two all-zero rows)."""
    a = [[2, 3, 0], [4, 5, 0], [0, 0, 3], [0, 0, 1], [0, 0, 2]]
    b = [[2, 3, 0], [0, 0, 2], [0, 0, 3], [0, 0, 0], [0, 0, 0]]
    return np.asarray([a, b], np.float32)


def _pair(input_size, hidden, seed, gate_output=True):
    with numpy_weight_draws(seed):
        jm = jnn.BinaryTreeLSTM(input_size, hidden, gate_output=gate_output)
    tm = tnn.BinaryTreeLSTM(input_size, hidden, gate_output=gate_output,
                            **CPU)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    return jm, tm


def _jax_vjp(jm, x, trees, g):
    """(states, embedding grad, parameter grad leaves) of the JAX layer,
    the trees held static."""
    from bigdl_tpu.nn.module import pure_apply

    fn = pure_apply(jm)
    buffers = jm.buffers_dict()

    @jax.jit
    def run(p, xx, gg):
        out, vjp = jax.vjp(lambda pp, xi: fn(pp, buffers, JaxTable(xi, trees),
                                             training=False)[0], p, xx)
        return out, vjp(gg)

    out, (gp, gx) = run(jm.params_dict(), jnp.asarray(x), jnp.asarray(g))
    return np.asarray(out), np.asarray(gx), [np.asarray(a) for a in
                                             jax.tree.leaves(gp)]


@pytest.mark.parametrize("gate_output", [True, False])
def test_forward_and_gradients_match_jax(gate_output):
    jm, tm = _pair(4, 6, 1, gate_output)
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 4).astype(np.float32)
    trees = _deep_trees()
    g = rs.randn(2, 5, 6).astype(np.float32)
    j_out, j_gx, j_gp = _jax_vjp(jm, x, trees, g)
    xt = torch.tensor(x, requires_grad=True)
    out = tm(Table(xt, torch.tensor(trees)))
    params = [p for _, p in tree_leaves(tm.params_dict())]
    grads = torch.autograd.grad(out, [xt] + params, torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), j_out, **TOL)
    np.testing.assert_allclose(grads[0].numpy(), j_gx, **TOL)
    assert len(grads) - 1 == len(j_gp)
    for ours, theirs in zip(grads[1:], j_gp):
        np.testing.assert_allclose(ours.numpy(), theirs, **TOL)
    # the padded row's empty nodes are 0
    assert float(out[1, 3:].detach().abs().sum()) == 0.0


def test_forward_shapes_and_padding():
    jm, tm = _pair(4, 6, 3)
    x = np.random.RandomState(0).randn(1, 2, 4).astype(np.float32)
    trees = np.concatenate([_tiny_tree(), np.zeros((1, 1, 3), np.float32)],
                           axis=1)
    out = tm(Table(torch.tensor(x), torch.tensor(trees))).detach().numpy()
    assert out.shape == (1, 4, 6)
    assert np.any(out[0, 0] != 0)                 # root
    np.testing.assert_allclose(out[0, 3], 0.0)    # padding row
    np.testing.assert_allclose(out, np.asarray(jm(JaxTable(
        jnp.asarray(x), jnp.asarray(trees)))), **TOL)
    # the trees may come as numpy, as in the JAX layer
    np.testing.assert_allclose(tm(Table(torch.tensor(x), trees))
                               .detach().numpy(), out, **TOL)


def test_leaf_and_composer_math():
    """The root's h equals the composer over the two leaves by hand."""
    _, m = _pair(3, 2, 4)
    x = torch.tensor(np.random.RandomState(1).randn(1, 2, 3)
                     .astype(np.float32))
    with torch.no_grad():
        out = m(Table(x, torch.tensor(_tiny_tree())))
        lc1, lh1 = m._leaf(x[0, 0])
        lc2, lh2 = m._leaf(x[0, 1])
        _, hroot = m._compose(lc1, lh1, lc2, lh2)
    np.testing.assert_allclose(out[0, 1].numpy(), lh1.numpy(), **TOL)
    np.testing.assert_allclose(out[0, 2].numpy(), lh2.numpy(), **TOL)
    np.testing.assert_allclose(out[0, 0].numpy(), hroot.numpy(), **TOL)
    assert sorted(n for n, _ in m.named_children()) == sorted(
        ["leaf_c", "leaf_o"] + [f"comp_{g}_{s}" for g in
                                ("i", "lf", "rf", "update", "o")
                                for s in "lr"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnn.BinaryTreeLSTM(3, 2)


def test_backward_matches_the_jax_layer():
    """The eager ``backward``: the embeddings' gradient and the
    accumulated parameter gradients of the JAX layer's backward (its vjp
    with the trees held static, jitted here), and zeros for the trees, as
    the JAX layer returns."""
    jm, tm = _pair(4, 5, 5)
    rs = np.random.RandomState(6)
    x = rs.randn(2, 3, 4).astype(np.float32)
    trees = _deep_trees()
    g = rs.randn(2, 5, 5).astype(np.float32)
    _, j_gx, j_gp = _jax_vjp(jm, x, trees, g)
    tm.zero_grad_parameters()
    t_in = Table(torch.tensor(x), torch.tensor(trees))
    tm(t_in)
    t_gin = tm.backward(t_in, torch.tensor(g))
    np.testing.assert_allclose(t_gin[1].numpy(), j_gx, **TOL)
    assert float(t_gin[2].abs().sum()) == 0.0
    assert tuple(t_gin[2].shape) == trees.shape
    t_grads = [g for _, g in tree_leaves(tm.grads_dict())]
    assert len(t_grads) == len(j_gp)
    for ours, theirs in zip(t_grads, j_gp):
        np.testing.assert_allclose(ours.numpy(), theirs, **TOL)


def test_tree_lstm_learns_root_classification():
    """The tree-sentiment loop at the JAX test's sizes: the loss falls
    below 0.6 of its start in 40 steps."""
    rng = np.random.RandomState(3)
    n = 16
    x = rng.randn(n, 2, 4).astype(np.float32)
    y = torch.tensor((x[:, 0, 0] + x[:, 1, 0] > 0).astype(np.int64) + 1)
    trees = np.repeat(_tiny_tree(), n, axis=0)
    tree = tnn.BinaryTreeLSTM(4, 8, **CPU)
    head = tnn.Sequential().add(tnn.Linear(8, 2, **CPU)).add(
        tnn.LogSoftMax())
    crit = tnn.ClassNLLCriterion()
    inp = Table(torch.tensor(x), torch.tensor(trees))
    losses = []
    for _ in range(40):
        tree.zero_grad_parameters()
        head.zero_grad_parameters()
        with torch.no_grad():
            states = tree(inp)
            root = states[:, 0]
            out = head(root)
            losses.append(float(crit(out, y)))
        g_root = head.backward(root, crit.backward(out, y))
        g_states = torch.zeros_like(states)
        g_states[:, 0] = g_root
        tree.backward(inp, g_states)
        tree.update_parameters(0.2)
        head.update_parameters(0.2)
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])


def test_tree_nn_accuracy():
    # (batch 2, nodes 2, classes 3); root predictions argmax + 1 = [2, 3]
    out = np.asarray([[[0.1, 0.8, 0.1], [0.9, 0.05, 0.05]],
                      [[0.1, 0.2, 0.7], [0.9, 0.05, 0.05]]])
    target = np.asarray([[2.0, 1.0], [1.0, 1.0]])
    val, count = TreeNNAccuracy()(torch.tensor(out), target).result()
    assert count == 2 and abs(val - 0.5) < 1e-9
    assert JaxTreeNNAccuracy()(out, target).result() == (val, count)
    # one tree (n_nodes, n_classes)
    one = TreeNNAccuracy()(out[1], target[1]).result()
    assert one == JaxTreeNNAccuracy()(out[1], target[1]).result()
    with pytest.raises(ValueError, match="rank"):
        TreeNNAccuracy()(np.zeros(3), np.zeros(3))


def test_tree_nn_accuracy_binary():
    out = np.asarray([[[0.8], [0.2]], [[0.3], [0.9]]])
    target = np.asarray([[1.0, 0.0], [0.0, 0.0]])
    val, count = TreeNNAccuracy()(out, target).result()
    assert count == 2 and val == 1.0
    merged = TreeNNAccuracy()(out, target) + TreeNNAccuracy()(out[:1],
                                                              target[:1])
    assert merged.result() == (1.0, 3)
