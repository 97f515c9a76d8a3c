"""The table, shape, linear and container layers of the port held against
the JAX package where they are easy to get wrong.

Each case builds the layer in both packages, carries the JAX weights
across, and compares the forward and the input and parameter gradients
for one random cotangent (``jax.vjp`` against autograd) at rtol 1e-5 /
atol 1e-6 in f32, as the layer sweep does:

- ties in ``Max`` / ``Min`` / ``CMaxTable`` / ``CMinTable``, where
  ``jnp.max`` and ``jnp.maximum`` split the gradient evenly
  (``torch.max(dim)`` would send it to one index);
- ``ResizeBilinear`` growing, shrinking and at odd sizes
  (``jax.image.resize``: half-pixel centres, antialiased when it
  shrinks), and ``align_corners=True`` against the corner-aligned
  formula the JAX layer ignores;
- ``MaskedSelect``'s dense zero-filled copy;
- the 1-based dims and indices, negative dims and the batched shift;
- ``Euclidean``'s and ``Cosine``'s epsilons where an input equals a
  centre;
- ``MapTable``'s shared child, whose gradients add up over the entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.module import activity_tensors, tree_leaves
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")


def _jax_in(x):
    if isinstance(x, tuple):
        return JaxTable(*[_jax_in(v) for v in x])
    return jnp.asarray(x)


def _port_in(x, leaves):
    if isinstance(x, tuple):
        return Table(*[_port_in(v, leaves) for v in x])
    t = torch.tensor(x)
    if t.is_floating_point():
        t.requires_grad_(True)
        leaves.append(t)
    return t


def check(jm, tm, x, seed=7):
    """Forward and gradients of ``tm`` against ``jm`` on the numpy input
    ``x`` (a tuple is a Table); returns the port's outputs and input
    gradients."""
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    jm.evaluate()
    tm.evaluate()
    fn = pure_apply(jm)
    j_out, vjp = jax.vjp(
        lambda p, xx: fn(p, jm.buffers_dict(), xx, training=False)[0],
        jm.params_dict(), _jax_in(x))
    j_outs, tree = jax.tree.flatten(j_out)
    rs = np.random.RandomState(seed)
    gs = [rs.randn(*o.shape).astype(np.float32) for o in j_outs]
    j_gp, j_gx = vjp(jax.tree.unflatten(tree, [jnp.asarray(g) for g in gs]))

    leaves = []
    t_outs = activity_tensors(tm(_port_in(x, leaves)))
    params = [p for _, p in tree_leaves(tm.params_dict())]
    assert len(t_outs) == len(j_outs)
    for ours, theirs in zip(t_outs, j_outs):
        assert tuple(ours.shape) == tuple(theirs.shape)
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                   **TOL)
    grads = torch.autograd.grad(t_outs, leaves + params,
                                [torch.from_numpy(g) for g in gs],
                                allow_unused=True)
    grads = [np.zeros(tuple(t.shape), np.float32) if d is None else d.numpy()
             for t, d in zip(leaves + params, grads)]
    want = [np.asarray(a) for a in jax.tree.leaves(j_gx)
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)]
    want += [np.asarray(a) for a in jax.tree.leaves(j_gp)]
    assert len(grads) == len(want)
    for ours, theirs in zip(grads, want):
        np.testing.assert_allclose(ours, theirs, **TOL)
    return t_outs, grads[:len(leaves)]


# ------------------------------------------------------------------ ties
def _tied(shape, seed):
    """Integer-valued floats in {-1, 0, 1}: every row holds ties."""
    return np.random.RandomState(seed).randint(-1, 2, shape).astype(np.float32)


@pytest.mark.parametrize("cls", ["Max", "Min"])
@pytest.mark.parametrize("dim,num_input_dims,shape", [
    (2, 0, (3, 6)), (1, 1, (4, 5)), (2, 2, (2, 3, 4)), (-1, 0, (3, 5))])
def test_max_min_split_tied_gradients_as_jax(cls, dim, num_input_dims, shape):
    x = _tied(shape, 1)
    _, (gx,) = check(getattr(jnn, cls)(dim, num_input_dims),
                     getattr(tnn, cls)(dim, num_input_dims), x)
    # the split is real: some element got a fraction of its cotangent
    frac = np.abs(gx[gx != 0])
    assert frac.size and not np.all(np.isin(frac, np.abs(gx).max()))


def test_max_ties_share_where_torch_max_picks_one():
    x = torch.tensor([[2.0, 2.0, 1.0]], requires_grad=True)
    tnn.Max(2)(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [[0.5, 0.5, 0.0]])
    y = x.detach().clone().requires_grad_(True)
    y.max(dim=1).values.sum().backward()       # the form the port avoids
    assert sorted(y.grad.numpy().ravel().tolist()) == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("cls", ["CMaxTable", "CMinTable"])
def test_cmax_cmin_give_half_to_each_equal_input(cls):
    a = _tied((3, 4), 2)
    b = a.copy()
    b[0, 0] += 1.0                  # one element not tied
    _, (ga, gb) = check(getattr(jnn, cls)(), getattr(tnn, cls)(), (a, b))
    g = np.random.RandomState(7).randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(ga[1:], g[1:] / 2, **TOL)
    np.testing.assert_allclose(gb[1:], g[1:] / 2, **TOL)
    # three equal inputs: the chain of pairwise maxima, as in JAX
    check(getattr(jnn, cls)(), getattr(tnn, cls)(), (a, a.copy(), a.copy()))


# ------------------------------------------------------- ResizeBilinear
@pytest.mark.parametrize("hw,out", [
    ((4, 4), (6, 6)), ((8, 8), (3, 3)), ((7, 5), (3, 9)), ((5, 7), (11, 4)),
    ((9, 9), (9, 9)), ((6, 10), (1, 1))])
def test_resize_bilinear_matches_jax_image_resize(hw, out):
    x = np.random.RandomState(3).randn(2, 3, *hw).astype(np.float32)
    check(jnn.ResizeBilinear(*out), tnn.ResizeBilinear(*out), x)
    # a 3-D (C, H, W) input is the batched result's first image
    check(jnn.ResizeBilinear(*out), tnn.ResizeBilinear(*out), x[0])


def _corner_aligned(x, oh, ow):
    """The reference's align_corners form: output pixel i samples input
    position i * (in - 1) / (out - 1), bilinearly."""
    h, w = x.shape[-2:]

    def axis(n_in, n_out):
        pos = (np.arange(n_out) * (n_in - 1) / (n_out - 1) if n_out > 1
               else np.zeros(1))
        lo = np.floor(pos).astype(int)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, pos - lo

    ylo, yhi, fy = axis(h, oh)
    xlo, xhi, fx = axis(w, ow)
    top = x[..., ylo, :] * (1 - fy)[:, None] + x[..., yhi, :] * fy[:, None]
    return top[..., xlo] * (1 - fx) + top[..., xhi] * fx


@pytest.mark.parametrize("hw,out", [((4, 4), (7, 7)), ((9, 6), (4, 11))])
def test_resize_bilinear_align_corners_is_the_corner_aligned_form(hw, out):
    x = np.random.RandomState(4).randn(2, 3, *hw).astype(np.float32)
    got = tnn.ResizeBilinear(*out, align_corners=True)(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), _corner_aligned(x, *out),
                               rtol=1e-5, atol=1e-5)
    # corners land on corners; the JAX layer ignores the flag and
    # resizes by half-pixel centres
    np.testing.assert_allclose(got.numpy()[..., 0, 0], x[..., 0, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy()[..., -1, -1], x[..., -1, -1],
                               rtol=1e-6)
    jax_out = np.asarray(jnn.ResizeBilinear(*out, align_corners=True)(
        jnp.asarray(x)))
    assert np.abs(jax_out - got.numpy()).max() > 1e-2


# --------------------------------------------------------- MaskedSelect
def test_masked_select_is_a_dense_zero_filled_copy():
    rs = np.random.RandomState(5)
    x = rs.randn(3, 4, 5).astype(np.float32)
    mask = rs.rand(3, 4, 5) > 0.5
    (out,), (gx,) = check(jnn.MaskedSelect(), tnn.MaskedSelect(), (x, mask))
    assert tuple(out.shape) == x.shape            # not a packed vector
    np.testing.assert_array_equal(out.detach().numpy(), np.where(mask, x, 0))
    assert np.all(gx[~mask] == 0)


# ------------------------------------------- 1-based dims and indices
def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _masked_steps():
    """(2, 4, 3) with time steps 1 of the first and 3 of the second row
    all zero."""
    x = _f(2, 4, 3)
    x[0, 1] = 0.0
    x[1, 3] = 0.0
    return x


@pytest.mark.parametrize("name,args,x", [
    ("Select", (-1, 2), _f(3, 4, 5)),
    ("Select", (2, -1), _f(3, 4, 5)),
    ("Narrow", (-2, 2, 2), _f(3, 5, 4)),
    ("Narrow", (3, -3, 2), _f(3, 4, 6)),
    ("Narrow", (2, 2, -1), _f(3, 6)),
    ("Squeeze", (2, 2), _f(4, 3, 1)),            # batched: dim 2 -> axis 2
    ("Squeeze", ((1, 3), 0), _f(1, 3, 1, 2)),
    ("Squeeze", (-1,), _f(3, 4, 1)),
    ("Unsqueeze", (2, 2), _f(4, 3, 5)),
    ("Unsqueeze", (-1,), _f(3, 4)),
    ("Transpose", (((1, -1), (2, 3)),), _f(2, 3, 4, 5)),
    ("Reverse", (-1,), _f(2, 3, 4)),
    ("Tile", (-2, 3), _f(2, 3, 4)),
    ("Replicate", (2, -1), _f(3, 4)),
    ("Padding", (1, -2, 1, -1.5), _f(4, 3)),      # batched, padded before
    ("Padding", (-1, 3, 2), _f(4, 3)),
    ("Sum", (2, 2, True), _f(4, 3, 5)),
    ("Sum", (1, -1, False, False), _f(3, 5)),
    ("Mean", (2, 2, False), _f(4, 3, 5)),
    ("Max", (1, 1), _f(4, 6)),
    ("Min", (-1,), _f(4, 6)),
    ("InferReshape", ((0, -1, 2), True), _f(2, 3, 4)),
    ("SplitTable", (-1,), _f(2, 3, 4)),
    ("SplitTable", (1, 2), _f(5, 3, 4)),           # batched: splits dim 2
    ("BifurcateSplitTable", (2,), _f(3, 7)),
    ("Masking", (0.0,), _masked_steps()),
])
def test_dims_match_jax(name, args, x):
    check(getattr(jnn, name)(*args), getattr(tnn, name)(*args), x)


@pytest.mark.parametrize("name,args,x", [
    ("JoinTable", (1, 1), (_f(4, 3), _f(4, 5))),         # batched shift
    ("JoinTable", (-1,), (_f(2, 3, 4), _f(2, 3, 4))),    # JAX: axis -2
    ("Pack", (-1,), (_f(2, 3), _f(2, 3), _f(2, 3))),
    ("Pack", (3,), (_f(2, 3), _f(2, 3))),
    ("SelectTable", (-1,), (_f(2, 3), _f(2, 5))),
    ("NarrowTable", (2, -1), (_f(2, 3), _f(2, 3), _f(2, 3), _f(2, 2))),
    ("NarrowTable", (2, 2), (_f(2, 3), _f(2, 4), _f(2, 5))),
    ("MM", (True, True), (_f(2, 4, 3), _f(2, 5, 4))),
    ("MV", (True,), (_f(3, 4, 2), _f(3, 4))),
    ("PairwiseDistance", (1,), (_f(3, 4), _f(3, 4, seed=1))),
    ("FlattenTable", (), ((_f(2, 3), (_f(2, 2), _f(2, 1))), _f(2, 3))),
])
def test_table_dims_match_jax(name, args, x):
    check(getattr(jnn, name)(*args), getattr(tnn, name)(*args), x)


def test_index_takes_one_based_indices_and_jax_dims():
    t = _f(5, 4, 3)
    for dim, idx in ((1, [1, 5, 2]), (2, [4, 4, 1]), (-1, [2, 1]),
                     (3, [3, 1])):
        idx = np.asarray(idx, np.int32)
        (out,), _ = check(jnn.Index(dim), tnn.Index(dim), (t, idx))
        ax = dim - 1
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.take(t, idx - 1, axis=ax))


def test_pairwise_distance_of_equal_inputs_has_finite_gradient():
    a = _f(3, 4)
    _, (ga, gb) = check(jnn.PairwiseDistance(), tnn.PairwiseDistance(),
                        (a, a.copy()))
    assert np.isfinite(ga).all() and np.isfinite(gb).all()


# ------------------------------------------------------------ epsilons
def test_euclidean_gradient_where_an_input_equals_a_centre():
    jm, tm = jnn.Euclidean(4, 3), tnn.Euclidean(4, 3, **CPU)
    w = np.asarray(jm.params_dict()["~params"]["weight"])
    x = np.stack([w[1], _f(4, seed=2)])          # row 0 sits on centre 1
    (out,), (gx,) = check(jm, tm, x)
    np.testing.assert_allclose(out.detach().numpy()[0, 1], 1e-6, rtol=1e-3)
    assert np.isfinite(gx).all()


def test_cosine_gradient_where_an_input_equals_a_centre():
    jm, tm = jnn.Cosine(4, 3), tnn.Cosine(4, 3, **CPU)
    w = np.asarray(jm.params_dict()["~params"]["weight"])
    x = np.stack([w[2], 1e-3 * w[0], _f(4, seed=3)])
    (out,), _ = check(jm, tm, x)
    np.testing.assert_allclose(out.detach().numpy()[0, 2], 1.0, rtol=1e-6)


def test_cosine_distance_matches_jax_at_parallel_inputs():
    a = _f(3, 4)
    check(jnn.CosineDistance(), tnn.CosineDistance(), (a, 2.0 * a))


# ----------------------------------------------------------- containers
def test_map_table_gradients_add_up_over_the_entries():
    jm, tm = jnn.MapTable(jnn.Linear(4, 3)), tnn.MapTable(
        tnn.Linear(4, 3, **CPU))
    xs = (_f(2, 4), _f(2, 4, seed=1), _f(2, 4, seed=2))
    check(jm, tm, xs)
    # the shared weight's gradient is the sum of the three entries' own
    tm.zero_grad()
    outs = list(tm(Table(*[torch.tensor(v) for v in xs])))
    sum(o.sum() for o in outs).backward()
    want = sum(np.ones((2, 3), np.float32).T @ v for v in xs)
    np.testing.assert_allclose(tm[0].weight.grad.numpy(), want, **TOL)


def test_parallel_table_bottle_time_distributed_match_jax():
    check(jnn.ParallelTable(jnn.Linear(4, 3), jnn.Tanh()),
          tnn.ParallelTable(tnn.Linear(4, 3, **CPU), tnn.Tanh()),
          (_f(2, 4), _f(2, 5)))
    check(jnn.Bottle(jnn.Linear(4, 3)), tnn.Bottle(tnn.Linear(4, 3, **CPU)),
          _f(2, 3, 5, 4))
    check(jnn.Bottle(jnn.Linear(4, 3), 3),
          tnn.Bottle(tnn.Linear(4, 3, **CPU), 3), _f(2, 3, 5, 4))
    check(jnn.TimeDistributed(jnn.Sequential(jnn.Linear(5, 3), jnn.Tanh())),
          tnn.TimeDistributed(tnn.Sequential(tnn.Linear(5, 3, **CPU),
                                             tnn.Tanh())),
          _f(2, 4, 3, 5))
    assert tnn.DynamicContainer is tnn.Container
    seq = tnn.DynamicContainer().add(tnn.Identity())
    assert len(seq) == 1


def test_bilinear_scale_parameters_cross_by_name():
    for jm, tm in ((jnn.Bilinear(3, 4, 5, bias_res=False),
                    tnn.Bilinear(3, 4, 5, bias_res=False, **CPU)),
                   (jnn.Scale((3, 1)), tnn.Scale((3, 1), **CPU))):
        x = ((_f(3, 3), _f(3, 4)) if isinstance(tm, tnn.Bilinear)
             else _f(2, 3, 4))
        check(jm, tm, x)
    names = [n for n, _ in tree_leaves(tnn.Scale((1, 4), **CPU).params_dict())]
    assert names == ["cadd.bias", "cmul.weight"]


def test_new_linear_layers_follow_the_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the rule is about a machine without a card")
    for make in (lambda: tnn.Add(4), lambda: tnn.Mul(),
                 lambda: tnn.CMul((1, 4)), lambda: tnn.CAdd((1, 4)),
                 lambda: tnn.Scale((1, 4)), lambda: tnn.Bilinear(2, 3, 4),
                 lambda: tnn.Euclidean(4, 3), lambda: tnn.Cosine(4, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
