"""The port's vision layers (bigdl_tpu_torch/nn/{conv,normalization,
pooling,activation,container,table_ops,shape_ops}.py) against the JAX
package's, forward and gradients: the same numpy input and output
cotangent go through the JAX layer (``jax.grad`` of the cotangent's dot
product with the output, through ``pure_apply``) and the port's
(autograd), on weights and buffers carried across by the bridge.

Tolerance: f32 at rtol 1e-5 / atol 1e-5 for the outputs, the gradients
and the running statistics (both sides compute the same f32 math; the
convolutions and reductions sum in another order, on inputs and weights
of order 1). Max pooling and the elementwise layers agree exactly up to
that tolerance too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.weights import (buffers_to_numpy,
                                           load_jax_buffers, load_jax_params)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge(jm, tm):
    load_jax_params(tm, _np(jm.params_dict()))
    load_jax_buffers(tm, _np(jm.buffers_dict()))
    return tm


def _jax_run(jm, x, g, training):
    """(out, new buffers, param grads as leaves, input grad)."""
    fn = pure_apply(jm)
    buffers = jm.buffers_dict()

    def f(p, xx):
        out, nb = fn(p, buffers, xx, training=training)
        return jnp.sum(out * g), (out, nb)

    (_, (out, nb)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jm.params_dict(), jnp.asarray(x))
    return (np.asarray(out), _np(nb),
            [np.asarray(a) for a in jax.tree.leaves(gp)], np.asarray(gx))


def _port_run(tm, x, g, training):
    tm.train(training)
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt)
    (out * torch.from_numpy(g)).sum().backward()
    grads = [p.grad.numpy() for _, p in tree_leaves(tm.params_dict())]
    return out.detach().numpy(), buffers_to_numpy(tm), grads, xt.grad.numpy()


def _check(jm, tm, x, training=True, tol=TOL):
    """Forward, input and parameter gradients, and the buffers after one
    call, port against JAX; returns the port's output."""
    _bridge(jm, tm)
    shape = jax.eval_shape(lambda xx: pure_apply(jm)(
        jm.params_dict(), jm.buffers_dict(), xx, training=training)[0],
        jnp.asarray(x)).shape
    g = _rand(*shape, seed=99)
    j_out, j_buf, j_gp, j_gx = _jax_run(jm, x, g, training)
    t_out, t_buf, t_gp, t_gx = _port_run(tm, x, g, training)
    np.testing.assert_allclose(t_out, j_out, **tol)
    np.testing.assert_allclose(t_gx, j_gx, **tol)
    assert len(t_gp) == len(j_gp)
    for ours, theirs in zip(t_gp, j_gp):
        np.testing.assert_allclose(ours, theirs, **tol)
    for (name, ours), (_, theirs) in zip(tree_leaves(t_buf),
                                         tree_leaves(j_buf)):
        np.testing.assert_allclose(ours, theirs, **tol, err_msg=name)
    return t_out


# (constructor args, input shape NCHW): plain, strided and padded, groups
# without bias, SAME at stride 1 (symmetric) and stride 2 (the odd pad
# element on the high side), rectangular kernel, unbatched
CONV_CASES = {
    "plain": ((3, 8, 3, 3), {}, (2, 3, 9, 9)),
    "stride_pad": ((3, 8, 3, 3, 2, 2, 1, 1), {}, (2, 3, 10, 11)),
    "groups_no_bias": ((4, 6, 3, 3, 1, 1, 1, 1),
                       dict(n_group=2, with_bias=False), (2, 4, 7, 7)),
    "same_stride1": ((3, 5, 3, 3, 1, 1, -1, -1), {}, (2, 3, 8, 8)),
    "same_stride2": ((3, 5, 4, 3, 2, 2, -1, -1), {}, (2, 3, 9, 8)),
    "rect_kernel": ((3, 4, 5, 3, 1, 2, 2, 1), {}, (2, 3, 9, 10)),
    "unbatched": ((3, 4, 3, 3, 1, 1, 1, 1), {}, (3, 6, 6)),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_spatial_convolution_matches_jax(case, fmt):
    args, kw, shape = CONV_CASES[case]
    jm = jnn.SpatialConvolution(*args, format=fmt, **kw)
    # a nonzero bias, so that its gradient and its add are checked
    if jm.with_bias:
        jm._set_param("bias", jnp.asarray(_rand(args[1], seed=3)))
    tm = tnn.SpatialConvolution(*args, format=fmt, device="cpu", **kw)
    x = _rand(*shape, seed=1)
    if fmt == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, -3, -1))
    out = _check(jm, tm, x)
    if fmt == "NHWC":
        assert tm.weight.is_contiguous(memory_format=torch.channels_last)
        assert out.shape[-1] == args[1]


def _random_bn(jm, n, seed):
    rs = np.random.RandomState(seed)
    jm._set_param("weight", jnp.asarray(rs.uniform(0.5, 1.5, n), jnp.float32))
    jm._set_param("bias", jnp.asarray(rs.randn(n), jnp.float32))
    jm._set_buffer("running_mean", jnp.asarray(rs.randn(n), jnp.float32))
    jm._set_buffer("running_var",
                   jnp.asarray(rs.uniform(0.5, 2.0, n), jnp.float32))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("fmt,shape", [("NCHW", (4, 5, 6, 7)),
                                       ("NHWC", (4, 6, 7, 5)),
                                       ("NCHW", (5, 6, 7))])
def test_spatial_batch_norm_matches_jax(fmt, shape, training):
    jm = jnn.SpatialBatchNormalization(5, 1e-3, format=fmt)
    _random_bn(jm, 5, seed=4)
    tm = tnn.SpatialBatchNormalization(5, 1e-3, format=fmt, device="cpu")
    before = np.asarray(jm.running_mean)
    x = _rand(*shape, seed=5) * 2 + 0.5
    _check(jm, tm, x, training=training)
    moved = not np.allclose(tm.running_mean.numpy(), before)
    assert moved == training


def test_batch_norm_2d_and_no_affine_match_jax():
    jm = jnn.BatchNormalization(6)
    _random_bn(jm, 6, seed=6)
    _check(jm, tnn.BatchNormalization(6, device="cpu"),
           _rand(8, 6, seed=7) * 3)
    jm = jnn.BatchNormalization(6, affine=False)
    _check(jm, tnn.BatchNormalization(6, affine=False, device="cpu"),
           _rand(8, 6, seed=8))


def test_batch_norm_keeps_bf16_activations_and_f32_statistics():
    tm = tnn.SpatialBatchNormalization(4, device="cpu", dtype=torch.bfloat16)
    x = torch.from_numpy(_rand(2, 4, 3, 3, seed=9)).to(torch.bfloat16)
    y = tm(x)
    assert y.dtype == torch.bfloat16
    assert tm.running_mean.dtype == tm.running_var.dtype == torch.float32
    xf = x.float()
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               0.1 * xf.mean((0, 2, 3)).numpy(), rtol=1e-6)


# (kw, kh, dw, dh, pad_w, pad_h), input H x W: floor; padded (the
# asymmetric high side the output size asks for); ceil mode with an
# overhang; ceil with padding; ResNet's stem pool
POOL_CASES = {
    "floor": ((2, 2, 2, 2, 0, 0), (7, 8), False),
    "padded": ((3, 3, 2, 2, 1, 1), (9, 8), False),
    "ceil": ((3, 3, 2, 2, 0, 0), (8, 9), True),
    "ceil_padded": ((3, 2, 2, 2, 1, 1), (8, 7), True),
    "stem": ((3, 3, 2, 2, 1, 1), (12, 12), False),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pooling_matches_jax(case, fmt):
    args, (h, w), ceil = POOL_CASES[case]
    jm = jnn.SpatialMaxPooling(*args, format=fmt)
    tm = tnn.SpatialMaxPooling(*args, format=fmt)
    if ceil:
        jm.ceil()
        tm.ceil()
    shape = (2, h, w, 3) if fmt == "NHWC" else (2, 3, h, w)
    _check(jm, tm, _rand(*shape, seed=10))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_average_pooling_matches_jax(case, count_include_pad, fmt):
    args, (h, w), ceil = POOL_CASES[case]
    kw = dict(ceil_mode=ceil, count_include_pad=count_include_pad,
              format=fmt)
    jm = jnn.SpatialAveragePooling(*args, **kw)
    tm = tnn.SpatialAveragePooling(*args, **kw)
    shape = (2, h, w, 3) if fmt == "NHWC" else (2, 3, h, w)
    _check(jm, tm, _rand(*shape, seed=11))


def test_average_pooling_ceil_overhang_divides_by_the_window():
    """In ceil mode with count_include_pad the last window hangs over the
    input and still divides by kH * kW, where F.avg_pool2d's own ceil
    mode divides by the clipped window."""
    x = np.arange(25, dtype=np.float32).reshape(1, 1, 5, 5)
    tm = tnn.SpatialAveragePooling(2, 2, 2, 2, ceil_mode=True)
    out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == (1, 1, 3, 3)
    assert out[0, 0, 2, 2] == x[0, 0, 4, 4] / 4
    lib = torch.nn.functional.avg_pool2d(torch.from_numpy(x), 2, 2,
                                         ceil_mode=True)
    assert lib[0, 0, 2, 2] == x[0, 0, 4, 4]
    ref = jnn.SpatialAveragePooling(2, 2, 2, 2, ceil_mode=True)(
        jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kw", [dict(global_pooling=True),
                                dict(divide=False),
                                dict(global_pooling=True, divide=False)])
def test_global_and_undivided_average_pooling_match_jax(kw, fmt):
    jm = jnn.SpatialAveragePooling(2, 2, 1, 1, format=fmt, **kw)
    tm = tnn.SpatialAveragePooling(2, 2, 1, 1, format=fmt, **kw)
    shape = (2, 5, 6, 3) if fmt == "NHWC" else (2, 3, 5, 6)
    _check(jm, tm, _rand(*shape, seed=12))


def test_unbatched_pooling_matches_jax():
    x = _rand(3, 7, 7, seed=13)
    _check(jnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
           tnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1), x)
    _check(jnn.SpatialAveragePooling(2, 2).ceil(),
           tnn.SpatialAveragePooling(2, 2).ceil(), x)


@pytest.mark.parametrize("name", ["ReLU", "Tanh", "LogSoftMax", "Identity"])
def test_activations_match_jax(name):
    _check(getattr(jnn, name)(), getattr(tnn, name)(), _rand(4, 7, seed=14))


def test_mul_constant_matches_jax():
    _check(jnn.MulConstant(0.5), tnn.MulConstant(0.5), _rand(3, 5, seed=15))


def _shortcut_pair(fmt):
    """The ResNet type-A shortcut body in both packages: a strided 1x1
    average pool, then Concat(channel dim, Identity, MulConstant(0))."""
    ch = 4 if fmt == "NHWC" else 2
    mods = []
    for nn in (jnn, tnn):
        mods.append(nn.Sequential(
            nn.SpatialAveragePooling(1, 1, 2, 2, format=fmt),
            nn.Concat(ch, nn.Identity(), nn.MulConstant(0.0))))
    return mods


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_concat_zero_pad_shortcut_matches_jax(fmt):
    jm, tm = _shortcut_pair(fmt)
    x = _rand(2, 3, 6, 6, seed=16)
    if fmt == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    out = _check(jm, tm, x)
    ch = out.shape[-1] if fmt == "NHWC" else out.shape[1]
    assert ch == 6


def test_concat_table_cadd_residual_matches_jax():
    mods = []
    for nn in (jnn, tnn):
        kw = {} if nn is jnn else {"device": "cpu"}
        branch = nn.Sequential(nn.SpatialConvolution(3, 3, 3, 3, 1, 1, 1, 1,
                                                     **kw), nn.ReLU())
        mods.append(nn.Sequential(nn.ConcatTable(branch, nn.Identity()),
                                  nn.CAddTable(), nn.ReLU()))
    jm, tm = mods
    assert [n for n, _ in tree_leaves(tm.params_dict())] == \
        ["m0.m0.m0.bias", "m0.m0.m0.weight"]
    _check(jm, tm, _rand(2, 3, 5, 5, seed=17))
    t = tm[0](torch.from_numpy(_rand(1, 3, 5, 5)))
    assert isinstance(t, Table) and sorted(t.keys()) == [1, 2]


@pytest.mark.parametrize("layer,shape,want", [
    (lambda nn: nn.View(12), (2, 3, 4), (2, 12)),
    (lambda nn: nn.View(12), (3, 4), (12,)),
    (lambda nn: nn.View(-1, 4), (2, 3, 4), (2, 3, 4)),
    (lambda nn: nn.View(-1, 4), (3, 4), (3, 4)),
    (lambda nn: nn.Reshape((1, 4, 3)), (12,), (1, 4, 3)),
    (lambda nn: nn.Reshape((1, 4, 3)), (5, 12), (5, 1, 4, 3)),
    (lambda nn: nn.Reshape((4, 3), batch_mode=True), (1, 12), (1, 4, 3)),
])
def test_view_and_reshape_infer_the_batch_as_jax(layer, shape, want):
    x = _rand(*shape, seed=18)
    ours = layer(tnn)(torch.from_numpy(x))
    theirs = layer(jnn)(jnp.asarray(x))
    assert tuple(ours.shape) == tuple(theirs.shape) == want
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
