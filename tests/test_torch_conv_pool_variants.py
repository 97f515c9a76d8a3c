"""The conv and pooling variants of the port (bigdl_tpu_torch/nn/conv.py,
nn/pooling.py) against the JAX package at the edges the layer sweep's
fixtures do not reach: odd planes, stride > 1, dilation 2, adj > 0 (below
the stride, where ``conv_transpose`` takes it, and at or above it, where
the port dilates the input itself), n_group > 1, ceil-mode windows that
start in the padding, pool sizes 4 and 5, pads wider than half the
window, and ``SpatialConvolutionMap`` with a connection table. Each case
carries the JAX weights across and holds the forward, the input gradient
and every parameter gradient for one random cotangent at rtol 1e-5 /
atol 1e-6 in f32 (as the sweep does).
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
from bigdl_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")

# id -> (JAX layer, port layer, input shape)
CASES = {
    "dilated_odd_stride2": (
        lambda: jnn.SpatialDilatedConvolution(3, 4, 3, 3, 2, 2, 1, 1, 2, 2),
        lambda: tnn.SpatialDilatedConvolution(3, 4, 3, 3, 2, 2, 1, 1, 2, 2,
                                              **CPU), (2, 3, 9, 7)),
    "dilated_same_groups_nhwc": (
        lambda: jnn.SpatialDilatedConvolution(4, 6, 3, 3, 2, 2, -1, -1, 2,
                                              2, n_group=2, format="NHWC"),
        lambda: tnn.SpatialDilatedConvolution(4, 6, 3, 3, 2, 2, -1, -1, 2,
                                              2, n_group=2, format="NHWC",
                                              **CPU), (2, 9, 8, 4)),
    "share_stride2_pad": (
        lambda: jnn.SpatialShareConvolution(3, 5, 4, 4, 2, 2, 1, 1),
        lambda: tnn.SpatialShareConvolution(3, 5, 4, 4, 2, 2, 1, 1, **CPU),
        (2, 3, 9, 9)),
    "full_adj_groups": (
        lambda: jnn.SpatialFullConvolution(4, 6, 3, 3, 2, 2, 1, 1, 1, 1,
                                           n_group=2),
        lambda: tnn.SpatialFullConvolution(4, 6, 3, 3, 2, 2, 1, 1, 1, 1,
                                           n_group=2, **CPU), (2, 4, 5, 7)),
    "full_adj_at_stride": (
        lambda: jnn.SpatialFullConvolution(4, 2, 3, 2, 1, 1, 0, 0, 1, 2,
                                           n_group=2),
        lambda: tnn.SpatialFullConvolution(4, 2, 3, 2, 1, 1, 0, 0, 1, 2,
                                           n_group=2, **CPU), (2, 4, 5, 4)),
    "full_wide_pad_unbatched": (
        lambda: jnn.SpatialFullConvolution(2, 3, 3, 3, 3, 2, 3, 2),
        lambda: tnn.SpatialFullConvolution(2, 3, 3, 3, 3, 2, 3, 2, **CPU),
        (2, 6, 7)),
    "separable_stride2_odd": (
        lambda: jnn.SpatialSeparableConvolution(3, 5, 2, 3, 3, 2, 2, 1, 1),
        lambda: tnn.SpatialSeparableConvolution(3, 5, 2, 3, 3, 2, 2, 1, 1,
                                                **CPU), (2, 3, 9, 7)),
    "local2d_stride2_pad": (
        lambda: jnn.LocallyConnected2D(3, 7, 9, 4, 3, 3, 2, 2, 1, 1),
        lambda: tnn.LocallyConnected2D(3, 7, 9, 4, 3, 3, 2, 2, 1, 1, **CPU),
        (2, 3, 9, 7)),
    "temporal_stride2_unbatched": (
        lambda: jnn.TemporalConvolution(5, 4, 3, 2),
        lambda: tnn.TemporalConvolution(5, 4, 3, 2, **CPU), (9, 5)),
    "volumetric_strided_padded": (
        lambda: jnn.VolumetricConvolution(2, 3, 3, 3, 2, 2, 1, 2, 1, 1, 0),
        lambda: tnn.VolumetricConvolution(2, 3, 3, 3, 2, 2, 1, 2, 1, 1, 0,
                                          **CPU), (2, 2, 5, 7, 6)),
    "volumetric_full_adj_groups": (
        lambda: jnn.VolumetricFullConvolution(4, 2, 2, 3, 3, 2, 2, 2, 0, 1,
                                              1, 1, 1, 0, n_group=2),
        lambda: tnn.VolumetricFullConvolution(4, 2, 2, 3, 3, 2, 2, 2, 0, 1,
                                              1, 1, 1, 0, n_group=2, **CPU),
        (1, 4, 3, 4, 5)),
    "volumetric_full_adj_at_stride": (
        lambda: jnn.VolumetricFullConvolution(2, 3, 2, 2, 2, 1, 1, 1, 0, 0,
                                              0, 1, 0, 2),
        lambda: tnn.VolumetricFullConvolution(2, 3, 2, 2, 2, 1, 1, 1, 0, 0,
                                              0, 1, 0, 2, **CPU),
        (1, 2, 3, 4, 3)),
    "local1d_stride2": (
        lambda: jnn.LocallyConnected1D(9, 4, 3, 3, 2),
        lambda: tnn.LocallyConnected1D(9, 4, 3, 3, 2, **CPU), (2, 9, 4)),
    "temporal_maxpool_4_stride3": (
        lambda: jnn.TemporalMaxPooling(4, 3),
        lambda: tnn.TemporalMaxPooling(4, 3), (2, 11, 3)),
    "volumetric_maxpool_4_padded": (
        lambda: jnn.VolumetricMaxPooling(4, 4, 4, 2, 2, 2, 1, 1, 1),
        lambda: tnn.VolumetricMaxPooling(4, 4, 4, 2, 2, 2, 1, 1, 1),
        (1, 2, 7, 9, 5)),
    "volumetric_maxpool_wide_pad": (
        lambda: jnn.VolumetricMaxPooling(3, 3, 2, 2, 2, 1, 2, 0, 1),
        lambda: tnn.VolumetricMaxPooling(3, 3, 2, 2, 2, 1, 2, 0, 1),
        (1, 2, 5, 6, 7)),
    "volumetric_avgpool_5": (
        lambda: jnn.VolumetricAveragePooling(5, 5, 5, 3, 3, 3, 2, 2, 2),
        lambda: tnn.VolumetricAveragePooling(5, 5, 5, 3, 3, 3, 2, 2, 2),
        (1, 2, 7, 9, 8)),
    "volumetric_avgpool_no_count": (
        lambda: jnn.VolumetricAveragePooling(3, 3, 3, 2, 2, 2, 1, 1, 1,
                                             count_include_pad=False),
        lambda: tnn.VolumetricAveragePooling(3, 3, 3, 2, 2, 2, 1, 1, 1,
                                             count_include_pad=False),
        (1, 2, 5, 6, 7)),
    "volumetric_avgpool_wide_pad_no_count": (
        lambda: jnn.VolumetricAveragePooling(2, 3, 2, 1, 2, 2, 2, 1, 1,
                                             count_include_pad=False),
        lambda: tnn.VolumetricAveragePooling(2, 3, 2, 1, 2, 2, 2, 1, 1,
                                             count_include_pad=False),
        (2, 3, 4, 5)),
    "map_random_table": (
        lambda: jnn.SpatialConvolutionMap(
            jnn.SpatialConvolutionMap.random(4, 5, 2, seed=3), 3, 3, 2, 2,
            1, 1),
        lambda: tnn.SpatialConvolutionMap(
            tnn.SpatialConvolutionMap.random(4, 5, 2, seed=3), 3, 3, 2, 2,
            1, 1, **CPU), (2, 4, 9, 7)),
    "map_full_unbatched": (
        lambda: jnn.SpatialConvolutionMap(
            jnn.SpatialConvolutionMap.full(2, 3), 2, 3),
        lambda: tnn.SpatialConvolutionMap(
            tnn.SpatialConvolutionMap.full(2, 3), 2, 3, **CPU), (2, 6, 5)),
    "map_one_to_one": (
        lambda: jnn.SpatialConvolutionMap(
            jnn.SpatialConvolutionMap.one_to_one(3), 3, 3, 1, 1, 1, 1),
        lambda: tnn.SpatialConvolutionMap(
            tnn.SpatialConvolutionMap.one_to_one(3), 3, 3, 1, 1, 1, 1,
            **CPU), (2, 3, 5, 6)),
}

# ceil-mode windows that start in the padding, odd planes, sizes 4 and 5
INDEX_CASES = {
    "ceil_4_stride2_pad1": ((4, 4, 2, 2, 1, 1), True, (2, 3, 9, 7)),
    "ceil_5_stride3_pad2": ((5, 5, 3, 3, 2, 2), True, (1, 2, 11, 8)),
    "floor_3_stride2_pad1": ((3, 3, 2, 2, 1, 1), False, (2, 2, 7, 9)),
    "ceil_2_rect_unbatched": ((2, 3, 2, 2, 0, 1), True, (3, 7, 5)),
}


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_vjp(jm, x, g):
    fn = pure_apply(jm)
    bufs = jm.buffers_dict()
    out, vjp = jax.vjp(lambda p, xx: fn(p, bufs, xx, training=False)[0],
                       jm.params_dict(), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    return (np.asarray(out), np.asarray(gx),
            [np.asarray(a) for a in jax.tree.leaves(gp)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_matches_jax_at_its_edges(case):
    jfac, tfac, shape = CASES[case]
    jm, tm = jfac(), tfac()
    jm.evaluate()
    tm.evaluate()
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    # nonzero biases, so that their adds and gradients are checked
    with torch.no_grad():
        for i, (name, p) in enumerate(tree_leaves(tm.params_dict())):
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(_rand(*p.shape, seed=10 + i)))
    load_params = {n: p.detach().numpy() for n, p in
                   tree_leaves(tm.params_dict())}
    _set_jax_params(jm, load_params)
    x = _rand(*shape, seed=1)
    xt = torch.tensor(x, requires_grad=True)
    params = [p for _, p in tree_leaves(tm.params_dict())]
    out = tm(xt)
    g = _rand(*out.shape, seed=2)
    j_out, j_gx, j_gp = _jax_vjp(jm, x, g)
    assert tuple(out.shape) == j_out.shape, case
    grads = torch.autograd.grad(out, [xt] + params, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), j_out, **TOL,
                               err_msg=f"{case}: forward")
    np.testing.assert_allclose(grads[0].numpy(), j_gx, **TOL,
                               err_msg=f"{case}: input grad")
    names = [n for n, _ in tree_leaves(tm.params_dict())]
    assert len(params) == len(j_gp)
    for name, ours, theirs in zip(names, grads[1:], j_gp):
        np.testing.assert_allclose(ours.numpy(), theirs, **TOL,
                                   err_msg=f"{case}: grad of {name}")


def _set_jax_params(jm, flat):
    """Write the port's (dotted name -> array) values into the JAX layer
    and its children."""
    for name, value in flat.items():
        *path, leaf = name.split(".")
        m = jm
        for p in path:
            m = m._modules[p]
        m._set_param(leaf, jnp.asarray(value))


def _brute_pool(x, kh, kw, dh, dw, pad_h, pad_w, out_h, out_w):
    """Max and 1-based flat index of every window over the padded plane
    by loops: the first maximum in row-major order; 0 where a window
    sees only padding."""
    n, c, h, w = x.shape
    pooled = np.full((n, c, out_h, out_w), -np.inf, np.float32)
    idx = np.zeros((n, c, out_h, out_w), np.float32)
    for i in range(out_h):
        for j in range(out_w):
            for a in range(kh):
                for b in range(kw):
                    y, z = i * dh + a - pad_h, j * dw + b - pad_w
                    if 0 <= y < h and 0 <= z < w:
                        v = x[:, :, y, z]
                        better = v > pooled[:, :, i, j]
                        pooled[:, :, i, j] = np.where(better, v,
                                                      pooled[:, :, i, j])
                        idx[:, :, i, j] = np.where(better, y * w + z + 1,
                                                   idx[:, :, i, j])
    return pooled, idx


def _brute_grad(x, g, kh, kw, dh, dw, pad_h, pad_w):
    """d(sum(g * maxpool(x))) / dx by loops, a window's cotangent split
    evenly over its cells equal to its maximum."""
    n, c, h, w = x.shape
    out = np.zeros_like(x, dtype=np.float64)
    for i in range(g.shape[2]):
        for j in range(g.shape[3]):
            cells = [(y, z) for a in range(kh) for b in range(kw)
                     for y, z in [(i * dh + a - pad_h, j * dw + b - pad_w)]
                     if 0 <= y < h and 0 <= z < w]
            vals = np.stack([x[:, :, y, z] for y, z in cells], -1)
            hit = vals == vals.max(-1, keepdims=True)
            share = g[:, :, i, j] / hit.sum(-1)
            for k, (y, z) in enumerate(cells):
                out[:, :, y, z] += np.where(hit[..., k], share, 0.0)
    return out.astype(np.float32)


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_max_pooling_with_indices_and_unpooling_match_jax(case):
    """The pooled values and indices equal a loop over the windows
    everywhere and the JAX layer's wherever the JAX values are finite:
    JAX extracts patches by a convolution, which turns a window that
    reaches its -inf padding into NaN (a fault of the JAX package this
    port does not share); the pooled gradient and the unpooling of the
    port's table match JAX's."""
    args, ceil, shape = INDEX_CASES[case]
    kw, kh, dw, dh, pad_w, pad_h = args
    jp, tp = jnn.SpatialMaxPoolingWithIndices(*args), \
        tnn.SpatialMaxPoolingWithIndices(*args)
    if ceil:
        jp.ceil()
        tp.ceil()
    # ties inside a window: the first in row-major order wins on both
    x = np.round(_rand(*shape, seed=4) * 2) / 2
    j_pooled, j_idx = map(np.asarray, jp.forward(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    pooled, idx = list(tp(xt))
    assert idx.dtype == torch.float32
    assert pooled.shape == j_pooled.shape and idx.shape == j_idx.shape
    x4 = x if x.ndim == 4 else x[None]
    b_pooled, b_idx = _brute_pool(x4, kh, kw, dh, dw, pad_h, pad_w,
                                  *pooled.shape[-2:])
    if x.ndim == 3:
        b_pooled, b_idx = b_pooled[0], b_idx[0]
    np.testing.assert_array_equal(pooled.detach().numpy(), b_pooled)
    np.testing.assert_array_equal(idx.numpy(), b_idx)
    ok = np.isfinite(j_pooled)
    assert ok.any()
    np.testing.assert_array_equal(pooled.detach().numpy()[ok], j_pooled[ok])
    np.testing.assert_array_equal(idx.numpy()[ok], j_idx[ok])
    # the pooled values' gradient: each window's cotangent split evenly
    # over the cells that hold its maximum, as jnp.max's (the JAX
    # gradient itself is NaN wherever a window reached the padding)
    g = _rand(*pooled.shape, seed=5)
    (gx,) = torch.autograd.grad(pooled, xt, torch.from_numpy(g))
    g4 = g if g.ndim == 4 else g[None]
    want = _brute_grad(x4, g4, kh, kw, dh, dw, pad_h, pad_w)
    np.testing.assert_allclose(gx.numpy(), want.reshape(x.shape), **TOL)
    # unpooling the port's table, the indices' plane included
    from bigdl_tpu.utils.table import Table as JaxTable
    from bigdl_tpu_torch.utils.table import Table

    ju, tu = jnn.SpatialUnpooling(*args), tnn.SpatialUnpooling(*args)
    pv = pooled.detach()
    j_up = np.asarray(ju.forward(JaxTable(jnp.asarray(pv.numpy()),
                                          jnp.asarray(idx.numpy()))))
    np.testing.assert_allclose(tu(Table(pv, idx)).numpy(), j_up, **TOL)


def test_max_pooling_floor_undoes_ceil():
    x = torch.from_numpy(_rand(2, 3, 7, 7, seed=6))
    m = tnn.SpatialMaxPooling(2, 2, 2, 2)
    floor_shape = tuple(m(x).shape)
    assert m.ceil() is m and tuple(m(x).shape) == (2, 3, 4, 4)
    assert m.floor() is m and tuple(m(x).shape) == floor_shape == (2, 3, 3, 3)
    jm = jnn.SpatialMaxPooling(2, 2, 2, 2).ceil().floor()
    np.testing.assert_allclose(m(x).numpy(),
                               np.asarray(jm.forward(jnp.asarray(x.numpy()))),
                               **TOL)


def test_volumetric_average_pooling_in_bf16_on_the_cpu():
    """The CPU has no bf16 ``avg_pool3d``: the port pools in f32 there
    and casts back; the result is the f32 one rounded to bf16."""
    m = tnn.VolumetricAveragePooling(2, 2, 2, 2, 2, 2, 1, 1, 1)
    x = torch.from_numpy(_rand(1, 2, 5, 6, 7, seed=7))
    out = m(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    want = m(x.to(torch.bfloat16).float()).to(torch.bfloat16)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_indices_and_unpooling_refuse_nhwc():
    for cls in (tnn.SpatialMaxPoolingWithIndices, tnn.SpatialUnpooling):
        with pytest.raises(ValueError, match="NCHW"):
            cls(2, 2, format="NHWC")


def test_connection_table_tables_match_jax():
    for ours, theirs in (
            (tnn.SpatialConvolutionMap.full(3, 4),
             jnn.SpatialConvolutionMap.full(3, 4)),
            (tnn.SpatialConvolutionMap.one_to_one(5),
             jnn.SpatialConvolutionMap.one_to_one(5)),
            (tnn.SpatialConvolutionMap.random(6, 4, 3, seed=9),
             jnn.SpatialConvolutionMap.random(6, 4, 3, seed=9))):
        np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError, match="n_pairs, 2"):
        tnn.SpatialConvolutionMap(np.ones((3, 3), np.int64), 2, 2, **CPU)
