"""The port's attention layers (bigdl_tpu_torch/nn/attention.py) against
the JAX package's (bigdl_tpu/nn/attention.py) on the same weights, carried
across by bigdl_tpu_torch.utils.weights.load_jax_params.

Tolerance: f32 at rtol 2e-4 / atol 2e-5 (the JAX flash test's): both
sides compute the same f32 math with sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch.nn import attention as tatt
from bigdl_tpu_torch.utils.weights import jax_param_names, load_jax_params

TOL = dict(rtol=2e-4, atol=2e-5)
C, HEADS, KV = 32, 4, 2


def _np_tree(module):
    return jax.tree.map(np.asarray, module.params_dict())


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(port, ref, **kw):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(kw or TOL))


def test_layer_norm_matches_and_casts_before_affine():
    ln_j = jnn.LayerNorm(16)
    tree = {"~params": {"weight": _rand(16, seed=1),
                        "bias": _rand(16, seed=2)}}
    ln_j.load_params_dict(jax.tree.map(jnp.asarray, tree))
    ln_t = tatt.LayerNorm(16, device="cpu")
    load_jax_params(ln_t, tree)
    x = _rand(3, 5, 16) * 3 + 1
    _close(ln_t(torch.from_numpy(x)), ln_j(jnp.asarray(x)))
    # bf16: normalized in f32, cast to bf16, THEN the affine in bf16
    ln_t = ln_t.to(torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = ln_t(xb)
    assert y.dtype == torch.bfloat16
    xf = xb.float()
    norm = ((xf - xf.mean(-1, keepdim=True))
            * torch.rsqrt(xf.var(-1, unbiased=False, keepdim=True) + 1e-5))
    expect = norm.to(torch.bfloat16) * ln_t.weight + ln_t.bias
    assert torch.equal(y, expect)


@pytest.mark.parametrize("rowwise", [None, "step", "chunk"])
def test_rotary_embedding_rotates_interleaved_pairs(rowwise):
    x = _rand(2, 3, 6, 8)
    if rowwise is None:
        pos = np.arange(6) + 5
        ref = jnn.attention.rotary_embedding(jnp.asarray(x), jnp.asarray(pos))
        out = tatt.rotary_embedding(torch.from_numpy(x), torch.tensor(pos))
    else:
        pos = (np.array([3, 17]) if rowwise == "step"
               else np.array([[0, 1, 2, 3, 4, 5], [9, 10, 11, 12, 13, 14]]))
        if rowwise == "step":
            x = x[:, :, :1]
        ref = jnn.attention.rotary_embedding_rowwise(jnp.asarray(x),
                                                     jnp.asarray(pos))
        out = tatt.rotary_embedding_rowwise(torch.from_numpy(x),
                                            torch.tensor(pos))
    _close(out, ref)
    # the half-split rotate_half convention gives a different answer
    if rowwise is None:
        half = np.concatenate([-x[..., 4:], x[..., :4]], -1)
        assert not np.allclose(np.asarray(ref), half, atol=1e-3)


@pytest.mark.parametrize("tq,tk,causal", [
    (8, 8, True), (4, 10, True), (10, 4, True), (6, 6, False),
    (4, 10, False)])
def test_dot_product_attention_matches(tq, tk, causal):
    q, k, v = _rand(2, 3, tq, 8, seed=1), _rand(2, 3, tk, 8, seed=2), \
        _rand(2, 3, tk, 8, seed=3)
    ref = jnn.attention.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal)
    out = tatt.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    _close(out, ref)
    assert torch.isfinite(out).all()
    if causal and tq > tk:
        assert (out[:, :, :tq - tk] == 0).all()     # dead rows give 0


def _mha_pair(rotary=True, use_flash=False, causal=True):
    mj = jnn.MultiHeadAttention(C, HEADS, causal=causal, num_kv_heads=KV,
                                rotary=rotary, use_flash=use_flash)
    mt = tatt.MultiHeadAttention(C, HEADS, causal=causal, num_kv_heads=KV,
                                 rotary=rotary, use_flash=use_flash,
                                 device="cpu")
    load_jax_params(mt, _np_tree(mj))
    return mj, mt


@pytest.mark.parametrize("use_flash,rotary,t", [
    (True, True, 128), (False, True, 24), (True, False, 24),
    (False, False, 24)])
def test_mha_forward_matches(use_flash, rotary, t):
    mj, mt = _mha_pair(rotary, use_flash)
    x = _rand(2, t, C, seed=5)
    with torch.no_grad():
        _close(mt(torch.from_numpy(x)), mj(jnp.asarray(x)))


def test_mha_prefill_continuation_matches():
    mj, mt = _mha_pair()
    x = _rand(2, 12, C, seed=6)
    cj = mj.init_cache(2, 16)
    ct = mt.init_cache(2, 16)
    oj, cj = mj.forward_prefill(jnp.asarray(x[:, :8]), cj, 0)
    ot, ct = mt.forward_prefill(torch.from_numpy(x[:, :8]), ct, 0)
    _close(ot, oj)
    oj, cj = mj.forward_prefill(jnp.asarray(x[:, 8:]), cj, 8)
    ot, ct = mt.forward_prefill(torch.from_numpy(x[:, 8:]), ct, 8)
    _close(ot, oj)
    for a, b in zip(ct, cj):
        _close(a, b)
    with pytest.raises(ValueError, match="overflows"):
        mt.forward_prefill(torch.from_numpy(x[:, 8:]), ct, 14)


@pytest.mark.parametrize("ragged", [False, True])
def test_mha_forward_step_matches(ragged):
    mj, mt = _mha_pair()
    x = _rand(2, 10, C, seed=7)
    cj = mj.init_cache(2, 12)
    ct = mt.init_cache(2, 12)
    _, cj = mj.forward_prefill(jnp.asarray(x[:, :9]), cj, 0)
    _, ct = mt.forward_prefill(torch.from_numpy(x[:, :9]), ct, 0)
    x_t = x[:, 9:10]
    if ragged:   # rows at different depths
        pos_j, pos_t = jnp.asarray([9, 4]), torch.tensor([9, 4])
    else:
        pos_j, pos_t = 9, 9
    oj, cj = mj.forward_step(jnp.asarray(x_t), cj, pos_j)
    ot, ct = mt.forward_step(torch.from_numpy(x_t), ct, pos_t)
    _close(ot, oj)
    for a, b in zip(ct, cj):
        _close(a, b)


@pytest.mark.parametrize("ragged", [False, True])
def test_mha_forward_chunk_matches(ragged):
    mj, mt = _mha_pair()
    x = _rand(2, 12, C, seed=8)
    cj = mj.init_cache(2, 16)
    ct = mt.init_cache(2, 16)
    _, cj = mj.forward_prefill(jnp.asarray(x[:, :8]), cj, 0)
    _, ct = mt.forward_prefill(torch.from_numpy(x[:, :8]), ct, 0)
    if ragged:
        pos_j, pos_t = jnp.asarray([8, 3]), torch.tensor([8, 3])
    else:
        pos_j, pos_t = 8, 8
    oj, cj = mj.forward_chunk(jnp.asarray(x[:, 8:]), cj, pos_j)
    ot, ct = mt.forward_chunk(torch.from_numpy(x[:, 8:]), ct, pos_t)
    _close(ot, oj)
    for a, b in zip(ct, cj):
        _close(a, b)


def test_transformer_block_matches_with_tanh_gelu():
    bj = jnn.TransformerBlock(C, HEADS, num_kv_heads=KV, rotary=True)
    bt = tatt.TransformerBlock(C, HEADS, num_kv_heads=KV, rotary=True,
                               device="cpu")
    load_jax_params(bt, _np_tree(bj))
    x = _rand(2, 9, C, seed=9)
    with torch.no_grad():
        _close(bt(torch.from_numpy(x)), bj(jnp.asarray(x)))
    # jax.nn.gelu defaults to the tanh form; PyTorch's default is erf
    h = _rand(64, seed=10) * 3
    ref = np.asarray(jax.nn.gelu(jnp.asarray(h)))
    _close(F.gelu(torch.from_numpy(h), approximate="tanh"), ref)
    assert not np.allclose(F.gelu(torch.from_numpy(h)).numpy(), ref,
                           **TOL)


def test_weight_bridge_maps_every_key_and_refuses_mismatches():
    mj, mt = _mha_pair()
    names = dict(jax_param_names(mt))
    assert names == {"out_proj/~params/bias": "out_proj.bias",
                     "out_proj/~params/weight": "out_proj.weight",
                     "qkv/~params/bias": "qkv.bias",
                     "qkv/~params/weight": "qkv.weight"}
    tree = _np_tree(mj)
    tree["qkv"]["~params"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(mt, tree)
    tree = _np_tree(mj)
    del tree["out_proj"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(mt, tree)
    tree = _np_tree(mj)
    tree["qkv"]["~params"]["weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(mt, tree)
