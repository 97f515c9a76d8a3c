"""The gradient of the port's flash attention (the ``FlashAttention``
autograd Function: the kernel's forward, here its plain version on the
CPU, and the blocked backward ``flash_attention_backward_reference``)
against ``jax.vjp`` of the JAX package's ``flash_attention`` (its Pallas
kernel in interpret mode with the ``_flash_bwd`` custom VJP; lengths that
do not tile into its 128-blocks take its dense fallback), and against
``flash_with_lse`` for the lse cotangent.

Tolerance: dq, dk, dv in f32 at rtol 2e-4 / atol 2e-5, the JAX flash
test's (sums in another order and over other blocks: the port's
backward takes 256 keys a block, the JAX one the forward's 128).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn import attention as jattn
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash
from bigdl_tpu.ops.flash_attention import flash_with_lse as jax_flash_lse
from bigdl_tpu.utils import random as bt_random
from bigdl_tpu_torch.nn import MultiHeadAttention
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=2e-4, atol=2e-5)
B, H = 2, 4

# (t, tk, d, causal, group)
CASES = [
    (128, 128, 32, True, 1),
    (128, 128, 32, False, 1),
    (128, 128, 16, True, 4),      # GQA: dk, dv summed over the group
    (128, 128, 16, False, 2),
    (128, 256, 16, True, 2),      # t < tk: kv_offset > 0
    (256, 128, 16, True, 1),      # t > tk causal: dead rows
    (100, 100, 16, True, 2),      # does not tile: JAX dense fallback
    (300, 300, 16, True, 1),      # two port kv blocks, the second ragged
]


def _inputs(t, tk, d, group, seed=0):
    rng = np.random.RandomState(seed)
    h_kv = H // group
    return [rng.randn(*s).astype(np.float32)
            for s in ((B, H, t, d), (B, h_kv, tk, d), (B, h_kv, tk, d),
                      (B, H, t, d), (B, H, t))]


def _port_grads(q, k, v, g_out, g_lse, causal):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse(qt, kt, vt, causal)
    assert out.grad_fn is not None and lse.grad_fn is not None
    obj = (out * torch.from_numpy(g_out)).sum()
    if g_lse is not None:
        obj = obj + (lse * torch.from_numpy(g_lse)).sum()
    return [g.numpy() for g in torch.autograd.grad(obj, (qt, kt, vt))]


@pytest.mark.parametrize("t,tk,d,causal,group", CASES)
def test_flash_grads_match_jax(t, tk, d, causal, group):
    q, k, v, g_out, _ = _inputs(t, tk, d, group)

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g_out))
    got = _port_grads(q, k, v, g_out, None, causal)
    for name, ours, theirs in zip("qkv", got, want):
        np.testing.assert_allclose(ours, np.asarray(theirs), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("t,tk,d,causal,group", [c for c in CASES
                                                 if c[0] % 128 == 0
                                                 and c[1] % 128 == 0])
def test_lse_cotangent_matches_flash_with_lse(t, tk, d, causal, group):
    q, k, v, g_out, g_lse = _inputs(t, tk, d, group, seed=1)
    h_kv = H // group
    scale = 1.0 / math.sqrt(d)
    # the JAX building block takes (B*H, t, d) and returns lse (B*H, t, 1)
    flat = [jnp.asarray(q.reshape(B * H, t, d)),
            jnp.asarray(k.reshape(B * h_kv, tk, d)),
            jnp.asarray(v.reshape(B * h_kv, tk, d))]

    def f(q_, k_, v_):
        return jax_flash_lse(q_, k_, v_, causal, scale, 128, 128, True,
                             group)

    _, vjp = jax.vjp(f, *flat)
    dead = np.asarray(f(*flat)[1]).reshape(B, H, t) <= fa.NEG_INF / 2
    g_lse = np.where(dead, 0.0, g_lse).astype(np.float32)
    want = vjp((jnp.asarray(g_out.reshape(B * H, t, d)),
                jnp.asarray(g_lse.reshape(B * H, t, 1))))
    got = _port_grads(q, k, v, g_out, g_lse, causal)
    for name, ours, theirs, shape in zip("qkv", got, want,
                                         (q.shape, k.shape, v.shape)):
        np.testing.assert_allclose(ours, np.asarray(theirs).reshape(shape),
                                   **TOL, err_msg=f"d{name}")


def test_grads_through_strided_gqa_projection_match_jax():
    """MultiHeadAttention(use_flash=True) hands the Function strided
    views of its fused projection; the grads of the projection weights
    match the JAX layer's."""
    bt_random.set_seed(2)
    jm = jattn.MultiHeadAttention(64, 8, causal=True, use_flash=True,
                                  num_kv_heads=2)
    tm = MultiHeadAttention(64, 8, causal=True, use_flash=True,
                            num_kv_heads=2, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    x = np.random.RandomState(3).randn(2, 128, 64).astype(np.float32)
    w = np.random.RandomState(4).randn(2, 128, 64).astype(np.float32)

    def jloss(p):
        out, _ = pure_apply(jm)(p, {}, jnp.asarray(x))
        return jnp.sum(out * w)

    jg = jax.jit(jax.grad(jloss))(jm.params_dict())
    (tm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    for layer in ("qkv", "out_proj"):
        for name in ("weight", "bias"):
            np.testing.assert_allclose(
                getattr(getattr(tm, layer), name).grad.numpy(),
                np.asarray(jg[layer]["~params"][name]), **TOL,
                err_msg=f"{layer}.{name}")
