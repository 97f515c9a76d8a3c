"""The port's flash attention (bigdl_tpu_torch/ops/flash_attention.py)
against the JAX package's (bigdl_tpu/ops/flash_attention.py).

On the CPU the port's wrappers run the kernel's plain PyTorch version and
the JAX side runs its Pallas kernel in interpret mode, as
tests/test_flash_attention.py does. Lengths that do not tile into the
JAX kernel's 128-blocks take the JAX wrapper's dense fallback there; the
port handles every length in the same function.

Tolerances: f32 at rtol 2e-4 / atol 2e-5, the JAX flash test's (sums in
another order); bf16 at 2e-2 (outputs rounded to 8 mantissa bits).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash
from bigdl_tpu.ops.flash_attention import flash_with_lse as jax_flash_lse
from bigdl_tpu_torch.ops import flash_attention as fa

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, H = 2, 4

# (t, tk, d, causal, group, dtype)
CASES = [
    (128, 128, 64, True, 1, "f32"),
    (128, 128, 32, True, 4, "f32"),
    (128, 128, 64, False, 4, "f32"),
    (128, 128, 32, False, 1, "f32"),
    (128, 256, 32, True, 4, "f32"),     # t < tk: kv_offset > 0
    (128, 256, 64, False, 1, "f32"),
    (256, 128, 32, True, 1, "f32"),     # t > tk causal: dead rows
    (256, 128, 64, True, 4, "f32"),
    (100, 100, 32, True, 4, "f32"),     # does not tile: JAX dense fallback
    (100, 100, 64, False, 1, "f32"),
    (128, 128, 64, True, 4, "bf16"),
    (256, 128, 32, True, 1, "bf16"),
]


def _inputs(t, tk, d, group, dtype, seed=0):
    rng = np.random.RandomState(seed)
    h_kv = H // group
    arrs = [rng.randn(*s).astype(np.float32)
            for s in ((B, H, t, d), (B, h_kv, tk, d), (B, h_kv, tk, d))]
    if dtype == "bf16":
        return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrs],
                [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _dense_lse(q, k, d, causal, group):
    """float64 logsumexp of the masked scores (the lse the JAX package's
    dense fallback does not return)."""
    k = np.repeat(k.astype(np.float64), group, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / math.sqrt(d)
    t, tk = s.shape[-2:]
    if causal:
        s = np.where(np.tril(np.ones((t, tk), bool), k=tk - t), s, -np.inf)
    mx = s.max(-1, keepdims=True)
    return (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("t,tk,d,causal,group,dtype", CASES)
def test_flash_matches_jax(t, tk, d, causal, group, dtype):
    (jq, jk, jv), (tq, tk_, tv) = _inputs(t, tk, d, group, dtype)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(tq, tk_, tv, causal=causal)
    assert fa.launches == before  # CPU tensors take the plain version
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert out.shape == (B, H, t, d) and lse.shape == (B, H, t)
    np.testing.assert_allclose(
        _np(fa.flash_attention(tq, tk_, tv, causal=causal)), _np(out))
    ref = jax_flash(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    if t % 128 == 0 and tk % 128 == 0:
        scale = 1.0 / math.sqrt(d)
        j_out, j_lse = jax_flash_lse(
            jq.reshape(B * H, t, d), jk.reshape(-1, tk, d),
            jv.reshape(-1, tk, d), causal, scale, 128, 128, True, group)
        np.testing.assert_allclose(_np(out).reshape(B * H, t, d),
                                   _np(j_out), **tol)
        np.testing.assert_allclose(_np(lse).reshape(B * H, t),
                                   np.asarray(j_lse)[..., 0], **F32_TOL)
    else:
        np.testing.assert_allclose(
            _np(lse), _dense_lse(_np(jq), _np(jk), d, causal, group),
            **F32_TOL)
    if causal and t > tk:
        # rows that see no key: 0 out and lse -1e30, like the JAX kernel
        dead = t - tk
        assert (out[:, :, :dead] == 0).all()
        assert (lse[:, :, :dead] == fa.NEG_INF).all()
        assert (lse[:, :, dead:] > fa.NEG_INF / 2).all()


@pytest.mark.parametrize("bad", ["dtype", "mixed", "head_dim", "rank",
                                 "heads", "cuda_entry"])
def test_flash_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 8, 32)
    k = v = torch.zeros(1, 2, 8, 32)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 2, 8, 160) for _ in range(3))
    elif bad == "rank":
        q = q[0]
    elif bad == "heads":
        k = v = torch.zeros(1, 3, 8, 32)
    if bad == "cuda_entry":
        # the kernel's own entry refuses CPU tensors instead of running
        with pytest.raises(ValueError, match="CUDA tensors"):
            fa._launch(q, k, v, True, 1.0)
        return
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v)
