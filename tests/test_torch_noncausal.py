"""The non-causal TransformerLM (``causal=False``) of the port against
the JAX package's on the same weights: the full-sequence forward
attends every position (flash on: the port runs its kernel's plain
version with ``causal=False``; flash off: the dense path), and the
KV-cache entry points stay causal, as JAX's prefill passes
``causal=True`` (``bigdl_tpu/nn/attention.py:417``): their logits equal
JAX's and the causal model's.

Tolerance: f32 logits at rtol 2e-4 / atol 2e-5 (the JAX flash test's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import transformer as jtr
from bigdl_tpu_torch.models import transformer as ttr
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=2e-4, atol=2e-5)
CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2,
           max_len=64, num_kv_heads=2)


def _pair(use_flash, use_rope, causal=False):
    from bigdl_tpu.utils import random as bt_random

    bt_random.set_seed(13)
    jm = jtr.TransformerLM(**CFG, use_flash=use_flash, use_rope=use_rope,
                           causal=causal)
    jm.evaluate()
    tm = ttr.TransformerLM(**CFG, use_flash=use_flash, use_rope=use_rope,
                           causal=causal, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.evaluate()
    return jm, tm


def _ids(b=2, t=20, seed=0):
    return np.random.RandomState(seed).randint(0, 64, (b, t)).astype(np.int32)


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "learned"])
@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_noncausal_forward_matches_jax(use_flash, use_rope):
    jm, tm = _pair(use_flash, use_rope)
    ids = _ids()
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, causal=False, **kw):
        calls.append(causal)
        return real(q, k, v, causal=causal, **kw)

    fa.flash_attention = spy
    try:
        with torch.no_grad():
            out = tm(torch.from_numpy(ids))
    finally:
        fa.flash_attention = real
    np.testing.assert_allclose(out.numpy(), np.asarray(jm(jnp.asarray(ids))),
                               **TOL)
    assert calls == ([False] * CFG["num_layers"] if use_flash else [])
    # the first position sees the last: changing the last token moves it
    ids2 = ids.copy()
    ids2[:, -1] = (ids2[:, -1] + 1) % 64
    with torch.no_grad():
        out2 = tm(torch.from_numpy(ids2))
    assert not torch.allclose(out[:, 0], out2[:, 0])


def test_kv_cache_paths_stay_causal_as_in_jax():
    """Prefill and decode of the non-causal model equal JAX's and the
    causal model's on the same weights."""
    jm, tm = _pair(True, True)
    _, tc = _pair(True, True, causal=True)
    ids = _ids(2, 10, seed=1)
    cj, ct, cc = jm.init_cache(2, 16), tm.init_cache(2, 16), \
        tc.init_cache(2, 16)
    lj, cj = jm.prefill(jnp.asarray(ids[:, :8]), cj)
    lt, ct = tm.prefill(ids[:, :8], ct)
    lc, cc = tc.prefill(ids[:, :8], cc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert torch.equal(lt, lc)
    lj, _ = jm.decode_step(jnp.asarray(ids[:, 8]), 8, cj)
    lt, _ = tm.decode_step(ids[:, 8], 8, ct)
    lc, _ = tc.decode_step(ids[:, 8], 8, cc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert torch.equal(lt, lc)
    np.testing.assert_array_equal(
        tm.generate(ids[:, :8], 4).numpy(),
        np.asarray(jm.generate(jnp.asarray(ids[:, :8]), 4)))
