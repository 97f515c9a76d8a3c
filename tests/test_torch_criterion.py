"""The port's criterions (bigdl_tpu_torch/nn/criterion.py) against the
JAX package's (bigdl_tpu/nn/criterion.py): forward and the gradient in
the input, with 1-based targets, padding rows (target -1), class
weights, label smoothing and ``size_average=False``.

Tolerance: f32 at rtol 1e-5 / atol 1e-6 (the same sums in another
order); bf16 logits give a bf16 loss on both sides, compared at rtol
2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu_torch.nn import criterion as tcrit

N, C = 12, 7
TOL = dict(rtol=1e-5, atol=1e-6)


def _data(seed, padded):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, C).astype(np.float32)
    y = rs.randint(1, C + 1, N)          # 1-based classes
    y[0], y[-1] = 1, C                   # both ends of the label range
    if padded:
        y[[2, 5]] = -1                   # padding rows
    return x, y


def _weights():
    return np.linspace(0.5, 2.0, C).astype(np.float32)


# name -> (constructor kwargs, padded targets)
CASES = {
    "nll": ("ClassNLLCriterion", {}, False),
    "nll_padding": ("ClassNLLCriterion", {}, True),
    "nll_weights_sum": ("ClassNLLCriterion",
                        dict(weights=_weights(), size_average=False), True),
    "nll_probabilities": ("ClassNLLCriterion",
                          dict(log_prob_as_input=False), False),
    "ce": ("CrossEntropyCriterion", {}, False),
    "ce_weights_padding": ("CrossEntropyCriterion",
                           dict(weights=_weights()), True),
    "ce_smoothing": ("CrossEntropyCriterion",
                     dict(label_smoothing=0.1), True),
    "ce_smoothing_weights_sum": ("CrossEntropyCriterion",
                                 dict(weights=_weights(), size_average=False,
                                      label_smoothing=0.2), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_input_grad_match_jax(case):
    cls, kw, padded = CASES[case]
    x, y = _data(sorted(CASES).index(case), padded)
    if not kw.get("log_prob_as_input", True):
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    elif cls == "ClassNLLCriterion":
        x = np.array(jax.nn.log_softmax(jnp.asarray(x)))
    jc, tc = getattr(jcrit, cls)(**kw), getattr(tcrit, cls)(**kw)
    want = jc.forward(jnp.asarray(x), jnp.asarray(y))
    got = tc(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(
        tc.backward(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jc.backward(jnp.asarray(x), jnp.asarray(y))), **TOL)
    if padded:
        assert (tc.grad_input.numpy()[[2, 5]] == 0).all()


def test_bf16_logits_give_a_bf16_loss_as_in_jax():
    x, y = _data(0, True)
    want = jcrit.CrossEntropyCriterion().forward(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(y))
    got = tcrit.CrossEntropyCriterion()(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(y))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().item(), float(want), rtol=2e-2)


def test_label_smoothing_range_is_checked():
    with pytest.raises(ValueError, match="label_smoothing"):
        tcrit.CrossEntropyCriterion(label_smoothing=1.0)
