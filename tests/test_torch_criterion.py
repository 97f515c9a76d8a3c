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


# ------------------------------------------------ every criterion
from bigdl_tpu import nn as jnn                                 # noqa: E402
from bigdl_tpu.utils.table import Table as JTable               # noqa: E402
from bigdl_tpu_torch import nn as tnn                           # noqa: E402
from bigdl_tpu_torch.utils.table import Table as TTable         # noqa: E402

R, K = 6, 5   # rows, classes


def _probs(rs, *shape):
    e = np.exp(rs.randn(*shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _logp(rs, *shape):
    return np.log(_probs(rs, *shape)).astype(np.float32)


def _f(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _sign(rs, *shape):
    return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _labels(rs, *shape):
    return rs.randint(1, K + 1, shape).astype(np.float32)


def _multilabel(rs):
    t = np.zeros((R, K), np.float32)
    for i in range(R):
        n = 1 + i % 3
        t[i, :n] = rs.permutation(K)[:n] + 1
    return t


def _tmask_target(rs):
    t = _labels(rs, R, 4)
    t[:, -1] = 0
    t[0, 1] = 0
    return t


class _T:
    """A Table marker for the case builders: the same entries become a
    JAX Table on one side and the port's on the other."""

    def __init__(self, *vals):
        self.vals = vals


def _both(v):
    """(JAX value, port value) of a case's input or target."""
    if isinstance(v, _T):
        pairs = [_both(x) for x in v.vals]
        return JTable(*[p[0] for p in pairs]), TTable(*[p[1] for p in pairs])
    if isinstance(v, np.ndarray):
        return jnp.asarray(v), torch.from_numpy(v.copy())
    return v, v


# name -> (build(criterion module, nn module), data(rs) -> (input, target))
ALL = {
    "ClassNLL": (lambda c, n: c.ClassNLLCriterion(),
                 lambda rs: (_logp(rs, R, K), _labels(rs, R))),
    "CrossEntropy": (lambda c, n: c.CrossEntropyCriterion(),
                     lambda rs: (_f(rs, R, K), _labels(rs, R))),
    "CategoricalCrossEntropy": (
        lambda c, n: c.CategoricalCrossEntropy(),
        lambda rs: (_probs(rs, R, K),
                    np.eye(K, dtype=np.float32)[rs.randint(0, K, R)])),
    "MSE": (lambda c, n: c.MSECriterion(),
            lambda rs: (_f(rs, R, K), _f(rs, R, K))),
    "MSE_sum": (lambda c, n: c.MSECriterion(size_average=False),
                lambda rs: (_f(rs, R, K), _f(rs, R, K))),
    "Abs": (lambda c, n: c.AbsCriterion(),
            lambda rs: (_f(rs, R, K), _f(rs, R, K))),
    "BCE": (lambda c, n: c.BCECriterion(
                weights=np.linspace(0.5, 1.5, K).astype(np.float32)),
            lambda rs: (1 / (1 + np.exp(-_f(rs, R, K))),
                        (rs.rand(R, K) > 0.5).astype(np.float32))),
    "SmoothL1": (lambda c, n: c.SmoothL1Criterion(),
                 lambda rs: (2 * _f(rs, R, K), _f(rs, R, K))),
    "DistKLDiv": (lambda c, n: c.DistKLDivCriterion(),
                  lambda rs: (_logp(rs, R, K),
                              _probs(rs, R, K) * (rs.rand(R, K) > 0.3))),
    "KLD": (lambda c, n: c.KLDCriterion(),
            lambda rs: (_T(_f(rs, R, K), 0.5 * _f(rs, R, K)), None)),
    "Gaussian": (lambda c, n: c.GaussianCriterion(),
                 lambda rs: (_T(_f(rs, R, K), 0.5 * _f(rs, R, K)),
                             _f(rs, R, K))),
    "Margin": (lambda c, n: c.MarginCriterion(),
               lambda rs: (_f(rs, R, K), _sign(rs, R, K))),
    "Margin_squared": (lambda c, n: c.MarginCriterion(squared=True),
                       lambda rs: (_f(rs, R, K), _sign(rs, R, K))),
    "HingeEmbedding": (lambda c, n: c.HingeEmbeddingCriterion(),
                       lambda rs: (_f(rs, R, K), _sign(rs, R, K))),
    "L1HingeEmbedding": (lambda c, n: c.L1HingeEmbeddingCriterion(20.0),
                         lambda rs: (_T(_f(rs, K), _f(rs, K)),
                                     np.float32(-1.0))),
    "CosineEmbedding": (lambda c, n: c.CosineEmbeddingCriterion(0.1),
                        lambda rs: (_T(_f(rs, R, K), _f(rs, R, K)),
                                    _sign(rs, R))),
    "MarginRanking": (lambda c, n: c.MarginRankingCriterion(),
                      lambda rs: (_T(_f(rs, R), _f(rs, R)), _sign(rs, R))),
    "MultiMargin": (lambda c, n: c.MultiMarginCriterion(),
                    lambda rs: (_f(rs, R, K), _labels(rs, R))),
    "MultiMargin_p2_weights": (
        lambda c, n: c.MultiMarginCriterion(
            p=2, weights=np.linspace(0.5, 2, K).astype(np.float32)),
        lambda rs: (_f(rs, R, K), _labels(rs, R))),
    "MultiLabelMargin": (lambda c, n: c.MultiLabelMarginCriterion(),
                         lambda rs: (_f(rs, R, K), _multilabel(rs))),
    "MultiLabelSoftMargin": (lambda c, n: c.MultiLabelSoftMarginCriterion(),
                             lambda rs: (_f(rs, R, K),
                                         (rs.rand(R, K) > 0.5)
                                         .astype(np.float32))),
    "SoftMargin": (lambda c, n: c.SoftMarginCriterion(),
                   lambda rs: (_f(rs, R, K), _sign(rs, R, K))),
    "L1Cost": (lambda c, n: c.L1Cost(), lambda rs: (_f(rs, R, K), None)),
    "DotProduct": (lambda c, n: c.DotProductCriterion(size_average=True),
                   lambda rs: (_f(rs, R, K), _f(rs, R, K))),
    "CosineDistance": (lambda c, n: c.CosineDistanceCriterion(),
                       lambda rs: (_f(rs, R, K), _f(rs, R, K))),
    "CosineProximity": (lambda c, n: c.CosineProximityCriterion(),
                        lambda rs: (_f(rs, R, K), _f(rs, R, K))),
    "Poisson": (lambda c, n: c.PoissonCriterion(),
                lambda rs: (np.exp(_f(rs, R, K)), np.exp(_f(rs, R, K)))),
    "MeanAbsolutePercentage": (
        lambda c, n: c.MeanAbsolutePercentageCriterion(),
        lambda rs: (_f(rs, R, K), _f(rs, R, K))),
    "MeanSquaredLogarithmic": (
        lambda c, n: c.MeanSquaredLogarithmicCriterion(),
        lambda rs: (np.exp(_f(rs, R, K)), np.exp(_f(rs, R, K)))),
    "KullbackLeiblerDivergence": (
        lambda c, n: c.KullbackLeiblerDivergenceCriterion(),
        lambda rs: (_probs(rs, R, K), _probs(rs, R, K))),
    "DiceCoefficient": (lambda c, n: c.DiceCoefficientCriterion(),
                        lambda rs: (1 / (1 + np.exp(-_f(rs, R, 2, 3))),
                                    (rs.rand(R, 2, 3) > 0.5)
                                    .astype(np.float32))),
    "ClassSimplex": (lambda c, n: c.ClassSimplexCriterion(K),
                     lambda rs: (_f(rs, R, K), _labels(rs, R))),
    "Parallel": (lambda c, n: c.ParallelCriterion().add(c.MSECriterion(), 0.5)
                 .add(c.AbsCriterion(), 2.0),
                 lambda rs: (_T(_f(rs, R, K), _f(rs, R)),
                             _T(_f(rs, R, K), _f(rs, R)))),
    "Multi": (lambda c, n: c.MultiCriterion().add(c.MSECriterion())
              .add(c.SmoothL1Criterion(), 0.3),
              lambda rs: (_f(rs, R, K), _f(rs, R, K))),
    "TimeDistributed": (lambda c, n: c.TimeDistributedCriterion(
                            c.MSECriterion(), size_average=True),
                        lambda rs: (_f(rs, R, 3, K), _f(rs, R, 3, K))),
    "PG": (lambda c, n: c.PGCriterion(),
           lambda rs: (_probs(rs, R, K), _f(rs, R, K))),
    "ActivityRegularization": (
        lambda c, n: c.ActivityRegularization(l1=0.1, l2=0.2),
        lambda rs: (_f(rs, R, K), None)),
    "SmoothL1WithWeights": (
        lambda c, n: c.SmoothL1CriterionWithWeights(sigma=2.0, num=3),
        lambda rs: (_f(rs, R, K), _T(_f(rs, R, K), rs.rand(R, K)
                                     .astype(np.float32),
                                     rs.rand(R, K).astype(np.float32)))),
    "SoftmaxWith_valid": (
        lambda c, n: c.SoftmaxWithCriterion(ignore_label=2),
        lambda rs: (_f(rs, 2, K, 3, 4), _labels(rs, 2, 3, 4))),
    "SoftmaxWith_full": (
        lambda c, n: c.SoftmaxWithCriterion(normalize_mode="FULL"),
        lambda rs: (_f(rs, 2, K, 3, 4), _labels(rs, 2, 1, 3, 4))),
    "TimeDistributedMask_nll": (
        lambda c, n: c.TimeDistributedMaskCriterion(c.ClassNLLCriterion()),
        lambda rs: (_logp(rs, R, 4, K), _tmask_target(rs))),
    "TimeDistributedMask_mse": (
        lambda c, n: c.TimeDistributedMaskCriterion(c.MSECriterion()),
        lambda rs: (_f(rs, R, 4), _tmask_target(rs))),
    "Transformer": (lambda c, n: c.TransformerCriterion(
                        c.MSECriterion(), n.Tanh(), n.Tanh()),
                    lambda rs: (_f(rs, R, K), _f(rs, R, K))),
}


def _leaves(v):
    return list(v.values()) if isinstance(v, (JTable, TTable)) else [v]


def test_every_criterion_class_has_a_case():
    names = {n for n in dir(tcrit) if isinstance(getattr(tcrit, n), type)
             and issubclass(getattr(tcrit, n), tcrit.Criterion)
             and n != "Criterion"}
    built = {type(build(tcrit, tnn)).__name__ for build, _ in ALL.values()}
    assert len(names) == 38 and built == names, sorted(names - built)


@pytest.mark.parametrize("case", sorted(ALL))
def test_every_criterion_matches_jax(case):
    """Value and input gradient of each criterion against the JAX one on
    the same inputs, f32, at TOL."""
    build, data = ALL[case]
    x, t = data(np.random.RandomState(sorted(ALL).index(case)))
    (jx, tx), (jt, tt) = _both(x), _both(t)
    jc, tc = build(jcrit, jnn), build(tcrit, tnn)
    want, got = jc.forward(jx, jt), tc(tx, tt)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    for g, w in zip(_leaves(tc.backward(tx, tt)),
                    _leaves(jc.backward(jx, jt))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
