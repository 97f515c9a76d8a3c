"""The port's optimization methods and learning-rate schedules
(bigdl_tpu_torch/optim/optim_method.py) against the JAX package's
(bigdl_tpu/optim/optim_method.py): SGD (momentum, dampening, nesterov,
weight decay, a rate decay), Adam and AdamW updated three times on the
same parameters and gradients, and every ported schedule's ``rate``
sequence over neval / epoch / score.

Tolerance: parameters and slots in f32 at rtol 1e-6 / atol 1e-7 (the
same elementwise math; powers and square roots may round differently
in the last bit); rates to 1e-12 (the same double arithmetic).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu_torch.optim import optim_method as tom

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(3, 4), (5,), ()]

METHODS = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "sgd_momentum": ("SGD", dict(learning_rate=0.1, momentum=0.9)),
    "sgd_dampening_wd": ("SGD", dict(learning_rate=0.05, momentum=0.5,
                                     dampening=0.2, weight_decay=0.01)),
    "sgd_nesterov": ("SGD", dict(learning_rate=0.1, momentum=0.9,
                                 dampening=0.0, nesterov=True,
                                 learning_rate_decay=0.1)),
    "adam": ("Adam", dict(learning_rate=0.01)),
    "adam_wd": ("Adam", dict(learning_rate=0.01, weight_decay=0.1,
                             beta1=0.8, beta2=0.99)),
    "adamw": ("AdamW", dict(learning_rate=0.01, weight_decay=0.1)),
}


def _trees(seed):
    rs = np.random.RandomState(seed)
    return [np.asarray(rs.randn(*s), np.float32) for s in SHAPES]


@pytest.mark.parametrize("case", sorted(METHODS))
def test_updates_match_jax(case):
    cls, kw = METHODS[case]
    jm, tm = getattr(jom, cls)(**kw), getattr(tom, cls)(**kw)
    params = _trees(0)
    jp = [jnp.asarray(a) for a in params]
    tp = [torch.from_numpy(a) for a in params]
    js, ts = jm.init_slots(jp), tm.init_slots(tp)
    for i in range(3):
        grads = _trees(i + 1)
        lr_j, lr_t = jm.get_current_rate(), tm.get_current_rate()
        assert lr_t == lr_j
        jp, js = jm.step(jp, [jnp.asarray(g) for g in grads], js,
                         jnp.float32(lr_j))
        tp, ts = tm.step(tp, [torch.from_numpy(g) for g in grads], ts,
                         torch.tensor(lr_t, dtype=torch.float32))
        for m in (jm, tm):
            m.state["neval"] += 1
    for ours, theirs in zip(tp, jp):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    flat_j = jax.tree.leaves(js)
    flat_t = [x for v in (ts[k] for k in sorted(ts))
              for x in (v if isinstance(v, list) else [v])]
    assert len(flat_t) == len(flat_j)
    for ours, theirs in zip(flat_t, flat_j):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_sgd_dampening_defaults_to_momentum_and_nesterov_is_checked():
    assert tom.SGD(momentum=0.9).dampening == 0.9
    with pytest.raises(ValueError, match="nesterov"):
        tom.SGD(momentum=0.9, nesterov=True)


def _schedules(m):
    return {
        "default": (m.Default(), dict(learning_rate_decay=0.3)),
        "poly": (m.Poly(0.5, 8), {}),
        "step": (m.Step(3, 0.5), {}),
        "multistep": (m.MultiStep([2, 5, 9], 0.1), {}),
        "epochstep": (m.EpochStep(2, 0.5), {}),
        "exponential": (m.Exponential(4, 0.5), {}),
        "exponential_staircase": (m.Exponential(4, 0.5, staircase=True),
                                  {}),
        "warmup": (m.Warmup(0.05), {}),
        "sequential": (m.SequentialSchedule(3).add(m.Warmup(0.1), 4)
                       .add(m.CosineDecay(6, peak_lr=0.5), 6)
                       .add(m.Step(2, 0.5), 1), {}),
        "epochschedule": (m.EpochSchedule([(1, 2, 0.3), (3, 4, 0.03)]), {}),
        "cosine": (m.CosineDecay(10, min_lr=0.01), {}),
        "naturalexp": (m.NaturalExp(3, 0.2), {}),
        "plateau": (m.Plateau(patience=2, factor=0.5, cooldown=1,
                              min_lr=0.01), {}),
    }


@pytest.mark.parametrize("case", sorted(_schedules(tom)))
def test_schedule_rates_match_jax(case):
    rates = []
    for m in (jom, tom):
        sched, kw = _schedules(m)[case]
        meth = m.SGD(learning_rate=0.2, learning_rate_schedule=sched, **kw)
        seq = []
        for n in range(1, 17):
            # one epoch every 3 iterations, a score that stalls
            meth.update_state(neval=n, epoch=(n - 1) // 3 + 1,
                              score=max(1.0, 4.0 - n * 0.5))
            seq.append(meth.get_current_rate())
        rates.append(seq)
    np.testing.assert_allclose(rates[1], rates[0], rtol=0, atol=1e-12)
    assert len(set(rates[1])) > 1
    assert all(math.isfinite(r) for r in rates[1])
