"""The port's optimization methods and learning-rate schedules
(bigdl_tpu_torch/optim/optim_method.py) against the JAX package's
(bigdl_tpu/optim/optim_method.py): SGD (momentum, dampening, nesterov,
weight decay, a rate decay), Adam and AdamW updated three times on the
same parameters and gradients; Adagrad, Adadelta, Adamax, RMSprop, Ftrl
and ParallelAdam over ten steps; every method's flat ``optimize(feval,
x)`` and LBFGS on the same quadratic; ``save`` / ``load`` /
``clear_history``; and every ported schedule's ``rate`` sequence over
neval / epoch / score.

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
        "epochdecay": (m.EpochDecay(lambda e: (e - 1) // 2), {}),
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


NEW_METHODS = {
    "adagrad": ("Adagrad", dict(learning_rate=0.1, weight_decay=0.01,
                                learning_rate_decay=0.05)),
    "adadelta": ("Adadelta", dict(decay_rate=0.8, epsilon=1e-6)),
    "adamax": ("Adamax", dict(learning_rate=0.02)),
    "rmsprop": ("RMSprop", dict(learning_rate=0.01,
                                learning_rate_decay=0.1)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1,
                          l2_regularization_strength=0.01,
                          l2_shrinkage_regularization_strength=0.02)),
    "ftrl_l1": ("Ftrl", dict(learning_rate=0.1, learning_rate_power=-0.6,
                             l1_regularization_strength=0.05)),
    "parallel_adam": ("ParallelAdam", dict(learning_rate=0.01)),
}
# ten steps compound the last-bit differences of sqrt and pow
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)


def _slot_leaves(slots):
    return [x for k in sorted(slots)
            for x in (slots[k] if isinstance(slots[k], list)
                      else [slots[k]])]


@pytest.mark.parametrize("case", sorted(NEW_METHODS))
def test_ten_step_trajectory_matches_jax(case):
    """Each new method from the same parameters, fed the same gradients
    for ten steps: the parameters after every step and the slots at the
    end agree."""
    cls, kw = NEW_METHODS[case]
    jm, tm = getattr(jom, cls)(**kw), getattr(tom, cls)(**kw)
    params = _trees(0)
    jp = [jnp.asarray(a) for a in params]
    tp = [torch.from_numpy(a) for a in params]
    js, ts = jm.init_slots(jp), tm.init_slots(tp)
    for i in range(10):
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
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       **TRAJ_TOL)
    flat_j, flat_t = jax.tree.leaves(js), _slot_leaves(ts)
    assert len(flat_t) == len(flat_j)
    for ours, theirs in zip(flat_t, flat_j):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   **TRAJ_TOL)


_A = np.array([[3.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 1.0]],
              np.float32)
_B = np.array([1.0, -2.0, 0.5], np.float32)


def _feval(xp):
    """f(x) = x'Ax / 2 - b'x and its gradient, in either framework."""
    a, b = xp.asarray(_A), xp.asarray(_B)

    def f(x):
        g = a @ x - b
        return 0.5 * (x @ (a @ x)) - b @ x, g

    return f


@pytest.mark.parametrize("case", sorted(METHODS) + sorted(NEW_METHODS)
                         + ["lbfgs"])
def test_flat_optimize_matches_jax(case):
    """The flat API: five ``optimize(feval, x)`` calls (one for LBFGS,
    which iterates inside) on the same quadratic; the iterates, the
    losses and ``neval`` agree."""
    cls, kw = (("LBFGS", dict(max_iter=15, learning_rate=0.5))
               if case == "lbfgs" else {**METHODS, **NEW_METHODS}[case])
    jm, tm = getattr(jom, cls)(**kw), getattr(tom, cls)(**kw)
    jx = jnp.zeros(3, jnp.float32)
    tx = torch.zeros(3)
    for _ in range(1 if case == "lbfgs" else 5):
        jx, jl = jm.optimize(_feval(jnp), jx)
        tx, tl = tm.optimize(_feval(torch), tx)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-6)
    assert tm.state["neval"] == jm.state["neval"]
    if case == "lbfgs":   # near the minimizer when the loss change fell
        # under tolerance_fun (1e-5)
        np.testing.assert_allclose(tx.numpy(), np.linalg.solve(_A, _B),
                                   rtol=1e-2, atol=1e-2)
        assert len(tl) > 2 and tl[-1] < tl[0]


def test_save_load_and_clear_history(tmp_path):
    """``save`` pickles the method with its flat slots on the host;
    ``load`` gives an equal method that continues the same trajectory;
    ``clear_history`` resets the state table and drops the slots."""
    m = tom.RMSprop(learning_rate=0.05)
    x = torch.zeros(3)
    for _ in range(3):
        x, _ = m.optimize(_feval(torch), x)
    path = str(tmp_path / "method.pkl")
    m.save(path)
    with pytest.raises(FileExistsError):
        m.save(path)
    m.save(path, overwrite=True)
    back = tom.OptimMethod.load(path)
    assert type(back) is tom.RMSprop and back.state == m.state
    for a, b in zip(_slot_leaves(back._flat_slots),
                    _slot_leaves(m._flat_slots)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    x1, l1 = m.optimize(_feval(torch), x)
    x2, l2 = back.optimize(_feval(torch), x)
    assert torch.equal(x1, x2) and l1 == l2
    back.clear_history()
    assert back.state == {"epoch": 1, "neval": 1}
    assert not hasattr(back, "_flat_slots")
    jm = jom.RMSprop(learning_rate=0.05)
    jx = jnp.zeros(3, jnp.float32)
    for _ in range(3):
        jx, _ = jm.optimize(_feval(jnp), jx)
    jm.clear_history()
    assert jm.state == back.state
