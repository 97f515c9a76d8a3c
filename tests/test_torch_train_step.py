"""The port's train step (bigdl_tpu_torch/optim/optimizer.py) against the
JAX package's TrainStep, on a 2-layer TransformerLM (embed 64, 4 heads,
2 kv heads, vocab 97, t 128 so that the JAX flash kernel tiles and runs
in interpret mode; the port runs the kernel's plain forward and the
blocked backward) with shared weights and the same batch: next-token
cross entropy with 1-based targets, SGD.

Tolerances, per step and per leaf:
- f32: loss and grad norm at rtol 1e-5; grads and parameters after
  three steps at rtol 2e-4 / atol 2e-6 (sums in another order);
- bf16 compute over f32 masters: the loss within 2 bf16 steps at its
  size (2 * 2^-5 near ln 97 = 4.57), and each leaf's three-step update
  (params - initial) within 5% of the largest |JAX update| of that leaf.

Also: remat gives the same step as no remat (with dropout, the masks
replay in the recompute and the generator ends where it would without
it), dropout's keep rate, scale and evaluation mode, and frozen
parameters, per-submodule optimizers, regularizers and the momentum
slots on a small two-layer net against the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn.module import Module as JaxModule
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim import regularizer as jreg
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu.utils import random as bt_random
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.models.perf import LMLoss
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn import CrossEntropyCriterion, Dropout, Linear, Module
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.utils.weights import load_jax_params, params_to_numpy

V, T, B = 97, 128, 2
CFG = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=T,
           num_kv_heads=2, use_flash=True)
F32 = dict(rtol=2e-4, atol=2e-6)


class JaxLMLoss:
    """The JAX package's _LMLoss (models/perf.py) at vocab V."""

    def forward(self, logits, ids):
        lg = logits[:, :-1].reshape(-1, V)
        return jnn.CrossEntropyCriterion().forward(
            lg, ids[:, 1:].reshape(-1) + 1)


@pytest.fixture(scope="module")
def jax_lm():
    bt_random.set_seed(5)
    return JaxLM(V, **CFG)


def _port_lm(jm, **kw):
    tm = TransformerLM(V, **CFG, device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    return tm


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)


def _leaves_np(tree):
    return [np.asarray(a, np.float32)
            for a in jax.tree.leaves(jax.tree.map(np.asarray, tree))]


def _run_jax(jm, ids, steps, method, **kw):
    ts = jax_train_step(jm, JaxLMLoss(), method, **kw)
    params = jm.params_dict()
    slots = ts.init_slots(params)
    fn = jax.jit(ts.step_with_stats)
    x = jnp.asarray(ids)
    out = []
    for _ in range(steps):
        loss, gnorm, params, _, slots = fn(params, {}, slots, x, x,
                                           ts.current_lrs(),
                                           jax.random.PRNGKey(0))
        out.append((float(loss), float(gnorm)))
    return out, params


def _run_port(tm, ids, steps, method, **kw):
    ts = topt.make_train_step(tm, LMLoss(V), method, **kw)
    params, buffers = tm.params_dict(), tm.buffers_dict()
    slots = ts.init_slots(params)
    x = torch.from_numpy(ids)
    out = []
    for _ in range(steps):
        loss, gnorm, params, buffers, slots = ts.step_with_stats(
            params, buffers, slots, x, x, ts.current_lrs(), None)
        out.append((float(loss), float(gnorm)))
    return out, params


def test_f32_grads_match_jax(jax_lm):
    tm = _port_lm(jax_lm)
    ids = _ids()
    loss_fn = JaxLMLoss()

    def jloss(p):
        out, _ = pure_apply(jax_lm)(p, {}, jnp.asarray(ids), training=True)
        return loss_fn.forward(out, jnp.asarray(ids))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax_lm.params_dict())
    x = torch.from_numpy(ids)
    loss = LMLoss(V).forward(tm(x), x)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    names = [n for n, _ in tree_leaves(tm.params_dict())]
    grads = [p.grad.numpy() for _, p in tree_leaves(tm.params_dict())]
    for name, ours, theirs in zip(names, grads, _leaves_np(jg)):
        np.testing.assert_allclose(ours, theirs, **F32, err_msg=name)


# (optimizer, train-step options): plain SGD, the global-L2 clip (at a
# norm below the grads', so it clips), the constant clip (below the
# largest grads), two accumulated micro-batches with momentum
STEP_CASES = {
    "sgd": (lambda m: m.SGD(learning_rate=0.01), {}),
    "clip_l2norm": (lambda m: m.SGD(learning_rate=0.5),
                    dict(grad_clip={"l2norm": 0.05})),
    "clip_constant": (lambda m: m.SGD(learning_rate=0.5),
                      dict(grad_clip={"constant": (-1e-3, 2e-3)})),
    "grad_accum_2": (lambda m: m.SGD(learning_rate=0.1, momentum=0.9),
                     dict(grad_accum=2)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_f32_three_steps_match_jax(jax_lm, case):
    method, kw = STEP_CASES[case]
    ids = _ids(1)
    tm = _port_lm(jax_lm)
    jout, jparams = _run_jax(jax_lm, ids, 3, method(jom), **kw)
    tout, tparams = _run_port(tm, ids, 3, method(topt), **kw)
    for (jl, jn), (tl, tn) in zip(jout, tout):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tn, jn, rtol=1e-5)
    if case == "clip_l2norm":
        assert min(n for _, n in jout) > 0.05   # the clip did act
    for ours, theirs in zip(_leaves_np(params_to_numpy(tparams)),
                            _leaves_np(jparams)):
        np.testing.assert_allclose(ours, theirs, **F32)


def test_bf16_compute_over_f32_masters_matches_jax(jax_lm):
    ids = _ids(2)
    tm = _port_lm(jax_lm)
    init = _leaves_np(jax_lm.params_dict())
    jout, jparams = _run_jax(jax_lm, ids, 3, jom.SGD(learning_rate=0.5),
                             compute_dtype=jnp.bfloat16)
    tout, tparams = _run_port(tm, ids, 3, topt.SGD(learning_rate=0.5),
                              compute_dtype=torch.bfloat16)
    for (jl, _), (tl, _) in zip(jout, tout):
        assert abs(tl - jl) <= 2 * 2.0 ** -5, (tl, jl)
    ours = _leaves_np(params_to_numpy(tparams))
    for p0, o, j in zip(init, ours, _leaves_np(jparams)):
        assert o.dtype == np.float32
        upd_j, upd_o = j - p0, o - p0
        assert np.abs(upd_o - upd_j).max() <= 0.05 * np.abs(upd_j).max()


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_remat_equals_no_remat(jax_lm, dropout):
    ids = torch.from_numpy(_ids(3))
    results = []
    for remat in (False, True):
        tm = _port_lm(jax_lm, remat=remat, dropout=dropout)
        ts = topt.make_train_step(tm, LMLoss(V),
                                  topt.SGD(learning_rate=0.1))
        gen = torch.Generator().manual_seed(7)
        params, slots = tm.params_dict(), ts.init_slots(tm.params_dict())
        for _ in range(2):
            loss, params, _, slots = ts.step(params, {}, slots, ids, ids,
                                             ts.current_lrs(), gen)
        results.append((loss, params, torch.rand(4, generator=gen)))
    (l0, p0, r0), (l1, p1, r1) = results
    assert torch.equal(r0, r1)          # the stream went on unchanged
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    for (_, a), (_, b) in zip(tree_leaves(p0), tree_leaves(p1)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_dropout_keep_rate_scale_and_evaluate():
    d = Dropout(0.3, generator=torch.Generator().manual_seed(0))
    x = torch.ones(200_000)
    y = d(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.7, rtol=1e-6)
    d.evaluate()
    assert d(x) is x
    d.training_mode()
    assert Dropout(0.0)(x) is x


class _JaxTwo(JaxModule):
    def __init__(self):
        super().__init__()
        self.a = jnn.Linear(6, 8, w_regularizer=jreg.L2Regularizer(0.1))
        self.b = jnn.Linear(8, 5)

    def forward(self, x):
        return self.b(jnp.tanh(self.a(x)))


class _Two(Module):
    def __init__(self):
        super().__init__()
        self.a = Linear(6, 8, w_regularizer=topt.L2Regularizer(0.1),
                        device="cpu")
        self.b = Linear(8, 5, device="cpu")

    def forward(self, x):
        return self.b(torch.tanh(self.a(x)))


@pytest.mark.parametrize("frozen", [False, True])
def test_regularizer_groups_and_freeze_match_jax(frozen):
    bt_random.set_seed(9)
    jm = _JaxTwo()
    tm = _Two()
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    jm.a.set_name("first")
    tm.a.set_name("first")
    if frozen:
        jm.freeze("first")
        tm.freeze("first")
        tm.b.freeze().unfreeze()
    assert (jax.tree.leaves(jm.trainable_dict())
            == [t for _, t in tree_leaves(tm.trainable_dict())])
    np.testing.assert_allclose(
        tm.regularization_loss().item(),
        float(jm.regularization_loss()), rtol=1e-6)
    rs = np.random.RandomState(4)
    x, y = rs.randn(16, 6).astype(np.float32), rs.randint(1, 6, 16)
    jts = jax_train_step(jm, jnn.CrossEntropyCriterion(),
                         jom.SGD(learning_rate=0.1),
                         sub_methods={"first": jom.SGD(learning_rate=0.3,
                                                       momentum=0.9)})
    tts = topt.make_train_step(tm, CrossEntropyCriterion(),
                          topt.SGD(learning_rate=0.1),
                          sub_methods={"first": topt.SGD(
                              learning_rate=0.3, momentum=0.9)})
    jp, tp = jm.params_dict(), tm.params_dict()
    js, tsl = jts.init_slots(jp), tts.init_slots(tp)
    jstep = jax.jit(jts.step)
    for _ in range(3):
        jl, jp, _, js = jstep(jp, {}, js, jnp.asarray(x), jnp.asarray(y),
                              jts.current_lrs(), None)
        tl, tp, _, tsl = tts.step(tp, {}, tsl, torch.from_numpy(x),
                                  torch.from_numpy(y), tts.current_lrs(),
                                  None)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for ours, theirs in zip(_leaves_np(params_to_numpy(tp)),
                            _leaves_np(jp)):
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tsl[1]["velocity"][0].numpy(),
        np.asarray(jax.tree.leaves(js[1]["velocity"])[0]), rtol=1e-5,
        atol=1e-6)
