"""The port's training loop and data path (bigdl_tpu_torch/optim/
{optimizer,trigger,validation,evaluator}.py, bigdl_tpu_torch/dataset/)
against the JAX package's.

Both ``LocalDataSet``s draw their offsets and shuffles from the same
numpy seed, so the two loops see the same batches in the same order; a
small conv + BatchNorm net with the same weights (carried by the bridge)
trains for two epochs in each and ends with the same parameters, running
statistics, state table and validation score. Tolerance for the final
parameters and statistics: rtol 1e-4 and an atol of 1e-4 of the largest
|value| of the leaf, at least 1e-6 (f32; eight SGD steps carry the
sum-order differences of each step into the next). Triggers and the
validation methods must agree exactly (Loss to rtol 1e-6).
"""

import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim import validation as jval
from bigdl_tpu.optim.evaluator import Evaluator as JaxEvaluator
from bigdl_tpu.optim.optimizer import Optimizer as JaxOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import (DataSet, LocalDataSet, MiniBatch,
                                     Sample, SampleToMiniBatch, Transformer,
                                     prefetch, to_device)
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.optim import validation as tval
from bigdl_tpu_torch.utils.weights import (buffers_to_numpy,
                                           load_jax_buffers, load_jax_params,
                                           params_to_numpy)

N_TRAIN, N_VAL, BATCH, CLASSES = 64, 24, 16, 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data(n, seed):
    """(images (n, 1, 8, 8), 1-based labels): the class is the argmax of
    five fixed projections, so the net can learn it."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 1, 8, 8).astype(np.float32)
    proj = np.random.RandomState(123).randn(64, CLASSES).astype(np.float32)
    y = (x.reshape(n, 64) @ proj).argmax(1) + 1
    return x, y.astype(np.float32)


def _net(nn, **kw):
    return nn.Sequential(
        nn.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1, **kw),
        nn.SpatialBatchNormalization(4, **kw), nn.ReLU(),
        nn.SpatialMaxPooling(2, 2), nn.View(4 * 4 * 4),
        nn.Linear(64, CLASSES, **kw), nn.LogSoftMax())


def _pair():
    jm = _net(jnn)
    tm = _net(tnn, device="cpu")
    load_jax_params(tm, _np(jm.params_dict()))
    load_jax_buffers(tm, _np(jm.buffers_dict()))
    return jm, tm


class _Losses(logging.Handler):
    """Collects the loss of every iteration the loop logs."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        if "Throughput" in record.msg:
            self.losses.append(record.args[-1])


def _train(pkg, model, samples, val, grad_accum=1, clip=None):
    opt_cls, trig, sgd, top1, name = {
        "jax": (JaxOptimizer, JaxTrigger, jom.SGD, jval.Top1Accuracy,
                "bigdl_tpu.optim"),
        "torch": (topt.Optimizer, topt.Trigger, topt.SGD, topt.Top1Accuracy,
                  "bigdl_tpu_torch.optim")}[pkg]
    method = sgd(learning_rate=0.1)
    opt = opt_cls(model=model, dataset=samples,
                  criterion=(jnn if pkg == "jax" else tnn).ClassNLLCriterion(),
                  batch_size=BATCH, end_when=trig.max_epoch(2))
    opt.set_optim_method(method)
    opt.set_validation(trig.every_epoch(), val, [top1()])
    if grad_accum > 1:
        opt.set_gradient_accumulation(grad_accum)
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    logger = logging.getLogger(name)
    handler, level = _Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        opt.optimize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return method.state, handler.losses


def _leaf_close(ours, theirs, name):
    atol = max(1e-4 * np.abs(theirs).max(), 1e-6)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=atol,
                               err_msg=name)


# loop options: plain, two accumulated micro-batches, and a global-L2
# clip far below the gradients' norm, so that it acts on every step
LOOP_CASES = {"plain": {}, "grad_accum_2": dict(grad_accum=2),
              "clip_l2norm": dict(clip=0.05)}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_local_optimizer_trains_as_the_jax_loop(case):
    kw = LOOP_CASES[case]
    x, y = _data(N_TRAIN, seed=1)
    vx, vy = _data(N_VAL, seed=2)
    jm, tm = _pair()
    t_buf0 = buffers_to_numpy(tm)
    j_state, j_losses = _train(
        "jax", jm, [JaxSample(a, b) for a, b in zip(x, y)],
        [JaxSample(a, b) for a, b in zip(vx, vy)], **kw)
    t_state, t_losses = _train(
        "torch", tm, [Sample(a, b) for a, b in zip(x, y)],
        [Sample(a, b) for a, b in zip(vx, vy)], **kw)
    steps = 2 * N_TRAIN // BATCH
    assert len(t_losses) == len(j_losses) == steps
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    if "clip" not in kw:
        per_epoch = np.reshape(t_losses, (2, -1)).mean(1)
        assert per_epoch[1] < per_epoch[0], per_epoch
    for key in ("epoch", "neval", "recordsProcessedThisEpoch"):
        assert t_state[key] == j_state[key], key
    assert t_state["epoch"] == 3 and t_state["neval"] == steps + 1
    np.testing.assert_allclose(t_state["score"], j_state["score"])
    # the loop wrote its parameters and statistics back into the model
    for (name, ours), (_, theirs) in zip(tree_leaves(params_to_numpy(tm)),
                                         tree_leaves(_np(jm.params_dict()))):
        _leaf_close(ours, theirs, name)
    for (name, ours), (_, theirs), (_, old) in zip(
            tree_leaves(buffers_to_numpy(tm)),
            tree_leaves(_np(jm.buffers_dict())), tree_leaves(t_buf0)):
        _leaf_close(ours, theirs, name)
        assert not np.allclose(ours, old), name


class _ToBF16(Transformer):
    """MiniBatches with their inputs as bf16 tensors: how a bf16 model is
    fed (numpy has no bf16)."""

    def __call__(self, it):
        for b in it:
            yield MiniBatch(torch.from_numpy(b.get_input()).to(torch.bfloat16),
                            b.get_target())


def test_local_optimizer_trains_a_bf16_model_with_f32_statistics():
    x, y = _data(N_TRAIN, seed=3)
    tm = _net(tnn, device="cpu", dtype=torch.bfloat16)
    data = (LocalDataSet([Sample(a, b) for a, b in zip(x, y)])
            >> SampleToMiniBatch(BATCH) >> _ToBF16())
    opt = topt.Optimizer(model=tm, dataset=data,
                         criterion=tnn.ClassNLLCriterion(), batch_size=BATCH,
                         end_when=topt.Trigger.max_iteration(3))
    opt.set_optim_method(topt.SGD(learning_rate=0.1))
    p0, buf0 = params_to_numpy(tm), buffers_to_numpy(tm)
    opt.optimize()
    assert isinstance(opt, topt.LocalOptimizer)
    assert opt.optim_method.state["neval"] == 4
    assert np.isfinite(opt.optim_method.state["Loss"])
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    # the loop wrote its new parameters and statistics back into the model
    for (name, new), (_, old) in zip(tree_leaves(params_to_numpy(tm)),
                                     tree_leaves(p0)):
        assert not np.array_equal(new, old), name
    for (name, new), (_, old) in zip(tree_leaves(buffers_to_numpy(tm)),
                                     tree_leaves(buf0)):
        assert not np.allclose(new, old), name


def test_module_loaders_check_the_tree():
    """load_params_dict / load_buffers_dict copy in place across dtypes
    and refuse a tree with a missing or extra key or a wrong shape."""
    src = _net(tnn, device="cpu")
    dst = _net(tnn, device="cpu", dtype=torch.bfloat16)
    tree = src.params_dict()
    with torch.no_grad():
        src.m1.running_mean.add_(0.5)
    dst.load_params_dict(tree)
    dst.load_buffers_dict(src.buffers_dict())
    for (name, a), (_, b) in zip(tree_leaves(dst.params_dict()),
                                 tree_leaves(tree)):
        assert a.dtype == torch.bfloat16, name
        torch.testing.assert_close(a, b.to(torch.bfloat16))
    assert dst.m1.running_mean.dtype == torch.float32
    torch.testing.assert_close(dst.m1.running_mean, src.m1.running_mean)
    bufs = src.buffers_dict()
    del bufs["m1"]
    with pytest.raises(KeyError, match="missing"):
        dst.load_buffers_dict(bufs)
    bad = src.params_dict()
    bad["m0"]["~params"]["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="unexpected"):
        dst.load_params_dict(bad)
    bad = src.params_dict()
    bad["m5"]["~params"]["weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        dst.load_params_dict(bad)


def test_optimizer_refuses_a_sharded_dataset():
    """The local loop does not take a ShardedDataSet: since the
    distributed slice the factory gives the DistriOptimizer for one, as
    the JAX factory does, and a LocalOptimizer for the in-memory set."""
    from bigdl_tpu_torch.parallel import DistriOptimizer

    samples = [Sample(np.zeros(3, np.float32), 1.0) for _ in range(4)]
    opt = topt.Optimizer(model=tnn.Linear(3, 2, device="cpu"),
                         dataset=DataSet.sharded(samples, 0, 2),
                         criterion=tnn.ClassNLLCriterion(), batch_size=2)
    assert isinstance(opt, DistriOptimizer)
    assert not isinstance(topt.Optimizer(
        model=tnn.Linear(3, 2, device="cpu"), dataset=samples,
        criterion=tnn.ClassNLLCriterion(), batch_size=2), DistriOptimizer)


def test_evaluator_matches_jax():
    jm, tm = _pair()
    vx, vy = _data(N_VAL + 3, seed=4)
    methods_j = [jval.Top1Accuracy(), jval.Top5Accuracy(), jval.Loss()]
    methods_t = [topt.Top1Accuracy(), topt.Top5Accuracy(), topt.Loss()]
    rj = JaxEvaluator(jm).test([JaxSample(a, b) for a, b in zip(vx, vy)],
                               methods_j, batch_size=8)
    tm.training_mode()
    rt = topt.Evaluator(tm).test([Sample(a, b) for a, b in zip(vx, vy)],
                                 methods_t, batch_size=8)
    assert tm.is_training()          # the modes come back
    for (_, a), (_, b) in zip(rt, rj):
        va, na = a.result()
        vb, nb = b.result()
        assert na == nb == N_VAL + 3
        np.testing.assert_allclose(va, vb, rtol=1e-5)


TRIGGERS = {
    "every_epoch": lambda T: T.every_epoch(),
    "several_iteration": lambda T: T.several_iteration(3),
    "max_epoch": lambda T: T.max_epoch(2),
    "max_iteration": lambda T: T.max_iteration(5),
    "max_score": lambda T: T.max_score(0.5),
    "min_loss": lambda T: T.min_loss(0.3),
    "and": lambda T: T.max_iteration(2).and_(T.min_loss(0.6)),
    "or": lambda T: T.max_epoch(2).or_(T.several_iteration(4)),
}


@pytest.mark.parametrize("kind", sorted(TRIGGERS))
def test_triggers_match_jax(kind):
    tj, tt = TRIGGERS[kind](JaxTrigger), TRIGGERS[kind](topt.Trigger)
    fired_j, fired_t = [], []
    for i in range(1, 13):
        state = {"neval": i, "epoch": 1 + i // 4, "Loss": 1.0 / i,
                 "score": 0.1 * i if i % 2 else None}
        fired_j.append(tj(dict(state)))
        fired_t.append(tt(dict(state)))
    assert fired_t == fired_j
    assert any(fired_t)


def test_validation_methods_match_jax():
    rs = np.random.RandomState(5)
    logits = rs.randn(3, 9, 7).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    target = rs.randint(1, 8, (3, 9)).astype(np.float32)
    for tcls, jcls in ((tval.Top1Accuracy, jval.Top1Accuracy),
                       (tval.Top5Accuracy, jval.Top5Accuracy),
                       (tval.Loss, jval.Loss)):
        tm, jm = tcls(), jcls()
        rt = [tm(torch.from_numpy(o), torch.from_numpy(t))
              for o, t in zip(logp, target)]
        rj = [jm(jnp.asarray(o), jnp.asarray(t))
              for o, t in zip(logp, target)]
        total_t, total_j = rt[0] + rt[1] + rt[2], rj[0] + rj[1] + rj[2]
        for a, b in zip(rt + [total_t], rj + [total_j]):
            np.testing.assert_allclose(a.result(), b.result(), rtol=1e-6)
        assert tm.name() == jm.name()


def test_minibatches_and_epoch_order_match_jax():
    """The data path alone: SampleToMiniBatch over the infinite training
    stream of a LocalDataSet, with a shuffle between epochs, gives the
    JAX package's batches."""
    from bigdl_tpu.dataset import dataset as jds
    from bigdl_tpu.dataset import transformer as jtr

    x, y = _data(20, seed=6)
    ours = LocalDataSet([Sample(a, b) for a, b in zip(x, y)], seed=3)
    theirs = jds.LocalDataSet([JaxSample(a, b) for a, b in zip(x, y)],
                              seed=3)
    for ds, to_mb in ((ours, SampleToMiniBatch(8)),
                      (theirs, jtr.SampleToMiniBatch(8))):
        ds.batches = []
        it = to_mb(ds.data(train=True))
        for i in range(5):
            b = next(it)
            ds.batches.append((b.get_input().copy(), b.get_target().copy()))
            if i == 1:
                ds.shuffle()
    for (a, b), (c, d) in zip(ours.batches, theirs.batches):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    last = MiniBatch.from_samples([Sample(a, b) for a, b in zip(x, y)])
    assert last.slice(3, 4).size() == 4


def test_prefetch_stages_batches_and_stops_its_thread():
    x, y = _data(12, seed=7)
    batches = list(SampleToMiniBatch(4)(Sample(a, b) for a, b in zip(x, y)))
    cpu = torch.device("cpu")
    staged = list(prefetch(iter(batches), transfer=lambda b: (
        to_device(b.get_input(), cpu), to_device(b.get_target(), cpu))))
    assert len(staged) == 3
    x2, y2 = staged[2]
    assert isinstance(x2, torch.Tensor) and x2.dtype == torch.float32
    np.testing.assert_array_equal(x2.numpy(), batches[2].get_input())
    np.testing.assert_array_equal(y2.numpy(), batches[2].get_target())
    # an abandoned consumer releases the producer of an infinite stream
    def forever():
        while True:
            yield 1

    it = prefetch(forever(), buffer_size=2)
    assert next(it) == 1
    it.close()
    for t in threading.enumerate():
        if t.name == "bigdl-prefetch":
            t.join(timeout=5)
    assert not any(t.name == "bigdl-prefetch" and t.is_alive()
                   for t in threading.enumerate())

    def broken():
        yield 1
        raise RuntimeError("bad record")

    with pytest.raises(RuntimeError, match="bad record"):
        list(prefetch(broken()))
