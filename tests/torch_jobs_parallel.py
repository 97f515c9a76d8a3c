"""Rank-side jobs of ``tests/test_torch_parallel.py`` (run in
``torch_world.World``; no JAX here)."""

from __future__ import annotations

import logging

import numpy as np

from torch_world import arrays, my_rows, rank


def collectives_round(x_all):
    """psum, reduce-scatter, all-gather, ppermute both ways and a tiled
    all-to-all of this rank's row of ``x_all`` (n, k)."""
    import torch

    from bigdl_tpu_torch.parallel import collectives as C

    x = torch.tensor(x_all[rank()])
    return {"psum": C.psum(x).numpy(),
            "scatter": C.reduce_scatter(x).numpy(),
            "gather": C.all_gather(x).numpy(),
            "right": C.ppermute(x, None, 1).numpy(),
            "left": C.ppermute(x, None, -1).numpy(),
            "a2a": C.all_to_all(x.reshape(4, -1), None, 0, 1).numpy(),
            "transport": C.transport(None, x)}


def ppermute_grad(x_all, w_all):
    """d/dx of sum(w * ppermute(x)) on every rank: the cotangent comes
    back from the rank the value went to."""
    import torch

    from bigdl_tpu_torch.parallel import collectives as C

    x = torch.tensor(x_all[rank()], requires_grad=True)
    (C.ppermute(x, None, 1) * torch.tensor(w_all[rank()])).sum().backward()
    return x.grad.numpy()


def arp_round(grads, compress):
    """AllReduceParameter.aggregate and all_gather_weights of this rank's
    flat gradient row."""
    import torch

    from bigdl_tpu_torch.parallel import AllReduceParameter

    dtype = torch.bfloat16 if compress else None
    arp = AllReduceParameter("data", compress_dtype=dtype)
    owned = arp.aggregate(torch.tensor(grads[rank()]))
    return owned.numpy(), arp.all_gather_weights(owned).numpy()


# ------------------------------------------------------------ models, data
def mlp(dim=2, hidden=32, classes=2, bn=False, dropout=0.0):
    from bigdl_tpu_torch import nn

    layers = [nn.Linear(dim, hidden, device="cpu")]
    if bn:
        layers.append(nn.BatchNormalization(hidden, device="cpu"))
    layers.append(nn.Tanh() if not bn else nn.ReLU())
    if dropout:
        layers.append(nn.Dropout(dropout))
    layers += [nn.Linear(hidden, classes, device="cpu"), nn.LogSoftMax()]
    return nn.Sequential(*layers)


def samples_of(x, y):
    from bigdl_tpu_torch.dataset import Sample

    return [Sample(a, b) for a, b in zip(x, y)]


class RowsOfJaxBatches:
    """This rank's contiguous block of each global batch of the stream a
    ``LocalDataSet(records, seed)`` gives, as MiniBatches: the rows JAX
    device r gets on a mesh (a pre-sharded dataset: one shard a rank)."""

    def __init__(self, x, y, batch, iters, seed=1):
        import torch.distributed as dist

        from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch

        self.num_shards, self.shard_id = dist.get_world_size(), rank()
        ids = LocalDataSet(list(range(len(x))), seed=seed)
        stream = ids.data(True)
        per = batch // self.num_shards
        self.batches, seen = [], 0
        for _ in range(iters):
            rows = np.asarray([next(stream) for _ in range(batch)])
            rows = rows[self.shard_id * per:(self.shard_id + 1) * per]
            self.batches.append(MiniBatch(x[rows], y[rows]))
            seen += batch
            if seen >= len(x):      # the loop's reshuffle between epochs
                seen = 0
                ids.shuffle()
        self._n = len(x)

    def size(self):
        return self._n

    def local_size(self):
        return self._n // self.num_shards

    def shuffle(self):
        pass

    def data(self, train=True):
        return iter(self.batches)


def train_distri(params, x, y, batch, iters, sync, compress, method="sgd",
                 exact_rows=False, clip=None):
    """The port's DistriOptimizer on the JAX initial ``params``: the new
    parameters (numpy tree) and the optimizer."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, Adam, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils.weights import load_jax_params

    model = mlp()
    load_jax_params(model, params)
    data = (RowsOfJaxBatches(x, y, batch, iters) if exact_rows
            else DataSet.array(samples_of(x, y)))
    opt = DistriOptimizer(model=model, dataset=data,
                          criterion=nn.ClassNLLCriterion(), batch_size=batch,
                          end_when=Trigger.max_iteration(iters),
                          parameter_sync=sync,
                          compress_dtype=torch.bfloat16 if compress else None)
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9,
                             dampening=0.0) if method == "sgd"
                         else Adam(learning_rate=0.05))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    opt.optimize()
    return arrays(model.params_dict())


def local_step(params, x, y, batch):
    """The LocalOptimizer's one step on the same global batch (the
    RefDistriOptimizer oracle)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.utils.weights import load_jax_params

    model = mlp()
    load_jax_params(model, params)
    opt = Optimizer(model=model, dataset=DataSet.array(samples_of(x, y)),
                    criterion=nn.ClassNLLCriterion(), batch_size=batch,
                    end_when=Trigger.max_iteration(1))
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.optimize()
    return arrays(model.params_dict())


def sharded_one_step(params, x, y, batch):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils.weights import load_jax_params

    model = mlp()
    load_jax_params(model, params)
    opt = DistriOptimizer(model=model, dataset=DataSet.array(samples_of(x, y)),
                          criterion=nn.ClassNLLCriterion(), batch_size=batch,
                          end_when=Trigger.max_iteration(1),
                          parameter_sync="sharded", compress_dtype=None)
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.optimize()
    return arrays(model.params_dict())


def linear_problem(n=64, dim=8, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    w = rng.randn(dim, classes).astype(np.float32)
    y = ((x @ w).argmax(1) + 1.0).astype(np.float32)
    return x, y


def accuracy(model, x, y):
    from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy

    res = Evaluator(model).test(samples_of(x, y), [Top1Accuracy()],
                                batch_size=16)
    return res[0][1].result()[0]


def _linear_opt(iters, batch=16, **kw):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer

    x, y = linear_problem()
    bn = kw.pop("bn", False)
    model = mlp(8, 16, 3, bn=bn)
    opt = DistriOptimizer(model=model, dataset=DataSet.array(samples_of(x,
                                                                        y)),
                          criterion=nn.ClassNLLCriterion(), batch_size=batch,
                          end_when=Trigger.max_iteration(iters), **kw)
    return opt, x, y


def batch_must_divide():
    from bigdl_tpu_torch.optim import SGD

    opt, _, _ = _linear_opt(1, batch=30)
    opt.set_optim_method(SGD(learning_rate=0.1))
    try:
        opt.optimize()
    except ValueError as e:
        return str(e)
    return None


def bn_buffer_modes(sync_bn):
    """40 iterations with a BN model: each rank's running statistics (per
    rank, or averaged with sync_batch_norm), the model's after the loop,
    and the accuracy."""
    import torch

    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import collectives as C

    opt, x, y = _linear_opt(40, batch=32, bn=True,
                            sync_batch_norm=sync_bn)
    opt.set_optim_method(SGD(learning_rate=0.5))
    model = opt.optimize()
    mean = model.buffers_dict()["m1"]["~buffers"]["running_mean"]
    gathered = C.all_gather(mean.reshape(-1)).reshape(-1, mean.numel())
    return {"finite": bool(torch.isfinite(mean).all()),
            "same_on_every_rank": bool((gathered == gathered[0]).all()),
            "accuracy": accuracy(model, x, y)}


def log_interval_reads():
    from bigdl_tpu_torch.optim import SGD

    opt, x, y = _linear_opt(21, log_interval=5)
    opt.set_optim_method(SGD(learning_rate=0.5))
    model = opt.optimize()
    return opt.host_reads, accuracy(model, x, y)


def retry_from_checkpoint(path, slots_backend="pickle"):
    import os

    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.utils import config as bt_config

    opt, x, y = _linear_opt(30)
    opt.set_optim_method(SGD(learning_rate=0.5, momentum=0.9,
                             dampening=0.0))
    opt.set_checkpoint(path, Trigger.several_iteration(5),
                       slots_backend=slots_backend)
    fired = []

    def hook(state):
        if state["neval"] >= 12 and not fired:
            fired.append(state["neval"])
            raise RuntimeError("injected executor failure")

    opt._fault_hook = hook
    bt_config.set_property("bigdl.failure.retryTimes", 3)
    try:
        model = opt.optimize()
    finally:
        bt_config.clear_property("bigdl.failure.retryTimes")
    return {"fired": fired, "neval": opt.optim_method.state["neval"],
            "accuracy": accuracy(model, x, y),
            "files": sorted(os.listdir(path))}


def retry_gives_up(path):
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.utils import config as bt_config

    opt, _, _ = _linear_opt(50)
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_checkpoint(path, Trigger.several_iteration(2))
    calls = []

    def hook(state):
        if state["neval"] >= 6:
            calls.append(1)
            raise RuntimeError("persistent failure")

    opt._fault_hook = hook
    bt_config.set_property("bigdl.failure.retryTimes", 2)
    try:
        opt.optimize()
    except RuntimeError as e:
        return str(e), len(calls)
    finally:
        bt_config.clear_property("bigdl.failure.retryTimes")
    return None, len(calls)


def failure_without_checkpoint():
    from bigdl_tpu_torch.optim import SGD

    opt, _, _ = _linear_opt(10)
    opt.set_optim_method(SGD(learning_rate=0.1))

    def hook(state):
        raise RuntimeError("boom")

    opt._fault_hook = hook
    try:
        opt.optimize()
    except RuntimeError as e:
        return str(e)
    return None


def factory_on_sharded_dataset():
    """``Optimizer`` on a ``ShardedDataSet`` (shard = rank by default)
    gives a DistriOptimizer, which trains."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import ShardedDataSet
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    x, y = linear_problem()
    ds = ShardedDataSet(samples_of(x, y))
    opt = Optimizer(model=mlp(8, 16, 3), dataset=ds,
                    criterion=nn.ClassNLLCriterion(), batch_size=16,
                    end_when=Trigger.max_iteration(2))
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.optimize()
    return type(opt).__name__, ds.shard_id, ds.num_shards, \
        opt.optim_method.state["neval"]


def first_batch_ids(mode):
    """This rank's first minibatch (sample ids) of a 16-sample dataset at
    a global batch of 8, the dataset local (strided by rank) or
    sharded."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import LocalDataSet, Sample, ShardedDataSet
    from bigdl_tpu_torch.parallel import DistriOptimizer

    samples = [Sample(np.full((2,), float(i), np.float32),
                      np.asarray([i + 1], np.float32)) for i in range(16)]
    ds = (LocalDataSet(samples, seed=7) if mode == "local"
          else ShardedDataSet(samples, seed=7))
    opt = DistriOptimizer(model=nn.Sequential(nn.Linear(2, 2, device="cpu")),
                          dataset=ds, criterion=nn.MSECriterion(),
                          batch_size=8)
    mb = next(iter(opt._minibatches(ds, 8)))
    return sorted(int(v) for v in np.asarray(mb.get_input())[:, 0])


def bad_dataset_raises(kind):
    """The two datasets a distributed run refuses: pre-batched and not
    sharded, or sharded for another world size."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import (LocalDataSet, MiniBatch, Sample,
                                         ShardedDataSet)
    from bigdl_tpu_torch.parallel import DistriOptimizer

    if kind == "prebatched":
        mb = MiniBatch(np.zeros((4, 2), np.float32),
                       np.ones((4, 1), np.float32))
        ds = LocalDataSet([mb, mb])
    else:
        ds = ShardedDataSet([Sample(np.zeros((2,), np.float32),
                                    np.ones((1,), np.float32))] * 8,
                            shard_id=0, num_shards=1)
    opt = DistriOptimizer(model=nn.Sequential(nn.Linear(2, 1, device="cpu")),
                          dataset=ds, criterion=nn.MSECriterion(),
                          batch_size=4)
    try:
        next(iter(opt._minibatches(ds, 4)))
    except ValueError as e:
        return str(e)
    return None


def dropout_masks():
    """The first step's dropout mask on each rank (from each rank's own
    generator): the zeroed hidden units of one fixed input."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer

    x = np.ones((16, 2), np.float32)
    y = np.ones((16,), np.float32)
    model = mlp(dropout=0.5)
    drop = model[2]
    seen = []
    real = drop.forward

    def spy(inp):
        out = real(inp)
        seen.append((out == 0).detach().numpy().copy())
        return out

    drop.forward = spy
    opt = DistriOptimizer(model=model, dataset=DataSet.array(samples_of(x,
                                                                        y)),
                          criterion=nn.ClassNLLCriterion(), batch_size=16,
                          end_when=Trigger.max_iteration(1))
    opt.set_optim_method(SGD(learning_rate=0.0))
    opt.optimize()
    return seen[0]


def sync_bn_forward_and_grad(x, w_out, weight, bias):
    """A ``(Spatial)BatchNormalization(global_stats_axis="data")`` on this
    rank's
    rows of ``x``: its output rows, the gradient of sum(out * w_out) with
    respect to those input rows and to the affine, and the running
    statistics."""
    import torch

    from bigdl_tpu_torch import nn

    cls = (nn.SpatialBatchNormalization if x.ndim == 4
           else nn.BatchNormalization)
    bn = cls(x.shape[1], global_stats_axis="data", device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(weight))
        bn.bias.copy_(torch.tensor(bias))
    xr = torch.tensor(my_rows(x), requires_grad=True)
    out = bn(xr)
    (out * torch.tensor(my_rows(w_out))).sum().backward()
    return {"out": out.detach().numpy(), "dx": xr.grad.numpy(),
            "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def prefetch_shard(batch):
    """``device_prefetch(sharding="data")``: this rank's rows."""
    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.dataset.prefetch import device_prefetch

    mb = MiniBatch(batch, batch[:, :1])
    out = list(device_prefetch(iter([mb, batch]), sharding="data",
                               device="cpu"))
    return out[0].get_input().numpy(), out[1].numpy()


def quiet():
    logging.getLogger("bigdl_tpu_torch").setLevel(logging.WARNING)
    return True
