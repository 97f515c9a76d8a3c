"""The port's data-parallel engine held against the JAX package's (the
counterparts of ``tests/test_parallel.py``, ``tests/test_fault_tolerance.py``
and ``tests/test_multihost.py:59-89``).

The port runs in a world of 4 ranks over gloo on the CPU
(``torch_world.World``, one per file); the JAX package runs in this
process on a mesh of 4 of the conftest's 8 virtual CPU devices. Both
start from the same weights (the JAX model's, carried with
``load_jax_params``) and read the same batches: a device of the JAX mesh
gets a contiguous block of each global batch, and the exact-rows dataset
gives each rank the same block (``RowsOfJaxBatches``). Tolerances:
f32 parameters within 2e-5 after 1 and 3 steps; on the bf16 wire each
parameter within 2^-6 of its magnitude plus 2e-5 (each step rounds the
gradient and then the weights to bf16, an ulp, 2^-7 relative at most,
when a value sits on a rounding boundary that the f32 sums of the two
packages put on different sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bigdl_tpu.nn as jnn
import torch_jobs_parallel as jobs
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import Adam as JaxAdam
from bigdl_tpu.optim import Trigger as JaxTrigger
from bigdl_tpu.parallel import AllReduceParameter as JaxARP
from bigdl_tpu.parallel import DistriOptimizer as JaxDistriOptimizer
from bigdl_tpu.parallel import Engine as JaxEngine
from bigdl_tpu.parallel import all_reduce as jar
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu_torch.parallel import (DistriOptimizer, Engine, all_reduce,
                                      flatten_params, pad_to_multiple)
from bigdl_tpu_torch.utils import config as tconfig
from torch_world import World

N = 4
F32_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This file's port-side work is many tiny ops: one intra-op thread
    keeps it from contending with the test workers and the world's
    ranks (restored after the file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    w = World.shared(N)
    w.run(jobs.quiet)
    return w


@pytest.fixture(scope="module")
def mesh4():
    return JaxEngine.create_mesh([("data", N)], devices=jax.devices()[:N])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


# ------------------------------------------------------------- flat params
def test_flat_round_trip_padding_and_bf16_match_jax():
    tree = {"b": {"~params": {"w": np.arange(6, dtype=np.float32
                                              ).reshape(2, 3)}},
            "a": {"~params": {"bias": np.linspace(-3, 3, 5,
                                                  dtype=np.float32)}}}
    j_flat, _ = jar.flatten_params(jax.tree.map(jnp.asarray, tree))
    t_tree = jax.tree.map(torch.tensor, tree)
    t_flat, spec = flatten_params(t_tree)
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
    back = all_reduce.unflatten_params(t_flat, spec)
    np.testing.assert_array_equal(back["b"]["~params"]["w"].numpy(),
                                  tree["b"]["~params"]["w"])
    padded, size = pad_to_multiple(t_flat, 8)
    j_padded, j_size = jar.pad_to_multiple(j_flat, 8)
    assert size == j_size == 16
    np.testing.assert_array_equal(padded.numpy(), np.asarray(j_padded))
    x = np.asarray([1.2345678, -3.1415926, 1e-8, 65504.3, 2.0 ** -130],
                   np.float32)
    ours = all_reduce.decompress(all_reduce.compress(torch.tensor(x)))
    theirs = jar.decompress(jar.compress(jnp.asarray(x)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


# ------------------------------------------------------------ collectives
def test_collectives_over_a_gloo_world(world):
    x = np.arange(N * 8, dtype=np.float32).reshape(N, 8)
    out = world.run(jobs.collectives_round, x)
    total = x.sum(0)
    for r, o in enumerate(out):
        assert o["transport"] == "gloo"
        np.testing.assert_array_equal(o["psum"], total)
        np.testing.assert_array_equal(o["scatter"], total[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["gather"], x.reshape(-1))
        np.testing.assert_array_equal(o["right"], x[(r - 1) % N])
        np.testing.assert_array_equal(o["left"], x[(r + 1) % N])
        # chunk r of every rank's (4, 2) view, concatenated along dim 1
        np.testing.assert_array_equal(
            o["a2a"], np.concatenate([x[j].reshape(4, 2)[r:r + 1]
                                      for j in range(N)], axis=1))


def test_ppermute_gradient_is_the_jax_transpose(world, mesh4):
    x = np.random.RandomState(0).randn(N, 6).astype(np.float32)
    w = np.random.RandomState(1).randn(N, 6).astype(np.float32)
    perm = [(i, (i + 1) % N) for i in range(N)]

    def loss(xs, ws):
        def body(a, b):
            return jnp.sum(jax.lax.ppermute(a, "data", perm) * b)[None]
        return jnp.sum(jax.shard_map(body, mesh=mesh4,
                                     in_specs=(P("data"), P("data")),
                                     out_specs=P("data"))(xs, ws))

    want = np.asarray(jax.grad(loss)(jnp.asarray(x.reshape(-1)),
                                     jnp.asarray(w.reshape(-1))))
    got = np.stack(world.run(jobs.ppermute_grad, x, w))
    np.testing.assert_allclose(got.reshape(-1), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("compress", [False, True])
def test_all_reduce_parameter_matches_the_jax_mesh(world, mesh4, compress):
    grads = np.random.RandomState(3).randn(N, 32).astype(np.float32)
    arp = JaxARP("data", compress_dtype=jnp.bfloat16 if compress else None)

    def body(g):
        owned = arp.aggregate(g)
        return owned, arp.all_gather_weights(owned)

    owned, full = jax.jit(jax.shard_map(
        body, mesh=mesh4, in_specs=P("data"),
        out_specs=(P("data"), P("data")), check_vma=False))(
            jnp.asarray(grads.reshape(-1)))
    owned = np.asarray(owned).reshape(N, -1)
    full = np.asarray(full).reshape(N, -1)
    got = world.run(jobs.arp_round, grads, compress)
    # bf16 wire: both packages sum bf16 addends in bf16, each in its own
    # order, so an element may differ by an ulp of each partial sum, at
    # most 2^-7 of the sum of the addends' magnitudes per addition
    bound = (2 ** -6 * np.abs(grads).sum(0) / N + 1e-6 if compress
             else 1e-6 + 1e-6 * np.abs(grads).sum(0))
    for r, (o, f) in enumerate(got):
        per = bound.size // N
        assert np.all(np.abs(o - owned[r]) <= bound[r * per:(r + 1) * per])
        assert np.all(np.abs(f - full[r]) <= bound)


# ------------------------------------------------------- DistriOptimizer
def _xor(n=128, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    y = (((x[:, 0] > 0.5) ^ (x[:, 1] > 0.5)).astype(np.float32) + 1.0)
    return x, y


def _jax_mlp(seed=11):
    from bigdl_tpu.utils import random as jrandom

    jrandom.set_seed(seed)
    return (jnn.Sequential().add(jnn.Linear(2, 32)).add(jnn.Tanh())
            .add(jnn.Linear(32, 2)).add(jnn.LogSoftMax()))


def _jax_distri(mesh, x, y, batch, iters, sync, compress, method, clip):
    model = _jax_mlp()
    p0 = _np(model.params_dict())
    samples = [JaxSample(a, np.asarray([b])) for a, b in zip(x, y)]
    opt = JaxDistriOptimizer(
        model=model, dataset=JaxDataSet.array(samples),
        criterion=jnn.ClassNLLCriterion(), batch_size=batch,
        end_when=JaxTrigger.max_iteration(iters), mesh=mesh,
        parameter_sync=sync,
        compress_dtype=jnp.bfloat16 if compress else None)
    opt.set_optim_method(JaxSGD(learning_rate=0.1, momentum=0.9,
                                dampening=0.0) if method == "sgd"
                         else JaxAdam(learning_rate=0.05))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    opt.optimize()
    return p0, _np(model.params_dict())


@pytest.mark.parametrize("sync,compress,iters,method,clip", [
    ("sharded", False, 1, "sgd", None),
    ("sharded", False, 3, "sgd", None),
    ("sharded", False, 3, "adam", 0.5),
    ("sharded", True, 3, "sgd", None),
    ("allreduce", False, 3, "sgd", None),
    ("allreduce", True, 3, "sgd", None),
])
def test_distri_optimizer_matches_the_jax_distri_optimizer(
        world, mesh4, sync, compress, iters, method, clip):
    x, y = _xor()
    p0, want = _jax_distri(mesh4, x, y, 64, iters, sync, compress, method,
                           clip)
    got = world.run(jobs.train_distri, p0, x, y, 64, iters, sync, compress,
                    method, exact_rows=True, clip=clip)
    for g in got[1:]:                     # every rank holds the same model
        for a, b in zip(_leaves(g), _leaves(got[0])):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(got[0]), _leaves(want)):
        if compress and sync == "sharded":
            assert np.all(np.abs(a - b) <= 2 ** -6 * np.abs(b) + F32_ATOL)
        else:
            np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0)


def test_strided_stream_trains_as_the_jax_distri_optimizer(world, mesh4):
    """The default data path (every rank strides the same LocalDataSet
    stream) feeds the same global batches as the JAX mesh, across the
    epoch's reshuffle."""
    x, y = _xor()
    p0, want = _jax_distri(mesh4, x, y, 64, 3, "sharded", False, "sgd", None)
    got = world.run(jobs.train_distri, p0, x, y, 64, 3, "sharded", False)
    for a, b in zip(_leaves(got[0]), _leaves(want)):
        np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0)


def test_sharded_step_matches_the_local_optimizer(world):
    """RefDistriOptimizer oracle: one sharded step at world 4 equals one
    local step on the same global batch."""
    x, y = _xor(64, seed=3)
    p0 = _np(_jax_mlp().params_dict())
    got = world.run(jobs.sharded_one_step, p0, x, y, 64)
    want = world.run(jobs.local_step, p0, x, y, 64)[0]
    for a, b in zip(_leaves(got[0]), _leaves(want)):
        np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0)


def test_batch_divisibility_enforced(world):
    msgs = world.run(jobs.batch_must_divide)
    assert all(m is not None and "divide" in m for m in msgs), msgs


@pytest.mark.parametrize("sync_bn", [False, True])
def test_batchnorm_buffer_modes(world, sync_bn):
    """Per-rank running statistics by default (the model takes rank 0's),
    averaged over the ranks with sync_batch_norm; both train."""
    out = world.run(jobs.bn_buffer_modes, sync_bn)
    for o in out:
        assert o["finite"] and o["same_on_every_rank"]
        assert o["accuracy"] > 0.8, o


def test_sync_bn_forward_and_gradient_match_jax(world, mesh4):
    rs = np.random.RandomState(4)
    x = (rs.randn(16, 6) * 2 + 1).astype(np.float32)
    w_out = rs.randn(16, 6).astype(np.float32)
    weight = rs.rand(6).astype(np.float32) + 0.5
    bias = rs.randn(6).astype(np.float32)
    bn = jnn.BatchNormalization(6, global_stats_axis="data")
    from bigdl_tpu.nn.module import pure_apply

    apply_fn = pure_apply(bn)
    params = {"~params": {"weight": jnp.asarray(weight),
                          "bias": jnp.asarray(bias)}}
    buffers = bn.buffers_dict()

    def loss(p, xx):
        def body(p, xx, ww):
            out, nb = apply_fn(p, buffers, xx, rng=None, training=True)
            return jnp.sum(out * ww)[None], out, nb
        s, out, nb = jax.shard_map(
            body, mesh=mesh4, in_specs=(P(), P("data"), P("data")),
            out_specs=(P("data"), P("data"), P()), check_vma=False)(
                p, xx, jnp.asarray(w_out))
        return jnp.sum(s), (out, nb)

    (_, (out, nb)), (dp, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    got = world.run(jobs.sync_bn_forward_and_grad, x, w_out, weight, bias)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got]),
                               np.asarray(out), **tol)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got]),
                               np.asarray(dx), **tol)
    for g in got:
        # each rank's affine gradient is its own rows' share; their sum is
        # the JAX gradient of the whole batch
        assert np.all(np.isfinite(g["dweight"]))
        np.testing.assert_allclose(g["running_mean"],
                                   np.asarray(nb["~buffers"]["running_mean"]),
                                   **tol)
        np.testing.assert_allclose(g["running_var"],
                                   np.asarray(nb["~buffers"]["running_var"]),
                                   **tol)
    np.testing.assert_allclose(sum(g["dweight"] for g in got),
                               np.asarray(dp["~params"]["weight"]), **tol)
    np.testing.assert_allclose(sum(g["dbias"] for g in got),
                               np.asarray(dp["~params"]["bias"]), **tol)


def test_log_interval_reads_the_loss_every_n_iterations(world):
    for reads, acc in world.run(jobs.log_interval_reads):
        assert reads == 4          # iterations 5, 10, 15, 20 of 21
        assert acc > 0.9


def test_retry_restores_from_checkpoint(world, tmp_path):
    out = world.run(jobs.retry_from_checkpoint, str(tmp_path))
    for o in out:
        assert o["fired"] and o["neval"] >= 30
        assert o["accuracy"] > 0.9
        assert any(f.startswith("optimSlots.") for f in o["files"])


def test_retry_gives_up_after_max_retries(world, tmp_path):
    for msg, calls in world.run(jobs.retry_gives_up, str(tmp_path)):
        assert msg == "persistent failure"
        assert calls == 3           # the first failure and 2 retries


def test_failure_without_checkpoint_propagates(world):
    assert world.run(jobs.failure_without_checkpoint) == ["boom"] * N


def test_config_property_tiers(monkeypatch):
    for prop in ("bigdl.failure.retryTimes", "bigdl.log.interval",
                 "bigdl.Parameter.syncPoolSize"):
        assert tconfig.to_env_name(prop) == jconfig.to_env_name(prop)
    assert tconfig.DEFAULTS == jconfig.DEFAULTS
    assert tconfig.get_int("bigdl.failure.retryTimes", 0) == 5
    monkeypatch.setenv("BIGDL_TPU_FAILURE_RETRY_TIMES", "9")
    assert tconfig.get_int("bigdl.failure.retryTimes", 0) == 9
    tconfig.set_property("bigdl.failure.retryTimes", 2)
    assert tconfig.get_int("bigdl.failure.retryTimes", 0) == 2
    tconfig.clear_property("bigdl.failure.retryTimes")
    assert tconfig.get_int("bigdl.failure.retryTimes", 0) == 9
    monkeypatch.setenv("BIGDL_TPU_LOG_INTERVAL", "yes")
    assert tconfig.get_bool("bigdl.log.interval") is True
    assert tconfig.get_float("bigdl.failure.retryTimeInterval") == 120.0


def test_factory_on_a_sharded_dataset(world):
    for r, (kind, shard, shards, neval) in enumerate(
            world.run(jobs.factory_on_sharded_dataset)):
        assert (kind, shard, shards, neval) == ("DistriOptimizer", r, N, 3)


@pytest.mark.parametrize("mode", ["local", "sharded"])
def test_shards_are_disjoint(world, mode):
    shards = world.run(jobs.first_batch_ids, mode)
    assert all(len(s) == 8 // N for s in shards)
    ids = [i for s in shards for i in s]
    assert len(set(ids)) == len(ids), shards


@pytest.mark.parametrize("kind,match", [("prebatched", "identical batches"),
                                        ("mismatched", "sharded 1-way")])
def test_datasets_a_distributed_run_refuses(world, kind, match):
    for msg in world.run(jobs.bad_dataset_raises, kind):
        assert msg is not None and match in msg


def test_dropout_masks_differ_per_rank(world):
    masks = world.run(jobs.dropout_masks)
    assert all(0 < m.mean() < 1 for m in masks)
    assert len({m.tobytes() for m in masks}) == N


def test_engine_mesh_and_world_of_one():
    """Without a process group the world is one rank: the default mesh
    has one ``data`` rank, its groups are None, collectives are the
    identity, the factory gives a DistriOptimizer on a ShardedDataSet,
    and an entry point asked for the card raises without one."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.optim import Optimizer
    from bigdl_tpu_torch.parallel import collectives as C

    mesh = Engine.create_mesh()
    assert mesh.shape == {"data": 1} and mesh.group("data") is None
    assert mesh.size(("data",)) == 1 and mesh.index("data") == 0
    with pytest.raises(ValueError, match="do not cover"):
        Engine.create_mesh([("data", 2)])
    x = torch.arange(4.0)
    assert C.transport(None, x) == "local"
    assert torch.equal(C.ppermute(x, None, 1), x)
    assert torch.equal(C.all_to_all(x, None), x)
    assert Engine.node_number() == 1 and Engine.total_devices() == 1
    assert Engine.compute_dtype() in (torch.float32, torch.bfloat16)
    samples = [Sample(np.zeros(3, np.float32), 1.0) for _ in range(4)]
    opt = Optimizer(model=nn.Linear(3, 2, device="cpu"),
                    dataset=DataSet.sharded(samples),
                    criterion=nn.ClassNLLCriterion(), batch_size=2)
    assert isinstance(opt, DistriOptimizer)
    with pytest.raises(NotImplementedError, match="accumulation"):
        opt.set_gradient_accumulation(2)
    # the sharded slot format (utils/sharded_ckpt.py) is this
    # optimizer's orbax backend
    assert opt.set_checkpoint("/nonexistent", None,
                              slots_backend="orbax") is opt
    assert opt.checkpoint_slots_backend == "orbax"
    with pytest.raises(ValueError, match="NCCL"):
        Engine.init(device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine.init()
