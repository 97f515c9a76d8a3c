"""The port's vision models (bigdl_tpu_torch/models/{resnet,lenet}) and
its train step on a model with buffers, against the JAX package's.

Weights and BatchNorm statistics are the JAX model's, carried across by
the bridge (``load_jax_params`` / ``load_jax_buffers``). Every BN first
gets a random gamma, beta, running mean and running variance from a
seed: the zero gamma of each bottleneck's last BN would otherwise make
every residual branch output 0 and hide its convolutions.

Tolerances (f32 on both sides; sums run in another order through up to
50 layers): eval logits within 1e-4 of the largest |logit|; one train
step's loss at rtol 1e-5, and each new parameter and running statistic
at rtol 1e-4 and an atol of 1e-4 of the largest |value| of its leaf,
at least 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.models.resnet import DatasetType
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.models import LeNet5, ResNet
from bigdl_tpu_torch.nn import CrossEntropyCriterion, Module
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.utils.weights import (buffers_to_numpy,
                                           load_jax_buffers, load_jax_params,
                                           params_to_numpy)

LOGIT_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port's ResNet math: the suite runs
    several test processes side by side, and a ResNet-50 on every core
    starves the timing-sensitive tests of the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize_bn(jm, seed):
    """Random gamma, beta, running mean and variance in every BN of the
    JAX model ``jm``; gamma small enough that 16 residual blocks keep
    the logits of order 1-100."""
    rs = np.random.RandomState(seed)
    for _, m in jm.named_modules():
        if isinstance(m, jnn.SpatialBatchNormalization):
            n = m.n_output
            m._set_param("weight", jnp.asarray(rs.uniform(0.1, 0.5, n),
                                               jnp.float32))
            m._set_param("bias", jnp.asarray(0.1 * rs.randn(n), jnp.float32))
            m._set_buffer("running_mean",
                          jnp.asarray(0.1 * rs.randn(n), jnp.float32))
            m._set_buffer("running_var",
                          jnp.asarray(rs.uniform(0.5, 2.0, n), jnp.float32))


def _port_twin(jm, cls_args, **kw):
    tm = ResNet(*cls_args, device="cpu", **kw)
    load_jax_params(tm, _np(jm.params_dict()))
    load_jax_buffers(tm, _np(jm.buffers_dict()))
    return tm


def _jax_eval(jm, x):
    fn = jax.jit(lambda p, b, xx: pure_apply(jm)(p, b, xx, training=False)[0])
    return np.asarray(fn(jm.params_dict(), jm.buffers_dict(),
                         jnp.asarray(x)))


def _port_eval(tm, x):
    tm.evaluate()
    with torch.inference_mode():
        return tm(torch.from_numpy(x)).numpy()


def _assert_logits_close(ours, ref):
    assert ours.shape == ref.shape
    assert np.isfinite(ref).all() and np.abs(ref).max() > 1e-2
    rel = np.abs(ours - ref).max() / np.abs(ref).max()
    assert rel <= LOGIT_RTOL, rel


def _images(batch, hw, seed, fmt="NCHW"):
    x = np.random.RandomState(seed).randn(batch, 3, hw, hw).astype(np.float32)
    return np.ascontiguousarray(np.moveaxis(x, 1, -1)) if fmt == "NHWC" else x


def _nhwc(x):
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


@pytest.fixture(scope="module")
def jax_resnet50():
    """ImageNet ResNet-50 (NCHW) with random BN state; built once, as the
    JAX package draws its 25 M weights slowly on the CPU."""
    jm = JaxResNet(1000, {"depth": 50, "dataSet": DatasetType.ImageNet})
    _randomize_bn(jm, seed=50)
    return jm


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet50_eval_matches_jax(jax_resnet50, fmt):
    """Both formats of the port against the JAX NCHW model on the same
    weights and images (the NHWC port takes the images transposed)."""
    jm = jax_resnet50
    tm = _port_twin(jm, (1000, {"depth": 50, "dataSet": DatasetType.ImageNet,
                                "format": fmt}))
    assert len(tree_leaves(tm.buffers_dict())) == 2 * 53
    x = _images(2, 224, seed=1)
    ref = _jax_eval(jm, x)
    ours = _port_eval(tm, _nhwc(x) if fmt == "NHWC" else x)
    _assert_logits_close(ours, ref)


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_resnet18_eval_matches_jax_nhwc(fmt):
    jm = JaxResNet(1000, {"depth": 18, "dataSet": DatasetType.ImageNet,
                          "format": "NHWC"})
    _randomize_bn(jm, seed=18)
    tm = _port_twin(jm, (1000, {"depth": 18, "dataSet": DatasetType.ImageNet,
                                "format": fmt}))
    x = _images(2, 224, seed=2, fmt="NHWC")
    ref = _jax_eval(jm, x)
    ours = _port_eval(tm, x if fmt == "NHWC" else
                      np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    _assert_logits_close(ours, ref)


CIFAR20 = (10, {"depth": 20, "dataSet": DatasetType.CIFAR10,
                "shortcutType": "A"})


def _cifar20(fmt="NCHW", seed=20):
    cfg = (CIFAR20[0], {**CIFAR20[1], "format": fmt})
    jm = JaxResNet(*cfg)
    _randomize_bn(jm, seed=seed)
    return jm, cfg


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_cifar_resnet20_shortcut_a_eval_matches_jax(fmt):
    jm, cfg = _cifar20(fmt)
    tm = _port_twin(jm, cfg)
    kinds = {type(m).__name__ for m in tm.modules()}
    assert {"Concat", "MulConstant", "SpatialAveragePooling"} <= kinds
    x = _images(4, 32, seed=3, fmt=fmt)
    _assert_logits_close(_port_eval(tm, x), _jax_eval(jm, x))


def test_lenet5_matches_jax():
    jm = JaxLeNet5(10)
    tm = LeNet5(10, device="cpu")
    load_jax_params(tm, _np(jm.params_dict()))
    assert [n for n, _ in tree_leaves(tm.params_dict())][:2] == \
        ["m1.bias", "m1.weight"]
    x = np.random.RandomState(4).randn(5, 784).astype(np.float32)
    ref = np.asarray(jm(jnp.asarray(x)))
    ours = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    # one image, no batch: the Reshape and the convolutions infer it
    one = tm(torch.from_numpy(x[0])).detach().numpy()
    ref_one = np.asarray(jm(jnp.asarray(x[0])))
    assert one.shape == ref_one.shape
    np.testing.assert_allclose(one, ref_one, rtol=1e-5, atol=1e-5)


def _leaf_close(ours, theirs, name):
    """rtol 1e-4, atol 1e-4 of the leaf's largest |value|, and never below
    1e-7: a conv bias ahead of a BN has a zero data gradient, so after
    one step it holds only rounding noise of order 1e-9."""
    atol = max(1e-4 * np.abs(theirs).max(), 1e-7)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_threads_batch_norm_buffers_as_jax(grad_accum):
    """One SGD step of CIFAR ResNet-20 (shortcut A, L2(1e-4) on every
    conv): the loss, the new parameters and the new running statistics
    equal the JAX step's; under ``grad_accum`` 2 the second micro-batch
    starts from the first's statistics."""
    jm, cfg = _cifar20()
    tm = _port_twin(jm, cfg)
    x = _images(4, 32, seed=5)
    y = np.array([1, 3, 10, 7], np.int32)
    jts = jax_train_step(jm, jnn.CrossEntropyCriterion(),
                         jom.SGD(learning_rate=0.1), grad_accum=grad_accum)
    jp, jb = jm.params_dict(), jm.buffers_dict()
    jloss, jp2, jb2, _ = jax.jit(jts.step)(
        jp, jb, jts.init_slots(jp), jnp.asarray(x), jnp.asarray(y),
        jts.current_lrs(), jax.random.PRNGKey(0))
    tts = topt.make_train_step(tm, CrossEntropyCriterion(),
                               topt.SGD(learning_rate=0.1),
                               grad_accum=grad_accum)
    tp, tb = tm.params_dict(), tm.buffers_dict()
    before = buffers_to_numpy(tb)
    tloss, tp2, tb2, _ = tts.step(tp, tb, tts.init_slots(tp),
                                  torch.from_numpy(x), torch.from_numpy(y),
                                  tts.current_lrs(), None)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for (name, ours), (_, theirs) in zip(
            tree_leaves(params_to_numpy(tp2)), tree_leaves(_np(jp2))):
        _leaf_close(ours, theirs, name)
    new = buffers_to_numpy(tb2)
    for (name, ours), (_, theirs), (_, old) in zip(
            tree_leaves(new), tree_leaves(_np(jb2)), tree_leaves(before)):
        _leaf_close(ours, theirs, name)
        assert ours.dtype == np.float32
        assert not np.allclose(ours, old), name   # the statistics moved
    # the step's inputs and the model are left as they were
    for (name, now), (_, old) in zip(tree_leaves(buffers_to_numpy(tm)),
                                     tree_leaves(before)):
        np.testing.assert_array_equal(now, old, err_msg=name)


def test_train_step_bf16_compute_keeps_f32_statistics():
    jm, cfg = _cifar20()
    tm = _port_twin(jm, cfg)
    tts = topt.make_train_step(tm, CrossEntropyCriterion(),
                               topt.SGD(learning_rate=0.1),
                               compute_dtype=torch.bfloat16)
    tp, tb = tm.params_dict(), tm.buffers_dict()
    x = torch.from_numpy(_images(2, 32, seed=6)).to(torch.bfloat16)
    _, tp2, tb2, _ = tts.step(tp, tb, tts.init_slots(tp), x,
                              torch.tensor([2, 5]), tts.current_lrs(), None)
    assert all(v.dtype == torch.float32 for _, v in tree_leaves(tb2))
    assert all(v.dtype == torch.float32 for _, v in tree_leaves(tp2))
    moved = [not torch.equal(a, b) for (_, a), (_, b) in
             zip(tree_leaves(tb2), tree_leaves(tb))]
    assert all(moved)


def test_module_loads_params_and_buffers_in_place():
    jm, cfg = _cifar20()
    tm = _port_twin(jm, cfg)
    other = ResNet(*cfg, seed=7, device="cpu")
    ids = [id(p) for p in other.parameters()]
    other.load_params_dict(tm.params_dict())
    other.load_buffers_dict(tm.buffers_dict())
    assert [id(p) for p in other.parameters()] == ids
    for a, b in ((tm.params_dict(), other.params_dict()),
                 (tm.buffers_dict(), other.buffers_dict())):
        for (n, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y), n
    assert isinstance(other, Module)


def test_run_perf_summary_on_the_cpu():
    """The run_perf twin on the CPU at a small size: the JAX summary's
    keys, finite losses of every step, bf16 over f32 masters for a
    ResNet (the model's own parameters untouched), params stored in
    dtype otherwise, and a refusal that names the roadmap for the models
    not ported yet."""
    from bigdl_tpu_torch.models.perf import build_model, run_perf

    quiet = dict(log=lambda *_: None, device="cpu")
    s = run_perf("lenet5", batch_size=8, iterations=2, warmup=1, **quiet)
    assert {"model", "batch_size", "iterations", "warmup_s", "time_s",
            "records_per_sec", "ms_per_iter", "loss"} <= set(s)
    assert s["timer"] == "host_clock" and len(s["losses"]) == 3
    model, shape, classes = build_model("resnet18", 10, format="NHWC",
                                        device="cpu")
    assert shape == (224, 224, 3) and classes == 10
    w0 = model.m0.weight.detach().clone()
    s = run_perf("resnet18", batch_size=2, iterations=1, warmup=1,
                 dtype=torch.bfloat16, model=model, input_shape=shape,
                 master_f32=True, **quiet)
    assert all(np.isfinite(s["losses"])) and s["model"] == "resnet18"
    assert torch.equal(model.m0.weight, w0)
    with pytest.raises(ValueError, match="ROADMAP"):
        build_model("vgg16", device="cpu")
