"""The port's image zoo (bigdl_tpu_torch/models/{vgg,inception,mobilenet,
autoencoder}.py) against the JAX package's, at the full architectures.

Weights and BN statistics are the JAX model's, carried across by the
bridge; every BN first gets a random gamma, beta, mean and variance from
a seed, so that no branch hides behind a trivial normalization. The
Inception pair's JAX weights are drawn by numpy (tests/jax_numpy_init.py:
the JAX package's threefry draws compile a sampler per shape, tens of
seconds for Inception's many). The same numpy images go through both.

Tolerances (f32 on both sides; the convolutions sum in another order
through up to 22 layers):
- eval outputs (log-probabilities; MobileNet's logits; the autoencoder's
  sigmoids): ``|ours - ref| <= 1e-4 * (1 + |ref|)`` per element;
- one SGD step (lr 0.01, the perf harness's), the parameters taken as
  one vector: the new parameters within 1e-4 of the JAX step's in L2
  norm relative to its; the update ``new - old`` within 2e-2 of the JAX
  update, the same way; the loss at rtol 1e-4. A training-mode step at
  a small batch is ill-conditioned (each BN normalizes over few images,
  and a conv bias ahead of a BN has a zero true gradient, so its update
  is rounding noise): against an f64 autograd reference of the same
  step the JAX package's own f32 gradient reads 4.0e-3 (MobileNet,
  batch 2) and 5.9e-4 (VGG CIFAR, batch 8: its head BN normalizes over
  the batch alone, and at batch 2 the step's gradient outgrows the
  parameters) in this norm, the port's 5.3e-3 and 5.9e-4; so the port's
  f32 step is also held to its own f64 step, at least as close to it as
  the JAX package's f32 step is (new parameters, relative L2), or, where
  JAX's is within one f32 epsilon of it (the rounding floor, where the
  order is noise), within two;
- parameter counts equal.

Then the JAX shape tests of tests/test_models.py (the VGG CIFAR forward,
the autoencoder, InceptionV1's (B, 3 * classes) output, MobileNet's
shapes and parameter count, NHWC against NCHW, and MobileNet learning
four samples), run on the port.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.nn.module import tree_leaves
from bigdl_tpu_torch.utils.weights import (load_jax_buffers, load_jax_params,
                                           params_to_numpy)
from tests.jax_numpy_init import numpy_weight_draws, seed_of

EVAL_RTOL = 1e-4
STEP_RTOL = 1e-4
UPDATE_RTOL = 2e-2
LOSS_RTOL = 1e-4
#: f32's machine epsilon: a step this close to the f64 step in relative
#: L2 is at the rounding floor of its f32 storage
F32_EPS = float(np.finfo(np.float32).eps)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port's side: the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize_bn(jm, seed):
    rs = np.random.RandomState(seed)
    for _, m in jm.named_modules():
        if isinstance(m, jnn.BatchNormalization):
            n = m.n_output
            m._set_param("weight", jnp.asarray(rs.uniform(0.5, 1.5, n),
                                               jnp.float32))
            m._set_param("bias", jnp.asarray(0.1 * rs.randn(n), jnp.float32))
            m._set_buffer("running_mean",
                          jnp.asarray(0.1 * rs.randn(n), jnp.float32))
            m._set_buffer("running_var",
                          jnp.asarray(rs.uniform(0.5, 2.0, n), jnp.float32))


# name -> (JAX model, port model, input shape, criterion name, NHWC input)
ZOO = {
    "vgg_cifar": (lambda: jmodels.VggForCifar10(10, has_dropout=False),
                  lambda: tmodels.VggForCifar10(10, has_dropout=False, **CPU),
                  (8, 3, 32, 32), "ClassNLLCriterion", False),
    "vgg16": (lambda: jmodels.Vgg16(1000, has_dropout=False),
              lambda: tmodels.Vgg16(1000, has_dropout=False, **CPU),
              (2, 3, 224, 224), "ClassNLLCriterion", False),
    "inception_v1_noaux": (
        lambda: jmodels.InceptionV1NoAuxClassifier(1000, has_dropout=False),
        lambda: tmodels.InceptionV1NoAuxClassifier(1000, has_dropout=False,
                                                   **CPU),
        (2, 3, 224, 224), "ClassNLLCriterion", False),
    "inception_v1": (lambda: jmodels.InceptionV1(1000, has_dropout=False),
                     lambda: tmodels.InceptionV1(1000, has_dropout=False,
                                                 **CPU),
                     (2, 3, 224, 224), "MSECriterion", False),
    "mobilenet_nchw": (lambda: jmodels.MobileNetV1(1000),
                       lambda: tmodels.MobileNetV1(1000, **CPU),
                       (2, 3, 224, 224), "CrossEntropyCriterion", False),
    "mobilenet_nhwc": (lambda: jmodels.MobileNetV1(1000, format="NHWC"),
                       lambda: tmodels.MobileNetV1(1000, format="NHWC", **CPU),
                       (2, 3, 224, 224), "CrossEntropyCriterion", True),
    "autoencoder": (lambda: jmodels.Autoencoder(32),
                    lambda: tmodels.Autoencoder(32, **CPU),
                    (2, 28, 28), "MSECriterion", False),
}

_BUILT = {}


def _pair(name):
    """(JAX model with random BN state, port twin on its weights), built
    once per module: the JAX package draws large trees slowly."""
    if name not in _BUILT:
        jf, tf = ZOO[name][:2]
        if name.startswith("inception"):
            with numpy_weight_draws(seed_of(name)):
                jm = jf()
        else:
            jm = jf()
        _randomize_bn(jm, seed=len(name))
        tm = tf()
        load_jax_params(tm, _np(jm.params_dict()))
        load_jax_buffers(tm, _np(jm.buffers_dict()))
        _BUILT[name] = (jm, tm)
    return _BUILT[name]


def _input(name, seed):
    shape, nhwc = ZOO[name][2], ZOO[name][4]
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.ascontiguousarray(np.moveaxis(x, 1, -1)) if nhwc else x


def _jax_eval(jm, x):
    fn = jax.jit(lambda p, b, xx: pure_apply(jm)(p, b, xx, training=False)[0])
    return np.asarray(fn(jm.params_dict(), jm.buffers_dict(),
                         jnp.asarray(x)))


def _port_eval(tm, x):
    tm.evaluate()
    with torch.inference_mode():
        return tm(torch.from_numpy(x)).numpy()


def _assert_eval_close(ours, ref, what):
    assert ours.shape == ref.shape, what
    assert np.isfinite(ref).all()
    excess = np.abs(ours - ref) - EVAL_RTOL * (1.0 + np.abs(ref))
    assert excess.max() <= 0, (what, float(np.abs(ours - ref).max()))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_eval_matches_jax(name):
    jm, tm = _pair(name)
    x = _input(name, seed=1)
    ref = _jax_eval(jm, x)
    ours = _port_eval(tm, x)
    if name == "inception_v1":
        # the three heads, each: [main (loss3), aux2 (loss2), aux1 (loss1)]
        for i, head in enumerate(("main", "aux2", "aux1")):
            _assert_eval_close(ours[:, 1000 * i:1000 * (i + 1)],
                               ref[:, 1000 * i:1000 * (i + 1)], head)
    _assert_eval_close(ours, ref, name)


def _targets(name, out_shape, x):
    crit = ZOO[name][3]
    rs = np.random.RandomState(3)
    if crit == "MSECriterion":
        if name == "autoencoder":
            return x.reshape(x.shape[0], -1) / 4.0
        return rs.randn(*out_shape).astype(np.float32) * 0.1
    return rs.randint(1, out_shape[1] + 1, out_shape[0]).astype(np.int64)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_sgd_step_matches_jax(name):
    """One training-mode SGD step (batch statistics in every BN): the
    loss, and each parameter's update."""
    jm, tm = _pair(name)
    crit = ZOO[name][3]
    x = _input(name, seed=2)
    # the output's shape only: traced, not compiled or run
    out_shape = jax.eval_shape(
        lambda p, b, xx: pure_apply(jm)(p, b, xx, training=False)[0],
        jm.params_dict(), jm.buffers_dict(), jnp.asarray(x)).shape
    y = _targets(name, out_shape, x)
    jts = jax_train_step(jm, getattr(jnn, crit)(),
                         jom.SGD(learning_rate=0.01))
    jp, jb = jm.params_dict(), jm.buffers_dict()
    jloss, jp2, _, _ = jax.jit(jts.step)(
        jp, jb, jts.init_slots(jp), jnp.asarray(x),
        jnp.asarray(y.astype(np.int32) if y.dtype == np.int64 else y),
        jts.current_lrs(), jax.random.PRNGKey(0))
    tts = topt.make_train_step(tm, getattr(tnn, crit)(),
                               topt.SGD(learning_rate=0.01))
    tp, tb = tm.params_dict(), tm.buffers_dict()
    before = params_to_numpy(tp)
    tloss, tp2, _, _ = tts.step(tp, tb, tts.init_slots(tp),
                                torch.from_numpy(x), torch.from_numpy(y),
                                tts.current_lrs(), None)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    leaves = list(zip(tree_leaves(params_to_numpy(tp2)),
                      tree_leaves(_np(jp2)), tree_leaves(before)))
    assert len(leaves) == len(tree_leaves(_np(jp)))

    def rel_l2(ours, ref):
        err = np.sqrt(sum(((o - r) ** 2).sum() for o, r in zip(ours, ref)))
        return err / np.sqrt(sum((r ** 2).sum() for r in ref))

    new_t = [o for (_, o), _, _ in leaves]
    new_j = [t for _, (_, t), _ in leaves]
    old = [b for _, _, (_, b) in leaves]
    assert rel_l2(new_t, new_j) <= STEP_RTOL, (name, rel_l2(new_t, new_j))
    d_t = [a - b for a, b in zip(new_t, old)]
    d_j = [a - b for a, b in zip(new_j, old)]
    assert rel_l2(d_t, d_j) <= UPDATE_RTOL, (name, rel_l2(d_t, d_j))
    moved = sum(bool(np.abs(d).max() > 0) for d in d_j)
    assert moved >= len(leaves) // 2, (name, moved, len(leaves))
    # the same step of the port in f64 is the reference both f32 steps
    # are held to: the port's is at least as close to it as JAX's
    tm64 = copy.deepcopy(tm).to(torch.float64)
    tts64 = topt.make_train_step(tm64, getattr(tnn, crit)(),
                                 topt.SGD(learning_rate=0.01))
    tp64, tb64 = tm64.params_dict(), tm64.buffers_dict()
    y64 = y.astype(np.float64) if y.dtype == np.float32 else y
    _, tp64_2, _, _ = tts64.step(tp64, tb64, tts64.init_slots(tp64),
                                 torch.from_numpy(x.astype(np.float64)),
                                 torch.from_numpy(y64),
                                 tts64.current_lrs(), None)
    new_64 = [o for _, o in tree_leaves(params_to_numpy(tp64_2))]
    err_t, err_j = rel_l2(new_t, new_64), rel_l2(new_j, new_64)
    print(f"f64 step: {name} port {err_t:.3e} jax {err_j:.3e}")
    if err_j > F32_EPS:
        assert err_t <= err_j, (name, err_t, err_j)
    else:   # both at f32's rounding floor, where the order is noise
        assert err_t <= 2 * F32_EPS, (name, err_t, err_j)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_parameter_counts_match_jax(name):
    jm, tm = _pair(name)
    n_jax = sum(int(np.prod(a.shape)) for a in
                jax.tree.leaves(jm.params_dict()))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert [n for n, _ in tree_leaves(tm.params_dict())] == \
        [n for n, _ in tree_leaves(_np(jm.params_dict()))]


@pytest.mark.parametrize("name", ["inception_v1", "inception_v1_noaux"])
def test_inception_layer_names_match_jax(name):
    """Every module of the port carries the JAX module's name at the same
    place in the tree (``set_name``)."""
    jm, tm = _pair(name)
    ours = {path: m._name for path, m in tm.named_modules() if path}
    theirs = {path: m._name for path, m in jm.named_modules()
              if m is not jm}
    assert ours == theirs
    # 14 names in each of the nine blocks, and the stem, pools and heads
    assert sum(n is not None for n in ours.values()) > 9 * 14


# the pools inside Inception at the plane sizes it feeds them: the
# stem's and the blocks' ceil-mode 3x3/2 pools (112 -> 56 -> 28 -> 14 ->
# 7), the blocks' ceil-mode 3x3/1 pad-1 pools (56, 28, 14, 7 kept), the
# aux heads' 5x5/3 average pools (14 -> 4, ceil and floor) and pool5
POOLS = {
    "max3s2_112": (lambda m: m.SpatialMaxPooling(3, 3, 2, 2).ceil(), 112),
    "max3s2_56": (lambda m: m.SpatialMaxPooling(3, 3, 2, 2).ceil(), 56),
    "max3s2_28": (lambda m: m.SpatialMaxPooling(3, 3, 2, 2).ceil(), 28),
    "max3s2_14": (lambda m: m.SpatialMaxPooling(3, 3, 2, 2).ceil(), 14),
    "max3s1p1_28": (lambda m: m.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(),
                    28),
    "max3s1p1_7": (lambda m: m.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(), 7),
    "avg5s3_ceil_14": (lambda m: m.SpatialAveragePooling(5, 5, 3, 3).ceil(),
                       14),
    "avg5s3_floor_14": (lambda m: m.SpatialAveragePooling(5, 5, 3, 3), 14),
    "avg7s1_7": (lambda m: m.SpatialAveragePooling(7, 7, 1, 1), 7),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_inception_pools_match_jax_at_its_plane_sizes(case):
    make, hw = POOLS[case]
    jm, tm = make(jnn), make(tnn)
    rs = np.random.RandomState(hw)
    x = rs.randn(2, 3, hw, hw).astype(np.float32)
    fn = pure_apply(jm)
    out, vjp = jax.vjp(lambda xx: fn({}, {}, xx, training=False)[0],
                       jnp.asarray(x))
    g = rs.randn(*out.shape).astype(np.float32)
    (gx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    ot = tm(xt)
    (ot * torch.from_numpy(g)).sum().backward()
    assert tuple(ot.shape) == out.shape
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------ tests/test_models.py, on the port
def test_vgg_cifar_forward():
    m = tmodels.VggForCifar10(10, has_dropout=False, **CPU)
    m.evaluate()
    with torch.no_grad():
        out = m(torch.ones(2, 3, 32, 32))
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out.exp().sum(-1).numpy(), 1.0, rtol=1e-4)


def test_autoencoder_reconstruction_shape():
    m = tmodels.Autoencoder(32, **CPU)
    assert m(torch.ones(5, 28, 28)).shape == (5, 28 * 28)
    # the graph form: on the JAX graph form's weights, its forward and
    # gradients are the JAX graph's, and it equals the Sequential form
    from tests.test_torch_graph import like_jax

    jg = jmodels.Autoencoder.graph(32)
    g = tmodels.Autoencoder.graph(32, **CPU)
    x = np.random.RandomState(3).rand(5, 28, 28).astype(np.float32)
    out = like_jax(jg, g, x)[0]
    assert out.shape == (5, 28 * 28)
    linears = [n.module for n in g._topo if isinstance(n.module, tnn.Linear)]
    for lin, ours in zip(linears, [m[1], m[3]]):
        ours.load_params_dict(lin.params_dict())
    np.testing.assert_allclose(m(torch.tensor(x)).detach().numpy(),
                               out.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_inception_aux_heads():
    m = tmodels.InceptionV1(12, has_dropout=False, **CPU)
    with torch.no_grad():
        out = m(torch.ones(2, 3, 224, 224))
    assert out.shape == (2, 36)


def test_mobilenet_v1_shapes_and_param_count():
    m = tmodels.MobileNetV1(1000, **CPU)
    m.evaluate()
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 224, 224)
                         .astype(np.float32))
    with torch.no_grad():
        assert m(x).shape == (1, 1000)
    n_params = sum(p.numel() for p in m.parameters())
    assert 3.9e6 < n_params < 4.6e6, n_params


def test_mobilenet_v1_nhwc_matches_nchw():
    """Same seed, same weights (the NHWC convolutions keep the OIHW
    shape); the NHWC model takes the images transposed."""
    m_nchw = tmodels.MobileNetV1(10, width=0.25, seed=0, **CPU)
    m_nhwc = tmodels.MobileNetV1(10, width=0.25, format="NHWC", seed=0,
                                 **CPU)
    for (n, a), (_, b) in zip(tree_leaves(m_nchw.params_dict()),
                              tree_leaves(m_nhwc.params_dict())):
        assert torch.equal(a, b), n
    m_nchw.evaluate()
    m_nhwc.evaluate()
    x = np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        a = m_nchw(torch.from_numpy(x)).numpy()
        b = m_nhwc(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 2, 3, 1)))).numpy()
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_mobilenet_v1_trains():
    m = tmodels.MobileNetV1(4, width=0.25, seed=1, **CPU)
    ts = topt.make_train_step(m, tnn.CrossEntropyCriterion(),
                              topt.SGD(learning_rate=0.1))
    params, buffers = m.params_dict(), m.buffers_dict()
    slots = ts.init_slots(params)
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 3, 64, 64)
                         .astype(np.float32))
    y = torch.tensor([1.0, 2.0, 3.0, 4.0])
    for _ in range(15):
        loss, params, buffers, slots = ts.step(params, buffers, slots, x, y,
                                               ts.current_lrs(), None)
    assert float(loss) < 0.5, float(loss)


# ------------------------------------------------------------ optim/ema.py
def test_ema_matches_jax_bit_for_bit():
    """Five updates of an f32 tree (with an int leaf, which takes the new
    value) give the JAX EMA's shadow exactly; ``swap`` loads it."""
    from bigdl_tpu.optim.ema import EMA as JaxEMA
    from bigdl_tpu_torch.optim import EMA

    model = tmodels.LeNet5(10, **CPU)
    rs = np.random.RandomState(0)

    def random_like(tree):
        return {k: (random_like(v) if isinstance(v, dict)
                    else rs.randn(*v.shape).astype(np.float32))
                for k, v in tree.items()}

    trees = [random_like(params_to_numpy(model)) for _ in range(6)]

    def as_torch(tree):
        return {k: (as_torch(v) if isinstance(v, dict)
                    else torch.from_numpy(np.array(v)))
                for k, v in tree.items()}

    ours = EMA.init(as_torch(trees[0]), decay=0.9)
    theirs = JaxEMA.init(jax.tree.map(jnp.asarray, trees[0]), decay=0.9)
    for tree in trees[1:]:
        ours = ours.update(as_torch(tree))
        theirs = theirs.update(jax.tree.map(jnp.asarray, tree))
    assert ours.step == theirs.step == 5
    for (name, a), (_, b) in zip(tree_leaves(ours.shadow),
                                 tree_leaves(_np(theirs.shadow))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    counter = EMA({"n": torch.tensor(3)}).update({"n": torch.tensor(7)})
    assert int(counter.shadow["n"]) == 7
    ours.swap(model)
    for (name, a), (_, b) in zip(tree_leaves(model.params_dict()),
                                 tree_leaves(ours.shadow)):
        assert torch.equal(a.detach(), b), name
