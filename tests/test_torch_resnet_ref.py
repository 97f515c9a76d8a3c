"""The raw-torch ResNet-50 step (bigdl_tpu_torch/models/torch_resnet_ref.py)
against the raw-JAX one (bigdl_tpu/models/jax_resnet_ref.py), the
denominator of ``bench.py``'s ``vs_baseline``: the JAX ``init_params``
list carried across (``resnet_ref_params_from_jax``) gives the same
layout program, the same forward and the same two SGD-momentum steps on
2 x 32 x 32 x 3 f32 images, and on 2 x 64 x 64 x 3 with random BN
affines (rel 1e-4; the measured logit errors are 3.4e-6 and 1.8e-6), and
``run_ref_perf`` returns the JAX keys. The JAX ``make_step`` fixes bf16 compute, so the f32
reference step here is its loss and update written over the JAX
``forward`` in f32.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import jax_resnet_ref as J
from bigdl_tpu_torch.models import torch_resnet_ref as T
from bigdl_tpu_torch.utils.weights import resnet_ref_params_from_jax

RTOL = 1e-4
LR, MOMENTUM = 0.01, 0.9


@pytest.fixture(scope="module")
def carried():
    """The JAX ``init_params(PRNGKey(0))`` list as numpy, and the layout."""
    params, layout = J.init_params(jax.random.PRNGKey(0))
    return [np.asarray(p) for p in params], layout


def _random_bn(arrays):
    """Every BN gamma and beta (the bottlenecks' zero gammas included)
    drawn at random, so that every branch counts."""
    rs = np.random.RandomState(1)
    last = len(arrays) - 1
    return [a if a.ndim != 1 or i == last
            else (1.0 + 0.5 * rs.randn(*a.shape)).astype(np.float32)
            for i, a in enumerate(arrays)]


def _rel(ours, ref):
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_init_params_give_the_jax_layout_and_shapes(carried):
    arrays, layout = carried
    params, ours = T.init_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    assert ours == layout
    carried_t = resnet_ref_params_from_jax(arrays, device="cpu")
    assert [tuple(p.shape) for p in params] == \
        [tuple(p.shape) for p in carried_t]
    for a, t in zip(arrays, carried_t):
        if a.ndim == 4:       # HWIO -> OIHW, stored channels-last
            assert t.is_contiguous(memory_format=torch.channels_last)
            np.testing.assert_array_equal(t.numpy(),
                                          a.transpose(3, 2, 0, 1))
    # the twin's own draws: He normal, zero third gammas, a 0.01 head
    w0 = params[0]
    assert abs(float(w0.std()) - (2.0 / (7 * 7 * 3)) ** 0.5) < 0.01
    assert float(params[-2].std()) == pytest.approx(0.01, rel=0.05)


@pytest.mark.parametrize("bn,size", [("init", 32), ("random", 64)])
def test_forward_matches_jax_in_f32(carried, bn, size):
    """The JAX init at 32 x 32, and random BN affines at 64 x 64 (at 32 x
    32 the last stage's BN normalizes two values a channel, which turns
    f32 rounding into 1e-3-sized differences once every branch counts)."""
    arrays, layout = carried
    if bn == "random":
        arrays = _random_bn(arrays)
    x = np.random.RandomState(2).randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: J.forward(p, layout, v))(
        [jnp.asarray(a) for a in arrays], jnp.asarray(x)))
    got = T.forward(resnet_ref_params_from_jax(arrays, device="cpu"),
                    layout, torch.from_numpy(x))
    assert got.shape == (2, 1000)
    assert _rel(got.detach().numpy(), want) < RTOL


def test_two_steps_match_jax(carried):
    """Two SGD-momentum steps from the JAX init on 2 x 32 x 32 x 3 images
    (the first moves the zero gammas, so the second reaches every
    branch), in f64 on both sides: in f32 the JAX step is itself 3.9e-4
    (max, per leaf) from its f64 result at this size, the port's 5.5e-4,
    so f32 cannot resolve rel 1e-4."""
    arrays, layout = carried
    arrays = [a.astype(np.float64) for a in arrays]
    rs = np.random.RandomState(3)
    x = rs.randn(2, 32, 32, 3)
    y = np.array([3, 997])

    def loss_fn(params, x, y):
        logits = J.forward(params, layout, x)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    def jax_step(params, vel, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        vel = [MOMENTUM * v + g for v, g in zip(vel, grads)]
        params = [w - LR * v for w, v in zip(params, vel)]
        return loss, params, vel

    step = T.make_step(layout, LR, MOMENTUM, compute_dtype=torch.float64)
    tp = [p.double() for p in resnet_ref_params_from_jax(arrays,
                                                         device="cpu")]
    tv = [torch.zeros_like(p) for p in tp]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with jax.enable_x64(True):
        jstep = jax.jit(jax_step)
        jp = [jnp.asarray(a) for a in arrays]
        jv = [jnp.zeros_like(a) for a in jp]
        for _ in range(2):
            t_loss, tp, tv = step(tp, tv, xt, yt)
            j_loss, jp_new, jv = jstep(jp, jv, jnp.asarray(x),
                                       jnp.asarray(y))
            assert abs(float(t_loss) - float(j_loss)) <= RTOL * abs(
                float(j_loss))
            for i, (ours, new, old) in enumerate(zip(tp, jp_new, jp)):
                ref, old = np.asarray(new), np.asarray(old)
                got = ours.numpy()
                if got.ndim == 4:
                    got = got.transpose(2, 3, 1, 0)
                assert _rel(got - old, ref - old) < RTOL, i
            jp = jp_new
    assert all(not p.requires_grad for p in tp)


def _jax_keys():
    """The keys of the JAX ``run_ref_perf`` result, read from its
    source (running it compiles a ResNet-50 at 224 x 224)."""
    tree = ast.parse(inspect.getsource(J.run_ref_perf))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and node.targets[0].id == "out"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in jax_resnet_ref.run_ref_perf")


def test_run_ref_perf_returns_the_jax_keys():
    out = T.run_ref_perf(batch_size=2, iterations=1, warmup=1, image=32,
                         device="cpu", log=lambda *a: None)
    assert set(out) == _jax_keys() | {"device", "timer"}
    assert out["device"] == "cpu" and out["timer"] == "host_clock"
    assert out["records_per_sec"] > 0 and np.isfinite(out["loss"])
    assert out["batch_size"] == 2 and out["iterations"] == 1
