"""The port's eager Module API (bigdl_tpu_torch/nn/module.py) against the
JAX package's (bigdl_tpu/nn/module.py:165-517): the verify recipe's
eager loop (forward, criterion backward, ``backward``,
``update_parameters``) for five steps, gradients accumulating over two
``backward`` calls until ``zero_grad_parameters``, ``get_parameters``
as a flat copy, ``grads_dict`` / ``load_grads_dict``,
``update_grad_input``, the Dropout mask replayed in ``backward``,
buffers left as the forward set them, ``clone_module``,
``copy_parameters_from``, ``save`` / ``load``, and the inference
helpers ``predict`` / ``predict_class`` / ``evaluate_on`` against the
JAX ``LocalPredictor``.

Tolerance: f32 at rtol 1e-5 / atol 1e-6 (the same sums in another
order, compounded over five steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair():
    from bigdl_tpu.utils import random as rnd

    rnd.set_seed(7)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 2),
                        jnn.LogSoftMax())
    tm = tnn.Sequential(tnn.Linear(4, 8, device="cpu"), tnn.Tanh(),
                        tnn.Linear(8, 2, device="cpu"), tnn.LogSoftMax())
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    return jm, tm


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(8, 4).astype(np.float32),
            rs.randint(1, 3, 8).astype(np.float32))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_eager_recipe_five_steps_matches_jax():
    """The verify recipe: zero, forward, criterion, backward, update."""
    jm, tm = _pair()
    jc, tc = jnn.ClassNLLCriterion(), tnn.ClassNLLCriterion()
    x, y = _data()
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), \
        torch.tensor(y)
    for _ in range(5):
        jm.zero_grad_parameters()
        tm.zero_grad_parameters()
        jo, to = jm(jx), tm(tx)
        _close(tc(to, ty), jc(jo, jy))
        jg = jm.backward(jx, jc.backward(jo, jy))
        tg = tm.backward(tx, tc.backward(to, ty))
        _close(tg, jg)
        jm.update_parameters(0.1)
        tm.update_parameters(0.1)
    jw, jgr = jm.get_parameters()
    tw, tgr = tm.get_parameters()
    _close(tw, jw)
    _close(tgr, jgr)


def test_grads_accumulate_until_zeroed():
    jm, tm = _pair()
    x, _ = _data(1)
    g = np.random.RandomState(2).randn(8, 2).astype(np.float32)
    for _ in range(2):
        jm.backward(jnp.asarray(x), jnp.asarray(g))
        tm.backward(torch.tensor(x), torch.tensor(g))
    _, jg = jm.get_parameters()
    _, tg = tm.get_parameters()
    _close(tg, jg)
    once = Module.get_parameters(_pair()[1])[1]
    assert torch.equal(once, torch.zeros_like(once))
    fresh = _pair()[1]
    fresh.backward(torch.tensor(x), torch.tensor(g))
    torch.testing.assert_close(tg, 2 * fresh.get_parameters()[1])
    tm.zero_grad_parameters()
    assert not tm.get_parameters()[1].any()
    # update_grad_input: gradInput only, nothing accumulated
    gi = tm.update_grad_input(torch.tensor(x), torch.tensor(g))
    _close(gi, jm.update_grad_input(jnp.asarray(x), jnp.asarray(g)))
    assert not tm.get_parameters()[1].any()


def test_parameters_and_flat_copy():
    jm, tm = _pair()
    ws, gs = tm.parameters_and_grads()
    jws, jgs = jm.parameters()
    assert len(ws) == len(jws) == 4 and len(gs) == 4
    for w, jw in zip(ws, jws):
        _close(w, jw)
    flat, _ = tm.get_parameters()
    flat += 1.0                    # a copy: the model does not move
    _close(tm.get_parameters()[0], jm.get_parameters()[0])


def test_grads_dict_roundtrip():
    jm, tm = _pair()
    x, _ = _data(3)
    g = np.ones((8, 2), np.float32)
    tm.backward(torch.tensor(x), torch.tensor(g))
    jm.backward(jnp.asarray(x), jnp.asarray(g))
    from bigdl_tpu_torch.nn.module import tree_leaves

    tl = tree_leaves(tm.grads_dict())
    jl = jax.tree.leaves(jm.grads_dict())
    assert len(tl) == len(jl)
    for (_, a), b in zip(tl, jl):
        _close(a, b)
    other = _pair()[1]
    other.load_grads_dict(tm.grads_dict())
    assert torch.equal(other.get_parameters()[1], tm.get_parameters()[1])


def _dropout_net():
    torch.manual_seed(0)
    return tnn.Sequential(tnn.Linear(6, 16, device="cpu"), tnn.Tanh(),
                          tnn.Dropout(0.5), tnn.Linear(16, 3, device="cpu"))


@pytest.mark.parametrize("generator", [False, True],
                         ids=["default_generator", "bound_generator"])
def test_backward_replays_the_forward_dropout_mask(generator):
    """backward recomputes the forward from the generator states of the
    last call, so the Dropout mask is the forward's: the gradients equal
    autograd through the forward's own graph. The caller's forward ran
    under no_grad, and the stream goes on as if no replay had run."""
    x = torch.randn(5, 6, generator=torch.Generator().manual_seed(1))
    g = torch.randn(5, 3, generator=torch.Generator().manual_seed(2))

    def build():
        net = _dropout_net()
        gen = torch.Generator().manual_seed(3) if generator else None
        tnn.bind_generator(net, gen)
        torch.manual_seed(11)
        return net, gen

    ref, _ = build()
    xr = x.clone().requires_grad_(True)
    out_ref = ref(xr)
    want = torch.autograd.grad(out_ref, [xr] + list(ref.parameters()), g)
    net, gen = build()
    with torch.no_grad():
        out = net(x)
    assert torch.equal(out, out_ref.detach())
    stream = (gen.get_state() if generator else torch.get_rng_state())
    gi = net.backward(x, g)
    assert torch.equal(gen.get_state() if generator
                       else torch.get_rng_state(), stream)
    torch.testing.assert_close(gi, want[0], rtol=0, atol=0)
    for p, w in zip(net.parameters(), want[1:]):
        torch.testing.assert_close(p.grad, w, rtol=0, atol=0)


def test_backward_leaves_the_forward_buffers():
    """A training-mode BatchNorm's recompute in backward does not move
    its running statistics a second time."""
    torch.manual_seed(0)
    net = tnn.Sequential(tnn.Linear(4, 6, device="cpu"),
                         tnn.BatchNormalization(6, device="cpu"))
    x = torch.randn(8, 4)
    net(x)
    stats = [b.clone() for b in net.buffers()]
    net.backward(x, torch.ones(8, 6))
    assert all(torch.equal(a, b) for a, b in zip(stats, net.buffers()))


def test_clone_copy_save_load(tmp_path):
    _, tm = _pair()
    x, _ = _data(4)
    tx = torch.tensor(x)
    clone = tm.clone_module()
    assert clone is not tm and torch.equal(clone(tx), tm(tx))
    other = _pair()[1]
    with torch.no_grad():
        for p in other.parameters():
            p.add_(1.0)
    other.copy_parameters_from(tm)
    assert torch.equal(other(tx), tm(tx))
    tm.backward(tx, torch.ones(8, 2))
    path = str(tmp_path / "m.bigdl")
    tm.save(path)
    with pytest.raises(FileExistsError):
        tm.save(path)
    back = Module.load(path, device="cpu")
    assert type(back) is type(tm) and torch.equal(back(tx), tm(tx))
    assert torch.equal(back.get_parameters()[1], tm.get_parameters()[1])
    proto = str(tmp_path / "m.proto")
    assert tm.save_module(proto) is tm
    with pytest.raises(FileExistsError):
        tm.save_module(proto)
    back = Module.load_module(proto, device="cpu")
    assert type(back) is type(tm) and torch.equal(back(tx), tm(tx))
    for (n, a), (_, b) in zip(back.named_parameters(), tm.named_parameters()):
        assert torch.equal(a, b) and a.requires_grad, n
    with pytest.raises(NotImplementedError, match="item 12"):
        tm.save("gs://bucket/m.bigdl")
    with pytest.raises(RuntimeError, match="device='cpu'") if not \
            torch.cuda.is_available() else pytest.raises(Exception):
        if torch.cuda.is_available():
            raise Exception("the card is there: nothing to refuse")
        Module.load(path)


def test_predict_and_evaluate_match_jax():
    """``predict`` (a partial last batch), ``predict_class`` (1-based)
    and ``evaluate_on`` against the JAX LocalPredictor and Evaluator."""
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.optim import Top1Accuracy as JTop1
    from bigdl_tpu.optim.predictor import LocalPredictor as JPredictor
    from bigdl_tpu_torch.dataset import Sample as TSample
    from bigdl_tpu_torch.optim import LocalPredictor, Top1Accuracy

    jm, tm = _pair()
    rs = np.random.RandomState(5)
    xs = rs.randn(11, 4).astype(np.float32)
    ys = rs.randint(1, 3, 11).astype(np.float32)
    want = JPredictor(jm, batch_size=4).predict(
        [JSample(a, b) for a, b in zip(xs, ys)])
    samples = [TSample(a, b) for a, b in zip(xs, ys)]
    got = tm.predict(samples, batch_size=4)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    cls = tm.predict_class(samples, batch_size=4)
    np.testing.assert_array_equal(
        cls, JPredictor(jm, batch_size=4).predict_class(
            [JSample(a, b) for a, b in zip(xs, ys)]))
    assert cls.min() >= 1
    np.testing.assert_array_equal(
        LocalPredictor(tm, batch_size=5).predict_class(samples), cls)
    (_, res), = tm.evaluate_on(samples, [Top1Accuracy()], batch_size=4)
    (_, jres), = jm.evaluate_on([JSample(a, b) for a, b in zip(xs, ys)],
                                [JTop1()], batch_size=4)
    assert res.result() == jres.result()
    assert tm.is_training()       # the modes come back


def test_predictor_keeps_table_inputs():
    """Samples of two features reach the model as a Table of two batched
    tensors, as in the JAX LocalPredictor."""
    from bigdl_tpu import nn as jnn2
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.optim.predictor import LocalPredictor as JPredictor
    from bigdl_tpu_torch.dataset import Sample as TSample

    jm = jnn2.CAddTable()
    tm = tnn.CAddTable()
    tm.register_buffer("anchor", torch.zeros(1))   # places it on the host
    rs = np.random.RandomState(9)
    a, b = rs.randn(7, 3).astype(np.float32), rs.randn(7, 3).astype(
        np.float32)
    want = JPredictor(jm, batch_size=3).predict(
        [JSample([x, y], np.float32(1)) for x, y in zip(a, b)])
    got = tm.predict([TSample([x, y], np.float32(1)) for x, y in zip(a, b)],
                     batch_size=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(np.stack(got), a + b, **TOL)


def test_child_backward_replays_its_own_mask():
    """A Dropout called inside a container replays its own forward mask
    on a direct ``child.backward`` (the JAX package's
    test_child_backward_replays_parent_scoped_mask)."""
    m = tnn.Sequential(tnn.Dropout(0.5), tnn.Identity())
    x = torch.ones(4, 16)
    y = m(x)
    gi = m[0].backward(x, torch.ones_like(x))
    np.testing.assert_array_equal(y.numpy() != 0, gi.numpy() != 0)
