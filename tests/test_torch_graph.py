"""The port's graph container and LookupTable (bigdl_tpu_torch/nn/graph.py,
nn/embedding.py) against the JAX package's, with the graph forms of
LeNet-5 and NCF's ``build_ncf``.

Each case of tests/test_graph.py has a counterpart here, on JAX weights
carried across by ``load_jax_params``: the JAX graph and the port's,
built the same way, take the same numpy input, and the forward and the
input and parameter gradients for one random output cotangent (``jax.vjp``
of ``pure_apply`` against autograd) agree within f32 rtol 1e-5 / atol
1e-6. The port's graph keeps the JAX topological order, so its
``n{i}_{ClassName}`` children carry the JAX tree key for key; a graph
sorted otherwise fails ``load_jax_params``. ``test_graph_jits``'s
counterpart holds the graph through the port's ``TrainStep`` to its
``Sequential`` twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.example.recommendation import ncf as jncf
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.optim import LocalPredictor as JaxLocalPredictor
from bigdl_tpu.optim.evaluator import Evaluator as JaxEvaluator
from bigdl_tpu.optim.validation import Loss as JaxLoss
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.example.recommendation import ncf
from bigdl_tpu_torch.nn.module import activity_tensors, tree_leaves
from bigdl_tpu_torch.optim import SGD, LocalPredictor, make_train_step
from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.validation import Loss
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.weights import load_jax_params, params_to_numpy
from tests.jax_numpy_init import numpy_weight_draws

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")


# ------------------------------------------------------ the parity helper
def to_port(x):
    """A JAX input (array or Table) as the port's (tensor or Table)."""
    if isinstance(x, JaxTable):
        return Table(*[to_port(v) for v in x.values()])
    return torch.tensor(np.asarray(x))


def _float_leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)]


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32
                        else np.asarray(a), tree)


def like_jax(jm, tm, x, training=False, load=True, seed=7, f64=False):
    """Carry ``jm``'s weights into ``tm`` (unless ``load`` is False) and
    hold the port's forward, input gradients and parameter gradients to
    the JAX package's (jitted: one compile instead of one per operation)
    on input ``x`` (numpy, or a JAX Table of numpy) for one random output
    cotangent. Returns the port's outputs.

    With ``f64`` both sides compute in float64 (JAX under
    ``jax.enable_x64``, the port's module cast by ``.double()``), for
    the cases whose f32 gradients sum hundreds of terms: there the two
    packages' f32 summation orders part by more than atol 1e-6 on an
    element that cancels, while in float64 the functions must agree to
    the same rtol 1e-5 / atol 1e-6 (their rounding is then ~1e-15)."""
    if load:
        load_jax_params(tm, jax.tree.map(np.asarray, jm.params_dict()))
    tm.train(training)
    params = jm.params_dict()
    if f64:
        tm.double()
        params, x = _f64(params), _f64(x)
    with jax.enable_x64(f64):
        j_outs, j_gx, j_gp, gs = _jax_forward_vjp(jm, params, x, training,
                                                  seed)
    xt = to_port(x)
    leaves = [t.requires_grad_(True) for t in activity_tensors(xt)
              if t.is_floating_point()]
    params = [p for _, p in tree_leaves(tm.params_dict())]
    t_outs = activity_tensors(tm(xt))
    assert [tuple(o.shape) for o in t_outs] == \
        [tuple(o.shape) for o in j_outs]
    grads = torch.autograd.grad(t_outs, leaves + params,
                                [torch.from_numpy(g).to(o.dtype)
                                 for g, o in zip(gs, t_outs)],
                                allow_unused=True)
    grads = [np.zeros(tuple(t.shape), np.float32) if d is None
             else d.numpy() for t, d in zip(leaves + params, grads)]
    for ours, theirs in zip(t_outs, j_outs):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                   **TOL, err_msg="forward")
    j_gx, j_gp = _float_leaves(j_gx), _float_leaves(j_gp)
    assert len(j_gx) == len(leaves) and len(j_gp) == len(params)
    for i, (ours, theirs) in enumerate(zip(grads, j_gx + j_gp)):
        np.testing.assert_allclose(ours, theirs, **TOL,
                                   err_msg=f"gradient {i}")
    return t_outs


def _jax_forward_vjp(jm, params, x, training, seed):
    """(output leaves, input grads, parameter grads, the cotangents) of
    the JAX module, jitted."""
    fn = pure_apply(jm)
    buffers = jm.buffers_dict()

    def apply(p, xx):
        return fn(p, buffers, xx, training=training)[0]

    shapes = jax.tree.leaves(jax.eval_shape(apply, params, x))
    rs = np.random.RandomState(seed)
    gs = [rs.randn(*o.shape).astype(np.float32) for o in shapes]

    @jax.jit
    def forward_vjp(p, xx, cts):
        out, vjp = jax.vjp(apply, p, xx)
        leaves, tree = jax.tree.flatten(out)
        return leaves, vjp(jax.tree.unflatten(
            tree, [c.astype(o.dtype) for c, o in zip(cts, leaves)]))

    j_outs, (j_gp, j_gx) = forward_vjp(params, x,
                                       [jnp.asarray(g) for g in gs])
    return j_outs, j_gx, j_gp, gs


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------- tests/test_graph.py, ported
def _chain(nn, **kw):
    l1, l2 = nn.Linear(4, 8, **kw), nn.Linear(8, 3, **kw)
    inp = nn.Input()
    return nn.Graph(inp, l2.inputs(l1.inputs(inp))), (l1, l2)


def test_linear_chain_matches_sequential():
    jg, _ = _chain(jnn)
    tg, (l1, l2) = _chain(tnn, **CPU)
    x = _x(0, 5, 4)
    out = like_jax(jg, tg, x)[0]
    seq = tnn.Sequential(l1, l2)
    np.testing.assert_allclose(out.detach().numpy(),
                               seq(torch.tensor(x)).detach().numpy(), **TOL)


def _two_branch(nn, **kw):
    inp = nn.Input()
    a = nn.Linear(4, 6, **kw).inputs(inp)
    b = nn.Linear(4, 6, **kw).inputs(inp)
    out = nn.ReLU().inputs(nn.CAddTable().inputs(a, b))
    return nn.Graph(inp, out), a, b


def test_two_branch_merge():
    jg, _, _ = _two_branch(jnn)
    tg, a, b = _two_branch(tnn, **CPU)
    x = _x(1, 2, 4)
    y = like_jax(jg, tg, x)[0]
    assert tuple(y.shape) == (2, 6)
    la, lb = tg.node(a.name).module, tg.node(b.name).module
    xt = torch.tensor(x)
    np.testing.assert_allclose(y.detach().numpy(),
                               torch.relu(la(xt) + lb(xt)).detach().numpy(),
                               **TOL)


def _multi_io(nn, **kw):
    i1, i2 = nn.Input(), nn.Input()
    a = nn.Linear(3, 5, **kw).inputs(i1)
    b = nn.Linear(2, 5, **kw).inputs(i2)
    s = nn.CAddTable().inputs(a, b)
    return nn.Graph([i1, i2], [s, nn.Tanh().inputs(s)])


def test_multi_input_multi_output():
    out = like_jax(_multi_io(jnn), _multi_io(tnn, **CPU),
                   JaxTable(_x(2, 4, 3), _x(3, 4, 2)))
    assert [tuple(o.shape) for o in out] == [(4, 5), (4, 5)]
    np.testing.assert_allclose(out[1].detach().numpy(),
                               np.tanh(out[0].detach().numpy()), **TOL)
    got = _multi_io(tnn, **CPU)(Table(torch.ones(4, 3), torch.ones(4, 2)))
    assert isinstance(got, Table) and len(got) == 2


def _shared(nn, **kw):
    shared = nn.Linear(4, 4, **kw)
    inp = nn.Input()
    return nn.Graph(inp, shared.inputs(shared.inputs(inp))), shared


def test_shared_module_registered_once():
    jg, _ = _shared(jnn)
    tg, shared = _shared(tnn, **CPU)
    assert len(list(tg.parameters())) == 2      # weight and bias, once
    assert len(tree_leaves(tg.params_dict())) == 2
    x = _x(4, 1, 4)
    out = like_jax(jg, tg, x)[0]
    xt = torch.tensor(x)
    np.testing.assert_allclose(out.detach().numpy(),
                               shared(shared(xt)).detach().numpy(), **TOL)
    assert tg.check_duplicate() == [shared]
    with pytest.raises(ValueError, match="multiple nodes"):
        tg.check_duplicate(raise_on_shared=True)


def _stopped(nn, **kw):
    inp = nn.Input()
    l1 = nn.Linear(4, 4, **kw).set_name("frozen_branch")
    l2 = nn.Linear(4, 4, **kw)
    g = nn.Graph(inp, l2.inputs(l1.inputs(inp)))
    return g.stop_gradient(["frozen_branch"]), l1, l2


def test_stop_gradient_prunes_backward():
    jg, _, _ = _stopped(jnn)
    tg, l1, l2 = _stopped(tnn, **CPU)
    x = _x(5, 2, 4)
    like_jax(jg, tg, x)                   # JAX's zeros for the stopped leaf
    # the eager backward and the train step's gradient tree give zeros,
    # not None, for the stopped branch
    tg.zero_grad_parameters()
    xt = torch.tensor(x)
    dx = tg.backward(xt, 2 * tg(xt))
    grads = tg.grads_dict()
    name1 = next(k for k, m in tg.named_children() if m is l1)
    name2 = next(k for k, m in tg.named_children() if m is l2)
    assert all(float(g.abs().sum()) == 0.0
               for g in grads[name1]["~params"].values())
    assert all(float(g.abs().sum()) > 0.0
               for g in grads[name2]["~params"].values())
    assert float(dx.abs().sum()) == 0.0
    step = make_train_step(tg, tnn.MSECriterion(), SGD(learning_rate=0.1))
    params = tg.params_dict()
    loss, new, _, _ = step.step(params, {}, step.init_slots(params), xt,
                                torch.zeros(2, 4), step.current_lrs(), None)
    for k in ("weight", "bias"):
        assert torch.equal(new[name1]["~params"][k], getattr(l1, k))
        assert not torch.equal(new[name2]["~params"][k], getattr(l2, k))


def test_cycle_detection():
    inp = tnn.Input()
    a = tnn.Node(tnn.Linear(2, 2, **CPU))
    b = tnn.Node(tnn.Linear(2, 2, **CPU))
    a.inputs(inp, b)
    b.inputs(a)
    with pytest.raises(ValueError, match="cycle"):
        tnn.Graph(inp, b)


def test_disconnected_input_rejected():
    i1, i2 = tnn.Input(), tnn.Input()
    out = tnn.Linear(2, 2, **CPU).inputs(i1)
    with pytest.raises(ValueError, match="not connected"):
        tnn.Graph([i1, i2], out)
    # with allow_unused_inputs the unused input goes to the front, as in
    # the JAX order
    g = tnn.Graph([i1, i2], out, allow_unused_inputs=True)
    assert g._topo[0] is i2
    j1, j2 = jnn.Input(), jnn.Input()
    jg = jnn.Graph([j1, j2], jnn.Linear(2, 2).inputs(j1),
                   allow_unused_inputs=True)
    assert list(g.params_dict()) == list(jg.params_dict())


def _lin(nn, **kw):
    inp = nn.Input()
    return nn.Graph(inp, nn.Linear(4, 2, **kw).inputs(inp))


def test_graph_jits():
    """The graph through the port's TrainStep equals its Sequential twin
    (one SGD step: loss and new parameters), and its forward the JAX
    graph's jitted forward on the same weights."""
    jg = _lin(jnn)
    tg = _lin(tnn, **CPU)
    load_jax_params(tg, jax.tree.map(np.asarray, jg.params_dict()))
    x = _x(6, 3, 4)
    jitted = jax.jit(lambda p, b, xx: pure_apply(jg)(p, b, xx)[0])(
        jg.params_dict(), jg.buffers_dict(), x)
    np.testing.assert_allclose(tg(torch.tensor(x)).detach().numpy(),
                               np.asarray(jitted), **TOL)
    lin = tg._topo[1].module
    seq = tnn.Sequential(tnn.Linear(4, 2, **CPU))
    seq[0].load_params_dict(lin.params_dict())
    y = torch.tensor(_x(7, 3, 2))
    news = []
    for m in (tg, seq):
        step = make_train_step(m, tnn.MSECriterion(), SGD(learning_rate=0.1))
        p = m.params_dict()
        loss, new, _, _ = step.step(p, {}, step.init_slots(p),
                                    torch.tensor(x), y, step.current_lrs(),
                                    None)
        news.append((float(loss), [t for _, t in tree_leaves(new)]))
    assert news[0][0] == pytest.approx(news[1][0], rel=1e-6)
    for a, b in zip(news[0][1], news[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ----------------------------------------------------- graph faults
def test_graph_errors_as_jax_raises_them():
    inp = tnn.Input()
    orphan = tnn.Node(tnn.Linear(2, 2, **CPU))
    out = tnn.CAddTable().inputs(tnn.Linear(2, 2, **CPU).inputs(inp), orphan)
    g = tnn.Graph(inp, out)
    with pytest.raises(ValueError, match="no inputs and is not an input"):
        g(torch.ones(1, 2))
    g2 = _multi_io(tnn, **CPU)
    with pytest.raises(ValueError, match="expects 2 inputs, got 3"):
        g2(Table(torch.ones(1, 3), torch.ones(1, 2), torch.ones(1, 2)))
    with pytest.raises(TypeError, match="must be Nodes"):
        tnn.Linear(2, 2, **CPU).inputs(torch.ones(2))
    with pytest.raises(KeyError):
        g.stop_gradient(["no_such_node"])
    # distinct modules under one name make node(name) ambiguous
    i = tnn.Input()
    a = tnn.Linear(2, 2, **CPU).set_name("dup").inputs(i)
    b = tnn.Linear(2, 2, **CPU).set_name("dup").inputs(i)
    with pytest.raises(ValueError, match="share names"):
        tnn.Graph(i, tnn.CAddTable().inputs(a, b)).check_duplicate()


class _PredecessorsReversed(tnn.Graph):
    """A graph that visits each node's predecessors last to first."""

    def _topo_sort(self):
        for n in self._all_nodes():
            n.prev = n.prev[::-1]
        try:
            return super()._topo_sort()
        finally:
            for n in self._all_nodes():
                n.prev = n.prev[::-1]

    def _all_nodes(self):
        seen, stack = {}, list(self.output_nodes)
        while stack:
            n = stack.pop()
            if n._uid not in seen:
                seen[n._uid] = n
                stack.extend(n.prev)
        return list(seen.values())


def _branches(nn, graph_cls, **kw):
    inp = nn.Input()
    a = nn.Linear(4, 3, **kw).inputs(inp)
    b = nn.Tanh().inputs(nn.Linear(4, 3, **kw).inputs(inp))
    return graph_cls(inp, nn.CAddTable().inputs(a, b))


def test_a_graph_sorted_otherwise_fails_load_jax_params():
    jg = _branches(jnn, jnn.Graph)
    ours = _branches(tnn, tnn.Graph, **CPU)
    load_jax_params(ours, jax.tree.map(np.asarray, jg.params_dict()))
    reordered = _branches(tnn, _PredecessorsReversed, **CPU)
    assert list(reordered.params_dict()) != list(ours.params_dict())
    with pytest.raises(KeyError, match="tree mismatch"):
        load_jax_params(reordered, jax.tree.map(np.asarray,
                                                jg.params_dict()))


def test_node_counter_is_the_graph_modules_own():
    a, b = tnn.Node(tnn.Identity()), tnn.Node(tnn.Identity())
    assert b._uid == a._uid + 1
    jnn.Input()                                 # the JAX counter moves
    assert tnn.Node(tnn.Identity())._uid == b._uid + 1
    assert isinstance(tnn.StaticGraph(a, a), tnn.Graph)
    assert isinstance(tnn.DynamicGraph(a, a), tnn.Graph)


# ------------------------------------------------------------ LookupTable
def test_lookup_table_1based():
    m = tnn.LookupTable(5, 4, **CPU)
    y = m(torch.tensor([[1, 5], [2, 3]]))
    assert tuple(y.shape) == (2, 2, 4)
    assert torch.equal(y[0, 0], m.weight[0])
    assert torch.equal(y[0, 1], m.weight[4])
    # 0 and 6 read the nearest rows, as the JAX clip does
    z = m(torch.tensor([0, 6]))
    assert torch.equal(z[0], m.weight[0]) and torch.equal(z[1], m.weight[4])


_IDS = np.asarray([[1, 3, 0, 7], [7, 2, 2, 5]], np.int32)


@pytest.mark.parametrize("kw", [
    dict(), dict(padding_value=2), dict(max_norm=1.5),
    dict(max_norm=0.7, norm_type=1.0, padding_value=7),
], ids=["plain", "padding", "max_norm", "max_norm_l1_padding"])
def test_lookup_table_matches_jax(kw):
    with numpy_weight_draws(11):
        jm = jnn.LookupTable(8, 5, **kw)
    like_jax(jm, tnn.LookupTable(8, 5, **kw, **CPU), _IDS)


def test_embedding_max_norm_form_fails_the_gradient_check():
    """F.embedding(max_norm=) renormalises only the looked-up rows, in
    place: not the JAX function, and its gradient differs."""
    with numpy_weight_draws(12):
        jm = jnn.LookupTable(8, 5, max_norm=1.5)
    tm = tnn.LookupTable(8, 5, max_norm=1.5, **CPU)
    like_jax(jm, tm, _IDS)

    class _InPlaceRenorm(tnn.LookupTable):
        def forward(self, input):
            idx = (input.long() - 1).clamp(0, self.n_index - 1)
            return F.embedding(idx, self.weight, max_norm=self.max_norm)

    bad = _InPlaceRenorm(8, 5, max_norm=1.5, **CPU)
    with pytest.raises(AssertionError, match="gradient"):
        like_jax(jm, bad, _IDS)


def test_lookup_table_options_jax_ignores_raise():
    with pytest.raises(NotImplementedError,
                       match="should_scale_grad_by_freq.*ignores"):
        tnn.LookupTable(5, 4, should_scale_grad_by_freq=True, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnn.LookupTable(5, 4)


# ------------------------------------------------ the models' graph forms
def test_lenet_graph_matches_jax_and_its_sequential_form():
    with numpy_weight_draws(13):
        jg = jmodels.LeNet5.graph(10)
    tg = tmodels.LeNet5.graph(10, **CPU)
    assert {tg.node(n).module.get_name() for n in
            ("conv1_5x5", "conv2_5x5", "fc1", "fc2")} == {
        "conv1_5x5", "conv2_5x5", "fc1", "fc2"}
    x = _x(14, 2, 28, 28)
    out = like_jax(jg, tg, x)[0]
    seq = tmodels.LeNet5(10, **CPU)
    by_name = {m.get_name(): m for m in tg.modules()}
    for m in seq.modules():
        if m.get_name() in ("conv1_5x5", "conv2_5x5", "fc1", "fc2"):
            m.load_params_dict(by_name[m.get_name()].params_dict())
    seq.evaluate()
    np.testing.assert_allclose(seq(torch.tensor(x)).detach().numpy(),
                               out.detach().numpy(), **TOL)
    # from one seed the two forms draw the same weights
    a = [t for _, t in tree_leaves(tmodels.LeNet5.graph(10, **CPU)
                                   .params_dict())]
    b = [t for _, t in tree_leaves(tmodels.LeNet5(10, **CPU).params_dict())]
    assert sorted(float(t.detach().sum()) for t in a) == \
        sorted(float(t.detach().sum()) for t in b)


def test_build_ncf_matches_jax():
    with numpy_weight_draws(15):
        jm = jncf.build_ncf(9, 12)
    tm = ncf.build_ncf(9, 12, **CPU)
    assert list(tm.params_dict()) == list(jm.params_dict())
    rs = np.random.RandomState(16)
    x = JaxTable(rs.randint(1, 10, 6).astype(np.int32),
                 rs.randint(1, 13, 6).astype(np.int32))
    out = like_jax(jm, tm, x)[0]
    assert tuple(out.shape) == (6, 1)
    data = np.asarray([[1, 2, 5, 0], [3, 4, 1, 0]])
    ours, theirs = ncf.ratings_to_samples(data), \
        jncf.ratings_to_samples(data)
    for s, js in zip(ours, theirs):
        assert [f.tobytes() for f in s.features] == \
            [np.asarray(f).tobytes() for f in js.features]
        assert s.label().tobytes() == js.label().tobytes()


def _join(nn, **kw):
    a, b = nn.Input(), nn.Input()
    out = nn.Sigmoid().inputs(nn.Linear(4, 1, **kw).inputs(
        nn.JoinTable(2).inputs(nn.Identity().inputs(a),
                               nn.Identity().inputs(b))))
    return nn.Graph([a, b], out)


def test_evaluator_and_predictor_handle_multi_input_samples():
    jg, tg = _join(jnn), _join(tnn, **CPU)
    load_jax_params(tg, jax.tree.map(np.asarray, jg.params_dict()))
    rng = np.random.RandomState(0)
    feats = [(rng.randn(2).astype(np.float32), rng.randn(2).astype(
        np.float32)) for _ in range(8)]
    one = np.asarray([1.0], np.float32)
    samples = [Sample([a, b], one) for a, b in feats]
    jsamples = [JaxSample([a, b], one) for a, b in feats]
    preds = LocalPredictor(tg).predict(samples)
    jpreds = JaxLocalPredictor(jg).predict(jsamples)
    assert len(preds) == 8 and preds[0].shape == (1,)
    for p, jp in zip(preds, jpreds):
        np.testing.assert_allclose(np.asarray(p), np.asarray(jp), **TOL)
    res = Evaluator(tg).test(samples, [Loss(tnn.BCECriterion())],
                             batch_size=4)
    jres = JaxEvaluator(jg).test(jsamples, [JaxLoss(jnn.BCECriterion())],
                                 batch_size=4)
    assert res[0][1].result()[0] == pytest.approx(jres[0][1].result()[0],
                                                  rel=1e-5)


@pytest.mark.slow
def test_ncf_example_beats_majority_baseline():
    _, acc, base = ncf.main(["--ratings", "4096", "--max-epoch", "12",
                             "--device", "cpu"])
    assert acc > base + 0.1, (acc, base)


def test_ncf_params_cross_as_numpy():
    tm = ncf.build_ncf(4, 5, **CPU)
    back = params_to_numpy(tm)
    assert sorted(back) == sorted(tm.params_dict())
    if not torch.cuda.is_available():
        for build in (lambda: ncf.build_ncf(4, 5),
                      lambda: tmodels.LeNet5.graph(10),
                      lambda: tmodels.Autoencoder.graph(32)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
