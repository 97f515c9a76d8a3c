"""The port's sparse stack (bigdl_tpu_torch/nn/sparse.py, the sparse
Sample and SparseMiniBatch of bigdl_tpu_torch/dataset/) against the JAX
package's (bigdl_tpu/nn/sparse.py), on the same numpy inputs and the JAX
weights carried by the bridge.

Each test of tests/test_sparse.py has a counterpart here, and the
layout's traps each have one, with the wrong form shown apart from JAX:
padding and entries out of bounds are dropped (clamping them into bounds
is not), duplicate ids take the largest id while duplicate per-id
weights add up, ``LookupTableSparse.max_norm`` leaves the weight as it
was (``F.embedding(max_norm=)`` writes it). Tolerances: f32 forwards and
gradients rtol 1e-5, atol 1e-6; the integer layout exactly; losses of a
few training steps rtol 1e-5.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JaxToBatch
from bigdl_tpu.nn.module import pure_apply
from bigdl_tpu.nn.sparse import SparseMiniBatch as JaxMiniBatch
from bigdl_tpu.nn.sparse import SparseTensor as JaxSparse
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim.optimizer import Optimizer as JaxOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import Sample, SampleToMiniBatch, to_device
from bigdl_tpu_torch.dataset.prefetch import device_prefetch
from bigdl_tpu_torch.nn.sparse import SparseMiniBatch, SparseTensor
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _tree(tree):
    return {k: (_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _params(jm):
    return _tree(jm.params_dict())


def _same_layout(ours: SparseTensor, theirs: JaxSparse, values=True):
    assert ours.shape == tuple(theirs.shape)
    np.testing.assert_array_equal(_np(ours.indices), np.asarray(
        theirs.indices))
    if values:
        np.testing.assert_allclose(_np(ours.values),
                                   np.asarray(theirs.values), **TOL)


def _sparse_pair(dense, nse=None):
    """The port's ``from_dense`` and JAX's, padding included."""
    return (SparseTensor.from_dense(dense, nse=nse),
            JaxSparse.from_dense(dense, nse=nse))


def _coo_pair(dense):
    """The port's ``from_dense`` and JAX's tensor of the same nonzeros,
    built by ``coo`` (``BCOO.fromdense`` compiles a program for each
    shape and count; the equality of the two is
    ``test_from_dense_pads_truncates_and_orders_as_bcoo``'s)."""
    dense = np.asarray(dense, np.float32)
    at = np.nonzero(dense)
    return (SparseTensor.from_dense(dense),
            JaxSparse.coo(np.stack(at), dense[at], dense.shape))


# ------------------------------------------------------------ SparseTensor
def test_sparse_tensor_coo_roundtrip():
    ours = SparseTensor.coo([[0, 1], [1, 0]], [3.0, 4.0], (2, 3))
    theirs = JaxSparse.coo([[0, 1], [1, 0]], [3.0, 4.0], (2, 3))
    _same_layout(ours, theirs)
    d = _np(ours.to_dense())
    np.testing.assert_array_equal(d, [[0, 3, 0], [4, 0, 0]])
    back = SparseTensor.from_dense(d)
    _same_layout(back, JaxSparse.from_dense(d))
    np.testing.assert_array_equal(_np(back.to_dense()), d)


def test_coo_square_indices_use_documented_orientation():
    ours = SparseTensor.coo([[0, 0], [1, 2]], [1.0, 2.0], (2, 3))
    theirs = JaxSparse.coo([[0, 0], [1, 2]], [1.0, 2.0], (2, 3))
    _same_layout(ours, theirs)
    np.testing.assert_array_equal(_np(ours.to_dense()),
                                  [[0, 1, 2], [0, 0, 0]])


@pytest.mark.parametrize("nse", [None, 2, 5])
def test_from_dense_pads_truncates_and_orders_as_bcoo(nse):
    """Row-major entries; padding with index == shape and value 0 past
    the nonzeros; the first ``nse`` when fewer (``BCOO.fromdense``)."""
    d = np.asarray([[1.0, 0, 2], [0, 3, 0]], np.float32)
    ours, theirs = _sparse_pair(d, nse)
    _same_layout(ours, theirs)
    np.testing.assert_allclose(_np(ours.to_dense()),
                               np.asarray(theirs.to_dense()), **TOL)


def test_padding_and_entries_out_of_bounds_are_dropped():
    """An entry out of bounds (index == shape, or past it, with a nonzero
    value here) adds nothing in ``to_dense`` and ``SparseLinear``; the
    wrong form, its index clamped into bounds (a gather's default),
    would add it."""
    idx, vals = [[0, 1, 2], [0, 2, 3]], [1.0, 2.0, 5.0]
    ours = SparseTensor.coo(idx, vals, (2, 3))
    theirs = JaxSparse.coo(idx, vals, (2, 3))
    ref = np.asarray(theirs.to_dense())
    np.testing.assert_array_equal(_np(ours.to_dense()), ref)
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = tnn.SparseLinear(3, 4, init_weight=w, **CPU)(ours)
    ref_out = np.asarray(jnn.SparseLinear(3, 4, init_weight=w)(theirs))
    np.testing.assert_allclose(_np(out), ref_out, **TOL)
    wrong = torch.zeros(2, 3).index_put_(
        tuple(torch.tensor(idx).clamp_max(torch.tensor([[1], [2]]))),
        torch.tensor(vals), accumulate=True)
    assert np.abs(_np(wrong) - ref).max() > 1.0
    # from_dense's padding through the layer and its gradient
    d = np.asarray([[1.0, 0, 2], [0, 3, 0]], np.float32)
    ours, theirs = _sparse_pair(d, nse=5)
    tl = tnn.SparseLinear(3, 4, init_weight=w, **CPU)
    jl = jnn.SparseLinear(3, 4, init_weight=w)
    np.testing.assert_allclose(_np(tl(ours)), d @ w.T, **TOL)
    g = np.ones((2, 4), np.float32)
    gi = tl.backward(ours, torch.tensor(g))
    jgi = jl.backward(theirs, jnp.asarray(g))
    assert isinstance(gi, SparseTensor)     # JAX's indices here are float0
    assert torch.equal(gi.indices, ours.indices)
    np.testing.assert_allclose(_np(gi.values), np.asarray(jgi.values), **TOL)


# ------------------------------------------------------------ SparseLinear
def test_sparse_linear_matches_dense_linear():
    rng = np.random.RandomState(0)
    dense = rng.rand(4, 6).astype(np.float32)
    dense[dense < 0.7] = 0.0
    w = rng.randn(3, 6).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    ours, theirs = _coo_pair(dense)
    out = tnn.SparseLinear(6, 3, init_weight=w, init_bias=b, **CPU)(ours)
    ref = np.asarray(jnn.SparseLinear(6, 3, init_weight=w,
                                      init_bias=b)(theirs))
    np.testing.assert_allclose(_np(out), ref, **TOL)
    np.testing.assert_allclose(_np(out), dense @ w.T + b, **TOL)


def test_sparse_linear_duplicates_add_up():
    idx, vals = [[0, 0, 1], [2, 2, 0]], [1.5, -0.5, 2.0]
    w = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    out = tnn.SparseLinear(4, 3, init_weight=w, **CPU)(
        SparseTensor.coo(idx, vals, (2, 4)))
    ref = jnn.SparseLinear(4, 3, init_weight=w)(JaxSparse.coo(idx, vals,
                                                              (2, 4)))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_sparse_linear_trains():
    """The JAX test's problem: the first eager SGD steps equal JAX's, and
    120 of them fit it."""
    rng = np.random.RandomState(1)
    x = (rng.rand(32, 10) * (rng.rand(32, 10) > 0.8)).astype(np.float32)
    y = x @ rng.randn(1, 10).astype(np.float32).T
    jl = jnn.SparseLinear(10, 1)
    tl = tnn.SparseLinear(10, 1, **CPU)
    load_jax_params(tl, _params(jl))
    sx, jx = _coo_pair(x)
    crit, jcrit = tnn.MSECriterion(), jnn.MSECriterion()
    yt, yj = torch.tensor(y), jnp.asarray(y)
    losses = []
    for step in range(120):
        tl.zero_grad_parameters()
        out = tl(sx)
        loss = crit(out, yt)
        tl.backward(sx, crit.backward(out, yt))
        tl.update_parameters(0.3)
        if step < 3:
            jl.zero_grad_parameters()
            jout = jl(jx)
            losses.append((loss.item(), float(jcrit(jout, yj))))
            jl.backward(jx, jcrit.backward(jout, yj))
            jl.update_parameters(0.3)
    np.testing.assert_allclose(*zip(*losses), rtol=1e-5)
    assert loss.item() < 0.05, loss.item()


def test_sparse_linear_backward_slice():
    """gradInput is the dense column slice ``g @ W[:, 2:4]`` and the
    parameter gradients are JAX's."""
    rng = np.random.RandomState(3)
    x = (rng.rand(4, 6) * (rng.rand(4, 6) > 0.5)).astype(np.float32)
    w = rng.randn(2, 6).astype(np.float32)
    go = rng.randn(4, 2).astype(np.float32)
    tl = tnn.SparseLinear(6, 2, init_weight=w, backward_start=3,
                          backward_length=2, **CPU)
    jl = jnn.SparseLinear(6, 2, init_weight=w, backward_start=3,
                          backward_length=2)
    ours, theirs = _coo_pair(x)
    for m in (tl, jl):
        m.zero_grad_parameters()
    tl(ours)
    gi = tl.backward(ours, torch.tensor(go))
    jl(theirs)
    jgi = jl.backward(theirs, jnp.asarray(go))
    assert tuple(gi.shape) == (4, 2)
    np.testing.assert_allclose(_np(gi), np.asarray(jgi), **TOL)
    np.testing.assert_allclose(_np(gi), go @ w[:, 2:4], **TOL)
    np.testing.assert_allclose(_np(tl.weight.grad),
                               np.asarray(jl.grads_dict()["~params"][
                                   "weight"]), **TOL)


# ------------------------------------------------------- LookupTableSparse
def _lookup_pair(*args, **kw):
    jm = jnn.LookupTableSparse(*args, **kw)
    tm = tnn.LookupTableSparse(*args, **kw, **CPU)
    load_jax_params(tm, _params(jm))
    return jm, tm


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_table_sparse_combiners(combiner):
    jm, tm = _lookup_pair(10, 4, combiner=combiner)
    ids = np.asarray([[1, 3, -1], [2, -1, -1]])
    out = _np(tm(torch.tensor(ids)))
    np.testing.assert_allclose(out, np.asarray(jm(jnp.asarray(ids))), **TOL)
    w = _np(tm.weight)
    rows = np.stack([w[1] + w[3], w[2]])
    if combiner == "mean":
        rows[0] /= 2
    elif combiner == "sqrtn":
        rows[0] /= np.sqrt(2)
    np.testing.assert_allclose(out, rows, rtol=1e-5)


def test_lookup_table_sparse_ids_as_sparse_tensor_with_weights():
    jm, tm = _lookup_pair(10, 4, combiner="sum")
    args = ([[0, 0, 1], [0, 1, 0]], [1, 3, 2], (2, 2))
    wargs = ([[0, 0, 1], [0, 1, 0]], [2.0, 0.5, 1.0], (2, 2))
    out = _np(tm(Table(SparseTensor.coo(*args), SparseTensor.coo(*wargs))))
    ref = np.asarray(jm(JaxTable(JaxSparse.coo(*args),
                                 JaxSparse.coo(*wargs))))
    np.testing.assert_allclose(out, ref, **TOL)
    w = _np(tm.weight)
    np.testing.assert_allclose(out[0], 2.0 * w[0] + 0.5 * w[2], rtol=1e-5)
    np.testing.assert_allclose(out[1], w[1], rtol=1e-5)


def test_duplicate_ids_take_the_largest_and_duplicate_weights_add():
    """Ids 3 and 5 at one position read row ``W[4]``; their weights 1.0
    and 2.0 add up to 3.0. The wrong forms (ids added, weights maxed)
    land elsewhere."""
    jm, tm = _lookup_pair(10, 4, combiner="sum")
    at = [[0, 0, 1], [0, 0, 1]]
    ids, wts = ([at, [3, 5, 2], (2, 2)], [at, [1.0, 2.0, 1.0], (2, 2)])
    out = _np(tm(Table(SparseTensor.coo(*ids), SparseTensor.coo(*wts))))
    ref = np.asarray(jm(JaxTable(JaxSparse.coo(*ids),
                                 JaxSparse.coo(*wts))))
    np.testing.assert_allclose(out, ref, **TOL)
    w = _np(tm.weight)
    np.testing.assert_allclose(out[0], 3.0 * w[4], rtol=1e-5)
    for wrong in (3.0 * w[7], 2.0 * w[4]):   # ids summed; weights maxed
        assert np.abs(wrong - ref[0]).max() > 1e-3


def test_lookup_table_max_norm():
    """Each looked-up row is clipped to the norm out of place: the weight
    keeps its values, where ``F.embedding(max_norm=)`` renormalises the
    rows it reads in place."""
    jm, tm = _lookup_pair(5, 3, combiner="sum", max_norm=0.1)
    with torch.no_grad():
        tm.weight.fill_(1.0)
    jm._set_param("weight", jnp.ones((5, 3)))
    ids = np.asarray([[0, -1]])
    out = _np(tm(torch.tensor(ids)))
    np.testing.assert_allclose(out, np.asarray(jm(jnp.asarray(ids))), **TOL)
    np.testing.assert_allclose(np.linalg.norm(out[0]), 0.1, rtol=1e-4)
    np.testing.assert_array_equal(_np(tm.weight), np.ones((5, 3)))
    wrong = torch.ones(5, 3)
    F.embedding(torch.tensor([0]), wrong, max_norm=0.1)
    assert not torch.equal(wrong, torch.ones(5, 3))


def test_lookup_sparse_minibatch_pad_safe_and_differentiable():
    """Zero-padded batched sparse ids never beat a real id; the forward
    and the weight gradient of the eager backward are JAX's."""
    jm, tm = _lookup_pair(10, 3, combiner="sum")
    rows = ([[[0, 1]], [4, 5], (2,)], [[[0]], [6], (2,)])
    mb = SparseMiniBatch.from_samples(
        [Sample(SparseTensor.coo(*r), np.asarray([1.0])) for r in rows])
    jmb = JaxMiniBatch.from_samples(
        [JaxSample(JaxSparse.coo(*r), np.asarray([1.0])) for r in rows])
    ids, jids = mb.get_input(), jmb.get_input()
    _same_layout(ids, jids)
    out = _np(tm(ids))
    np.testing.assert_allclose(out, np.asarray(jm(jids)), **TOL)
    w = _np(tm.weight)
    np.testing.assert_allclose(out[0], w[3] + w[4], rtol=1e-5)
    np.testing.assert_allclose(out[1], w[5], rtol=1e-5)
    g = np.random.RandomState(5).randn(2, 3).astype(np.float32)
    for m in (tm, jm):
        m.zero_grad_parameters()
    tm.backward(ids, torch.tensor(g))
    jm.backward(jids, jnp.asarray(g))
    np.testing.assert_allclose(_np(tm.weight.grad), np.asarray(
        jm.grads_dict()["~params"]["weight"]), **TOL)


# ---------------------------------------------- SparseJoinTable, DenseToSparse
@pytest.mark.parametrize("dimension", [1, 2])
def test_sparse_join_table(dimension):
    """Every entry of the second part, padding included, moves by the
    first part's size along the dimension."""
    a = SparseTensor.from_dense(np.asarray([[1.0, 0], [0, 2.0]]), nse=3)
    b = SparseTensor.from_dense(np.asarray([[0, 3.0], [4.0, 0]]), nse=3)
    ja, jb = (JaxSparse.coo(_np(m.indices).T, _np(m.values), m.shape)
              for m in (a, b))
    joined = tnn.SparseJoinTable(dimension)(Table(a, b))
    _same_layout(joined, jnn.SparseJoinTable(dimension)(JaxTable(ja, jb)))
    want = [[1, 0, 0, 3], [0, 2, 4, 0]] if dimension == 2 else \
        [[1, 0], [0, 2], [0, 3], [4, 0]]
    np.testing.assert_array_equal(_np(joined.to_dense()), want)


def test_dense_to_sparse_roundtrip():
    x = np.asarray([[0.0, 1.5, 0.0], [2.0, 0.0, 3.0]], np.float32)
    for nse in (None, 4):
        st = tnn.DenseToSparse(nse)(torch.tensor(x))
        _same_layout(st, jnn.DenseToSparse(nse)(jnp.asarray(x)))
        np.testing.assert_array_equal(_np(st.to_dense()), x)


def test_dense_to_sparse_gradient_is_the_dense_pass_through():
    """The documented backward (``bigdl_tpu/nn/sparse.py:252``): the
    gradient of each stored entry goes back to its position, zero
    elsewhere, padding included. (The JAX layer's eager backward raises
    here: ``BCOO.fromdense`` needs a concrete ``nse`` under its vjp.)"""
    x = np.asarray([[0.0, 1.5, 0.0], [2.0, 0.0, 3.0]], np.float32)
    layer = tnn.DenseToSparse(nse=5)
    out = layer(torch.tensor(x))
    g = SparseTensor(out.indices, torch.tensor([0.5, -1.0, 2.0, 7.0, 9.0]),
                     out.shape)
    gi = layer.backward(torch.tensor(x), g)
    np.testing.assert_array_equal(_np(gi), [[0, 0.5, 0], [-1.0, 0, 2.0]])


# --------------------------------------------------------- the data path
def test_sample_to_minibatch_dispatches_sparse():
    samples = [Sample(SparseTensor.coo([[0]], [float(i + 1)], (3,)),
                      np.asarray([float(i)])) for i in range(4)]
    jsamples = [JaxSample(JaxSparse.coo([[0]], [float(i + 1)], (3,)),
                          np.asarray([float(i)])) for i in range(4)]
    batches = list(SampleToMiniBatch(2)(iter(samples)))
    jbatches = list(JaxToBatch(2)(iter(jsamples)))
    assert len(batches) == len(jbatches) == 2
    assert isinstance(batches[0], SparseMiniBatch)
    assert batches[0].size() == 2
    for b, jb in zip(batches, jbatches):
        _same_layout(b.get_input(), jb.get_input())
        np.testing.assert_array_equal(b.get_target(), jb.get_target())


def test_sparse_minibatch_from_samples():
    def rows(ST, S):
        return [S([ST.coo([[0], [2]], [1.0, 2.0], (4,)),
                   np.asarray([9.0, 9.0], np.float32)], np.asarray([1.0])),
                S([ST.coo([[1]], [5.0], (4,)),
                   np.asarray([7.0, 7.0], np.float32)], np.asarray([2.0]))]

    mb = SparseMiniBatch.from_samples(rows(SparseTensor, Sample))
    jmb = JaxMiniBatch.from_samples(rows(JaxSparse, JaxSample))
    assert mb.size() == jmb.size() == 2
    feats, jfeats = mb.get_input(), jmb.get_input()
    _same_layout(feats[1], jfeats[1])
    np.testing.assert_array_equal(_np(feats[1].to_dense()),
                                  [[1, 0, 2, 0], [0, 5, 0, 0]])
    np.testing.assert_array_equal(feats[2], [[9, 9], [7, 7]])
    np.testing.assert_array_equal(mb.get_target(), [[1], [2]])
    # staged as tensors, the sparse feature's indices and values both,
    # alone and by the prefetch thread
    staged = to_device(feats[1], torch.device("cpu"))
    assert isinstance(staged, SparseTensor)
    assert torch.equal(staged.indices, feats[1].indices)
    it = device_prefetch(iter([mb]), device="cpu")
    got = next(it)
    it.close()
    assert isinstance(got, SparseMiniBatch) and got.size() == 2
    assert torch.equal(got.get_input()[1].values, feats[1].values)
    assert torch.equal(got.get_input()[2], torch.tensor([[9.0, 9], [7, 7]]))
    assert torch.equal(got.get_target(), torch.tensor([[1.0], [2.0]]))


# ------------------------------------------------ wide and deep, eagerly
def test_wide_and_deep_smoke():
    """The JAX test's eager wide-and-deep loop on the port: its first
    three steps' losses equal JAX's on the same weights (the JAX side's
    SGD steps as one jitted program of the same modules, ``pure_apply``
    and ``jax.grad``: op by op, its compiles take ~7 s), and 60 steps
    cut the loss by 30%."""
    rng = np.random.RandomState(2)
    n, wide_dim, n_cat = 64, 20, 8
    wide_x = (rng.rand(n, wide_dim) * (rng.rand(n, wide_dim) > 0.9)
              ).astype(np.float32)
    cat_ids = rng.randint(0, n_cat, (n, 2))
    deep_x = rng.randn(n, 4).astype(np.float32)
    y = ((wide_x.sum(1) * 0.5 + (cat_ids[:, 0] == 3) * 2.0 + deep_x[:, 0]
          - 0.5) > 0).astype(np.float32)[:, None]

    def parts(nn, **kw):
        return (nn.SparseLinear(wide_dim, 1, **kw),
                nn.LookupTableSparse(n_cat, 4, combiner="mean", **kw),
                nn.Sequential().add(nn.Linear(8, 8, **kw)).add(nn.ReLU())
                .add(nn.Linear(8, 1, **kw)), nn.Sigmoid(), nn.BCECriterion())

    jmods, tmods = parts(jnn), parts(tnn, **CPU)
    for jm, tm in zip(jmods[:3], tmods[:3]):
        load_jax_params(tm, _params(jm))
    sx, jsx = _coo_pair(wide_x)
    ids, dx, yy = (jnp.asarray(a) for a in (cat_ids, deep_x, y))
    fns = [pure_apply(m) for m in jmods[:3]]

    def jax_loss(ps):
        e = fns[1](ps[1], {}, ids)[0]
        d_out = fns[2](ps[2], {}, jnp.concatenate([e, dx], axis=1))[0]
        out = jmods[3].forward(fns[0](ps[0], {}, jsx)[0] + d_out)
        return jmods[4].forward(out, yy)

    @jax.jit
    def jax_step(ps):
        loss, g = jax.value_and_grad(jax_loss)(ps)
        return loss, jax.tree.map(lambda p, d: p - 0.5 * d, ps, g)

    ps, j_losses = [m.params_dict() for m in jmods[:3]], []
    for _ in range(3):
        loss, ps = jax_step(ps)
        j_losses.append(float(loss))

    wide, emb, deep, sig, crit = tmods
    xi, xd, yt = (torch.tensor(a) for a in (cat_ids, deep_x, y))
    losses = []
    for _ in range(60):
        for m in (wide, emb, deep):
            m.zero_grad_parameters()
        deep_in = torch.cat([emb(xi), xd], dim=1)
        w_out, d_out = wide(sx), deep(deep_in)
        out = sig(w_out + d_out)
        losses.append(crit(out, yt).item())
        g = sig.backward(w_out + d_out, crit.backward(out, yt))
        wide.backward(sx, g)
        emb.backward(xi, deep.backward(deep_in, g)[:, :4])
        for m in (wide, emb, deep):
            m.update_parameters(0.5)
    np.testing.assert_allclose(losses[:3], j_losses, rtol=1e-5)
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


# ------------------------------------ the slice: a graph through the loop
def _wide_deep_graph(nn, wide_dim, n_ids, n_dense, **kw):
    wide_in, ids_in, dense_in = nn.Input(), nn.Input(), nn.Input()
    wide = nn.SparseLinear(wide_dim, 1, **kw).inputs(wide_in)
    emb = nn.LookupTableSparse(n_ids, 4, combiner="mean", **kw) \
        .inputs(ids_in)
    deep = nn.JoinTable(2).inputs(emb, dense_in)
    deep = nn.ReLU().inputs(nn.Linear(4 + n_dense, 8, **kw).inputs(deep))
    deep = nn.Linear(8, 1, **kw).inputs(deep)
    out = nn.Sigmoid().inputs(nn.CAddTable().inputs(wide, deep))
    return nn.Graph([wide_in, ids_in, dense_in], out)


class _Losses(logging.Handler):
    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        if "Throughput" in record.msg:
            self.losses.append(record.args[-1])


def _optimize(opt_cls, trig, adam, crit, model, samples, logger_name):
    opt = opt_cls(model=model, dataset=samples, criterion=crit,
                  batch_size=8, end_when=trig.max_iteration(3))
    opt.set_optim_method(adam(learning_rate=0.05))
    logger = logging.getLogger(logger_name)
    handler, level = _Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        opt.optimize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.losses


def test_wide_and_deep_graph_trains_through_the_loop_as_jax():
    """A wide-and-deep ``Graph`` (SparseLinear over hashed columns,
    LookupTableSparse over id fields joined with dense features, an MLP,
    Sigmoid) trained three Adam steps by each package's optimizer from the
    same sparse Samples: equal losses, and equal parameters after."""
    rs = np.random.RandomState(11)
    n, wide_dim, n_ids, fields, n_dense = 32, 64, 12, 3, 2
    samples, jsamples = [], []
    for _ in range(n):
        cols = np.sort(rs.choice(wide_dim, 4, replace=False))
        wv = rs.rand(4).astype(np.float32)
        ids = rs.randint(1, n_ids + 1, fields)
        dense = rs.randn(n_dense).astype(np.float32)
        label = np.asarray([float(cols[0] < wide_dim // 2)], np.float32)
        feats = [([cols], wv, (wide_dim,)),
                 ([np.arange(fields)], ids, (fields,))]
        samples.append(Sample([SparseTensor.coo(*feats[0]),
                               SparseTensor.coo(*feats[1]), dense], label))
        jsamples.append(JaxSample([JaxSparse.coo(*feats[0]),
                                   JaxSparse.coo(*feats[1]), dense], label))
    jm = _wide_deep_graph(jnn, wide_dim, n_ids, n_dense)
    tm = _wide_deep_graph(tnn, wide_dim, n_ids, n_dense, **CPU)
    load_jax_params(tm, _params(jm))
    j_losses = _optimize(JaxOptimizer, JaxTrigger, jom.Adam,
                         jnn.BCECriterion(), jm, jsamples, "bigdl_tpu.optim")
    losses = _optimize(topt.Optimizer, topt.Trigger, topt.Adam,
                       tnn.BCECriterion(), tm, samples,
                       "bigdl_tpu_torch.optim")
    assert len(losses) == len(j_losses) == 3
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for (name, ours), theirs in zip(
            sorted(_flat(tm.params_dict()).items()),
            [v for _, v in sorted(_flat(_params(jm)).items())]):
        np.testing.assert_allclose(_np(ours), theirs, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
