"""The port's TF infra ops (bigdl_tpu_torch/nn/tf_ops.py) against the JAX
package's (bigdl_tpu/nn/tf_ops.py): control flow, state, TensorArray,
tf.Example parsing.

``PROGRAMS`` holds one parity case for every public class and factory:
the same program runs over each package's ops (JAX arrays there, torch
tensors on the CPU here) and the outputs agree within f32 rtol 1e-5 /
atol 1e-6, integers and bytes exactly. ``COVERED`` is what
tests/test_torch_ops.py's coverage case reads. Each test of
tests/test_tf_ops.py has a counterpart under its own name; the hazard
tests hold where a Python loop or an in-place write would part from
JAX's traced semantics (each fails under that naive form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import tf_ops as jtf
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn import tf_ops as ttf
from bigdl_tpu_torch.utils import protowire as pw
from bigdl_tpu_torch.utils.table import Table
from tests.test_torch_ops import same

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")
f32 = np.float32


class Pkg:
    """One package's side of a program: its ``tf_ops`` and ``nn``, its
    Table, an array maker from numpy and the constructor keywords its
    device-making ops need."""

    def __init__(self, port: bool):
        self.port = port
        self.tf, self.nn = (ttf, tnn) if port else (jtf, jnn)
        self.T = Table if port else JaxTable
        self.kw = CPU if port else {}

    def a(self, x):
        x = np.asarray(x)
        return torch.from_numpy(x.copy()) if self.port else jnp.asarray(x)


def _records():
    """Three tf.Example records: floats, an int64 list, bytes, and one
    record missing two features."""
    def feature(kind, payload):
        return pw.enc_bytes(kind, payload)

    def example(feats):
        return pw.enc_bytes(1, b"".join(
            pw.enc_bytes(1, pw.enc_string(1, k) + pw.enc_bytes(2, fv))
            for k, fv in feats.items()))

    return [
        example({"x": feature(2, pw.enc_packed_floats(1, [1.5, -2.0])),
                 "n": feature(3, pw.enc_packed_varints(1, [5, 2 ** 20])),
                 "s": feature(1, pw.enc_bytes(1, b"abc"))}),
        example({"x": feature(2, pw.enc_float(1, 0.25)
                              + pw.enc_float(1, 4.0)),
                 "n": feature(3, pw.enc_varint(1, 7)
                              + pw.enc_varint(1, -3)),
                 "s": feature(1, pw.enc_bytes(1, b"de"))}),
        example({"s": feature(1, pw.enc_bytes(1, b""))}),
    ]


# ------------------------------------------------------- the programs
def p_while_loop(p):
    m = p.tf.WhileLoop(cond=lambda i, acc: i < 10,
                       body=lambda i, acc: (i + 1, acc * 0.5 + i))
    capped = p.tf.WhileLoop(cond=lambda v: p.nn.Sum(1)(v) < 1e9,
                            body=p.nn.Tanh(), max_iterations=3)
    return p.T(*m(p.T(p.a(np.int32(0)), p.a(np.ones(3, f32)))),
               capped(p.a(np.arange(3, dtype=f32))))


def p_if(p):
    m = p.tf.If(then_branch=lambda x, y: x * y, else_branch=lambda x, y: x - y)
    mod = p.tf.If(then_branch=p.nn.Tanh(), else_branch=p.nn.Sigmoid())
    x, y = p.a(np.arange(3, dtype=f32)), p.a(np.full(3, 2.0, f32))
    return p.T(m(p.T(p.a(True), x, y)), m(p.T(p.a(False), x, y)),
               mod(p.T(p.a(np.asarray([0.0], f32)), x)))


def p_switch(p):
    out = p.tf.Switch()(p.T(p.a(np.arange(4, dtype=f32)), p.a(1)))
    return p.T(*out)


def p_merge(p):
    sw, mg = p.tf.Switch(), p.tf.Merge()
    data = p.a(np.arange(4, dtype=f32))
    f, t, pred = sw(p.T(data, p.a(False)))
    return p.T(mg(p.T(f * 2.0, t + 1.0, pred)),
               mg(p.T(p.T(data, data), p.T(data * 0, data + 5),
                      p.a(True))),
               mg(p.T(data, data * 3)))


def _identity(cls):
    def prog(p):
        m = getattr(p.tf, cls)() if cls != "Enter" else p.tf.Enter("frame")
        x = p.a(np.arange(3, dtype=f32))
        return p.T(m(x), *m(p.T(x, x * 2)))

    return prog


def p_assert(p):
    return p.tf.Assert("never")(p.T(p.a(True), p.a(np.ones(2, f32))))


def p_control_nodes(p):
    cn = p.tf.ControlNodes
    out = cn.while_loop(lambda v: p.nn.Sum(1)(v) < 100.0, lambda v: v * 2.0,
                        [p.a(np.ones(4, f32))], name="doubling")
    sw = cn.switch(p.a(np.arange(3, dtype=f32)), p.a(True))
    return p.T(out, cn.merge(sw[1] * 2, sw[2], sw[3]))


def p_variable(p):
    v = p.tf.Variable(p.a(np.arange(3, dtype=f32)), **p.kw)
    frozen = p.tf.Variable(p.a(np.ones(2, f32)), trainable=False, **p.kw)
    return p.T(v(None), v.params_dict()["~params"]["value"], frozen(None),
               p.a(np.asarray([v.trainable_dict()["~params"]["value"],
                               frozen.trainable_dict()["~params"]["value"]
                               ])))


def p_assign(p):
    v = p.tf.Variable(p.a(np.zeros(3, f32)), **p.kw)
    first = p.tf.Assign(v)(p.T(None, p.a(np.asarray([1.0, 2.0, 3.0], f32))))
    first = first * 1.0
    p.tf.AssignAdd(v)(p.a(np.full(3, 0.5, f32)))
    after_add = v.value * 1.0
    p.tf.AssignSub(v)(p.a(np.full(3, 2.0, f32)))
    return p.T(first, after_add, v.value * 1.0,
               np.asarray(sorted(p.tf.Assign(v).params_dict())))


def p_tensor_array(p):
    ta = p.tf.TensorArray(3, element_shape=(2,), **p.kw)
    for i in range(3):
        ta.write(i, p.a(np.full(2, i + 1.0, f32)))
    ta.write(p.a(np.int32(5)), p.a(np.full(2, 9.0, f32)))   # clamps to row 2
    ta.write(p.a(np.int32(-3)), p.a(np.full(2, 7.0, f32)))  # wraps to row 0
    lazy = p.tf.TensorArray(4, **p.kw)
    lazy.scatter(p.a(np.asarray([0, 9, -1], np.int32)),
                 p.a(np.arange(6, dtype=f32).reshape(3, 2)))
    split = p.tf.TensorArray(2, **p.kw).split(
        p.a(np.arange(10, dtype=f32).reshape(5, 2)), [2, 3])
    return p.T(ta.stack(), ta.read(p.a(np.int32(-1))),
               ta.read(p.a(np.int32(7))),
               ta.gather(p.a(np.asarray([2, -1, 3], np.int32))),
               ta.concat(), lazy.stack(), split.stack(), split.concat(),
               p.a(np.asarray(split.size)))


def p_tensor_array_modules(p):
    ta = p.tf.TensorArrayCreator(element_shape=(3,), **p.kw)(p.a(4))
    for i in range(4):
        ta = p.tf.TensorArrayWrite()(p.T(ta, i, p.a(np.full(3, i, f32))))
    read = p.tf.TensorArrayRead()(p.T(ta, 2))
    gathered = p.tf.TensorArrayGather()(p.T(ta, p.a(np.asarray([3, 0]))))
    ta = p.tf.TensorArrayScatter()(p.T(ta, p.a(np.asarray([1, 2])),
                                       p.a(np.ones((2, 3), f32))))
    concat = p.tf.TensorArrayConcat()(p.T(ta))
    size = p.tf.TensorArraySize()(p.T(ta))
    ta2 = p.tf.TensorArraySplit()(p.T(p.tf.TensorArray(1, **p.kw),
                                      p.a(np.arange(6, dtype=f32)),
                                      p.a(np.asarray([2, 2, 2]))))
    close = p.tf.TensorArrayClose()(p.T(ta))
    return p.T(read, gathered, concat, size, ta2.stack(), close)


def p_parse_example_bytes(p):
    out = []
    for rec in _records():
        feats = p.tf.parse_example_bytes(rec)
        for k in sorted(feats):
            v = feats[k]
            out.append(v if v.dtype == object else
                       p.a(v.astype(np.int32) if v.dtype == np.int64
                           else v))
    return p.T(*out)


def p_parse_example(p):
    pe = p.tf.ParseExample(3, [np.float32, np.int64, object],
                           [(2,), (2,), ()], **p.kw)
    out = pe(p.T(np.asarray(_records(), object), None, "x", b"n",
                 np.asarray(["s"]), np.asarray([8.0, 9.0], f32),
                 np.asarray([-1, -1], np.int64), np.asarray(b"none",
                                                           object)))
    return p.T(out[1], out[2], out[3].astype(bytes))


PROGRAMS = {
    "WhileLoop": p_while_loop, "If": p_if, "Switch": p_switch,
    "Merge": p_merge, "Enter": _identity("Enter"), "Exit": _identity("Exit"),
    "NextIteration": _identity("NextIteration"), "NoOp": _identity("NoOp"),
    "ControlDependency": _identity("ControlDependency"), "Assert": p_assert,
    "ControlNodes": p_control_nodes, "Variable": p_variable,
    "Assign": p_assign, "TensorArray": p_tensor_array,
    "TensorArrayCreator": p_tensor_array_modules,
    "parse_example_bytes": p_parse_example_bytes,
    "ParseExample": p_parse_example,
}
# names a program above holds besides its own
COVERED = set(PROGRAMS) | {"AssignAdd", "AssignSub"} | {
    f"TensorArray{m}" for m in ("Write", "Read", "Gather", "Scatter",
                                "Concat", "Size", "Split", "Close")}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tf_op_matches_jax(name):
    prog = PROGRAMS[name]
    same(prog(Pkg(port=True)), prog(Pkg(port=False)))


# ---------------------------- counterparts of tests/test_tf_ops.py
def test_while_loop_module_eager_and_jit():
    """The port has no trace: the same module called twice (as JAX calls
    it eagerly and under jit) gives the same answer both times."""
    m = tnn.WhileLoop(cond=lambda i, acc: i < 10,
                      body=lambda i, acc: (i + 1, acc + i))
    out = m(Table(torch.tensor(0), torch.tensor(0)))
    assert int(out[2]) == sum(range(10))
    i, acc = tuple(m(Table(torch.tensor(0), torch.tensor(0))))
    assert int(acc) == 45 and int(i) == 10
    assert m.iterations == 10 and m.host_syncs == 22


def test_while_loop_max_iterations():
    m = tnn.WhileLoop(cond=lambda i: i < 100, body=lambda i: i + 1,
                      max_iterations=7)
    assert int(m(torch.tensor(0))) == 7
    assert m.host_syncs == 7          # the cap is read before the condition


def test_control_nodes_while_loop_matches_reference_builder():
    """ControlNodes.while_loop(condition, body, loopVars)
    ≙ ControlOps.scala:296-326."""
    out = ttf.ControlNodes.while_loop(
        cond=lambda v: torch.sum(v) < 100.0,
        body=lambda v: v * 2.0,
        loop_vars=[torch.ones((4,))])
    assert float(torch.sum(out)) >= 100.0


def test_control_nodes_while_loop_names_its_module(monkeypatch):
    names = []
    forward = ttf.WhileLoop.forward

    def spy(self, input):
        names.append(self.get_name())
        return forward(self, input)

    monkeypatch.setattr(ttf.WhileLoop, "forward", spy)
    ttf.ControlNodes.while_loop(lambda v: v < 3, lambda v: v + 1,
                                [torch.tensor(0)], name="counter")
    assert names == ["counter"]


def test_if_module_both_branches():
    m = tnn.If(then_branch=lambda x: x * 2.0, else_branch=lambda x: x - 1.0)
    np.testing.assert_allclose(
        m(Table(torch.tensor(True), torch.ones((3,)))).numpy(),
        2 * np.ones(3))
    np.testing.assert_allclose(
        m(Table(torch.tensor(False), torch.ones((3,)))).numpy(), np.zeros(3))
    assert m.host_syncs == 2


def test_switch_merge_select():
    sw = ttf.Switch()
    mg = ttf.Merge()
    data = torch.tensor([1.0, 2.0])
    out_t = sw(Table(data, torch.tensor(True)))
    assert len(out_t) == 3                       # (false, true, pred)
    picked = mg(out_t)
    np.testing.assert_allclose(picked.numpy(), data.numpy())


def test_variable_assign():
    v = tnn.Variable(torch.zeros((3,)), **CPU)
    tnn.Assign(v)(torch.ones((3,)))
    np.testing.assert_allclose(v.value.detach().numpy(), np.ones(3))
    tnn.AssignAdd(v)(2 * torch.ones((3,)))
    np.testing.assert_allclose(v.value.detach().numpy(), 3 * np.ones(3))
    tnn.AssignSub(v)(torch.ones((3,)))
    np.testing.assert_allclose(v.value.detach().numpy(), 2 * np.ones(3))


def test_variable_is_trainable_parameter():
    v = tnn.Variable(torch.ones((2,)), **CPU)
    assert "value" in v.params_dict()["~params"]
    assert isinstance(v.value, torch.nn.Parameter) and v.value.requires_grad


def test_tensor_array_write_read_stack_gather():
    ta = tnn.TensorArray(4, element_shape=(2,), **CPU)
    for i in range(4):
        ta.write(i, torch.full((2,), float(i)))
    np.testing.assert_allclose(ta.read(2).numpy(), [2.0, 2.0])
    assert ta.stack().shape == (4, 2)
    np.testing.assert_allclose(ta.gather([1, 3])[:, 0].numpy(), [1.0, 3.0])
    np.testing.assert_allclose(ta.concat().numpy(),
                               np.repeat([0., 1, 2, 3], 2))


def test_tensor_array_scatter_unstack_split():
    ta = tnn.TensorArray(3, **CPU)
    ta.scatter([0, 1, 2], torch.arange(6.0).reshape(3, 2))
    np.testing.assert_allclose(ta.read(1).numpy(), [2.0, 3.0])
    ta2 = tnn.TensorArray(2, **CPU)
    ta2.split(torch.arange(6.0), [3, 3])
    np.testing.assert_allclose(ta2.read(1).numpy(), [3.0, 4.0, 5.0])


def test_tensor_array_in_while_loop():
    """A stacked buffer threads through the loop as a loop var, written
    out of place each iteration (the port's TensorArray.write)."""
    buf = torch.zeros((5, 2))

    def body(i, b):
        return i + 1, b.index_put((i.reshape(1),),
                                  torch.full((1, 2), float(i)))

    _, out = tnn.WhileLoop(lambda i, b: i < 5, body)(
        Table(torch.tensor(0), buf))
    np.testing.assert_allclose(out[:, 0].numpy(), np.arange(5.0))


def test_parse_example_module_roundtrip():
    """ParseExample vs protos built by hand with protowire (no TF needed)."""
    def feature_float(vals):
        return pw.enc_bytes(2, pw.enc_packed_floats(1, vals))

    def feature_int(vals):
        return pw.enc_bytes(3, pw.enc_packed_varints(1, vals))

    def example(feats: dict):
        entries = b"".join(
            pw.enc_bytes(1, pw.enc_string(1, k) + pw.enc_bytes(2, fv))
            for k, fv in feats.items())
        return pw.enc_bytes(1, entries)

    recs = [
        example({"feat": feature_float([1.0, 2.0]), "label": feature_int([5])}),
        example({"feat": feature_float([3.0, 4.0]), "label": feature_int([8])}),
    ]
    pe = tnn.ParseExample(2, [np.float32, np.int64], [(2,), ()], **CPU)
    out = pe(Table(np.asarray(recs, object), None,
                   "feat", "label",
                   np.zeros((2,), np.float32), np.asarray(0, np.int64)))
    np.testing.assert_allclose(out[1].numpy(), [[1, 2], [3, 4]])
    np.testing.assert_allclose(out[2].numpy(), [5, 8])


def test_parse_example_missing_feature_uses_default():
    empty = pw.enc_bytes(1, b"")  # Example with empty Features
    pe = tnn.ParseExample(1, [np.float32], [(3,)], **CPU)
    out = pe(Table(np.asarray([empty], object), None, "feat",
                   np.asarray([7.0, 8.0, 9.0], np.float32)))
    np.testing.assert_allclose(out.numpy(), [[7.0, 8.0, 9.0]])


def test_assert_module():
    a = ttf.Assert("boom")
    out = a(Table(torch.tensor(True), torch.ones((2,))))
    assert out.shape == (2,)
    with pytest.raises(AssertionError):
        a(Table(torch.tensor(False), torch.ones((2,))))
    assert a.host_syncs == 2


def test_graph_cycle_error_mentions_while_loop():
    lin = tnn.Linear(2, 2, **CPU)
    n1 = tnn.Node(lin)
    n2 = tnn.Node(tnn.ReLU())
    n1.inputs(n2)
    n2.inputs(n1)
    with pytest.raises(ValueError, match="WhileLoop"):
        tnn.Graph([n1], [n2])


# ------------------------------------------------------------ hazards
_BODIES = {
    "shape": (lambda i, x: (i + 1, x[:2]), lambda i, x: (i + 1, x[:2])),
    "dtype": (lambda i, x: (i + 1, x.to(torch.int32)),
              lambda i, x: (i + 1, x.astype(jnp.int32))),
    "number": (lambda i, x: (i + 1,), lambda i, x: (i + 1,)),
}


@pytest.mark.parametrize("change", sorted(_BODIES))
def test_while_loop_body_must_keep_the_loop_vars_types(change):
    """``lax.while_loop`` refuses a body that changes the loop vars; so
    does the port (a Python loop would run on with them)."""
    ours, theirs = _BODIES[change]
    with pytest.raises(TypeError, match="identical types"):
        tnn.WhileLoop(lambda i, x: i < 3, ours)(
            Table(torch.tensor(0), torch.ones(3)))
    with pytest.raises(TypeError):
        jnn.WhileLoop(lambda i, x: i < 3, theirs)(
            JaxTable(jnp.asarray(0), jnp.ones(3)))


def test_merge_takes_both_branches_and_selects_per_element():
    """With a tensor predicate Merge reads nothing on the host: both
    branches were computed and ``torch.where`` selects, elementwise for
    a vector predicate, as ``jnp.where`` does."""
    pred = np.asarray([True, False, True])
    f, t = np.zeros(3, f32), np.ones(3, f32)
    ours = ttf.Merge()(Table(torch.from_numpy(f), torch.from_numpy(t),
                             torch.from_numpy(pred)))
    same(ours, jtf.Merge()(JaxTable(f, t, pred)))
    assert ours.tolist() == [1.0, 0.0, 1.0]


def test_assign_keeps_the_parameter_an_optimizer_holds():
    """Assign writes into the same Parameter: an SGD step after it starts
    from the assigned value (a replaced Parameter would leave the
    optimizer updating the old one)."""
    v = tnn.Variable(torch.zeros(3), **CPU)
    p = v.value
    sgd = torch.optim.SGD(v.parameters(), lr=0.25)
    tnn.Assign(v)(torch.tensor([1.0, 2.0, 3.0]))
    assert v.value is p
    (v() ** 2).sum().backward()          # d/dv = 2v at the assigned value
    sgd.step()
    np.testing.assert_allclose(v.value.detach().numpy(), [0.5, 1.0, 1.5])
    tnn.AssignAdd(v)(torch.ones(3))
    assert v.value is p
    np.testing.assert_allclose(p.detach().numpy(), [1.5, 2.0, 2.5])


def test_variable_maps_through_load_jax_params_and_freezes():
    from bigdl_tpu_torch.utils.weights import load_jax_params

    jv = jnn.Variable(jnp.asarray([1.0, -2.0]))
    tv = tnn.Variable(torch.zeros(2), **CPU)
    load_jax_params(tv, jax.tree.map(np.asarray, jv.params_dict()))
    np.testing.assert_array_equal(tv.value.detach().numpy(), [1.0, -2.0])
    frozen = tnn.Variable(torch.zeros(2), trainable=False, **CPU)
    assert frozen.trainable_dict() == {"~params": {"value": False}}
    iv = tnn.Variable(np.arange(3), **CPU)
    assert iv.value.dtype == torch.int64 and not iv.value.requires_grad


def test_tensor_array_writes_are_out_of_place():
    """A stacked result taken before a write keeps its values (JAX's
    arrays are immutable), and a gradient through a loop that reads rows
    back through ``stack()`` and writes new ones equals JAX's."""
    rs = np.random.RandomState(3)
    x0, w = rs.randn(3).astype(f32), rs.randn(3, 3).astype(f32)

    def loop(pkg, x, wt, tanh):
        ta = pkg.tf.TensorArray(4, element_shape=(3,), **pkg.kw)
        ta.write(0, x)
        first = ta.stack()
        for i in range(1, 4):
            ta.write(i, tanh(ta.stack()[i - 1] @ wt))
        return first, ta.stack()

    p = Pkg(port=True)
    xt = torch.from_numpy(x0).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    first, out = loop(p, xt, wt, torch.tanh)
    assert float(first[1:].detach().abs().sum()) == 0.0   # untouched
    (out ** 2).sum().backward()

    def jloss(x, wj):
        return (loop(Pkg(port=False), x, wj, jnp.tanh)[1] ** 2).sum()

    gx, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x0), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **TOL)


def test_tensor_array_index_clamps_and_wraps_as_lax():
    ta = tnn.TensorArray(3, element_shape=(2,), **CPU)
    ta.write(torch.tensor(5), torch.ones(2))
    ta.write(torch.tensor(-1), torch.ones(2) * 2)      # the same last row
    ta.write(torch.tensor(-5), torch.ones(2) * 3)      # wraps to -2, clamps
    np.testing.assert_array_equal(ta.stack()[:, 0].numpy(), [3.0, 0.0, 2.0])
    assert ta.read(torch.tensor(-1)).tolist() == [2.0, 2.0]
    assert ta.read(torch.tensor(9)).tolist() == [2.0, 2.0]


def test_parse_example_keeps_int64():
    """JAX (64-bit types off) reads 2**40 back as 0; the port keeps it."""
    rec = pw.enc_bytes(1, pw.enc_bytes(1, pw.enc_string(1, "n") + pw.enc_bytes(
        2, pw.enc_bytes(3, pw.enc_packed_varints(1, [2 ** 40, -5])))))
    keys = (np.asarray([rec], object), None, "n", np.zeros(2, np.int64))
    out = tnn.ParseExample(1, [np.int64], [(2,)], **CPU)(Table(*keys))
    assert out.dtype == torch.int64 and out.tolist() == [[2 ** 40, -5]]
    theirs = np.asarray(jnn.ParseExample(1, [np.int64], [(2,)])(
        JaxTable(*keys)))
    assert theirs.tolist() == [[0, -5]]


def test_device_making_tf_ops_follow_the_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for make in (lambda: tnn.Variable(np.zeros(2)),
                 lambda: tnn.TensorArray(2),
                 lambda: tnn.ParseExample(1, [np.float32], [()]),
                 lambda: ttf.TensorArrayCreator()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
