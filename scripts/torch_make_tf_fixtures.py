"""Write the small TF GraphDefs the port's TF import is held against on
the card, each with TensorFlow's own outputs.

The card's machine has no tensorflow, so the fixtures are made where it
is installed and committed under ``tests/data/torch_tf/``:

- ``tf1_while``: a ``tf.while_loop`` frozen with the default lowering
  (a TF1 Enter/Merge/Switch/LoopCond/NextIteration/Exit frame);
- ``functional_while_topk``: a functional ``While`` whose body runs
  ``TopK`` (``lower_control_flow=False``);
- ``nested_cond``: a ``tf.cond`` inside a ``tf.cond``, lowered to TF1
  Switch/Merge;
- ``tf1_linear``: the unfrozen TF1 linear graph of
  ``tests/test_tf_session.py`` (``VariableV2`` + ``Assign`` initializers),
  which ``utils/tf_session.py::Session`` trains.

Each fixture is ``<name>.pb`` (the GraphDef), ``<name>.npz`` (inputs
``x<i>`` and TF's outputs ``y<i>_<j>``) and ``<name>.json`` (input and
output names, the number of cases). Run from the repo root:

    python scripts/torch_make_tf_fixtures.py [out_dir]
"""

import json
import os
import sys

import numpy as np

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")

import tensorflow as tf  # noqa: E402
from tensorflow.python.framework.convert_to_constants import (  # noqa: E402
    convert_variables_to_constants_v2,
)

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data", "torch_tf")
LINEAR_W0 = np.zeros((3, 1), np.float32)
LINEAR_B0 = np.zeros((1,), np.float32)


def _write(out, name, graph_bytes, inputs, outputs, cases, note):
    with open(os.path.join(out, f"{name}.pb"), "wb") as f:
        f.write(graph_bytes)
    arrays = {}
    for i, (x, ys) in enumerate(cases):
        arrays[f"x{i}"] = x
        for j, y in enumerate(ys):
            arrays[f"y{i}_{j}"] = y
    np.savez(os.path.join(out, f"{name}.npz"), **arrays)
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump({"graph": f"{name}.pb", "io": f"{name}.npz",
                   "inputs": inputs, "outputs": outputs,
                   "cases": len(cases), "note": note}, f, indent=1)
        f.write("\n")


def _frozen(fn, lower):
    cf = convert_variables_to_constants_v2(fn.get_concrete_function(),
                                           lower_control_flow=lower)
    return cf, cf.graph.as_graph_def().SerializeToString()


def _run(cf, x):
    r = cf(tf.constant(x))
    return [t.numpy() for t in (r if isinstance(r, (list, tuple)) else [r])]


def tf1_while(out):
    @tf.function(input_signature=[tf.TensorSpec([64], tf.float32)])
    def f(x):
        def cond(i, v):
            return i < 8

        def body(i, v):
            return i + 1, v * 1.25 + tf.tanh(v) - tf.cast(i, tf.float32) * 0.1

        _, v = tf.while_loop(cond, body, [tf.constant(0), x])
        return v

    cf, gd = _frozen(f, lower=True)
    rs = np.random.RandomState(0)
    xs = [rs.randn(64).astype(np.float32) for _ in range(2)]
    _write(out, "tf1_while", gd, ["x"], ["Identity"],
           [(x, _run(cf, x)) for x in xs],
           "tf.while_loop of 8 iterations, TF1 frame (lowered)")


def functional_while_topk(out):
    @tf.function(input_signature=[tf.TensorSpec([16], tf.float32)])
    def f(x):
        def cond(i, v):
            return i < 3

        def body(i, v):
            vals, idxs = tf.math.top_k(v, k=16)
            return i + 1, vals * 0.5 + tf.cast(idxs, tf.float32) * 0.25

        _, v = tf.while_loop(cond, body, [tf.constant(0), x])
        return v

    cf, gd = _frozen(f, lower=False)
    rs = np.random.RandomState(1)
    xs = [rs.randn(16).astype(np.float32) for _ in range(2)]
    _write(out, "functional_while_topk", gd, ["x"], ["Identity"],
           [(x, _run(cf, x)) for x in xs],
           "functional While whose body runs TopK (lower_control_flow=False)")


def nested_cond(out):
    @tf.function(input_signature=[tf.TensorSpec([2, 8], tf.float32)])
    def g(x):
        return tf.cond(
            x[0, 0] > 0.0,
            lambda: tf.cond(x[0, 1] > 0.0, lambda: tf.tanh(x) * 2.0,
                            lambda: x * 3.0),
            lambda: tf.nn.softmax(x) - 10.0)

    cf, gd = _frozen(g, lower=True)
    rs = np.random.RandomState(2)
    xs = []
    for s0, s1 in ((1, 1), (1, -1), (-1, 1)):
        x = rs.randn(2, 8).astype(np.float32)
        x[0, 0], x[0, 1] = s0 * abs(x[0, 0]) + s0 * 0.1, \
            s1 * abs(x[0, 1]) + s1 * 0.1
        xs.append(x)
    _write(out, "nested_cond", gd, ["x"], ["Identity"],
           [(x, _run(cf, x)) for x in xs],
           "tf.cond nested in tf.cond, TF1 Switch/Merge (lowered)")


def tf1_linear(out):
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [None, 3], name="x")
        w = tf.compat.v1.get_variable("w", initializer=tf.constant(LINEAR_W0))
        b = tf.compat.v1.get_variable("b", initializer=tf.constant(LINEAR_B0))
        pred = tf.identity(tf.matmul(x, w) + b, name="pred")
        init = tf.compat.v1.global_variables_initializer()
    rs = np.random.RandomState(3)
    xs = [rs.randn(16, 3).astype(np.float32)]
    with tf.compat.v1.Session(graph=g) as s:
        s.run(init)
        cases = [(xx, [s.run(pred, {x: xx})]) for xx in xs]
    _write(out, "tf1_linear", g.as_graph_def().SerializeToString(), ["x"],
           ["pred"], cases,
           "unfrozen TF1 linear model (VariableV2 + Assign), as "
           "tests/test_tf_session.py builds it; Session.train trains it")


def main(argv) -> int:
    out = argv[0] if argv else OUT
    os.makedirs(out, exist_ok=True)
    for make in (tf1_while, functional_while_topk, nested_cond, tf1_linear):
        make(out)
    for name in sorted(os.listdir(out)):
        print(f"{name} {os.path.getsize(os.path.join(out, name))}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
