"""The port's TF-style ops (bigdl_tpu_torch/nn/ops.py) against the JAX
package's (bigdl_tpu/nn/ops.py) on the same numpy inputs.

``CASES`` holds one or more parity cases for every op: the JAX op and the
port's, built with the same arguments, take the same input (numpy for
JAX, torch tensors on the CPU for the port) and agree within f32 rtol
1e-5 / atol 1e-6, NaN where JAX has NaN; indices, masks, hash buckets and
strings exactly, with the same dtype kind (JAX's int32 indices against
the port's int64). ``test_every_op_is_ported_and_covered`` fails if a
public class or factory of either JAX module has no port counterpart or
no parity case. The hazard tests each hold a place where torch's plain
call parts from ``jax.numpy``; each fails when the op is swapped for that
call. The counterparts of tests/test_parity_tails.py's op cases keep
their names. Random ops are held by their distributions, never their
values (threefry and Philox differ).

Integer division by zero (FloorDiv, Mod, FloorMod) is undefined in both
packages and left out of the cases.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import ops as jops
from bigdl_tpu.nn import tf_ops as jtf
from bigdl_tpu.nn.sparse import SparseTensor as JaxSparse
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn import ops as tops
from bigdl_tpu_torch.nn import tf_ops as ttf
from bigdl_tpu_torch.nn.sparse import SparseTensor
from bigdl_tpu_torch.utils.table import Table

TOL = dict(rtol=1e-5, atol=1e-6)
f32 = np.float32
i32 = np.int32
# the port's ops that make tensors from nothing or from host values take
# device= (the card by default); the tests build them on the CPU
DEVICE_OPS = {"RangeOps", "RandomUniform", "TruncatedNormal", "Kv2Tensor",
              "CategoricalColHashBucket", "CrossCol",
              "CategoricalColVocaList"}


# ------------------------------------------------------------ the harness
class Case:
    """One parity case: ``make(ops_module, port)`` builds the op in either
    package; ``x`` is its numpy input (a tuple is a Table). ``jit`` runs
    the JAX op under ``jax.jit``: one compile in place of one per
    primitive, for the ops of many primitives."""

    def __init__(self, id, make, x, cls=None, jit=False):
        self.id, self.make, self.x, self.cls, self.jit = id, make, x, cls, jit

    def param(self):
        return pytest.param(self, id=self.id)


def mk(id, cls, *args, x, jit=False, **kw):
    def make(o, port):
        extra = dict(device="cpu") if port and cls in DEVICE_OPS else {}
        return getattr(o, cls)(*args, **kw, **extra)

    return Case(id, make, x, cls, jit)


def to_jax(x):
    if isinstance(x, tuple):
        return JaxTable(*[to_jax(v) for v in x])
    return x


def to_port(x):
    if isinstance(x, tuple):
        return Table(*[to_port(v) for v in x])
    if isinstance(x, np.ndarray) and x.dtype.kind in "biuf":
        return torch.from_numpy(x.copy())
    return x


def same(ours, theirs, where="output"):
    """The port's output against JAX's: Tables entry by entry, sparse
    tensors by shape and dense form, strings exactly, floats by TOL,
    everything else exactly, dtype kinds equal."""
    if isinstance(theirs, JaxTable):
        assert isinstance(ours, Table) and len(ours) == len(theirs), where
        for k, (a, b) in enumerate(zip(ours, theirs)):
            same(a, b, f"{where}[{k + 1}]")
        return
    if isinstance(theirs, JaxSparse):
        assert isinstance(ours, SparseTensor), where
        assert ours.shape == tuple(theirs.bcoo.shape), where
        same(ours.to_dense(), theirs.to_dense(), where)
        return
    if isinstance(theirs, (str, bytes)):
        assert ours == theirs, where
        return
    theirs = np.asarray(theirs)
    ours = ours.detach().numpy() if torch.is_tensor(ours) else \
        np.asarray(ours)
    assert ours.shape == theirs.shape, (where, ours.shape, theirs.shape)
    assert ours.dtype.kind == theirs.dtype.kind, (where, ours.dtype,
                                                  theirs.dtype)
    if theirs.dtype.kind == "f":
        np.testing.assert_allclose(ours, theirs, **TOL, err_msg=where)
        zeros = (theirs == 0) & (ours == 0)
        np.testing.assert_array_equal(np.signbit(ours[zeros]),
                                      np.signbit(theirs[zeros]),
                                      err_msg=f"{where}: sign of zero")
    else:
        np.testing.assert_array_equal(ours, theirs, err_msg=where)


def run_both(case):
    op = case.make(jops, False)
    theirs = (jax.jit(lambda x: op(x)) if case.jit else op)(to_jax(case.x))
    ours = case.make(tops, True)(to_port(case.x))
    return ours, theirs


# ------------------------------------------------------------ the inputs
rs = np.random.RandomState(19)
X34 = rs.randn(3, 4).astype(f32)
Y34 = rs.randn(3, 4).astype(f32)
HALVES = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 1.2, -3.7], f32)
SPECIAL = np.asarray([1.0, np.inf, -np.inf, np.nan, -0.0, 0.0], f32)
POS = np.asarray([0.5, 1.0, 2.5, 10.0, 3.3], f32)
GAMMA_X = np.asarray([0.5, 1.0, 2.5, 10.0, -0.5, -2.5, 0.0, -1.0], f32)
SAT = np.asarray([1e10, -1e10, np.nan, np.inf, -np.inf, 300.0, -1.5, 2.7,
                  255.9, -129.0], f32)
INTS_A = np.asarray([-7, 7, 9, -9, 0, 5], i32)
INTS_B = np.asarray([3, -3, 2, 4, 5, -2], i32)
FL_B = np.asarray([3.0, -3.0, 2.5, 0.7, 5.0, -2.0], f32)
BOOL_A = np.asarray([True, False, True, False])
BOOL_B = np.asarray([True, True, False, False])
X234 = rs.randn(2, 3, 4).astype(f32)
TIES = np.asarray([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0], [5, 1, 5, 1, 4]], f32)
NHWC = rs.randn(2, 7, 6, 3).astype(f32)
HWIM = rs.randn(3, 3, 3, 2).astype(f32)
NCHW = np.ascontiguousarray(NHWC.transpose(0, 3, 1, 2))
IMG = rs.rand(1, 8, 8, 2).astype(f32)
WORDS = np.asarray(["engineer", "teacher", "farmer", "artist", "clerk"])
AGES = np.asarray([18.0, 25.0, 34.9, 35.0, 45.0, 64.99, 65.0, 70.0], f32)

UNARY = [
    ("Ceil", HALVES), ("Floor", HALVES), ("Round", HALVES),
    ("Rint", HALVES), ("Exp", X34), ("Expm1", X34 * 1e-3),
    ("Inv", POS), ("Sign", SPECIAL), ("Erf", X34), ("Erfc", X34),
    ("Lgamma", GAMMA_X), ("Digamma", GAMMA_X), ("IsFinite", SPECIAL),
    ("IsInf", SPECIAL), ("IsNan", SPECIAL), ("LogicalNot", BOOL_A),
]
BINARY = [
    ("Pow", (POS, FL_B[:5])), ("FloorDiv", (INTS_A, INTS_B)),
    ("FloorMod", (INTS_A, INTS_B)), ("Mod", (INTS_A * 1.5, FL_B)),
    ("TruncateDiv", (INTS_A, INTS_B)), ("SquaredDifference", (X34, Y34)),
    ("Maximum", (SPECIAL, np.zeros(6, f32))),
    ("Minimum", (SPECIAL, -np.zeros(6, f32))), ("Equal", (INTS_A, INTS_B * -1)),
    ("NotEqual", (INTS_A, INTS_B * -1)), ("Greater", (X34, Y34)),
    ("GreaterEqual", (INTS_A, INTS_B)), ("Less", (X34, Y34)),
    ("LessEqual", (INTS_A, INTS_B)), ("LogicalAnd", (BOOL_A, BOOL_B)),
    ("LogicalOr", (BOOL_A, BOOL_B)),
]


def _module_to_operation(o, port):
    return o.ModuleToOperation((tnn if port else jnn).Tanh())


def _compare(o, port):
    class GreaterPlus(o.Compare):
        compare_fn = staticmethod(lambda a, b: a > b)

    return GreaterPlus()


CASES = (
    [mk(f"{c}", c, x=x) for c, x in UNARY]
    + [mk(f"{c}", c, x=x) for c, x in BINARY]
    + [
        mk("Pow_int", "Pow", x=(INTS_A[:4] % 4,
                                np.asarray([0, 1, 2, 3], i32))),
        mk("FloorDiv_float", "FloorDiv", x=(INTS_A * 1.5, FL_B)),
        mk("Mod_int", "Mod", x=(INTS_A, INTS_B)),
        mk("TruncateDiv_float", "TruncateDiv", x=(INTS_A * 1.5, FL_B)),
        mk("Maximum_broadcast", "Maximum", x=(X234, Y34[0])),
        mk("Minimum_scalar", "Minimum", x=(X34, np.float32(0.25))),
        mk("Cast_saturating_int32", "Cast", np.int32, x=SAT),
        mk("Cast_saturating_int8", "Cast", np.int8, x=SAT),
        mk("Cast_saturating_uint8", "Cast", np.uint8, x=SAT),
        mk("Cast_int_to_f32", "Cast", np.float32, x=INTS_A),
        mk("Cast_to_bool", "Cast", bool, x=SPECIAL),
        mk("ApproximateEqual", "ApproximateEqual", 0.5, x=(X34, Y34)),
        mk("All_none", "All", x=BOOL_A),
        mk("All_axis", "All", (0,), x=X234 > -1.0),
        mk("Any_axes_keep", "Any", (0, 2), True, x=X234 > 1.0),
        mk("Max_axis", "Max", (1,), x=X234),
        mk("Max_none_nan", "Max", x=SPECIAL),
        mk("Prod_axes", "Prod", (0, 2), x=X234),
        mk("Prod_int", "Prod", (1,), x=INTS_A.reshape(2, 3)),
        mk("Sum_none", "Sum", x=X234),
        mk("Sum_neg_axis_keep", "Sum", (-1,), True, x=X234),
        mk("Sum_bool", "Sum", x=BOOL_A),
        mk("ArgMax_ctor", "ArgMax", 1, x=TIES),
        mk("ArgMax_pair", "ArgMax", x=(X234, np.asarray(2, i32))),
        mk("ArgMax_nan", "ArgMax", 0, x=np.asarray([1, np.nan, 3, np.nan],
                                                   f32)),
        mk("BatchMatMul", "BatchMatMul", x=(X234, rs.randn(2, 4, 5).astype(
            f32))),
        mk("BatchMatMul_adj", "BatchMatMul", True, True,
           x=(rs.randn(2, 4, 3).astype(f32), rs.randn(2, 5, 4).astype(f32))),
        mk("Gather_axis0", "Gather", x=(X34, np.asarray([[2, 0], [1, 1]],
                                                        i32))),
        mk("Gather_axis1_edges", "Gather", 1,
           x=(X34, np.asarray([-1, 4, -5, 0, 3], i32))),
        mk("Gather_int_edges", "Gather", x=(INTS_A, np.asarray([-1, 6, 2],
                                                               i32))),
        mk("Gather_float_ids", "Gather", x=(X34, np.asarray([1.7, 0.2],
                                                            f32))),
        mk("OneHot", "OneHot", 4, 2.0, -1.0, x=np.asarray([0, 3, 1, 2], i32)),
        mk("OneHot_axis0_out_of_range", "OneHot", 3, axis=0,
           x=np.asarray([[-1, 3], [1, 2]], i32), jit=True),
        mk("TopK_ties", "TopK", 2, x=TIES),
        mk("TopK_3d", "TopK", 3, x=X234),
        mk("InTopK", "InTopK", 2, x=(TIES, np.asarray([1, 0, 4], i32)),
           jit=True),
        mk("InTopK_out_of_range", "InTopK", 1,
           x=(TIES, np.asarray([7, -1, 0], i32))),
        mk("Rank", "Rank", x=X234),
        mk("Shape", "Shape", x=X234),
        mk("Select", "Select", x=(X34 > 0, X34, Y34)),
        mk("Slice", "Slice", [0, 1, 1], [2, -1, 2], x=X234),
        mk("Tile_ctor", "Tile", [2, 1, 3], x=X234),
        mk("Tile_pair", "Tile", x=(X34, np.asarray([1, 2], i32))),
        mk("Pad", "Pad", [[1, 0], [0, 2], [1, 1]], 0.5, x=X234),
        mk("RangeOps_int", "RangeOps", 2, 11, 3, x=None),
        mk("RangeOps_float", "RangeOps", 0.0, 1.0, 0.25, x=None),
        mk("L2Loss", "L2Loss", x=X234),
        mk("SegmentSum_counted", "SegmentSum",
           x=(X34, np.asarray([0, 0, 2], i32))),
        mk("SegmentSum_out_of_range", "SegmentSum", 3,
           x=(np.ones(4, f32), np.asarray([0, 1, 5, -1], i32))),
        mk("CrossEntropy", "CrossEntropy", x=(X34, np.asarray([0, 3, 1],
                                                              i32)), jit=True),
        mk("CrossEntropy_out_of_range", "CrossEntropy",
           x=(X34, np.asarray([4, -1, 1], i32))),
        mk("ResizeBilinearOp_grow", "ResizeBilinearOp", 13, 11, x=IMG,
           jit=True),
        mk("ResizeBilinearOp_shrink", "ResizeBilinearOp", 3, 5, x=IMG,
           jit=True),
        mk("ResizeBilinearOp_mixed", "ResizeBilinearOp", 5, 12, x=IMG,
           jit=True),
        mk("ResizeBilinearOp_align", "ResizeBilinearOp", 13, 5, True, x=IMG,
           jit=True),
        mk("ResizeBilinear_alias", "ResizeBilinear", 4, 4, True, x=IMG,
           jit=True),
        mk("BucketizedCol", "BucketizedCol", [25.0, 35.0, 45.0, 55.0, 65.0],
           x=AGES),
        mk("BucketizedCol_int", "BucketizedCol", [2.5, 5.0], x=INTS_A),
        mk("CategoricalColHashBucket_str", "CategoricalColHashBucket", 32,
           x=WORDS.reshape(5, 1)),
        mk("CategoricalColHashBucket_int", "CategoricalColHashBucket", 7,
           x=INTS_A),
        mk("IndicatorCol", "IndicatorCol", 6,
           x=np.asarray([0, 5, 6, -1], i32)),
        mk("IndicatorCol_multi_hot", "IndicatorCol", 5,
           x=np.asarray([[0, 2, 2], [4, 7, 1]], i32)),
        mk("CrossCol", "CrossCol", 64, x=[WORDS, WORDS[::-1]]),
        mk("CrossCol_int_float", "CrossCol", 16,
           x=[INTS_A[:3], np.asarray([0.5, 1.25, -3.0], f32)]),
        mk("Kv2Tensor", "Kv2Tensor", ",", ":", 6,
           x=np.asarray(["0:1.5,3:2", "", "5:-1,1:0.25"])),
        mk("MkString", "MkString", "|", x=INTS_A.reshape(2, 3)),
        mk("MkString_float", "MkString", x=np.asarray([[0.5, 1.0]], f32)),
        mk("CategoricalColVocaList_filter", "CategoricalColVocaList",
           ["a", "b", "c"], x=np.asarray(["a,b", "c", "zzz", "c,q,a"])),
        mk("CategoricalColVocaList_default", "CategoricalColVocaList",
           ["a", "b"], ";", True, x=np.asarray(["zzz;a", "b"])),
        mk("CategoricalColVocaList_oov", "CategoricalColVocaList",
           ["a", "b"], num_oov_buckets=4,
           x=np.asarray(["zzz,a,qq", "b,yy"])),
        mk("DepthwiseConv2D_nhwc", "DepthwiseConv2D", 2, 1, 1, 0,
           x=(NHWC, HWIM), jit=True),
        mk("DepthwiseConv2D_nchw", "DepthwiseConv2D", 1, 2, 0, 1, "NCHW",
           x=(NCHW, HWIM), jit=True),
        mk("Dilation2D_same", "Dilation2D", (1, 2, 2, 1), (1, 1, 1, 1),
           x=(NHWC, HWIM[..., 0]), jit=True),
        mk("Dilation2D_same_rates", "Dilation2D", (1, 1, 2, 1), (1, 2, 1, 1),
           "same", x=(NHWC, HWIM[..., 1]), jit=True),
        mk("Dilation2D_valid", "Dilation2D", (1, 1, 1, 1), (1, 1, 2, 1),
           "VALID", x=(NHWC, HWIM[:2, :2, :, 0]), jit=True),
        mk("Substr", "Substr", x=("abcdef", 1, 3)),
        Case("TensorOp", lambda o, port: (((o.TensorOp() + 2.0) * 3.0
                                           - 1.0) / 2.0) ** 2, X34,
             "TensorOp", jit=True),
        Case("TensorOp_named", lambda o, port: o.TensorOp().abs().sqrt()
             .log().exp().sigmoid().tanh(), X34, "TensorOp", jit=True),
        Case("ModuleToOperation", _module_to_operation, X34,
             "ModuleToOperation"),
        Case("Compare", _compare, (X34, Y34), "Compare"),
    ])


@pytest.mark.parametrize("case", [c.param() for c in CASES])
def test_op_matches_jax(case):
    ours, theirs = run_both(case)
    same(ours, theirs)


# ------------------------------------------------------------ coverage
# classes and factories held by a test of their own, not by CASES
HELD_ELSEWHERE = {
    "Operation": "test_operation_is_forward_only",
    "RandomUniform": "test_random_op_matches_jax_distribution",
    "TruncatedNormal": "test_random_op_matches_jax_distribution",
}


def _public(module):
    """The public classes and functions defined in ``module``."""
    return sorted(
        name for name, obj in vars(module).items()
        if not name.startswith("_")
        and (inspect.isclass(obj) or inspect.isfunction(obj))
        and getattr(obj, "__module__", None) == module.__name__)


def _tf_case_names():
    from tests.test_torch_tf_ops import COVERED

    return set(COVERED)


@pytest.mark.parametrize("jax_module,port_module", [
    (jops, tops), (jtf, ttf)], ids=["ops", "tf_ops"])
def test_every_op_is_ported_and_covered(jax_module, port_module):
    names = _public(jax_module)
    # the alias is a name of the module, not a class defined under it
    if jax_module is jops:
        names.append("ResizeBilinear")
        covered = {c.cls for c in CASES} | set(HELD_ELSEWHERE)
    else:
        covered = _tf_case_names()
    assert len(names) > 20
    missing = [n for n in names if not hasattr(port_module, n)]
    assert not missing, f"no port counterpart: {missing}"
    uncovered = [n for n in names if n not in covered]
    assert not uncovered, f"no parity case: {uncovered}"


def test_nn_keeps_its_layers_of_the_ops_names():
    """``nn.Select`` / ``Max`` / ``Sum`` / ``Tile`` stay the port's layers,
    as JAX keeps its own; the ops live under ``nn.ops`` only."""
    from bigdl_tpu_torch.nn import shape_ops, table_ops

    assert tnn.Select is shape_ops.Select and tnn.Tile is shape_ops.Tile
    assert tnn.Max is table_ops.Max and tnn.Sum is table_ops.Sum
    assert tnn.ops is tops and tnn.tf_ops is ttf
    for name in ("Select", "Max", "Sum", "Tile"):
        assert getattr(tnn, name) is not getattr(tops, name)
        assert getattr(jnn, name) is not getattr(jops, name)
    lifted = {"WhileLoop", "If", "ControlNodes", "Variable", "Assign",
              "AssignAdd", "AssignSub", "TensorArray", "ParseExample"}
    for name in lifted:
        assert getattr(tnn, name) is getattr(ttf, name)
        assert getattr(jnn, name) is getattr(jtf, name)


def test_operation_is_forward_only():
    x = torch.randn(2, 3)
    for op in (tops.Floor(), tops.ModuleToOperation(tnn.Tanh())):
        with pytest.raises(RuntimeError, match="forward-only Operation"):
            op.backward(x, x)
        with pytest.raises(RuntimeError, match="forward-only Operation"):
            op.update_grad_input(x, x)
    with pytest.raises(RuntimeError, match="forward-only Operation"):
        jops.Floor().backward(jnp.ones(2), jnp.ones(2))
    # autograd through the torch ops stays available
    x.requires_grad_(True)
    tops.TensorOp().exp()(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x.exp().detach().numpy(),
                               **TOL)


@pytest.mark.parametrize("cls,kw", [
    ("RandomUniform", dict(minval=-2.0, maxval=3.0)),
    ("TruncatedNormal", dict(mean=1.0, stddev=2.0))])
def test_random_op_matches_jax_distribution(cls, kw):
    """Same range and truncation, and moments within sampling error of
    JAX's draw over 20000 values; a seeded op repeats its stream from the
    seed, and ``bind_generator`` reaches it."""
    shape = np.asarray([100, 200], i32)
    theirs = np.asarray(getattr(jops, cls)(**kw, seed=3)(shape))
    op = getattr(tops, cls)(**kw, seed=3, device="cpu")
    ours = op(torch.from_numpy(shape)).numpy()
    assert ours.shape == theirs.shape == (100, 200)
    assert ours.dtype == theirs.dtype == np.float32
    if cls == "RandomUniform":
        lo, hi = -2.0, 3.0
        sd = 5.0 / np.sqrt(12.0)
    else:
        lo, hi = 1.0 - 4.0, 1.0 + 4.0
        sd = 2.0 * 0.8796                 # sd of N(0, 1) cut at +-2
    for v in (ours, theirs):
        assert v.min() >= lo and v.max() <= hi
        assert abs(v.mean() - (lo + hi) / 2) < 5 * sd / np.sqrt(v.size)
        assert abs(v.std() - sd) < 0.02 * sd
    again = getattr(tops, cls)(**kw, seed=3, device="cpu")
    np.testing.assert_array_equal(again(shape).numpy(), ours)
    g = torch.Generator().manual_seed(5)
    tnn.bind_generator(tnn.Sequential(op), g)
    assert op.generator is g
    first = op(shape)
    g.manual_seed(5)
    np.testing.assert_array_equal(op(shape).numpy(), first.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(tops, cls)(**kw)


# ------------------------------------------------------------ hazards
def test_topk_ties_lowest_index_first():
    x = np.asarray([1, 3, 3, 2, 3], f32)
    vals, idx = tops.TopK(2)(torch.from_numpy(x))
    assert idx.tolist() == [1, 2]
    assert idx.tolist() == np.asarray(jops.TopK(2)(x)[2]).tolist()
    np.testing.assert_array_equal(vals.numpy(), [3.0, 3.0])


def test_one_hot_and_indicator_ids_out_of_range_give_zero_rows():
    ids = np.asarray([-1, 3, 1], i32)
    ours = tops.OneHot(3)(torch.from_numpy(ids))
    np.testing.assert_array_equal(ours.numpy(), [[0, 0, 0], [0, 0, 0],
                                                 [0, 1, 0]])
    same(ours, jops.OneHot(3)(ids))
    multi = np.asarray([[-1, 3, 1], [3, 3, 0]], i32)
    same(tops.IndicatorCol(3)(torch.from_numpy(multi)),
         jops.IndicatorCol(3)(multi))
    same(tops.IndicatorCol(3)(torch.from_numpy(ids)),
         jops.IndicatorCol(3)(ids))


def test_gather_wraps_and_fills_as_jnp_take():
    idx = np.asarray([-1, 3, -4, 1], i32)
    for params, fill in ((np.arange(3, dtype=f32), np.nan),
                         (np.arange(3, dtype=i32), -2 ** 31)):
        ours = tops.Gather()((torch.from_numpy(params),
                              torch.from_numpy(idx)))
        np.testing.assert_array_equal(ours.numpy(),
                                      [2, fill, fill, 1])
        same(ours, jops.Gather()([params, idx]))
    ours = tops.Gather()((torch.tensor([1, 2, 3], dtype=torch.uint8),
                          torch.tensor([3])))
    assert ours.tolist() == [255]
    ours = tops.Gather()((torch.tensor([True, False]), torch.tensor([2])))
    assert ours.tolist() == [True]


def test_segment_sum_drops_ids_out_of_range():
    ids = np.asarray([0, 1, 5, -1], i32)
    ours = tops.SegmentSum(3)((torch.ones(4), torch.from_numpy(ids)))
    assert ours.tolist() == [1.0, 1.0, 0.0]
    same(ours, jops.SegmentSum(3)([np.ones(4, f32), ids]))


def test_sign_keeps_nan_and_negative_zero():
    ours = tops.Sign()(torch.tensor([-0.0, np.nan, -2.0, 0.0, 3.0]))
    assert torch.signbit(ours[0]) and torch.isnan(ours[1])
    assert ours[2:].tolist() == [-1.0, 0.0, 1.0]
    theirs = np.asarray(jops.Sign()(np.asarray([-0.0, np.nan], f32)))
    assert np.signbit(theirs[0]) and np.isnan(theirs[1])


def test_maximum_and_minimum_of_signed_zeros_as_jnp():
    a = np.asarray([-0.0, 0.0, -0.0, 0.0], f32)
    b = np.asarray([0.0, -0.0, -0.0, 0.0], f32)
    for cls, signs in (("Maximum", [False, False, True, False]),
                       ("Minimum", [True, True, True, False])):
        ours = getattr(tops, cls)()((torch.from_numpy(a),
                                     torch.from_numpy(b)))
        assert torch.signbit(ours).tolist() == signs, cls
        same(ours, getattr(jops, cls)()([a, b]))


def test_digamma_is_nan_at_zero():
    x = np.asarray([0.0, -0.0, -1.0, 1.0], f32)
    ours = tops.Digamma()(torch.from_numpy(x))
    assert torch.isnan(ours[:3]).all()
    same(ours, jops.Digamma()(x))


def test_cast_and_truncate_div_saturate():
    ours = tops.Cast(np.int32)(torch.tensor([1e10, -1e10, np.nan, 2.7]))
    assert ours.tolist() == [2 ** 31 - 1, -2 ** 31, 0, 2]
    assert ours.dtype == torch.int32
    a, b = np.asarray([7, -7, 0, 7], i32), np.asarray([0, 0, 0, 2], i32)
    ours = tops.TruncateDiv()((torch.from_numpy(a), torch.from_numpy(b)))
    assert ours.tolist() == [2 ** 31 - 1, -2 ** 31, 0, 3]
    same(ours, jops.TruncateDiv()([a, b]))


def test_mod_takes_the_divisors_sign():
    a, b = np.asarray([-7, 7], i32), np.asarray([3, -3], i32)
    for cls in ("Mod", "FloorMod"):
        ours = getattr(tops, cls)()((torch.from_numpy(a),
                                     torch.from_numpy(b)))
        assert ours.tolist() == [2, -2]
        same(ours, getattr(jops, cls)()([a, b]))


def test_resize_bilinear_antialiases_when_shrinking():
    x = rs.rand(1, 8, 8, 3).astype(f32)
    ours = tops.ResizeBilinearOp(3, 5)(torch.from_numpy(x))
    same(ours, jops.ResizeBilinearOp(3, 5)(x))


def test_bucketized_col_puts_a_boundary_in_the_bucket_above():
    x = np.asarray([24.9, 25.0, 35.0, 70.0], f32)
    ours = tops.BucketizedCol([25.0, 35.0])(torch.from_numpy(x))
    assert ours.tolist() == [0, 1, 2, 2]
    same(ours, jops.BucketizedCol([25.0, 35.0])(x))


def test_hash_buckets_of_tensor_inputs_equal_jax():
    """Tensors hash by value (``str`` of a numpy element), not as
    ``tensor(3)``: the buckets of a tensor input equal JAX's of the same
    numpy values, on every column that hashes."""
    ints, floats = INTS_A, np.asarray([0.5, 1.25, -3.0, 2.0, 0.0, 7.0], f32)
    for vals in (ints, floats):
        ours = tops.CategoricalColHashBucket(1000, device="cpu")(
            torch.from_numpy(vals))
        same(ours, jops.CategoricalColHashBucket(1000)(vals))
    ours = tops.CrossCol(1000, device="cpu")([torch.from_numpy(ints),
                                              torch.from_numpy(floats)])
    same(ours, jops.CrossCol(1000)([ints, floats]))
    oov = np.asarray(["zz,y", "xx"])
    same(tops.CategoricalColVocaList(["a"], num_oov_buckets=50,
                                     device="cpu")(oov),
         jops.CategoricalColVocaList(["a"], num_oov_buckets=50)(oov))


def test_index_dtypes_are_int64_and_float64_is_kept():
    """JAX (64-bit types off) returns int32 indices and computes float64
    in float32; the port returns int64 and keeps float64."""
    x = torch.from_numpy(X34.astype(np.float64))
    assert tops.ArgMax(1)(x).dtype == torch.int64
    assert tops.TopK(2)(x)[2].dtype == torch.int64
    assert tops.Rank()(x).dtype == tops.Shape()(x).dtype == torch.int64
    assert tops.BucketizedCol([0.0])(x).dtype == torch.int64
    assert tops.Exp()(x).dtype == torch.float64
    assert np.asarray(jops.ArgMax(1)(X34)).dtype == np.int32
    np.testing.assert_allclose(tops.Exp()(x).numpy(),
                               np.exp(X34.astype(np.float64)), rtol=1e-12)


def test_ops_compute_on_their_inputs_device():
    """Tensors stay where they are; numpy and Python numbers join the
    first tensor; ops that make tensors follow the device rule."""
    a = torch.ones(3)
    assert tops.Maximum()((a, np.zeros(3, f32))).device == a.device
    assert tops.Select()((np.asarray([True, False, True]), a, 2.0)).tolist() \
        == [1.0, 2.0, 1.0]
    if not torch.cuda.is_available():
        for make in (lambda: tops.RangeOps(0, 3),
                     lambda: tops.Kv2Tensor(feat_len=2),
                     lambda: tops.CategoricalColHashBucket(4),
                     lambda: tops.CrossCol(4),
                     lambda: tops.CategoricalColVocaList(["a"])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


# ---------------------------- counterparts of tests/test_parity_tails.py
def test_categorical_col_voca_list_modes():
    # ≙ nn/ops/CategoricalColVocaList.scala
    op = tops.CategoricalColVocaList(["a", "b", "c"], device="cpu")
    st = op(np.asarray(["a,b", "c", "zzz"]))
    assert st.shape == (3, 3)
    dense = st.to_dense().numpy()
    assert dense[0, 0] == 0 and dense[0, 1] == 1 and dense[1, 0] == 2
    assert dense[2].sum() == 0  # OOV filtered

    op_d = tops.CategoricalColVocaList(["a", "b"], is_set_default=True,
                                       device="cpu")
    st_d = op_d(np.asarray(["zzz"]))
    assert st_d.shape == (1, 3)
    assert st_d.to_dense().numpy()[0, 0] == 2  # default id = len(voca)

    op_h = tops.CategoricalColVocaList(["a", "b"], num_oov_buckets=4,
                                       device="cpu")
    v = int(op_h(np.asarray(["zzz"])).to_dense()[0, 0])
    assert 2 <= v < 6

    with pytest.raises(ValueError, match="at most"):
        op(np.asarray(["a,b,c,a"]))  # 4 features > 3 columns: explicit error
    for args, kw, msg in ((["a"], dict(num_oov_buckets=-1), "negative"),
                          (["a"], dict(is_set_default=True,
                                       num_oov_buckets=1), "both"),
                          ([], {}, "empty"), (["a", "a"], {}, "duplicates")):
        with pytest.raises(ValueError, match=msg):
            tops.CategoricalColVocaList(args, **kw, device="cpu")


def test_depthwise_conv2d_op_matches_manual():
    # ≙ nn/ops/DepthwiseConv2D.scala (NHWC, filter HWIM)
    x = torch.randn(1, 5, 5, 2, generator=torch.Generator().manual_seed(1))
    filt = torch.randn(3, 3, 2, 1, generator=torch.Generator().manual_seed(2))
    out = tops.DepthwiseConv2D()([x, filt])
    assert out.shape == (1, 3, 3, 2)
    # channel 0 of the output only sees input channel 0
    manual = F.conv2d(x[..., :1].permute(0, 3, 1, 2),
                      filt[:, :, :1, 0][None].permute(0, 3, 1, 2))
    np.testing.assert_allclose(out[..., 0].numpy(), manual[:, 0].numpy(),
                               rtol=2e-5, atol=1e-5)


def test_dilation2d_valid_matches_manual():
    # ≙ nn/ops/Dilation2D.scala: out = max over window of (x + filter)
    x = torch.arange(16.0).reshape(1, 4, 4, 1)
    filt = torch.zeros((2, 2, 1))
    out = tops.Dilation2D(strides=(1, 1, 1, 1), rates=(1, 1, 1, 1),
                          padding="VALID")([x, filt])
    assert out.shape == (1, 3, 3, 1)
    # zero filter -> plain 2x2 max pool stride 1
    np.testing.assert_allclose(out[0, :, :, 0].numpy(),
                               [[5, 6, 7], [9, 10, 11], [13, 14, 15]])


def test_dilation2d_same_shape():
    x = torch.zeros((1, 5, 5, 2))
    filt = torch.ones((3, 3, 2))
    out = tops.Dilation2D(strides=(1, 2, 2, 1), rates=(1, 1, 1, 1),
                          padding="SAME")([x, filt])
    assert out.shape == (1, 3, 3, 2)
    np.testing.assert_allclose(out[0, 1, 1].numpy(), [1.0, 1.0])


def test_substr_op():
    # ≙ nn/ops/Substr.scala
    assert tops.Substr()(Table("abcdef", 1, 3)) == "bcd"


def test_tensor_op_combinators():
    # ≙ nn/ops/TensorOp.scala: (op + 2) * 3 chains into one function
    op = (tops.TensorOp() + 2.0) * 3.0
    np.testing.assert_allclose(op(torch.tensor([1.0, 0.0])).numpy(),
                               [9.0, 6.0])
    np.testing.assert_allclose(
        tops.TensorOp().abs().sqrt()(torch.tensor([-4.0])).numpy(), [2.0])


def test_compare_base_subclass():
    class GreaterPlus(tops.Compare):
        compare_fn = staticmethod(lambda a, b: a > b)

    out = GreaterPlus()([torch.tensor([1.0, 5.0]), torch.tensor([2.0, 2.0])])
    assert out.tolist() == [False, True]
    with pytest.raises(NotImplementedError):
        tops.Compare()([torch.ones(1), torch.ones(1)])


def test_ops_resize_bilinear_name_alias():
    assert tops.ResizeBilinear is tops.ResizeBilinearOp
