"""TF infra ops: control flow, state, TensorArray dataflow, tf.Example
parsing (port of ``bigdl_tpu/nn/tf_ops.py``).

Control flow is host Python over device tensors. ``WhileLoop`` reads its
condition once an iteration and ``If`` and ``Assert`` read their
predicate once a call: each read of a tensor on the card is one
device-to-host sync, counted in the module's ``host_syncs``. Where JAX
traces one ``lax.while_loop`` / ``lax.cond``, the port keeps their
contracts: ``WhileLoop`` raises ``TypeError`` when ``body`` changes the
number, shape, dtype or device of the loop variables (a Python loop
would accept the change) and stops at ``max_iterations``; ``Merge`` with
a predicate takes both branches and selects with ``torch.where``;
``Switch`` returns ``Table(data, data, pred)``; ``Assert`` always checks
(there is no trace in which to elide it).

``Variable`` is a ``Parameter`` named ``value`` (``load_jax_params`` maps
it; ``trainable=False`` freezes it). ``Assign`` writes into that same
``Parameter`` in place under ``no_grad``, so an optimizer holding it sees
the new value.

``TensorArray`` keeps a stacked buffer on its device. ``write`` and
``scatter`` replace the buffer out of place (``index_put``), so a
gradient through a loop of writes is right. Indices act as in
``lax.dynamic_update_index_in_dim`` / ``dynamic_index_in_dim``: a
negative index wraps once and one out of range clamps; ``gather`` and
``scatter`` follow ``jnp.take`` and ``.at[].set`` (fill, drop).

``ParseExample`` decodes serialized ``tf.Example`` records on the host
with ``utils/protowire`` and makes the dense outputs on its device.
Int64 features stay int64 (JAX, with 64-bit types off, truncates them to
int32: 2**40 reads back as 0 there).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.ops import (_host_array, _host_ints, _take,
                                    _torch_dtype)
from bigdl_tpu_torch.utils import protowire as pw
from bigdl_tpu_torch.utils.table import Table


def _as_tuple(act):
    if isinstance(act, (Table, list, tuple)):
        return tuple(act)
    return (act,)


def _as_activity(vals):
    vals = tuple(vals)
    return vals[0] if len(vals) == 1 else Table(*vals)


def _as_loop_var(v):
    return v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))


def _signature(vals):
    return [(tuple(v.shape), v.dtype, v.device) for v in vals]


class _HostControl(Module):
    """A module whose forward reads a device value on the host: each read
    adds one to ``host_syncs`` (a sync where the value lives on the card)."""

    def __init__(self):
        super().__init__()
        self.host_syncs = 0

    def _read_bool(self, x) -> bool:
        self.host_syncs += 1
        return bool(torch.as_tensor(x).reshape(()))

    @staticmethod
    def _call(fn, vals):
        return fn(_as_activity(vals)) if isinstance(fn, Module) else fn(*vals)


class WhileLoop(_HostControl):
    """Run ``body`` while ``cond`` holds over a tuple of loop vars
    (≙ ControlNodes.whileLoop, ControlOps.scala:296-326).

    ``cond``/``body`` are callables over the unpacked loop vars (a Module —
    e.g. an imported sub-Graph — or any function). ``body`` must return
    the same number of vars with the same shapes, dtypes and devices, as
    ``lax.while_loop`` requires; else ``TypeError``. ``cond`` is read on
    the host once an iteration (``host_syncs``); ``iterations`` is the
    last call's count."""

    def __init__(self, cond: Callable, body: Callable,
                 max_iterations: Optional[int] = None):
        super().__init__()
        self._cond, self._body = cond, body
        self.max_iterations = max_iterations
        self.iterations = 0

    def forward(self, input):
        vals = tuple(_as_loop_var(v) for v in _as_tuple(input))
        sig = _signature(vals)
        i = 0
        while (self.max_iterations is None or i < self.max_iterations) \
                and self._read_bool(self._call(self._cond, vals)):
            new = tuple(_as_loop_var(v)
                        for v in _as_tuple(self._call(self._body, vals)))
            if _signature(new) != sig:
                raise TypeError(
                    "body_fun output and input must have identical types: "
                    f"loop vars {sig}, body returned {_signature(new)}")
            vals = new
            i += 1
        self.iterations = i
        return _as_activity(vals)


class If(_HostControl):
    """Predicated branch (≙ the TF If op / reference cond subgraphs):
    input = Table(pred, *branch_args); the predicate is read on the host
    and only the branch taken runs."""

    def __init__(self, then_branch: Callable, else_branch: Callable):
        super().__init__()
        self._then, self._else = then_branch, else_branch

    def forward(self, input):
        vals = _as_tuple(input)
        branch = self._then if self._read_bool(vals[0]) else self._else
        return self._call(branch, vals[1:])


class Switch(Module):
    """≙ SwitchOps (ControlOps.scala:66): input Table(data, pred) ->
    Table(false_out, true_out, pred). Outside a dataflow scheduler both
    outputs are the data itself; ``Merge`` selects by the predicate. Kept
    for graph-shape parity with imported TF1 graphs."""

    def forward(self, input):
        data, pred = _as_tuple(input)
        return Table(data, data, torch.as_tensor(pred).reshape(()).to(
            torch.bool))


def _select(pred, f, t):
    if isinstance(f, (Table, list, tuple)):
        out = [_select(pred, a, b) for a, b in zip(_as_tuple(f),
                                                   _as_tuple(t))]
        return Table(*out) if isinstance(f, Table) else type(f)(out)
    return torch.where(pred, t, f)


class Merge(Module):
    """≙ MergeOps (ControlOps.scala:86): select whichever branch was taken.
    Both branches are computed (pure) and ``torch.where`` selects: no
    scheduler and no host read."""

    def forward(self, input):
        vals = _as_tuple(input)
        if len(vals) == 3:  # (false_val, true_val, pred) from paired Switch
            f, t, pred = vals
            return _select(pred, f, t)
        return vals[0]


class Enter(Module):
    """Loop-frame entry marker (≙ Enter, ControlOps.scala:198). Identity
    under structured control flow."""

    def __init__(self, frame: str = ""):
        super().__init__()
        self.frame = frame

    def forward(self, input):
        return input


class Exit(Module):
    """≙ Exit (ControlOps.scala:226); identity under structured control flow."""

    def forward(self, input):
        return input


class NextIteration(Module):
    """≙ NextIteration (ControlOps.scala:179); identity under structured
    control flow."""

    def forward(self, input):
        return input


class NoOp(Module):
    """≙ nn/tf/NoOp.scala — control-dependency anchor; passes input through."""

    def forward(self, input):
        return input


class ControlDependency(NoOp):
    """≙ nn/tf/ControlDependency.scala — ordering edge; identity on data."""


class Assert(_HostControl):
    """≙ nn/tf/Assert.scala: input Table(pred, data); raises
    ``AssertionError`` on a false predicate, read on the host every call."""

    def __init__(self, message: str = "assertion failed"):
        super().__init__()
        self.message = message

    def forward(self, input):
        vals = _as_tuple(input)
        if not self._read_bool(vals[0]):
            raise AssertionError(self.message)
        return _as_activity(vals[1:])


class ControlNodes:
    """Factory mirroring the reference's ControlNodes object
    (ControlOps.scala:240-326) with structured lowering."""

    @staticmethod
    def while_loop(cond: Callable, body: Callable, loop_vars,
                   name: str = None, max_iterations: Optional[int] = None):
        """Immediate-mode while loop over concrete loop vars: a
        :class:`WhileLoop` (named ``name``) run now."""
        m = WhileLoop(cond, body, max_iterations)
        if name:
            m.set_name(name)
        return m.forward(_as_activity(loop_vars))

    @staticmethod
    def switch(data, condition):
        return Switch().forward(Table(data, condition))

    @staticmethod
    def merge(*branches):
        return Merge().forward(Table(*branches))


# --------------------------------------------------------------- state ops
class Variable(Module):
    """≙ nn/tf/StateOps.scala Variable: a stateful tensor exposed as the
    parameter ``value`` on ``device`` (trainable unless ``trainable`` is
    False; an integer value takes no gradient)."""

    def __init__(self, value, trainable: bool = True, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        t = value.detach().clone() if torch.is_tensor(value) else \
            torch.as_tensor(np.asarray(value))
        t = t.to(resolve_device(device))
        self.value = torch.nn.Parameter(
            t, requires_grad=t.is_floating_point() or t.is_complex())
        if not trainable:
            self.freeze()

    def forward(self, input=None):
        return self.value


class Assign(Module):
    """≙ StateOps.scala Assign (:71): input Table(ref_ignored, value) or
    value; writes into the bound Variable's ``Parameter`` in place (the
    same object, so an optimizer holding it sees the new value) and
    returns it."""

    def __init__(self, variable: Variable, op: str = "set"):
        super().__init__()
        self._var = variable
        self._op = op

    def forward(self, input):
        value = _as_tuple(input)[-1]
        param = self._var.value
        value = torch.as_tensor(value, device=param.device)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"Assign of shape {tuple(value.shape)} to a "
                             f"Variable of shape {tuple(param.shape)}")
        with torch.no_grad():
            if self._op == "add":
                param.add_(value)
            elif self._op == "sub":
                param.sub_(value)
            else:
                param.copy_(value)
        return param


def AssignAdd(variable):  # ≙ tf AssignAdd lowering
    return Assign(variable, op="add")


def AssignSub(variable):
    return Assign(variable, op="sub")


# ----------------------------------------------------------- TensorArray ops
class TensorArray:
    """Fixed-capacity stacked buffer (≙ DataFlowOps.scala TensorArray:45) on
    ``device``. Capacity is fixed at creation, as in JAX; the buffer is
    made at the first write, scatter, split or unstack unless
    ``element_shape`` is given (then in ``dtype``; else in the first
    element's dtype, as JAX does)."""

    def __init__(self, size: int, dtype=torch.float32,
                 element_shape: Optional[Sequence[int]] = None, *,
                 device=DEFAULT_DEVICE):
        self.size = size
        self.dtype = _torch_dtype(dtype)
        self.device = resolve_device(device)
        self.buffer = (torch.zeros((size,) + tuple(element_shape),
                                   dtype=self.dtype, device=self.device)
                       if element_shape is not None else None)
        self._written = np.zeros((size,), bool)

    def _ensure(self, elem: torch.Tensor) -> None:
        if self.buffer is None:
            self.buffer = torch.zeros((self.size,) + tuple(elem.shape),
                                      dtype=elem.dtype, device=self.device)

    def _row(self, index) -> torch.Tensor:
        """``index`` as a (1,) device index: a negative one wrapped once,
        then clamped into the buffer."""
        i = torch.as_tensor(index, device=self.device).to(torch.int64)
        i = torch.where(i < 0, i + self.size, i)
        return i.clamp(0, self.size - 1).reshape(1)

    def write(self, index, value) -> "TensorArray":
        value = torch.as_tensor(value, device=self.device)
        self._ensure(value)
        self.buffer = self.buffer.index_put(
            (self._row(index),), value.to(self.buffer.dtype)[None])
        if isinstance(index, (int, np.integer)):
            self._written[int(index)] = True
        return self

    def read(self, index):
        if self.buffer is None:
            raise ValueError("reading from an empty TensorArray")
        return self.buffer.index_select(0, self._row(index))[0]

    def gather(self, indices):
        return _take(self.buffer, indices, 0)

    def scatter(self, indices, values) -> "TensorArray":
        """Rows ``values[k]`` at ``indices[k]``; a negative index wraps
        once, one still out of range is dropped (into a spare row)."""
        values = torch.as_tensor(values, device=self.device)
        self._ensure(values[0])
        idx = torch.as_tensor(indices, device=self.device).to(torch.int64)
        idx = torch.where(idx < 0, idx + self.size, idx)
        idx = torch.where((idx >= 0) & (idx < self.size), idx, self.size)
        spare = torch.cat([self.buffer, self.buffer[:1]])
        self.buffer = spare.index_put(
            (idx,), values.to(self.buffer.dtype))[:self.size]
        return self

    def unstack(self, values) -> "TensorArray":
        values = torch.as_tensor(values, device=self.device)
        self.size = int(values.shape[0])
        self.buffer = values
        self._written[:] = True
        return self

    def stack(self):
        return self.buffer

    def concat(self):
        b = self.buffer
        return b.reshape((-1,) + tuple(b.shape[2:]))

    def split(self, value, lengths) -> "TensorArray":
        """≙ TensorArraySplit: rows of ``value`` chunked by ``lengths``;
        unequal chunks are zero-padded to the longest."""
        value = torch.as_tensor(value, device=self.device)
        lengths = _host_ints(lengths)
        width = max(lengths)
        pieces = torch.split(value, lengths)
        pad = [0, 0] * (value.dim() - 1)
        return self.unstack(torch.stack(
            [F.pad(p, pad + [0, width - p.shape[0]]) for p in pieces]))


class TensorArrayCreator(Module):
    """≙ DataFlowOps.scala TensorArrayCreator(:176): size -> new handle."""

    def __init__(self, dtype=torch.float32, element_shape=None, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.dtype = dtype
        self.element_shape = element_shape
        self.device = resolve_device(device)

    def forward(self, input):
        return TensorArray(_host_ints(input)[0], self.dtype,
                           self.element_shape, device=self.device)


class TensorArrayWrite(Module):
    def forward(self, input):
        ta, index, value = _as_tuple(input)
        return ta.write(index, value)


class TensorArrayRead(Module):
    def forward(self, input):
        ta, index = _as_tuple(input)
        return ta.read(index)


class TensorArrayGather(Module):
    def forward(self, input):
        ta, indices = _as_tuple(input)
        return ta.gather(indices)


class TensorArrayScatter(Module):
    def forward(self, input):
        ta, indices, values = _as_tuple(input)
        return ta.scatter(indices, values)


class TensorArrayConcat(Module):
    def forward(self, input):
        return _as_tuple(input)[0].concat()


class TensorArraySize(Module):
    def forward(self, input):
        ta = _as_tuple(input)[0]
        return torch.tensor(ta.size, device=ta.device)


class TensorArraySplit(Module):
    def forward(self, input):
        ta, value, lengths = _as_tuple(input)
        return ta.split(value, lengths)


class TensorArrayClose(Module):
    def forward(self, input):
        ta = _as_tuple(input)[0]
        return torch.zeros((), dtype=torch.int64, device=ta.device)


# ------------------------------------------------------------- parsing ops
_EXAMPLE_FEATURES = 1   # Example.features
_FEATURES_MAP = 1       # Features.feature (map<string, Feature>)
_BYTES_LIST, _FLOAT_LIST, _INT64_LIST = 1, 2, 3  # Feature oneof fields
_LIST_VALUE = 1


def parse_example_bytes(serialized: bytes) -> dict:
    """Decode one tf.Example proto into {feature_name: numpy array} using
    the protowire decoder (≙ ParsingOps.scala ParseExample's JVM proto
    parse)."""
    out = {}
    ex = pw.decode(serialized)
    if _EXAMPLE_FEATURES not in ex:
        return out
    feats = pw.decode(ex[_EXAMPLE_FEATURES][0])
    for entry in feats.get(_FEATURES_MAP, []):
        em = pw.decode(entry)
        name = pw.as_string(em[1][0])
        fm = pw.decode(em[2][0])
        if _BYTES_LIST in fm:
            lst = pw.decode(fm[_BYTES_LIST][0])
            out[name] = np.asarray(lst.get(_LIST_VALUE, []), object)
        elif _FLOAT_LIST in fm:
            lst = pw.decode(fm[_FLOAT_LIST][0])
            vals = []
            for v in lst.get(_LIST_VALUE, []):
                vals.extend(pw.packed_floats(v) if isinstance(v, bytes)
                            else [v])
            out[name] = np.asarray(vals, np.float32)
        elif _INT64_LIST in fm:
            lst = pw.decode(fm[_INT64_LIST][0])
            out[name] = np.asarray(
                [pw.as_signed(v) for v in
                 pw.repeated_varints(lst.get(_LIST_VALUE, []))], np.int64)
    return out


def _record_bytes(rec) -> bytes:
    if isinstance(rec, bytes):
        return rec
    rec = np.asarray(rec)
    return bytes(rec.tolist()) if rec.dtype == object else rec.tobytes()


class ParseExample(Module):
    """≙ nn/tf/ParsingOps.scala ParseExample(:36): parse a batch of
    serialized tf.Example protos into dense feature tensors.

    Input: Table(serialized, names, key_1..key_nDense, default_1..
    default_nDense) exactly like the reference; ``serialized`` is a 1-D
    array/list of bytes. Output: Table of nDense dense tensors, each
    (batch,) + dense_shape, on ``device`` (a bytes feature stays a numpy
    object array). The decode runs on the host."""

    def __init__(self, n_dense: int, t_dense: Sequence,
                 dense_shapes: Sequence, *, device=DEFAULT_DEVICE):
        super().__init__()
        self.n_dense = n_dense
        self.t_dense = [torch.empty(0, dtype=t).numpy().dtype
                        if isinstance(t, torch.dtype) else np.dtype(t)
                        for t in t_dense]
        self.dense_shapes = [tuple(s) for s in dense_shapes]
        self.device = resolve_device(device)

    def forward(self, input):
        vals = _as_tuple(input)
        serialized = vals[0]
        keys = [self._key(v) for v in vals[2:2 + self.n_dense]]
        defaults = [_host_array(d) for d in
                    vals[2 + self.n_dense:2 + 2 * self.n_dense]]
        records = [serialized] if isinstance(serialized, bytes) \
            else list(serialized)
        cols: List[List[np.ndarray]] = [[] for _ in range(self.n_dense)]
        for rec in records:
            feats = parse_example_bytes(_record_bytes(rec))
            for j, key in enumerate(keys):
                shape = self.dense_shapes[j]
                v = feats[key] if key in feats and feats[key].size \
                    else defaults[j]
                if self.t_dense[j] == np.dtype(object):
                    cols[j].append(v.reshape(shape) if shape
                                   else v.reshape(()))
                else:
                    cols[j].append(np.asarray(v, self.t_dense[j]).reshape(
                        shape))
        outs = []
        for j in range(self.n_dense):
            if self.t_dense[j] == np.dtype(object):
                outs.append(np.stack(cols[j]) if cols[j]
                            else np.zeros((0,), object))
            else:
                outs.append(torch.from_numpy(np.stack(cols[j])).to(
                    self.device))
        return _as_activity(outs)

    @staticmethod
    def _key(v):
        if isinstance(v, bytes):
            return v.decode()
        if isinstance(v, str):
            return v
        a = np.asarray(v).reshape(-1)[0]
        return a.decode() if isinstance(a, bytes) else str(a)
