"""TensorFlow GraphDef import (port of ``bigdl_tpu/utils/tf_import.py``).

Reference: utils/tf/TensorflowLoader.scala:55 + the per-op loaders in
utils/tf/loaders/ — parse a frozen graph.pb, convert nodes to modules,
build a Graph between user-named inputs and outputs. The GraphDef is
decoded with the port's ``utils/protowire`` against the public tensorflow
.proto field numbers; a ``tensor_content`` payload is read with
``np.frombuffer`` (a frozen VGG-16 carries one 411 MB TensorProto), and
constants fold into their consumers (weights). The op set is the JAX
package's: frozen feed-forward inference graphs, TF1 ``while`` frames
(Enter/Merge/Switch/LoopCond/NextIteration/Exit rebuilt as one
``nn.tf_ops.WhileLoop``), TF1 ``cond`` (Switch/Merge: both branches are
computed and ``torch.where`` selects), the functional ``While`` /
``StatelessWhile`` / ``If`` / ``StatelessIf`` / ``PartitionedCall`` from
the function library, ``ParseExample``, image decoding, and the
``Variable`` handling of unfrozen graphs (``utils/tf_session.py``).

Where the port parts from the JAX loader:

- Every op without weights is one :class:`_Fn` module naming its op and
  holding its attributes and constant operands (a JAX ``_Fn`` holds a
  closure). So an imported graph saves with ``save_module`` and loads
  back like any other module tree.
- The model is built on ``device=`` (default the card): weights and
  folded constants live there, and ops that make a tensor from nothing
  (``Range``, ``Fill``, the random ops, the image decoders) put it
  there.
- The functional ``If`` computes both branches and selects with
  ``torch.where`` (:class:`_SelectIf`), as the JAX loader's TF1 cond
  does: the predicate is never read on the host. A TF1 ``while`` frame
  runs as ``WhileLoop``, which reads its condition once an iteration
  (``host_syncs``), where JAX traces one ``lax.while_loop``.
- ``RandomUniform`` and ``RandomShuffle`` draw from the loader's
  ``generator`` (the device's default stream when None): the same seed
  gives the same values; JAX's threefry bits are never matched.
- Torch's plain call is written to the JAX semantics where they part
  (``nn/ops.py``'s list): ``TopK`` ties lowest index first, ``OneHot``
  zero rows and ``Gather`` fills for ids out of range, ``Sign`` keeps
  NaN and -0.0, ``Cast`` of floats to integers saturates, ``Maximum`` /
  ``Minimum`` of signed zeros, ``Mod`` / ``TruncateMod`` as ``fmod`` and
  ``FloorMod`` as ``remainder``; a reduction over an empty axis list
  reduces nothing (torch's empty ``dim`` reduces everything).
- Integer indices (``ArgMax``, ``TopK``, ``Shape``, ``Rank``) are int64
  where JAX gives int32, and float64 constants stay float64.
"""

from __future__ import annotations

import io
import math
import struct
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.ops import (_digamma, _maximum, _minimum, _one_hot,
                                    _saturating_cast, _sign, _take,
                                    _take_rows, _torch_dtype, _truncate_div)
from bigdl_tpu_torch.utils import protowire as pw
from bigdl_tpu_torch.utils.table import Table

#: ops whose module emits a Table of outputs; consumers reference "name:i"
_MULTI_OUTPUT_OPS = {"Split", "SplitV", "Unpack", "TopK", "TopKV2",
                     "SoftmaxCrossEntropyWithLogits"}

#: FunctionDef refs name the output arg ("node:out_arg:idx"); flat output
#: index = arg's base offset + idx. Ops with one (possibly repeated) output
#: arg have offset 0 and are omitted.
_OUT_ARG_OFFSET = {
    "TopK": {"values": 0, "indices": 1},
    "TopKV2": {"values": 0, "indices": 1},
    "Switch": {"output_false": 0, "output_true": 1},
    "Merge": {"output": 0, "value_index": 1},
}

# tensorflow dtype enum (subset); 7 = DT_STRING (object arrays of bytes)
_DT = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 6: np.int8,
       7: object, 9: np.int64, 10: bool, 17: np.uint16}


# ------------------------------------------------------------ parse layer
def _parse_tensor(tensor_bytes: bytes) -> np.ndarray:
    msg = pw.decode(tensor_bytes)
    dtype = _DT.get(msg.get(1, [1])[0], np.float32)
    shape = []
    if 2 in msg:
        shape_msg = pw.decode(msg[2][0])
        for dim in shape_msg.get(2, []):
            shape.append(pw.as_signed(pw.decode(dim).get(1, [0])[0]))
    # TensorProto field numbers (tensorflow/core/framework/tensor.proto):
    # 4 tensor_content, 5 float_val, 6 double_val, 7 int_val, 9 int64_val,
    # 10 bool_val.  A tensor with NO value field is all default (zeros).
    if dtype is object:  # DT_STRING: string_val = field 8
        arr = np.asarray(list(msg.get(8, [])), object)
    elif 4 in msg and msg[4][0]:  # tensor_content: raw bytes, no Python list
        arr = np.frombuffer(msg[4][0], dtype=dtype).copy()
    elif 5 in msg:  # float_val: packed bytes or one fixed32 each
        parts = [np.frombuffer(v, "<f4") if isinstance(v, bytes)
                 else np.asarray([struct.unpack(
                     "<f", struct.pack("<I", v))[0]], np.float32)
                 for v in msg[5]]
        arr = np.concatenate(parts).astype(np.float32)
    elif 6 in msg:  # double_val
        parts = [np.frombuffer(v, "<f8") if isinstance(v, bytes)
                 else np.asarray([struct.unpack(
                     "<d", struct.pack("<Q", v))[0]])
                 for v in msg[6]]
        arr = np.concatenate(parts).astype(np.float64)
    elif 7 in msg:  # int_val
        arr = np.asarray([pw.as_signed(v) for v in pw.repeated_varints(msg[7])],
                         np.int32)
    elif 9 in msg:  # int64_val
        arr = np.asarray([pw.as_signed(v) for v in pw.repeated_varints(msg[9])],
                         np.int64)
    elif 10 in msg:  # bool_val
        arr = np.asarray(pw.repeated_varints(msg[10]), bool)
    else:
        arr = np.zeros(tuple(shape), dtype)
    if shape:
        if arr.size == 1 and int(np.prod(shape)) > 1:
            arr = np.full(shape, arr.reshape(-1)[0])
        arr = arr.reshape(shape)
    elif arr.size == 1 and arr.ndim == 1:
        arr = arr.reshape(())  # TensorProto with scalar shape
    return arr


class _TFNode:
    def __init__(self, node_bytes: bytes):
        msg = pw.decode(node_bytes)
        self.name = pw.as_string(msg.get(1, [b""])[0])
        self.op = pw.as_string(msg.get(2, [b""])[0])
        self.inputs = [pw.as_string(v) for v in msg.get(3, [])]
        self.attr: Dict[str, dict] = {}
        for entry in msg.get(5, []):
            em = pw.decode(entry)
            key = pw.as_string(em.get(1, [b""])[0])
            self.attr[key] = pw.decode(em[2][0]) if 2 in em else {}

    def attr_ints(self, key: str) -> List[int]:
        a = self.attr.get(key, {})
        if 1 not in a:
            return []
        lst = pw.decode(a[1][0])
        return [pw.as_signed(v) for v in pw.repeated_varints(lst.get(3, []))]

    def attr_s(self, key: str) -> Optional[str]:
        a = self.attr.get(key, {})
        return pw.as_string(a[2][0]) if 2 in a else None

    def attr_b(self, key: str, default=False) -> bool:
        a = self.attr.get(key, {})
        return bool(a[5][0]) if 5 in a else default

    def attr_func(self, key: str) -> Optional[str]:
        """AttrValue.func (NameAttrList, field 10) -> function name."""
        a = self.attr.get(key, {})
        if 10 not in a:
            return None
        nal = pw.decode(a[10][0])
        return pw.as_string(nal.get(1, [b""])[0])

    def attr_types(self, key: str) -> List[type]:
        """AttrValue.list.type (repeated DataType, ListValue field 6)."""
        a = self.attr.get(key, {})
        if 1 not in a:
            return []
        lst = pw.decode(a[1][0])
        return [_DT.get(int(v), np.float32)
                for v in pw.repeated_varints(lst.get(6, []))]

    def attr_shapes(self, key: str) -> List[tuple]:
        """AttrValue.list.shape (repeated TensorShapeProto, ListValue field 7)."""
        a = self.attr.get(key, {})
        if 1 not in a:
            return []
        lst = pw.decode(a[1][0])
        shapes = []
        for sb in lst.get(7, []):
            sm = pw.decode(sb)
            shapes.append(tuple(
                pw.as_signed(pw.decode(d).get(1, [0])[0]) for d in sm.get(2, [])))
        return shapes

    def attr_f(self, key: str, default: float = 0.0) -> float:
        a = self.attr.get(key, {})
        if 4 not in a:
            return default
        v = a[4][0]
        if isinstance(v, bytes):  # protowire yields fixed32 as raw bytes
            return struct.unpack("<f", v)[0]
        return struct.unpack("<f", struct.pack("<I", v))[0]

    def attr_i(self, key: str, default: int = 0) -> int:
        a = self.attr.get(key, {})
        return pw.as_signed(a[3][0]) if 3 in a else default

    def attr_type(self, key: str):
        a = self.attr.get(key, {})
        return _DT.get(a[6][0]) if 6 in a else None

    def attr_tensor(self) -> Optional[np.ndarray]:
        a = self.attr.get("value", {})
        return _parse_tensor(a[8][0]) if 8 in a else None


def parse_graphdef(data: bytes) -> List[_TFNode]:
    return [_TFNode(nb) for nb in pw.decode(data).get(1, [])]


class _TFFunction:
    """FunctionDef (tensorflow/core/framework/function.proto): signature
    OpDef (1), node_def (3), ret map (4). Inside a function body, input refs
    use ``node:out_arg:idx`` / ``arg_name`` syntax."""

    def __init__(self, data: bytes):
        msg = pw.decode(data)
        sig = pw.decode(msg[1][0])
        self.name = pw.as_string(sig.get(1, [b""])[0])
        self.input_args = [pw.as_string(pw.decode(a).get(1, [b""])[0])
                           for a in sig.get(2, [])]
        self.output_args = [pw.as_string(pw.decode(a).get(1, [b""])[0])
                            for a in sig.get(3, [])]
        self.nodes = [_TFNode(nb) for nb in msg.get(3, [])]
        self.ret: Dict[str, str] = {}
        for e in msg.get(4, []):
            em = pw.decode(e)
            self.ret[pw.as_string(em[1][0])] = pw.as_string(em[2][0])


def parse_function_library(data: bytes) -> Dict[str, _TFFunction]:
    """GraphDef.library (field 2) -> {name: _TFFunction}."""
    fns: Dict[str, _TFFunction] = {}
    for lib in pw.decode(data).get(2, []):
        lm = pw.decode(lib)
        for fb in lm.get(1, []):
            fn = _TFFunction(fb)
            fns[fn.name] = fn
    return fns


def _clean(name: str) -> str:
    name = name.lstrip("^")
    return name.split(":")[0]


# ------------------------------------------------------------- op kernels
def _is_host(v) -> bool:
    """A value that stays on the host: None, bytes, strings and object
    arrays."""
    return v is None or isinstance(v, (bytes, str)) or (
        isinstance(v, np.ndarray) and v.dtype == object)


def _on(v, device):
    """``v`` as a tensor on ``device`` (host values stay as they are)."""
    if torch.is_tensor(v) or _is_host(v):
        return v
    return torch.as_tensor(np.asarray(v), device=device)


def _dev_of(xs, default):
    return next((x.device for x in xs if torch.is_tensor(x)), default)


def _axes(axes, ndim: int):
    return tuple(sorted({int(a) % ndim for a in axes}))


def _reduce(fn):
    """A reduction over each axis in turn (none for an empty list)."""
    def run(x, axes, keep):
        ax = _axes(axes, x.dim()) if x.dim() else ()
        for a in reversed(ax):
            x = fn(x, a, keep)
        return x
    return run


_REDUCE = {
    "Max": _reduce(lambda x, a, k: torch.amax(x, a, keepdim=k)),
    "Min": _reduce(lambda x, a, k: torch.amin(x, a, keepdim=k)),
    "Sum": _reduce(lambda x, a, k: torch.sum(x, a, keepdim=k)),
    "Prod": _reduce(lambda x, a, k: torch.prod(x, a, keepdim=k)),
    "All": _reduce(lambda x, a, k: torch.all(x.bool(), a, keepdim=k)),
    "Any": _reduce(lambda x, a, k: torch.any(x.bool(), a, keepdim=k)),
    "Mean": _reduce(lambda x, a, k: torch.mean(x, a, keepdim=k)),
}


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_UNARY = {
    "Neg": torch.neg, "Rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "Sqrt": torch.sqrt, "Square": torch.square, "Exp": torch.exp,
    "Log": torch.log, "Log1p": torch.log1p, "Abs": torch.abs,
    "Floor": torch.floor, "Ceil": torch.ceil, "Round": torch.round,
    "Rint": torch.round, "Sign": _sign, "Erf": torch.erf,
    "Erfc": torch.erfc, "Reciprocal": lambda x: 1.0 / x,
    "Inv": lambda x: 1.0 / x, "Softplus": _softplus,
    "Softsign": lambda x: x / (1.0 + torch.abs(x)),
    "Elu": F.elu, "Selu": F.selu,
    "LogSoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "Tanh": torch.tanh, "Expm1": torch.expm1, "IsFinite": torch.isfinite,
    "IsNan": torch.isnan, "IsInf": torch.isinf, "Lgamma": torch.lgamma,
    "Digamma": _digamma, "LogicalNot": torch.logical_not,
}

_BINARY = {
    "Sub": torch.sub, "Mul": torch.mul, "RealDiv": torch.true_divide,
    "Div": torch.true_divide, "Maximum": _maximum, "Minimum": _minimum,
    "Pow": torch.pow, "SquaredDifference": lambda a, b: (a - b) ** 2,
    "FloorDiv": torch.floor_divide, "FloorMod": torch.remainder,
    "Greater": torch.gt, "GreaterEqual": torch.ge, "Less": torch.lt,
    "LessEqual": torch.le, "Equal": torch.eq, "NotEqual": torch.ne,
    "LogicalAnd": torch.logical_and, "LogicalOr": torch.logical_or,
    "TruncateDiv": _truncate_div, "Mod": torch.fmod, "TruncateMod": torch.fmod,
}


def _binary(m, *xs):
    """A binary op; a folded constant sits at ``const_at`` (0 or 1)."""
    if m.consts:
        c = m.consts[0]
        a, b = (c, xs[0]) if m.attrs.get("const_at") == 0 else (xs[0], c)
    else:
        a, b = xs
    if m.attrs["fn"] == "ApproximateEqual":
        return torch.abs(a - b) < m.attrs["tol"]
    return _BINARY[m.attrs["fn"]](a, b)


def _strided_slice(x, spec):
    """``x[spec]`` with numpy's rules for every step, a negative one
    included (torch's indexing takes positive steps only)."""
    dims = x.dim()
    n_real = sum(1 for s in spec if s is not None and s is not Ellipsis)
    out = x
    d = 0
    for s in spec:
        if s is Ellipsis:
            d += dims - n_real
        elif s is None:
            out = out.unsqueeze(d)
            d += 1
        elif isinstance(s, int):
            out = out.select(d, s)
        else:
            start, stop, step = s.indices(out.shape[d])
            if step == 1:
                out = out.narrow(d, start, max(stop - start, 0))
            else:
                idx = torch.arange(start, stop, step, device=out.device)
                out = out.index_select(d, idx)
            d += 1
    return out


def _op_strided_slice(m, x):
    a = m.attrs
    idx = []
    for d in range(len(a["begin"])):
        if a["elm"] & (1 << d):
            idx.append(Ellipsis)
        elif a["nm"] & (1 << d):
            idx.append(None)
        elif a["sm"] & (1 << d):
            idx.append(int(a["begin"][d]))
        else:
            b = None if a["bm"] & (1 << d) else int(a["begin"][d])
            e = None if a["em"] & (1 << d) else int(a["end"][d])
            idx.append(slice(b, e, int(a["strides"][d])))
    return _strided_slice(x, idx)


def _reshape_to(x, tgt):
    known = int(np.prod([d for d in tgt if d != -1])) or 1
    return x.reshape(tuple(int(x.numel() // known) if d == -1 else int(d)
                           for d in tgt))


def _host_ints(v):
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return [int(i) for i in np.asarray(v).reshape(-1)]


def _slice(x, begin, size):
    return x[tuple(slice(b, None if s == -1 else b + s)
                   for b, s in zip(begin, size))]


def _segment_sum(x, ids, num):
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < num)
    rest = x.shape[ids.dim():]
    xm = torch.where(valid.reshape(valid.shape + (1,) * len(rest)), x, 0)
    return x.new_zeros((num,) + tuple(rest)).index_add(
        0, torch.where(valid, ids, 0).reshape(-1), xm.reshape((-1,) + rest))


def _op_dyn_segment_sum(m, x, ids):
    num = int(_host_ints(ids)[-1]) + 1   # ids sorted, TF contract
    return _segment_sum(x, torch.as_tensor(ids, device=x.device), num)


def _op_in_top_k(m, pred, tgt):
    k = m.attrs["k"]
    thresh = torch.sort(pred, dim=-1).values[..., -k]
    return _take_rows(pred, torch.as_tensor(tgt, device=pred.device)) \
        >= thresh


def _op_random_uniform(m, _x):
    return torch.rand(tuple(m.attrs["shape"]), generator=m.generator,
                      device=m.device)


def _op_random_shuffle(m, x):
    perm = torch.randperm(x.shape[0], generator=m.generator,
                          device=m.device).to(x.device)
    return x.index_select(0, perm)


def _op_dilation2d(m, x):
    return nn.ops.Dilation2D(strides=m.attrs["strides"], rates=m.attrs["rates"],
                             padding=m.attrs["padding"])([x, m.consts[0]])


def _scalar_bytes(x):
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    if isinstance(x, str):
        return x.encode("latin-1")
    return np.asarray(x, object).reshape(-1)[0]


def _frame(img, ch):
    # ch == 0 keeps the file's own channel count (TF semantics);
    # palette images expand to RGB like TF does
    if ch == 1:
        img = img.convert("L")
    elif ch == 4:
        img = img.convert("RGBA")
    elif ch == 3 or img.mode == "P":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _op_decode(m, x):
    """DecodeJpeg / DecodePng / DecodeImage / DecodeGif through PIL on the
    host; the pixels go to the loader's device."""
    from PIL import Image

    op, ch = m.attrs["op"], m.attrs["channels"]
    want = m.attrs.get("image_dtype")
    img = Image.open(io.BytesIO(_scalar_bytes(x)))
    is_gif = (img.format or "").upper() == "GIF"
    if op == "DecodeGif" or (op == "DecodeImage" and is_gif):
        # 4-D (frames, H, W, 3): TF expands animations — GIFs are rank-4
        # even with a single frame
        frames = []
        for f in range(getattr(img, "n_frames", 1)):
            img.seek(f)
            frames.append(np.asarray(img.convert("RGB")))
        arr = np.stack(frames)
    else:
        arr = _frame(img, ch)
    # DecodeImage applies convert_image_dtype semantics
    if want is not None:
        want = np.dtype(want)
        if arr.dtype != want:
            src_max = np.iinfo(arr.dtype).max
            if np.issubdtype(want, np.floating):
                arr = arr.astype(np.float32) / src_max
            elif np.issubdtype(want, np.integer):
                dst_max = np.iinfo(want).max
                arr = (arr.astype(np.int64) * (dst_max // src_max)).astype(
                    want)
    return torch.from_numpy(np.array(arr)).to(m.device)


def _op_decode_raw(m, x):
    dt = np.dtype(m.attrs["out_type"])
    rows = [np.frombuffer(v, dtype=dt) for v in np.asarray(x, object).reshape(-1)]
    arr = np.stack(rows) if len(rows) > 1 else rows[0]
    return torch.from_numpy(arr.copy()).to(m.device)


def _op_substr(m, x):
    p, ln = m.attrs["pos"], m.attrs["len"]
    arr = np.asarray(x, object).reshape(-1)
    out = np.asarray([v[p:p + ln] for v in arr], object)
    return out.reshape(np.shape(x))


def _op_fused_bn(m, x):
    scale, offset, mean, var = m.consts
    inv = scale / torch.sqrt(var + m.attrs["eps"])
    return x * inv + (offset - mean * inv)


def _op_lrn(m, x):
    r, b, a, be = (m.attrs[k] for k in ("radius", "bias", "alpha", "beta"))
    sq = torch.square(x)
    # sum over the channel window [c-r, c+r] (NHWC)
    padded = F.pad(sq, (r, r))
    win = sum(padded[..., i:i + x.shape[-1]] for i in range(2 * r + 1))
    return x / torch.pow(b + a * win, be)


def _op_bmm(m, a, b=None):
    if b is None:
        b = m.consts[0]
    if m.attrs["adj_x"]:
        a = a.transpose(-1, -2)
    if m.attrs["adj_y"]:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _op_gather(m, *xs):
    a = m.attrs
    if a["const"] == "indices":
        params, ind = xs[0], m.consts[0]
    elif a["const"] == "params":
        params, ind = m.consts[0], xs[0]
    else:
        params, ind = xs
    return _take(params, torch.as_tensor(ind, device=params.device),
                 axis=a["axis"])


def _op_split(m, x):
    return Table(*torch.chunk(x, m.attrs["num"], dim=m.attrs["axis"]))


def _op_splitv(m, x):
    return Table(*torch.split(x, list(m.attrs["sizes"]), dim=m.attrs["axis"]))


def _op_conv3d(m, x):
    w = m.consts[0]                              # DHWIO
    s = tuple(m.attrs["strides"])
    pads = []
    xs = x.permute(0, 4, 1, 2, 3)                # NDHWC -> NCDHW
    if m.attrs["padding"] == "SAME":
        for d in range(3):
            pads.append(_same_pad(xs.shape[2 + d], w.shape[d], s[d]))
        xs = F.pad(xs, (*pads[2], *pads[1], *pads[0]))
    out = F.conv3d(xs, w.permute(4, 3, 0, 1, 2), stride=s)
    return out.permute(0, 2, 3, 4, 1)


def _op_parse_example(m, serialized):
    return m.parser.forward(Table(serialized, None, *m.attrs["keys"],
                                   *m.consts))


def _smce(m, logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return Table(-torch.sum(labels * logp, dim=-1),
                 torch.softmax(logits, dim=-1) - labels)


def _merge(m, a, b, p):
    from bigdl_tpu_torch.nn.tf_ops import _select

    t, f = (a, b) if m.attrs["side0"] else (b, a)
    pred = torch.as_tensor(p).to(device=_dev_of([a, b], m.device),
                                 dtype=torch.bool)
    return Table(_select(pred, f, t),
                 torch.zeros((), dtype=torch.int32, device=pred.device))


def _const_vals(m):
    vals = list(m.consts)
    return vals[0] if len(vals) == 1 else Table(*vals)


#: op name -> fn(module, *inputs); ``module.attrs`` holds the attributes
#: and ``module.consts`` the folded constants (on the loader's device)
_OPS = {
    "literal": lambda m, *_: m.consts[0],
    "const_fn": lambda m, *_: _const_vals(m),
    "select": lambda m, *xs: xs[m.attrs["i"]],
    "switch": lambda m, d, p: Table(d, d),
    "merge": _merge,
    "unary": lambda m, x: _UNARY[m.attrs["fn"]](x),
    "binary": _binary,
    "leaky_relu": lambda m, x: torch.where(x > 0, x, m.attrs["alpha"] * x),
    "cast": lambda m, x: (x != 0) if m.attrs["dtype"] == "bool"
    else _saturating_cast(x, _torch_dtype(m.attrs["dtype"])),
    "reshape": lambda m, x: _reshape_to(x, m.attrs["shape"]),
    "dyn_reshape": lambda m, x, s: _reshape_to(x, _host_ints(s)),
    "squeeze": lambda m, x: x.squeeze(tuple(m.attrs["dims"]))
    if m.attrs["dims"] else x.squeeze(),
    "reduce": lambda m, x: _REDUCE[m.attrs["fn"]](x, m.attrs["axes"],
                                                  m.attrs["keep"]),
    "segment_sum": lambda m, x: _segment_sum(x, m.consts[0],
                                             m.attrs["num"]),
    "dyn_segment_sum": _op_dyn_segment_sum,
    "in_top_k": _op_in_top_k,
    "random_uniform": _op_random_uniform,
    "random_shuffle": _op_random_shuffle,
    "dilation2d": _op_dilation2d,
    "decode": _op_decode,
    "decode_raw": _op_decode_raw,
    "pad": lambda m, x: F.pad(x, [p for pair in reversed(m.attrs["pads"])
                                  for p in pair]),
    "concat": lambda m, *xs: torch.cat(xs, dim=m.attrs["axis"]),
    "add_n": lambda m, *xs: sum(xs[1:], xs[0]),
    "fused_bn": _op_fused_bn,
    "lrn": _op_lrn,
    "transpose": lambda m, x: x.permute(tuple(m.attrs["perm"])),
    "expand_dims": lambda m, x: x.unsqueeze(m.attrs["dim"]),
    "pack": lambda m, *xs: torch.stack(xs, dim=m.attrs["axis"]),
    "tile": lambda m, x: x.tile(tuple(m.attrs["mult"])),
    "strided_slice": _op_strided_slice,
    "argmax": lambda m, x: torch.argmax(x, dim=m.attrs["dim"]),
    "gather": _op_gather,
    "where": lambda m, c, t, e: torch.where(c.bool(), t, e),
    "bmm": _op_bmm,
    "one_hot": lambda m, x: _one_hot(x, m.attrs["depth"], m.attrs["axis"])
    * (m.attrs["on"] - m.attrs["off"]) + m.attrs["off"],
    "split": _op_split,
    "splitv": _op_splitv,
    "unpack": lambda m, x: Table(*torch.unbind(x, dim=m.attrs["axis"])),
    "top_k": lambda m, x: Table(*nn.ops.TopK(m.attrs["k"])(x)),
    "shape": lambda m, x: torch.as_tensor(tuple(x.shape), dtype=torch.int64,
                                          device=x.device),
    "rank": lambda m, x: torch.as_tensor(x.dim(), dtype=torch.int64,
                                         device=x.device),
    "fill": lambda m, *_: m.consts[0].reshape(()).expand(
        tuple(m.attrs["shape"])).clone(),
    "fill_value": lambda m, v: v.reshape(()).expand(
        tuple(m.attrs["shape"])).clone(),
    "range": lambda m, *_: m.consts[0],
    "slice": lambda m, x: _slice(x, m.attrs["begin"], m.attrs["size"]),
    "dyn_slice": lambda m, x, b, s: _slice(x, _host_ints(b), _host_ints(s)),
    "l2_loss": lambda m, x: torch.sum(torch.square(x)) / 2,
    "smce": _smce,
    "substr": _op_substr,
    "conv3d": _op_conv3d,
    "parse_example": _op_parse_example,
}


class _Fn(Module):
    """One TF op without weights: ``op`` names its kernel in ``_OPS``,
    ``attrs`` holds its attributes (plain values) and ``consts`` the
    operands folded at import, as buffers ``c0``, ``c1``, ... on
    ``device`` (so ``.to()`` and a pickle round trip move them; bytes
    and string constants stay on the host). Inputs that arrive as numbers
    or numeric numpy arrays join the module's device; bytes, strings and
    object arrays stay on the host. A Table input is spread over the
    kernel's arguments, as the JAX ``_Fn`` does."""

    def __init__(self, op: str, attrs: Optional[dict] = None, consts=(), *,
                 generator: Optional[torch.Generator] = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        if op not in _OPS:
            raise ValueError(f"unknown imported op kernel {op!r}")
        dev = resolve_device(device)
        self.op = op
        self.attrs = dict(attrs or {})
        self.n_consts = len(consts)
        self._host_consts = {}
        for i, c in enumerate(consts):
            if _is_host(c):
                self._host_consts[i] = c
            else:
                self.register_buffer(f"c{i}", _dev_tensor(c, dev))
        self.register_buffer("anchor", torch.empty(0, device=dev),
                             persistent=False)
        self.generator = generator
        if op == "parse_example":
            from bigdl_tpu_torch.nn.tf_ops import ParseExample

            self.parser = ParseExample(len(self.attrs["tdense"]),
                                       self.attrs["tdense"],
                                       self.attrs["shapes"], device=dev)

    @property
    def device(self) -> torch.device:
        return self.anchor.device

    @property
    def consts(self) -> list:
        return [self._host_consts[i] if i in self._host_consts
                else getattr(self, f"c{i}") for i in range(self.n_consts)]

    def forward(self, x):
        xs = list(x) if isinstance(x, Table) else [x]
        xs = [_on(v, self.device) if v is not None else v for v in xs]
        return _OPS[self.op](self, *xs)


def _dev_tensor(c, device) -> torch.Tensor:
    """A copy of the constant ``c`` on ``device`` (never a view of the
    parsed numpy array, which another consumer may fold too)."""
    if torch.is_tensor(c):
        return c.detach().to(device, copy=True)
    return torch.tensor(np.asarray(c), device=device)


def _param(c, device) -> torch.nn.Parameter:
    """A folded constant as a parameter on ``device`` (an integer one, a
    loop counter's step, takes no gradient)."""
    t = _dev_tensor(c, resolve_device(device))
    return torch.nn.Parameter(t, requires_grad=t.is_floating_point())


def _same_pad(size: int, k: int, stride: int):
    """(low, high) padding of TF's SAME rule along one dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class _ConstBind(Module):
    """Wrap a multi-arg module, baking const operands in at fixed positions
    (functional ops like While take consts as loop vars; they can't fold
    into the function body because position matters)."""

    def __init__(self, inner: Module, consts: dict, n_total: int, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.inner = inner
        dev = resolve_device(device)
        self._const_at = sorted(int(k) for k in consts)
        for k, v in consts.items():
            self.register_buffer(f"c{int(k)}", _dev_tensor(v, dev))
        self._n_total = n_total

    def forward(self, input):
        dyn = list(input) if isinstance(input, Table) else [input]
        full, di = [], 0
        for pos in range(self._n_total):
            if pos in self._const_at:
                full.append(getattr(self, f"c{pos}"))
            else:
                full.append(dyn[di])
                di += 1
        return self.inner.forward(Table(*full) if len(full) > 1 else full[0])


class _SelectIf(Module):
    """The functional ``If`` / ``StatelessIf``: input Table(pred,
    *branch_args); both branches run and ``torch.where`` selects by the
    predicate, so no host read (JAX traces ``lax.cond``; the port's
    ``nn.tf_ops.If`` reads the predicate on the host)."""

    def __init__(self, then_branch: Module, else_branch: Module):
        super().__init__()
        self._then, self._else = then_branch, else_branch

    def forward(self, input):
        from bigdl_tpu_torch.nn.tf_ops import _as_activity, _as_tuple, _select

        vals = _as_tuple(input)
        t = self._then(_as_activity(vals[1:]))
        e = self._else(_as_activity(vals[1:]))
        dev = next((v.device for v in _as_tuple(t) if torch.is_tensor(v)),
                   None)
        pred = torch.as_tensor(vals[0]).to(device=dev, dtype=torch.bool)
        return _select(pred.reshape(()), e, t)


# ------------------------------------------------------ NHWC math modules
class _Conv2D(Module):
    """Conv2D / DepthwiseConv2dNative over NHWC input with an HWIO
    ``weight`` (JAX's name and layout). The convolution runs on a
    channels-last NCHW view, as ``nn/conv.py``'s NHWC format does, with
    TF's SAME padding (the larger half after)."""

    def __init__(self, w_hwio, strides, padding, depthwise=False, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.weight = _param(w_hwio, device)
        self.strides = list(strides)
        self.padding = padding
        self.depthwise = depthwise

    def forward(self, x):
        w = self.weight
        groups = 1
        if self.depthwise:
            h, wd, c, m = w.shape
            w = w.reshape(h, wd, 1, c * m)
            groups = c
        w = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        xs = x.permute(0, 3, 1, 2)
        sh, sw = self.strides[1:3]
        if self.padding == "SAME":
            ph = _same_pad(xs.shape[2], w.shape[2], sh)
            pw_ = _same_pad(xs.shape[3], w.shape[3], sw)
            if ph[0] == ph[1] and pw_[0] == pw_[1]:
                pad = (ph[0], pw_[0])
            else:
                xs = F.pad(xs, (*pw_, *ph))
                pad = (0, 0)
        else:
            pad = (0, 0)
        return F.conv2d(xs, w, None, (sh, sw), pad, 1, groups).permute(
            0, 2, 3, 1)


class _Pool(Module):
    """MaxPool / AvgPool over NHWC: the max pads with -inf, the SAME
    average divides by the count of valid cells (``lax.reduce_window``'s
    sums in the JAX loader)."""

    def __init__(self, ksize, strides, padding, kind):
        super().__init__()
        self.ksize, self.strides, self.pad, self.kind = \
            list(ksize), list(strides), padding, kind

    def forward(self, x):
        kh, kw = self.ksize[1:3]
        sh, sw = self.strides[1:3]
        xs = x.permute(0, 3, 1, 2)
        pads = (0, 0, 0, 0)
        if self.pad == "SAME":
            ph = _same_pad(xs.shape[2], kh, sh)
            pw_ = _same_pad(xs.shape[3], kw, sw)
            pads = (*pw_, *ph)
        if self.kind == "max":
            xs = F.pad(xs, pads, value=-math.inf) if any(pads) else xs
            out = F.max_pool2d(xs, (kh, kw), (sh, sw))
        else:
            summed = F.avg_pool2d(F.pad(xs, pads), (kh, kw), (sh, sw),
                                  divisor_override=1)
            if self.pad == "VALID":
                out = summed / (kh * kw)
            else:
                ones = torch.ones((1, 1) + tuple(xs.shape[2:]),
                                  dtype=xs.dtype, device=xs.device)
                counts = F.avg_pool2d(F.pad(ones, pads), (kh, kw), (sh, sw),
                                      divisor_override=1)
                out = summed / counts
        return out.permute(0, 2, 3, 1)


class _MatMul(Module):
    """MatMul with a folded ``weight`` (JAX's name, (in, out) unless
    ``transpose_b``) or over two dynamic operands."""

    def __init__(self, w=None, transpose_a=False, transpose_b=False, *,
                 device=DEFAULT_DEVICE):
        super().__init__()
        if w is not None:
            self.weight = _param(w, device)
        self.has_w = w is not None
        self.ta, self.tb = transpose_a, transpose_b

    def forward(self, input):
        if self.has_w:
            a, b = input, self.weight
        else:
            a, b = input[1], input[2]
        if self.ta:
            a = a.T
        if self.tb:
            b = b.T
        return a @ b


class _BiasAdd(Module):
    def __init__(self, b, *, device=DEFAULT_DEVICE):
        super().__init__()
        self.bias = _param(b, device)

    def forward(self, x):
        return x + self.bias


class TensorflowLoader:
    """≙ TensorflowLoader.load (utils/tf/TensorflowLoader.scala:55). The
    model is built on ``device``; the random ops draw from ``generator``."""

    def __init__(self, graph_pb_path: str, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.generator = generator
        with open(graph_pb_path, "rb") as f:
            data = f.read()
        self.nodes = {n.name: n for n in parse_graphdef(data)}
        self.functions = parse_function_library(data)
        self._fn_models: Dict[str, object] = {}
        # unfrozen graphs: VariableV2 initial values from Assign(var, Const)
        # initializers (≙ Session.scala's variable extraction)
        self._var_init_refs: Dict[str, str] = {}
        for nd in self.nodes.values():
            # ref variables (VariableV2+Assign) and resource variables
            # (VarHandleOp + AssignVariableOp + ReadVariableOp)
            if nd.op in ("Assign", "AssignVariableOp") and len(nd.inputs) >= 2:
                self._var_init_refs.setdefault(_clean(nd.inputs[0]),
                                               nd.inputs[1])
        self.variables: Dict[str, object] = {}  # name -> Variable module

    def _child(self, nodes) -> "TensorflowLoader":
        sub = TensorflowLoader.__new__(TensorflowLoader)
        sub.nodes = nodes
        sub.functions = self.functions
        sub._fn_models = self._fn_models
        sub.device, sub.generator = self.device, self.generator
        sub._var_init_refs = {}
        sub.variables = {}
        return sub

    def _fn(self, op: str, attrs=None, consts=()) -> _Fn:
        return _Fn(op, attrs, consts, generator=self.generator,
                   device=self.device)

    def _function_model(self, fname: str):
        """Build (once) a Graph executing the named FunctionDef — the
        cond/body of While and the branches of If (≙ the reference
        executing loop-frame subgraphs via Scheduler)."""
        if fname not in self._fn_models:
            fdef = self.functions[fname]
            sub = self._child({n.name: n for n in fdef.nodes})
            outs = [fdef.ret.get(o, o) for o in fdef.output_args]
            if not fdef.input_args:
                # zero-arg branch (e.g. `lambda: tf.constant(c)`): outputs
                # must be const-only
                consts = {nd.name: nd.attr_tensor() for nd in fdef.nodes
                          if nd.op == "Const"}

                def c_of(ref):
                    b = _clean(ref)
                    if b in consts:
                        return consts[b]
                    nd = sub.nodes.get(b)
                    if nd is not None and nd.op == "Identity":
                        return c_of(nd.inputs[0])
                    raise ValueError(
                        f"zero-arg function {fname!r}: output {ref!r} is "
                        "not constant")

                self._fn_models[fname] = self._fn(
                    "const_fn", consts=[c_of(o) for o in outs]).set_name(
                        fname)
            else:
                self._fn_models[fname] = sub.load(list(fdef.input_args), outs,
                                                  allow_unused_inputs=True)
        return self._fn_models[fname]

    def load(self, inputs: List[str], outputs: List[str],
             allow_unused_inputs: bool = False):
        consts: Dict[str, np.ndarray] = {}
        for n in self.nodes.values():
            if n.op == "Const":
                consts[n.name] = n.attr_tensor()

        def const_of(name: str) -> Optional[np.ndarray]:
            name = _clean(name)
            if name in consts:
                return consts[name]
            n = self.nodes.get(name)
            if n is not None and n.op == "Identity":
                return const_of(n.inputs[0])
            return None

        graph_nodes: Dict[str, nn.Node] = {}
        multi_bases: Dict[str, nn.Node] = {}
        tf1_frames: Dict[str, tuple] = {}
        input_nodes = []
        for name in inputs:
            node = nn.Input()
            graph_nodes[_clean(name)] = node
            input_nodes.append(node)

        def build(ref: str) -> nn.Node:
            base = _clean(ref)
            body = ref.lstrip("^")
            # GraphDef refs are "node[:idx]"; FunctionDef bodies use
            # "node:out_arg[:idx]" — flat index = arg offset + idx
            parts = body.split(":")
            if len(parts) >= 3:
                idx = int(parts[-1])
                prod = self.nodes.get(parts[0])
                if prod is not None:
                    idx += _OUT_ARG_OFFSET.get(prod.op, {}).get(parts[1], 0)
            elif len(parts) == 2 and parts[1].isdigit():
                idx = int(parts[1])
            else:
                idx = 0
            if base in graph_nodes:       # single-output / graph input
                return graph_nodes[base]
            key = f"{base}:{idx}"
            if key in graph_nodes:
                return graph_nodes[key]
            n = self.nodes[base]
            var_base = None
            if n.op == "VariableV2" and base in self._var_init_refs:
                var_base = base
            elif n.op == "ReadVariableOp":
                handle = _clean(n.inputs[0])
                if handle in self._var_init_refs:
                    var_base = handle
            if var_base is not None:
                from bigdl_tpu_torch.nn.tf_ops import Variable

                if var_base in self.variables:
                    var = self.variables[var_base]
                else:
                    init = const_of(self._var_init_refs[var_base])
                    if init is None:
                        raise ValueError(
                            f"variable {var_base!r}: initializer is not a "
                            "constant; freeze the graph or init from consts")
                    var = Variable(np.asarray(init), device=self.device)
                    var.set_name(var_base)
                    self.variables[var_base] = var
                node = nn.Node(var).inputs(input_nodes[0])
                graph_nodes[base] = node
                return node
            if n.op == "Const" and input_nodes:
                # a Const used structurally (e.g. an If branch returning a
                # constant): emit a literal node anchored on the first input
                node = (self._fn("literal", consts=[const_of(base)])
                        .set_name(base).inputs(input_nodes[0]))
                graph_nodes[base] = node
                return node
            if n.op == "Exit":
                # TF1 while frame: reconstruct once, select this exit's var
                wl_node, exit_of = self._tf1_while(n, build, const_of,
                                                   tf1_frames)
                node = (self._fn("select", {"i": exit_of[base]})
                        .set_name(base).inputs(wl_node))
                graph_nodes[base] = node
                return node
            if n.op in _MULTI_OUTPUT_OPS or self._n_outputs(n) > 1:
                # node emits a Table; each consumed :idx gets a selector
                if base not in multi_bases:
                    multi_bases[base] = self._convert(n, build, const_of)
                node = (self._fn("select", {"i": idx})
                        .set_name(f"{n.name}_out{idx}")
                        .inputs(multi_bases[base]))
                graph_nodes[key] = node
            else:
                node = self._convert(n, build, const_of)
                graph_nodes[base] = node
            return node

        output_nodes = [build(o) for o in outputs]
        return nn.Graph(input_nodes, output_nodes,
                        allow_unused_inputs=allow_unused_inputs)

    def _n_outputs(self, n: _TFNode) -> int:
        """Output arity for functional ops (loop vars / branch results)."""
        if n.op in ("While", "StatelessWhile"):
            return len([i for i in n.inputs if not i.startswith("^")])
        if n.op in ("If", "StatelessIf"):
            f = n.attr_func("then_branch")
            return len(self.functions[f].output_args) if f in self.functions else 1
        if n.op in ("PartitionedCall", "StatefulPartitionedCall"):
            f = n.attr_func("f")
            return len(self.functions[f].output_args) if f in self.functions else 1
        if n.op in ("ParseExample", "ParseExampleV2"):
            return len(n.attr_types("Tdense"))
        if n.op in ("Switch", "Merge"):
            return 2
        return 1

    # ---------------- TF1 raw control flow (lowered Switch/Merge frames)
    @staticmethod
    def _ref_idx(ref: str) -> int:
        parts = ref.lstrip("^").split(":")
        return int(parts[-1]) if len(parts) > 1 and parts[-1].isdigit() else 0

    def _trace_switch(self, ref: str, _depth=0):
        """Walk ancestors from ``ref`` to the gating Switch; returns
        (switch_node, output_index_used) or None.

        Nested conds: an intervening Merge means an inner cond already
        resolved on that path — it is skipped by continuing from its own
        gating Switch's *data* input (the value that entered the inner
        cond), so the outer Merge finds the outer Switch. Memoized so
        diamond fan-in stays linear."""
        memo = getattr(self, "_trace_memo", None)
        if memo is None:
            memo = self._trace_memo = {}
        if ref in memo:
            return memo[ref]
        if _depth > 500:
            return None
        base = _clean(ref)
        nd = self.nodes.get(base)
        found = None
        if nd is not None:
            if nd.op == "Switch":
                found = (nd, self._ref_idx(ref))
            elif nd.op == "Merge":
                inner = self._trace_switch(nd.inputs[0], _depth + 1)
                if inner is not None:
                    found = self._trace_switch(inner[0].inputs[0], _depth + 1)
            else:
                for i in nd.inputs:
                    if i.startswith("^"):
                        continue
                    found = self._trace_switch(i, _depth + 1)
                    if found:
                        break
        memo[ref] = found
        return found

    def _branch_side(self, ref: str) -> bool:
        """True if ``ref`` flows from a Switch's true (:1) output."""
        found = self._trace_switch(ref)
        return bool(found and found[1] == 1)

    def _switch_pred(self, ref: str):
        found = self._trace_switch(ref)
        return found[0].inputs[1] if found else None

    def _bind_consts(self, module: Module, refs: List[str], const_of):
        """Bake const operands of a multi-arg functional module in place;
        returns (module, dynamic_refs) (shared by wire_call + _tf1_while)."""
        consts, dyn_refs = {}, []
        for pos, ref in enumerate(refs):
            c = const_of(ref)
            if c is not None:
                consts[pos] = np.asarray(c)
            else:
                dyn_refs.append(ref)
        if consts:
            module = _ConstBind(module, consts, len(refs), device=self.device)
        return module, dyn_refs

    def _consumers(self):
        if not hasattr(self, "_consumers_idx"):
            idx: Dict[str, list] = {}
            for nd in self.nodes.values():
                for i in nd.inputs:
                    idx.setdefault(_clean(i), []).append(nd)
            self._consumers_idx = idx
        return self._consumers_idx

    def _subgraph(self, input_names: List[str], output_refs: List[str]):
        """Sub-model over this graph's nodes with the given names seeded as
        placeholders (used for TF1 loop-frame cond/body extraction)."""
        return self._child(self.nodes).load(input_names, output_refs,
                                            allow_unused_inputs=True)

    def _tf1_while(self, exit_node: _TFNode, build, const_of, frames: dict):
        """Reconstruct a TF1 while frame (Enter/Merge/Switch/LoopCond/
        NextIteration/Exit — the graph the reference walks with
        Scheduler/FrameManager, nn/Scheduler.scala:36) into ONE
        ``WhileLoop`` (one host read of the condition an iteration).

        Loop vars are the frame's Merge nodes; loop invariants are Enter
        nodes without a Merge consumer, appended as extra carried vars."""
        from bigdl_tpu_torch.nn.tf_ops import WhileLoop

        switch = self.nodes[_clean(exit_node.inputs[0])]
        merge0 = self.nodes[_clean(switch.inputs[0])]
        enter0 = self.nodes[_clean(merge0.inputs[0])]
        frame = enter0.attr_s("frame_name") or ""
        if frame in frames:
            return frames[frame]

        consumers = self._consumers()
        enters = sorted((nd for nd in self.nodes.values()
                         if nd.op == "Enter"
                         and (nd.attr_s("frame_name") or "") == frame),
                        key=lambda e: e.name)
        merges, inv_enters = [], []
        for e in enters:
            ms = [c for c in consumers.get(e.name, []) if c.op == "Merge"]
            (merges.append(ms[0]) if ms else inv_enters.append(e))
        merges = sorted(set(merges), key=lambda m: m.name)

        switches, exit_of = [], {}
        loopcond_ref = None
        for m in merges:
            sw = [c for c in consumers.get(m.name, []) if c.op == "Switch"]
            if not sw:
                raise ValueError(f"while frame {frame!r}: loop var "
                                 f"{m.name!r} has no Switch")
            switches.append(sw[0])
            loopcond_ref = sw[0].inputs[1]
            for c in consumers.get(sw[0].name, []):
                if c.op == "Exit":
                    exit_of[c.name] = len(switches) - 1
        loopcond = self.nodes[_clean(loopcond_ref)]

        var_seeds = [m.name for m in merges] + [e.name for e in inv_enters]
        cond_model = self._subgraph(var_seeds, [loopcond.inputs[0]])
        body_seeds = ([sw.name for sw in switches]
                      + [e.name for e in inv_enters])
        nextit_refs = []
        for m in merges:
            ni = self.nodes[_clean(m.inputs[1])]
            if ni.op != "NextIteration":
                raise ValueError(f"while frame {frame!r}: merge {m.name!r} "
                                 f"second input is {ni.op}, not NextIteration")
            nextit_refs.append(ni.inputs[0])
        body_model = self._subgraph(
            body_seeds, nextit_refs + [e.name for e in inv_enters])

        # outer wiring: initial values enter through each var's Enter
        outer_refs = ([self.nodes[_clean(m.inputs[0])].inputs[0] for m in merges]
                      + [e.inputs[0] for e in inv_enters])
        module, dyn_refs = self._bind_consts(
            WhileLoop(cond_model, body_model), outer_refs, const_of)
        node = module.set_name(f"while_frame/{frame}").inputs(
            *[build(r) for r in dyn_refs])
        frames[frame] = (node, exit_of)
        return frames[frame]

    def _convert(self, n: _TFNode, build, const_of) -> nn.Node:
        op = n.op
        data_inputs = [i for i in n.inputs if not i.startswith("^")]
        dev = self.device

        def prev(i=0):
            return build(data_inputs[i])

        def fn(kind, attrs=None, consts=(), *ins):
            return self._fn(kind, attrs, consts).set_name(n.name).inputs(
                *(ins or (prev(0),)))

        def c_int(i):
            return int(np.asarray(const_of(data_inputs[i])).reshape(())[()])

        def c_ints(i):
            return [int(v) for v in np.asarray(const_of(data_inputs[i])).reshape(-1)]

        def binop(name, **extra):
            """Binary op folding a const operand on either side."""
            c0 = const_of(data_inputs[0])
            c1 = const_of(data_inputs[1])
            attrs = dict(fn=name, **extra)
            if c1 is not None:
                return fn("binary", dict(attrs, const_at=1), [c1])
            if c0 is not None:
                return fn("binary", dict(attrs, const_at=0), [c0], prev(1))
            return fn("binary", attrs, (), prev(0), prev(1))

        if op in ("Identity", "StopGradient", "CheckNumerics"):
            return prev()
        if op == "Cast":
            dst = n.attr_type("DstT")
            if dst is None:
                return prev()
            return fn("cast", {"dtype": np.dtype(dst).name})
        if op == "Placeholder":
            raise ValueError(
                f"placeholder {n.name!r} reached but not listed in inputs")
        if op == "Const":
            raise ValueError(
                f"const {n.name!r} must fold into a consumer; unsupported use")
        if op == "MatMul":
            w = const_of(data_inputs[1])
            m = _MatMul(w, n.attr_b("transpose_a"), n.attr_b("transpose_b"),
                        device=dev)
            m.set_name(n.name)
            if w is None:  # dynamic rhs (e.g. an imported Variable)
                return m.inputs(prev(0), prev(1))
            return m.inputs(prev(0))
        if op in ("BiasAdd", "BiasAddV1") or (
                op in ("Add", "AddV2")
                and const_of(data_inputs[1]) is not None):
            return _BiasAdd(const_of(data_inputs[1]), device=dev).set_name(
                n.name).inputs(prev(0))
        if op in ("Add", "AddV2"):
            return nn.CAddTable().set_name(n.name).inputs(prev(0), prev(1))
        if op in ("Conv2D", "DepthwiseConv2dNative"):
            w = const_of(data_inputs[1])
            return _Conv2D(w, n.attr_ints("strides"), n.attr_s("padding"),
                           depthwise=op == "DepthwiseConv2dNative",
                           device=dev).set_name(n.name).inputs(prev(0))
        if op in ("MaxPool", "AvgPool"):
            return _Pool(n.attr_ints("ksize"), n.attr_ints("strides"),
                         n.attr_s("padding"),
                         "max" if op == "MaxPool" else "avg"
                         ).set_name(n.name).inputs(prev(0))
        _LAYERS = {"Relu": nn.ReLU, "Relu6": nn.ReLU6, "Tanh": nn.Tanh,
                   "Sigmoid": nn.Sigmoid, "Softmax": nn.SoftMax}
        if op in _LAYERS:
            return _LAYERS[op]().set_name(n.name).inputs(prev(0))
        if op == "Reshape":
            shape = const_of(data_inputs[1])
            if shape is None:
                # computed target shape (e.g. TF2's SMCE flatten/unflatten):
                # read from the runtime shape tensor on the host
                return fn("dyn_reshape", None, (), prev(0), prev(1))
            return fn("reshape", {"shape": tuple(
                int(s) for s in np.asarray(shape).reshape(-1))})
        if op == "Squeeze":
            return fn("squeeze", {"dims": tuple(n.attr_ints("squeeze_dims"))})
        if op == "Mean":
            return fn("reduce", {"fn": "Mean", "axes": tuple(c_ints(1)),
                                 "keep": n.attr_b("keep_dims")})
        if op == "SegmentSum":
            ids_c = const_of(data_inputs[1])
            if ids_c is not None:  # fold num_segments at import time
                num = int(np.asarray(ids_c).reshape(-1)[-1]) + 1
                return fn("segment_sum", {"num": num},
                          [np.asarray(ids_c).astype(np.int64)])
            return fn("dyn_segment_sum", None, (), prev(0), prev(1))
        if op in ("InTopK", "InTopKV2"):
            # InTopKV2's k arrives as a const input, not an attr
            k = c_int(2) if op == "InTopKV2" else n.attr_i("k", 1)
            return fn("in_top_k", {"k": k}, (), prev(0), prev(1))
        if op == "RandomUniform":
            return fn("random_uniform", {"shape": tuple(c_ints(0))})
        if op == "RandomShuffle":
            return fn("random_shuffle")
        if op == "Dilation2D":
            filt = const_of(data_inputs[1])
            if filt is None:
                raise ValueError(
                    f"Dilation2D {n.name!r}: dynamic (non-Const) filters are "
                    "unsupported; freeze the filter into the graph")
            return fn("dilation2d", {
                "strides": tuple(n.attr_ints("strides") or (1, 1, 1, 1)),
                "rates": tuple(n.attr_ints("rates") or (1, 1, 1, 1)),
                "padding": n.attr_s("padding") or "SAME"}, [filt])
        if op in ("DecodeJpeg", "DecodePng", "DecodeImage", "DecodeGif"):
            want = n.attr_type("dtype") if op == "DecodeImage" else None
            return fn("decode", {"op": op, "channels": n.attr_i("channels", 0),
                                 "image_dtype": None if want is None
                                 else np.dtype(want).name})
        if op == "Pad":
            return fn("pad", {"pads": tuple(
                (int(a), int(b)) for a, b in np.asarray(
                    const_of(data_inputs[1])))})
        if op == "ConcatV2":
            axis = c_int(-1)
            prevs = [build(i) for i in data_inputs[:-1]]
            return fn("concat", {"axis": axis}, (), *prevs)

        if op in _UNARY:
            return fn("unary", {"fn": op})
        if op == "LeakyRelu":
            return fn("leaky_relu", {"alpha": n.attr_f("alpha", 0.2)})
        if op in _BINARY:
            return binop(op)
        if op == "ApproximateEqual":
            return binop("ApproximateEqual", tol=n.attr_f("tolerance", 1e-5))
        if op == "AddN":
            return fn("add_n", None, (), *[build(i) for i in data_inputs])

        # ----- batch norm (utils/tf/loaders/FusedBatchNorm*.scala)
        if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
            return fn("fused_bn", {"eps": n.attr_f("epsilon", 1e-4)},
                      [const_of(data_inputs[i]) for i in (1, 2, 3, 4)])
        if op == "LRN":
            return fn("lrn", {"radius": n.attr_i("depth_radius", 5),
                              "bias": n.attr_f("bias", 1.0),
                              "alpha": n.attr_f("alpha", 1.0),
                              "beta": n.attr_f("beta", 0.5)})

        # ----- shape/layout ops
        if op == "Transpose":
            return fn("transpose", {"perm": tuple(c_ints(1))})
        if op == "ExpandDims":
            return fn("expand_dims", {"dim": c_int(1)})
        if op == "Pack":
            return fn("pack", {"axis": n.attr_i("axis", 0)}, (),
                      *[build(i) for i in data_inputs])
        if op == "Tile":
            return fn("tile", {"mult": tuple(c_ints(1))})
        if op == "StridedSlice":
            return fn("strided_slice", {
                "begin": tuple(c_ints(1)), "end": tuple(c_ints(2)),
                "strides": tuple(c_ints(3)), "bm": n.attr_i("begin_mask"),
                "em": n.attr_i("end_mask"), "sm": n.attr_i("shrink_axis_mask"),
                "nm": n.attr_i("new_axis_mask"),
                "elm": n.attr_i("ellipsis_mask")})

        # ----- reductions (Max/Min/Sum/Prod loaders; Mean handled above)
        if op in ("Max", "Min", "Sum", "Prod", "All", "Any"):
            return fn("reduce", {"fn": op, "axes": tuple(c_ints(1)),
                                 "keep": n.attr_b("keep_dims")
                                 or n.attr_b("keepdims")})
        if op == "ArgMax":
            return fn("argmax", {"dim": c_int(1)})

        # ----- gather/select/matmul family
        if op in ("Gather", "GatherV2"):
            axis = c_int(2) if op == "GatherV2" and len(data_inputs) > 2 \
                else 0
            ind = const_of(data_inputs[1])
            if ind is not None:
                return fn("gather", {"axis": axis, "const": "indices"},
                          [np.asarray(ind).astype(np.int64)])
            par = const_of(data_inputs[0])
            if par is not None:  # const table, computed indices
                return fn("gather", {"axis": axis, "const": "params"},
                          [par], prev(1))
            return fn("gather", {"axis": axis, "const": None}, (),
                      prev(0), prev(1))
        if op in ("Select", "SelectV2"):
            return fn("where", None, (), prev(0), prev(1), prev(2))
        if op in ("BatchMatMul", "BatchMatMulV2"):
            attrs = {"adj_x": n.attr_b("adj_x"), "adj_y": n.attr_b("adj_y")}
            c1 = const_of(data_inputs[1])
            if c1 is not None:
                return fn("bmm", attrs, [c1])
            return fn("bmm", attrs, (), prev(0), prev(1))
        if op == "OneHot":
            return fn("one_hot", {
                "depth": c_int(1),
                "on": float(np.asarray(const_of(data_inputs[2])).reshape(())),
                "off": float(np.asarray(const_of(data_inputs[3])).reshape(())),
                "axis": n.attr_i("axis", -1)})
        if op == "ResizeBilinear":
            size = c_ints(1)
            return (nn.ops.ResizeBilinearOp(size[0], size[1],
                                            n.attr_b("align_corners"))
                    .set_name(n.name).inputs(prev(0)))

        # ----- multi-output ops (emit a Table; load() adds :idx selectors)
        if op == "Split":
            return fn("split", {"num": n.attr_i("num_split", 1),
                                "axis": c_int(0)}, (), prev(1))
        if op == "SplitV":
            return fn("splitv", {"sizes": tuple(c_ints(1)),
                                 "axis": c_int(2)})
        if op == "Unpack":
            return fn("unpack", {"axis": n.attr_i("axis", 0)})
        if op in ("TopK", "TopKV2"):
            k = c_int(1) if op == "TopKV2" else n.attr_i("k", 1)
            return fn("top_k", {"k": k})

        # ----- misc math/shape/introspection loaders (utils/tf/loaders/)
        if op == "Shape":
            return fn("shape")
        if op == "Rank":
            return fn("rank")
        if op == "Fill":
            dims = const_of(data_inputs[0])
            value = const_of(data_inputs[1])
            if dims is None:
                raise ValueError(f"Fill {n.name!r}: dynamic dims unsupported")
            shape = tuple(int(d) for d in np.asarray(dims).reshape(-1))
            if value is not None:
                return fn("fill", {"shape": shape},
                          [np.asarray(value).reshape(())])
            return fn("fill_value", {"shape": shape}, (), prev(1))
        if op == "Range":
            vals = [const_of(i) for i in data_inputs]
            if any(v is None for v in vals):
                raise ValueError(f"Range {n.name!r}: dynamic bounds unsupported")
            s, e, d = (np.asarray(v).reshape(()) for v in vals)
            return fn("range", None, [np.arange(s, e, d)])
        if op == "Slice":
            begin = const_of(data_inputs[1])
            size = const_of(data_inputs[2])
            if begin is None or size is None:
                # computed begin/size: read from the runtime values
                return fn("dyn_slice", None, (), prev(0), prev(1), prev(2))
            return fn("slice", {"begin": tuple(c_ints(1)),
                                "size": tuple(c_ints(2))})
        if op == "L2Loss":
            return fn("l2_loss")
        if op == "SoftmaxCrossEntropyWithLogits":
            return fn("smce", None, (), prev(0), prev(1))
        if op == "Substr":
            return fn("substr", {"pos": c_int(1), "len": c_int(2)})
        if op == "Conv3D":
            return fn("conv3d", {"strides": tuple(n.attr_ints("strides")[1:4]),
                                 "padding": n.attr_s("padding")},
                      [const_of(data_inputs[1])])
        if op == "DecodeRaw":
            out_t = n.attr_type("out_type") or np.float32
            return fn("decode_raw", {"out_type": np.dtype(out_t).name})
        if op == "VariableV2":
            raise ValueError(
                f"VariableV2 {n.name!r}: graph is not frozen — freeze "
                "variables to constants first (convert_variables_to_"
                "constants), matching the reference's frozen-graph contract")

        # ----- functional control flow (≙ nn/tf/ControlOps.scala)
        def wire_call(module):
            """Wire a multi-arg functional module, binding const operands
            (loop counters, max_iterations, captured constants) in place."""
            module, dyn_refs = self._bind_consts(module, data_inputs, const_of)
            return module.set_name(n.name).inputs(*[build(r) for r in dyn_refs])

        if op in ("While", "StatelessWhile"):
            from bigdl_tpu_torch.nn.tf_ops import WhileLoop

            cond_m = self._function_model(n.attr_func("cond"))
            body_m = self._function_model(n.attr_func("body"))
            return wire_call(WhileLoop(cond_m, body_m))
        if op in ("If", "StatelessIf"):
            then_m = self._function_model(n.attr_func("then_branch"))
            else_m = self._function_model(n.attr_func("else_branch"))
            return wire_call(_SelectIf(then_m, else_m))
        if op in ("PartitionedCall", "StatefulPartitionedCall"):
            return wire_call(self._function_model(n.attr_func("f")))
        if op in ("NoOp", "ControlTrigger"):
            return prev()  # control anchors: identity on data
        if op == "Switch":
            # TF1 cond lowering: both outputs carry the data (pure branches
            # are evaluated unconditionally; Merge selects by the predicate)
            return fn("switch", None, (), prev(0), prev(1))
        if op == "Merge":
            # TF1 cond Merge: select between branch values by the predicate
            # of the Switch that gates them (≙ MergeOps, ControlOps.scala:86,
            # minus the scheduler: both branches computed, torch.where)
            side0 = self._branch_side(data_inputs[0])
            pred_ref = self._switch_pred(data_inputs[0]) or \
                self._switch_pred(data_inputs[1])
            if pred_ref is None:
                raise ValueError(
                    f"Merge {n.name!r}: cannot locate gating Switch predicate")
            return fn("merge", {"side0": side0}, (), build(data_inputs[0]),
                      build(data_inputs[1]), build(pred_ref))

        # ----- tf.Example parsing (≙ nn/tf/ParsingOps.scala ParseExample)
        if op in ("ParseExample", "ParseExampleV2"):
            tdense = n.attr_types("Tdense")
            ndense = len(tdense)
            if op == "ParseExampleV2":
                keys = list(np.asarray(const_of(data_inputs[3])).reshape(-1))
                defaults = [const_of(i) for i in data_inputs[5:5 + ndense]]
            else:
                ks = 2 + n.attr_i("Nsparse", 0)
                keys = [const_of(i) for i in data_inputs[ks:ks + ndense]]
                defaults = [const_of(i)
                            for i in data_inputs[ks + ndense:ks + 2 * ndense]]
            keys = [_key_str(k) for k in keys]
            return fn("parse_example", {
                "tdense": tuple(np.dtype(t).name for t in tdense),
                "shapes": tuple(n.attr_shapes("dense_shapes")),
                "keys": tuple(keys)}, defaults)

        raise ValueError(f"unsupported tf op {op!r} ({n.name})")


def _key_str(k) -> str:
    v = k if isinstance(k, (bytes, str)) else np.asarray(k, object).reshape(-1)[0]
    return v.decode() if isinstance(v, bytes) else str(v)


def load_tf(graph_pb_path: str, inputs: List[str], outputs: List[str], *,
            device=DEFAULT_DEVICE, generator: Optional[torch.Generator] = None):
    """≙ Module.loadTF (nn/Module.scala:94): the graph between ``inputs``
    and ``outputs`` as a Graph on ``device`` (default the card)."""
    return TensorflowLoader(graph_pb_path, device=device,
                            generator=generator).load(inputs, outputs)
