"""Export a module tree to a TensorFlow GraphDef (port of
``bigdl_tpu/utils/tf_export.py``).

Reference: utils/tf/BigDLToTensorflow.scala (per-layer converters) +
Module.saveTF (nn/Module.scala). The GraphDef is ENCODED with
utils/protowire against the public tensorflow .proto field numbers — the
mirror image of utils/tf_import's decoder.

Layout: TF's CPU kernels only run NHWC convs/pools, so spatial models must
be BUILT channels-last (``format="NHWC"`` on conv/pool/BN) to export —
_emit validates each spatial module's format against the export
data_format and raises on mismatch (≙ BigDLToTensorflow's NHWC
requirement). Weights stay OIHW in the module and are transposed to HWIO
at export. Layout-free models (MLPs) are unaffected.

The weights are copied to the host as f32 numpy arrays and folded with
the JAX package's numpy arithmetic, so the same weights give the same
GraphDef bytes, from the card or from the CPU.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils import protowire as pw
from bigdl_tpu_torch.utils.caffe_export import host_f32

_DT_FLOAT = 1
_DT_INT32 = 3


# ----------------------------------------------------------- proto encoding
def _shape_proto(shape) -> bytes:
    out = b""
    for d in shape:
        out += pw.enc_bytes(2, pw.enc_varint(1, int(d)))
    return out


def _tensor_proto(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = _DT_INT32 if arr.dtype in (np.int32, np.int64) else _DT_FLOAT
    arr = arr.astype(np.int32 if dt == _DT_INT32 else np.float32)
    out = pw.enc_varint(1, dt)
    out += pw.enc_bytes(2, _shape_proto(arr.shape))
    out += pw.enc_bytes(4, arr.tobytes())
    return out


def _attr(value_bytes: bytes) -> bytes:
    return value_bytes


def _attr_entry(key: str, value_bytes: bytes) -> bytes:
    return pw.enc_bytes(5, pw.enc_string(1, key) + pw.enc_bytes(2, value_bytes))


def _attr_type(key: str, dt: int) -> bytes:
    return _attr_entry(key, pw.enc_varint(6, dt))


def _attr_tensor(key: str, arr) -> bytes:
    return _attr_entry(key, pw.enc_bytes(8, _tensor_proto(arr)))


def _attr_shape(key: str, shape) -> bytes:
    return _attr_entry(key, pw.enc_bytes(7, _shape_proto(shape)))


def _attr_s(key: str, s: str) -> bytes:
    return _attr_entry(key, pw.enc_bytes(2, s.encode()))


def _attr_b(key: str, v: bool) -> bytes:
    return _attr_entry(key, pw.enc_varint(5, 1 if v else 0))


def _attr_ints(key: str, vals) -> bytes:
    lst = b"".join(pw.enc_varint(3, int(v)) for v in vals)
    return _attr_entry(key, pw.enc_bytes(1, lst))


def _node(name: str, op: str, inputs: List[str], *attrs: bytes) -> bytes:
    body = pw.enc_string(1, name) + pw.enc_string(2, op)
    for i in inputs:
        body += pw.enc_string(3, i)
    for a in attrs:
        body += a
    return pw.enc_bytes(1, body)


class GraphDefBuilder:
    def __init__(self):
        self.nodes: List[bytes] = []
        self._names: Dict[str, int] = {}

    def fresh(self, base: str) -> str:
        n = self._names.get(base, 0)
        self._names[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def const(self, name: str, arr) -> str:
        name = self.fresh(name)
        arr = np.asarray(arr)
        dt = _DT_INT32 if arr.dtype in (np.int32, np.int64) else _DT_FLOAT
        self.nodes.append(_node(name, "Const", [],
                                _attr_type("dtype", dt),
                                _attr_tensor("value", arr)))
        return name

    def op(self, op: str, name: str, inputs: List[str], *attrs: bytes,
           with_t: bool = True) -> str:
        name = self.fresh(name)
        alist = list(attrs)
        if with_t:
            alist.append(_attr_type("T", _DT_FLOAT))
        self.nodes.append(_node(name, op, inputs, *alist))
        return name

    def placeholder(self, name: str, shape) -> str:
        name = self.fresh(name)
        self.nodes.append(_node(name, "Placeholder", [],
                                _attr_type("dtype", _DT_FLOAT),
                                _attr_shape("shape", shape)))
        return name

    def build(self) -> bytes:
        out = b"".join(self.nodes)
        # versions: producer high enough for modern TF importers
        out += pw.enc_bytes(4, pw.enc_varint(1, 1087))
        return out


# ------------------------------------------------------------- module walk
def _flatten_modules(module: Module) -> List[Module]:
    from bigdl_tpu_torch.nn.container import flatten_sequential

    return flatten_sequential(module)


def save_tf(module: Module, input_shape, path: str,
            input_name: str = "input", output_name: str = "output",
            data_format: str = "NHWC") -> Dict[str, str]:
    """Export ``module`` (a Sequential pipeline of supported layers) as a
    frozen GraphDef (≙ Module.saveTF / BigDLToTensorflow). ``input_shape``
    excludes batch; spatial models are exported NHWC (give the NHWC shape).
    Returns {"input": name, "output": name}."""
    g = GraphDefBuilder()
    cur = g.placeholder(input_name, (-1,) + tuple(input_shape))
    for m in _flatten_modules(module):
        cur = _emit(g, m, cur, data_format)
    out = g.op("Identity", output_name, [cur])
    with open(path, "wb") as f:
        f.write(g.build())
    return {"input": input_name, "output": out}


def _emit(g: GraphDefBuilder, m: Module, cur: str, fmt: str) -> str:
    name = type(m).__name__

    if isinstance(m, nn.Linear):
        w = host_f32(m.weight)  # (out, in)
        wn = g.const(f"{name}/weight", w.T.copy())
        cur = g.op("MatMul", f"{name}/matmul", [cur, wn],
                   _attr_b("transpose_a", False), _attr_b("transpose_b", False))
        if getattr(m, "with_bias", True) and hasattr(m, "bias"):
            bn = g.const(f"{name}/bias", host_f32(m.bias))
            cur = g.op("BiasAdd", f"{name}/biasadd", [cur, bn])
        return cur
    if isinstance(m, nn.SpatialConvolution):
        if m.n_group != 1:
            raise ValueError("grouped conv export is unsupported")
        if m.format != fmt:
            raise ValueError(
                f"conv module is {m.format} but export data_format is "
                f"{fmt}; build the model with format={fmt!r} (TF CPU "
                "kernels only run NHWC)")
        w = host_f32(m.weight)  # OIHW
        hwio = np.transpose(w, (2, 3, 1, 0)).copy()
        wn = g.const(f"{name}/weight", hwio)
        if m.pad_w == -1 or m.pad_h == -1:
            padding = "SAME"
        elif (m.pad_w, m.pad_h) == (0, 0):
            padding = "VALID"
        else:
            raise ValueError(
                "explicit conv padding has no TF attr; use SAME/VALID")
        cur = g.op("Conv2D", f"{name}/conv", [cur, wn],
                   _attr_ints("strides", (1, m.stride_h, m.stride_w, 1)),
                   _attr_s("padding", padding),
                   _attr_s("data_format", fmt))
        if m.with_bias:
            bn = g.const(f"{name}/bias", host_f32(m.bias))
            cur = g.op("BiasAdd", f"{name}/biasadd", [cur, bn],
                       _attr_s("data_format", fmt))
        return cur
    if isinstance(m, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
        if m.format != fmt:
            raise ValueError(
                f"pool module is {m.format} but export data_format is {fmt}")
        if (m.pad_h, m.pad_w) != (0, 0):
            raise ValueError(
                "explicitly padded pooling has no TF attr (only VALID "
                "exports exactly); restructure with pad 0")
        if m.ceil_mode:
            raise ValueError("ceil-mode pooling does not export to TF "
                             "(VALID floors); use floor mode")
        op = "MaxPool" if isinstance(m, nn.SpatialMaxPooling) else "AvgPool"
        return g.op(op, f"{name}/pool", [cur],
                    _attr_ints("ksize", (1, m.kh, m.kw, 1)),
                    _attr_ints("strides", (1, m.dh, m.dw, 1)),
                    _attr_s("padding", "VALID"),
                    _attr_s("data_format", fmt))
    if isinstance(m, nn.ReLU):
        return g.op("Relu", f"{name}", [cur])
    if isinstance(m, nn.Tanh):
        return g.op("Tanh", f"{name}", [cur])
    if isinstance(m, nn.Sigmoid):
        return g.op("Sigmoid", f"{name}", [cur])
    if isinstance(m, nn.SoftMax):
        return g.op("Softmax", f"{name}", [cur])
    if isinstance(m, nn.LogSoftMax):
        return g.op("LogSoftmax", f"{name}", [cur])
    if isinstance(m, nn.Dropout):
        return cur  # inference export: identity
    if isinstance(m, (nn.View, nn.Reshape)):
        dims = [int(d) for d in
                (m.sizes if hasattr(m, "sizes") else m.size)]
        shape = g.const(f"{name}/shape",
                        np.asarray([-1] + dims, np.int32))
        return g.op("Reshape", f"{name}", [cur, shape],
                    _attr_entry("Tshape", pw.enc_varint(6, _DT_INT32)))
    if isinstance(m, (nn.SpatialBatchNormalization, nn.BatchNormalization)):
        if isinstance(m, nn.SpatialBatchNormalization) and m.format != fmt:
            raise ValueError(
                f"BN module is {m.format} but export data_format is {fmt}")
        # eval-mode BN folds to x*scale + offset (exported as Mul + Add)
        eps = m.eps
        mean = host_f32(m.running_mean)
        var = host_f32(m.running_var)
        gamma = host_f32(m.weight) if m.affine else np.ones_like(mean)
        beta = host_f32(m.bias) if m.affine else np.zeros_like(mean)
        scale = gamma / np.sqrt(var + eps)
        offset = beta - mean * scale
        sn = g.const(f"{name}/scale", scale.astype(np.float32))
        on = g.const(f"{name}/offset", offset.astype(np.float32))
        cur = g.op("Mul", f"{name}/mul", [cur, sn])
        return g.op("Add", f"{name}/add", [cur, on])
    if isinstance(m, nn.Identity):
        return cur
    raise ValueError(f"tf export: unsupported layer {name}")
