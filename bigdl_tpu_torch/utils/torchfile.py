"""Torch7 .t7 binary serialization: reader + writer (port of
``bigdl_tpu/utils/torchfile.py``).

Reference: utils/TorchFile.scala (read/write of Lua Torch objects —
tensors, storages, tables, nn modules) backing ``Module.loadTorch`` /
``saveTorch`` (nn/Module.scala:64, AbstractModule.scala:565).

Format (binary mode): each object = int32 type tag then payload.
  0 nil | 1 number(double) | 2 string(int32 len + bytes) | 3 table
  4 torch object | 5 boolean | 6/7/8 functions (unsupported here)
Torch objects carry an int32 memo index, a version string ("V 1"), the
class name, then class payload: tensors = ndim/sizes/strides/offset +
storage ref; storages = int64 count + raw elements; nn modules = a table
of fields. The reader and the writer work on the host in numpy, as the
JAX package's do, and write the same bytes; the writer also takes torch
tensors (copied to the host). ``load_torch`` maps the common torch nn
classes onto the port's modules, built on ``device=``. As in the JAX
package, the writer takes raw objects and ``TorchObject`` trees, not a
module: ``save(path, module)`` raises ``TypeError``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5

_STORAGE_DTYPES = {
    "torch.FloatStorage": (np.float32, 4),
    "torch.DoubleStorage": (np.float64, 8),
    "torch.LongStorage": (np.int64, 8),
    "torch.IntStorage": (np.int32, 4),
    "torch.ByteStorage": (np.uint8, 1),
    "torch.CharStorage": (np.int8, 1),
    "torch.ShortStorage": (np.int16, 2),
}
_TENSOR_CLASSES = {f"torch.{p}Tensor": f"torch.{p}Storage"
                   for p in ("Float", "Double", "Long", "Int", "Byte", "Char", "Short")}


class TorchObject:
    """A non-tensor torch class instance: .torch_class + .fields table."""

    def __init__(self, torch_class: str, fields: dict):
        self.torch_class = torch_class
        self.fields = fields

    def __getitem__(self, k):
        return self.fields.get(k)

    def __repr__(self):
        return f"TorchObject({self.torch_class})"


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.memo: Dict[int, Any] = {}

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from("<" + fmt, self.data, self.pos)
        self.pos += size
        return vals[0] if len(vals) == 1 else vals

    def read_int(self) -> int:
        return self._read("i")

    def read_long(self) -> int:
        return self._read("q")

    def read_string(self) -> str:
        n = self.read_int()
        s = self.data[self.pos:self.pos + n].decode("latin-1")
        self.pos += n
        return s

    def read_object(self):
        t = self.read_int()
        if t == TYPE_NIL:
            return None
        if t == TYPE_NUMBER:
            return self._read("d")
        if t == TYPE_STRING:
            return self.read_string()
        if t == TYPE_BOOLEAN:
            return bool(self.read_int())
        if t == TYPE_TABLE:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            n = self.read_int()
            table: Dict[Any, Any] = {}
            self.memo[idx] = table
            for _ in range(n):
                k = self.read_object()
                v = self.read_object()
                table[k] = v
            return table
        if t == TYPE_TORCH:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            version = self.read_string()  # "V 1"
            cls = self.read_string() if version.startswith("V") else version
            return self._read_torch_class(idx, cls)
        raise ValueError(f"unsupported t7 type tag {t} at {self.pos}")

    def _read_torch_class(self, idx: int, cls: str):
        if cls in _TENSOR_CLASSES:
            ndim = self.read_int()
            sizes = [self.read_long() for _ in range(ndim)]
            strides = [self.read_long() for _ in range(ndim)]
            offset = self.read_long() - 1  # 1-based
            placeholder = {}
            self.memo[idx] = placeholder
            storage = self.read_object()  # storage np array (or None)
            if storage is None or ndim == 0:
                arr = np.zeros(sizes, np.float32)
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=sizes,
                    strides=[s * storage.itemsize for s in strides]).copy()
            self.memo[idx] = arr
            return arr
        if cls in _STORAGE_DTYPES:
            dtype, itemsize = _STORAGE_DTYPES[cls]
            n = self.read_long()
            arr = np.frombuffer(self.data, dtype, n, self.pos).copy()
            self.pos += n * itemsize
            self.memo[idx] = arr
            return arr
        # generic class: payload is one table of fields
        obj = TorchObject(cls, {})
        self.memo[idx] = obj
        fields = self.read_object()
        obj.fields = fields if isinstance(fields, dict) else {}
        return obj


class _Writer:
    def __init__(self):
        self.out = bytearray()
        self.next_idx = 1

    def _w(self, fmt: str, *vals):
        self.out += struct.pack("<" + fmt, *vals)

    def write_string(self, s: str):
        b = s.encode("latin-1")
        self._w("i", len(b))
        self.out += b

    def write_object(self, obj):
        if obj is None:
            self._w("i", TYPE_NIL)
        elif isinstance(obj, bool):
            self._w("i", TYPE_BOOLEAN)
            self._w("i", int(obj))
        elif isinstance(obj, (int, float)):
            self._w("i", TYPE_NUMBER)
            self._w("d", float(obj))
        elif isinstance(obj, str):
            self._w("i", TYPE_STRING)
            self.write_string(obj)
        elif torch.is_tensor(obj):
            self._write_tensor(_host(obj))
        elif isinstance(obj, np.ndarray) or (
                hasattr(obj, "__array__")
                and not isinstance(obj, torch.nn.Module)):
            self._write_tensor(np.asarray(obj))
        elif isinstance(obj, dict):
            self._w("i", TYPE_TABLE)
            self._w("i", self._idx())
            self._w("i", len(obj))
            for k, v in obj.items():
                self.write_object(k)
                self.write_object(v)
        elif isinstance(obj, TorchObject):
            self._w("i", TYPE_TORCH)
            self._w("i", self._idx())
            self.write_string("V 1")
            self.write_string(obj.torch_class)
            self.write_object(obj.fields)
        else:
            raise TypeError(f"cannot write {type(obj)} to t7")

    def _idx(self) -> int:
        i = self.next_idx
        self.next_idx += 1
        return i

    def _write_tensor(self, arr: np.ndarray):
        if arr.dtype == np.float64:
            tcls, scls = "torch.DoubleTensor", "torch.DoubleStorage"
        elif arr.dtype == np.int64:
            tcls, scls = "torch.LongTensor", "torch.LongStorage"
        else:
            arr = arr.astype(np.float32)
            tcls, scls = "torch.FloatTensor", "torch.FloatStorage"
        arr = np.ascontiguousarray(arr)
        self._w("i", TYPE_TORCH)
        self._w("i", self._idx())
        self.write_string("V 1")
        self.write_string(tcls)
        self._w("i", arr.ndim)
        for s in arr.shape:
            self._w("q", s)
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self._w("q", s)
        self._w("q", 1)  # storage offset (1-based)
        # storage
        self._w("i", TYPE_TORCH)
        self._w("i", self._idx())
        self.write_string("V 1")
        self.write_string(scls)
        self._w("q", arr.size)
        self.out += arr.tobytes()


def load(path: str):
    """Raw t7 read → python objects (np arrays / dicts / TorchObject)."""
    with open(path, "rb") as f:
        return _Reader(f.read()).read_object()


def save(path: str, obj) -> None:
    w = _Writer()
    w.write_object(obj)
    with open(path, "wb") as f:
        f.write(bytes(w.out))


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (bf16, which numpy lacks, as f32: the writer
    stores every type but f64 and int64 as a FloatTensor anyway)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ------------------------------------------ torch nn -> bigdl_tpu_torch.nn
def _seq_children(fields: dict):
    mods = fields.get("modules", {})
    return [mods[k] for k in sorted(k for k in mods
                                    if isinstance(k, (int, float)))]


def _assign(param: torch.Tensor, arr) -> None:
    """``param``'s values from the host array ``arr`` (reshaped to it)."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    with torch.no_grad():
        param.copy_(src.reshape(param.shape))


def _to_module(obj, device):
    from bigdl_tpu_torch import nn

    if not isinstance(obj, TorchObject):
        raise TypeError(f"not a torch module: {obj!r}")
    cls = obj.torch_class.split(".")[-1]
    f = obj.fields
    dev = dict(device=device)

    def wb(m):
        if f.get("weight") is not None:
            _assign(m.weight, f["weight"])
        if f.get("bias") is not None and "bias" in m._parameters:
            _assign(m.bias, f["bias"])
        return m

    if cls == "Sequential":
        s = nn.Sequential()
        for child in _seq_children(f):
            s.add(_to_module(child, device))
        return s
    if cls in ("Concat",):
        c = nn.Concat(int(f.get("dimension", 2)))
        for child in _seq_children(f):
            c.add(_to_module(child, device))
        return c
    if cls == "ConcatTable":
        c = nn.ConcatTable()
        for child in _seq_children(f):
            c.add(_to_module(child, device))
        return c
    if cls == "Linear":
        w = np.asarray(f["weight"])
        m = nn.Linear(w.shape[1], w.shape[0],
                      with_bias=f.get("bias") is not None, **dev)
        return wb(m)
    if cls in ("SpatialConvolution", "SpatialConvolutionMM"):
        m = nn.SpatialConvolution(
            int(f["nInputPlane"]), int(f["nOutputPlane"]),
            int(f["kW"]), int(f["kH"]), int(f.get("dW", 1)),
            int(f.get("dH", 1)), int(f.get("padW", 0)), int(f.get("padH", 0)),
            with_bias=f.get("bias") is not None, **dev)
        return wb(m)
    if cls == "SpatialMaxPooling":
        m = nn.SpatialMaxPooling(int(f["kW"]), int(f["kH"]),
                                 int(f.get("dW", 1)), int(f.get("dH", 1)),
                                 int(f.get("padW", 0)), int(f.get("padH", 0)))
        if f.get("ceil_mode"):
            m.ceil()
        return m
    if cls == "SpatialAveragePooling":
        return nn.SpatialAveragePooling(int(f["kW"]), int(f["kH"]),
                                        int(f.get("dW", 1)),
                                        int(f.get("dH", 1)))
    if cls == "SpatialBatchNormalization":
        m = nn.SpatialBatchNormalization(
            int(f.get("nOutput") or len(np.asarray(f["running_mean"]))),
            float(f.get("eps", 1e-5)), float(f.get("momentum", 0.1)),
            affine=f.get("weight") is not None, **dev)
        for name in ("running_mean", "running_var"):
            if f.get(name) is not None:
                _assign(m._buffers[name], f[name])
        return wb(m)
    simple = {"ReLU": nn.ReLU, "Tanh": nn.Tanh, "Sigmoid": nn.Sigmoid,
              "SoftMax": nn.SoftMax, "LogSoftMax": nn.LogSoftMax,
              "Identity": nn.Identity, "CAddTable": nn.CAddTable}
    if cls in simple:
        return simple[cls]()
    if cls == "Dropout":
        return nn.Dropout(float(f.get("p", 0.5)))
    if cls == "JoinTable":
        return nn.JoinTable(int(f.get("dimension", 2)))
    if cls == "Reshape":
        size = f.get("size")
        return nn.Reshape(tuple(int(s) for s in np.asarray(size).reshape(-1)))
    if cls == "View":
        size = f.get("size")
        return nn.View(tuple(int(s) for s in np.asarray(size).reshape(-1)))
    raise ValueError(f"unsupported torch module class {obj.torch_class!r}")


def load_torch(path: str, device=DEFAULT_DEVICE):
    """≙ Module.loadTorch (nn/Module.scala:64): the nn module tree of the
    .t7 file at ``path`` as the port's modules on ``device``."""
    dev = resolve_device(device)
    return _to_module(load(path), dev)
