"""Module tree ↔ (json spec, tensor archive), in the JAX package's format.

Port of ``bigdl_tpu/utils/serializer/serializer.py``. Every Module
subclass records its constructor call (``utils/config_capture.py``); the
serializer encodes that config with the JAX package's value codec (tags
``f``, ``module``, ``table``, ``tuple``, ``list``, ``dict``, ``tensor``,
``obj``, ``dtype``), plus the parameter and buffer arrays, plus the
children attached after construction (``Container.add``) and the plain
attributes set after it (``extra``). Graphs carry their node topology
through ``__serialize_spec__`` / ``__deserialize_spec__``.

Format: ``path`` is a zip with
  module.json — {"format": 1, "root": id, "records": {id: record}},
                 a record's keys ``class``, ``name``, ``init`` / ``custom``,
                 ``children``, ``params``, ``buffers``, ``frozen``, ``extra``
  tensors.npz — numpy arrays keyed t0, t1, ...

Where the port parts from the JAX writer:

- Constructor arguments are written by name (``init.kwargs``); only the
  values of a ``*args`` parameter stay positional. The JAX package writes
  them as they were passed, so a JAX record's positional ``args`` are
  bound here to JAX's parameter names: the port's own, except for the
  classes in ``JAX_POSITIONAL`` whose order differs.
- ``device`` and generator objects (``torch.Generator``,
  ``RandomGenerator``) are not written: the loader gives its own
  ``device=`` and the layers draw from fresh generators, as the pickle
  path drops a bound generator (``utils/file.py``).
- A bfloat16 tensor is written as the 2-byte void payload (``|V2``) that
  the JAX package's ml_dtypes array gives, and a ``|V2`` array is read
  back as bfloat16 bit for bit; neither needs ml_dtypes. Every parameter
  and buffer takes its dtype from the archive.
- A class path ``bigdl_tpu.X`` resolves to ``bigdl_tpu_torch.X`` as a
  string: reading a JAX archive imports nothing of the JAX package, and
  no class outside ``bigdl_tpu_torch.`` is resolved.
"""

from __future__ import annotations

import importlib
import inspect
import io
import json
import os
import zipfile
from typing import Dict

import numpy as np
import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.config_capture import get_init_config
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.table import Table

PORT_PREFIX = "bigdl_tpu_torch."
JAX_PREFIX = "bigdl_tpu."

# JAX's positional constructor parameters of the classes whose order in
# the port differs (the others agree, up to a trailing ``generator``).
JAX_POSITIONAL = {
    "bigdl_tpu_torch.nn.attention.MultiHeadAttention": (
        "embed_dim", "num_heads", "dropout", "with_bias", "causal",
        "sequence_parallel", "use_flash", "num_kv_heads", "rotary",
        "rotary_base"),
    "bigdl_tpu_torch.nn.attention.TransformerBlock": (
        "embed_dim", "num_heads", "mlp_ratio", "dropout", "causal",
        "sequence_parallel", "use_flash", "n_experts", "expert_parallel",
        "num_kv_heads", "rotary"),
    "bigdl_tpu_torch.models.transformer.TransformerLM": (
        "vocab_size", "embed_dim", "num_heads", "num_layers", "max_len",
        "mlp_ratio", "dropout", "causal", "sequence_parallel",
        "tie_embeddings", "use_flash", "remat", "n_experts",
        "expert_parallel", "num_kv_heads", "use_rope"),
}

# the port's constructor arguments that the JAX package lacks: ``device``
# is the loader's, a generator object is fresh on load, and the others
# are written only where they differ from their default
_PORT_ONLY_ARGS = ("device", "dtype", "rng", "generator", "seed")
_NO_DEFAULT = inspect.Parameter.empty


class _Ctx:
    def __init__(self):
        self.records: Dict[str, dict] = {}
        self.mod_ids: Dict[int, str] = {}
        self.tensors: Dict[str, np.ndarray] = {}

    def tensor_key(self, arr) -> str:
        key = f"t{len(self.tensors)}"
        self.tensors[key] = to_numpy(arr)
        return key


def to_numpy(arr) -> np.ndarray:
    """A host numpy copy of ``arr``; bfloat16 as its ``|V2`` payload."""
    if not torch.is_tensor(arr):
        return np.asarray(arr)
    t = arr.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    try:
        return t.numpy()
    except TypeError as e:
        raise TypeError(f"cannot serialize a {t.dtype} tensor: {e}") from None


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``arr``; a 2-byte void array is bfloat16."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise TypeError(f"cannot read a tensor of dtype {arr.dtype}: only "
                            "the 2-byte void payload (bfloat16) is known")
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _class_path(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def _port_path(path: str) -> str:
    """``path`` in the port: ``bigdl_tpu.X`` is ``bigdl_tpu_torch.X``."""
    if path.startswith(PORT_PREFIX):
        return path
    if path.startswith(JAX_PREFIX):
        return PORT_PREFIX + path[len(JAX_PREFIX):]
    raise ValueError(f"class {path!r} is outside {PORT_PREFIX[:-1]}: "
                     "refusing to resolve it")


def _resolve_class(path: str):
    mod, _, name = _port_path(path).rpartition(".")
    target = importlib.import_module(mod)
    for part in name.split("."):
        target = getattr(target, part)
    return target


def _params(cls):
    return list(inspect.signature(cls.__init__).parameters.values())[1:]


def _by_name(obj):
    """The captured constructor call of ``obj`` as ``(args, kwargs)`` with
    every argument bound to its parameter's name (``args`` holds only what
    is passed positionally: a ``*args`` parameter's values and the
    parameters before it), ``device`` and generator objects left out."""
    args, kwargs = get_init_config(obj)
    sig = inspect.signature(type(obj).__init__)
    bound = sig.bind(obj, *args, **kwargs)
    params = list(sig.parameters.values())[1:]
    varpos = next((p.name for p in params
                   if p.kind == p.VAR_POSITIONAL), None)
    pos, named = [], {}
    for p in params:
        if p.name not in bound.arguments:
            continue
        v = bound.arguments[p.name]
        if p.kind == p.VAR_POSITIONAL:
            pos.extend(v)
        elif p.kind == p.VAR_KEYWORD:
            named.update(v)
        elif varpos is not None and bound.arguments.get(varpos) \
                and p.kind == p.POSITIONAL_OR_KEYWORD:
            pos.append(v)
        else:
            named[p.name] = v
    named = {k: v for k, v in named.items()
             if not _left_out(type(obj), k, v)}
    return pos, named


def _left_out(cls, name: str, value) -> bool:
    if isinstance(value, (torch.Generator, RandomGenerator)):
        return True
    if name not in _PORT_ONLY_ARGS:
        return False
    if name == "device":
        return True
    default = _default_of(cls, name)
    try:
        return value is default or bool(value == default)
    except (TypeError, RuntimeError, ValueError):
        return False


def _inits(cls):
    """The ``__init__`` parameters of ``cls`` and of its bases, nearest
    first (``**kw`` passes some of them on)."""
    for klass in cls.__mro__[:-1]:  # not ``object``
        init = klass.__dict__.get("__init__")
        if init is not None:
            yield list(inspect.signature(init).parameters.values())[1:]


def _default_of(cls, name: str):
    for params in _inits(cls):
        for p in params:
            if p.name == name:
                return p.default
    return _NO_DEFAULT


def takes_device(cls) -> bool:
    """Whether ``cls(...)`` takes ``device=``: as a parameter, or through
    ``**kw`` to a base that takes it."""
    for params in _inits(cls):
        names = {p.name for p in params}
        if "device" in names:
            return True
        if not any(p.kind == p.VAR_KEYWORD for p in params):
            return False
    return False


def _call_args(cls, path: str, args, kwargs):
    """``(args, kwargs)`` to construct ``cls`` from a record of class
    ``path``: a JAX record's positional arguments bound to JAX's names."""
    if not path.startswith(JAX_PREFIX) or not args:
        return list(args), dict(kwargs)
    names = JAX_POSITIONAL.get(_port_path(path))
    if names is None:
        params = _params(cls)
        if any(p.kind == p.VAR_POSITIONAL for p in params):
            return list(args), dict(kwargs)
        names = [p.name for p in params
                 if p.kind == p.POSITIONAL_OR_KEYWORD]
    if len(args) > len(names):
        raise TypeError(f"{path}: {len(args)} positional arguments, "
                        f"JAX's constructor takes {len(names)}")
    out = dict(zip(names, args))
    clash = sorted(set(out) & set(kwargs))
    if clash:
        raise TypeError(f"{path}: arguments {clash} given twice")
    out.update(kwargs)
    return [], out


def _encode(value, ctx: _Ctx):
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return {"t": "f", "v": repr(value)}  # repr round-trips inf/nan
    if isinstance(value, torch.nn.Module):
        return {"t": "module", "id": _serialize_module(value, ctx)}
    if isinstance(value, Table):
        return {"t": "table", "items": [_encode(v, ctx) for v in value]}
    if isinstance(value, (list, tuple)):
        return {"t": "tuple" if isinstance(value, tuple) else "list",
                "items": [_encode(v, ctx) for v in value]}
    if isinstance(value, dict):
        return {"t": "dict", "items": [[_encode(k, ctx), _encode(v, ctx)]
                                       for k, v in value.items()]}
    if torch.is_tensor(value) or isinstance(value, np.ndarray):
        return {"t": "tensor", "key": ctx.tensor_key(value)}
    if isinstance(value, np.generic):  # numpy scalar
        return _encode(value.item(), ctx)
    if hasattr(value, "_init_config"):  # regularizer, init method, ...
        args, kwargs = _by_name(value)
        return {"t": "obj", "class": _class_path(value),
                "args": [_encode(a, ctx) for a in args],
                "kwargs": {k: _encode(v, ctx) for k, v in kwargs.items()}}
    if isinstance(value, torch.dtype):
        return {"t": "dtype", "v": str(value).rpartition(".")[2]}
    if isinstance(value, np.dtype) or (isinstance(value, type)
                                       and issubclass(value, np.generic)):
        return {"t": "dtype", "v": np.dtype(value).name}
    raise TypeError(
        f"cannot serialize constructor argument of type {type(value)!r}: "
        f"{value!r}")


def _decode(enc, rd: "_Reader"):
    if enc is None or isinstance(enc, (bool, int, str)):
        return enc
    t = enc["t"]
    if t == "f":
        return float(enc["v"])
    if t == "module":
        return rd.module(enc["id"])
    if t == "table":
        return Table(*[_decode(v, rd) for v in enc["items"]])
    if t == "tuple":
        return tuple(_decode(v, rd) for v in enc["items"])
    if t == "list":
        return [_decode(v, rd) for v in enc["items"]]
    if t == "dict":
        return {_decode(k, rd): _decode(v, rd) for k, v in enc["items"]}
    if t == "tensor":
        return rd.tensor(enc["key"])
    if t == "dtype":
        return getattr(torch, enc["v"])
    if t == "obj":
        cls = _resolve_class(enc["class"])
        args, kwargs = _call_args(
            cls, enc["class"], [_decode(a, rd) for a in enc["args"]],
            {k: _decode(v, rd) for k, v in enc["kwargs"].items()})
        return cls(*args, **kwargs)
    raise ValueError(f"unknown encoded tag {t!r}")


def _serialize_module(module, ctx: _Ctx) -> str:
    if not isinstance(module, Module):
        raise TypeError(f"cannot serialize {type(module)!r}: not a "
                        f"{PORT_PREFIX[:-1]} module")
    mid = ctx.mod_ids.get(id(module))
    if mid is not None:
        return mid
    mid = f"m{len(ctx.mod_ids)}"
    ctx.mod_ids[id(module)] = mid
    rec: dict = {"class": _class_path(module), "name": module._name}
    ctx.records[mid] = rec  # register before recursing (shared modules)

    if hasattr(module, "__serialize_spec__"):
        rec["custom"] = module.__serialize_spec__(
            lambda m: _serialize_module(m, ctx), ctx.tensor_key)
    else:
        args, kwargs = _by_name(module)
        rec["init"] = {"args": [_encode(a, ctx) for a in args],
                       "kwargs": {k: _encode(v, ctx)
                                  for k, v in kwargs.items()}}
        rec["children"] = [[name, _serialize_module(child, ctx)]
                           for name, child in _children(module)]
    rec["params"] = {k: ctx.tensor_key(v)
                     for k, v in module._parameters.items() if v is not None}
    rec["buffers"] = {k: ctx.tensor_key(v)
                      for k, v in module._buffers.items() if v is not None}
    rec["frozen"] = bool(module._frozen)
    extra = _extra_state(module)
    if extra:
        rec["extra"] = {k: _encode(v, ctx) for k, v in extra.items()}
    return mid


def _children(module: Module):
    """The registered children, then the modules held as public
    attributes without registering them (a recurrent cell's activation),
    which the JAX package registers as children."""
    out = [(k, v) for k, v in module._modules.items() if v is not None]
    out += [(k, v) for k, v in vars(module).items()
            if isinstance(v, torch.nn.Module) and not k.startswith("_")]
    return out


_TRANSIENT_ATTRS = {"output", "grad_input", "training"}


def _is_plain(v) -> bool:
    if v is None or isinstance(v, (bool, int, str)):
        return True
    if isinstance(v, float):
        return bool(np.isfinite(v))  # inf defaults re-derive from init
    if isinstance(v, (tuple, list)):
        return all(_is_plain(i) for i in v)
    return False


def _extra_state(module: Module) -> dict:
    """Primitive attributes mutated after construction (``.ceil()``,
    ``set_p``...), restored verbatim on load: constructor args alone do
    not capture builder-style mutations. ``vars()`` of a torch module
    also holds ``training`` and torch's ``_*`` registries, left out."""
    out = {}
    for k, v in vars(module).items():
        if k.startswith("_") or k in _TRANSIENT_ATTRS:
            continue
        if k in module._parameters or k in module._buffers \
                or k in module._modules:
            continue
        if _is_plain(v):
            out[k] = v
    return out


class _Reader:
    """Materializes the records of one archive on ``device``; each
    record once (a shared module loads as one module)."""

    def __init__(self, records, tensors, device):
        self.records, self.tensors = records, tensors
        self.device = device
        self.memo: Dict[str, Module] = {}

    def tensor(self, key: str) -> torch.Tensor:
        return from_numpy(self.tensors[key])

    def module(self, mid: str) -> Module:
        if mid in self.memo:
            return self.memo[mid]
        rec = self.records[mid]
        cls = _resolve_class(rec["class"])
        if "custom" in rec:
            inst = cls.__deserialize_spec__(rec["custom"], self.module,
                                            self.tensor)
            self.memo[mid] = inst
        else:
            init = rec["init"]
            args, kwargs = _call_args(
                cls, rec["class"], [_decode(a, self) for a in init["args"]],
                {k: _decode(v, self) for k, v in init["kwargs"].items()})
            if takes_device(cls):
                kwargs.setdefault("device", self.device)
            inst = cls(*args, **kwargs)
            self.memo[mid] = inst
            for name, child_id in rec["children"]:
                self._attach(inst, name, self.module(child_id))
        for k, key in rec["params"].items():
            t = self.tensor(key).to(self.device)
            old = inst._parameters.get(k)
            grad = (old.requires_grad if old is not None else True) \
                and t.is_floating_point()
            p = torch.nn.Parameter(t, requires_grad=grad)
            if k in inst._parameters:
                inst._parameters[k] = p
            else:
                inst.register_parameter(k, p)
        for k, key in rec["buffers"].items():
            t = self.tensor(key).to(self.device)
            if k in inst._buffers:
                inst._buffers[k] = t
            else:
                inst.register_buffer(k, t)
        for k, enc in rec.get("extra", {}).items():
            if k in inst._parameters or k in inst._buffers \
                    or k in inst._modules:
                continue
            attr = getattr(type(inst), k, None)
            if isinstance(attr, property) and attr.fset is None:
                continue  # derived in the port: nothing to restore
            setattr(inst, k, _decode(enc, self))
        if rec.get("name"):
            inst.set_name(rec["name"])
        if rec.get("frozen"):
            inst._frozen = True
        return inst

    @staticmethod
    def _attach(inst: Module, name: str, child: Module) -> None:
        if inst._modules.get(name) is child:
            return
        if name not in inst._modules \
                and isinstance(inst.__dict__.get(name), torch.nn.Module):
            # held but not registered (a recurrent cell's activation)
            object.__setattr__(inst, name, child)
        else:
            inst.__dict__.pop(name, None)  # a None placeholder (``cell``)
            inst._modules[name] = child


def module_to_spec(module: Module):
    """(spec_dict, {tensor_key: np.ndarray}): the in-memory form."""
    ctx = _Ctx()
    root = _serialize_module(module, ctx)
    return {"format": 1, "root": root, "records": ctx.records}, ctx.tensors


def module_from_spec(spec: dict, tensors, device=DEFAULT_DEVICE) -> Module:
    dev = resolve_device(device)
    return _Reader(spec["records"], tensors, dev).module(spec["root"])


def save_module(module: Module, path: str, overwrite: bool = False) -> None:
    """≙ AbstractModule.saveModule (protobuf path,
    AbstractModule.scala:523)."""
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists; pass overwrite=True")
    spec, tensors = module_to_spec(module)
    buf = io.BytesIO()
    write_npz(buf, tensors)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("module.json", json.dumps(spec))
        z.writestr("tensors.npz", buf.getvalue())


def write_npz(f, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez(f, **arrays)``, but a bfloat16 payload (``|V2``) gets
    the header ``'<V2'`` that numpy writes for an ml_dtypes bfloat16
    array, so each ``.npy`` member has the JAX package's bytes."""
    fmt = np.lib.format
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as z:
        for key, arr in arrays.items():
            with z.open(key + ".npy", "w", force_zip64=True) as fid:
                if arr.dtype.kind != "V":
                    fmt.write_array(fid, np.asanyarray(arr), allow_pickle=False)
                    continue
                arr = np.ascontiguousarray(arr)
                header = fmt.header_data_from_array_1_0(arr)
                header["descr"] = "<V2"
                fmt.write_array_header_1_0(fid, header)
                fid.write(arr.tobytes())


def load_module(path: str, device=DEFAULT_DEVICE) -> Module:
    """≙ Module.loadModule (nn/Module.scala:44-94 protobuf path): the
    module of an archive written by :func:`save_module` or by the JAX
    package, built on ``device``."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as z:
        spec = json.loads(z.read("module.json").decode("utf-8"))
        with np.load(io.BytesIO(z.read("tensors.npz"))) as npz:
            tensors = {k: npz[k] for k in npz.files}
    return _Reader(spec["records"], tensors, dev).module(spec["root"])
