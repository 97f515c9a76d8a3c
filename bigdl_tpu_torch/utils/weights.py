"""Weight bridge from the JAX package's parameter tree into the port.

The JAX package's ``params_dict()`` is a nested dict
``{child: {...}, "~params": {name: array}}``; the port's modules register
the same children and parameters under the same names (see
``nn/module.py``), so the bridge is a key-for-key copy plus a dtype cast.
No layout needs a transpose: Linear weights are (out, in) on both sides.
Give it the tree with its leaves converted to numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import PARAMS_KEY


def _walk(tree: Dict, path=()):
    for key in sorted(tree):
        sub = tree[key]
        if key == PARAMS_KEY:
            for name in sorted(sub):
                yield path + (PARAMS_KEY, name), sub[name]
        else:
            yield from _walk(sub, path + (key,))


def jax_param_names(model) -> List[Tuple[str, str]]:
    """``(JAX tree path, port parameter name)`` for every parameter,
    e.g. ``("block0/attn/qkv/~params/weight", "block0.attn.qkv.weight")``."""
    return [("/".join(path),
             ".".join(p for p in path if p != PARAMS_KEY))
            for path, _ in _walk(model.params_dict())]


def _as_array(value) -> np.ndarray:
    arr = np.asarray(value)
    if arr.dtype.kind not in "fiub":   # e.g. ml_dtypes' bfloat16
        arr = arr.astype(np.float32)
    return arr


def _same_keys(ours: Dict, theirs: Dict, where: str):
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise KeyError(f"parameter tree mismatch at {where}: missing "
                       f"{missing}, unexpected {extra}")


def _load(ours: Dict, theirs: Dict, path: Tuple[str, ...]):
    where = "/".join(path) or "<root>"
    _same_keys(ours, theirs, where)
    for key in ours:
        if key != PARAMS_KEY:
            _load(ours[key], theirs[key], path + (key,))
            continue
        _same_keys(ours[key], theirs[key], f"{where}/{key}")
        for name, param in ours[key].items():
            arr = _as_array(theirs[key][name])
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(
                    f"shape mismatch at {where}/{name}: JAX "
                    f"{tuple(arr.shape)} vs port {tuple(param.shape)}")
            with torch.no_grad():
                param.copy_(torch.tensor(arr, dtype=param.dtype))


def load_jax_params(model, params: Dict) -> None:
    """Copy the JAX ``params_dict()`` tree ``params`` (numpy leaves) into
    ``model``, casting to each parameter's dtype and device. Raises on a
    missing or extra key or a shape mismatch."""
    _load(model.params_dict(), params, ())
