"""Module save and load on local paths (port of the local half of
``bigdl_tpu/utils/file.py``).

``save_module`` pickles a copy of the module whose parameters, their
gradients and its buffers are CPU tensors (``torch.save``), so a file
written from the card loads on a machine without one; a Dropout's bound
generator is not saved (the loaded layer draws from the default
generator). ``load_module`` moves the module to ``device``. ``save`` /
``load`` pickle any object (an optim method's state, a table), its
tensors on the host. Object-store paths (``gs://``, ``s3://``, ...)
raise ``NotImplementedError``: the JAX package routes them through
``etils.epath``, which the port does not carry yet (ROADMAP.md, Queue 1
item 12).
"""

from __future__ import annotations

import copy
import os

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def is_remote(path) -> bool:
    """True for URL-style paths (``gs://``, ``s3://``, ...)."""
    return "://" in str(path)


def _local(path) -> str:
    if is_remote(path):
        raise NotImplementedError(
            f"object-store path {path!r}: remote paths are not ported yet, "
            "see ROADMAP.md, Queue 1 item 12")
    return str(path)


def open_file(path, mode: str = "rb"):
    return open(_local(path), mode)


def exists(path) -> bool:
    return os.path.exists(_local(path))


def makedirs(path) -> None:
    os.makedirs(_local(path), exist_ok=True)


def listdir(path):
    return os.listdir(_local(path))


def snapshot(obj):
    """(copy, wait): a deep copy of ``obj`` whose tensors are host copies
    (parameters stay parameters, with their gradients) and whose
    generators are dropped, and a function that returns once every copy
    has landed. A CUDA tensor is copied into pinned memory without
    blocking and ``wait`` syncs on an event recorded after the copies, so
    the caller may go on queueing work: the copies read the tensors as
    they were when this was called, since the stream runs them first."""
    memo, seen, cuda = {}, set(), []
    _register(obj, memo, seen, cuda)
    clone = copy.deepcopy(obj, memo)
    if not cuda:
        return clone, lambda: None
    event = torch.cuda.Event()
    event.record()
    return clone, event.synchronize


def host_copy(obj):
    """:func:`snapshot`'s copy, landed."""
    clone, wait = snapshot(obj)
    wait()
    return clone


def _to_host(t: torch.Tensor, cuda: list) -> torch.Tensor:
    t = t.detach()
    if t.device.type != "cuda":
        return t.to("cpu", copy=True)
    cuda.append(t)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


def _register(obj, memo, seen, cuda) -> None:
    """Fill ``memo`` (a deepcopy memo) with a host copy of every tensor
    reachable from ``obj`` through containers and attributes, and None
    for every generator."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.nn.Parameter):
        q = torch.nn.Parameter(_to_host(obj, cuda),
                               requires_grad=obj.requires_grad)
        if obj.grad is not None:
            q.grad = _to_host(obj.grad, cuda)
        memo[id(obj)] = q
    elif torch.is_tensor(obj):
        memo[id(obj)] = _to_host(obj, cuda)
    elif isinstance(obj, torch.Generator):
        memo[id(obj)] = None
    elif isinstance(obj, dict):
        for v in obj.values():
            _register(v, memo, seen, cuda)
    elif isinstance(obj, (list, tuple, set)):
        for v in obj:
            _register(v, memo, seen, cuda)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        for k, v in vars(obj).items():
            if k == "_forward_rng" and v is not None:
                memo[id(v)] = None
                continue
            _register(v, memo, seen, cuda)


def save_module(module, path: str, overwrite: bool = False,
                snapshot=None) -> None:
    """Pickle ``module`` (or ``snapshot``, an earlier :func:`host_copy`
    of it) to ``path``."""
    if exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists; pass overwrite=True")
    clone = snapshot if snapshot is not None else host_copy(module)
    # a parameter pickles without its .grad: the gradients ride beside
    grads = {n: p.grad for n, p in clone.named_parameters()
             if p.grad is not None}
    with open_file(path, "wb") as f:
        torch.save({"module": clone, "grads": grads}, f)


def load_module(path: str, device=DEFAULT_DEVICE):
    """The module pickled at ``path``, with its gradients, moved to
    ``device``."""
    dev = resolve_device(device)
    with open_file(path, "rb") as f:
        saved = torch.load(f, map_location="cpu", weights_only=False)
    module = saved["module"]
    params = dict(module.named_parameters())
    for name, g in saved["grads"].items():
        params[name].grad = g
    return module.to(dev)


def save(obj, path: str, overwrite: bool = False, snapshot=None) -> None:
    """Pickle any object (or ``snapshot``, an earlier :func:`host_copy`
    of it), its tensors on the host."""
    if exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists; pass overwrite=True")
    clone = snapshot if snapshot is not None else host_copy(obj)
    with open_file(path, "wb") as f:
        torch.save(clone, f)


def load(path: str):
    with open_file(path, "rb") as f:
        return torch.load(f, map_location="cpu", weights_only=False)
