"""Sharded training-state checkpoints (the counterpart of
``bigdl_tpu/utils/orbax_ckpt.py``).

The JAX package writes mesh-sharded state with ``orbax.checkpoint``:
each array shard from the process that holds it, restored straight into
the requested shardings. Here the format is
``torch.distributed.checkpoint`` (part of torch): every rank saves its
own blocks (a replicated tensor once, the planner drops the copies) and
a restore reads whichever blocks a rank's new layout needs, so a state
saved from one layout restores onto another. A rank's tensors carry no
layout, so the caller names it: ``shardings`` is a tree of
``parallel/tp.py`` ``NamedSharding``s matching ``(params, buffers,
slots)`` (None leaves, or no tree: replicated). The API mirrors the
train-state tuple::

    save_train_state(path, step, params, buffers, slots, state,
                     shardings=None)
    step, params, buffers, slots, state = restore_train_state(
        path, like=(params, buffers, slots), shardings=None)

Kept from the JAX module: the atomic replace of a local path (the blocks
land in ``path + ".tmp-save"``, the sidecar ``.meta.json`` after them,
then the rename dance promotes the pair; a restore takes the newest
complete pair among ``.tmp-save``, the path and ``.old``, and the next
save finishes a swap a crash interrupted and sweeps partial leftovers),
the step and the loop state's scalars in the sidecar, and the
collective discipline: every rank of the world calls both functions.

Object-store paths (``gs://``, ``s3://``, ...) cannot rename a prefix
atomically, so they keep the JAX module's meta-last protocol instead:
the old sidecar is removed first (the checkpoint is then detectably
incomplete during the overwrite), the blocks are rewritten in place,
and the sidecar is put last in one write; a restore refuses a bucket
checkpoint without its sidecar. There every block is one ``torch.save``
under ``<path>/blocks.<rank>.pt`` of the lowest rank that holds it,
written and read through ``utils/file.py``'s seam, and the sidecar maps
each block to its file.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from bigdl_tpu_torch.utils import file as bt_file
from bigdl_tpu_torch.utils.file import is_remote

logger = logging.getLogger("bigdl_tpu_torch")


def _norm(path: str) -> str:
    # URL-style paths (gs://, s3://) must pass through untouched
    return path if is_remote(path) else os.path.abspath(path)


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


_remove = bt_file.remove
_exists = bt_file.exists


def _swap_in(path: str) -> None:
    """Promote a COMPLETE ``path + ".tmp-save"`` pair to ``path``: retire
    the live pair to ``.old`` (blocks first, then meta), rename tmp in
    (blocks first, then meta), drop the retired pair. Every interruption
    leaves a complete pair under a name ``_resolve_restore_path`` knows."""
    tmp, old = path + ".tmp-save", path + ".old"
    _remove(old)
    _remove(old + ".meta.json")
    if _exists(path):
        os.replace(path, old)
    if _exists(path + ".meta.json"):
        os.replace(path + ".meta.json", old + ".meta.json")
    os.replace(tmp, path)
    os.replace(tmp + ".meta.json", path + ".meta.json")
    _remove(old)
    _remove(old + ".meta.json")


def _flatten(tree, prefix: str, out: list) -> list:
    """``(path, leaf)`` of a nested dict / list / tuple, paths
    ``/``-joined."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out.append((prefix, tree))
    return out


def _rebuild(like, values: dict, prefix: str):
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{prefix}/{k}")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values, f"{prefix}/{i}")
                          for i, v in enumerate(like))
    return values[prefix]


def _shardings_of(shardings) -> dict:
    """``{path: NamedSharding}`` of a (params, buffers, slots) tree of
    shardings (None leaves dropped)."""
    if shardings is None:
        return {}
    tree = dict(zip(("params", "buffers", "slots"), shardings))
    return {p: s for p, s in _flatten(tree, "", [])
            if hasattr(s, "is_fully_replicated")}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.replace("torch.", ""))


def _grid(sharding, ndim: int):
    if sharding is None or sharding.is_fully_replicated:
        return [1] * ndim
    return [sharding.num_blocks(d) for d in range(ndim)]


def _block_key(path: str, coords) -> str:
    return f"{path}@{'.'.join(str(c) for c in coords)}"


def _blocks(grid):
    """Every block coordinate of ``grid``, row-major."""
    out = [()]
    for g in grid:
        out = [c + (i,) for c in out for i in range(g)]
    return out


def _dcp():
    """``torch.distributed.checkpoint`` and the keywords of its calls.
    Imported at the first save or load, not with this module: it takes
    ~2 s, which every process that imports ``parallel/`` would pay."""
    import torch.distributed.checkpoint as dcp

    return dcp, {"no_dist": not dist.is_initialized()}


def save_train_state(path: str, step: int, params, buffers, slots,
                     state: Optional[dict] = None, shardings=None) -> None:
    """Write one checkpoint directory at ``path``, each rank its own
    blocks (``shardings``: see the module notes), replacing any previous
    checkpoint atomically. ``state`` keeps its bool / int / float / str
    entries. Collective: every rank calls it."""
    path = _norm(path)
    if is_remote(path):
        _save_remote(path, step, params, buffers, slots, state, shardings)
        return
    tmp = path + ".tmp-save"
    if _rank0():
        if _exists(tmp) and _exists(tmp + ".meta.json"):
            # a previous save crashed mid-swap AFTER fully writing the
            # new checkpoint: finish its swap (it is the newest state)
            _swap_in(path)
        else:   # partial leftovers from a crash mid-write
            _remove(tmp)
            _remove(tmp + ".meta.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _barrier()      # the cleanup lands before any block is written
    sd, layout = _local_blocks(params, buffers, slots, shardings)
    dcp, kw = _dcp()
    dcp.save(sd, checkpoint_id=tmp, **kw)
    _barrier()      # every rank's blocks are written
    if _rank0():
        with open(tmp + ".meta.json.part", "w") as f:
            json.dump(_meta(step, state, layout), f)
        os.replace(tmp + ".meta.json.part", tmp + ".meta.json")
        _swap_in(path)
    # no rank returns (and possibly restores) before rank 0's swap
    _barrier()


def _meta(step, state, layout, files=None) -> dict:
    kept = {k: v for k, v in (state or {}).items()
            if isinstance(v, (bool, int, float, str))}
    meta = {"step": int(step), "state": kept, "layout": layout}
    if files is not None:
        meta["files"] = files
    return meta


def _local_blocks(params, buffers, slots, shardings):
    """(this rank's ``{block key: CPU tensor}``, the layout of every
    leaf)."""
    by_path = _shardings_of(shardings)
    tree = {"params": params, "buffers": buffers, "slots": slots}
    sd, layout = {}, {}
    for p, leaf in _flatten(tree, "", []):
        if not torch.is_tensor(leaf):
            layout[p] = {"value": leaf}
            continue
        s = by_path.get(p)
        grid = _grid(s, leaf.dim())
        shape = [n * g for n, g in zip(leaf.shape, grid)]
        if s is None or s.is_fully_replicated:
            coords = (0,) * leaf.dim()
        else:
            me = s._my_coords()
            coords = tuple(s.block_of(d, me) for d in range(leaf.dim()))
        sd[_block_key(p, coords)] = leaf.detach().cpu().contiguous()
        layout[p] = {"shape": shape, "grid": grid,
                     "dtype": str(leaf.dtype)}
    return sd, layout


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _save_remote(path, step, params, buffers, slots, state, shardings):
    """The meta-last protocol of an object-store path (module notes)."""
    meta = path + ".meta.json"
    if _rank0():
        _remove(meta)
    _barrier()      # the old sidecar is gone before any block changes
    sd, layout = _local_blocks(params, buffers, slots, shardings)
    keys = [sorted(sd)]
    if dist.is_initialized():
        keys = [None] * dist.get_world_size()
        dist.all_gather_object(keys, sorted(sd))
    files = {}
    for r, ks in enumerate(keys):      # a block's lowest holder writes it
        for k in ks:
            files.setdefault(k, f"blocks.{r}.pt")
    mine = {k: v for k, v in sd.items() if files[k] == f"blocks.{_rank()}.pt"}
    if mine:
        bt_file.makedirs(path)
        # the blocks are host copies already: saved as they are
        bt_file.save(None, f"{path}/blocks.{_rank()}.pt", overwrite=True,
                     snapshot=mine)
    _barrier()      # every rank's blocks are written
    if _rank0():    # one put: atomic on an object store
        with bt_file.open_file(meta, "w") as f:
            f.write(json.dumps(_meta(step, state, layout, files)))
    _barrier()


def restore_train_state(path: str, like, shardings=None):
    """Restore ``(step, params, buffers, slots, state)``. ``like`` is a
    ``(params, buffers, slots)`` tree of this rank's tensors (structure,
    dtype, device and local shape); ``shardings`` names the layout to
    restore onto (any layout: a rank reads the blocks it needs).
    Collective: every rank calls it."""
    path = _resolve_restore_path(_norm(path))
    with bt_file.open_file(path + ".meta.json", "r") as f:
        meta = json.load(f)
    layout = meta["layout"]
    by_path = _shardings_of(shardings)
    params, buffers, slots = like
    tree = {"params": params, "buffers": buffers, "slots": slots}
    leaves = _flatten(tree, "", [])
    sd = {}
    for p, _ in leaves:
        lay = layout.get(p)
        if lay is None:
            raise KeyError(f"{path}: no {p!r} in the checkpoint")
        if "value" in lay:
            continue
        block = [n // g for n, g in zip(lay["shape"], lay["grid"])]
        for c in _blocks(lay["grid"]):
            sd[_block_key(p, c)] = torch.empty(block,
                                               dtype=_dtype(lay["dtype"]))
    if "files" in meta:         # an object-store checkpoint
        loaded = {}
        for k in sd:
            name = meta["files"][k]
            if name not in loaded:
                loaded[name] = bt_file.load(f"{path}/{name}")
            sd[k] = loaded[name][k]
    else:
        dcp, kw = _dcp()
        dcp.load(sd, checkpoint_id=path, **kw)
    values = {}
    for p, leaf in leaves:
        lay = layout[p]
        if "value" in lay:
            values[p] = lay["value"]
            continue
        full = torch.empty(lay["shape"], dtype=_dtype(lay["dtype"]))
        block = [n // g for n, g in zip(lay["shape"], lay["grid"])]
        for c in _blocks(lay["grid"]):
            idx = tuple(slice(i * b, (i + 1) * b)
                        for i, b in zip(c, block))
            full[idx] = sd[_block_key(p, c)]
        s = by_path.get(p)
        if s is not None and not s.is_fully_replicated:
            full = full[s.index(tuple(full.shape))]
        if torch.is_tensor(leaf):
            full = full.to(device=leaf.device, dtype=leaf.dtype)
        values[p] = full.contiguous()
    out = _rebuild(tree, values, "")
    return (int(meta["step"]), out["params"], out["buffers"], out["slots"],
            meta.get("state", {}))


def _resolve_restore_path(path: str) -> str:
    """The newest COMPLETE (blocks dir, meta) pair among the path and the
    leftovers a mid-save crash can leave: ``.tmp-save`` wins over the
    path (its meta is written only after its blocks, and the pair is
    renamed away as soon as a swap completes), ``.old`` is the last
    resort."""
    for cand in (path + ".tmp-save", path, path + ".old"):
        if _exists(cand) and _exists(cand + ".meta.json"):
            if cand != path:
                logger.warning(
                    "checkpoint save at %s was interrupted; restoring "
                    "the newest intact copy at %s", path, cand)
            return cand
    raise ValueError(
        f"{path}: checkpoint incomplete — no complete (blocks, meta) pair "
        "at the path or its .tmp-save/.old fallbacks; refusing to guess "
        "step 0 on trained weights")


def exists(path: str) -> bool:
    """A complete checkpoint pair at ``path`` or one of its fallbacks."""
    try:
        _resolve_restore_path(_norm(path))
        return True
    except ValueError:
        return False
