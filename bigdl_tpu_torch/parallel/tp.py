"""Tensor-parallel sharding rules and the sharded model (port of
``bigdl_tpu/parallel/tp.py``).

The JAX package annotates the params pytree with ``NamedSharding``s and
lets GSPMD place the collectives. Torch has no such compiler: here a
rank holds its own slices as ordinary tensors and the sharded modules
issue the collectives themselves. The rules and specs are the JAX
package's, path for path:

  qkv / fc1  (out, in)  -> shard dim 0 (column parallel)
  out_proj / fc2        -> shard dim 1 (row parallel)
  tok_embed  (vocab, d) -> shard dim 0 (the vocabulary)
  head       (vocab, d) -> shard dim 0
  everything else       -> replicated

``spec_for_params`` maps ``/``-joined param paths to ``PartitionSpec``s
by first-match regex; ``NamedSharding(mesh, spec)`` tells a rank which
slice of each dimension it holds on a ``parallel/engine.py`` ``Mesh``;
``shard_params`` cuts this rank's slices out of a full tree and
``fetch_to_host`` / ``put_from_host`` move a sharded tree between the
ranks and one contiguous host copy (which has no layout, as in JAX).

:func:`shard_model` builds, on each rank, the module that holds its
shards and runs (every rank of the model axis calls it, with the same
full model):

- the fused ``qkv`` rows are ``[q (E) | k (kv_dim) | v (kv_dim)]``. A
  contiguous dim-0 split would give one rank only q rows and another
  only k; rank ``r`` takes instead the q rows of heads ``[r H/n, (r + 1)
  H/n)`` and its own K and V heads, under the same ``P(model)`` spec
  (``shard_params`` does the same for a bare tree), so each rank's
  attention runs on H/n query heads and H_kv/n KV heads with no
  collective, through the flash kernel on the scoring forward;
- ``out_proj`` / ``fc2`` are row parallel: the partial products are
  summed over the model axis by one all-reduce, in f32, and the bias is
  added once, after the sum;
- the token table is split on the vocabulary: a lookup is a masked
  lookup in the local slice plus an all-reduce, and the head's local
  logits are all-gathered into vocabulary order (tied or untied);
- an int8 clone (``nn/quantized.py``) is quantized from the full float
  weights before it is sharded: codes by the rules, the per-output-
  channel scale and zero point split with a column-parallel output and
  replicated for a row-parallel layer, whose input is quantized with
  ONE scale over the whole input (an all-reduce max of the local
  ``amax``) and whose int32 partial products are summed before the
  epilogue, so the sharded int8 layer equals the unsharded one exactly.

With a data axis in the rules (``transformer_tp_rules(model, data)``,
the zero-style 2-D layout) each float weight is split over both axes and
every use all-gathers its data-axis blocks before the tensor-parallel
math. An int8 clone's codes and scales take the model-axis split of the
1-D layout and are replicated over the data axis (the JAX package
replicates every int8 buffer under any mesh), so its sharded forward
equals the unsharded int8 forward exactly; its float leaves (the token
table) keep the 2-D split.

An ``n_experts=`` model keeps its experts replicated on every rank (no
rule matches ``MoEMLP``'s leaves, as in JAX) while its attention is
sharded by heads. A ``sequence_parallel=`` model runs its ring over that
axis of the same mesh and its heads over the model axis: what the JAX
package computes under ``shard_map`` over both axes. JAX cannot run
such a model outside ``shard_map`` over its sequence axis (its position
offset is an unbound ``axis_index``), so a mesh without that axis is a
``ValueError``.
"""

from __future__ import annotations

import copy
import re
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from bigdl_tpu_torch.parallel import collectives as C


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per array dimension, each
    a mesh axis name, a tuple of names, or None (not sharded); trailing
    dimensions past the spec are not sharded."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def tree_paths(params, prefix=""):
    """``(path, leaf)`` for every leaf of a nested dict, paths
    ``/``-joined from the root (``/block0/attn/qkv/~params/weight``)."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from tree_paths(v, f"{prefix}/{k}")
    else:
        yield prefix, params


def _compile(rules):
    return [(re.compile(pat), spec) for pat, spec in rules]


def _match(compiled, path: str, default):
    for pat, spec in compiled:
        if pat.search(path):
            return spec
    return default


def spec_for_params(params, rules: List[Tuple[str, P]], default: P = P()):
    """Tree of ``PartitionSpec`` matching ``params``; first regex match
    wins."""
    compiled = _compile(rules)

    def build(sub, prefix):
        if isinstance(sub, dict):
            return {k: build(v, f"{prefix}/{k}") for k, v in sub.items()}
        return _match(compiled, prefix, default)

    return build(params, "")


def transformer_tp_rules(model_axis: str = "model", data_axis: str = None):
    """Megatron-style rules for TransformerLM param paths. With
    ``data_axis`` each weight matrix is ALSO sharded over that axis on
    the dimension the model split leaves free (qkv / fc1 ``P(model,
    data)``, out_proj / fc2 ``P(data, model)``) and the learned position
    table's rows spread over it. Every sharded dimension must divide by
    its mesh-axis size."""
    mp, dp = model_axis, data_axis
    rules = [
        (r"attn/qkv/~params/weight$", P(mp, dp)),
        (r"attn/qkv/~params/bias$", P(mp)),
        (r"fc1/~params/weight$", P(mp, dp)),
        (r"fc1/~params/bias$", P(mp)),
        (r"attn/out_proj/~params/weight$", P(dp, mp)),
        (r"fc2/~params/weight$", P(dp, mp)),
        (r"~params/tok_embed$", P(mp, dp)),
        (r"head/~params/weight$", P(mp, dp)),
    ]
    if dp is not None:
        rules.append((r"~params/pos_embed$", P(dp, None)))
    return rules


def kv_pool_spec(model_axis: str = "model") -> P:
    """The spec of a slot-pooled KV cache ``(rows, H_kv, T, D)``: heads
    sharded along the model axis (the layout the column-parallel QKV
    writes with no collective), the rest replicated."""
    return P(None, model_axis, None, None)


# ------------------------------------------------------------ shardings
def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """``jax.sharding.NamedSharding(mesh, spec)`` over a
    ``parallel/engine.py`` ``Mesh``: dimension ``d`` is cut into as many
    blocks as the axes ``spec[d]`` span, and this rank holds block
    ``index`` (row-major over those axes, in the spec's order)."""

    def __init__(self, mesh, spec=P()):
        self.mesh = mesh
        self.spec = P(*spec)
        for entry in self.spec:
            for a in _axes(entry):
                if a not in mesh.shape:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                     f"not in mesh axes "
                                     f"{list(mesh.axis_names)}")

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __hash__(self):
        return hash((id(self.mesh), tuple(self.spec)))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec names, in mesh order."""
        named = {a for e in self.spec for a in _axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in named)

    @property
    def is_fully_replicated(self) -> bool:
        return all(self.mesh.shape[a] == 1 for a in self.axes)

    def num_blocks(self, dim: int) -> int:
        if dim >= len(self.spec):
            return 1
        n = 1
        for a in _axes(self.spec[dim]):
            n *= self.mesh.shape[a]
        return n

    def block_of(self, dim: int, coords: dict) -> int:
        """The block along ``dim`` held by the rank at mesh ``coords``."""
        if dim >= len(self.spec):
            return 0
        idx = 0
        for a in _axes(self.spec[dim]):
            idx = idx * self.mesh.shape[a] + coords[a]
        return idx

    def _my_coords(self) -> dict:
        return {a: self.mesh.index(a) for a in self.mesh.axis_names}

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        out = []
        for d, size in enumerate(global_shape):
            n = self.num_blocks(d)
            if size % n:
                raise ValueError(f"dimension {d} of {tuple(global_shape)} "
                                 f"does not divide over {n} blocks "
                                 f"({self.spec})")
            out.append(size // n)
        return tuple(out)

    def index(self, global_shape) -> Tuple[slice, ...]:
        """This rank's slice of an array of ``global_shape``."""
        local = self.shard_shape(global_shape)
        coords = self._my_coords()
        return tuple(slice(self.block_of(d, coords) * s,
                           (self.block_of(d, coords) + 1) * s)
                     for d, s in enumerate(local))


def kv_pool_sharding(mesh, num_kv_heads: int,
                     model_axis: str = "model") -> NamedSharding:
    """The sharding of ``TransformerLM.init_cache`` pool buffers,
    validating that the KV head count divides the model-axis size (an
    uneven head split would leave ragged shards and break the
    zero-communication cache-write layout)."""
    if model_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh axes {tuple(mesh.axis_names)} have no "
            f"{model_axis!r} axis to shard KV heads over")
    shards = int(mesh.shape[model_axis])
    if num_kv_heads % shards != 0:
        raise ValueError(
            f"num_kv_heads ({num_kv_heads}) must divide evenly over "
            f"the {shards}-way {model_axis!r} mesh axis; choose a "
            f"mesh the head count divides or bring more KV heads")
    return NamedSharding(mesh, kv_pool_spec(model_axis))


# ------------------------------------------------------- tree plumbing
def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / lists / tuples (None
    leaves passed through as None)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _fused_qkv_rows(rows: int, cols: int, n: int, r: int) -> torch.Tensor:
    """Rank ``r``'s rows of a fused ``[q (cols) | k | v]`` projection of
    ``rows`` outputs: its block of each of the three segments."""
    kv = (rows - cols) // 2
    out = []
    for start, size in ((0, cols), (cols, kv), (cols + kv, kv)):
        if size % n:
            raise ValueError(f"the fused qkv segment of {size} rows does "
                             f"not divide over {n} ranks")
        per = size // n
        out.append(torch.arange(start + r * per, start + (r + 1) * per))
    return torch.cat(out)


def _is_qkv(path: str) -> bool:
    return re.search(r"attn/qkv/~(params|buffers)/", path) is not None


def _slice_leaf(x: torch.Tensor, sharding: NamedSharding, path: str,
                qkv_cols: Optional[int] = None) -> torch.Tensor:
    """This rank's block of the full leaf ``x`` (a contiguous copy); the
    fused qkv rows go by head (``qkv_cols``: the projection's input
    width, which is the q segment's length)."""
    idx = list(sharding.index(tuple(x.shape)))
    if _is_qkv(path) and qkv_cols is not None and x.dim() >= 1 \
            and sharding.num_blocks(0) > 1:
        n = sharding.num_blocks(0)
        r = idx[0].start // (x.shape[0] // n)
        rows = _fused_qkv_rows(x.shape[0], qkv_cols, n, r).to(x.device)
        x = x.index_select(0, rows)
        idx[0] = slice(None)
    return x[tuple(idx)].contiguous().clone()


def shard_params(params, mesh, rules, default=P()):
    """This rank's slices of a full params tree (a new tree of contiguous
    tensors), each leaf cut by its rule's ``NamedSharding``; the fused
    ``attn/qkv`` rows go by head (see the module notes), the q segment's
    length read from the weight's input width."""
    specs = spec_for_params(params, rules, default)

    def walk(p, s, prefix, cols=None):
        if isinstance(p, dict):
            w = p.get("weight")
            c = int(np.shape(w)[1]) if np.ndim(w) == 2 else None
            return {k: walk(v, s[k], f"{prefix}/{k}", c)
                    for k, v in p.items()}
        t = p if torch.is_tensor(p) else torch.as_tensor(np.asarray(p))
        return _slice_leaf(t, NamedSharding(mesh, s), prefix, cols)

    return walk(params, specs, "")


def replicate(tree, mesh=None):
    """Every leaf copied whole onto this rank (``jax.device_put`` with a
    replicated ``NamedSharding``): copies, so a later in-place write
    never reaches the caller's tensors."""
    return _tree_map(lambda x: x.detach().clone() if torch.is_tensor(x)
                     else torch.as_tensor(np.array(x)), tree)


def _group_of(sharding: NamedSharding):
    return sharding.mesh.group(sharding.axes) if sharding.axes else None


def _member_coords(sharding: NamedSharding, i: int) -> dict:
    """Mesh coordinates (over the spec's axes) of member ``i`` of the
    spec's group: members are ordered row-major over those axes."""
    axes = sharding.axes
    coords = {}
    for a in reversed(axes):
        s = sharding.mesh.shape[a]
        coords[a] = i % s
        i //= s
    return coords


def _assemble(blocks: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full tensor from the (members, *local) blocks of a group."""
    local = tuple(blocks.shape[1:])
    shape = tuple(s * sharding.num_blocks(d) for d, s in enumerate(local))
    out = blocks.new_empty(shape)
    for i in range(blocks.shape[0]):
        c = _member_coords(sharding, i)
        idx = tuple(slice(sharding.block_of(d, c) * s,
                          (sharding.block_of(d, c) + 1) * s)
                    for d, s in enumerate(local))
        out[idx] = blocks[i]
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy().copy()


def fetch_to_host(tree, sharding: Optional[NamedSharding] = None,
                  dst: Optional[int] = None, as_numpy: bool = True):
    """One bulk device-to-host move of a tree of this rank's tensors.
    Sharded leaves (``sharding`` not fully replicated) gather every
    rank's block over the sharding's axes and reassemble ONE contiguous
    host array, so the host copy has no layout and can later be
    ``put_from_host`` under any sharding. ``dst`` (a rank of that group)
    gathers onto that rank alone, the others get None; by default every
    rank gets the array. Collective over the sharding's group. Leaves
    come back as numpy arrays (bf16 as f32: numpy has no bf16), or with
    ``as_numpy=False`` as CPU tensors in their own dtype."""
    conv = _to_numpy if as_numpy else (lambda t: t.detach().cpu().clone())
    if sharding is None or sharding.is_fully_replicated \
            or not dist.is_initialized():
        return _tree_map(conv, tree)
    g = _group_of(sharding)
    n, me = C.group_size(g), C.group_rank(g)

    def one(t):
        src = C._wire(g, t)
        if dst is None:
            out = C.all_gather(src.reshape(-1), g)
            return conv(_assemble(out.cpu().reshape(
                (n,) + tuple(src.shape)), sharding))
        bufs = ([torch.empty_like(src) for _ in range(n)] if me == dst
                else None)
        dist.gather(src, bufs, dst=dist.get_global_rank(g, dst), group=g)
        C.calls["gather"] += 1
        if me != dst:
            return None
        return conv(_assemble(torch.stack(bufs).cpu(), sharding))

    return _tree_map(one, tree)


def put_from_host(tree, sharding: Optional[NamedSharding] = None, *,
                  src: Optional[int] = None, like=None, device=None):
    """The reverse move: each rank receives ONLY its block of every full
    host array of ``tree`` (numpy arrays or CPU tensors), as a tensor on
    ``device`` (default: the CPU) in the leaf's dtype. Without ``src``
    every rank holds the full tree and cuts its own block (no message);
    with ``src`` (a rank of the sharding's group) that rank alone holds
    it (the others pass ``tree=None`` and ``like``, a tree of tensors of
    their local shapes and dtypes) and scatters the blocks. Collective
    over the sharding's group when ``src`` is given."""
    dev = torch.device(device) if device is not None else torch.device(
        "cpu")
    repl = sharding is None or sharding.is_fully_replicated

    def as_tensor(x):
        return torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) \
            else x

    if src is None or not dist.is_initialized() or repl:
        if src is not None and dist.is_initialized() and sharding is not None:
            raise ValueError("put_from_host(src=) needs a sharded layout "
                             "(a replicated tree is held by every rank)")

        def cut(x):
            x = as_tensor(x)
            if not repl:
                x = x[sharding.index(tuple(x.shape))]
            return x.to(dev).contiguous()

        return _tree_map(cut, tree)
    g = _group_of(sharding)
    n, me = C.group_size(g), C.group_rank(g)

    def blocks(x):
        x = as_tensor(x)
        local = sharding.shard_shape(tuple(x.shape))
        out = [None] * n
        for i in range(n):
            c = _member_coords(sharding, i)
            idx = tuple(slice(sharding.block_of(d, c) * s,
                              (sharding.block_of(d, c) + 1) * s)
                        for d, s in enumerate(local))
            out[i] = x[idx].contiguous()
        return out

    def one(x, ref):
        shape = ref.shape
        dtype = ref.dtype
        wire_dev = (torch.device("cpu") if C.transport(g, ref) != "nccl"
                    else ref.device)
        out = torch.empty(shape, dtype=dtype, device=wire_dev)
        parts = ([b.to(device=wire_dev, dtype=dtype) for b in blocks(x)]
                 if me == src else None)
        dist.scatter(out, parts, src=dist.get_global_rank(g, src), group=g)
        C.calls["scatter"] += 1
        return out.to(dev)

    if me == src:
        ref = like if like is not None else _tree_map(
            lambda x: torch.empty(sharding.shard_shape(
                tuple(as_tensor(x).shape)), dtype=as_tensor(x).dtype),
            tree)
        return _tree_map(one, tree, ref)
    if like is None:
        raise ValueError("put_from_host: a rank that does not hold the "
                         "tree passes like= (its local shapes)")
    return _tree_map(lambda ref: one(None, ref), like)


# ------------------------------------------------------ the sharded LM
class TensorParallel:
    """What a sharded model knows of its mesh: the model axis, its
    process group, the shard count and this rank's index, and the slice
    of the vocabulary its token table (and head) hold."""

    def __init__(self, mesh, model_axis: str, vocab_size: int,
                 vocab_sharded: bool, head_sharded: bool,
                 gathers: Optional[dict] = None):
        self.mesh = mesh
        self.model_axis = model_axis
        self.group = mesh.group(model_axis)
        self.shards = int(mesh.shape[model_axis])
        self.index = mesh.index(model_axis)
        self.vocab_size = vocab_size
        self.vocab_sharded = vocab_sharded
        self.head_sharded = head_sharded
        per = vocab_size // self.shards
        self.vocab_start = self.index * per if vocab_sharded else 0
        self.vocab_local = per if vocab_sharded else vocab_size
        #: the model's tables split over a data axis too: name -> gather
        self.gathers = {k: g for k, g in (gathers or {}).items()
                        if g is not None}

    def table(self, model, name: str) -> torch.Tensor:
        """``model.<name>`` (the token or position table) as this rank's
        model-axis shard: gathered over the data axis where it is split
        there."""
        t = getattr(model, name)
        g = self.gathers.get(name)
        return g(t) if g is not None else t

    def embed(self, ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """``F.embedding(ids, full_table)`` from this rank's vocabulary
        slice: a masked lookup, then an all-reduce (the other ranks add
        exact zeros)."""
        if not self.vocab_sharded:
            return F.embedding(ids, table)
        local = ids - self.vocab_start
        mine = (local >= 0) & (local < self.vocab_local)
        e = F.embedding(local.clamp(0, self.vocab_local - 1), table)
        e = torch.where(mine[..., None], e, torch.zeros((), dtype=e.dtype,
                                                        device=e.device))
        return C.all_reduce(e, self.group)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's (..., V/n) logits all-gathered into vocabulary
        order (..., V)."""
        n = self.shards
        flat = C.all_gather(logits.contiguous().reshape(-1), self.group)
        blocks = flat.reshape((n,) + tuple(logits.shape))
        return blocks.movedim(0, -2).reshape(*logits.shape[:-1],
                                             n * logits.shape[-1])


def _row_parallel_float(self, input):
    """A row-parallel float Linear: the local partial product in f32,
    summed over the model axis, then the bias once, then the input's
    dtype."""
    y = F.linear(input.float(), _weight(self).float())
    y = C.all_reduce(y, self.tp_group)
    if self.with_bias:
        y = y + self.bias.float()
    return y.to(input.dtype)


def _row_parallel_int8(self, input):
    """A row-parallel int8 Linear: the input quantized with ONE scale
    over the whole (sharded) input, an all-reduce max of the local
    ``amax``; the int32 partial products (zero point off) summed over
    the model axis; then the epilogue of ``nn/quantized.Linear``."""
    from bigdl_tpu_torch.nn.quantized import int8_matmul, quantize_activation

    squeeze = input.dim() == 1
    x = input[None] if squeeze else input
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    amax = x2.abs().amax()
    amax = C.all_reduce(amax.float(), self.tp_group, "max").to(amax.dtype)
    x_q, x_scale = quantize_activation(x2, amax=amax)
    acc = int8_matmul(x_q, self.weight_q)
    if self.has_zp:
        row = x_q.sum(1, keepdim=True, dtype=torch.int32)
        acc = acc - row * self.w_zp[:, 0][None, :]
    acc = C.all_reduce(acc, self.tp_group)
    out = acc.float() * (x_scale * self.w_scale[:, 0])[None, :]
    if self.has_bias:
        out = out + self.bias
    out = out.to(input.dtype).reshape(*lead, -1)
    return out[0] if squeeze else out


_CLASSES: dict = {}


def _parallel_class(base, kind: str):
    """A subclass of ``base`` (a float or int8 Linear) whose forward is
    the row-parallel one (``kind="row"``) or a column layer's whose weight
    is gathered over a data axis (``"gathered"``); the instance keeps its
    parameter names."""
    from bigdl_tpu_torch.nn import quantized as qnn

    cls = _CLASSES.get((base, kind))
    if cls is None:
        if kind == "row":
            fwd = _row_parallel_int8 if issubclass(base, qnn.Linear) \
                else _row_parallel_float
            name = f"RowParallel{base.__name__}"
        else:
            fwd, name = _column_gathered, f"DataGathered{base.__name__}"
        cls = type(name, (base,), {"forward": fwd, "__module__": __name__})
        _CLASSES[(base, kind)] = cls
    return cls


def _set(mod, name: str, value: torch.Tensor) -> None:
    """Replace parameter or buffer ``name`` of ``mod`` by ``value``."""
    if name in mod._parameters:
        old = mod._parameters[name]
        mod._parameters[name] = torch.nn.Parameter(
            value, requires_grad=old.requires_grad)
    else:
        mod._buffers[name] = value


def _linear_leaves(mod) -> List[str]:
    """The tensors of a Linear (float or int8) with an output dim 0."""
    names = [k for k in ("weight", "weight_q", "w_scale", "w_zp", "bias")
             if (k in mod._parameters and mod._parameters[k] is not None)
             or (k in mod._buffers and mod._buffers[k] is not None)]
    return names


class _GatherData:
    """A leaf split over a data axis as well (the 2-D ``data x model``
    rules): called on this rank's block, it all-gathers the data axis's
    blocks along ``dim`` into the rank's model-axis shard. A collective:
    only compute paths call it, on every rank alike."""

    def __init__(self, group, dim: int):
        self.group, self.dim = group, dim

    def __call__(self, block):
        n = C.group_size(self.group)
        flat = C.all_gather(block.contiguous().reshape(-1), self.group)
        parts = flat.reshape((n,) + tuple(block.shape)).movedim(0, self.dim)
        shape = list(block.shape)
        shape[self.dim] *= n
        return parts.reshape(shape)


def _data_gather(spec, data_axis, mesh) -> Optional[_GatherData]:
    """The gather of the one dimension ``spec`` splits over
    ``data_axis`` (None when it splits none)."""
    dims = [d for d, e in enumerate(spec) if data_axis in _axes(e)]
    if not dims or mesh.shape[data_axis] == 1:
        return None
    return _GatherData(mesh.group(data_axis), dims[0])


def _weight(mod):
    """A Linear's weight as its math uses it: gathered over the data axis
    when it is split there."""
    g = mod.__dict__.get("tp_data")
    return g(mod.weight) if g is not None else mod.weight


def _column_gathered(self, input):
    return F.linear(input, _weight(self),
                    self.bias if self.with_bias else None)


def shard_model(model, mesh, rules=None, model_axis: str = "model"):
    """This rank's shard of a ``TransformerLM`` (or its int8 clone) on a
    ``model_axis`` mesh: a copy of ``model`` whose layers hold this
    rank's slices by ``rules`` (default ``transformer_tp_rules(
    model_axis)``) and issue the model axis's collectives (see the
    module notes). Every rank of the mesh calls it with the same full
    model; the result serves every entry point of the model (the flash
    scoring forward, ``generate``, the KV-cache and paged forms, int8
    KV), each rank on H/n query heads and H_kv/n KV heads. Rules with a
    data axis (``transformer_tp_rules(model_axis, data_axis)``, a float
    model) also split each weight over that axis, zero-style: a rank
    keeps its block and every use all-gathers the data axis's blocks
    before the tensor-parallel math. Raises ``ValueError`` when the
    heads, the KV heads, the vocabulary or the MLP width do not divide
    over the axis."""
    from bigdl_tpu_torch.nn import linear as bt_linear
    from bigdl_tpu_torch.nn import quantized as qnn

    seq_axis = getattr(model, "sequence_parallel", None)
    if isinstance(seq_axis, str) and seq_axis not in mesh.shape:
        raise ValueError(
            f"a sequence_parallel={seq_axis!r} model on a mesh without a "
            f"{seq_axis!r} "
            "axis: the JAX package runs such a model only inside "
            "shard_map over that axis (outside it the sequence offset is "
            "an unbound axis_index); give the mesh the axis too")
    if getattr(model, "_tp", None) is not None:
        raise ValueError("the model is already sharded")
    rules = rules if rules is not None else transformer_tp_rules(model_axis)
    others = sorted({a for _, spec in rules for e in spec for a in _axes(e)
                     if a != model_axis})
    if len(others) > 1:
        raise ValueError(f"rules shard over {others} beside "
                         f"{model_axis!r}: one data axis at most")
    data_axis = others[0] if others else None
    if data_axis is not None and data_axis not in mesh.shape:
        raise ValueError(f"rules shard over {data_axis!r}, not in "
                         f"mesh axes {list(mesh.axis_names)}")
    attn0 = model.blocks()[0].attn
    kv_pool_sharding(mesh, attn0.num_kv_heads, model_axis)
    n = int(mesh.shape[model_axis])
    group = mesh.group(model_axis)
    if attn0.num_heads % n:
        raise ValueError(f"num_heads ({attn0.num_heads}) must divide "
                         f"evenly over the {n}-way {model_axis!r} axis")
    compiled = _compile(rules)
    sharding_of = {}

    def spec(path: str):
        return P(*_match(compiled, path, P()))

    def pad(sp, ndim):
        return P(*(tuple(sp) + (None,) * (ndim - len(sp))))

    local = copy.deepcopy(model)
    mods = dict(local.named_modules())
    with torch.no_grad():
        for name, mod in mods.items():
            if not isinstance(mod, (bt_linear.Linear, qnn.Linear)):
                continue
            prefix = "/" + name.replace(".", "/") + "/~params/"
            s = pad(spec(prefix + "weight"), 2)
            w = "weight" if isinstance(mod, bt_linear.Linear) \
                else "weight_q"
            if w == "weight_q" and data_axis is not None:
                # int8 codes and scales: the model split alone
                s = P(*(None if data_axis in _axes(e) else e for e in s))
            cols = getattr(mod, w).shape[1]
            if s[0] == model_axis:                              # column
                _set(mod, w, _slice_leaf(getattr(mod, w),
                                         NamedSharding(mesh, s),
                                         prefix + w, cols))
                out_sh = NamedSharding(mesh, P(model_axis))
                for leaf in _linear_leaves(mod):
                    if leaf != w:     # bias, and the int8 scale / zero point
                        _set(mod, leaf, _slice_leaf(
                            getattr(mod, leaf), out_sh, prefix + leaf, cols))
                if isinstance(mod, bt_linear.Linear):
                    mod.output_size = mod.weight.shape[0]
                sharding_of[name] = "column"
            elif s[1] == model_axis:                            # row
                _set(mod, w, _slice_leaf(getattr(mod, w),
                                         NamedSharding(mesh, s),
                                         prefix + w))
                if isinstance(mod, bt_linear.Linear):
                    mod.input_size = mod.weight.shape[1]
                mod.__class__ = _parallel_class(type(mod), "row")
                mod.tp_group = group
                sharding_of[name] = "row"
            elif any(e is not None for e in s):
                raise ValueError(f"{prefix}weight: spec {s} is neither "
                                 f"column nor row parallel over "
                                 f"{model_axis!r}")
            gather = (_data_gather(s, data_axis, mesh)
                      if data_axis is not None else None)
            if gather is not None:
                mod.tp_data = gather
                if sharding_of.get(name) != "row":
                    mod.__class__ = _parallel_class(type(mod), "gathered")
        for i, blk in enumerate(local.blocks()):
            pre = f"block{i}"
            attn = blk.attn
            if sharding_of.get(f"{pre}.attn.qkv") == "column":
                if sharding_of.get(f"{pre}.attn.out_proj") != "row":
                    raise ValueError(f"{pre}: a column-parallel qkv needs "
                                     "a row-parallel out_proj")
                attn.num_heads //= n
                attn.num_kv_heads //= n
                attn.q_dim = attn.num_heads * attn.head_dim
            elif sharding_of.get(f"{pre}.attn.out_proj") == "row":
                raise ValueError(f"{pre}: a row-parallel out_proj needs a "
                                 "column-parallel qkv")
            if (sharding_of.get(f"{pre}.fc1") == "column") != (
                    sharding_of.get(f"{pre}.fc2") == "row"):
                raise ValueError(f"{pre}: fc1 column-parallel and fc2 "
                                 "row-parallel go together")
        gathers = {}
        te = pad(spec("/~params/tok_embed"), 2)
        vocab_sharded = te[0] == model_axis
        if vocab_sharded and local.vocab_size % n:
            raise ValueError(f"vocab_size ({local.vocab_size}) must "
                             f"divide evenly over the {n}-way "
                             f"{model_axis!r} axis")
        if te[1] not in (None, data_axis):
            raise ValueError(f"tok_embed: spec {te} splits the embedding "
                             "over the model axis")
        for leaf, sp in (("tok_embed", te),
                         ("pos_embed", pad(spec("/~params/pos_embed"), 2))):
            if leaf not in local._parameters:
                continue
            if any(e is not None and model_axis in _axes(e)
                   for e in sp) and leaf == "pos_embed":
                raise ValueError(f"pos_embed: spec {sp} splits the "
                                 "position table over the model axis")
            _set(local, leaf, _slice_leaf(getattr(local, leaf),
                                          NamedSharding(mesh, sp),
                                          "/~params/" + leaf))
            if data_axis is not None:
                gathers[leaf] = _data_gather(sp, data_axis, mesh)
        head_sharded = (vocab_sharded if local.tie_embeddings
                        else sharding_of.get("head") == "column")
    local._tp = TensorParallel(mesh, model_axis, model.vocab_size,
                               vocab_sharded, head_sharded, gathers)
    if isinstance(seq_axis, str):   # the ring runs over this mesh's axis
        local.sequence_parallel = mesh.group(seq_axis)
        for blk in local.blocks():
            blk.attn.sequence_parallel = local.sequence_parallel
    return local
