"""The sparse stack (port of ``bigdl_tpu/nn/sparse.py``): ``SparseTensor``,
``SparseLinear``, ``LookupTableSparse``, ``SparseJoinTable``,
``DenseToSparse`` and ``SparseMiniBatch``.

A :class:`SparseTensor` keeps the JAX package's batched-COO layout as
plain tensors: ``indices`` (nse, ndim) int64, ``values`` (nse,) and a
``shape``. It is not a ``torch.sparse_coo_tensor`` and is never
coalesced: the JAX layout pads with entries that lie out of bounds
(``from_dense`` pads with index == shape, value 0), which torch's sparse
tensors reject, and coalescing would merge duplicate entries and change
``nse`` and the order of the entries. Every consumer here reads the
layout as JAX does: duplicates add up (``to_dense``, ``SparseLinear``;
``LookupTableSparse`` takes the largest duplicate id and adds duplicate
per-id weights) and out-of-bounds entries are dropped, masked to zero
and never indexed.

A ``SparseTensor`` is an activity like a tensor: its values are the
leaf (``nn/module.py::activity_tensors``) and its indices ride along,
so the eager ``backward`` of a sparse input returns a ``SparseTensor``
of value gradients at the input's indices, as JAX's pytree gives.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn import init as bt_init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.table import Table


def _tensor(x) -> torch.Tensor:
    """``x`` as a tensor; host data (lists, numpy) in the JAX package's
    default widths: float64 becomes float32."""
    if torch.is_tensor(x):
        return x
    t = torch.as_tensor(np.asarray(x))
    return t.float() if t.dtype == torch.float64 else t


class SparseTensor:
    """COO tensor (``tensor/SparseTensor.scala``; the JAX package's BCOO
    facade): 0-based ``indices`` (nse, ndim), ``values`` (nse,) and
    ``shape``. ``coo`` and ``from_dense`` build one; ``to_dense`` sums
    duplicates and drops entries out of bounds; ``to(device)`` moves it."""

    __slots__ = ("indices", "values", "shape")

    def __init__(self, indices: torch.Tensor, values: torch.Tensor, shape):
        self.indices = indices
        self.values = values
        self.shape = tuple(int(s) for s in shape)

    # --------------------------------------------------------- constructors
    @staticmethod
    def coo(indices, values, shape, device=None) -> "SparseTensor":
        """``Tensor.sparse(Array(rowIdx, colIdx), values, shape)``:
        ``indices`` is (ndim, nse) or (nse, ndim); when both readings fit
        (nse == ndim) the documented (ndim, nse) orientation wins. The
        tensors go to ``device``, by default the values' device when they
        are a tensor, else the host (a record's data, as ``torch.tensor``
        places it)."""
        idx = _tensor(indices)
        if idx.dim() != 2:
            raise ValueError("indices must be 2-D")
        if idx.shape[0] == len(shape):
            idx = idx.t()
        elif idx.shape[1] != len(shape):
            raise ValueError(
                f"indices {tuple(idx.shape)} fit neither (ndim, nse) nor "
                f"(nse, ndim) for shape {tuple(shape)}")
        vals = _tensor(values)
        dev = torch.device(device) if device is not None else vals.device
        return SparseTensor(idx.to(device=dev, dtype=torch.int64).contiguous(),
                            vals.to(dev), shape)

    @staticmethod
    def from_dense(dense: torch.Tensor,
                   nse: Optional[int] = None) -> "SparseTensor":
        """The nonzeros of ``dense`` in row-major order, on its device.
        ``nse`` entries: more than the nonzeros pads with index == shape
        and value 0, fewer keeps the first ``nse`` (``BCOO.fromdense``).
        Without ``nse`` the nonzeros are counted on the host: one device
        sync. The values are a gather of ``dense``, so their gradient
        flows back to it."""
        dense = _tensor(dense)
        flat = dense.reshape(-1)
        n = flat.numel()
        nz = flat != 0
        if nse is None:
            nse = int(nz.sum())
        pos = torch.where(nz, torch.arange(n, device=flat.device),
                          torch.full((), n, device=flat.device))
        pos = torch.sort(pos).values[:nse]
        if nse > n:
            pos = torch.cat([pos, pos.new_full((nse - n,), n)])
        valid = pos < n
        safe = torch.where(valid, pos, torch.zeros_like(pos))
        shape = tuple(dense.shape)
        idx = torch.stack(
            [torch.where(valid, (safe // math.prod(shape[d + 1:])) % n, n)
             for d, n in enumerate(shape)], dim=1) if shape else \
            safe.new_zeros((nse, 0))
        vals = flat.gather(0, safe) * valid.to(flat.dtype)
        return SparseTensor(idx, vals, shape)

    # -------------------------------------------------------------- views
    @property
    def nse(self) -> int:
        return int(self.indices.shape[0])

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def in_bounds(self) -> torch.Tensor:
        """(nse,) bool: the entries inside ``shape``."""
        ok = (self.indices >= 0).all(dim=1)
        for d, n in enumerate(self.shape):
            ok = ok & (self.indices[:, d] < n)
        return ok

    def flat_index(self, dims: Optional[int] = None) -> torch.Tensor:
        """The row-major offset of each entry over its first ``dims``
        indices (all by default); 0 where the entry is out of bounds."""
        dims = self.ndim if dims is None else dims
        off = torch.zeros(self.nse, dtype=torch.int64,
                          device=self.indices.device)
        for d in range(dims):
            off = off * self.shape[d] + self.indices[:, d]
        return torch.where(self.in_bounds(), off, torch.zeros_like(off))

    def to_dense(self) -> torch.Tensor:
        """The dense tensor: duplicate entries add up, entries out of
        bounds are dropped (differentiable in the values)."""
        keep = self.in_bounds().to(self.values.dtype)
        out = torch.zeros(math.prod(self.shape), dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add(0, self.flat_index(),
                             self.values * keep).reshape(self.shape)

    def to(self, device, non_blocking: bool = False) -> "SparseTensor":
        return SparseTensor(self.indices.to(device, non_blocking=non_blocking),
                            self.values.to(device, non_blocking=non_blocking),
                            self.shape)

    def __repr__(self):
        return f"SparseTensor(shape={self.shape}, nse={self.nse})"


def _as_sparse(x) -> SparseTensor:
    return x if isinstance(x, SparseTensor) else SparseTensor.from_dense(x)


class SparseLinear(Module):
    """``y = x W^T + b`` over a sparse (..., input_size) activation
    (``nn/SparseLinear.scala:44``): a gather of W's columns at each
    entry's last index, times the value, summed into rows by
    ``index_add``; entries out of bounds add zero. No dense copy of x.

    ``backward_start`` / ``backward_length`` (1-based, as the reference)
    make ``backward`` return the dense column slice ``g @ W[:, s:s+len]``
    of gradInput, the only part of a wide input with a differentiable
    producer (the Wide & Deep input tail); the parameter gradients still
    accumulate."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, backward_start: int = -1,
                 backward_length: int = -1, w_regularizer=None,
                 b_regularizer=None, init_weight=None, init_bias=None, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self._rng = rng or RandomGenerator()
        self.input_size, self.output_size = input_size, output_size
        self.with_bias = with_bias
        self.backward_start = backward_start
        self.backward_length = backward_length
        shape = (output_size, input_size)
        w = (bt_init.given(init_weight, shape, "init_weight")
             if init_weight is not None else self._draw())
        self.new_param("weight", w, dev, dtype, w_regularizer)
        if with_bias:
            b = (bt_init.given(init_bias, (output_size,), "init_bias")
                 if init_bias is not None else torch.zeros(output_size))
            self.new_param("bias", b, dev, dtype, b_regularizer)

    def _draw(self) -> torch.Tensor:
        return bt_init.Xavier()((self.output_size, self.input_size),
                                self._rng, fan_in=self.input_size,
                                fan_out=self.output_size)

    def reset(self) -> None:
        with torch.no_grad():
            self.weight.copy_(self._draw())
            if self.with_bias:
                self.bias.zero_()

    def forward(self, input):
        x = _as_sparse(input)
        keep = x.in_bounds()
        col = torch.where(keep, x.indices[:, -1],
                          torch.zeros_like(x.indices[:, -1]))
        vals = x.values.to(self.weight.dtype) * keep.to(self.weight.dtype)
        contrib = self.weight.t().index_select(0, col) * vals[:, None]
        lead = x.shape[:-1]
        out = torch.zeros(math.prod(lead), self.output_size,
                          dtype=contrib.dtype, device=contrib.device)
        out = out.index_add(0, x.flat_index(x.ndim - 1), contrib)
        out = out.reshape(*lead, self.output_size)
        return out + self.bias if self.with_bias else out

    def backward(self, input, grad_output):
        if self.backward_start > 0 and self.backward_length > 0:
            super().backward(input, grad_output)
            s = self.backward_start - 1
            gi = grad_output @ self.weight[:, s:s + self.backward_length] \
                .detach()
            self.grad_input = gi
            return gi
        return super().backward(input, grad_output)

    def extra_repr(self) -> str:
        return f"{self.input_size} -> {self.output_size}"


class LookupTableSparse(Module):
    """Embedding bag over sparse id lists (``nn/LookupTableSparse.scala:
    49``). Input: ids, or ``Table(ids, weights)``. Sparse ids (a
    :class:`SparseTensor` of shape (batch, max_ids)) are 1-based with 0
    inactive; duplicate entries at one position keep the largest id, and
    duplicate sparse per-id weights add up. Dense ids are 0-based with
    ``pad_id`` marking empties. ``max_norm`` clips each looked-up row to
    that L2 norm, out of place (the weight is not written). ``combiner``
    is ``sum``, ``mean`` or ``sqrtn``, with the JAX package's 1e-12
    floors."""

    def __init__(self, n_index: int, n_output: int, combiner: str = "sum",
                 max_norm: float = -1.0, w_regularizer=None,
                 pad_id: int = -1, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"bad combiner {combiner!r}")
        dev = resolve_device(device)
        self._rng = rng or RandomGenerator()
        self.n_index, self.n_output = n_index, n_output
        self.combiner = combiner
        self.max_norm = max_norm
        self.pad_id = pad_id
        self.new_param("weight", self._draw(), dev, dtype, w_regularizer)

    def _draw(self) -> torch.Tensor:
        return bt_init.RandomNormal(0.0, 1.0 / math.sqrt(self.n_output))(
            (self.n_index, self.n_output), self._rng)

    def reset(self) -> None:
        with torch.no_grad():
            self.weight.copy_(self._draw())

    def _ids_mask_weights(self, input):
        per_id_w = None
        ids = input
        if isinstance(input, Table):
            vals = list(input)
            ids = vals[0]
            if len(vals) > 1:
                per_id_w = vals[1]
        dev = self.weight.device
        if isinstance(ids, SparseTensor):
            ids = ids.to(dev)
            keep = ids.in_bounds()
            val = torch.where(keep, ids.values.to(torch.int64),
                              torch.zeros((), dtype=torch.int64, device=dev))
            dense = torch.zeros(math.prod(ids.shape), dtype=torch.int64,
                                device=dev).scatter_reduce(
                0, ids.flat_index(), val, "amax").reshape(ids.shape)
            if isinstance(per_id_w, SparseTensor):
                per_id_w = per_id_w.to(dev).to_dense()
            return (dense - 1).clamp_min(0), dense > 0, per_id_w
        ids = torch.as_tensor(ids, device=dev)
        mask = ids != self.pad_id
        safe = torch.where(mask, ids, torch.zeros_like(ids)).to(torch.int64)
        return safe, mask, per_id_w

    def forward(self, input):
        ids, mask, per_id_w = self._ids_mask_weights(input)
        emb = F.embedding(ids, self.weight)
        if self.max_norm > 0:
            norms = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            limit = torch.full_like(norms, self.max_norm)
            emb = emb * torch.clamp(limit / (norms + 1e-12), max=1.0)
        w = mask.to(emb.dtype)
        if per_id_w is not None:
            w = w * torch.as_tensor(per_id_w, device=emb.device).to(emb.dtype)
        summed = torch.einsum("bl,bld->bd", w, emb)
        if self.combiner == "sum":
            return summed
        if self.combiner == "mean":
            return summed / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
        return summed / torch.sqrt(torch.clamp(
            (w * w).sum(dim=1, keepdim=True), min=1e-12))

    def extra_repr(self) -> str:
        return (f"nIndex={self.n_index}, nOutput={self.n_output}, "
                f"combiner={self.combiner}")


class SparseJoinTable(Module):
    """Concatenate sparse activations along ``dimension`` (1-based,
    ``nn/SparseJoinTable.scala``), as ``bcoo_concatenate`` does: every
    entry of a later part, padding included, moves along the dimension
    by the sizes of the parts before it."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input):
        mats = [_as_sparse(x) for x in input]
        d = self.dimension - 1
        idx, offset = [], 0
        for m in mats:
            moved = m.indices.clone()
            moved[:, d] += offset
            idx.append(moved)
            offset += m.shape[d]
        shape = list(mats[0].shape)
        shape[d] = offset
        return SparseTensor(torch.cat(idx), torch.cat([m.values
                                                       for m in mats]),
                            shape)


class DenseToSparse(Module):
    """A dense activation as a :class:`SparseTensor` (``nn/
    DenseToSparse.scala``), on the input's device. ``nse`` fixes the
    stored entries (padding or truncating as ``SparseTensor.from_dense``);
    without it the nonzeros are counted on the host, one device sync a
    call. Backward is the dense pass-through: gradInput is the value
    gradients scattered back to their positions."""

    def __init__(self, nse: Optional[int] = None):
        super().__init__()
        self.nse = nse

    def forward(self, input):
        return SparseTensor.from_dense(input, nse=self.nse)


class SparseMiniBatch:
    """A batch of Samples whose features mix sparse and dense arrays
    (``dataset/MiniBatch.scala:588``): each sparse feature batches into
    one :class:`SparseTensor` with a leading batch dimension, each row
    padded to the batch's largest ``nse`` with index 0 and value 0 (in
    bounds, unlike ``from_dense``'s padding); dense features and labels
    stack as numpy arrays, staged on the device with the batch."""

    def __init__(self, features: List, labels=None):
        self.features = features
        self.labels = labels

    @staticmethod
    def _batch_sparse(rows: Sequence[SparseTensor]) -> SparseTensor:
        nse = max(r.nse for r in rows)
        idx, vals = [], []
        for r in rows:
            pad = nse - r.nse
            ri, rv = r.indices, r.values
            if pad:
                ri = torch.cat([ri, ri.new_zeros((pad, ri.shape[1]))])
                rv = torch.cat([rv, rv.new_zeros((pad,))])
            idx.append(ri)
            vals.append(rv)
        batch_idx = torch.arange(len(rows)).repeat_interleave(nse)[:, None]
        full = torch.cat([batch_idx.to(idx[0].device), torch.cat(idx)],
                         dim=1)
        return SparseTensor(full, torch.cat(vals),
                            (len(rows),) + rows[0].shape)

    @classmethod
    def from_samples(cls, samples) -> "SparseMiniBatch":
        feats = []
        for j in range(len(samples[0].features)):
            col = [s.features[j] for s in samples]
            feats.append(cls._batch_sparse(col)
                         if isinstance(col[0], SparseTensor)
                         else np.stack(col))
        labels = None
        if samples[0].labels:
            cols = [np.stack([s.labels[j] for s in samples])
                    for j in range(len(samples[0].labels))]
            labels = cols[0] if len(cols) == 1 else Table(*cols)
        return cls(feats, labels)

    def get_input(self):
        return self.features[0] if len(self.features) == 1 \
            else Table(*self.features)

    def get_target(self):
        return self.labels

    def size(self) -> int:
        return int(self.features[0].shape[0])
