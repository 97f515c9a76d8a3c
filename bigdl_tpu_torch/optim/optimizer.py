"""The train step (port of ``TrainStep`` / ``make_train_step`` in
``bigdl_tpu/optim/optimizer.py``).

``step(params, buffers, slots, x, y, lrs, rng) -> (loss, new_params,
new_buffers, new_slots)`` keeps the JAX package's functional signature:
``params`` and ``buffers`` are trees shaped like the model's
``params_dict()`` / ``buffers_dict()``, ``slots`` one entry per optimizer
group, ``lrs`` one scheduled rate per group (``current_lrs()``), ``rng``
a ``torch.Generator`` on the model's device that every dropout layer
draws from during the step (``None``: PyTorch's default generator).
The step changes none of its inputs; the model's own parameters are left
as they were.

With ``compute_dtype`` (bf16) the f32 master parameters are cast once
per step, the forward and backward run in that dtype, and the grads come
back in f32 through the cast. The step binds the (cast) tensors into the
model in place of its parameters for the forward AND the backward: the
twin of the JAX package's ``pure_apply``, held across the backward
because a checkpointed block (``remat``) recomputes its forward there
(``torch.func.functional_call`` unbinds when the forward returns, so the
recompute would read the model's own parameters). A model is therefore
stepped by one thread at a time.

Also ported: constant and global-L2 gradient clipping (``grad_clip``),
frozen parameters left unchanged, per-submodule optimizer groups
(``sub_methods``, by module name), ``grad_accum`` micro-batches with the
mean or sum combine and the regularizer counted once, and
``step_with_stats``, which also returns the pre-clip global grad norm.
New parameters are stored at each leaf's dtype.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from bigdl_tpu_torch.nn.dropout import bind_generator
from bigdl_tpu_torch.nn.module import (PARAMS_KEY, Module, tree_leaves,
                                       tree_unflatten)
from bigdl_tpu_torch.optim.optim_method import OptimMethod


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def _clip_by_global_norm(grads, max_norm: float):
    scale = torch.clamp(max_norm / (_global_norm(grads) + 1e-12), max=1.0)
    return [(g * scale).to(g.dtype) for g in grads]


def _method_groups(model: Module, default_method: OptimMethod, sub_methods):
    """(methods, group id of each parameter leaf in :func:`tree_leaves`
    order): group 0 is ``default_method``, then one group per named
    sub-module of ``sub_methods`` ({module name: method}); a parameter
    belongs to its nearest named ancestor's group."""
    methods = [default_method]
    name_to_gid = {}
    for name, m in (sub_methods or {}).items():
        name_to_gid[name] = len(methods)
        methods.append(m)
    known = {m.get_name() for m in model.modules() if isinstance(m, Module)}
    unmatched = set(name_to_gid) - known
    if unmatched:
        raise ValueError(f"sub_methods names not found in model: "
                         f"{sorted(unmatched)}")

    def walk(module, gid):
        g = name_to_gid.get(module.get_name(), gid)
        d = {}
        own = [n for n, _ in module.named_parameters(recurse=False)]
        if own:
            d[PARAMS_KEY] = {n: g for n in own}
        for child_name, child in module.named_children():
            sub = walk(child, g)
            if sub:
                d[child_name] = sub
        return d

    return methods, [g for _, g in tree_leaves(walk(model, 0))]


@contextmanager
def _bound(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """``model`` with the parameters and buffers named in ``tensors``
    (dotted name -> tensor) replaced by those tensors until exit."""
    saved = []
    try:
        for name, value in tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner)
            table = (mod._parameters if leaf in mod._parameters
                     else mod._buffers)
            saved.append((table, leaf, table[leaf]))
            table[leaf] = value
        yield
    finally:
        for table, leaf, old in reversed(saved):
            table[leaf] = old


@contextmanager
def _training(model: torch.nn.Module):
    """``model`` in training mode until exit, then each module back in
    its own mode."""
    modes = [(m, m.training) for m in model.modules()]
    model.train()
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode


class TrainStep:
    """The functional train step and its grouped optimizer state (see the
    module docstring)."""

    def __init__(self, model: Module, criterion, optim_method: OptimMethod,
                 grad_clip: Optional[dict] = None, sub_methods=None,
                 compute_dtype=None, grad_accum: int = 1):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.model = model
        self.criterion = criterion
        self.grad_clip = grad_clip or {}
        self.compute_dtype = compute_dtype
        self.grad_accum = grad_accum
        self._names = [n for n, _ in tree_leaves(model.params_dict())]
        self._trainable = [t for _, t in tree_leaves(model.trainable_dict())]
        self.methods, gids = _method_groups(model, optim_method, sub_methods)
        self._idxs_per_group = [[i for i, g in enumerate(gids) if g == k]
                                for k in range(len(self.methods))]

    # ------------------------------------------------------------ grads
    def _cast(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.compute_dtype is None:
            return list(leaves)
        return [p.to(self.compute_dtype) if p.is_floating_point() else p
                for p in leaves]

    def _grad(self, loss, leaves):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, leaves)]

    def _reg(self, params, cparams):
        return self.model.regularization_loss(tree_unflatten(params,
                                                             cparams))

    def _value_and_grad(self, params, leaves, buffers, x, y, with_reg):
        """(loss, grads) of one batch: the leaves cast to the compute
        dtype and bound into the model for the forward and backward."""
        cparams = self._cast(leaves)
        tensors = dict(zip(self._names, cparams))
        tensors.update(tree_leaves(buffers))
        with _bound(self.model, tensors):
            loss = self.criterion.forward(self.model(x), y)
            if with_reg:
                loss = loss + self._reg(params, cparams)
            return loss.detach(), self._grad(loss, leaves)

    def _loss_and_grads(self, params, buffers, x, y, rng):
        """(loss, grads in the f32 master layout), over ``grad_accum``
        sequential micro-batches when it is above 1."""
        leaves = [p.detach().requires_grad_(True)
                  for _, p in tree_leaves(params)]
        bind_generator(self.model, rng)
        with torch.enable_grad(), _training(self.model):
            n = self.grad_accum
            if n == 1:
                return self._value_and_grad(params, leaves, buffers, x, y,
                                            with_reg=True)
            batch = x.shape[0]
            if batch % n:
                raise ValueError(f"batch size {batch} not divisible by "
                                 f"grad_accum {n}")
            xs = x.reshape(n, batch // n, *x.shape[1:])
            ys = y.reshape(n, batch // n, *y.shape[1:])
            l_sum = torch.zeros((), device=leaves[0].device)
            g_sum = None
            for i in range(n):
                loss, g = self._value_and_grad(params, leaves, buffers,
                                               xs[i], ys[i], with_reg=False)
                g_sum = g if g_sum is None else [a + b for a, b in
                                                 zip(g_sum, g)]
                l_sum = l_sum + loss
            # mean criteria average the micro results, sum criteria keep
            # the sum; the regularizer enters once either way
            if getattr(self.criterion, "size_average", True):
                g_sum = [g / n for g in g_sum]
                l_sum = l_sum / n
            reg = self._reg(params, self._cast(leaves))
            if torch.is_tensor(reg):
                g_sum = [a + b for a, b in zip(g_sum, self._grad(reg,
                                                                 leaves))]
                l_sum = l_sum + reg.detach()
            return l_sum, g_sum

    # ------------------------------------------------------------- step
    def _core(self, params, buffers, slots, x, y, lrs, rng,
              with_norm: bool):
        loss, grads = self._loss_and_grads(params, buffers, x, y, rng)
        with torch.no_grad():
            gnorm = _global_norm(grads) if with_norm else None
            if "constant" in self.grad_clip:
                lo, hi = self.grad_clip["constant"]
                grads = [g.clamp(lo, hi) for g in grads]
            if "l2norm" in self.grad_clip:
                grads = _clip_by_global_norm(grads, self.grad_clip["l2norm"])
            leaves = [p.detach() for _, p in tree_leaves(params)]
            new_leaves = list(leaves)
            new_slots = []
            for k, meth in enumerate(self.methods):
                idxs = self._idxs_per_group[k]
                if not idxs:
                    new_slots.append(slots[k])
                    continue
                p_sub, ns = meth.step([leaves[i] for i in idxs],
                                      [grads[i] for i in idxs], slots[k],
                                      lrs[k])
                for i, pv in zip(idxs, p_sub):
                    new_leaves[i] = pv.to(leaves[i].dtype)
                new_slots.append(ns)
            new_leaves = [new if t else old for new, old, t in
                          zip(new_leaves, leaves, self._trainable)]
        return (loss, gnorm, tree_unflatten(params, new_leaves), buffers,
                tuple(new_slots))

    def step(self, params, buffers, slots, x, y, lrs, rng):
        """(loss, new_params, new_buffers, new_slots)."""
        loss, _, new_params, new_buffers, new_slots = self._core(
            params, buffers, slots, x, y, lrs, rng, with_norm=False)
        return loss, new_params, new_buffers, new_slots

    def step_with_stats(self, params, buffers, slots, x, y, lrs, rng):
        """(loss, pre-clip global grad L2 norm, new_params, new_buffers,
        new_slots)."""
        return self._core(params, buffers, slots, x, y, lrs, rng,
                          with_norm=True)

    # ------------------------------------------------------------ state
    def init_slots(self, params):
        leaves = [p.detach() for _, p in tree_leaves(params)]
        return tuple(m.init_slots([leaves[i] for i in idxs])
                     for m, idxs in zip(self.methods, self._idxs_per_group))

    def current_lrs(self) -> torch.Tensor:
        """One scheduled rate per optimizer group, an f32 CPU tensor."""
        return torch.tensor([m.get_current_rate() for m in self.methods],
                            dtype=torch.float32)


def make_train_step(model: Module, criterion, optim_method: OptimMethod,
                    grad_clip: Optional[dict] = None, sub_methods=None,
                    compute_dtype=None, grad_accum: int = 1) -> TrainStep:
    return TrainStep(model, criterion, optim_method, grad_clip, sub_methods,
                     compute_dtype=compute_dtype, grad_accum=grad_accum)
