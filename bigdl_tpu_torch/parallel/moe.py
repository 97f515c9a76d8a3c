"""Mixture of experts with expert parallelism (port of
``bigdl_tpu/parallel/moe.py``).

GShard's dense dispatch: top-1 (Switch) or top-2 gating builds a
(tokens, experts, capacity) one-hot dispatch tensor and routing is
einsums. A token's position in an expert's buffer follows GShard's
sequential rule: choice j's positions start after every choice-(j-1)
assignment to that expert, and within a choice tokens queue in token
order; past the capacity ``ceil(k t / E * capacity_factor)`` a route is
dropped (its expert contribution is 0). ``torch.argmax`` returns the
first maximum, as ``jnp.argmax`` does, so ties go to the lower expert;
a second choice whose remaining gate underflowed to 0 (a saturated
router) is voided, not re-picked. The drop rate and each expert's share
of the routes are the routing stats (:func:`record_moe_metrics`).

:func:`moe_spmd` is the expert-parallel dispatch over ``group`` (a
process group or an axis name of ``Engine.default_mesh()``): each rank
holds T/n tokens and E/n experts (global expert i on rank i // (E/n)),
builds its buffers for every global expert, and
``collectives.all_to_all`` carries them to the experts' owners and the
results back; both exchanges carry the gradient. The capacity is
computed from the LOCAL token count, so a sharded run routes (and drops)
differently from one process, in JAX too: hold it against JAX at the
same sharding.

``MoEMLP(expert_parallel=axis)`` runs :func:`moe_spmd` with this rank's
slice of its (replicated) expert weights, so the other slices get no
gradient on this rank: the expert weights' gradients are summed over the
expert axis, where the JAX model shards the expert weights instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.nn.init import Xavier
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.parallel import collectives as C
from bigdl_tpu_torch.utils.random import RandomGenerator


def _topk_dispatch(gates, capacity: int, k: int = 1):
    """gates (T, E) -> (dispatch (T, E, C), combine (T, E, C), stats):
    the JAX package's GShard assignment (see the module docstring). For
    k > 1 the combine weights are the chosen gates normalized over the
    kept choices; for k == 1 the raw gate (Switch). stats:
    ``drop_rate`` (the share of (token, choice) routes dropped) and
    ``expert_fraction`` (E,) (each expert's share of the routes before
    drops)."""
    t, e = gates.shape
    remaining = gates
    counts = gates.new_zeros(e)
    disps, weights = [], []
    kept_total = gates.new_zeros(())
    expert_fraction = gates.new_zeros(e)
    for j in range(k):
        expert = remaining.argmax(1)                      # first maximum
        onehot = F.one_hot(expert, e).to(gates.dtype)     # (T, E)
        if j > 0:
            # a saturated router underflows every non-top gate to 0: void
            # such phantom routes (argmax would re-pick expert 0)
            valid = (remaining * onehot).sum(1) > 0
            onehot = onehot * valid[:, None].to(gates.dtype)
        pos = onehot.cumsum(0) - onehot + counts[None, :]
        pos = (pos * onehot).sum(1).to(torch.long)        # (T,)
        routed = onehot.sum(1) > 0
        keep = (pos < capacity) & routed
        # an index of ``capacity`` is one past the buffer: a zero row
        pos_oh = F.one_hot(torch.where(keep, pos, torch.full_like(
            pos, capacity)), capacity + 1)[:, :capacity].to(gates.dtype)
        disps.append(onehot[:, :, None] * pos_oh[:, None, :])
        weights.append((gates * onehot).sum(1) * keep.to(gates.dtype))
        counts = counts + onehot.sum(0)
        kept_total = kept_total + keep.to(gates.dtype).sum()
        expert_fraction = expert_fraction + onehot.mean(0) / k
        remaining = remaining * (1.0 - onehot)
    dispatch = sum(disps)
    if k == 1:
        combine = disps[0] * weights[0][:, None, None]
    else:
        denom = sum(weights) + 1e-9
        combine = sum(d * (w / denom)[:, None, None]
                      for d, w in zip(disps, weights))
    stats = {"drop_rate": 1.0 - kept_total / (t * k),
             "expert_fraction": expert_fraction}
    return dispatch, combine, stats


def _top1_dispatch(gates, capacity: int):
    """Top-1 (Switch) routing: (dispatch, combine)."""
    dispatch, combine, _ = _topk_dispatch(gates, capacity, 1)
    return dispatch, combine


def _expert_fwd(p: dict, inp):
    """inp (E, C, D) -> (E, C, D): every expert's tanh-GELU MLP (JAX's
    default ``jax.nn.gelu``) on its buffer."""
    h = torch.einsum("ecd,edh->ech", inp, p["w1"]) + p["b1"][:, None]
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h, p["w2"]) + p["b2"][:, None]


class MoEMLP(Module):
    """Top-k gated mixture of GELU expert MLPs (D -> H -> D each);
    ``n_top=1`` is Switch routing, ``n_top=2`` GShard's with normalized
    combine weights. Parameters as in JAX: ``gate_w`` (D, E), ``w1`` (E,
    D, H), ``b1`` (E, H), ``w2`` (E, H, D), ``b2`` (E, D), Xavier
    weights and zero biases drawn from ``rng``."""

    #: the Switch load-balancing loss of the last ``forward`` (add a small
    #: multiple of it to the objective); ``forward_with_stats`` returns it
    l_aux = 0.0
    #: routing stats of the last ``forward``: drop_rate and
    #: expert_fraction (E,)
    last_stats = None

    def __init__(self, embed_dim: int, hidden_dim: int, n_experts: int,
                 capacity_factor: float = 1.25,
                 expert_parallel: Optional[str] = None, n_top: int = 1, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        if n_top < 1 or n_top > n_experts:
            raise ValueError(f"n_top={n_top} must be in [1, {n_experts}]")
        dev = resolve_device(device)
        rng = rng or RandomGenerator()
        self.embed_dim, self.hidden_dim = embed_dim, hidden_dim
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.expert_parallel = expert_parallel
        self.n_top = n_top
        xav = Xavier()
        d, h, e = embed_dim, hidden_dim, n_experts
        self.new_param("gate_w", xav((d, e), rng, fan_in=d, fan_out=e),
                       dev, dtype)
        self.new_param("w1", torch.stack([xav((d, h), rng, fan_in=d,
                                              fan_out=h) for _ in range(e)]),
                       dev, dtype)
        self.new_param("b1", torch.zeros(e, h), dev, dtype)
        self.new_param("w2", torch.stack([xav((h, d), rng, fan_in=h,
                                              fan_out=d) for _ in range(e)]),
                       dev, dtype)
        self.new_param("b2", torch.zeros(e, d), dev, dtype)

    def expert_params(self) -> dict:
        """The expert weights (leading dim = expert) as a dict."""
        return {"w1": self.w1, "b1": self.b1, "w2": self.w2, "b2": self.b2}

    def _local_experts(self) -> dict:
        """This rank's E/n experts of the ``expert_parallel`` axis."""
        n = C.group_size(self.expert_parallel)
        r = C.group_rank(self.expert_parallel)
        if self.n_experts % n:
            raise ValueError(
                f"n_experts {self.n_experts} not divisible by the "
                f"{self.expert_parallel!r} axis size {n}")
        per = self.n_experts // n
        return {k: v[r * per:(r + 1) * per]
                for k, v in self.expert_params().items()}

    def _aux_loss(self, gates):
        me = gates.mean(0)                    # mean gate per expert
        assign = F.one_hot(gates.argmax(1), self.n_experts).to(gates.dtype)
        return self.n_experts * (me * assign.mean(0)).sum()

    def forward_with_stats(self, input):
        """(output, l_aux, stats) without touching ``l_aux`` /
        ``last_stats``: what a checkpointed block returns."""
        shp = input.shape
        x2 = input.reshape(-1, self.embed_dim)
        t = x2.shape[0]
        gates = torch.softmax((x2 @ self.gate_w.to(x2.dtype)).float(), -1)
        aux = self._aux_loss(gates)
        if self.expert_parallel is not None:
            out, stats = moe_spmd(self._local_experts(), x2, gates,
                                  self.expert_parallel, self.capacity_factor,
                                  n_top=self.n_top, with_stats=True)
            return out.reshape(shp).to(input.dtype), aux, stats
        capacity = max(1, math.ceil(self.n_top * t / self.n_experts
                                    * self.capacity_factor))
        dispatch, combine, stats = _topk_dispatch(gates, capacity,
                                                  self.n_top)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(x2.dtype), x2)
        expert_out = _expert_fwd(self.expert_params(), expert_in)
        out = torch.einsum("ecd,tec->td", expert_out,
                           combine.to(expert_out.dtype))
        return out.reshape(shp).to(input.dtype), aux, stats

    def forward_with_aux(self, input):
        """(output, l_aux)."""
        out, aux, _ = self.forward_with_stats(input)
        return out, aux

    def forward(self, input):
        out, aux, stats = self.forward_with_stats(input)
        self.l_aux = aux
        self.last_stats = stats
        return out


def record_moe_metrics(metrics, stats, prefix: str = "moe") -> None:
    """Write the routing stats into an ``optim.metrics.Metrics`` table:
    the drop rate and the largest expert share (1/E is balanced). Both
    are fractions: read them with ``metrics.get(name)[0]``."""
    metrics.set(f"{prefix} drop rate", float(stats["drop_rate"]))
    metrics.set(f"{prefix} max expert fraction",
                float(stats["expert_fraction"].max()))


def moe_spmd(expert_params: dict, x2, gates, group,
             capacity_factor: float = 1.25, n_top: int = 1,
             with_stats: bool = False):
    """Expert-parallel MoE over ``group``: ``x2`` (T/n, D) and ``gates``
    (T/n, E) are this rank's tokens, ``expert_params`` its E/n experts
    (see the module docstring). Returns the (T/n, D) output (and the
    routing stats averaged over the group with ``with_stats``)."""
    group = C.resolve_group(group)
    n = C.group_size(group)
    t_local = x2.shape[0]
    e_global = gates.shape[1]
    if e_global % n:
        raise ValueError(f"n_experts {e_global} not divisible by the "
                         f"expert axis size {n}")
    e_local = e_global // n
    capacity = max(1, math.ceil(n_top * t_local / e_global
                                * capacity_factor))
    dispatch, combine, stats = _topk_dispatch(gates, capacity, n_top)
    buf = torch.einsum("tec,td->ecd", dispatch.to(x2.dtype), x2)
    buf = buf.reshape(n, e_local, capacity, buf.shape[-1])
    # rank d receives every source's buffers for ITS experts
    buf = C.all_to_all(buf, group, 0, 0)          # (n_src, e_local, C, D)
    inp = buf.movedim(0, 1).reshape(e_local, n * capacity, -1)
    out = _expert_fwd(expert_params, inp)
    out = out.reshape(e_local, n, capacity, -1).movedim(1, 0)
    out = C.all_to_all(out, group, 0, 0)          # back to the token owners
    out = out.reshape(e_global, capacity, -1)
    res = torch.einsum("ecd,tec->td", out, combine.to(out.dtype))
    if with_stats:
        stats = {k: C.all_reduce(v, group, "mean") for k, v in stats.items()}
        return res, stats
    return res
