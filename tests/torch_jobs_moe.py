"""Rank-side jobs of ``tests/test_torch_moe_pipeline.py`` (run in
``torch_world.World``; no JAX here)."""

from __future__ import annotations

import logging

from torch_world import arrays, my_rows, rank


def quiet():
    logging.getLogger("bigdl_tpu_torch").setLevel(logging.WARNING)
    return True


def _stage_fn(p, x):
    import torch

    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_run(stages, x, s, m, remat=False):
    """The pipelined forward over the first ``s`` ranks (a ``pipe`` mesh
    of those ranks; the others idle), and the gradient of sum(y ** 2)
    with respect to this rank's stage and to x."""
    import torch

    from bigdl_tpu_torch.parallel import Engine, pipeline_spmd

    mesh = Engine.create_mesh([("pipe", s)], ranks=list(range(s)))
    if rank() >= s:
        return None
    params = {k: torch.tensor(v[rank()]).requires_grad_(True)
              for k, v in stages.items()}
    xt = torch.tensor(x, requires_grad=True)
    y = pipeline_spmd(_stage_fn, params, xt, mesh.group("pipe"), m,
                      remat=remat)
    (y ** 2).sum().backward()
    return {"y": y.detach().numpy(),
            "grads": {k: p.grad.numpy() for k, p in params.items()},
            "dx": xt.grad.numpy()}


def pipeline_indivisible():
    import torch

    from bigdl_tpu_torch.parallel import Engine, pipeline_spmd

    mesh = Engine.create_mesh([("pipe", 4)])
    p = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    try:
        pipeline_spmd(_stage_fn, p, torch.ones(8, 4), mesh.group("pipe"), 3)
    except ValueError as e:
        return str(e)
    return None


def moe_spmd_run(params, x, gate_w, capacity_factor, n_top):
    """``moe_spmd`` over an ``expert`` mesh of the world: this rank's
    token rows and E/n experts; the output rows and the gradients of
    sum(out ** 2) with respect to its tokens and experts."""
    import torch

    from bigdl_tpu_torch.parallel import Engine, moe_spmd

    mesh = Engine.create_mesh([("expert", 4)])
    local = {k: torch.tensor(my_rows(v)).requires_grad_(True)
             for k, v in params.items()}
    xr = torch.tensor(my_rows(x), requires_grad=True)
    gates = torch.softmax(xr @ torch.tensor(gate_w), -1)
    out, stats = moe_spmd(local, xr, gates, mesh.group("expert"),
                          capacity_factor, n_top=n_top, with_stats=True)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "dx": xr.grad.numpy(),
            "grads": {k: v.grad.numpy() for k, v in local.items()},
            "stats": arrays(stats)}


def moe_spmd_indivisible():
    import torch

    from bigdl_tpu_torch.parallel import moe_spmd

    z = {"w1": torch.zeros(6, 4, 8), "b1": torch.zeros(6, 8),
         "w2": torch.zeros(6, 8, 4), "b2": torch.zeros(6, 4)}
    try:
        moe_spmd(z, torch.ones(2, 4), torch.ones(2, 6) / 6.0, None)
    except ValueError as e:
        return str(e)
    return None


def moe_lm_sp(params, ids, cfg):
    """An MoE TransformerLM with ``sequence_parallel="seq"`` on this
    rank's block of ``ids``: logits, l_aux and stats, and the gradients of
    sum(logits ** 2) * 1e-3 + 0.01 * l_aux summed over the ranks."""
    import torch

    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.parallel import collectives as C
    from bigdl_tpu_torch.utils.weights import load_jax_params

    Engine.set_default_mesh(Engine.create_mesh([("seq", 4)]))
    model = TransformerLM(**cfg, sequence_parallel="seq", device="cpu")
    load_jax_params(model, params)
    logits = model(torch.tensor(my_rows(ids, 1)))
    loss = (logits ** 2).sum() * 1e-3 + 0.01 * model.l_aux
    loss.backward()
    grads = {n: C.all_reduce(p.grad, "seq").numpy()
             for n, p in model.named_parameters()}
    Engine.set_default_mesh(Engine.create_mesh())
    return {"logits": logits.detach().numpy(), "l_aux": float(model.l_aux),
            "grads": grads, "stats": arrays(model.last_moe_stats)}


def moe_lm_expert_parallel(params, ids, cfg):
    """An MoE TransformerLM over an ``expert`` axis: each rank its own
    rows of ``ids`` and its E/n experts; the logits rows."""
    import torch

    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.utils.weights import load_jax_params

    Engine.set_default_mesh(Engine.create_mesh([("expert", 4)]))
    model = TransformerLM(**cfg, expert_parallel="expert", device="cpu")
    load_jax_params(model, params)
    with torch.no_grad():
        logits = model(torch.tensor(my_rows(ids)))
    Engine.set_default_mesh(Engine.create_mesh())
    return logits.numpy()
