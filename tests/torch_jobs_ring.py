"""Rank-side jobs of ``tests/test_torch_ring_attention.py`` (run in
``torch_world.World``; no JAX here)."""

from __future__ import annotations

import logging

from torch_world import my_rows


def seq_mesh():
    """A ("seq", n) default mesh over the world (collective: every rank
    runs it)."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import Engine

    logging.getLogger("bigdl_tpu_torch").setLevel(logging.WARNING)
    Engine.set_default_mesh(Engine.create_mesh(
        [("seq", dist.get_world_size())]))
    return True


def ring_fwd_grad(q, k, v, causal, use_flash, kind="ring", dtype="float32"):
    """This rank's block of the ring's (or Ulysses') output, the gradients
    of the global sum(out ** 2) with respect to its q / k / v blocks,
    and the flash calls it made (causal flag of each)."""
    import importlib

    import torch

    from bigdl_tpu_torch.ops import flash_attention as fa

    ra = importlib.import_module("bigdl_tpu_torch.parallel.ring_attention")

    dt = getattr(torch, dtype)
    qb, kb, vb = (torch.tensor(my_rows(a, 2)).to(dt).requires_grad_(True)
                  for a in (q, k, v))
    calls = []
    real = fa.flash_attention_with_lse

    def counting(q_, k_, v_, causal=False, scale=None):
        calls.append(bool(causal))
        return real(q_, k_, v_, causal, scale)

    fa.flash_attention_with_lse = counting
    try:
        if kind == "ring":
            out = ra.ring_attention(qb, kb, vb, "seq", causal=causal,
                                    use_flash=use_flash)
        else:
            out = ra.ulysses_attention(qb, kb, vb, "seq", causal=causal)
    finally:
        fa.flash_attention_with_lse = real
    (out.float() ** 2).sum().backward()
    return {"out": out.detach().float().numpy(),
            "dq": qb.grad.float().numpy(), "dk": kb.grad.float().numpy(),
            "dv": vb.grad.float().numpy(), "calls": calls,
            "launches": fa.launches}


def lm_sp(params, ids, cfg):
    """The sequence-parallel TransformerLM on this rank's block of ids:
    its logits block and the gradients of the global next-token loss
    (summed over ranks: the pmean over the sequence is the caller's)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.parallel import collectives as C
    from bigdl_tpu_torch.utils.weights import load_jax_params

    model = TransformerLM(**cfg, sequence_parallel="seq", device="cpu")
    load_jax_params(model, params)
    block = torch.tensor(my_rows(ids, 1))
    logits = model(block)
    # a summed cross entropy of every position against a fixed target,
    # the target of this rank's block
    tgt = torch.tensor(my_rows((ids + 1) % cfg["vocab_size"], 1))
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1), reduction="sum")
    loss.backward()
    grads = {n: C.all_reduce(p.grad, "seq").numpy()
             for n, p in model.named_parameters()}
    return {"logits": logits.detach().numpy(), "grads": grads,
            "loss": C.all_reduce(loss.detach(), "seq").item()}
