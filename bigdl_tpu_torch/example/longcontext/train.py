"""Long-context language-model training (port of
``bigdl_tpu/example/longcontext/train.py``).

One model composes the long-context stack: a TransformerLM with
per-block rematerialization (``torch.utils.checkpoint``), the flash
kernel (``--flash``), RoPE (``--rope``), grouped-query heads
(``--kv-heads``) and top-1 mixture-of-experts MLPs (``--experts N``,
the Switch load-balancing loss folded in with ``--aux-coef``), trained
by plain SGD(0.1) on the JAX main's synthetic stream (``RandomState(0)``
tokens, the targets shifted by one).

``--seq-parallel N`` shards the sequence over N ranks of a ``("data",
"seq")`` mesh of the launcher's world (ring attention through the flash
kernel with ``--flash``; the batch over the rest, rounded up to a
multiple of the data ranks): each rank takes the loss of its (rows,
positions) block, and the loss and the gradients are averaged over both
axes, as the JAX step's ``pmean`` over ``("data", "seq")`` does. Without
it the main trains in one process and then runs the ``generate`` demo.
Rank 0 prints each step's loss; every rank's last line is a JSON
summary (losses, the L2 norm of each step's averaged gradient, seconds
a step, tokens/s, peak device memory, flash launches, the group's
transport, the MoE routing stats).

    python -m bigdl_tpu_torch.example.longcontext.train --device cpu
    python -m bigdl_tpu_torch.tools.launch --procs 4 --backend gloo \\
        -m bigdl_tpu_torch.example.longcontext.train --seq-parallel 4 \\
        --flash --rope --kv-heads 2

``--device`` (default ``cuda``) is the launcher's ``--device`` under
the launcher. ``--init-params PATH`` starts from the parameters in an
``.npz`` whose keys are the JAX ``params_dict()`` paths
(``block0/attn/qkv/~params/weight``): the JAX main's weights, to hold
the two runs against each other.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_params(model, path: str) -> None:
    from bigdl_tpu_torch.utils.weights import load_jax_params

    tree: dict = {}
    with np.load(path) as npz:
        for key in npz.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = npz[key]
    load_jax_params(model, tree)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--embed", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--experts", type=int, default=0)
    p.add_argument("--flash", action="store_true")
    p.add_argument("--rope", action="store_true",
                   help="rotary positions instead of the learned table")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="GQA: fewer kv heads than query heads")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--seq-parallel", type=int, default=0, metavar="N",
                   help="shard the sequence over an N-rank 'seq' mesh axis")
    p.add_argument("--aux-coef", type=float, default=0.01)
    p.add_argument("--device", default="cuda",
                   help="device to train on (cuda, or cpu)")
    p.add_argument("--init-params", default=None,
                   help=".npz of the JAX params tree to start from")
    args = p.parse_args(argv)

    import torch

    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.parallel import collectives as C

    sp = args.seq_parallel
    dev = resolve_device(args.device)
    rank, dp, mesh = 0, 1, None
    if sp:
        Engine.init(device=args.device)    # a no-op under the launcher
        if dev.type == "cuda":
            dev = Engine.device()
        dp = max(1, Engine.node_number() // sp)
        mesh = Engine.create_mesh([("data", dp), ("seq", sp)])
        Engine.set_default_mesh(mesh)
        rank = C.group_rank(None)
    model = TransformerLM(
        args.vocab, embed_dim=args.embed, num_heads=args.heads,
        num_layers=args.layers, max_len=args.seq_len, causal=True,
        remat=not args.no_remat, use_flash=args.flash,
        n_experts=args.experts, use_rope=args.rope,
        num_kv_heads=args.kv_heads,
        sequence_parallel="seq" if sp else None, seed=1, device=dev)
    if args.init_params:
        _load_params(model, args.init_params)

    batch = args.batch
    if sp and batch % dp:
        batch = (batch + dp - 1) // dp * dp   # round up to the dp shards
        if rank == 0:
            print(f"[longcontext] batch rounded up to {batch} "
                  f"({dp}-way data parallel)")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, args.vocab, (batch, args.seq_len))
    targets = np.roll(ids, -1, axis=1)
    if sp:
        rows, cols = batch // dp, args.seq_len // sp
        d, s = mesh.index("data"), mesh.index("seq")
        ids = ids[d * rows:(d + 1) * rows, s * cols:(s + 1) * cols]
        targets = targets[d * rows:(d + 1) * rows, s * cols:(s + 1) * cols]
    ids_t = torch.as_tensor(ids, device=dev)
    tgt_t = torch.as_tensor(targets, device=dev)
    params = list(model.parameters())

    losses, times, grad_norms = [], [], []
    fa.launches = fa.backward_launches = fa.plain_backward_cuda_calls = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(args.steps):
        t0 = time.perf_counter()
        logits = model(ids_t)
        logp = torch.log_softmax(logits.float(), -1)
        nll = -logp.gather(-1, tgt_t[..., None]).mean()
        if args.experts:
            nll = nll + args.aux_coef * model.l_aux
        grads = torch.autograd.grad(nll, params)
        with torch.no_grad():
            if sp:    # pmean over ("data", "seq"): the whole world
                flat = C.all_reduce(torch.cat([g.reshape(-1)
                                               for g in grads]),
                                    None, "mean")
                grads = flat.split([q.numel() for q in params])
                nll = C.all_reduce(nll.detach(), None, "mean")
            grad_norms.append(float(torch.cat([g.reshape(-1)
                                               for g in grads]).norm()))
            for w, g in zip(params, grads):
                w -= 0.1 * g.reshape(w.shape)
        loss = float(nll.detach())
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if rank == 0:
            print(f"step {i}: loss {loss:.6f} ({times[-1]:.2f}s)", flush=True)
    if rank == 0:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")

    summary = {"rank": rank, "world": dp * sp if sp else 1, "losses": losses,
               "grad_norms": grad_norms, "step_s": times,
               "tokens_per_s": batch * args.seq_len / np.median(times[1:]
                                                                or times),
               "flash_launches": fa.launches,
               "flash_backward_launches": fa.backward_launches,
               "plain_backward_cuda_calls": fa.plain_backward_cuda_calls,
               "transport": C.transport(None, ids_t) if sp else "local",
               "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}
    if args.experts:
        st = model.last_moe_stats
        summary["moe"] = {
            "drop_rate": float(C.all_reduce(st["drop_rate"].detach(), None,
                                            "mean")),
            "max_expert_fraction": float(C.all_reduce(
                st["expert_fraction"].detach(), None, "mean").max())}
    if not sp:  # KV-cache decoding demo on the trained weights
        model.evaluate()
        t0 = min(8, max(1, args.seq_len // 2))
        new = min(8, args.seq_len - t0)
        out = model.generate(ids_t[:1, :t0], new)
        summary["generated"] = out[0, t0:].tolist()
        print(f"generated continuation: {summary['generated']}")
    # one write, so the ranks' lines never interleave on a shared pipe
    sys.stdout.write(json.dumps(summary) + "\n")
    sys.stdout.flush()
    return losses


if __name__ == "__main__":
    main()
