"""Training throughput of the transformer flagship (port of
``_transformer_perf`` in ``bigdl_tpu/models/perf.py``).

:func:`transformer_perf` builds the JAX package's long-context training
flagship (TransformerLM vocab 32000, embed 512, 8 heads, 8 layers,
learned positions, tied head, dropout 0, flash on; weights from seed 0),
trains it on one random batch with next-token cross entropy (1-based
targets) and ``SGD(learning_rate=0.01)`` through the train step, in
``dtype`` over f32 master parameters, and times the steps after
warm-up: with CUDA
events on the card, with the host clock on the CPU (the summary names
its device; a CPU time says nothing about the card). ``profile``, the
twin of the JAX harness's ``profile_dir``, is called after the timed
steps with a function that runs one more step, and its result is kept
in the summary (``chip_smoke.py`` passes
``bigdl_tpu_torch.utils.profiling.device_profile``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.optim.optim_method import SGD
from bigdl_tpu_torch.optim.optimizer import make_train_step


class LMLoss:
    """Next-token cross entropy over the flattened time axis: logits at
    t predict ids at t + 1, as 1-based targets."""

    def __init__(self, vocab: int):
        self.vocab = vocab
        self.ce = CrossEntropyCriterion()

    def forward(self, logits, ids):
        lg = logits[:, :-1].reshape(-1, self.vocab)
        tg = ids[:, 1:].reshape(-1) + 1
        return self.ce.forward(lg, tg)


def transformer_perf(batch_size: int = 32, iterations: int = 20,
                     warmup: int = 3, dtype=torch.bfloat16, log=print,
                     seq_len: int = 1024, vocab: int = 32000,
                     embed_dim: int = 512, layers: int = 8, heads: int = 8,
                     remat: bool = False,
                     profile: Optional[Callable] = None,
                     device=DEFAULT_DEVICE) -> dict:
    """Tokens/s of the train step on one random (batch_size, seq_len)
    batch, computing in ``dtype`` over f32 parameters. Returns the
    summary: ``records_per_sec`` (tokens/s), ``ms_per_iter``, ``loss``
    (last step), ``losses`` (every step, warm-up included),
    ``flops_per_iter`` (3 x the model's analytic forward FLOPs,
    ``flops_source`` "analytic") and the device it ran on."""
    dev = resolve_device(device)
    model = TransformerLM(vocab, embed_dim=embed_dim, num_heads=heads,
                          num_layers=layers, max_len=seq_len, use_flash=True,
                          remat=remat, seed=0, device=dev)
    ts = make_train_step(model, LMLoss(vocab), SGD(learning_rate=0.01),
                         compute_dtype=dtype)
    params = model.params_dict()
    buffers = model.buffers_dict()
    slots = ts.init_slots(params)
    lrs = ts.current_lrs()
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, vocab, (batch_size, seq_len), device=dev,
                        generator=gen)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    losses = []
    t0 = time.perf_counter()
    for _ in range(max(1, warmup)):
        loss, params, buffers, slots = ts.step(params, buffers, slots, ids,
                                               ids, lrs, gen)
        losses.append(loss)
    sync()
    warmup_s = time.perf_counter() - t0
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iterations):
        loss, params, buffers, slots = ts.step(params, buffers, slots, ids,
                                               ids, lrs, gen)
        losses.append(loss)
    if on_card:
        end.record()
    sync()
    elapsed_ms = (start.elapsed_time(end) if on_card
                  else (time.perf_counter() - t0) * 1e3)
    tokens = batch_size * seq_len
    s = {"model": "transformer_lm", "batch_size": batch_size,
         "seq_len": seq_len, "iterations": iterations,
         "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
         "timer": "cuda_events" if on_card else "host_clock",
         "warmup_s": warmup_s, "time_s": elapsed_ms / 1e3,
         "records_per_sec": tokens * iterations / (elapsed_ms / 1e3),
         "ms_per_iter": elapsed_ms / iterations,
         "losses": [float(x) for x in losses],
         "flops_per_iter": 3.0 * model.analytic_flops(tokens, seq_len),
         "flops_source": "analytic"}
    s["loss"] = s["losses"][-1]
    if profile is not None:
        def one_step():
            nonlocal params, buffers, slots
            _, params, buffers, slots = ts.step(params, buffers, slots, ids,
                                                ids, lrs, gen)

        s["profile"] = profile(one_step)
    log(f"[perf] transformer_lm batch={batch_size} seq={seq_len} on "
        f"{s['device']}: {s['records_per_sec']:.0f} tokens/s "
        f"({s['ms_per_iter']:.1f} ms/iter)")
    return s
