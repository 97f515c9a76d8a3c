"""Synthetic-data training throughput (port of ``build_model``,
``run_perf`` and ``_transformer_perf`` in ``bigdl_tpu/models/perf.py``).

:func:`run_perf` trains a model chosen by name (``lenet5``,
``resnet<depth>``; ``transformer`` goes to :func:`transformer_perf`) on
one random batch made on the device (labels all 1, 1-based) with
``SGD(learning_rate=0.01)`` through the train step, in ``dtype`` (params
stored in it, or f32 masters cast per step with ``master_f32``), and
times the steps after warm-up as :func:`transformer_perf` does. The JAX
summary's FLOP and byte counts come from XLA's cost analysis, which has
no counterpart here, so those keys are absent, as they are there when
the analysis fails.

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
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import DatasetType, ResNet
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion)
from bigdl_tpu_torch.nn.module import Module, tree_leaves, tree_unflatten
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


def build_model(name: str, class_num: int = 1000, format: str = "NCHW", *,
                seed: int = 1, device=DEFAULT_DEVICE, dtype=torch.float32):
    """(model, input shape without the batch, class count) by name, built
    on ``device`` in ``dtype``; ``format="NHWC"`` gives the channels-last
    ResNet. The JAX package's VGG, Inception and MobileNet are not
    ported yet (``ROADMAP.md``) and raise."""
    name = name.lower()
    if name == "lenet5":
        return LeNet5(10, seed=seed, device=device, dtype=dtype), (28, 28), 10
    if name.startswith("resnet"):
        depth = int(name[len("resnet"):] or 50)
        shape = (224, 224, 3) if format == "NHWC" else (3, 224, 224)
        return (ResNet(class_num, {"depth": depth,
                                   "dataSet": DatasetType.ImageNet,
                                   "format": format},
                       seed=seed, device=device, dtype=dtype),
                shape, class_num)
    raise ValueError(f"perf model {name!r} is not ported (lenet5 and "
                     "resnet<depth> are; see ROADMAP.md for the rest)")


def _timed_steps(ts, params, buffers, slots, x, y, lrs, iterations, warmup,
                 dev, gen=None):
    """Run ``warmup`` then ``iterations`` steps; (params, buffers, slots,
    losses, warm-up seconds, timed ms, timer name): CUDA events on the
    card, the host clock on the CPU."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    losses = []
    t0 = time.perf_counter()
    for _ in range(max(1, warmup)):
        loss, params, buffers, slots = ts.step(params, buffers, slots, x, y,
                                               lrs, gen)
        losses.append(loss)
    sync()
    warmup_s = time.perf_counter() - t0
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iterations):
        loss, params, buffers, slots = ts.step(params, buffers, slots, x, y,
                                               lrs, gen)
        losses.append(loss)
    if on_card:
        end.record()
    sync()
    elapsed_ms = (start.elapsed_time(end) if on_card
                  else (time.perf_counter() - t0) * 1e3)
    return (params, buffers, slots, [float(v) for v in losses], warmup_s,
            elapsed_ms, "cuda_events" if on_card else "host_clock")


def run_perf(model_name: str = None, batch_size: int = 32,
             iterations: int = 20, warmup: int = 3, dtype=torch.float32,
             criterion=None, model: Optional[Module] = None,
             input_shape=None, class_num: int = 1000, log=print,
             format: str = "NCHW", master_f32: bool = False,
             profile: Optional[Callable] = None,
             device=DEFAULT_DEVICE) -> dict:
    """Records/s of the train step on one random batch. Returns the JAX
    summary's keys (``model``, ``batch_size``, ``iterations``,
    ``warmup_s``, ``time_s``, ``records_per_sec``, ``ms_per_iter``,
    ``loss``) with ``losses`` (every step, warm-up included), the device
    and the timer; ``profile`` as in :func:`transformer_perf`. ResNets
    train with ``CrossEntropyCriterion`` on their raw logits, the other
    models with ``ClassNLLCriterion``."""
    dev = resolve_device(device)
    if model is None:
        model_name = model_name or "resnet50"
        if model_name in ("transformer", "transformer_lm"):
            if criterion is not None:
                raise ValueError(
                    "the transformer bench fixes its own next-token CE "
                    "loss; custom criterion is not supported")
            return transformer_perf(batch_size, iterations, warmup, dtype,
                                    log=log, profile=profile, device=dev)
        model, input_shape, class_num = build_model(
            model_name, class_num, format=format, device=dev)
    elif input_shape is None:
        raise ValueError("input_shape is required when passing a custom model")
    else:
        model_name = model_name or "custom"
    if criterion is None:
        criterion = (CrossEntropyCriterion() if model_name.startswith("resnet")
                     else ClassNLLCriterion())
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((batch_size,) + tuple(input_shape), device=dev,
                    generator=gen).to(dtype)
    y = torch.ones((batch_size,), dtype=torch.int64, device=dev)
    ts = make_train_step(model, criterion, SGD(learning_rate=0.01),
                         compute_dtype=dtype if master_f32 else None)
    params, buffers = model.params_dict(), model.buffers_dict()
    if not master_f32:
        params, buffers = (
            tree_unflatten(t, [v.detach().to(dtype) if v.is_floating_point()
                               else v for _, v in tree_leaves(t)])
            for t in (params, buffers))
    slots = ts.init_slots(params)
    lrs = ts.current_lrs()
    params, buffers, slots, losses, warmup_s, elapsed_ms, timer = \
        _timed_steps(ts, params, buffers, slots, x, y, lrs, iterations,
                     warmup, dev)
    s = {"model": model_name, "batch_size": batch_size,
         "iterations": iterations,
         "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
         "timer": timer, "warmup_s": warmup_s, "time_s": elapsed_ms / 1e3,
         "records_per_sec": batch_size * iterations / (elapsed_ms / 1e3),
         "ms_per_iter": elapsed_ms / iterations, "losses": losses,
         "loss": losses[-1]}
    if profile is not None:
        def one_step():
            nonlocal params, buffers, slots
            _, params, buffers, slots = ts.step(params, buffers, slots, x, y,
                                                lrs, None)

        s["profile"] = profile(one_step)
    log(f"[perf] {model_name} batch={batch_size} on {s['device']}: "
        f"{s['records_per_sec']:.1f} records/s "
        f"({s['ms_per_iter']:.1f} ms/iter)")
    return s


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
    params, buffers, slots, losses, warmup_s, elapsed_ms, timer = \
        _timed_steps(ts, params, buffers, slots, ids, ids, lrs, iterations,
                     warmup, dev, gen)
    tokens = batch_size * seq_len
    s = {"model": "transformer_lm", "batch_size": batch_size,
         "seq_len": seq_len, "iterations": iterations,
         "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
         "timer": timer, "warmup_s": warmup_s, "time_s": elapsed_ms / 1e3,
         "records_per_sec": tokens * iterations / (elapsed_ms / 1e3),
         "ms_per_iter": elapsed_ms / iterations, "losses": losses,
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
