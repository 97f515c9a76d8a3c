"""Synthetic-data training throughput, decode throughput, the host input
pipeline and the perf CLI (port of ``bigdl_tpu/models/perf.py``).

:func:`run_perf` trains a model chosen by name (``lenet5``, ``vgg16``,
``vggcifar``, ``inception_v1``, ``mobilenet[_v1|_<width>]``,
``resnet<depth>``; ``transformer`` goes to :func:`transformer_perf`) on
one random batch made on the device (labels all 1, 1-based) with
``SGD(learning_rate=0.01)`` through the train step, in ``dtype`` (params
stored in it, or f32 masters cast per step with ``master_f32``), and
times the steps after warm-up as :func:`transformer_perf` does. The JAX
summary's FLOP and byte counts come from XLA's cost analysis, which has
no counterpart here: ``flops_per_iter`` is analytic (6 x the batch x
:func:`analytic_macs`, the convolutions' and linear layers'
multiply-accumulates; ``flops_source`` "analytic") and the byte count is
absent, as it is there when the analysis fails.

:func:`transformer_perf` builds the JAX package's long-context training
flagship (TransformerLM vocab 32000, embed 512, 8 heads, 8 layers,
learned positions, tied head, dropout 0, flash on; weights from seed 0),
trains it on one random batch with next-token cross entropy (1-based
targets) and ``SGD(learning_rate=0.01)`` through the train step, in
``dtype`` over f32 master parameters (``master_f32=False``: the
parameters stored in ``dtype``, as the JAX harness offers; ``use_flash``
False: the dense attention), and times the steps after warm-up: with CUDA
events on the card, with the host clock on the CPU (the summary names
its device; a CPU time says nothing about the card). ``profile_dir``
writes a ``torch.profiler`` Chrome trace of the timed steps into that
directory (the JAX harness writes a ``jax.profiler`` trace there);
``profile`` is called after the timed steps with a function that runs
one more step, and its result is kept in the summary (``chip_smoke.py``
passes ``bigdl_tpu_torch.utils.profiling.device_profile``).

:func:`run_decode_perf` times greedy KV-cache decode, the prefill alone
and, with a draft, speculative decoding, and returns the JAX row's keys.

:func:`run_input_pipeline_perf` measures the feed side alone: records/s
from TFRecord shards through the ImageNet augment chain (composed, or
the one-pass ``FusedCropFlipNormalize``), ``SampleToMiniBatch`` and the
staging copy onto the device, at several prefetch depths, with the
records read by the C++ reader or the Python pool and the one-pass
augment run by the C++ kernel or its numpy twin; each row says what
actually ran.

:func:`main` is the command line (``python -m
bigdl_tpu_torch.models.perf``), with the JAX CLI's flags and a
``--device``.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.models.inception import InceptionV1NoAuxClassifier
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.mobilenet import MobileNetV1
from bigdl_tpu_torch.models.resnet import DatasetType, ResNet
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.vgg import Vgg16, VggForCifar10
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
    on ``device`` in ``dtype`` (the JAX package's ``--model`` names);
    ``format="NHWC"`` gives the channels-last MobileNet and ResNet."""
    kw = dict(seed=seed, device=device, dtype=dtype)
    name = name.lower()
    if name == "lenet5":
        return LeNet5(10, **kw), (28, 28), 10
    if name == "vgg16":
        return Vgg16(class_num, **kw), (3, 224, 224), class_num
    if name == "vggcifar":
        return VggForCifar10(10, **kw), (3, 32, 32), 10
    if name in ("inception_v1", "inception"):
        return (InceptionV1NoAuxClassifier(class_num, **kw), (3, 224, 224),
                class_num)
    shape = (224, 224, 3) if format == "NHWC" else (3, 224, 224)
    if name.startswith("mobilenet"):
        # accepted: mobilenet, mobilenet_v1, mobilenet_<width> (e.g. _0.5)
        suffix = name[len("mobilenet"):].lstrip("_")
        if suffix in ("", "v1"):
            width = 1.0
        else:
            try:
                width = float(suffix)
            except ValueError:
                raise ValueError(
                    f"unknown mobilenet variant {name!r} (only V1 exists "
                    "here; use mobilenet, mobilenet_v1, or mobilenet_<width>)")
        return (MobileNetV1(class_num, width=width, format=format, **kw),
                shape, class_num)
    if name.startswith("resnet"):
        depth = int(name[len("resnet"):] or 50)
        return (ResNet(class_num, {"depth": depth,
                                   "dataSet": DatasetType.ImageNet,
                                   "format": format}, **kw),
                shape, class_num)
    raise ValueError(f"unknown perf model {name!r}")


def analytic_macs(model: Module, input_shape) -> int:
    """Multiply-accumulates of one image's forward through the model's
    convolutions and linear layers, counted from the shapes their outputs
    take in a forward of one zero image (in evaluation mode, without
    gradients; the model's mode is put back): a convolution's output
    elements times ``C_in / groups * kH * kW``, a linear layer's times
    its input width. A train step is about 3 x 2 x this many FLOPs."""
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    from bigdl_tpu_torch.nn.linear import Linear

    macs = []

    def count(m, _, out):
        if isinstance(m, SpatialConvolution):
            per = m.n_input_plane // m.n_group * m.kernel_h * m.kernel_w
        else:
            per = m.input_size
        macs.append(out.numel() * per)

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (SpatialConvolution, Linear))]
    p = next(model.parameters())
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros((1,) + tuple(input_shape), device=p.device,
                              dtype=p.dtype))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return int(sum(macs))


def _cast_floating(tree, dtype):
    """A copy of a parameter or buffer tree with every floating leaf in
    ``dtype`` (the JAX harness's ``_cast_floating``)."""
    return tree_unflatten(tree, [v.detach().to(dtype) if v.is_floating_point()
                                 else v for _, v in tree_leaves(tree)])


class _Clock:
    """Times a stretch of work in ms: CUDA events on the card (read after
    a synchronize), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.on_card = dev.type == "cuda"
        self.name = "cuda_events" if self.on_card else "host_clock"

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.dev)

    def start(self):
        if self.on_card:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.on_card:
            self._end.record()
        self.sync()
        if self.on_card:
            return self._start.elapsed_time(self._end)
        return (time.perf_counter() - self._t0) * 1e3


@contextlib.contextmanager
def traced(profile_dir: Optional[str], dev: torch.device, label: str):
    """A ``torch.profiler`` trace of the block (CPU and, on the card,
    CUDA activity) written to ``profile_dir`` as a Chrome trace JSON,
    ``<label>.<pid>.<ns>.pt.trace.json``; nothing without a directory.
    The profiler's own cost is inside whatever the block times, as the
    JAX harness's ``jax.profiler.trace`` is. It holds the observability
    profiler's lock (``ProfilerBusy`` while a ``/debug/profile`` capture
    runs), so two sessions never overlap."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.observability.profiler import exclusive

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with exclusive(), profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{label}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def _timed_steps(ts, params, buffers, slots, x, y, lrs, iterations, warmup,
                 dev, gen=None, profile_dir=None, label="perf"):
    """Run ``warmup`` then ``iterations`` steps (traced into
    ``profile_dir`` when given); (params, buffers, slots, losses, warm-up
    seconds, timed ms, timer name)."""
    clock = _Clock(dev)
    losses = []
    t0 = time.perf_counter()
    for _ in range(max(1, warmup)):
        loss, params, buffers, slots = ts.step(params, buffers, slots, x, y,
                                               lrs, gen)
        losses.append(loss)
    clock.sync()
    warmup_s = time.perf_counter() - t0
    with traced(profile_dir, dev, label):
        clock.start()
        for _ in range(iterations):
            loss, params, buffers, slots = ts.step(params, buffers, slots,
                                                   x, y, lrs, gen)
            losses.append(loss)
        elapsed_ms = clock.stop()
    return (params, buffers, slots, [float(v) for v in losses], warmup_s,
            elapsed_ms, clock.name)


def run_perf(model_name: str = None, batch_size: int = 32,
             iterations: int = 20, warmup: int = 3, dtype=torch.float32,
             criterion=None, model: Optional[Module] = None,
             input_shape=None, class_num: int = 1000, log=print,
             format: str = "NCHW", master_f32: bool = False,
             profile: Optional[Callable] = None,
             profile_dir: Optional[str] = None,
             device=DEFAULT_DEVICE) -> dict:
    """Records/s of the train step on one random batch. Returns the JAX
    summary's keys (``model``, ``batch_size``, ``iterations``,
    ``warmup_s``, ``time_s``, ``records_per_sec``, ``ms_per_iter``,
    ``loss``) with ``losses`` (every step, warm-up included), the device
    and the timer; ``profile`` and ``profile_dir`` as in
    :func:`transformer_perf`. ResNets
    train with ``CrossEntropyCriterion`` on their raw logits, the other
    models with ``ClassNLLCriterion``, as in the JAX harness (MobileNet's
    head emits logits too: its loss is then minus the label's logit).
    ``transformer`` goes to :func:`transformer_perf` with
    ``master_f32``."""
    dev = resolve_device(device)
    if model is None:
        model_name = model_name or "resnet50"
        if model_name in ("transformer", "transformer_lm"):
            if criterion is not None:
                raise ValueError(
                    "the transformer bench fixes its own next-token CE "
                    "loss; custom criterion is not supported")
            if format not in ("NCHW", None):
                log(f"[perf] note: format={format!r} ignored for "
                    "transformer")
            return transformer_perf(batch_size, iterations, warmup, dtype,
                                    log=log, master_f32=master_f32,
                                    profile=profile,
                                    profile_dir=profile_dir, device=dev)
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
        params, buffers = _cast_floating(params, dtype), \
            _cast_floating(buffers, dtype)
    slots = ts.init_slots(params)
    lrs = ts.current_lrs()
    params, buffers, slots, losses, warmup_s, elapsed_ms, timer = \
        _timed_steps(ts, params, buffers, slots, x, y, lrs, iterations,
                     warmup, dev, profile_dir=profile_dir,
                     label=f"perf_{model_name}")
    s = {"model": model_name, "batch_size": batch_size,
         "iterations": iterations,
         "device": _device_name(dev),
         "timer": timer, "warmup_s": warmup_s, "time_s": elapsed_ms / 1e3,
         "records_per_sec": batch_size * iterations / (elapsed_ms / 1e3),
         "ms_per_iter": elapsed_ms / iterations, "losses": losses,
         "loss": losses[-1],
         "flops_per_iter": 6.0 * batch_size * analytic_macs(model,
                                                            input_shape),
         "flops_source": "analytic"}
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
                     remat: bool = False, use_flash: bool = True,
                     master_f32: bool = True,
                     profile: Optional[Callable] = None,
                     profile_dir: Optional[str] = None,
                     device=DEFAULT_DEVICE) -> dict:
    """Tokens/s of the train step on one random (batch_size, seq_len)
    batch, computing in ``dtype`` over f32 parameters (or, without
    ``master_f32``, over parameters stored in ``dtype``). Returns the
    summary: ``records_per_sec`` (tokens/s), ``ms_per_iter``, ``loss``
    (last step), ``losses`` (every step, warm-up included),
    ``flops_per_iter`` (3 x the model's analytic forward FLOPs,
    ``flops_source`` "analytic") and the device it ran on.
    ``profile_dir`` writes a ``torch.profiler`` Chrome trace of the timed
    steps there (see :func:`traced`)."""
    dev = resolve_device(device)
    model = TransformerLM(vocab, embed_dim=embed_dim, num_heads=heads,
                          num_layers=layers, max_len=seq_len,
                          use_flash=use_flash, remat=remat, seed=0,
                          device=dev)
    ts = make_train_step(model, LMLoss(vocab), SGD(learning_rate=0.01),
                         compute_dtype=dtype if master_f32 else None)
    params, buffers = model.params_dict(), model.buffers_dict()
    if not master_f32:
        params, buffers = _cast_floating(params, dtype), \
            _cast_floating(buffers, dtype)
    slots = ts.init_slots(params)
    lrs = ts.current_lrs()
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, vocab, (batch_size, seq_len), device=dev,
                        generator=gen)
    params, buffers, slots, losses, warmup_s, elapsed_ms, timer = \
        _timed_steps(ts, params, buffers, slots, ids, ids, lrs, iterations,
                     warmup, dev, gen, profile_dir=profile_dir,
                     label="perf_transformer_lm")
    tokens = batch_size * seq_len
    s = {"model": "transformer_lm", "batch_size": batch_size,
         "seq_len": seq_len, "iterations": iterations,
         "device": _device_name(dev),
         "timer": timer, "warmup_s": warmup_s, "time_s": elapsed_ms / 1e3,
         "records_per_sec": tokens * iterations / (elapsed_ms / 1e3),
         "ms_per_iter": elapsed_ms / iterations, "losses": losses,
         "flops_per_iter": 3.0 * model.analytic_flops(tokens, seq_len),
         "flops_source": "analytic", "use_flash": use_flash,
         "master_f32": master_f32}
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


def run_decode_perf(batch_size: int = 8, prompt_len: int = 128,
                    new_tokens: int = 128, vocab: int = 32000,
                    embed_dim: int = 512, layers: int = 8, heads: int = 8,
                    num_kv_heads: Optional[int] = None,
                    use_rope: bool = True, dtype=torch.bfloat16,
                    int8: bool = False, speculative: int = 0,
                    spec_gamma: int = 4, spec_int8_draft: bool = False,
                    profile_dir: Optional[str] = None, log=print,
                    device=DEFAULT_DEVICE) -> dict:
    """Serving-side throughput: greedy KV-cache decode tokens/s of a
    TransformerLM (weights from seed 0, in ``dtype``, which the KV cache
    takes too) over one random (batch_size, prompt_len) batch. A first
    ``generate`` warms up; the second, timed, gives
    ``decode_tokens_per_sec`` and ``ms_per_token``; a prefill alone
    (``generate(prompt, 1, host_loop=True)`` with the warm call's cache
    length) gives ``prefill_tokens_per_sec``. Timed with CUDA events on
    the card, the host clock on the CPU.

    ``int8`` times the ``Quantizer.quantize`` clone (int8 Linear
    weights). ``speculative=K`` also times greedy
    ``speculative_generate`` with a K-layer draft that shares the
    target's first K blocks and its embeddings; ``spec_int8_draft`` with
    the target's int8 clone as the draft (``spec_*`` keys: tokens/s,
    rounds, accept rate, speedup over plain decode). On the CPU every
    knob is clamped as the JAX harness clamps it (vocab 256, embed 64, 2
    layers, 4 heads, prompt and new tokens at most 16, K below the
    layer count), so any documented invocation still runs as a smoke;
    the incompatible draft choices raise its ``ValueError``s.
    ``profile_dir`` traces the timed decode (see :func:`traced`).
    Returns the JAX row's keys, unrounded; ``main`` adds the device."""
    from bigdl_tpu_torch.nn.quantized import Quantizer

    dev = resolve_device(device)
    if dev.type == "cpu":
        vocab, embed_dim, layers, heads = 256, 64, 2, 4
        prompt_len, new_tokens = min(prompt_len, 16), min(new_tokens, 16)
        if speculative:
            speculative = min(speculative, layers - 1)
    if (speculative or spec_int8_draft) and int8:
        raise ValueError("speculative modes build their draft from the "
                         "float target; combine with --int8 is not "
                         "supported")
    if speculative and spec_int8_draft:
        raise ValueError("--speculative K and --speculative-int8 are "
                         "alternative draft choices; pick one")
    if speculative and speculative >= layers:
        raise ValueError(f"--speculative draft layers ({speculative}) must "
                         f"be < target layers ({layers})")
    spec = bool(speculative or spec_int8_draft)
    max_len = prompt_len + new_tokens + (spec_gamma if spec else 0)
    cfg = dict(embed_dim=embed_dim, num_heads=heads,
               num_kv_heads=num_kv_heads, max_len=max_len,
               use_rope=use_rope, seed=0, device=dev, dtype=dtype)
    model = TransformerLM(vocab, num_layers=layers, **cfg)
    model.evaluate()
    draft = None
    if speculative:
        # truncated-depth draft on the target's first K blocks and
        # embeddings: real acceptance rates without a trained draft
        draft = TransformerLM(vocab, num_layers=speculative, **cfg)
        draft.evaluate()
        tp = dict(model.named_parameters())
        with torch.no_grad():
            for name, p in draft.named_parameters():
                p.copy_(tp[name])
    elif spec_int8_draft:
        draft = Quantizer.quantize(model)
        draft.evaluate()
    if int8:
        model = Quantizer.quantize(model)
        model.evaluate()
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, vocab, (batch_size, prompt_len), device=dev,
                           generator=gen)
    clock = _Clock(dev)
    t0 = time.perf_counter()
    model.generate(prompt, new_tokens)
    clock.sync()
    warm_s = time.perf_counter() - t0
    with traced(profile_dir, dev, "decode"):
        clock.start()
        model.generate(prompt, new_tokens)
        elapsed_ms = clock.stop()
    # the prefill alone: the first token samples from the prefill's
    # logits, no decode step runs; the cache keeps the warm call's length
    clock.start()
    model.generate(prompt, 1, max_len=prompt_len + new_tokens,
                   host_loop=True)
    prefill_ms = clock.stop()
    tokens = batch_size * new_tokens
    s = {"model": "transformer_lm_decode", "int8": bool(int8),
         "batch_size": batch_size, "prompt_len": prompt_len,
         "new_tokens": new_tokens, "num_kv_heads": num_kv_heads or heads,
         "warmup_s": warm_s, "time_s": elapsed_ms / 1e3,
         "decode_tokens_per_sec": tokens / (elapsed_ms / 1e3),
         "prefill_tokens_per_sec": batch_size * prompt_len
         / max(prefill_ms / 1e3, 1e-9),
         "ms_per_token": elapsed_ms / tokens}
    if draft is not None:
        # the same tokens as greedy decoding; what changes is the number
        # of target forwards
        model.speculative_generate(prompt, new_tokens, draft=draft,
                                   gamma=spec_gamma)
        clock.start()
        _, st = model.speculative_generate(prompt, new_tokens, draft=draft,
                                           gamma=spec_gamma,
                                           return_stats=True)
        spec_ms = clock.stop()
        s.update({
            "speculative_draft_layers": speculative or "int8",
            "spec_gamma": spec_gamma,
            "spec_tokens_per_sec": tokens / (spec_ms / 1e3),
            "spec_rounds": st["rounds"],
            "spec_accept_rate": st["accept_rate"],
            "spec_vs_plain": elapsed_ms / spec_ms,
        })
    log(f"[perf] decode batch={batch_size} prompt={prompt_len} "
        f"new={new_tokens} on {_device_name(dev)}: "
        f"{s['decode_tokens_per_sec']:.0f} tokens/s decode, "
        f"{s['prefill_tokens_per_sec']:.0f} tokens/s prefill"
        + (f"; speculative {s['spec_tokens_per_sec']:.0f} tokens/s "
           f"({s['spec_vs_plain']:.2f}x, accept "
           f"{s['spec_accept_rate']:.0%})" if draft is not None else ""))
    return s


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


# the ImageNet normalization of the input-pipeline chain (JAX's constants)
PIPELINE_MEANS = [123.68, 116.779, 103.939]
PIPELINE_STDS = [58.393, 57.12, 57.375]


def run_input_pipeline_perf(batch_size: int = 64, n_records: int = 512,
                            image: int = 256, crop: int = 224,
                            depths=(0, 2, 4), shards: int = 4,
                            native_modes=(True, False), log=print,
                            device=DEFAULT_DEVICE) -> list:
    """Host input-pipeline throughput: records/s through
    ``RecordFileDataSet`` -> the ImageNet augment chain -> ``SampleToMiniBatch``
    -> the staging copy onto ``device`` (pinned and non-blocking on the
    card, synchronized per batch), without prefetch (depth 0) and through
    a prefetch thread of each depth. No model step runs: compare
    records/s with the images/s a train step consumes. ``n_records``
    random ``image``-square uint8 images are written to temporary shards
    first. The rows, in order:

    - the composed chain (RandomCrop + HFlip + ChannelNormalize) at each
      depth, for each ``native_modes`` entry: True reads through the C++
      reader, False through the Python pool;
    - the one-pass ``FusedCropFlipNormalize`` (flip_prob 1, the same
      semantics) through the C++ kernel at each depth, then through its
      numpy twin at each depth, read by the C++ reader when
      ``native_modes`` holds True, else by the Python pool;
    - the C++ kernel on ``min(4, cpus)`` workers at the deepest depth.

    Each row's ``native_reader`` and ``fused_augment`` say what actually
    ran (the reader's pool; every image through the C++ kernel), and
    ``asked`` what the row asked for; where the native runtime is not
    available the rows run on the Python paths and a log line gives the
    reason. Returns the rows."""
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.dataset.prefetch import prefetch, to_device
    from bigdl_tpu_torch.dataset.records import (RecordFileDataSet,
                                                 write_record_shards)
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
    from bigdl_tpu_torch.transform.vision import (ChannelNormalize,
                                                  FusedCropFlipNormalize,
                                                  HFlip, ImageFeature,
                                                  RandomCrop)

    dev = resolve_device(device)
    n_used = (n_records // batch_size) * batch_size
    results = []
    rng0 = np.random.RandomState(0)
    if not native.native_available():
        log(f"[pipeline] the native runtime is not available "
            f"({native.unavailable_reason()}): rows run on the Python "
            f"paths")
    with tempfile.TemporaryDirectory() as d:

        def gen():
            for i in range(n_records):
                img = rng0.randint(0, 255, (image, image, 3), np.uint8)
                yield Sample(img, np.array([1.0 + (i % 1000)], np.float32))

        write_record_shards(gen(), d, num_shards=shards)

        def stage(mb):
            return to_device(mb.get_input(), dev)

        def run_config(aug, depth, native_reader, workers=1):
            ds = RecordFileDataSet(d, num_shards=1, shard_id=0,
                                   native_reader=native_reader)

            def sample_stream():
                src = ds.data(train=True)
                feats = (ImageFeature(next(src).feature(), label=None,
                                      preserve_dtype=True)
                         for _ in range(n_used))
                for f in aug(feats):
                    yield Sample(f.image(), np.float32(1.0))

            batches = SampleToMiniBatch(batch_size)(sample_stream())
            it = (prefetch(batches, buffer_size=depth, transfer=stage)
                  if depth > 0 else (stage(b) for b in batches))
            t0 = time.perf_counter()
            seen = 0
            for x in it:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                seen += x.shape[0]
            elapsed = time.perf_counter() - t0
            fused = isinstance(aug, FusedCropFlipNormalize)
            kernel = fused and aug.native_images == seen
            row = {"mode": "input_pipeline",
                   "native_reader": ds.reader_pool == "native",
                   "fused_augment": kernel,
                   "augment": ("native kernel" if kernel else
                               "numpy one pass" if fused else "composed"),
                   "asked": {"native_reader": native_reader,
                             "native_augment": fused and aug.use_native},
                   "augment_workers": workers, "prefetch_depth": depth,
                   "batch_size": batch_size, "records": seen,
                   "image": image, "crop": crop, "device": str(dev),
                   "records_per_sec": seen / elapsed, "time_s": elapsed}
            results.append(row)
            log(f"[pipeline] reader={ds.reader_pool} "
                f"augment={row['augment']} workers={workers} depth={depth}: "
                f"{row['records_per_sec']:.0f} records/s")

        def fused(use_native, workers=1):
            return FusedCropFlipNormalize(crop, crop, PIPELINE_MEANS,
                                          PIPELINE_STDS, flip_prob=1.0,
                                          workers=workers,
                                          use_native=use_native)

        for native_reader in native_modes:
            for depth in depths:
                run_config(RandomCrop(crop, crop) >> HFlip()
                           >> ChannelNormalize(PIPELINE_MEANS, PIPELINE_STDS),
                           depth, native_reader)
        reader = any(native_modes)
        for use_native in (True, False):
            for depth in depths:
                run_config(fused(use_native), depth, reader)
        workers = min(4, os.cpu_count() or 1)
        if workers > 1:
            run_config(fused(True, workers), max(depths), reader, workers)
    return results


def _append_rows_to_history(rows) -> None:
    """Append result rows, each with a ``ts``, to the bench trend file:
    ``bench_history.jsonl`` in the working directory, or the file
    ``BIGDL_BENCH_HISTORY`` names (the JAX harness's contract). A file
    that cannot be written is skipped."""
    hist = (os.environ.get("BIGDL_BENCH_HISTORY")
            or os.path.join(os.getcwd(), "bench_history.jsonl"))
    try:
        with open(hist, "a") as f:
            for r in rows:
                f.write(json.dumps(dict(r, ts=time.time())) + "\n")
    except OSError:
        pass


def main(argv=None):
    """``python -m bigdl_tpu_torch.models.perf``: the JAX perf CLI's
    flags and errors (training by ``--model``, ``--decode``,
    ``--input-pipeline``) plus ``--device`` (default ``cuda``, which
    raises on a machine without a card; ``cpu`` for a smoke). Each run
    prints its JSON result on the last line: the decode row (with the
    device's name) and the input-pipeline rows are appended to the bench
    history as in JAX; the training summary is printed but not
    appended, as in JAX, where it is only logged. The JAX CLI's
    ``enable_persistent_cache()`` turns on XLA's compile cache; eager
    PyTorch compiles nothing, so it has no counterpart here."""
    import argparse

    p = argparse.ArgumentParser(
        description="bigdl_tpu_torch training perf (≙ DistriOptimizerPerf)")
    p.add_argument("--model", default="resnet50")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--format", default="NCHW", choices=["NCHW", "NHWC"])
    p.add_argument("--master-f32", action="store_true",
                   help="f32 master params + compute-dtype cast in-step")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the timed "
                        "loop into DIR")
    p.add_argument("--decode", action="store_true",
                   help="measure KV-cache decode tokens/sec instead of "
                        "training throughput (transformer only)")
    p.add_argument("--input-pipeline", action="store_true",
                   help="measure host feed records/sec (records -> "
                        "augments -> minibatch -> device copy), no model")
    p.add_argument("--int8", action="store_true",
                   help="--decode: post-training int8 weights")
    p.add_argument("--records", type=int, default=512,
                   help="--input-pipeline: records per config")
    p.add_argument("--prompt-len", type=int, default=128,
                   help="--decode: prompt length")
    p.add_argument("--new-tokens", type=int, default=128,
                   help="--decode: generated tokens per pass")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="--decode: also time greedy speculative decoding "
                        "with a K-layer truncated-depth draft (exact "
                        "tokens; reports accept rate + speedup)")
    p.add_argument("--spec-gamma", type=int, default=4,
                   help="--speculative: draft proposals per round")
    p.add_argument("--speculative-int8", action="store_true",
                   help="--decode: speculative decoding with the int8 "
                        "clone of the target as the draft")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    if args.decode and not args.input_pipeline:
        if args.model not in ("resnet50", "transformer", "transformer_lm"):
            p.error("--decode measures the transformer LM; --model does "
                    "not apply")
        if args.master_f32 or args.format != "NCHW":
            p.error("--decode takes --batch-size/--dtype/--prompt-len/"
                    "--new-tokens/--int8/--profile only")
        if args.new_tokens < 1 or args.prompt_len < 1:
            p.error("--prompt-len/--new-tokens must be >= 1")
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.input_pipeline:
        rows = run_input_pipeline_perf(batch_size=args.batch_size,
                                       n_records=args.records, device=dev)
        _append_rows_to_history(rows)
        print(json.dumps(rows))
        return
    if args.decode:
        s = run_decode_perf(batch_size=args.batch_size, dtype=dtype,
                            prompt_len=args.prompt_len,
                            new_tokens=args.new_tokens,
                            int8=args.int8, speculative=args.speculative,
                            spec_gamma=args.spec_gamma,
                            spec_int8_draft=args.speculative_int8,
                            profile_dir=args.profile, device=dev)
        s["device"] = _device_name(dev)
        _append_rows_to_history([s])
        print(json.dumps(s))
        return
    s = run_perf(args.model, args.batch_size, args.iterations, dtype=dtype,
                 format=args.format, master_f32=args.master_f32,
                 profile_dir=args.profile, device=dev)
    print(json.dumps(s))


if __name__ == "__main__":
    main()
