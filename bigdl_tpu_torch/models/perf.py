"""Synthetic-data training throughput and the host input pipeline (port
of ``build_model``, ``run_perf``, ``_transformer_perf`` and
``run_input_pipeline_perf`` in ``bigdl_tpu/models/perf.py``).

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
its device; a CPU time says nothing about the card). ``profile``, the
twin of the JAX harness's ``profile_dir``, is called after the timed
steps with a function that runs one more step, and its result is kept
in the summary (``chip_smoke.py`` passes
``bigdl_tpu_torch.utils.profiling.device_profile``).

:func:`run_input_pipeline_perf` measures the feed side alone: records/s
from TFRecord shards through the ImageNet augment chain (composed, or
the one-pass ``FusedCropFlipNormalize``), ``SampleToMiniBatch`` and the
staging copy onto the device, at several prefetch depths. The JAX
harness's native-reader rows wait for the C++ reader (ROADMAP.md, Queue
1 item 12): the function logs that they did not run and returns no row
for them.
"""

from __future__ import annotations

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
            return transformer_perf(batch_size, iterations, warmup, dtype,
                                    log=log, master_f32=master_f32,
                                    profile=profile, device=dev)
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
                     warmup, dev)
    s = {"model": model_name, "batch_size": batch_size,
         "iterations": iterations,
         "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
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
                     device=DEFAULT_DEVICE) -> dict:
    """Tokens/s of the train step on one random (batch_size, seq_len)
    batch, computing in ``dtype`` over f32 parameters (or, without
    ``master_f32``, over parameters stored in ``dtype``). Returns the
    summary: ``records_per_sec`` (tokens/s), ``ms_per_iter``, ``loss``
    (last step), ``losses`` (every step, warm-up included),
    ``flops_per_iter`` (3 x the model's analytic forward FLOPs,
    ``flops_source`` "analytic") and the device it ran on."""
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


# the ImageNet normalization of the input-pipeline chain (JAX's constants)
PIPELINE_MEANS = [123.68, 116.779, 103.939]
PIPELINE_STDS = [58.393, 57.12, 57.375]


def run_input_pipeline_perf(batch_size: int = 64, n_records: int = 512,
                            image: int = 256, crop: int = 224,
                            depths=(0, 2, 4), shards: int = 4,
                            native_modes=(True, False), log=print,
                            device=DEFAULT_DEVICE) -> list:
    """Host input-pipeline throughput: records/s through
    ``RecordFileDataSet`` -> the ImageNet augment chain (RandomCrop +
    HFlip + ChannelNormalize; then the one-pass ``FusedCropFlipNormalize``
    with the same semantics, flip_prob 1, serially and on up to 4
    workers) -> ``SampleToMiniBatch`` -> the staging copy onto
    ``device`` (pinned and non-blocking on the card, synchronized per
    batch), without prefetch (depth 0) and through a prefetch thread of
    each depth. No model step runs: compare records/s with the images/s
    a train step consumes. ``n_records`` random ``image``-square uint8
    images are written to temporary shards first. A ``native_modes``
    entry True asks for the C++ reader and fused kernel, which wait for
    ROADMAP.md Queue 1 item 12: it is logged as not run and gives no
    row. Returns one dict per configuration run."""
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
    if any(native_modes):
        log("[pipeline] the native reader and fused kernel wait for "
            "ROADMAP.md Queue 1 item 12: their rows did not run")
    with tempfile.TemporaryDirectory() as d:

        def gen():
            for i in range(n_records):
                img = rng0.randint(0, 255, (image, image, 3), np.uint8)
                yield Sample(img, np.array([1.0 + (i % 1000)], np.float32))

        write_record_shards(gen(), d, num_shards=shards)

        def sample_stream(aug):
            src = RecordFileDataSet(d, num_shards=1, shard_id=0).data(
                train=True)
            feats = (ImageFeature(next(src).feature(), label=None,
                                  preserve_dtype=True)
                     for _ in range(n_used))
            for f in aug(feats):
                yield Sample(f.image(), np.float32(1.0))

        def stage(mb):
            return to_device(mb.get_input(), dev)

        def run_config(aug, depth, fused, workers=1):
            batches = SampleToMiniBatch(batch_size)(sample_stream(aug))
            it = (prefetch(batches, buffer_size=depth, transfer=stage)
                  if depth > 0 else (stage(b) for b in batches))
            t0 = time.perf_counter()
            seen = 0
            for x in it:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                seen += x.shape[0]
            elapsed = time.perf_counter() - t0
            row = {"mode": "input_pipeline", "native_reader": False,
                   "fused_augment": fused,
                   "augment": "numpy one pass" if fused else "composed",
                   "augment_workers": workers, "prefetch_depth": depth,
                   "batch_size": batch_size, "records": seen,
                   "image": image, "crop": crop, "device": str(dev),
                   "records_per_sec": seen / elapsed, "time_s": elapsed}
            results.append(row)
            log(f"[pipeline] fused={fused} workers={workers} depth={depth}: "
                f"{row['records_per_sec']:.0f} records/s")

        for depth in depths:
            run_config(RandomCrop(crop, crop) >> HFlip()
                       >> ChannelNormalize(PIPELINE_MEANS, PIPELINE_STDS),
                       depth, fused=False)
        for depth in depths:
            run_config(FusedCropFlipNormalize(crop, crop, PIPELINE_MEANS,
                                              PIPELINE_STDS, flip_prob=1.0),
                       depth, fused=True)
        workers = min(4, os.cpu_count() or 1)
        if workers > 1:
            run_config(FusedCropFlipNormalize(crop, crop, PIPELINE_MEANS,
                                              PIPELINE_STDS, flip_prob=1.0,
                                              workers=workers),
                       max(depths), fused=True, workers=workers)
    return results
