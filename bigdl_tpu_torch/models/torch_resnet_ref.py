"""Raw-torch ResNet-50 train step: the twin of
``bigdl_tpu/models/jax_resnet_ref.py``, the measured ``vs_baseline``
denominator of ``bench.py``.

A minimal ResNet-50 v1 written directly against ``torch`` and
``torch.nn.functional``, independent of ``bigdl_tpu_torch.nn``, so that
the port's ``run_perf("resnet50")`` can be held against raw PyTorch on
the same card, as the JAX benchmark holds the framework against raw
JAX: ``vs_ref = ours / (0.70 x ref)``.

Kept from the JAX step:

- the parameter list and the ``layout`` program that :func:`forward`
  interprets (same order and indices: a JAX ``init_params`` list carried
  across with ``utils.weights.resnet_ref_params_from_jax`` gives the same
  model); He-normal convolutions, BN gamma 1 / beta 0 with the third BN
  of every bottleneck at gamma 0, the head 0.01 x normal with a zero
  bias;
- NHWC activations: the input is (B, H, W, 3) and every activation is a
  channels-last NCHW view of the same memory, the convolution weights
  (stored OIHW here, HWIO in JAX) are channels-last too;
- XLA's SAME padding (odd pad element on the high side; written out
  with ``F.pad`` where it is not symmetric), max pooling 3 x 3 / 2 with
  SAME padding of -inf;
- BatchNorm on the batch's statistics (biased variance, eps 1e-3, no
  running statistics), the head on the spatial mean;
- the step: bf16 compute over f32 master parameters (``compute_dtype``),
  mean cross entropy over 0-based labels in f32, SGD with momentum 0.9
  (``vel = 0.9 vel + g``, ``p -= lr vel``), a functional update;
- :func:`run_ref_perf`'s timed-loop shape: batch 256 of 224 x 224
  images, 2 warm-up steps then 10 timed ones.

Timed with CUDA events on the card and the host clock on the CPU.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device

BLOCKS = (3, 4, 6, 3)  # ResNet-50


def init_params(generator: torch.Generator, num_classes: int = 1000,
                device=DEFAULT_DEVICE):
    """(params, layout): f32 parameters drawn from ``generator`` (a CPU
    generator) and moved to ``device``, in the JAX ``init_params``
    order, and the layer program :func:`forward` interprets."""
    dev = resolve_device(device)
    params = []

    def conv(kh, kw, cin, cout):
        std = (2.0 / (kh * kw * cin)) ** 0.5   # He normal (MSRA)
        w = std * torch.randn((cout, cin, kh, kw), generator=generator)
        params.append(w)
        return len(params) - 1

    def bn(c, zero_gamma=False):
        params.append(torch.zeros(c) if zero_gamma else torch.ones(c))
        params.append(torch.zeros(c))
        return len(params) - 2

    layout = [("conv", conv(7, 7, 3, 64), 2, "SAME"), ("bn", bn(64)),
              ("relu",), ("maxpool",)]
    cin = 64
    for stage, n_blocks in enumerate(BLOCKS):
        width = 64 * (2 ** stage)
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            proj = None
            if b == 0:
                proj = (conv(1, 1, cin, width * 4), bn(width * 4), stride)
            layout.append(("block",
                           conv(1, 1, cin, width), bn(width),
                           conv(3, 3, width, width), bn(width),
                           conv(1, 1, width, width * 4),
                           bn(width * 4, True), proj, stride))
            cin = width * 4
    params.append(0.01 * torch.randn((cin, num_classes), generator=generator))
    params.append(torch.zeros(num_classes))
    return [_place(p, dev) for p in params], layout


def _place(p: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A parameter on ``dev``; a convolution weight channels-last."""
    p = p.to(dev)
    if p.dim() == 4:
        p = p.contiguous(memory_format=torch.channels_last)
    return p


def _same(size: int, k: int, stride: int):
    """(low, high) padding of XLA's SAME rule along one dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh: int, kw: int, stride: int, value: float):
    """(input, symmetric padding) realizing SAME windows over NCHW ``x``:
    the padding is the op's own where it is symmetric, else written out
    with ``F.pad`` filled with ``value``."""
    ph = _same(x.shape[2], kh, stride)
    pw = _same(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def _conv2d(x, w, stride: int):
    x, pad = _pad_same(x, w.shape[2], w.shape[3], stride, 0.0)
    return F.conv2d(x, w, None, stride, pad)


def _bn(x, gamma, beta, eps: float = 1e-3):
    return F.batch_norm(x, None, None, gamma, beta, training=True,
                        momentum=0.0, eps=eps)


def forward(params, layout, x):
    """Logits (B, classes) of NHWC images ``x`` (B, H, W, 3)."""
    p = params
    x = x.permute(0, 3, 1, 2)            # a channels-last NCHW view

    def block(x, i1, ib1, i2, ib2, i3, ib3, proj, stride):
        y = F.relu(_bn(_conv2d(x, p[i1], 1), p[ib1], p[ib1 + 1]))
        y = F.relu(_bn(_conv2d(y, p[i2], stride), p[ib2], p[ib2 + 1]))
        y = _bn(_conv2d(y, p[i3], 1), p[ib3], p[ib3 + 1])
        if proj is not None:
            pc, pb, pstride = proj
            x = _bn(_conv2d(x, p[pc], pstride), p[pb], p[pb + 1])
        return F.relu(x + y)

    for op in layout:
        if op[0] == "conv":
            x = _conv2d(x, p[op[1]], op[2])
        elif op[0] == "bn":
            x = _bn(x, p[op[1]], p[op[1] + 1])
        elif op[0] == "relu":
            x = F.relu(x)
        elif op[0] == "maxpool":
            x, pad = _pad_same(x, 3, 3, 2, -float("inf"))
            x = F.max_pool2d(x, 3, 2, pad)
        elif op[0] == "block":
            x = block(x, *op[1:])
    x = x.mean((2, 3))
    return x @ p[-2].to(x.dtype) + p[-1].to(x.dtype)


def make_step(layout, lr: float = 0.01, momentum: float = 0.9,
              compute_dtype=torch.bfloat16):
    """``step(params, vel, x, y) -> (loss, params, vel)``: one SGD-momentum
    step of mean cross entropy over 0-based labels ``y``, computing in
    ``compute_dtype`` over the f32 ``params`` (the loss in f32, or in
    ``compute_dtype`` where that is wider); new lists are returned, the
    inputs are left as they were."""

    def step(params, vel, x, y):
        leaves = [w.detach().requires_grad_(True) for w in params]
        with torch.enable_grad():
            cparams = [w.to(compute_dtype) for w in leaves]
            logits = forward(cparams, layout, x.to(compute_dtype)).to(
                torch.promote_types(compute_dtype, torch.float32))
            loss = -torch.log_softmax(logits, -1).gather(
                1, y[:, None]).mean()
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            vel = torch._foreach_add(torch._foreach_mul(vel, momentum),
                                     grads)
            params = torch._foreach_add(params, vel, alpha=-lr)
        return loss.detach(), params, vel

    return step


def run_ref_perf(batch_size: int = 256, iterations: int = 10,
                 warmup: int = 2, log=print, image: int = 224,
                 device=DEFAULT_DEVICE) -> dict:
    """Records/s of the raw step at ``batch_size`` bf16 NHWC images of
    ``image`` x ``image`` (the JAX ``run_ref_perf``'s loop: ``warmup``
    steps, then ``iterations`` timed ones). Returns the JAX keys
    (``records_per_sec``, ``ms_per_iter``, ``warmup_s``, ``loss``,
    ``batch_size``, ``iterations``), unrounded, with the device and the
    timer."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    params, layout = init_params(gen, device=dev)
    vel = [torch.zeros_like(w) for w in params]
    x = torch.randn((batch_size, image, image, 3), generator=gen).to(
        dev, torch.bfloat16)
    y = torch.zeros((batch_size,), dtype=torch.long, device=dev)
    step = make_step(layout)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    for _ in range(max(1, warmup)):
        loss, params, vel = step(params, vel, x, y)
    sync()
    warmup_s = time.perf_counter() - t0
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iterations):
        loss, params, vel = step(params, vel, x, y)
    if on_card:
        end.record()
    sync()
    elapsed_ms = (start.elapsed_time(end) if on_card
                  else (time.perf_counter() - t0) * 1e3)
    out = {"records_per_sec": batch_size * iterations / (elapsed_ms / 1e3),
           "ms_per_iter": elapsed_ms / iterations, "warmup_s": warmup_s,
           "loss": float(loss), "batch_size": batch_size,
           "iterations": iterations,
           "device": (torch.cuda.get_device_name(dev) if on_card
                      else "cpu"),
           "timer": "cuda_events" if on_card else "host_clock"}
    log(f"[ref-torch] resnet50 batch={batch_size} on {out['device']}: "
        f"{out['records_per_sec']:.1f} records/s")
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args()
    run_ref_perf(args.batch_size, args.iterations, device=args.device)
