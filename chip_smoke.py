#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's inference path on the card at the full width of the
serving flagship (TransformerLM vocab 32000, embed 512, 8 heads, 2 kv
heads, 8 layers, RoPE, flash on; random weights from a seed) and its
training path at the full width of the training flagship (vocab 32000,
embed 512, 8 heads, 8 layers, learned positions, batch 32 x 1024
tokens, bf16 compute over f32 masters, SGD, flash on), and fails, with
a non-zero exit, at the first phase that does not hold:

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, TF32;
2. build: the CUDA kernel library compiled from
   ``bigdl_tpu_torch/ops/csrc`` with ``nvcc`` for sm_90a, with the
   compiler's register/spill report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes of the main path and its edge cases, out and lse, with the
   stated tolerances (shown, at the flagship shape, to reject an output
   that dropped one kv tile), at the edges of its tiling, and timed beside
   its bound and a PyTorch library call: ``kernel_ms`` / ``library_ms``
   by CUDA events around eager calls, ``device_ms`` /
   ``library_device_ms`` by CUDA-graph replay (the card's time alone);
   then a sweep of t = tk from 512 to 8192 at the flagship width (kernel,
   library and bound ms, share of the bound);
4. scoring: the flagship forward in bf16 over 4 x 2048 tokens launches
   the flash kernel once per layer and agrees with the dense path;
5. generate: greedy generation of 64 tokens for 8 prompts of 256 tokens,
   checked by teacher forcing through the flash forward;
6. server: ``GenerationService`` answers 8 concurrent mixed-length
   requests, each row equal to a lone ``generate`` in f32 with TF32 off;
7. flash_backward: the differentiable flash attention (the kernel's
   forward, the plain blocked backward) against the plain forward (out
   and lse) and autograd through it (dq / dk / dv and the lse
   cotangent), at the training shape (on views of a fused qkv
   projection, as the model passes them) and its edge cases; the
   backward timed beside SDPA's backward and its bound;
8. train: ``transformer_perf`` at the training flagship (ms/step,
   tokens/s, analytic MFU, the loss of every step, 8 kernel launches a
   step; a remat step launches 16), a ``torch.profiler`` pass over one
   step, and at batch 4 in f32 with TF32 off the flash path's gradients
   against the dense path's, then f32 SGD steps that lower the loss;
9. the kernels line: one JSON object with each kernel's launches on the
   main paths (phases 4-6, and the timed bf16 training run of phase 8,
   each counted from 0 just before it and read just after; the remat
   run and the f32 gate are counted on their own lines), error, times
   and bound.

Before the kernels line, the vision path (ResNet-50 at full width and
depth, LeNet-5, the LocalOptimizer), which launches no kernel of the
port: its convolutions, BatchNorm and pooling are XLA ops in the JAX
package and torch ops here.

- vision_gate: f32 with TF32 off for matmul and cuDNN, ResNet-50 NHWC
  and NCHW on shared weights with random BN affine and statistics; the
  eval logits at batch 2 agree with each other and with the port's CPU
  forward, and one training ``TrainStep`` at batch 4 on the card (NHWC)
  agrees with the same step on the CPU (NCHW): parameter updates and
  new running statistics, which must have moved;
- vision_train: ``run_perf("resnet50")`` at batch 256, NHWC, bf16 over
  f32 masters, as ``bench.py`` sets it up: ms/step, images/s, peak
  memory, analytic MFU, the loss of every step; then a
  ``torch.profiler`` pass over one step (vision_profile);
- vision_eval: the ``entry()`` twin, ResNet-50 eval forward in f32 at
  batch 8 NCHW, and in bf16 NHWC at batch 256 (checked at its first 8
  images against the f32 model), images/s;
- local_optimizer: ``LocalOptimizer`` trains LeNet-5 for one epoch over
  4096 synthetic samples at batch 128 with a Top1Accuracy validation at
  the end of the epoch (the loss falls), then a bf16 ResNet-50 NHWC
  (f32 BN statistics) for 8 iterations at batch 64 from 224 x 224
  samples staged through the prefetch thread (the records/s the loop
  logs; the parameters and statistics it writes back must have moved);
  beside it, where a loop step's time goes: the host side of the data
  path per batch, the same step without the loop, and ``run_perf`` at
  batch 64 with one profiled step.

Earlier lines are one JSON object each; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
CUDA is not available or the port cannot be imported.
"""

from __future__ import annotations

import json
import logging
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 on
# CUDA cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(vocab_size=32000, embed_dim=512, num_heads=8,
                num_kv_heads=2, num_layers=8, max_len=2048, use_rope=True,
                use_flash=True)

# kernel vs plain version: an element may be off by rtol times the sum of
# its own |ref| and the RMS of its reference row. The row term scales the
# absolute allowance to what that row holds: a row averaging n keys has an
# output RMS of about sqrt(e/n), 0.036 at n = 2048, so a fixed atol would
# hide errors of that size in late rows. bf16 outputs round to 8 bits of
# mantissa and the kernel rounds P to bf16 for the tensor cores; f32 as the
# JAX flash test; lse is f32 math on both sides
RTOL = {"bfloat16": 2e-2, "float32": 2e-4}
LSE_ATOL = 1e-4
# model-level bf16 agreement (flash vs dense path, decode vs teacher-forced
# forward): max |diff| relative to the largest |logit|
LOGIT_RTOL = 5e-2
# the training flagship of the JAX package (models/perf.py:79-149)
TRAIN = dict(vocab=32000, embed_dim=512, layers=8, heads=8, seq_len=1024)
TRAIN_BATCH = 32
# the flash gradient against autograd through the plain forward: each
# gradient row (over the head dim) may be off, in L2 norm, by rtol times
# the sum of its reference row's norm and the RMS of all the reference's
# row norms. Rows, not elements: the backward forms D = rowsum(dO * O)
# from the bf16 output the kernel normalized with f32 sums of unrounded
# P, as every flash backward does, where autograd differentiates the
# unrounded function; in rows that see few keys dP - D cancels and that
# rounding leaves an error of the size of a typical gradient entry in a
# row near 0, whose largest element over millions of rows is an extreme
# value (an element-wise form, rtol * (|ref| + RMS of the row + RMS of
# the gradient), read 1.34 at B = 32 on the card where B = 4 passed).
# Shown, at the training shape, to reject a gradient whose reference
# dropped one 64-key V tile
BWD_RTOL = {"bfloat16": 5e-2, "float32": 2e-4}
# f32 flash vs dense model gradients, TF32 off: per leaf, max |diff| over
# the leaf's max |dense grad| (the kernel's f32 sums run in another order)
GRAD_RTOL = 1e-3
# flash backward edge cases beside the training shape: (B, H, H_kv, t, tk,
# d), causal, dtype: GQA, t < tk, dead rows (t > tk), a ragged length,
# non-causal with t != tk, f32
BWD_CASES = [
    ((4, 8, 2, 512, 512, 64), True, "bfloat16"),
    ((2, 8, 2, 256, 1024, 64), True, "bfloat16"),
    ((2, 8, 2, 512, 256, 64), True, "bfloat16"),
    ((2, 8, 2, 1000, 1000, 64), True, "bfloat16"),
    ((2, 8, 2, 300, 700, 64), False, "bfloat16"),
    ((2, 8, 8, 512, 512, 64), True, "float32"),
]
# the vision path's f32 gate (TF32 off): logits of the card's NHWC and
# NCHW forwards and of the CPU's may differ by this much of the largest
# |logit| (cuDNN picks its own f32 algorithms and sum orders; H100 runs
# read 2.2e-7 to 3.3e-7), and the loss of a training step by this much
# of its value
VISION_RTOL = 1e-5
# the update of one f32 training step at batch 4 (all parameters as one
# vector): ||d_card - d_cpu|| / ||d_cpu||. The step is ill-conditioned:
# 53 training-mode BNs over 4 images amplify rounding, so the same step
# in the NCHW and NHWC layouts, both on the CPU, differs by about 1.4e-2
# in this norm; a wrong layer gives an error of order 1
UPDATE_RTOL = 5e-2
# new running statistics: max |diff| over the leaf's largest |value|
# (H100 runs read 1.13e-6)
STATS_RTOL = 1e-5
# ResNet-50 at 224 x 224: forward FLOPs per image (bench.py:25), x 3 for
# a training step (bench.py:26)
RESNET50_TRAIN_FLOPS = 4.09e9 * 3.0
VISION_BATCH = 256
# the bf16 eval forward against the f32 one on the same weights
EVAL_BF16_RTOL = 5e-2

# the flash kernel's flagship kernel_ms before its redesign for Hopper
# (the WMMA version, H100 80GB HBM3 at 700 W): a constant from PERF.md,
# printed for comparison and never measured here
PRIOR_MS = 0.381


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` in ms, called eagerly with an event
    recorded before and after each call (events and stream fetched before
    the loop): where the host takes longer to issue a call than the card
    to run it, this is the host's time."""
    for _ in range(warmup):
        fn()
    stream = torch.cuda.current_stream()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in pairs:
        s.record(stream)
        fn()
        e.record(stream)
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def graph_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """The card's time for one call of ``fn`` in ms: ``calls`` calls
    captured in one CUDA graph, the median replay time over ``calls``, so
    no host time between launches is counted."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    g.replay()
    times = []
    for _ in range(replays):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / calls)
    del g
    return statistics.median(times)


def flash_bound(b, h, h_kv, t, tk, d, dtype: str, causal: bool):
    """(least ms on an H100, "operations" or "bytes"): the two products
    over the (row, key) pairs this mask keeps, against each input read
    once and each output written once."""
    off = tk - t
    pairs = (sum(max(0, min(tk, r + off + 1)) for r in range(t))
             if causal else t * tk)
    flops = 4 * d * pairs * b * h
    esz = 2 if dtype == "bfloat16" else 4
    nbytes = esz * (2 * b * h * t * d + 2 * b * h_kv * tk * d) + 4 * b * h * t
    ms_ops = flops / PEAK_FLOPS[dtype] * 1e3
    ms_bytes = nbytes / PEAK_BYTES * 1e3
    return max(ms_ops, ms_bytes), ("operations" if ms_ops >= ms_bytes
                                   else "bytes")


def tol_excess(torch, out, ref, rtol: float) -> float:
    """The largest |out - ref| / (rtol * (|ref| + RMS of ref's row)) over
    the elements: the check passes below 1. A row of zeros (a dead row)
    allows no error at all."""
    o, r = out.float(), ref.float()
    allow = rtol * (r.abs() + r.pow(2).mean(-1, keepdim=True).sqrt())
    err = (o - r).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
    return ratio.max().item()


def grad_excess(torch, grad, ref, rtol: float) -> float:
    """The largest ||grad row - ref row|| / (rtol * (||ref row|| + RMS of
    ref's row norms)) over the rows (the last dim): the check passes
    below 1."""
    ref_norm = ref.float().norm(dim=-1)
    err = (grad.float() - ref.float()).norm(dim=-1)
    allow = rtol * (ref_norm + ref_norm.pow(2).mean().sqrt())
    ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
    return ratio.max().item()


def check_flash(torch, fa, shape, causal, dtype, with_library,
                mutant=False):
    """The kernel against its plain version at one shape, timed. With
    ``mutant``, also shows that the tolerance rejects an output whose
    64-key V tile at tk/2 was dropped (the plain version run on V with
    that tile zeroed)."""
    b, h, h_kv, t, tk, d = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = (torch.randn(sz, device="cuda", generator=g).to(dtype)
               for sz in ((b, h, t, d), (b, h_kv, tk, d), (b, h_kv, tk, d)))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    name = str(dtype).replace("torch.", "")
    rtol = RTOL[name]
    err = (out.float() - ref_out.float()).abs()
    excess = tol_excess(torch, out, ref_out, rtol)
    dead = ref_lse <= fa.NEG_INF / 2
    lse_err = (lse - ref_lse)[~dead].abs().max().item() if (~dead).any() \
        else 0.0
    assert excess <= 1.0, (shape, name, causal, err.max().item(), excess)
    assert torch.equal(lse <= fa.NEG_INF / 2, dead), "dead rows differ"
    assert (out.float()[dead.unsqueeze(-1).expand_as(out)] == 0).all()
    assert lse_err <= LSE_ATOL, (shape, lse_err)
    mutant_excess = None
    if mutant:
        v_bad = v.clone()
        v_bad[:, :, tk // 2:tk // 2 + fa.BLOCK_K] = 0
        bad_out, _ = fa.flash_attention_reference(q, k, v_bad, causal)
        mutant_excess = tol_excess(torch, bad_out, ref_out, rtol)
        assert mutant_excess > 1.0, ("the tolerance passes an output that "
                                     "dropped a kv tile", mutant_excess)
        del v_bad, bad_out
    def kernel():
        return fa.flash_attention_with_lse(q, k, v, causal)

    ms, device_ms = time_ms(torch, kernel), graph_ms(torch, kernel)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, causal), warmup=1, iters=5)
    library_ms = library_device_ms = None
    if with_library:
        import torch.nn.functional as F

        # top-left causal alignment equals the port's last-query alignment
        # only at t == tk; timed as a yardstick, never called by the port
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)

        library_ms = time_ms(torch, library)
        library_device_ms = graph_ms(torch, library)
    bound_ms, bound_by = flash_bound(b, h, h_kv, t, tk, d, name, causal)
    rec = {"phase": "kernel", "kernel": "flash_attention_fwd",
           "shape": {"B": b, "H": h, "H_kv": h_kv, "t": t, "tk": tk,
                     "d": d},
           "dtype": name, "causal": causal,
           "max_abs_err": err.max().item(),
           "median_abs_ref": ref_out.float().abs().median().item(),
           "tol": {"rtol": rtol, "allowance": "rtol*(|ref|+rms(ref row))"},
           "max_err_over_tol": excess,
           "dropped_tile_err_over_tol": mutant_excess,
           "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL,
           "dead_rows": int(dead.sum()), "kernel_ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_device_ms": library_device_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    return rec


def flash_bwd_bound(b, h, h_kv, t, tk, d, dtype: str, causal: bool):
    """(least ms on an H100, "operations" or "bytes") of the backward:
    five products (S again, dP, dQ, dK, dV) over the kept (row, key)
    pairs, against q, k, v, out, dout and lse read once and dq, dk, dv
    written once."""
    off = tk - t
    pairs = (sum(max(0, min(tk, r + off + 1)) for r in range(t))
             if causal else t * tk)
    flops = 10 * d * pairs * b * h
    esz = 2 if dtype == "bfloat16" else 4
    nbytes = (esz * (4 * b * h * t * d + 4 * b * h_kv * tk * d)
              + 4 * b * h * t)
    ms_ops = flops / PEAK_FLOPS[dtype] * 1e3
    ms_bytes = nbytes / PEAK_BYTES * 1e3
    return max(ms_ops, ms_bytes), ("operations" if ms_ops >= ms_bytes
                                   else "bytes"), flops


def check_flash_backward(torch, fa, shape, causal, dtype, with_lse,
                         timed=False, fused=False):
    """The Function's forward (out and lse, against the plain forward)
    and gradients (kernel forward, blocked backward, against autograd
    through the plain forward) for dq, dk, dv, with the lse cotangent
    when ``with_lse``; with ``fused``, q, k and v are strided views of one
    (B, t, (H + 2·H_kv)·d) projection, as ``MultiHeadAttention`` passes
    them; with ``timed``, the backward's time beside SDPA's and its
    bound."""
    import torch.nn.functional as F

    b, h, h_kv, t, tk, d = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + 1)
    if fused:
        assert t == tk, shape
        qkv = torch.randn((b, t, (h + 2 * h_kv) * d), device="cuda",
                          generator=g).to(dtype).requires_grad_(True)
        cuts = (0, h * d, (h + h_kv) * d, (h + 2 * h_kv) * d)
        q, k, v = (qkv[..., lo:hi].unflatten(-1, (-1, d)).transpose(1, 2)
                   for lo, hi in zip(cuts, cuts[1:]))
        assert not q.is_contiguous()
    else:
        q, k, v = (torch.randn(sz, device="cuda", generator=g).to(dtype)
                   .requires_grad_(True)
                   for sz in ((b, h, t, d), (b, h_kv, tk, d),
                              (b, h_kv, tk, d)))
    d_out = torch.randn((b, h, t, d), device="cuda", generator=g).to(dtype)
    d_lse = torch.randn((b, h, t), device="cuda", generator=g)
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    assert fa.launches == before + 1 and out.grad_fn is not None
    outs, cots = ((out, lse), (d_out, d_lse)) if with_lse else \
        ((out,), (d_out,))
    grads = torch.autograd.grad(outs, (q, k, v), cots)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref_out, ref_lse = fa.flash_attention_reference(qr, kr, vr, causal)
    ref = torch.autograd.grad((ref_out, ref_lse)[:len(outs)], (qr, kr, vr),
                              cots)
    name = str(dtype).replace("torch.", "")
    # the forward the backward starts from, held as phase 3 holds it
    out_excess = tol_excess(torch, out.detach(), ref_out.detach(),
                            RTOL[name])
    dead = ref_lse <= fa.NEG_INF / 2
    lse_err = ((lse - ref_lse).detach()[~dead].abs().max().item()
               if (~dead).any() else 0.0)
    assert out_excess <= 1.0, (shape, name, "out", out_excess)
    assert torch.equal(lse <= fa.NEG_INF / 2, dead), "dead rows differ"
    assert lse_err <= LSE_ATOL, (shape, name, "lse", lse_err)
    rtol = BWD_RTOL[name]
    excess = {f"d{n}": grad_excess(torch, a, r, rtol)
              for n, a, r in zip("qkv", grads, ref)}
    errs = {f"d{n}": (a.float() - r.float()).abs().max().item()
            for n, a, r in zip("qkv", grads, ref)}
    assert all(a.dtype == x.dtype and a.shape == x.shape
               for a, x in zip(grads, (q, k, v)))
    assert max(excess.values()) <= 1.0, (shape, name, errs, excess)
    mutant = None
    if timed:
        # the reference with one 64-key V tile zeroed must fail the check
        v_bad = vr.detach().clone()
        v_bad[:, :, tk // 2:tk // 2 + fa.BLOCK_K] = 0
        qb, kb, vb = (x.detach().clone().requires_grad_(True)
                      for x in (qr, kr, v_bad))
        bad = torch.autograd.grad(
            fa.flash_attention_reference(qb, kb, vb, causal)[:len(outs)],
            (qb, kb, vb), cots)
        mutant = {f"d{n}": grad_excess(torch, a, r, rtol)
                  for n, a, r in zip("qk", bad, ref)}
        assert min(mutant.values()) > 1.0, ("the tolerance passes a "
                                            "gradient that dropped a kv "
                                            "tile", mutant)
        del v_bad, qb, kb, vb, bad
    del ref, qr, kr, vr, ref_out, ref_lse
    rec = {"phase": "flash_backward",
           "shape": {"B": b, "H": h, "H_kv": h_kv, "t": t, "tk": tk,
                     "d": d}, "dtype": name, "causal": causal,
           "inputs": ("views of a fused qkv projection" if fused
                      else "contiguous"),
           "lse_cotangent": with_lse,
           "out_err_over_tol": out_excess, "out_rtol": RTOL[name],
           "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL,
           "max_abs_err": errs, "max_err_over_tol": excess,
           "tol": {"rtol": rtol, "allowance": "per row: ||err|| <= rtol*("
                   "||ref row||+rms of ref row norms)",
                   "reference": "autograd through flash_attention_reference"},
           "dropped_tile_err_over_tol": mutant}
    if timed:
        scale = 1.0 / d ** 0.5
        q0, k0, v0 = q.detach(), k.detach(), v.detach()
        o0, l0 = out.detach(), lse.detach()

        def plain_backward():
            return fa.flash_attention_backward_reference(
                q0, k0, v0, o0, l0, d_out, causal, scale)

        rec["backward_ms"] = time_ms(torch, plain_backward, 1, 5)
        torch.backends.cuda.matmul.allow_tf32 = True
        rec["backward_tf32_ms"] = time_ms(torch, plain_backward, 1, 5)
        torch.backends.cuda.matmul.allow_tf32 = False
        # leaves over the same (strided) storage, so that every timed
        # graph starts at its inputs
        qkv_in = tuple(x.detach().requires_grad_(True) for x in (q, k, v))
        rec["fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            fa.flash_attention(*qkv_in, causal), qkv_in, d_out), 1, 5)
        so = F.scaled_dot_product_attention(*qkv_in, is_causal=causal,
                                            enable_gqa=True)
        rec["sdpa_backward_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            so, qkv_in, d_out, retain_graph=True))
        rec["sdpa_fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*qkv_in, is_causal=causal,
                                           enable_gqa=True), qkv_in,
            d_out))
        bound, by, flops = flash_bwd_bound(b, h, h_kv, t, tk, d, name,
                                           causal)
        rec.update(backward_bound_ms=bound, backward_bound_by=by,
                   backward_flops=flops,
                   backward_share_of_bound=bound / rec["backward_ms"],
                   timing="median CUDA-event interval around eager calls; "
                          "backward_ms with TF32 off, as every f32 product "
                          "of this run; library calls timed only")
    emit(rec)


def flash_backward_phase(torch, fa) -> None:
    """Phase 7: the Function against autograd through the plain forward
    at the training shape (timed, on the main path's inputs and
    cotangent: views of the fused projection, out only; then contiguous,
    with the lse cotangent) and at ``BWD_CASES``. The backward is not a
    kernel: its times stay on the ``flash_backward`` line."""
    b, h, t = TRAIN_BATCH, TRAIN["heads"], TRAIN["seq_len"]
    shape = (b, h, h, t, t, TRAIN["embed_dim"] // h)
    check_flash_backward(torch, fa, shape, True, torch.bfloat16,
                         with_lse=False, timed=True, fused=True)
    check_flash_backward(torch, fa, shape, True, torch.bfloat16,
                         with_lse=True)
    for shape, causal, dtype in BWD_CASES:
        check_flash_backward(torch, fa, shape, causal,
                             getattr(torch, dtype), with_lse=True)


def train_phase(torch, fa, smi) -> int:
    """Phase 8: the training flagship through ``transformer_perf``, a
    remat step, a profile of one step, and the f32 gate at batch 4;
    returns the bf16 kernel launches of the timed flagship run (warm-up,
    timed and profiled steps), counted from 0 just before it."""
    from bigdl_tpu_torch.models.perf import LMLoss, transformer_perf
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.optim import SGD, make_train_step
    from bigdl_tpu_torch.utils.profiling import device_profile

    bf16, f32 = torch.bfloat16, torch.float32
    # bf16 compute over f32 masters, through the train step: every step
    # launches the kernel once per layer
    warm, steps = 2, 5
    fa.launches = 0
    perf = transformer_perf(TRAIN_BATCH, steps, warm, bf16,
                            log=lambda *_: None, device="cuda",
                            profile=lambda fn: device_profile(fn, top=20),
                            **TRAIN)
    train_launches = fa.launches
    per_step = TRAIN["layers"]
    assert train_launches == per_step * (warm + steps + 1), train_launches
    assert all(map(math.isfinite, perf["losses"])), perf["losses"]
    prof = perf.pop("profile")
    mfu = perf["flops_per_iter"] / (perf["ms_per_iter"] / 1e3) \
        / PEAK_FLOPS["bfloat16"]
    # a remat run (one warm-up, one timed step): the recompute launches
    # the kernel again, counted on its own
    fa.launches = 0
    remat = transformer_perf(TRAIN_BATCH, 1, 1, bf16, log=lambda *_: None,
                             remat=True, device="cuda", **TRAIN)
    remat_launches = fa.launches
    remat_per_step = remat_launches // 2
    assert remat_per_step == 2 * per_step, remat_per_step
    assert all(map(math.isfinite, remat["losses"])), remat["losses"]
    emit({"phase": "train", "config": {**TRAIN, "batch": TRAIN_BATCH,
                                       "compute_dtype": "bfloat16",
                                       "masters": "float32",
                                       "optimizer": "SGD(0.01)",
                                       "use_flash": True},
          "nvidia_smi": smi, "warmup_steps": warm, "timed_steps": steps,
          "ms_per_step": perf["ms_per_iter"],
          "tokens_per_s": perf["records_per_sec"],
          "losses": perf["losses"],
          "analytic_flops_per_step": perf["flops_per_iter"],
          "analytic_mfu": mfu, "mfu_peak": "989 TFLOP/s bf16 (H100 SXM)",
          "flash_launches": train_launches,
          "flash_launches_per_step": per_step,
          "remat_ms_per_step": remat["ms_per_iter"],
          "remat_flash_launches": remat_launches,
          "remat_flash_launches_per_step": remat_per_step,
          "timer": perf["timer"]})
    emit({"phase": "train_profile", "window": "one flagship train step",
          **prof})

    # the gate: f32, TF32 off, at batch 4 on the same weights and batch,
    # the flash path's gradients equal the dense path's; then f32 SGD
    # steps of the flash path lower the loss
    model = TransformerLM(TRAIN["vocab"], TRAIN["embed_dim"],
                          TRAIN["heads"], TRAIN["layers"], TRAIN["seq_len"],
                          use_flash=True, seed=0, device="cuda", dtype=f32)
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, TRAIN["vocab"], (4, TRAIN["seq_len"]),
                        device="cuda", generator=g)
    crit = LMLoss(TRAIN["vocab"])

    def model_grads(flash: bool):
        for blk in model.blocks():
            blk.attn.use_flash = flash
        model.zero_grad(set_to_none=True)
        loss = crit.forward(model(ids), ids)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}

    # the f32 kernel (the CUDA-core loop, not the bf16 wgmma kernel of the
    # timed path), counted on its own
    fa.launches = 0
    loss_flash, g_flash = model_grads(True)
    assert fa.launches == TRAIN["layers"], fa.launches
    loss_dense, g_dense = model_grads(False)
    model.zero_grad(set_to_none=True)
    leaf_rel = {n: ((g_flash[n] - g_dense[n]).abs().max()
                    / g_dense[n].abs().max()).item() for n in g_dense}
    worst = max(leaf_rel, key=leaf_rel.get)
    del g_flash, g_dense
    for blk in model.blocks():
        blk.attn.use_flash = True
    ts = make_train_step(model, crit, SGD(learning_rate=0.01))
    params, slots = model.params_dict(), ts.init_slots(model.params_dict())
    f32_losses = []
    for _ in range(4):
        loss, params, _, slots = ts.step(params, {}, slots, ids, ids,
                                         ts.current_lrs(), None)
        f32_losses.append(loss.item())
    gate_launches = fa.launches
    emit({"phase": "train_gate", "batch": 4, "dtype": "float32",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "loss_flash": loss_flash, "loss_dense": loss_dense,
          "grad_max_rel_diff": leaf_rel[worst], "worst_leaf": worst,
          "grad_rtol": GRAD_RTOL,
          "tol": "per leaf: max|g_flash - g_dense| / max|g_dense|",
          "sgd_f32_losses": f32_losses,
          "f32_flash_launches": gate_launches})
    assert leaf_rel[worst] <= GRAD_RTOL, (worst, leaf_rel[worst])
    assert abs(loss_flash - loss_dense) <= 1e-4 * abs(loss_dense)
    assert all(b < a for a, b in zip(f32_losses, f32_losses[1:])), \
        f32_losses
    assert gate_launches == TRAIN["layers"] * (1 + len(f32_losses)), \
        gate_launches
    return train_launches


def rel_diff(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def randomize_bn(torch, model, seed: int) -> None:
    """Random gamma, beta, running mean and variance in every BN of
    ``model``: the zero gamma of each bottleneck's last BN would make
    every residual branch 0 and hide its convolutions from the checks."""
    from bigdl_tpu_torch.nn import SpatialBatchNormalization

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SpatialBatchNormalization):
                n = m.n_output
                m.weight.copy_(torch.rand(n, generator=g) * 0.4 + 0.1)
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean = 0.1 * torch.randn(n, generator=g).to(
                    m.running_mean.device)
                m.running_var = (torch.rand(n, generator=g) * 1.5 + 0.5).to(
                    m.running_var.device)


def vision_gate(torch, smi):
    """Phase vision_gate: f32, TF32 off. Returns the card's NCHW model
    (random BN state) for the eval phase."""
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.module import tree_leaves
    from bigdl_tpu_torch.optim import SGD, make_train_step

    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = {"depth": 50, "dataSet": "ImageNet"}
    nchw = ResNet(1000, cfg, seed=0, device="cuda")
    randomize_bn(torch, nchw, seed=5)
    nhwc = ResNet(1000, {**cfg, "format": "NHWC"}, seed=1, device="cuda")
    cpu = ResNet(1000, cfg, seed=2, device="cpu")
    for m in (nhwc, cpu):
        m.load_params_dict(nchw.params_dict())
        m.load_buffers_dict(nchw.buffers_dict())
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 3, 224, 224), generator=g)
    with torch.inference_mode():
        for m in (nchw, nhwc, cpu):
            m.evaluate()
        out_nchw = nchw(x.cuda())
        out_nhwc = nhwc(x.permute(0, 2, 3, 1).contiguous().cuda())
        out_cpu = cpu(x)
        torch.cuda.synchronize()
    eval_rel = {"nhwc_vs_nchw": rel_diff(out_nhwc.cpu(), out_nchw.cpu()),
                "nchw_vs_cpu": rel_diff(out_nchw.cpu(), out_cpu),
                "nhwc_vs_cpu": rel_diff(out_nhwc.cpu(), out_cpu)}

    # one training step, card (NHWC) against CPU (NCHW)
    xt = torch.randn((4, 3, 224, 224), generator=g)
    yt = torch.tensor([1, 17, 400, 1000])
    steps = {}
    for name, model, xin in (
            ("card", nhwc, xt.permute(0, 2, 3, 1).contiguous().cuda()),
            ("cpu", cpu, xt)):
        ts = make_train_step(model, CrossEntropyCriterion(),
                             SGD(learning_rate=0.01))
        p0, b0 = model.params_dict(), model.buffers_dict()
        loss, p1, b1, _ = ts.step(p0, b0, ts.init_slots(p0), xin,
                                  yt.to(xin.device), ts.current_lrs(), None)
        steps[name] = (loss.item(),
                       [(n, (b - a).float().cpu()) for (n, a), (_, b) in
                        zip(tree_leaves(p0), tree_leaves(p1))],
                       [(n, b.float().cpu(), a.float().cpu()) for (n, a),
                        (_, b) in zip(tree_leaves(b0), tree_leaves(b1))])
    err = math.sqrt(sum(((dg - dc) ** 2).sum().item() for (_, dg), (_, dc)
                        in zip(steps["card"][1], steps["cpu"][1])))
    ref = math.sqrt(sum((dc ** 2).sum().item() for _, dc in steps["cpu"][1]))
    upd_rel = err / ref
    stats_rel, unmoved = 0.0, []
    for (n, bg, old), (_, bc, _) in zip(steps["card"][2], steps["cpu"][2]):
        stats_rel = max(stats_rel, rel_diff(bg, bc))
        if torch.equal(bc, old):
            unmoved.append(n)
    rec = {"phase": "vision_gate", "nvidia_smi": smi,
           "model": "ResNet-50 ImageNet, random BN affine and statistics",
           "dtype": "float32", "allow_tf32": False,
           "eval_batch": 2, "eval_max_rel_to_max_logit": eval_rel,
           "eval_rtol": VISION_RTOL, "train_batch": 4,
           "train_loss": {"card_nhwc": steps["card"][0],
                          "cpu_nchw": steps["cpu"][0]},
           "update_rel_l2": upd_rel, "update_rtol": UPDATE_RTOL,
           "update_tol": "||d_card - d_cpu|| / ||d_cpu|| over all "
                         "parameters, d = new - old",
           "stats_max_rel": stats_rel, "stats_rtol": STATS_RTOL,
           "running_stats": len(steps["cpu"][2]),
           "unmoved_stats": unmoved}
    emit(rec)
    assert max(eval_rel.values()) <= VISION_RTOL, eval_rel
    assert abs(steps["card"][0] - steps["cpu"][0]) <= \
        VISION_RTOL * abs(steps["cpu"][0]), rec["train_loss"]
    assert upd_rel <= UPDATE_RTOL, upd_rel
    assert stats_rel <= STATS_RTOL, stats_rel
    assert not unmoved, unmoved
    del nhwc, cpu, steps
    return nchw


def vision_train(torch, smi):
    """Phases vision_train and vision_profile: the run_perf twin."""
    from bigdl_tpu_torch.models.perf import run_perf
    from bigdl_tpu_torch.utils.profiling import device_profile

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    warm, steps = 3, 10
    perf = run_perf("resnet50", batch_size=VISION_BATCH, iterations=steps,
                    warmup=warm, dtype=torch.bfloat16, format="NHWC",
                    master_f32=True, log=lambda *_: None, device="cuda",
                    profile=lambda fn: device_profile(fn, top=400))
    peak = torch.cuda.max_memory_allocated()
    prof = perf.pop("profile")
    # every kernel of the step by name: cuDNN's layout transposes, and
    # ATen's own kernels (BN, ReLU, adds, casts, SGD) against the rest
    # (cuDNN convolutions, cuBLAS for the head)
    kernels = prof.pop("top_kernels_ms")
    transposes = [k for k in kernels if "nchwtonhwc" in k[0].lower()
                  or "nhwctonchw" in k[0].lower()]
    aten_ms = sum(k[1] for k in kernels if "at::native" in k[0])
    prof.update(top_kernels_ms=kernels[:15],
                top_ops_ms=prof["top_ops_ms"][:15],
                distinct_kernels=len(kernels),
                aten_kernel_ms=aten_ms,
                other_kernel_ms=prof["device_kernel_ms"] - aten_ms,
                layout_transpose_kernels={
                    "names": len(transposes),
                    "ms": sum(k[1] for k in transposes)})
    # the same step in NCHW, for the layout's cost (short: its time only)
    nchw = run_perf("resnet50", batch_size=VISION_BATCH, iterations=3,
                    warmup=2, dtype=torch.bfloat16, format="NCHW",
                    master_f32=True, log=lambda *_: None, device="cuda")
    assert all(map(math.isfinite, nchw["losses"])), nchw["losses"]
    assert len(perf["losses"]) == warm + steps
    assert all(map(math.isfinite, perf["losses"])), perf["losses"]
    mfu = perf["records_per_sec"] * RESNET50_TRAIN_FLOPS / \
        PEAK_FLOPS["bfloat16"]
    emit({"phase": "vision_train", "nvidia_smi": smi,
          "config": {"model": "resnet50", "batch": VISION_BATCH,
                     "format": "NHWC", "compute_dtype": "bfloat16",
                     "masters": "float32", "optimizer": "SGD(0.01)",
                     "criterion": "CrossEntropyCriterion"},
          "warmup_steps": warm, "timed_steps": steps,
          "ms_per_step": perf["ms_per_iter"],
          "images_per_s": perf["records_per_sec"],
          "peak_memory_gb": peak / 1e9, "losses": perf["losses"],
          "analytic_flops_per_image": RESNET50_TRAIN_FLOPS,
          "analytic_mfu": mfu, "mfu_peak": "989 TFLOP/s bf16 (H100 SXM)",
          "timer": perf["timer"], "warmup_s": perf["warmup_s"],
          "nchw_ms_per_step": nchw["ms_per_iter"],
          "nchw_images_per_s": nchw["records_per_sec"]})
    emit({"phase": "vision_profile", "nvidia_smi": smi,
          "window": "one ResNet-50 train step, batch 256 NHWC bf16", **prof})


def vision_eval(torch, smi, model):
    """Phase vision_eval: the entry() twin (f32, batch 8, NCHW) and the
    bf16 NHWC forward at batch 256, on the gate's weights."""
    from bigdl_tpu_torch.models import ResNet

    g = torch.Generator(device="cuda").manual_seed(4)
    x8 = torch.randn((8, 3, 224, 224), device="cuda", generator=g)
    with torch.inference_mode():
        out8 = model(x8)
        f32_ms = time_ms(torch, lambda: model(x8), warmup=2, iters=10)
    assert out8.shape == (8, 1000) and torch.isfinite(out8).all()
    bf = ResNet(1000, {"depth": 50, "dataSet": "ImageNet", "format": "NHWC"},
                seed=1, device="cuda", dtype=torch.bfloat16)
    bf.load_params_dict(model.params_dict())
    bf.load_buffers_dict(model.buffers_dict())
    bf.evaluate()
    xb = torch.randn((VISION_BATCH, 224, 224, 3), device="cuda",
                     generator=g).to(torch.bfloat16)
    xb[:8] = x8.permute(0, 2, 3, 1).to(torch.bfloat16)
    with torch.inference_mode():
        outb = bf(xb)
        bf16_ms = time_ms(torch, lambda: bf(xb), warmup=2, iters=10)
    assert outb.shape == (VISION_BATCH, 1000) and torch.isfinite(outb).all()
    rel = rel_diff(outb[:8], out8)
    emit({"phase": "vision_eval", "nvidia_smi": smi,
          "f32_nchw": {"batch": 8, "ms": f32_ms,
                       "images_per_s": 8 / f32_ms * 1e3},
          "bf16_nhwc": {"batch": VISION_BATCH, "ms": bf16_ms,
                        "images_per_s": VISION_BATCH / bf16_ms * 1e3},
          "bf16_vs_f32_max_rel": rel, "rtol": EVAL_BF16_RTOL,
          "timing": "median CUDA-event interval around eager forwards "
                    "under inference_mode"})
    assert rel <= EVAL_BF16_RTOL, rel
    del bf


class LoopLog(logging.Handler):
    """The (loss, records/s) of every iteration the LocalOptimizer logs."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        if "Throughput" in record.msg:
            self.rows.append((record.args[-1], record.args[-2]))


def logged(name, fn):
    """Run ``fn`` with a LoopLog on the logger ``name``; its rows."""
    log = logging.getLogger(name)
    handler, level = LoopLog(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        fn()
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return handler.rows


def local_optimizer_phase(torch, smi):
    """Phase local_optimizer: LeNet-5 for one epoch with validation, then
    ResNet-50 NHWC bf16 for 8 iterations through the prefetch thread, and
    the same step without the loop."""
    import numpy as np

    from bigdl_tpu_torch.dataset import (LocalDataSet, MiniBatch, Sample,
                                         SampleToMiniBatch, Transformer,
                                         to_device)
    from bigdl_tpu_torch.dataset.dataset import minibatches
    from bigdl_tpu_torch.models import LeNet5, ResNet
    from bigdl_tpu_torch.models.perf import run_perf
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, CrossEntropyCriterion,
                                    Linear, SpatialBatchNormalization)
    from bigdl_tpu_torch.nn.module import tree_leaves
    from bigdl_tpu_torch.optim import (SGD, Optimizer, Top1Accuracy, Trigger,
                                       make_train_step)
    from bigdl_tpu_torch.utils.profiling import device_profile

    rs = np.random.RandomState(0)
    templates = rs.randn(10, 28, 28).astype(np.float32)

    def mnist_like(n):
        """Noisy copies of ten fixed 28 x 28 templates, labelled 1..10."""
        y = rs.randint(0, 10, n)
        x = templates[y] + rs.randn(n, 28, 28).astype(np.float32)
        return [Sample(a, b) for a, b in zip(x, (y + 1).astype(np.float32))]

    lenet = LeNet5(10, seed=0, device="cuda")
    opt = Optimizer(model=lenet, dataset=mnist_like(4096),
                    criterion=ClassNLLCriterion(), batch_size=128,
                    end_when=Trigger.max_epoch(1))
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_validation(Trigger.every_epoch(), mnist_like(1024),
                       [Top1Accuracy()])
    t0 = time.monotonic()
    rows = logged("bigdl_tpu_torch.optim", opt.optimize)
    lenet_s = time.monotonic() - t0
    losses = [r[0] for r in rows]
    state = opt.optim_method.state
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    lenet_rec = {"samples": 4096, "batch": 128, "iterations": len(rows),
                 "epoch_after": state["epoch"], "neval": state["neval"],
                 "top1_after_epoch": state.get("score"),
                 "loss_first4_mean": first, "loss_last4_mean": last,
                 "seconds": lenet_s,
                 "records_per_s_logged_median": float(np.median(
                     [r[1] for r in rows]))}
    assert len(rows) == 32 and state["epoch"] == 2, lenet_rec
    assert state.get("score") is not None and last < first, lenet_rec

    # ResNet-50 in bf16 (f32 BN statistics), fed as a bf16 model is: the
    # user's transformer casts each stacked batch on the prefetch thread
    class ToBF16(Transformer):
        def __call__(self, it):
            for b in it:
                yield MiniBatch(to_bf16(b.get_input()), b.get_target())

    def to_bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    batch, iters = 64, 8
    images = rs.randn(4 * batch, 224, 224, 3).astype(np.float32)
    labels = rs.randint(1, 1001, 4 * batch).astype(np.float32)
    samples = [Sample(a, b) for a, b in zip(images, labels)]
    net = ResNet(1000, {"depth": 50, "dataSet": "ImageNet",
                        "format": "NHWC"}, seed=0, device="cuda",
                 dtype=torch.bfloat16)
    par0 = [(n, p.clone()) for n, p in tree_leaves(net.params_dict())]
    buf0 = [b.clone() for _, b in tree_leaves(net.buffers_dict())]
    opt = Optimizer(model=net, dataset=(LocalDataSet(samples)
                                        >> SampleToMiniBatch(batch)
                                        >> ToBF16()),
                    criterion=CrossEntropyCriterion(), batch_size=batch,
                    end_when=Trigger.max_iteration(iters))
    opt.set_optim_method(SGD(learning_rate=0.01))
    t0 = time.monotonic()
    rows = logged("bigdl_tpu_torch.optim", opt.optimize)
    resnet_s = time.monotonic() - t0
    changed = [n for (n, a), (_, b) in zip(par0, tree_leaves(
        net.params_dict())) if not torch.equal(a, b)]
    moved = sum(not torch.equal(a, b) for a, (_, b) in
                zip(buf0, tree_leaves(net.buffers_dict())))
    # bf16 rounds away most SGD updates (lr 0.01) of the conv weights and
    # of gamma = 1; the head and the BN shifts (beta, from 0) keep theirs
    must_change = [f"{n}.{w}" for n, m in net.named_modules() for w in
                   (("weight", "bias") if isinstance(m, Linear) else
                    ("bias",) if isinstance(m, SpatialBatchNormalization)
                    else ())]

    # where a loop step's time goes. (1) The host side of the data path
    # alone, per batch: numpy stacking, the bf16 cast, the pinned
    # non-blocking copy. (2) The same step without the loop: the loop's
    # model and TrainStep on one batch already on the card, timed as the
    # loop times a step (host clock around the step and the loss's sync).
    # (3) run_perf at this batch (bf16 over f32 masters, CUDA events) and
    # one profiled step of it: its device busy time.
    stream = minibatches(LocalDataSet(samples), batch, train=True)
    host = {"stack_ms": [], "cast_ms": [], "pin_copy_ms": []}
    for _ in range(4):
        t0 = time.perf_counter()
        b = next(stream)
        t1 = time.perf_counter()
        x = to_bf16(b.get_input())
        t2 = time.perf_counter()
        to_device(x, torch.device("cuda"))
        to_device(b.get_target(), torch.device("cuda"))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(host, (t1 - t0, t2 - t1, t3 - t2)):
            host[k].append(v * 1e3)
    ts = make_train_step(net, CrossEntropyCriterion(), SGD(learning_rate=0.01))
    params, buffers = net.params_dict(), net.buffers_dict()
    slots, lrs = ts.init_slots(params), ts.current_lrs()
    xb = to_bf16(images[:batch]).cuda()
    yb = torch.from_numpy(labels[:batch]).cuda()
    bare_ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        loss, params, buffers, slots = ts.step(params, buffers, slots, xb, yb,
                                               lrs, None)
        float(loss)
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    del ts, params, buffers, slots
    perf = run_perf("resnet50", batch_size=batch, iterations=iters, warmup=3,
                    dtype=torch.bfloat16, format="NHWC", master_f32=True,
                    log=lambda *_: None, device="cuda",
                    profile=lambda fn: device_profile(fn, top=5))
    prof = perf["profile"]
    loop_ms = [batch / r[1] * 1e3 for r in rows]
    emit({"phase": "local_optimizer", "nvidia_smi": smi, "lenet5": lenet_rec,
          "resnet50": {"format": "NHWC", "param_dtype": "bfloat16",
                       "stats_dtype": "float32", "batch": batch,
                       "iterations": len(rows), "losses": [r[0] for r in rows],
                       "records_per_s_logged": [r[1] for r in rows],
                       "step_ms_logged": loop_ms, "seconds": resnet_s,
                       "params_changed": len(changed), "params": len(par0),
                       "must_change": len(must_change),
                       "running_stats_moved": moved,
                       "running_stats": len(buf0)},
          "resnet50_without_loop": {
              "host_data_path_ms_per_batch": host,
              "bare_step_ms": bare_ms,
              "timing": "host clock around the step and float(loss), as "
                        "the loop times it",
              "loop_minus_bare_median_ms": statistics.median(loop_ms[1:])
                                           - statistics.median(bare_ms[1:])},
          "run_perf_batch64": {
              "config": "resnet50 NHWC bf16 over f32 masters",
              "ms_per_step": perf["ms_per_iter"],
              "images_per_s": perf["records_per_sec"],
              "timer": perf["timer"],
              "profiled_step": {k: prof[k] for k in prof
                                if not k.startswith("top_")}}})
    assert len(rows) == iters and all(math.isfinite(r[0]) for r in rows)
    assert moved == len(buf0), (moved, len(buf0))
    missed = sorted(set(must_change) - set(changed))
    assert len(must_change) == 55 and not missed, (len(must_change), missed)
    assert all(map(math.isfinite, perf["losses"])), perf["losses"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.ops import build
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.optim.generation_service import GenerationService

    # ---------------------------------------------------------- 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # ----------------------------------------------------------- 2. build
    t_build = time.monotonic()
    lib = build.build()
    build_s = time.monotonic() - t_build
    with open(build.build_log()) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln
                 or "Function properties" in ln]
    emit({"phase": "build", "seconds": build_s, "nvcc": build.nvcc_path(),
          "flags": build.NVCC_FLAGS, "library": os.path.relpath(lib, ROOT),
          "ptxas": ptxas})

    # --------------------------------------------------------- 3. kernels
    bf16, f32 = torch.bfloat16, torch.float32
    flagship = check_flash(torch, fa, (4, 8, 2, 2048, 2048, 64), True, bf16,
                           with_library=True, mutant=True)
    check_flash(torch, fa, (2, 8, 2, 1024, 1024, 64), False, bf16, True)
    check_flash(torch, fa, (2, 8, 2, 256, 2048, 64), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 512, 256, 64), True, bf16, False)
    check_flash(torch, fa, (4, 8, 2, 1000, 1000, 64), True, bf16, True)
    # edges of the bf16 tiling: one query row, a q tile plus one row, a kv
    # tile plus one key (with dead rows), head dims 128 and, zero-padded, 32
    # and 72
    check_flash(torch, fa, (2, 8, 2, 1, 2048, 64), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 129, 129, 64), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 200, 65, 64), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 1024, 1024, 128), True, bf16, True)
    check_flash(torch, fa, (2, 8, 2, 300, 300, 32), True, bf16, False)
    check_flash(torch, fa, (2, 4, 2, 160, 96, 72), False, bf16, False)
    # odd d: element stores in place of TMA copies, single-element outputs
    check_flash(torch, fa, (2, 4, 1, 100, 100, 77), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 1024, 1024, 64), True, f32, True)
    # the flagship width over sequence lengths
    sweep = []
    for t in (512, 1024, 2048, 4096, 8192):
        rec = flagship if t == 2048 else check_flash(
            torch, fa, (4, 8, 2, t, t, 64), True, bf16, True)
        sweep.append({"t": t, "tk": t, "kernel_ms": rec["kernel_ms"],
                      "library_ms": rec["library_ms"],
                      "device_ms": rec["device_ms"],
                      "library_device_ms": rec["library_device_ms"],
                      "bound_ms": rec["bound_ms"],
                      "bound_share": rec["bound_ms"] / rec["kernel_ms"],
                      "device_bound_share":
                          rec["bound_ms"] / rec["device_ms"]})
    emit({"phase": "sweep", "kernel": "flash_attention_fwd",
          "shape": {"B": 4, "H": 8, "H_kv": 2, "d": 64}, "dtype": "bfloat16",
          "causal": True, "nvidia_smi": smi, "rows": sweep})
    emit({"phase": "prior", "kernel": "flash_attention_fwd",
          "flagship_kernel_ms_before_redesign": PRIOR_MS,
          "origin": "constant from PERF.md (the WMMA kernel, eager CUDA-event "
                    "time, H100 80GB HBM3, 700 W); not measured in this run"})

    # ------------------------------------------- main path: phases 4 to 6
    fa.launches = 0

    # 4. scoring at full width through the flash kernel
    model = TransformerLM(**FLAGSHIP, seed=0, device="cuda", dtype=bf16)
    model.evaluate()
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, FLAGSHIP["vocab_size"], (4, 2048), device="cuda",
                        generator=g)
    with torch.inference_mode():
        before = fa.launches
        logits = model(ids)
        torch.cuda.synchronize()
        assert fa.launches - before == model.num_layers, fa.launches
        assert logits.shape == (4, 2048, FLAGSHIP["vocab_size"])
        assert torch.isfinite(logits).all()
        n_fwd = 3
        before = fa.launches
        fwd_ms = time_ms(torch, lambda: model(ids), warmup=0, iters=n_fwd)
        assert fa.launches - before == n_fwd * model.num_layers
        for blk in model.blocks():
            blk.attn.use_flash = False
        dense = model(ids)
        for blk in model.blocks():
            blk.attn.use_flash = True
    score_rel = rel_diff(logits, dense)
    agree = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
    emit({"phase": "scoring", "batch": 4, "seq": 2048, "dtype": "bfloat16",
          "forward_ms": fwd_ms, "tokens_per_s": 4 * 2048 / fwd_ms * 1e3,
          "launches_per_forward": model.num_layers,
          "flash_vs_dense_max_rel": score_rel, "rtol": LOGIT_RTOL,
          "argmax_agreement": agree})
    assert score_rel <= LOGIT_RTOL, score_rel
    del logits, dense

    # 5. greedy generate, checked by teacher forcing
    prompts = torch.randint(0, FLAGSHIP["vocab_size"], (8, 256),
                            device="cuda", generator=g)
    n_new = 64
    model.generate(prompts[:, :32], 4)           # warm-up
    torch.cuda.synchronize()
    first = []

    def on_token(_):
        if not first:
            torch.cuda.synchronize()
            first.append(time.monotonic())

    t0 = time.monotonic()
    out, seen = model.generate(prompts, n_new, on_token=on_token,
                               return_logits=True)
    torch.cuda.synchronize()
    t_end = time.monotonic()
    assert out.shape == (8, 256 + n_new)
    assert torch.equal(out[:, :256], prompts)
    with torch.inference_mode():
        tf = model(out)[:, 255:255 + n_new]
    gen_rel = rel_diff(seen, tf)
    tf_agree = (tf.argmax(-1) == out[:, 256:]).float().mean().item()
    prefill_s, decode_s = first[0] - t0, t_end - first[0]
    emit({"phase": "generate", "prompts": 8, "prompt_len": 256,
          "new_tokens": n_new, "dtype": "bfloat16",
          "prefill_tokens_per_s": 8 * 256 / prefill_s,
          "decode_tokens_per_s": 8 * (n_new - 1) / decode_s,
          "teacher_forced_max_rel": gen_rel, "rtol": LOGIT_RTOL,
          "teacher_forced_argmax_agreement": tf_agree})
    assert gen_rel <= LOGIT_RTOL, gen_rel
    del model, seen, tf

    # 6. server: concurrent mixed-length requests, f32 with TF32 off
    model32 = TransformerLM(**FLAGSHIP, seed=0, device="cuda", dtype=f32)
    model32.evaluate()
    lengths = [100, 128, 193, 200, 224, 241, 250, 256]
    news = [32, 24, 32, 16, 32, 32, 20, 32]
    reqs = [prompts[i, :n].cpu().numpy() for i, n in enumerate(lengths)]
    svc = GenerationService(model32, max_batch=8, batch_timeout_ms=500.0,
                            bucket_tokens=32, prompt_bucket=64)
    answers = [None] * len(reqs)

    def ask(i):
        answers[i] = svc.generate(reqs[i], news[i])

    threads = [threading.Thread(target=ask, args=(i,), daemon=True)
               for i in range(len(reqs))]
    t_srv = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    srv_s = time.monotonic() - t_srv
    near_ties = []
    for i, (p, n) in enumerate(zip(reqs, news)):
        ans = answers[i]
        assert ans is not None and ans.shape == (len(p) + n,), i
        lone, lone_logits = model32.generate(p, n, return_logits=True)
        lone = lone[0].cpu().numpy()
        if (ans == lone).all():
            continue
        # allowed only where the lone run's top two logits tie to f32
        # rounding at the first difference; anything else fails
        j = int((ans != lone).nonzero()[0][0]) - len(p)
        top2 = lone_logits[0, j].topk(2).values
        margin = (top2[0] - top2[1]).item()
        near_ties.append({"request": i, "position": j, "margin": margin})
        assert margin < 1e-4, near_ties[-1]
    stats = svc.stats()
    emit({"phase": "server", "requests": len(reqs), "prompt_lengths": lengths,
          "new_tokens": news, "dtype": "float32", "seconds": srv_s,
          "stats": stats, "rows_equal_lone_generate":
          len(reqs) - len(near_ties), "near_ties": near_ties})
    serving_launches = fa.launches
    assert serving_launches > 0, \
        "the serving path never launched the flash kernel"
    del model32, svc

    # ---------------------------------------- 7. and 8.: the train path
    flash_backward_phase(torch, fa)
    train_launches = train_phase(torch, fa, smi)

    # ---------------------------------------------------- the vision path
    gate_model = vision_gate(torch, smi)
    vision_train(torch, smi)
    vision_eval(torch, smi, gate_model)
    del gate_model
    local_optimizer_phase(torch, smi)

    # ----------------------------------------------------- 9. kernels line
    print(nvidia_smi(), flush=True)
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "bigdl_tpu/ops/flash_attention.py:116",
        "tpu_kernel": "bigdl_tpu/ops/flash_attention.py::_flash_kernel",
        "launches": serving_launches + train_launches,
        "launches_serving": serving_launches,
        "launches_train": train_launches,
        "max_abs_err": flagship["max_abs_err"],
        "ms": flagship["kernel_ms"], "kernel_ms": flagship["kernel_ms"],
        "device_ms": flagship["device_ms"],
        "plain_ms": flagship["plain_ms"], "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": flagship["library_ms"],
        "library_device_ms": flagship["library_device_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
