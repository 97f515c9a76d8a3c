#!/usr/bin/env python3
"""Host cost of one eager flash-attention call with and without autograd.

    python3 scripts/torch_flash_host_cost.py

At the serving flagship shape (B 4, H 8, H_kv 2, t = tk = 2048, d 64,
bf16, causal) and a small one (B 2, t = tk = 512), with no input
requiring a gradient, under ``torch.inference_mode`` as the scoring path
runs, times three eager calls on the same tensors: the public
``flash_attention_with_lse`` (through the ``FlashAttention`` Function),
the kernel's launch without the Function (``_forward``), and SDPA. Each
is measured twice, in the order A B C C B A, as the median CUDA-event
interval around single calls (``kernel_ms`` of ``chip_smoke.py``) and as
host microseconds per call over a burst of calls issued without a
synchronize. Prints one JSON line per shape and the card's name and
power limit. Needs a GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4, 8, 2, 2048, 2048, 64), (2, 8, 2, 512, 512, 64)]
BURST = 500


def event_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(5):
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


def host_us(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BURST):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / BURST * 1e6


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_host_cost: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bigdl_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for b, h, h_kv, t, tk, d in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(sz, device="cuda", generator=g)
                   .to(torch.bfloat16)
                   for sz in ((b, h, t, d), (b, h_kv, tk, d),
                              (b, h_kv, tk, d)))
        scale = 1.0 / d ** 0.5
        calls = {
            "function": lambda: fa.flash_attention_with_lse(q, k, v, True),
            "launch": lambda: fa._forward(q, k, v, True, scale),
            "sdpa": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
        }
        ms = {n: [] for n in calls}
        us = {n: [] for n in calls}
        with torch.inference_mode():
            for n in ("function", "launch", "sdpa", "sdpa", "launch",
                      "function"):
                ms[n].append(event_ms(torch, calls[n]))
                us[n].append(host_us(torch, calls[n]))
        print(json.dumps({"shape": {"B": b, "H": h, "H_kv": h_kv, "t": t,
                                    "tk": tk, "d": d},
                          "dtype": "bfloat16", "causal": True,
                          "nvidia_smi": smi, "event_ms": ms,
                          "host_us_per_call": us,
                          "function_minus_launch_host_us": statistics.mean(
                              us["function"]) - statistics.mean(
                              us["launch"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
