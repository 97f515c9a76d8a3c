#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's flagship inference path.

    python3 scripts/torch_port_profile.py

Builds the serving flagship (TransformerLM vocab 32000, embed 512, 8
heads, 2 kv heads, 8 layers, RoPE, flash on; random bf16 weights from a
seed) on the GPU and traces, with ``torch.profiler``, one warm scoring
forward over the 4 x 2048 tokens of ``chip_smoke.py``'s scoring phase
and a window of 16 warm greedy decode steps after a 256-token prompt. For each it prints one JSON line: wall time, the summed device
time by kernel (top entries), and the device's idle share of the window
(1 - busy / wall, counting overlapping kernels once). Needs a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the shapes of chip_smoke.py's scoring and generate phases
FLAGSHIP = dict(vocab_size=32000, embed_dim=512, num_heads=8,
                num_kv_heads=2, num_layers=8, max_len=2048, use_rope=True,
                use_flash=True)
BATCH, SEQ, PROMPT, DECODE_STEPS = 4, 2048, 256, 16


def _busy_us(events) -> float:
    """Union of the device kernels' [start, end) intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def trace(torch, name, fn, top: int = 12):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA"]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    busy = _busy_us(kernels)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    print(json.dumps({
        "window": name, "wall_ms": wall_us / 1e3,
        "device_kernel_ms": total / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernel_launches": len(kernels),
        "top_kernels_ms": [[n[:90], us / 1e3, us / total if total else 0.0]
                           for n, us in rows]}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_profile: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bigdl_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(**FLAGSHIP, seed=0, device="cuda",
                          dtype=torch.bfloat16).evaluate()
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, FLAGSHIP["vocab_size"], (BATCH, SEQ),
                        device="cuda", generator=g)
    with torch.inference_mode():
        model(ids)                                          # warm-up
        trace(torch, f"scoring_forward_b{BATCH}_t{SEQ}", lambda: model(ids))
    prompts = ids[:, :PROMPT]
    caches = model.init_cache(BATCH, PROMPT + DECODE_STEPS + 1)
    logits, caches = model.prefill(prompts, caches)
    tok = logits.argmax(-1)
    logits, caches = model.decode_step(tok, PROMPT, caches)  # warm-up

    def decode():
        nonlocal logits, caches
        for i in range(DECODE_STEPS):
            logits, caches = model.decode_step(logits.argmax(-1),
                                               PROMPT + 1 + i, caches)

    trace(torch, f"decode_{DECODE_STEPS}_steps_b{BATCH}", decode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
