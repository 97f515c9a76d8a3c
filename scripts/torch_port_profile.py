#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's flagship paths.

    python3 scripts/torch_port_profile.py

Builds the serving flagship (TransformerLM vocab 32000, embed 512, 8
heads, 2 kv heads, 8 layers, RoPE, flash on; random bf16 weights from a
seed) on the GPU and traces, with ``torch.profiler``, one warm scoring
forward over the 4 x 2048 tokens of ``chip_smoke.py``'s scoring phase
and a window of 16 warm greedy decode steps after a 256-token prompt;
then one warm step of the training flagship (``transformer_perf``:
vocab 32000, embed 512, 8 heads, 8 layers, 32 x 1024 tokens, bf16 over
f32 masters, SGD). For each it prints one JSON line: wall time, the
summed device time by kernel and by PyTorch operation and input shapes
(top entries), and the device's idle share of the window (1 - busy /
wall, counting overlapping kernels once). Needs a GPU.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the shapes of chip_smoke.py's scoring and generate phases
FLAGSHIP = dict(vocab_size=32000, embed_dim=512, num_heads=8,
                num_kv_heads=2, num_layers=8, max_len=2048, use_rope=True,
                use_flash=True)
BATCH, SEQ, PROMPT, DECODE_STEPS = 4, 2048, 256, 16


def trace(name, fn):
    from bigdl_tpu_torch.utils.profiling import device_profile

    print(json.dumps({"window": name, **device_profile(fn)}), flush=True)


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
        trace(f"scoring_forward_b{BATCH}_t{SEQ}", lambda: model(ids))
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

    trace(f"decode_{DECODE_STEPS}_steps_b{BATCH}", decode)
    del model, caches, logits

    from bigdl_tpu_torch.models.perf import transformer_perf
    from bigdl_tpu_torch.utils.profiling import device_profile

    perf = transformer_perf(32, 2, 2, torch.bfloat16, log=lambda *_: None,
                            device="cuda",
                            profile=lambda fn: device_profile(fn, top=30))
    print(json.dumps({"window": "train_step_b32_t1024",
                      "ms_per_step": perf["ms_per_iter"],
                      **perf["profile"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
