#!/usr/bin/env python3
"""Repeat the port's QoS storm and read the tenant bucket's refusals.

    python3 scripts/torch_qos_storm.py [--runs 4] [--gate port|jax|both]

Builds the serving flagship (TransformerLM vocab 32000, embed 512, 8
heads, 2 kv heads, 8 layers, RoPE; random bf16 weights from a seed) on
the GPU and runs ``run_qos_storm`` at the JAX package's defaults (24
requests at 20/s into 2 slots, 3 greedy-tenant requests, seed 0), as
``chip_smoke.py``'s qos_serving phase does, ``--runs`` times per gate.
``--gate jax`` admits on the bucket's balance alone, as the JAX engine
does; ``--gate port`` also counts what the tenant's requests in flight
have been metered (the port's gate); ``both`` alternates them, jax
first, so the two are compared within one process. Each run prints one
JSON line: the shed / preempted / rate-limited counts of both legs, the
high-class TTFT ratios and percentiles, conservation, and for each
greedy-tenant request its outcome, its admission and first token
(seconds after submit) and its metered device-seconds. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the serving flagship and the storm of chip_smoke.py's qos_serving phase
FLAGSHIP = dict(vocab_size=32000, embed_dim=512, num_heads=8,
                num_kv_heads=2, num_layers=8, max_len=2048, use_rope=True,
                use_flash=True)
QOS_SERVING = dict(n_requests=24, rate_hz=20.0, max_slots=2,
                   prefill_chunk=8, prefill_rows=2, n_greedy=3, seed=0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--gate", choices=("port", "jax", "both"),
                    default="both")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_qos_storm: needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serving import run_qos_storm
    from bigdl_tpu_torch.serving.engine import ContinuousBatchingEngine
    from bigdl_tpu_torch.serving.scheduler import TokenBucket

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    model = TransformerLM(**FLAGSHIP, seed=0, device="cuda",
                          dtype=torch.bfloat16).evaluate()

    greedy = []
    finish = ContinuousBatchingEngine._finish_handle

    def record(self, h, err, outcome):
        if h.tenant == "greedy":
            rel = (lambda t: None if t is None
                   else round(t - h.submitted_at, 4))
            greedy.append({"leg": self.service_name, "outcome": outcome,
                           "submitted_s": round(h.submitted_at, 4),
                           "admitted_s": rel(h.admitted_at),
                           "first_token_s": rel(h.first_token_at),
                           "device_s": round(h._usage.device_s, 6)})
        return finish(self, h, err, outcome)

    ContinuousBatchingEngine._finish_handle = record
    port_admit = TokenBucket.try_admit

    def jax_admit(self, now=None, pending=0.0):
        return port_admit(self, now)

    gates = {"port": ("port",), "jax": ("jax",),
             "both": ("jax", "port")}[args.gate]
    for i in range(args.runs):
        for gate in gates:
            TokenBucket.try_admit = port_admit if gate == "port" \
                else jax_admit
            greedy.clear()
            res = run_qos_storm(model, **QOS_SERVING)
            storm, unc = res["qos"], res["uncontended"]
            print(json.dumps({
                "run": i, "gate": gate, "nvidia_smi": smi,
                "shed": res["shed"], "preempted": res["preempted"],
                "rate_limited": res["rate_limited"],
                "uncontended_rate_limited":
                    unc["outcomes"]["rate_limited"],
                "high_ttft_p50_ratio": res["high_ttft_p50_ratio"],
                "high_ttft_p99_ratio": res["high_ttft_p99_ratio"],
                "high_ttft": storm["ttft"],
                "uncontended_high_ttft": unc["ttft"],
                "conservation_ok": res["conservation_ok"],
                "greedy": sorted(greedy, key=lambda g: (
                    g["leg"], g["submitted_s"]))}), flush=True)
    TokenBucket.try_admit = port_admit
    return 0


if __name__ == "__main__":
    sys.exit(main())
