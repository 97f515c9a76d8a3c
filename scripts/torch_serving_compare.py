"""Time the micro-batched services of one checkout of the port on the card.

Runs ``chip_smoke.py``'s ``predict_serving`` phase (``PredictionService``
over the bf16 flagship, 16 clients, ``max_batch`` 8, a 20 ms window) and
phase 6's server settings (``GenerationService`` over the f32 flagship,
8 mixed-length requests, ``max_batch`` 8, a 500 ms window) ``--reps``
times each, the first of each a warm-up, from the checkout at ``ROOT``
(its own ``chip_smoke.py`` and ``bigdl_tpu_torch``). Prints one JSON line
a run. To compare two commits, unpack both and run them in one call on
one card, in the order parent, change, change, parent:

    python3 scripts/torch_serving_compare.py build/parent --label parent
"""

import argparse
import json
import os
import sys
import threading
import time


def server(torch, cs, smi, model32, label):
    """Phase 6's server: the wall time and the latency percentiles."""
    import numpy as np

    from bigdl_tpu_torch.optim.generation_service import GenerationService

    g = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cs.FLAGSHIP["vocab_size"], (8, 256),
                            generator=g)
    reqs = [prompts[i, :n].numpy() for i, n in enumerate(cs.SERVER_LENGTHS)]
    svc = GenerationService(model32, max_batch=8, batch_timeout_ms=500.0,
                            bucket_tokens=32, prompt_bucket=64)
    answers, lat = [None] * len(reqs), [None] * len(reqs)

    def ask(i):
        t = time.monotonic()
        answers[i] = svc.generate(reqs[i], cs.SERVER_NEWS[i])
        lat[i] = time.monotonic() - t

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(reqs))]
    t0 = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.monotonic() - t0
    for i, n in enumerate(cs.SERVER_NEWS):
        assert answers[i] is not None and answers[i].shape == (
            len(reqs[i]) + n,), i
    ms = sorted(x * 1e3 for x in lat)
    print(json.dumps({
        "label": label, "phase": "server", "nvidia_smi": smi,
        "seconds": wall, "latency_ms_p50": float(np.percentile(ms, 50)),
        "latency_ms_p99": float(np.percentile(ms, 99)),
        "dispatches": svc.stats()["dispatches"]}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("root", help="the checkout to time")
    p.add_argument("--label", default=None)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_serving_compare: CUDA is not available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.ops import build
    from bigdl_tpu_torch.ops import flash_attention as fa

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    label = args.label or root
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    build.build()
    model16 = TransformerLM(**cs.FLAGSHIP, seed=0, device="cuda",
                            dtype=torch.bfloat16)
    model16.evaluate()
    for rep in range(args.reps):
        print(json.dumps({"label": label, "rep": rep}), flush=True)
        cs.predict_serving(torch, fa, smi, model16)
    del model16
    model32 = TransformerLM(**cs.FLAGSHIP, seed=0, device="cuda",
                            dtype=torch.float32)
    model32.evaluate()
    for rep in range(args.reps):
        server(torch, cs, smi, model32, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
