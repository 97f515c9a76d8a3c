"""Run named phases of ``chip_smoke.py`` alone on the card.

Each phase takes ``(torch, fa, smi)`` and counts its own flash launches;
TF32 is off as in the whole script, and the flash kernel is built from
the checkout first. Run from the repo root on a machine with one H100:

    python3 scripts/torch_chip_phases.py \\
        serialize_gate interop_gate imageclass_predict
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch.ops import build  # noqa: E402
from bigdl_tpu_torch.ops import flash_attention as fa  # noqa: E402


def main(names) -> int:
    if not torch.cuda.is_available():
        print("torch_chip_phases: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    t = time.monotonic()
    build.build()
    print(f"build seconds {time.monotonic() - t:.3f}", flush=True)
    for name in names:
        t = time.monotonic()
        n = getattr(cs, name)(torch, fa, smi)
        print(f"{name} seconds {time.monotonic() - t:.3f} flash launches {n}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
