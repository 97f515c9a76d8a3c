"""The device rule every entry point of the port follows.

An entry point called without ``device=`` runs on the card. Where there
is no card it raises and names the way out (``device="cpu"``); it never
moves to the CPU by itself.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device on a
    machine where CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available on "
            "this machine; pass device='cpu' to run on the CPU")
    return dev
