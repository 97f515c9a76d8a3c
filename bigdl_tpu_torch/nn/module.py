"""Thin module base over ``torch.nn.Module``.

Port of the parts of ``bigdl_tpu/nn/module.py`` the inference slice
needs: parameter naming and ``evaluate``. Parameters are registered
under the same names as in the JAX package, so
:meth:`Module.params_dict` returns the JAX ``params_dict()`` tree key
for key: ``{child: {...}, "~params": {name: tensor}}``.
"""

from __future__ import annotations

from typing import Dict

import torch

PARAMS_KEY = "~params"


class Module(torch.nn.Module):
    """Base of the port's layers."""

    def new_param(self, name: str, value: torch.Tensor, device,
                  dtype) -> None:
        """Register ``value`` (an f32 CPU tensor from an init method) as
        parameter ``name``, cast to ``dtype`` on ``device``."""
        self.register_parameter(
            name, torch.nn.Parameter(value.to(device=device, dtype=dtype)))

    def evaluate(self) -> "Module":
        """Inference mode (the JAX package's ``evaluate``)."""
        return self.eval()

    def params_dict(self) -> Dict:
        """Nested ``{child: ..., "~params": {name: tensor}}`` tree, the
        layout of the JAX package's ``params_dict()``."""
        d = {}
        own = dict(self.named_parameters(recurse=False))
        if own:
            d[PARAMS_KEY] = own
        for name, child in self.named_children():
            sub = child.params_dict() if isinstance(child, Module) else {}
            if sub:
                d[name] = sub
        return d
