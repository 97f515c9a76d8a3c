"""Exponential moving average of model parameters (port of
``bigdl_tpu/optim/ema.py``).

Keep a decayed shadow copy of the parameters during training and
evaluate or serve with it. The state is a plain object over the port's
parameter trees (``params_dict()``-shaped dicts of tensors); it is not
registered anywhere::

    ema = EMA.init(model.params_dict(), decay=0.999)
    for step ...:
        loss, params, buffers, slots = train_step.step(...)
        ema = ema.update(params)
    ema.swap(model)                       # or read ema.shadow

The arithmetic is the JAX package's: the decay is an f32 scalar and
``d * shadow + (1 - d) * params`` runs in the shadow's dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _map(fn, shadow, params):
    return {k: (_map(fn, v, params[k]) if isinstance(v, dict)
                else fn(v, params[k])) for k, v in shadow.items()}


class EMA:
    """Immutable EMA state: ``shadow`` (a parameter tree), ``decay`` and
    the number of updates so far, ``step``."""

    def __init__(self, shadow, decay: float = 0.999, step: int = 0):
        self.shadow = shadow
        self.decay = decay
        self.step = step

    @classmethod
    def init(cls, params, decay: float = 0.999) -> "EMA":
        """An EMA whose shadow is a detached copy of ``params``."""
        return cls(_map(lambda s, _: s.detach().clone(), params, params),
                   decay, 0)

    def update(self, params) -> "EMA":
        """shadow <- d * shadow + (1 - d) * params, with the warm-up
        corrected decay d = min(decay, (1 + step) / (10 + step)), so the
        early steps track the fast-moving parameters instead of the
        random init. Non-float leaves take the new value."""
        step = self.step + 1
        d = np.float32(min(self.decay, (1.0 + step) / (10.0 + step)))

        def mix(s, p):
            if not s.is_floating_point():
                return p
            dt = torch.tensor(d, device=s.device)
            p = p.detach().to(s.device)
            return (dt * s + (1.0 - dt) * p).to(s.dtype)

        with torch.no_grad():
            shadow = _map(mix, self.shadow, params)
        return EMA(shadow, self.decay, step)

    def swap(self, model) -> None:
        """Load the shadow into ``model``'s parameters (before an
        evaluation, say); keep the training parameters elsewhere to put
        them back."""
        model.load_params_dict(self.shadow)
