"""Weight regularizers (port of ``bigdl_tpu/optim/regularizer.py``).

A regularizer is a penalty ``reg(w) -> scalar`` added to the loss
(``Module.regularization_loss``), so its gradient falls out of autograd;
give it to a layer as ``Linear(..., w_regularizer=L2Regularizer(1e-4))``.
"""

from __future__ import annotations


class Regularizer:
    def __call__(self, w):
        raise NotImplementedError


class L1L2Regularizer(Regularizer):
    """``l1 * |w|_1 + l2 / 2 * |w|_2^2``."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = float(l1)
        self.l2 = float(l2)

    def __call__(self, w):
        out = 0.0
        if self.l1:
            out = out + self.l1 * w.abs().sum()
        if self.l2:
            out = out + 0.5 * self.l2 * (w * w).sum()
        return out


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1, l2=0.0)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2: float):
        super().__init__(l1=0.0, l2=l2)
