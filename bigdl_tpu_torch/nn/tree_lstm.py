"""The binary (constituency) tree LSTM (port of ``TreeLSTM`` and
``BinaryTreeLSTM`` in ``bigdl_tpu/nn/tree_lstm.py``).

The input is ``Table(embeddings, trees)``: embeddings (batch, n_leaves,
input_size) and trees (batch, n_nodes, 3), row i (node i, 1-based) =
``[left, right, leaf_index]``; no children mark a leaf over
``embeddings[:, leaf_index - 1]``, and an all-zero row is padding. The
trees are host data: they steer a memoised recursion, batch row by
batch row, as in the JAX layer. One leaf module and one composer are
plain children reused at every node, registered under the JAX names
(``leaf_c``, ``leaf_o``, ``comp_{i,lf,rf,update,o}_{l,r}``). The
gradient comes from autograd; ``backward`` gives the embeddings'
gradient and zeros for the trees, as the JAX layer does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.device import DEFAULT_DEVICE
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.random import RandomGenerator


class TreeLSTM(Module):
    """Base of the tree LSTMs."""

    def __init__(self, input_size: int, hidden_size: int = 150):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size


def _host_trees(trees) -> np.ndarray:
    if torch.is_tensor(trees):
        trees = trees.detach().cpu().numpy()
    return np.asarray(trees).astype(np.int64)


class BinaryTreeLSTM(TreeLSTM):
    """Output (batch, n_nodes, hidden): each node's h at its row, 0 on
    padding rows. A leaf is ``c = W_c x``, ``h = sigmoid(W_o x) *
    tanh(c)`` (``tanh(c)`` without ``gate_output``); a parent composes
    its children's (c, h) with the gates i, lf, rf, update (and o), each
    ``W_l lh + W_r rh``."""

    def __init__(self, input_size: int, hidden_size: int,
                 gate_output: bool = True, *,
                 rng: Optional[RandomGenerator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__(input_size, hidden_size)
        kw = dict(rng=rng or RandomGenerator(), device=device, dtype=dtype)
        self.gate_output = gate_output
        self.leaf_c = Linear(input_size, hidden_size, **kw)
        if gate_output:
            self.leaf_o = Linear(input_size, hidden_size, **kw)
        self._gates = ["i", "lf", "rf", "update"] + (
            ["o"] if gate_output else [])
        for g in self._gates:
            setattr(self, f"comp_{g}_l", Linear(hidden_size, hidden_size,
                                                **kw))
            setattr(self, f"comp_{g}_r", Linear(hidden_size, hidden_size,
                                                **kw))

    # ------------------------------------------------------------ cell math
    def _leaf(self, x):
        c = self.leaf_c(x)
        if self.gate_output:
            h = torch.sigmoid(self.leaf_o(x)) * torch.tanh(c)
        else:
            h = torch.tanh(c)
        return c, h

    def _gate(self, name, lh, rh):
        return (getattr(self, f"comp_{name}_l")(lh)
                + getattr(self, f"comp_{name}_r")(rh))

    def _compose(self, lc, lh, rc, rh):
        i = torch.sigmoid(self._gate("i", lh, rh))
        lf = torch.sigmoid(self._gate("lf", lh, rh))
        rf = torch.sigmoid(self._gate("rf", lh, rh))
        update = torch.tanh(self._gate("update", lh, rh))
        c = i * update + lf * lc + rf * rc
        if self.gate_output:
            h = torch.sigmoid(self._gate("o", lh, rh)) * torch.tanh(c)
        else:
            h = torch.tanh(c)
        return c, h

    # -------------------------------------------------------------- forward
    def forward(self, input):
        inputs, trees = input[1], _host_trees(input[2])
        batch, n_nodes = trees.shape[0], trees.shape[1]
        rows = []
        for b in range(batch):
            memo: Dict[int, Tuple] = {}

            def recurse(i: int):
                if i in memo:
                    return memo[i]
                left, right, leaf = (int(v) for v in trees[b, i - 1])
                if left == 0 and right == 0:
                    out = self._leaf(inputs[b, leaf - 1])
                else:
                    lc, lh = recurse(left)
                    rc, rh = recurse(right)
                    out = self._compose(lc, lh, rc, rh)
                memo[i] = out
                return out

            zero = inputs.new_zeros((self.hidden_size,))
            rows.append(torch.stack([
                recurse(i)[1] if trees[b, i - 1].any() else zero
                for i in range(1, n_nodes + 1)]))
        return torch.stack(rows)
