"""Tree-LSTM sentiment (port of
``bigdl_tpu/example/treeLSTMSentiment/train.py``; ≙
example/treeLSTMSentiment/Train.scala): a ``BinaryTreeLSTM`` over binary
trees, its root classified by a ``Linear`` + ``LogSoftMax`` head and
scored by ``TreeNNAccuracy``, trained by hand: ``backward`` through the
head and the tree, then ``update_parameters``.

Run: ``python -m bigdl_tpu_torch.example.treeLSTMSentiment.train
[--device cpu]``. Synthetic trees and embeddings keep the example
offline: the label is the sign of a planted direction summed over the
leaves, so it must travel up the tree's composition. The last line
printed is a JSON summary: seconds, the first and last loss, and the
root accuracy.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.optim.validation import TreeNNAccuracy
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.table import Table


def synthetic_trees(n: int, n_leaves: int, embed_dim: int, seed: int = 0):
    """(embeddings (n, n_leaves, embed_dim), trees (n, 2 n_leaves - 1, 3),
    labels (n, n_nodes) with the class, 1 or 2, at the root): balanced
    trees, internal node i with children 2i and 2i + 1."""
    rng = np.random.RandomState(seed)
    direction = rng.randn(embed_dim).astype(np.float32)
    n_nodes = 2 * n_leaves - 1
    tree = np.zeros((n_nodes, 3), np.float32)
    for i in range(1, n_leaves):
        tree[i - 1] = [2 * i, 2 * i + 1, 0]
    for j in range(n_leaves):
        tree[n_leaves - 1 + j] = [0, 0, j + 1]
    xs, ys = [], []
    for _ in range(n):
        x = rng.randn(n_leaves, embed_dim).astype(np.float32)
        ys.append(1 if float((x @ direction).sum()) > 0 else 2)
        xs.append(x)
    trees = np.repeat(tree[None], n, axis=0)
    labels = np.zeros((n, n_nodes), np.float32)
    labels[:, 0] = ys
    return np.stack(xs), trees, labels


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="tree-LSTM sentiment (≙ treeLSTMSentiment/Train.scala)")
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--leaves", type=int, default=4)
    p.add_argument("--embed-dim", type=int, default=8)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device to train on (cuda, or cpu)")
    return p


def build(embed_dim: int, hidden: int, *, device=DEFAULT_DEVICE,
          seed: int = 1):
    """(tree module, classification head), weights from one stream."""
    kw = dict(rng=RandomGenerator(seed), device=device)
    tree_mod = nn.BinaryTreeLSTM(embed_dim, hidden, **kw)
    head = nn.Sequential().add(nn.Linear(hidden, 2, **kw)).add(
        nn.LogSoftMax())
    return tree_mod, head


def train(tree_mod, head, x, trees, labels, epochs: int, lr: float):
    """``epochs`` full-batch steps by hand; (losses, root accuracy)."""
    dev = next(tree_mod.parameters()).device
    crit = nn.ClassNLLCriterion()
    inp = Table(torch.tensor(x, device=dev), torch.tensor(trees, device=dev))
    y = torch.tensor(labels[:, 0], dtype=torch.long, device=dev)
    losses = []
    for _ in range(epochs):
        tree_mod.zero_grad_parameters()
        head.zero_grad_parameters()
        with torch.no_grad():
            states = tree_mod(inp)
            root = states[:, 0]
            out = head(root)
            losses.append(float(crit(out, y)))
        g = crit.backward(out, y)
        g_root = head.backward(root, g)
        g_states = torch.zeros_like(states)
        g_states[:, 0] = g_root
        tree_mod.backward(inp, g_states)
        tree_mod.update_parameters(lr)
        head.update_parameters(lr)
    full = np.zeros((x.shape[0], trees.shape[1], 2), np.float32)
    with torch.no_grad():
        full[:, 0] = head(tree_mod(inp)[:, 0]).cpu().numpy()
    acc = TreeNNAccuracy()(full, labels).result()[0]
    return losses, acc


def main(argv=None):
    """Train and score; returns ``(last loss, root accuracy)`` as the JAX
    main does."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    x, trees, labels = synthetic_trees(args.samples, args.leaves,
                                       args.embed_dim)
    tree_mod, head = build(args.embed_dim, args.hidden, device=dev)
    t0 = time.perf_counter()
    losses, acc = train(tree_mod, head, x, trees, labels, args.epochs,
                        args.lr)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"final loss {losses[-1]:.4f}, root accuracy {acc:.3f}")
    print(json.dumps({"seconds": seconds, "epochs": args.epochs,
                      "samples": args.samples, "leaves": args.leaves,
                      "embed_dim": args.embed_dim, "hidden": args.hidden,
                      "first_loss": losses[0], "last_loss": losses[-1],
                      "root_accuracy": acc, "device": str(dev)}))
    return losses[-1], acc


if __name__ == "__main__":
    main()
