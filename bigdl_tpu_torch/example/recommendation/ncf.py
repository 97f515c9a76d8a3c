"""Neural Collaborative Filtering on MovieLens ratings (port of
``bigdl_tpu/example/recommendation/ncf.py``): a GMF tower (elementwise
product of a user and an item embedding) and an MLP tower (their
concatenation through a dense stack), joined by a sigmoid scorer, built
with the ``Graph`` API's multi-input wiring and trained to predict
whether a user rates a movie 4 stars or more.

Run: ``python -m bigdl_tpu_torch.example.recommendation.ncf [--data-dir
DIR] [--device cpu]``. Without ``--data-dir`` the latent-factor synthetic
ratings of ``dataset/movielens.py`` are used, so the example runs
offline. The last line printed is a JSON summary: iterations, ms a step
and records/s of the training loop, held-out accuracy, AUC and the
majority-class baseline.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.dataset import LocalDataSet
from bigdl_tpu_torch.dataset.movielens import (read_data_sets,
                                               synthetic_movielens)
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.device import DEFAULT_DEVICE
from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.optim_method import Adam
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import AUC, BinaryAccuracy
from bigdl_tpu_torch.utils.random import RandomGenerator


def build_ncf(n_users: int, n_items: int, embed_gmf: int = 8,
              embed_mlp: int = 16, hidden=(32, 16), *,
              device=DEFAULT_DEVICE, seed: int = 1) -> nn.Module:
    """The two-tower NCF as a ``Graph`` of inputs (user ids, item ids),
    both 1-based; weights from one seeded stream."""
    kw = dict(rng=RandomGenerator(seed), device=device)
    u, i = nn.Input(), nn.Input()
    gmf = nn.CMulTable().inputs(
        nn.LookupTable(n_users, embed_gmf, **kw).inputs(u),
        nn.LookupTable(n_items, embed_gmf, **kw).inputs(i))
    x = nn.JoinTable(2).inputs(
        nn.LookupTable(n_users, embed_mlp, **kw).inputs(u),
        nn.LookupTable(n_items, embed_mlp, **kw).inputs(i))
    width = 2 * embed_mlp
    for h in hidden:
        x = nn.ReLU().inputs(nn.Linear(width, h, **kw).inputs(x))
        width = h
    cat = nn.JoinTable(2).inputs(gmf, x)
    out = nn.Sigmoid().inputs(nn.Linear(embed_gmf + width, 1, **kw).inputs(
        cat))
    return nn.Graph([u, i], out)


def ratings_to_samples(data: np.ndarray):
    """(N, >= 3) [user, item, rating, ...] to implicit-feedback Samples:
    features (user, item), label 1.0 where the rating is 4 or more."""
    return [Sample([np.int32(u), np.int32(i)],
                   np.asarray([1.0 if r >= 4 else 0.0], np.float32))
            for u, i, r in data[:, :3]]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="NCF on MovieLens ratings")
    p.add_argument("--data-dir", default=None,
                   help="ml-1m dir; default: synthetic latent-factor "
                        "ratings")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--max-epoch", type=int, default=12)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--ratings", type=int, default=4096,
                   help="synthetic rating count")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device to train on (cuda, or cpu)")
    return p


def main(argv=None):
    """Train and evaluate; returns ``(trained model, held-out accuracy,
    majority baseline)`` as the JAX main does."""
    args = parser().parse_args(argv)
    data = (read_data_sets(args.data_dir) if args.data_dir
            else synthetic_movielens(n_users=64, n_items=128,
                                     n_ratings=args.ratings))
    # ml-1m's ratings.dat is sorted by user: shuffle before the split, or
    # the held-out users would all have untrained embeddings
    data = data[np.random.RandomState(0).permutation(len(data))]
    n_users, n_items = int(data[:, 0].max()), int(data[:, 1].max())
    samples = ratings_to_samples(data)
    split = int(0.9 * len(samples))

    model = build_ncf(n_users, n_items, device=args.device)
    method = Adam(learning_rate=args.lr)
    opt = Optimizer(model=model, dataset=LocalDataSet(samples[:split]),
                    criterion=nn.BCECriterion(), batch_size=args.batch_size,
                    end_when=Trigger.max_epoch(args.max_epoch))
    opt.set_optim_method(method)
    t0 = time.perf_counter()
    trained = opt.optimize()
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    trained.evaluate()
    results = Evaluator(trained).test(samples[split:],
                                      [BinaryAccuracy(), AUC()],
                                      batch_size=args.batch_size)
    acc = results[0][1].result()[0]
    auc = results[1][1].result()[0]
    y = (data[split:, 2] >= 4).astype(np.float32)
    base = max(y.mean(), 1 - y.mean())
    print(f"held-out accuracy: {acc:.3f} auc: {auc:.3f} "
          f"(majority baseline {base:.3f})")
    iterations = method.state["neval"] - 1
    print(json.dumps({
        "iterations": iterations, "train_s": train_s,
        "ms_per_step": 1e3 * train_s / max(1, iterations),
        "records_per_sec": iterations * args.batch_size / train_s,
        "users": n_users, "items": n_items, "train_records": split,
        "held_out_records": len(samples) - split,
        "held_out_accuracy": float(acc), "auc": float(auc),
        "majority_baseline": float(base),
        "device": str(args.device)}))
    return trained, acc, base


if __name__ == "__main__":
    main()
