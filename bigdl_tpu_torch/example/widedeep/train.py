"""Wide & Deep over the feature-column ops (port of
``bigdl_tpu/example/widedeep/train.py``).

The canonical consumer of the ``nn.ops`` feature-column set: feature
prep runs on the host in the data pipeline (the string-hash ops read
Python strings), producing one wide multi-hot vector and deep ids per
row; the model is a ``Graph`` with a linear wide tower over the
multi-hot and an embedding MLP deep tower over the ids, fused by a
sigmoid scorer.

Run: ``python -m bigdl_tpu_torch.example.widedeep.train [--device cpu]``.
Synthetic census-like rows (age/occupation/education) with a label rule
driven by the occupation x education CROSS, learnable by the wide
tower's crossed column, which is the point of the architecture. The
last line printed is a JSON summary: iterations, ms a step and
records/s of the training loop, held-out accuracy and the majority
baseline.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.dataset import LocalDataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.device import DEFAULT_DEVICE
from bigdl_tpu_torch.nn import ops
from bigdl_tpu_torch.optim.optim_method import Adam
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.table import Table

OCCUPATIONS = ["engineer", "teacher", "farmer", "artist", "doctor", "clerk"]
EDUCATIONS = ["highschool", "college", "masters", "phd"]
AGE_BOUNDARIES = [25.0, 35.0, 45.0, 55.0, 65.0]
HASH_OCC, HASH_CROSS = 32, 64


def synthetic_census(n: int, seed: int = 0):
    """rows (age, occupation, education) + binary label that depends on the
    occupation x education pair (plus a mild age effect): the crossed
    feature carries the signal. numpy's ``RandomState``, so both packages
    draw the same rows."""
    rng = np.random.RandomState(seed)
    pair_w = rng.randn(len(OCCUPATIONS), len(EDUCATIONS))
    rows, labels = [], []
    for _ in range(n):
        age = float(rng.uniform(18, 70))
        occ = OCCUPATIONS[rng.randint(len(OCCUPATIONS))]
        edu = EDUCATIONS[rng.randint(len(EDUCATIONS))]
        score = pair_w[OCCUPATIONS.index(occ), EDUCATIONS.index(edu)] \
            + 0.5 * (age > 45.0)
        rows.append((age, occ, edu))
        labels.append(1.0 if score > 0.0 else 0.0)
    return rows, np.asarray(labels, np.float32)


def preprocess(rows):
    """Feature columns on the host -> (wide multi-hot (B, W) f32, deep ids
    (B, 3) int32, 1-based): bucketize, hash, cross, indicator."""
    cpu = dict(device="cpu")
    ages = np.asarray([r[0] for r in rows], np.float32)
    occs = [r[1] for r in rows]
    edus = [r[2] for r in rows]

    age_b = ops.BucketizedCol(AGE_BOUNDARIES).forward(ages).numpy()
    occ_id = ops.CategoricalColHashBucket(HASH_OCC, **cpu).forward(
        occs).numpy()
    edu_id = np.asarray([EDUCATIONS.index(e) for e in edus], np.int32)
    cross = ops.CrossCol(HASH_CROSS, **cpu).forward([occs, edus])

    n_age = len(AGE_BOUNDARIES) + 1
    wide = torch.cat([
        ops.IndicatorCol(n_age).forward(age_b),
        ops.IndicatorCol(HASH_OCC).forward(occ_id),
        ops.IndicatorCol(HASH_CROSS).forward(cross),
    ], dim=1).numpy().astype(np.float32)
    deep = np.stack([age_b + 1, occ_id + 1, edu_id + 1], axis=1)  # 1-based
    return wide, deep.astype(np.int32)


def build_wide_deep(wide_dim: int, embed: int = 8, *,
                    device=DEFAULT_DEVICE, seed: int = 1) -> nn.Module:
    """The wide-and-deep ``Graph`` of inputs (wide multi-hot, deep ids);
    weights from one seeded stream."""
    kw = dict(rng=RandomGenerator(seed), device=device)
    wide_in, deep_in = nn.Input(), nn.Input()
    wide_logit = nn.Linear(wide_dim, 1, **kw).inputs(wide_in)
    towers = []
    for col, n in enumerate([len(AGE_BOUNDARIES) + 1, HASH_OCC,
                             len(EDUCATIONS)]):
        ids = nn.Select(2, col + 1).inputs(deep_in)  # 1-based dims
        towers.append(nn.LookupTable(n, embed, **kw).inputs(ids))
    x = nn.JoinTable(2).inputs(*towers)
    x = nn.ReLU().inputs(nn.Linear(3 * embed, 16, **kw).inputs(x))
    deep_logit = nn.Linear(16, 1, **kw).inputs(x)
    out = nn.Sigmoid().inputs(nn.CAddTable().inputs(wide_logit, deep_logit))
    return nn.Graph([wide_in, deep_in], out)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Wide & Deep on census-like rows")
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--max-epoch", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device to train on (cuda, or cpu)")
    return p


def main(argv=None):
    """Train and evaluate; returns ``(trained model, held-out accuracy,
    majority baseline)`` as the JAX main does."""
    args = parser().parse_args(argv)
    rows, labels = synthetic_census(args.samples)
    wide, deep = preprocess(rows)
    samples = [Sample([wide[i], deep[i]], np.asarray([labels[i]], np.float32))
               for i in range(len(rows))]
    split = int(0.9 * len(samples))

    model = build_wide_deep(wide.shape[1], device=args.device)
    method = Adam(learning_rate=args.lr)
    opt = Optimizer(model=model, dataset=LocalDataSet(samples[:split]),
                    criterion=nn.BCECriterion(),
                    batch_size=args.batch_size,
                    end_when=Trigger.max_epoch(args.max_epoch))
    opt.set_optim_method(method)
    on_card = torch.device(args.device).type == "cuda"
    t0 = time.perf_counter()
    trained = opt.optimize()
    if on_card:
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    trained.evaluate()
    with torch.no_grad():
        p_hat = trained.forward(Table(
            torch.from_numpy(wide[split:]).to(args.device),
            torch.from_numpy(deep[split:]).to(args.device)))[:, 0].cpu()
    y = labels[split:]
    acc = float(((p_hat.numpy() > 0.5) == (y > 0.5)).mean())
    base = float(max(y.mean(), 1 - y.mean()))
    print(f"held-out accuracy: {acc:.3f} (majority baseline {base:.3f})")
    iterations = method.state["neval"] - 1
    print(json.dumps({
        "iterations": iterations, "train_s": train_s,
        "ms_per_step": 1e3 * train_s / max(1, iterations),
        "records_per_sec": iterations * args.batch_size / train_s,
        "train_records": split, "held_out_records": len(samples) - split,
        "wide_dim": int(wide.shape[1]), "held_out_accuracy": acc,
        "majority_baseline": base, "device": str(args.device)}))
    return trained, acc, base


if __name__ == "__main__":
    main()
