"""ML-pipeline example (port of ``bigdl_tpu/example/MLPipeline/train.py``;
≙ example/MLPipeline/DLClassifierLeNet.scala and the DLEstimator
examples): a ``DLClassifier`` fitted on the train rows of a pandas
DataFrame and scored on the held-out rows by ``transform``.

Run: ``python -m bigdl_tpu_torch.example.MLPipeline.train [--device
cpu]``. Two classes split by the sign of x0 - x2 over four Gaussian
features; the model trains on the device of its parameters. Returns the
held-out accuracy.
"""

from __future__ import annotations

import argparse

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.dlframes import DLClassifier
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.random import RandomGenerator


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=128)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device to train on (cuda, or cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    import pandas as pd

    rng = np.random.RandomState(0)
    x = rng.randn(args.rows, 4).astype(np.float32)
    y = (x[:, 0] - x[:, 2] > 0).astype(np.float32) + 1  # classes 1/2
    df = pd.DataFrame({"features": list(x), "label": list(y)})
    train_df, test_df = df[: args.rows * 3 // 4], df[args.rows * 3 // 4:]

    kw = dict(rng=RandomGenerator(4), device=dev)
    model = (nn.Sequential().add(nn.Linear(4, 16, **kw)).add(nn.ReLU())
             .add(nn.Linear(16, 2, **kw)).add(nn.LogSoftMax()))
    clf = (DLClassifier(model, nn.ClassNLLCriterion(), [4])
           .set_batch_size(16).set_learning_rate(0.1)
           .set_end_when(Trigger.max_epoch(args.epochs)))
    fitted = clf.fit(train_df)
    out = fitted.transform(test_df)
    acc = float(np.mean(np.asarray(out["prediction"])
                        == np.asarray(test_df["label"], np.int64)))
    print(f"test accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
