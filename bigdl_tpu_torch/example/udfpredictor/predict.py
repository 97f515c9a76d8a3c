"""UDF predictor (port of ``bigdl_tpu/example/udfpredictor/predict.py``;
≙ example/udfpredictor/, a trained model registered as a Spark SQL UDF
over a text DataFrame): a pandas column transform backed by the port's
``PredictionService``, which keeps one model shared across calls.

Run: ``python -m bigdl_tpu_torch.example.udfpredictor.predict [--device
cpu]``. Returns the DataFrame with its ``prediction`` column.
"""

from __future__ import annotations

import argparse

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.optim.prediction_service import PredictionService
from bigdl_tpu_torch.utils.random import RandomGenerator


def make_udf(model: nn.Module, concurrent: bool = False,
             sample_ndim: int = 1):
    """A features-in, class-out function for pandas ``.apply`` / ``.map``
    (the reference's ``udf(predict _)``), on the model's device.
    ``concurrent=True`` adds micro-batching, which pays only when MANY
    threads call the udf at once (a sequential ``.map`` would just wait
    out the batch window)."""
    svc = PredictionService(model, num_threads=4,
                            max_batch=16 if concurrent else None,
                            sample_ndim=sample_ndim)

    def udf(features) -> int:
        out = svc.predict(np.asarray(features, np.float32))
        return int(np.argmax(np.asarray(out))) + 1

    return udf


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=64)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device to predict on (cuda, or cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    import pandas as pd

    rng = np.random.RandomState(0)
    kw = dict(rng=RandomGenerator(1), device=dev)
    model = (nn.Sequential().add(nn.Linear(8, 16, **kw)).add(nn.ReLU())
             .add(nn.Linear(16, 2, **kw)).add(nn.SoftMax()))
    model.evaluate()
    df = pd.DataFrame({"features": list(rng.randn(args.rows, 8)
                                        .astype(np.float32))})
    udf = make_udf(model)
    df["prediction"] = df["features"].map(udf)
    print(df["prediction"].value_counts().to_dict())
    return df


if __name__ == "__main__":
    main()
