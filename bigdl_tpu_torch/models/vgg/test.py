"""VGG CIFAR-10 evaluation main (port of ``bigdl_tpu/models/vgg/test.py``;
≙ models/vgg/Test.scala).

Run: ``python -m bigdl_tpu_torch.models.vgg.test -f <cifar_dir> --model
<snapshot>``.
"""

from __future__ import annotations

import logging
import os

from bigdl_tpu_torch.dataset import cifar
from bigdl_tpu_torch.models import train_utils
from bigdl_tpu_torch.models.vgg.train import cifar_eval_pipeline, raw_samples
from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy
from bigdl_tpu_torch.utils import file as bt_file


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = train_utils.test_parser("Evaluate VGG on CIFAR-10").parse_args(argv)
    vi, vl = cifar.load_batch(os.path.join(args.folder, "test_batch.bin"))
    samples = list(cifar_eval_pipeline()(iter(raw_samples(vi, vl))))
    model = bt_file.load_module(args.model, device=args.device)
    results = Evaluator(model).test(samples, [Top1Accuracy()],
                                    batch_size=args.batch_size)
    for method, result in results:
        print(f"{result} is {method}")
    return results


if __name__ == "__main__":
    main()
