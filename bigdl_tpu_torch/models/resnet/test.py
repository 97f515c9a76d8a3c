"""ResNet CIFAR-10 evaluation main (port of
``bigdl_tpu/models/resnet/test.py``; ≙ models/resnet/TestCIFAR10.scala).

Run: ``python -m bigdl_tpu_torch.models.resnet.test -f <cifar_dir>
--model <snapshot>``.
"""

from __future__ import annotations

import logging
import os

from bigdl_tpu_torch.dataset import cifar
from bigdl_tpu_torch.models import train_utils
from bigdl_tpu_torch.models.resnet.train import cifar_eval_pipeline, labelled
from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy
from bigdl_tpu_torch.utils import file as bt_file


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = train_utils.test_parser(
        "Evaluate ResNet on CIFAR-10").parse_args(argv)
    vi, vl = cifar.load_batch(os.path.join(args.folder, "test_batch.bin"))
    samples = list(cifar_eval_pipeline()(iter(labelled(vi, vl))))
    model = bt_file.load_module(args.model, device=args.device)
    results = Evaluator(model).test(samples, [Top1Accuracy()],
                                    batch_size=args.batch_size)
    for method, result in results:
        print(f"{result} is {method}")
    return results


if __name__ == "__main__":
    main()
