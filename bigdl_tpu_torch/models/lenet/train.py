"""LeNet-5 MNIST training main (port of
``bigdl_tpu/models/lenet/train.py``; ≙ models/lenet/Train.scala).

Reads the MNIST idx files, builds LeNet-5 (or resumes a snapshot) on
``--device``, trains with SGD and validates and checkpoints every epoch.
Run: ``python -m bigdl_tpu_torch.models.lenet.train -f <mnist_dir>``
(``--device cpu`` on a machine without a card).
"""

from __future__ import annotations

import logging

from bigdl_tpu_torch.dataset import DataSet, mnist
from bigdl_tpu_torch.models import train_utils
from bigdl_tpu_torch.models.lenet.model import LeNet5
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.optim import SGD, Top1Accuracy


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = train_utils.train_parser(
        "LeNet-5 on MNIST (≙ models/lenet/Train.scala)",
        default_batch=128, default_epochs=5, default_lr=0.05).parse_args(argv)

    ti, tl, vi, vl = mnist.read_data_sets(args.folder)
    train_samples = mnist.to_samples(ti, tl, mnist.TRAIN_MEAN, mnist.TRAIN_STD)
    val_samples = mnist.to_samples(vi, vl, mnist.TEST_MEAN, mnist.TEST_STD)

    model, method = train_utils.resume(
        args, lambda: LeNet5(10, device=args.device),
        lambda: SGD(learning_rate=args.learning_rate,
                    learning_rate_decay=args.learning_rate_decay,
                    weight_decay=args.weight_decay, momentum=args.momentum))

    optimizer = train_utils.build_optimizer(
        args, model, DataSet.array(train_samples), ClassNLLCriterion())
    optimizer.set_optim_method(method)
    train_utils.wire_common(optimizer, args, val_samples, [Top1Accuracy()])
    return train_utils.optimize(optimizer)


if __name__ == "__main__":
    main()
