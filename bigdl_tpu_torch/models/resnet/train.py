"""ResNet training main: CIFAR-10 (≙ TrainCIFAR10.scala) and ImageNet
records (≙ TrainImageNet.scala); port of
``bigdl_tpu/models/resnet/train.py``.

CIFAR: depth 20, shortcut A, SGD with momentum 0.9, weight decay 1e-4
and nesterov, pad-4 crop + flip + normalize. ImageNet: depth 50,
shortcut B, the records ``imagenet_gen`` writes through RandomResizedCrop
+ HFlip + ColorJitter + Lighting + normalize, and with
``--warmup-epochs`` a linear ramp to ``--max-lr`` followed by 0.1x steps
at epochs 30, 60 and 80. Run: ``python -m
bigdl_tpu_torch.models.resnet.train -f <dir> --dataset cifar10``
(``--device cpu`` on a machine without a card).
"""

from __future__ import annotations

import logging

import numpy as np

from bigdl_tpu_torch.dataset import (DataSet, RecordFileDataSet, Sample,
                                     cifar, image)
from bigdl_tpu_torch.models import train_utils
from bigdl_tpu_torch.models.resnet.model import (DatasetType, ResNet,
                                                 ShortcutType)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion)
from bigdl_tpu_torch.optim import (SGD, EpochSchedule, SequentialSchedule,
                                   Top1Accuracy, Top5Accuracy, Warmup)

CIFAR_MEAN = (125.3, 123.0, 113.9)
CIFAR_STD = (63.0, 62.1, 66.7)


def imagenet_train_pipeline(seed: int = 1):
    """RandomResizedCrop(224) + HFlip + ColorJitter + Lighting + normalize
    (≙ TrainImageNet.scala's ImageNetDataSet chain)."""
    return (image.BytesToImg()
            >> image.RandomResizedCrop(224, 224, seed=seed)
            >> image.HFlip(0.5, seed=seed + 1)
            >> image.ColorJitter(seed=seed + 2)
            >> image.Lighting(seed=seed + 3)
            >> image.ChannelNormalize((0.485 * 255, 0.456 * 255, 0.406 * 255),
                                      (0.229 * 255, 0.224 * 255, 0.225 * 255))
            >> image.ImgToSample())


def cifar_eval_pipeline():
    return (image.BytesToImg()
            >> image.ChannelNormalize(CIFAR_MEAN, CIFAR_STD)
            >> image.ImgToSample())


def labelled(images, labels):
    """Samples of raw images with 1-based labels."""
    return [Sample(images[i], np.array([labels[i] + 1.0], np.float32))
            for i in range(images.shape[0])]


def warmup_schedule(iters_per_epoch: int, warmup_epochs: int, base_lr: float,
                    max_lr: float) -> SequentialSchedule:
    """≙ TrainImageNet.scala:106-124: ramp ``base_lr`` -> ``max_lr`` over
    the warm-up iterations, then 0.1x steps at epochs 30, 60 and 80."""
    warmup_iters = warmup_epochs * iters_per_epoch
    delta = (max_lr - base_lr) / max(1, warmup_iters)
    w = warmup_epochs
    return (SequentialSchedule(iters_per_epoch)
            .add(Warmup(delta), warmup_iters)
            .add(EpochSchedule([
                (1, 30 - w, max_lr),
                (31 - w, 60 - w, max_lr * 0.1),
                (61 - w, 80 - w, max_lr * 0.01),
                (81 - w, 10 ** 9, max_lr * 1e-3)]), 10 ** 9))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = train_utils.train_parser(
        "ResNet (≙ models/resnet/TrainCIFAR10.scala / TrainImageNet.scala)",
        default_batch=128, default_epochs=165, default_lr=0.1)
    p.add_argument("--dataset", choices=["cifar10", "imagenet"],
                   default="cifar10")
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--classes", type=int, default=None)
    p.add_argument("--warmup-epochs", type=int, default=0,
                   help="linear LR warmup epochs (ImageNet recipe)")
    p.add_argument("--max-lr", type=float, default=None,
                   help="peak LR after warmup (≙ TrainImageNet maxLr; "
                        "--learning-rate is the warmup start)")
    args = p.parse_args(argv)
    if args.momentum == 0.0:
        args.momentum = 0.9
    if args.weight_decay == 0.0:
        args.weight_decay = 1e-4

    if args.dataset == "cifar10":
        depth = args.depth or 20
        classes = args.classes or 10
        ti, tl, vi, vl = cifar.read_data_sets(args.folder)
        pipe = (image.BytesToImg()
                >> image.RandomCrop(32, 32, padding=4, seed=1)
                >> image.HFlip(0.5, seed=2)
                >> image.ChannelNormalize(CIFAR_MEAN, CIFAR_STD)
                >> image.ImgToSample())
        train_ds = DataSet.array(labelled(ti, tl)).transform(pipe)
        val_samples = list(cifar_eval_pipeline()(iter(labelled(vi, vl))))
        opt = {"depth": depth, "shortcutType": ShortcutType.A,
               "dataSet": DatasetType.CIFAR10}
        criterion = ClassNLLCriterion()
        val_methods = [Top1Accuracy()]
    else:
        depth = args.depth or 50
        classes = args.classes or 1000
        records = RecordFileDataSet(args.folder)
        train_ds = records.transform(imagenet_train_pipeline())
        val_samples = None
        opt = {"depth": depth, "shortcutType": ShortcutType.B,
               "dataSet": DatasetType.ImageNet}
        # the ImageNet head emits raw logits (TrainImageNet.scala uses
        # CrossEntropyCriterion)
        criterion = CrossEntropyCriterion()
        val_methods = [Top1Accuracy(), Top5Accuracy()]

    schedule = None
    if args.warmup_epochs:
        schedule = warmup_schedule(
            max(1, train_ds.size() // args.batch_size), args.warmup_epochs,
            args.learning_rate, args.max_lr or args.learning_rate)

    model, method = train_utils.resume(
        args, lambda: ResNet(classes, opt, device=args.device),
        lambda: SGD(learning_rate=args.learning_rate,
                    learning_rate_decay=args.learning_rate_decay,
                    weight_decay=args.weight_decay, momentum=args.momentum,
                    dampening=0.0, nesterov=True,
                    learning_rate_schedule=schedule))

    optimizer = train_utils.build_optimizer(args, model, train_ds, criterion)
    optimizer.set_optim_method(method)
    train_utils.wire_common(optimizer, args, val_samples, val_methods)
    return train_utils.optimize(optimizer)


if __name__ == "__main__":
    main()
