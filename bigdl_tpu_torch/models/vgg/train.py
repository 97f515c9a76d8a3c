"""VGG CIFAR-10 training main (port of ``bigdl_tpu/models/vgg/train.py``;
≙ models/vgg/Train.scala).

CIFAR binary batches, pad-4 random crop + flip + per-channel normalize,
SGD (momentum 0.9, weight decay 5e-4 unless given), validation every
epoch. Run: ``python -m bigdl_tpu_torch.models.vgg.train -f <cifar_dir>``
(``--device cpu`` on a machine without a card).
"""

from __future__ import annotations

import logging

import numpy as np

from bigdl_tpu_torch.dataset import DataSet, Sample, cifar, image
from bigdl_tpu_torch.models import train_utils
from bigdl_tpu_torch.models.vgg.model import VggForCifar10
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.optim import SGD, Top1Accuracy


def cifar_train_pipeline(seed: int = 1):
    """pad-4 random crop + hflip + per-channel normalize (≙ Train.scala's
    BGRImgRdmCropper/HFlip/BGRImgNormalizer chain)."""
    return (image.BytesToImg()
            >> image.RandomCrop(32, 32, padding=4, seed=seed)
            >> image.HFlip(0.5, seed=seed + 1)
            >> image.ChannelNormalize(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
            >> image.ImgToSample())


def cifar_eval_pipeline():
    return (image.BytesToImg()
            >> image.ChannelNormalize(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
            >> image.ImgToSample())


def raw_samples(images: np.ndarray, labels: np.ndarray):
    return [Sample(images[i], np.array([labels[i] + 1.0], np.float32))
            for i in range(images.shape[0])]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = train_utils.train_parser(
        "VGG on CIFAR-10 (≙ models/vgg/Train.scala)",
        default_batch=128, default_epochs=90, default_lr=0.01)
    args = p.parse_args(argv)
    if args.momentum == 0.0:
        args.momentum = 0.9
    if args.weight_decay == 0.0:
        args.weight_decay = 5e-4

    ti, tl, vi, vl = cifar.read_data_sets(args.folder)
    train_ds = DataSet.array(raw_samples(ti, tl)).transform(
        cifar_train_pipeline())
    val_samples = list(cifar_eval_pipeline()(iter(raw_samples(vi, vl))))

    model, method = train_utils.resume(
        args, lambda: VggForCifar10(10, device=args.device),
        lambda: SGD(learning_rate=args.learning_rate,
                    learning_rate_decay=args.learning_rate_decay,
                    weight_decay=args.weight_decay, momentum=args.momentum,
                    dampening=0.0, nesterov=False))

    optimizer = train_utils.build_optimizer(
        args, model, train_ds, ClassNLLCriterion())
    optimizer.set_optim_method(method)
    train_utils.wire_common(optimizer, args,
                            val_samples if len(val_samples) else None,
                            [Top1Accuracy()])
    return train_utils.optimize(optimizer)


if __name__ == "__main__":
    main()
