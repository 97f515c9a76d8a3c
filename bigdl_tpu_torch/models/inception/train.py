"""Inception-v1 ImageNet training main (port of
``bigdl_tpu/models/inception/train.py``; ≙ models/inception/Train.scala).

Reads the sharded-TFRecord records that ``imagenet_gen`` writes, trains
the single-head GoogLeNet with SGD under a Poly(0.5) decay, and
checkpoints / resumes through ``--checkpoint`` / ``--model`` /
``--state``. Run: ``python -m bigdl_tpu_torch.models.inception.train -f
<records_dir>`` (``--device cpu`` on a machine without a card).
"""

from __future__ import annotations

import logging

from bigdl_tpu_torch.dataset import RecordFileDataSet, image
from bigdl_tpu_torch.models import train_utils
from bigdl_tpu_torch.models.inception.model import InceptionV1NoAuxClassifier
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.optim import SGD, Poly, Top1Accuracy, Top5Accuracy


def inception_train_pipeline(seed: int = 1):
    """224 random resized crop + HFlip + normalize (≙
    models/inception/ImageNet2012.scala's train chain)."""
    return (image.BytesToImg()
            >> image.RandomResizedCrop(224, 224, seed=seed)
            >> image.HFlip(0.5, seed=seed + 1)
            >> image.ChannelNormalize((123.0, 117.0, 104.0), (1.0, 1.0, 1.0))
            >> image.ImgToSample())


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = train_utils.train_parser(
        "Inception-v1 on ImageNet records (≙ models/inception/Train.scala)",
        default_batch=128, default_epochs=70, default_lr=0.065)
    p.add_argument("--classes", type=int, default=1000)
    args = p.parse_args(argv)

    records = RecordFileDataSet(args.folder)
    train_ds = records.transform(inception_train_pipeline())
    iters_per_epoch = max(1, records.size() // args.batch_size)

    model, method = train_utils.resume(
        args, lambda: InceptionV1NoAuxClassifier(args.classes,
                                                 device=args.device),
        lambda: SGD(learning_rate=args.learning_rate,
                    learning_rate_decay=args.learning_rate_decay,
                    weight_decay=args.weight_decay, momentum=args.momentum,
                    learning_rate_schedule=Poly(
                        0.5, args.max_epoch * iters_per_epoch)))

    optimizer = train_utils.build_optimizer(
        args, model, train_ds, ClassNLLCriterion())
    optimizer.set_optim_method(method)
    train_utils.wire_common(optimizer, args, None,
                            [Top1Accuracy(), Top5Accuracy()])
    return train_utils.optimize(optimizer)


if __name__ == "__main__":
    main()
