"""The SimpleRNN word language model's training main (port of
``bigdl_tpu/models/rnn/train.py``; ≙ models/rnn/Train.scala).

Reads ``train.txt`` in ``--folder``, splits and tokenizes it with
sentence markers, keeps the ``--vocab-size`` most frequent words in a
``Dictionary``, and trains ``SimpleRNN`` with SGD on one-hot sentences
padded to ``--seq-len`` through ``TimeDistributedCriterion(
CrossEntropyCriterion)``. Run: ``python -m
bigdl_tpu_torch.models.rnn.train -f <dir with train.txt>`` (``--device
cpu`` on a machine without a card).
"""

from __future__ import annotations

import logging
import os

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.text import (
    Dictionary, LabeledSentenceToSample, SentenceSplitter, SentenceTokenizer,
    TextToLabeledSentence,
)
from bigdl_tpu_torch.models import train_utils
from bigdl_tpu_torch.models.rnn.model import SimpleRNN
from bigdl_tpu_torch.optim import SGD, Loss


def build_samples(folder: str, vocab_size: int, seq_len: int,
                  filename: str = "train.txt"):
    """(padded one-hot Samples, the Dictionary) of ``folder/filename``."""
    with open(os.path.join(folder, filename)) as f:
        text = f.read()
    sentences = list(SentenceTokenizer()(SentenceSplitter()(iter([text]))))
    dictionary = Dictionary(sentences, vocab_size)
    pipe = (TextToLabeledSentence(dictionary)
            >> LabeledSentenceToSample(dictionary.vocab_size(),
                                       fixed_length=seq_len))
    return list(pipe(iter(sentences))), dictionary


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = train_utils.train_parser(
        "SimpleRNN word LM (≙ models/rnn/Train.scala)",
        default_batch=8, default_epochs=30, default_lr=0.1)
    p.add_argument("--vocab-size", type=int, default=4000)
    p.add_argument("--hidden-size", type=int, default=40)
    p.add_argument("--seq-len", type=int, default=32,
                   help="the length every sentence is padded or cut to")
    args = p.parse_args(argv)

    samples, dictionary = build_samples(args.folder, args.vocab_size,
                                        args.seq_len)
    if args.checkpoint:
        dictionary.save(args.checkpoint)
    vocab = dictionary.vocab_size()

    model, method = train_utils.resume(
        args, lambda: SimpleRNN(vocab, args.hidden_size, vocab,
                                device=args.device),
        lambda: SGD(learning_rate=args.learning_rate,
                    learning_rate_decay=args.learning_rate_decay,
                    weight_decay=args.weight_decay, momentum=args.momentum))

    criterion = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(),
                                            size_average=True)
    optimizer = train_utils.build_optimizer(args, model,
                                            DataSet.array(samples), criterion)
    optimizer.set_optim_method(method)
    train_utils.wire_common(optimizer, args,
                            samples[:min(len(samples), 64)], [Loss(criterion)])
    return train_utils.optimize(optimizer)


if __name__ == "__main__":
    main()
