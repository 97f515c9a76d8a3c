"""Text classification: word vectors + a temporal CNN (port of
``bigdl_tpu/example/textclassification/train.py``; ≙ example/
textclassification/TextClassifier.scala: GloVe embeddings ->
TemporalConvolution -> ReLU -> TemporalMaxPooling -> Linear -> LogSoftMax
over the 20-newsgroup classes).

Run: ``python -m bigdl_tpu_torch.example.textclassification.train
[--data-dir ./data/news20] [--device cpu]``. With ``--data-dir`` the real
20 Newsgroups corpus and GloVe vectors are read (``dataset/news20.py``,
which downloads them where there is a network and raises a clear error
where there is none); without it ``synthetic_news20`` gives an offline
corpus of the same shape and the words get deterministic hashed
embeddings. Either way the same tokenize -> vectorize -> train ->
evaluate pipeline runs, on ``--device`` (default ``cuda``). The last line
printed is a JSON summary: iterations, ms a step and records/s of the
training loop, and the validation accuracy.
"""

from __future__ import annotations

import argparse
import json
import time
import zlib

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.dataset import LocalDataSet
from bigdl_tpu_torch.dataset.news20 import (get_glove_w2v, get_news20,
                                            synthetic_news20)
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.text import SentenceTokenizer
from bigdl_tpu_torch.device import DEFAULT_DEVICE
from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.optim_method import SGD
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import Top1Accuracy
from bigdl_tpu_torch.utils.random import RandomGenerator


def build_model(class_num: int, seq_len: int = 32, embed_dim: int = 20, *,
                device=DEFAULT_DEVICE, seed: int = 1) -> nn.Module:
    """≙ TextClassifier.buildModel: TemporalConvolution + max pooling over
    time, weights drawn from one seeded stream."""
    rng = RandomGenerator(seed)
    return (nn.Sequential()
            .add(nn.TemporalConvolution(embed_dim, 64, 5, rng=rng,
                                        device=device))
            .add(nn.ReLU())
            .add(nn.TemporalMaxPooling(seq_len - 5 + 1))
            .add(nn.Squeeze(2))
            .add(nn.Linear(64, class_num, rng=rng, device=device))
            .add(nn.LogSoftMax()))


def _hashed_vec(word: str, dim: int) -> np.ndarray:
    """Deterministic per-word gaussian embedding (the GloVe stand-in when
    no pre-trained vectors are on disk); crc32, so stable across runs."""
    rng = np.random.RandomState(zlib.crc32(word.encode()) & 0x7FFFFFFF)
    return rng.randn(dim).astype(np.float32)


def vectorize(texts, seq_len: int, embed_dim: int, w2v=None):
    """[(text, label)] -> [Sample((seq_len, embed_dim), label)]: tokenize,
    truncate or zero-pad to ``seq_len``, map words to vectors (the GloVe
    dict when given, unknown words zero, else hashed embeddings)."""
    tok = SentenceTokenizer(add_markers=False)
    cache = {}

    def vec(w):
        if w not in cache:
            if w2v is not None:
                v = w2v.get(w)
                cache[w] = (np.asarray(v, np.float32)[:embed_dim]
                            if v is not None
                            else np.zeros(embed_dim, np.float32))
            else:
                cache[w] = _hashed_vec(w, embed_dim)
        return cache[w]

    samples = []
    for text, label in texts:
        # one document at a time: the streaming tokenizer skips empty
        # documents, which would shift tokens against labels under zip
        tokens = next(iter(tok(iter([text]))), [])[:seq_len]
        seq = np.zeros((seq_len, embed_dim), np.float32)
        for i, w in enumerate(tokens):
            seq[i] = vec(w)
        samples.append(Sample(seq, np.asarray([label], np.float32)))
    return samples


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="temporal-CNN text classifier (≙ TextClassifier.scala)")
    p.add_argument("--data-dir", default=None,
                   help="20news/GloVe dir (downloads if absent); "
                        "default: offline synthetic corpus")
    p.add_argument("--class-num", type=int, default=4,
                   help="classes for the synthetic corpus (real data: 20)")
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--embed-dim", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-epoch", type=int, default=6)
    p.add_argument("--samples", type=int, default=128,
                   help="synthetic corpus size")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device to train on (cuda, or cpu)")
    return p


def main(argv=None):
    """Train and evaluate; returns ``(trained model, validation
    accuracy)`` as the JAX main does."""
    args = parser().parse_args(argv)
    if args.data_dir:
        texts = get_news20(args.data_dir)
        try:
            w2v = get_glove_w2v(args.data_dir, dim=max(50, args.embed_dim))
        except (RuntimeError, OSError) as e:  # no net / no glove.6B.<d>d.txt
            print(f"GloVe unavailable ({e}); using hashed embeddings")
            w2v = None
        class_num = max(label for _, label in texts)
    else:
        texts = synthetic_news20(n=args.samples, class_num=args.class_num)
        w2v, class_num = None, args.class_num

    samples = vectorize(texts, args.seq_len, args.embed_dim, w2v)
    split = int(0.8 * len(samples))
    model = build_model(class_num, args.seq_len, args.embed_dim,
                        device=args.device)
    method = SGD(learning_rate=0.1)
    opt = Optimizer(model=model, dataset=LocalDataSet(samples[:split]),
                    criterion=nn.ClassNLLCriterion(),
                    batch_size=args.batch_size,
                    end_when=Trigger.max_epoch(args.max_epoch))
    opt.set_optim_method(method)
    opt.set_validation(Trigger.every_epoch(), samples[split:],
                       [Top1Accuracy()], args.batch_size)
    t0 = time.perf_counter()
    trained = opt.optimize()
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    results = Evaluator(trained).test(samples[split:], [Top1Accuracy()],
                                      batch_size=args.batch_size)
    acc = results[0][1].result()[0]  # [(method, result), ...]
    print(f"validation accuracy: {acc:.3f}")
    iterations = method.state["neval"] - 1
    print(json.dumps({
        "iterations": iterations, "train_s": train_s,
        "ms_per_step": 1e3 * train_s / max(1, iterations),
        "records_per_sec": iterations * args.batch_size / train_s,
        "train_records": split, "val_records": len(samples) - split,
        "class_num": class_num, "seq_len": args.seq_len,
        "embed_dim": args.embed_dim, "batch_size": args.batch_size,
        "validation_accuracy": acc, "device": str(args.device)}))
    return trained, acc


if __name__ == "__main__":
    main()
