"""A PTB-style word language model (port of
``bigdl_tpu/example/languagemodel/train.py``; ≙ example/languagemodel/
PTBModel + PTBWordLM.scala): ``LookupTable`` -> ``Recurrent(LSTM)`` ->
``TimeDistributed(Linear)`` -> ``LogSoftMax``, trained with Adagrad on a
token stream cut into ``--num-steps`` windows.

Run: ``python -m bigdl_tpu_torch.example.languagemodel.train [--data
ptb.train.txt] [--device cpu]``. Without ``--data`` a synthetic corpus
of rolled arithmetic progressions is used, so the example runs offline.
The last line printed is a JSON summary: iterations, ms a step and
records/s of the training loop.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.dataset import LocalDataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.device import DEFAULT_DEVICE
from bigdl_tpu_torch.optim.optim_method import Adagrad
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.random import RandomGenerator


def build_model(vocab: int, embed: int = 64, hidden: int = 128, *,
                device=DEFAULT_DEVICE, seed: int = 1) -> nn.Module:
    """≙ PTBModel's recurrent branch, weights from one seeded stream."""
    rng = RandomGenerator(seed)
    kw = dict(rng=rng, device=device)
    return (nn.Sequential()
            .add(nn.LookupTable(vocab, embed, **kw))
            .add(nn.Recurrent(nn.LSTM(embed, hidden, **kw)))
            .add(nn.TimeDistributed(nn.Linear(hidden, vocab, **kw)))
            .add(nn.LogSoftMax()))


def load_tokens(path, vocab: int, n_tokens: int = 4000):
    """(1-based token stream, vocabulary size): the words of ``path``
    numbered in order of first appearance, or the synthetic corpus."""
    if path:
        with open(path) as f:
            words = f.read().split()
        idx = {}
        stream = []
        for w in words:
            idx.setdefault(w, len(idx) + 1)
            stream.append(idx[w])
        return np.asarray(stream, np.int64), len(idx) + 1
    rng = np.random.RandomState(0)
    base = np.arange(1, vocab)
    stream = np.concatenate([np.roll(base, -s)[:vocab // 2]
                             for s in rng.randint(0, vocab, 40)])
    return stream[:n_tokens], vocab


def windows(stream: np.ndarray, num_steps: int):
    """Samples of ``num_steps`` tokens, each labelled with the next
    ``num_steps``."""
    n = (len(stream) - 1) // num_steps
    samples = []
    for i in range(n):
        x = stream[i * num_steps:(i + 1) * num_steps]
        y = stream[i * num_steps + 1:(i + 1) * num_steps + 1]
        samples.append(Sample(x.astype(np.int64), y.astype(np.int64)))
    return samples


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PTB word LM (≙ PTBWordLM.scala)")
    p.add_argument("--data", default=None, help="PTB token file (optional)")
    p.add_argument("--vocab", type=int, default=40)
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-epoch", type=int, default=2)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--embed", type=int, default=32)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device to train on (cuda, or cpu)")
    return p


def main(argv=None):
    """Train; returns the trained model, as the JAX main does."""
    args = parser().parse_args(argv)
    stream, vocab = load_tokens(args.data, args.vocab)
    samples = windows(stream, args.num_steps)
    model = build_model(vocab, args.embed, args.hidden, device=args.device)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
    method = Adagrad(learning_rate=0.1)
    opt = Optimizer(model=model, dataset=LocalDataSet(samples),
                    criterion=crit, batch_size=args.batch_size,
                    end_when=Trigger.max_epoch(args.max_epoch))
    opt.set_optim_method(method)
    t0 = time.perf_counter()
    trained = opt.optimize()
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    iterations = method.state["neval"] - 1
    print(json.dumps({
        "iterations": iterations, "train_s": train_s,
        "ms_per_step": 1e3 * train_s / max(1, iterations),
        "records_per_sec": iterations * args.batch_size / train_s,
        "windows": len(samples), "vocab": vocab, "embed": args.embed,
        "hidden": args.hidden, "num_steps": args.num_steps,
        "batch_size": args.batch_size, "last_loss": float(
            method.state["Loss"]), "device": str(args.device)}))
    return trained


if __name__ == "__main__":
    main()
