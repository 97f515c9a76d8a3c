"""Shared command-line plumbing of the zoo's train and test mains (port of
``bigdl_tpu/models/train_utils.py``).

The JAX package's flags, plus ``--device`` (default ``cuda``: the port's
device rule; ``--device cpu`` runs a main on the CPU). A model is built
on that device, a ``--model`` snapshot or ``--resume`` checkpoint loaded
onto it. ``--distributed`` trains with the sharded ``DistriOptimizer``
over a ``data`` mesh of every rank (``python -m
bigdl_tpu_torch.tools.launch --procs N`` starts the ranks; alone, the
main is a world of one). Summaries are the port's
``visualization`` writers, flushed when :func:`optimize` returns.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Tuple

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.optim.optim_method import OptimMethod

logger = logging.getLogger("bigdl_tpu_torch.models")


def train_parser(description: str, default_batch: int = 128,
                 default_epochs: int = 5,
                 default_lr: float = 0.01) -> argparse.ArgumentParser:
    """The common TrainParams flags (≙ models/*/Utils.scala trainParser)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--folder", default="./", help="data folder")
    p.add_argument("--model", default=None,
                   help="model snapshot to resume from")
    p.add_argument("--state", default=None,
                   help="optim-state snapshot to resume from")
    p.add_argument("--checkpoint", default=None, help="checkpoint dir")
    p.add_argument("--resume", action="store_true",
                   help="auto-resume from the newest snapshot in --checkpoint")
    p.add_argument("-b", "--batch-size", type=int, default=default_batch)
    p.add_argument("-e", "--max-epoch", type=int, default=default_epochs)
    p.add_argument("-r", "--learning-rate", type=float, default=default_lr)
    p.add_argument("--learning-rate-decay", type=float, default=0.0)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--max-iteration", type=int, default=None,
                   help="stop by iteration count instead of epochs")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel training (not ported yet)")
    p.add_argument("--summary-dir", default=None, help="tensorboard log dir")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device to train on (cuda, or cpu)")
    return p


def test_parser(description: str,
                default_batch: int = 128) -> argparse.ArgumentParser:
    """The common TestParams flags (≙ models/*/Utils.scala testParser)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", required=True, help="model snapshot to evaluate")
    p.add_argument("-b", "--batch-size", type=int, default=default_batch)
    p.add_argument("--device", default="cuda",
                   help="device to evaluate on (cuda, or cpu)")
    return p


def resume(args, fresh_model, fresh_method) -> Tuple[Module, OptimMethod]:
    """(model, optim method): the newest checkpoint in ``--checkpoint``
    with ``--resume``, else the ``--model`` / ``--state`` snapshots, else
    ``fresh_model()`` / ``fresh_method()``."""
    from bigdl_tpu_torch.optim.optimizer import load_latest_checkpoint
    from bigdl_tpu_torch.utils import file as bt_file

    model: Optional[Module] = None
    method: Optional[OptimMethod] = None
    if args.resume and args.checkpoint:
        model, method, tag = load_latest_checkpoint(args.checkpoint,
                                                    device=args.device)
        if model is not None:
            logger.info("resumed from %s (iteration %s)", args.checkpoint,
                        tag)
    if model is None and args.model:
        model = bt_file.load_module(args.model, device=args.device)
    if method is None and args.state:
        method = OptimMethod.load(args.state)
    return (model if model is not None else fresh_model(),
            method if method is not None else fresh_method())


def build_optimizer(args, model, dataset, criterion):
    """The local training loop, ending at ``--max-iteration`` or
    ``--max-epoch``; ``--distributed`` gives the sharded
    ``DistriOptimizer`` over a ``data`` mesh of every rank of the process
    group (a world of one without a launcher)."""
    from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
    from bigdl_tpu_torch.optim.trigger import Trigger

    end = (Trigger.max_iteration(args.max_iteration)
           if args.max_iteration else Trigger.max_epoch(args.max_epoch))
    if args.distributed:
        from bigdl_tpu_torch.parallel import DistriOptimizer, Engine

        return DistriOptimizer(model=model, dataset=dataset,
                               criterion=criterion,
                               batch_size=args.batch_size, end_when=end,
                               mesh=Engine.create_mesh(),
                               parameter_sync="sharded")
    return LocalOptimizer(model=model, dataset=dataset, criterion=criterion,
                          batch_size=args.batch_size, end_when=end)


def wire_common(optimizer, args, val_samples=None, val_methods=None):
    """The shared tail of every train main: a checkpoint every epoch,
    validation every epoch, and the summaries."""
    from bigdl_tpu_torch.optim.trigger import Trigger

    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch(),
                                 is_overwrite=args.overwrite)
    if val_samples is not None and val_methods:
        optimizer.set_validation(Trigger.every_epoch(), val_samples,
                                 val_methods, batch_size=args.batch_size)
    if args.summary_dir:
        from bigdl_tpu_torch.visualization import (TrainSummary,
                                                   ValidationSummary)

        app = os.path.basename(args.summary_dir.rstrip("/")) or "train"
        optimizer.set_train_summary(TrainSummary(args.summary_dir, app))
        optimizer.set_validation_summary(ValidationSummary(args.summary_dir,
                                                           app))
    return optimizer


def optimize(optimizer):
    """``optimizer.optimize()``, then the summaries flushed to disk (the
    writers otherwise flush on their two-second timer, and a main that
    returns may leave the last events unwritten)."""
    try:
        return optimizer.optimize()
    finally:
        for summary in (optimizer.train_summary,
                        optimizer.validation_summary):
            if summary is not None:
                summary.flush()
