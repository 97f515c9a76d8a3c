"""A world of ranks for the port's distributed tests.

``World(n, tmpdir)`` spawns ``n`` processes (the ``spawn`` start method:
a child never inherits the parent's state) that join one gloo process
group through a ``FileStore`` under ``tmpdir`` (no TCP port to collide
under ``pytest -n``) with ``Engine.init(device="cpu")``, and then serve
jobs: ``world.run(job, *args)`` calls ``job(*args)`` on every rank and
returns the per-rank results in rank order, raising with a rank's
traceback where one failed. A test file runs all its cases in one
world: ``World.shared(n)``, which the files that one ``pytest -n``
worker runs share (a world takes ~4 s and ~17 CPU-seconds to start), or
a world of its own where its jobs change a rank's defaults (the default
mesh), closed by the file.

The jobs live in modules that import neither JAX nor the JAX package
(``tests/torch_jobs_*.py``), so a child imports only torch and the port;
their arguments and results are numpy arrays and plain values. The
tests compute the JAX side in their own process.
"""

from __future__ import annotations

import atexit
import importlib
import multiprocessing as mp
import os
import shutil
import tempfile
import traceback

import numpy as np

JOB_TIMEOUT_S = 240


def _serve(rank: int, world: int, store: str, conn) -> None:
    import torch

    torch.set_num_threads(1)
    from bigdl_tpu_torch.parallel import Engine

    Engine.init(f"file://{store}", world, rank, device="cpu")
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, args, kw = msg
        mod, fn = name.split(":")
        try:
            out = ("ok", getattr(importlib.import_module(mod), fn)(*args,
                                                                   **kw))
        except BaseException:  # the parent raises it with the traceback
            out = ("err", traceback.format_exc())
        conn.send(out)
    Engine.reset()


_SHARED: dict = {}


class World:
    """``n`` ranks over gloo on the CPU (see the module docstring)."""

    def __init__(self, n: int, tmpdir: str):
        ctx = mp.get_context("spawn")
        store = os.path.join(str(tmpdir), f"store-{n}")
        self.n = n
        self.closed = False
        self.conns, self.procs = [], []
        for r in range(n):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=_serve, args=(r, n, store, theirs),
                            daemon=True)
            p.start()
            self.conns.append(ours)
            self.procs.append(p)

    @classmethod
    def shared(cls, n: int) -> "World":
        """This process's ``n``-rank world: started by the first caller
        (or anew where a job's timeout closed it), closed at exit. Its
        users' jobs leave each rank's default mesh as they found it."""
        w = _SHARED.get(n)
        if w is None or w.closed:
            tmp = tempfile.mkdtemp(prefix=f"world{n}-")
            w = _SHARED[n] = cls(n, tmp)
            atexit.register(shutil.rmtree, tmp, ignore_errors=True)
            atexit.register(w.close)
        return w

    def run(self, job, *args, **kw) -> list:
        """``job(*args, **kw)`` on every rank; the results in rank
        order."""
        name = f"{job.__module__}:{job.__qualname__}"
        for c in self.conns:
            c.send((name, args, kw))
        out, errs = [], []
        for r, c in enumerate(self.conns):
            if not c.poll(JOB_TIMEOUT_S):
                self.close()
                raise TimeoutError(f"rank {r} gave no result for {name} "
                                   f"in {JOB_TIMEOUT_S} s")
            status, value = c.recv()
            out.append(value)
            if status != "ok":
                errs.append(f"rank {r}:\n{value}")
        if errs:
            raise RuntimeError("\n".join(errs))
        return out

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for c in self.conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()


# ----------------------------------------------------------------- helpers
def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def arrays(tree):
    """tensors -> numpy leaves (nested dicts, lists)."""
    if isinstance(tree, dict):
        return {k: arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [arrays(v) for v in tree]
    return tree.detach().float().numpy().copy() if hasattr(tree, "detach") \
        else tree


def my_rows(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """This rank's contiguous block of ``x`` along ``axis``."""
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    per = x.shape[axis] // n
    return np.take(x, np.arange(r * per, (r + 1) * per), axis=axis)
