"""The launcher: one command that starts a training main with its process
group wired up (port of ``bigdl_tpu/tools/launch.py``, in ``torchrun``'s
terms).

Three ways in:

* **Local grid** (``--procs N``): N ranks on this host, each a fresh
  interpreter (never a fork: a child must not inherit a CUDA context),
  with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT`` set (the port a free one, or
  ``--port``; ``--store-file PATH`` rendezvouses through a file
  instead)::

      python -m bigdl_tpu_torch.tools.launch --procs 4 train.py --epochs 2
      python -m bigdl_tpu_torch.tools.launch --procs 4 --backend gloo \\
          -m bigdl_tpu_torch.example.longcontext.train --seq-parallel 4

  Each rank joins the group (``Engine.init``) and then runs the user's
  script, or ``-m`` module, as ``python script.py args`` would. A rank
  that fails takes the others down, and the launcher exits with the
  first failing rank's code (128 + N for a rank that signal N killed,
  named on stderr). A rank whose main returned leaves the process group
  (a barrier, then ``Engine.reset()``) before its interpreter exits.
* **Explicit cluster** (``--coordinator host:port --num-procs N
  --proc-id R``): this process is rank R of N.
* **Neither**: under an outer launcher that set ``RANK`` and
  ``WORLD_SIZE`` the group is joined from them; otherwise the main runs
  as a world of one.

``--device`` is ``cuda`` (the card, NCCL) by default; ``--device cpu``
gives gloo. ``--backend gloo`` on the card lets ranks share one card
(NCCL refuses two ranks on one device); their collectives then stage CUDA
tensors through host memory (``parallel/collectives.py``).
``--cpu-devices`` of the JAX launcher (virtual devices per process) has
no counterpart: a rank is one process on one device, so only 1 is
accepted.
"""

from __future__ import annotations

import argparse
import os
import runpy
import signal
import socket
import subprocess
import sys
import time

_ENV_DEVICE = "BIGDL_TPU_LAUNCH_DEVICE"
_ENV_BACKEND = "BIGDL_TPU_LAUNCH_BACKEND"
_ENV_STORE = "BIGDL_TPU_LAUNCH_STORE"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _join(device: str, backend, store=None, world=None, rank=None) -> None:
    from bigdl_tpu_torch.parallel import Engine

    if store:
        Engine.init(f"file://{os.path.abspath(store)}", world, rank,
                    device=device, backend=backend or None)
    else:
        Engine.init(device=device, backend=backend or None)


def _run_user_main(script: str, script_args, as_module: bool) -> None:
    """Run the user's main in THIS process, as ``python script.py args``
    / ``python -m pkg.mod args`` would see it."""
    sys.argv = [script] + list(script_args)
    if as_module:
        runpy.run_module(script, run_name="__main__", alter_sys=True)
    else:
        sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
        runpy.run_path(script, run_name="__main__")


def _leave() -> None:
    """Leave the process group after the user's main returned: a barrier
    first (no rank tears its group down while a peer still sends to it),
    then ``Engine.reset()``, which destroys the group. Left to interpreter
    shutdown instead, the backend's threads are destroyed unjoined, and
    C++ ``std::terminate`` aborts a rank whose work has finished."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import Engine

    if dist.is_initialized():
        dist.barrier()
    Engine.reset()


def _exit_code(code: int) -> int:
    """A rank's return code as the launcher's exit code: a rank killed by
    signal N (``Popen.returncode == -N``) gives 128 + N, as a shell
    reports it (``sys.exit(-N)`` would give 256 - N)."""
    return 128 - code if code < 0 else code


def _signal_name(num: int) -> str:
    try:
        return signal.Signals(num).name
    except ValueError:
        return f"signal {num}"


# A rank of the local grid: join the group from the environment, run the
# target, then leave the group. A failing rank exits at once with its code
# (os._exit), so it never waits in a collective for peers that wait for it.
_BOOTSTRAP = f"""
import os, sys, traceback
from bigdl_tpu_torch.tools import launch
tgt, as_mod = sys.argv[1], sys.argv[2] == '1'
try:
    store = os.environ.get('{_ENV_STORE}')
    launch._join(os.environ['{_ENV_DEVICE}'],
                 os.environ.get('{_ENV_BACKEND}'), store,
                 int(os.environ['WORLD_SIZE']), int(os.environ['RANK']))
    launch._run_user_main(tgt, sys.argv[3:], as_mod)
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    if code:
        sys.stderr.flush(); sys.stdout.flush()
        os._exit(code)
except BaseException:
    traceback.print_exc()
    sys.stderr.flush(); sys.stdout.flush()
    os._exit(1)
launch._leave()
"""


def _spawn_local_grid(args) -> int:
    port = args.port or _free_port()
    # the ranks import this package from where the launcher found it
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    procs = []
    for i in range(args.procs):
        env = dict(os.environ, RANK=str(i), WORLD_SIZE=str(args.procs),
                   LOCAL_RANK=str(i), LOCAL_WORLD_SIZE=str(args.procs),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=path)
        env[_ENV_DEVICE] = args.device
        if args.backend:
            env[_ENV_BACKEND] = args.backend
        if args.store_file:
            env[_ENV_STORE] = args.store_file
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _BOOTSTRAP, args.script,
             "1" if args.module else "0", *args.script_args], env=env))
    # poll rather than wait in order: a failed rank strands its peers in
    # collectives, so the first failure kills the survivors
    rc, live = 0, list(procs)
    while live:
        for p in list(live):
            code = p.poll()
            if code is None:
                continue
            live.remove(p)
            if code and not rc:
                rc = _exit_code(code)
                if code < 0:
                    print(f"launch: rank {procs.index(p)} was killed by "
                          f"{_signal_name(-code)} (exit {rc})",
                          file=sys.stderr, flush=True)
                for q in live:
                    q.kill()
        if live:
            time.sleep(0.1)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.tools.launch",
        description="Launch a training main with its torch.distributed "
                    "process group wired (a local grid of N ranks, an "
                    "explicit cluster, or an outer launcher's environment)")
    p.add_argument("--procs", type=int, default=None,
                   help="local grid: start N ranks on this host")
    p.add_argument("--cpu-devices", type=int, default=1,
                   help="only 1: a rank is one process on one device")
    p.add_argument("--port", type=int, default=None,
                   help="local grid: rendezvous port (default: a free one)")
    p.add_argument("--store-file", default=None,
                   help="local grid: rendezvous through a file at this "
                        "path instead of a TCP port")
    p.add_argument("--coordinator", default=None,
                   help="explicit cluster: rendezvous host:port (or a "
                        "tcp:// / file:// URL)")
    p.add_argument("--num-procs", type=int, default=None,
                   help="explicit cluster: the number of ranks")
    p.add_argument("--proc-id", type=int, default=None,
                   help="explicit cluster: this process's rank")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="each rank's device (default: the card)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("-m", "--module", action="store_true",
                   help="treat the target as a module name (python -m)")
    p.add_argument("script", help="training script (or module with -m)")
    p.add_argument("script_args", nargs=argparse.REMAINDER,
                   help="arguments passed through to the script")
    args = p.parse_args(argv)
    if args.cpu_devices != 1:
        p.error("--cpu-devices has no torch counterpart: a rank is one "
                "process on one device; start more ranks with --procs")
    if args.procs is not None:
        if args.procs < 1:
            p.error("--procs must be >= 1")
        return _spawn_local_grid(args)
    if args.coordinator is not None:
        if args.num_procs is None or args.proc_id is None:
            p.error("--coordinator needs --num-procs and --proc-id")
        from bigdl_tpu_torch.parallel import Engine

        Engine.init(args.coordinator, args.num_procs, args.proc_id,
                    device=args.device, backend=args.backend)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        _join(args.device, args.backend)
    else:
        print("launch: single-process run (no --procs, --coordinator or "
              "RANK / WORLD_SIZE)", file=sys.stderr)
    _run_user_main(args.script, args.script_args, args.module)
    _leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
