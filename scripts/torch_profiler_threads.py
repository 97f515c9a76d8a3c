"""Does a ``torch.profiler`` session hold the CUDA kernels that another
thread launches? The check behind ``observability/profiler.py``'s
hosted captures. Needs a CUDA card::

    python3 scripts/torch_profiler_threads.py [--trials 30]
        [--seconds 0.25] [--variants unhosted,hosted,...]

Each variant runs in a fresh interpreter: one CUDA graph and three short
sessions on the main thread first (as the smoke script's earlier phases
do), then ``--trials`` sessions of ``--seconds`` each, counting the
kernel events (``"cat": "kernel"``) and the ``cudaLaunchKernel`` runtime
events of each session's Chrome trace. A worker thread launches 100
elementwise kernels and synchronizes, over and over, unless the variant
says otherwise:

- ``unhosted``: the main thread asks ``profiler.capture`` with no host;
- ``teardown_off``: the same with ``TEARDOWN_CUPTI=0``;
- ``sync_before_stop``: a session on the main thread that synchronizes
  the device before it stops;
- ``all_threads``: a session with ``profile_all_threads=True``;
- ``one_core``: ``unhosted`` with the process bound to one CPU;
- ``main_launches``: no worker; the main thread launches inside its
  own sessions;
- ``worker_sessions``: the worker starts and stops its own sessions;
- ``hosted``: the worker runs inside ``profiler.hosting`` and polls
  between its batches; the main thread asks ``profiler.capture``.

Prints one JSON line a variant (``empty`` counts the sessions without a
kernel), then the card's name and power limit. With ``--kineto-log``
each variant runs with ``KINETO_LOG_LEVEL=0``, and its line adds, from
Kineto's log, each session's "CPU GPU out-of-order" count (three
warm-up sessions first) and the first warnings' gaps by which a kernel
started before its launch, in ns (Kineto's warning labels the
difference of its ns timestamps "us").
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("unhosted", "teardown_off", "sync_before_stop", "all_threads",
            "one_core", "main_launches", "worker_sessions", "hosted")


def _counts(path: str):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name") == "cudaLaunchKernel")
    return kernels, launches


def _trace_of(artifact: str) -> str:
    return os.path.join(artifact, next(
        f for f in os.listdir(artifact) if f.endswith(".json")))


def _launch_batch(torch, x):
    for _ in range(100):
        x = x * 1.0001
    torch.cuda.synchronize()
    return x


def _session(torch, seconds: float, launch=None, sync=False, **kw) -> str:
    """One raw session of ``seconds`` on this thread; its trace's path."""
    from torch.profiler import ProfilerActivity, profile

    p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                **kw)
    p.start()
    t_end = time.monotonic() + seconds
    if launch is None:
        time.sleep(seconds)
    else:
        while time.monotonic() < t_end:
            launch()
    if sync:
        torch.cuda.synchronize()
    p.stop()
    path = os.path.join(tempfile.mkdtemp(prefix="bdt_threads_"),
                        "trace.json")
    p.export_chrome_trace(path)
    return path


def run_variant(variant: str, trials: int, seconds: float) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    from bigdl_tpu_torch.observability import profiler

    if variant == "one_core":
        os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[0]})
    x = torch.randn(4096, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        x * 2
    graph.replay()
    for _ in range(3):
        _session(torch, 0.01, launch=lambda: _launch_batch(torch, x))
    rows, stop = [], threading.Event()

    def worker():
        y = torch.randn(4096, device="cuda")
        if variant == "worker_sessions":
            for _ in range(trials):
                state = {"y": y}

                def launch():
                    state["y"] = _launch_batch(torch, state["y"])

                rows.append(_counts(_session(torch, seconds, launch)))
            return
        if variant == "hosted":
            with profiler.hosting():
                while not stop.is_set():
                    profiler.poll()
                    y = _launch_batch(torch, y)
            return
        while not stop.is_set():
            y = _launch_batch(torch, y)

    th = None
    if variant != "main_launches":
        th = threading.Thread(target=worker, daemon=True)
        th.start()
        time.sleep(0.5)
    if variant != "worker_sessions":
        kw = {}
        if variant == "all_threads":
            from torch._C._profiler import _ExperimentalConfig
            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        state = {"x": x}

        def launch():
            state["x"] = _launch_batch(torch, state["x"])

        for _ in range(trials):
            if variant in ("unhosted", "teardown_off", "one_core", "hosted"):
                path = _trace_of(profiler.capture(seconds))
            else:
                path = _session(
                    torch, seconds,
                    launch if variant == "main_launches" else None,
                    sync=variant == "sync_before_stop", **kw)
            rows.append(_counts(path))
    stop.set()
    if th is not None:
        th.join()
    return {"variant": variant, "torch": torch.__version__,
            "trials": trials, "seconds": seconds,
            "empty": sum(1 for k, _ in rows if k == 0),
            "kernels": [k for k, _ in rows],
            "runtime_launches": [n for _, n in rows]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=30)
    ap.add_argument("--seconds", type=float, default=0.25)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kineto-log", action="store_true")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_threads: needs a CUDA card", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(run_variant(args.one, args.trials, args.seconds)),
              flush=True)
        return 0
    rc = 0
    for v in args.variants.split(","):
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}; one of {VARIANTS}")
        env = dict(os.environ)
        if v == "teardown_off":
            env["TEARDOWN_CUPTI"] = "0"
        if args.kineto_log:
            env["KINETO_LOG_LEVEL"] = "0"
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", v,
             "--trials", str(args.trials), "--seconds", str(args.seconds)],
            env=env, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode or not lines:
            rc = 1
            print(json.dumps({"variant": v, "rc": out.returncode,
                              "stderr": out.stderr[-2000:]}), flush=True)
        elif args.kineto_log:
            row = json.loads(lines[-1])
            row["out_of_order"] = [int(n) for n in re.findall(
                r"CPU GPU out-of-order = (\d+)", out.stderr)]
            row["gpu_before_launch_ns"] = [int(n) for n in re.findall(
                r"GPU op timestamp \(\d+\) < runtime timestamp \(\d+\) "
                r"by (\d+)us", out.stderr)]
            print(json.dumps(row), flush=True)
        else:
            print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
