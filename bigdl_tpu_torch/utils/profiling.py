"""Device-time breakdown of a piece of work on the card, by
``torch.profiler``.

:func:`device_profile` traces one call and sums the CUDA kernels' device
time by name, and takes the device's busy time as the union of the
kernels' intervals (overlapping kernels counted once): the idle share is
``1 - busy / wall``. The profiler's own cost inflates the wall time, so
the idle share is an upper bound. It also sums the device time of each
PyTorch operation (``aten::mm``, ``aten::copy_``, ...) by the shapes of
its inputs, which names the elementwise kernels the kernel list cannot
and tells one copy from another; a kernel launched outside PyTorch (the
port's ctypes kernels) counts only in the kernel list. Needs a CUDA
card.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence


def _busy_us(events) -> float:
    """Union of the events' [start, end) intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_profile(fn: Callable[[], object], top: int = 12,
                   named: Sequence[str] = ()) -> Dict:
    """Trace ``fn()`` (synchronized before and after) and return its wall
    ms, summed kernel ms, device busy ms and idle share, the number of
    kernel launches, the ``top`` kernels by device ms as ``[name, ms,
    share of the kernel ms]`` and the ``top`` PyTorch operations, by
    input shapes, as ``[name, shapes, ms, share, calls]``; with ``named``,
    also ``named_kernels_ms``: for each string, the device ms of the
    kernels whose name holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    by_name: Dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    busy = _busy_us(kernels)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = sorted(((a.key, str(a.input_shapes)[:100],
                   a.self_device_time_total, a.count)
                  for a in prof.key_averages(group_by_input_shape=True)
                  if a.device_type.name == "CPU"
                  and a.self_device_time_total > 0), key=lambda r: -r[2])
    found = {s: sum(us for n, us in by_name.items() if s in n) / 1e3
             for s in named}
    return {"wall_ms": wall_us / 1e3, "device_kernel_ms": total / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_launches": len(kernels),
            "top_kernels_ms": [[n[:90], us / 1e3, us / total if total
                                else 0.0] for n, us in rows],
            "top_ops_ms": [[n, shapes, us / 1e3, us / total if total
                            else 0.0, calls]
                           for n, shapes, us, calls in ops[:top]],
            **({"named_kernels_ms": found} if named else {})}
