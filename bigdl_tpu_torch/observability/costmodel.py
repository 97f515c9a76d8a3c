"""Dispatch-level cost model: FLOPs/bytes per program, roofline class
(port of ``bigdl_tpu/observability/costmodel.py``).

The engine has always known how long a dispatch took (host-measured
walls in :mod:`bigdl_tpu_torch.observability.accounting`); this module tells
it how much *work* each dispatch performed, so the two together answer
the ROADMAP's "as fast as the hardware allows" question with numbers:

* There is no compiler cost analysis to ask here: every dispatch kind
  is priced by the analytic transformer formulas on
  :class:`bigdl_tpu_torch.models.transformer.TransformerLM`
  (``analytic_flops`` / ``analytic_bytes``, params x tokens with an
  attention term, spec-aware through the verify path) — the JAX
  package's fallback, with ``source`` ``"analytic"``.
* :func:`device_peaks` maps the device's name to peak FLOP/s and
  peak HBM bytes/s (env-overridable: ``BIGDL_PEAK_FLOPS``,
  ``BIGDL_PEAK_HBM_GBPS``).
* :class:`DispatchCostModel` folds per-kind program costs together with
  the warm dispatch walls the engine feeds it into achieved FLOP/s,
  achieved bytes/s, arithmetic intensity, a compute-vs-memory-bound
  roofline classification, and the MFU / memory-bandwidth-utilization
  fractions behind the ``bdt_serving_mfu`` /
  ``bdt_serving_membw_util`` gauges.  Mesh-aware: achieved rates are
  per-device (divided by the mesh size) before comparing to the
  single-card peaks.
* :class:`LoopPhaseAccumulator` times the engine loop's host-side
  phases so the device-idle fraction (``1 - busy/wall``) decomposes
  into named bubbles — "why is MFU low" has an answer next to the MFU
  number itself.

Everything here is host-side arithmetic over numbers the engine already
measures; nothing touches the device.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = [
    "PEAK_TABLE", "DEFAULT_PEAKS", "ENV_PEAK_FLOPS", "ENV_PEAK_HBM_GBPS",
    "device_peaks", "peak_flops",
    "DispatchCostModel", "LoopPhaseAccumulator",
]

#: Per-device-kind peaks: substring of the device's name (lowercased) ->
#: (peak FLOP/s at bf16, peak HBM bytes/s).  Matched longest-substring
#: first so "H100 PCIe" wins over "H100".  The H100 rows are NVIDIA's
#: data-sheet dense bf16 peaks and HBM rates at the full power limit:
#: the SXM part ("NVIDIA H100 80GB HBM3") and the PCIe part. The TPU
#: rows are the JAX package's table, kept so one table prices both; the
#: cpu entry is the JAX package's deliberately conservative figure.
PEAK_TABLE: Dict[str, tuple] = {
    "h100 pcie": (756e12, 2.0e12),
    "h100": (989e12, 3.35e12),
    "tpu v6 lite": (918e12, 1.64e12),
    "tpu v6e": (918e12, 1.64e12),
    "tpu v5 lite": (197e12, 0.82e12),
    "tpu v5e": (197e12, 0.82e12),
    "tpu v5": (459e12, 2.77e12),
    "tpu v4": (275e12, 1.23e12),
    "cpu": (5e11, 5e10),
}

#: Fallback when the device kind matches nothing in the table.
DEFAULT_PEAKS = (5e11, 5e10)

#: Env override for peak FLOP/s (a plain float, e.g. ``197e12``).
ENV_PEAK_FLOPS = "BIGDL_PEAK_FLOPS"

#: Env override for peak HBM bandwidth in **GB/s** (e.g. ``819``).
ENV_PEAK_HBM_GBPS = "BIGDL_PEAK_HBM_GBPS"


def _device_kind(device=None) -> str:
    """The device's name: ``torch.cuda.get_device_name`` for a CUDA
    device (default: CUDA device 0 where there is a card), ``"cpu"``
    otherwise."""
    import torch

    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device              # a device-kind string given directly
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def device_peaks(device=None) -> dict:
    """Peak FLOP/s and HBM bytes/s for ``device`` (a ``torch.device``,
    a device string, or a device-kind name; default: CUDA device 0, or
    the CPU without a card), with env overrides applied.

    Returns ``{"device_kind", "flops_per_s", "hbm_bytes_per_s",
    "source"}`` where ``source`` is ``"table"``, ``"default"``, or
    ``"env"`` (when either override is set).
    """
    kind = _device_kind(device)
    low = kind.lower()
    flops, bw = DEFAULT_PEAKS
    source = "default"
    for sub in sorted(PEAK_TABLE, key=len, reverse=True):
        if sub in low:
            flops, bw = PEAK_TABLE[sub]
            source = "table"
            break
    env_f = os.environ.get(ENV_PEAK_FLOPS)
    env_b = os.environ.get(ENV_PEAK_HBM_GBPS)
    try:
        if env_f:
            flops = float(env_f)
            source = "env"
        if env_b:
            bw = float(env_b) * 1e9
            source = "env"
    except ValueError:
        pass
    return {"device_kind": kind, "flops_per_s": float(flops),
            "hbm_bytes_per_s": float(bw), "source": source}


def peak_flops(device=None) -> float:
    """Peak FLOP/s only."""
    return device_peaks(device)["flops_per_s"]


def _roofline(intensity: Optional[float], ridge: float) -> Optional[str]:
    if intensity is None:
        return None
    return "compute-bound" if intensity >= ridge else "memory-bound"


class DispatchCostModel:
    """Folds static per-kind program costs into live roofline numbers.

    The engine registers one cost per dispatch kind at warmup
    (:meth:`set_program_cost`, sums over the kind's programs — e.g.
    decode under speculation is propose + verify), then feeds every
    *warm* dispatch wall through :meth:`charge`.  Cold (first-call)
    dispatches are excluded from both numerator and denominator,
    mirroring the usage ledger.  Thread-safe: the loop thread charges
    while HTTP/stats threads read.
    """

    KINDS = ("prefill", "decode")

    def __init__(self, peaks: Optional[dict] = None, devices: int = 1):
        self.peaks = dict(peaks) if peaks else device_peaks()
        self.devices = max(1, int(devices))
        self._lock = threading.Lock()
        self._flops = {k: 0.0 for k in self.KINDS}   # per dispatch
        self._bytes = {k: 0.0 for k in self.KINDS}   # per dispatch
        self._source = {k: None for k in self.KINDS}
        self._n = {k: 0 for k in self.KINDS}          # warm dispatches
        self._wall = {k: 0.0 for k in self.KINDS}     # warm walls (s)

    # -- static program costs (once, at warmup) -----------------------
    def set_program_cost(self, kind: str, flops: float, bytes_accessed:
                         float, source: str) -> None:
        """Record the per-dispatch cost of ``kind`` (sum its programs
        before calling)."""
        with self._lock:
            self._flops[kind] = float(flops)
            self._bytes[kind] = float(bytes_accessed)
            self._source[kind] = source

    # -- live walls ----------------------------------------------------
    def charge(self, kind: str, wall_s: float, warm: bool = True) -> None:
        """Account one dispatch of ``kind``; only warm dispatches count
        (a cold wall is mostly first-call set-up, not work)."""
        if not warm or wall_s <= 0.0:
            return
        with self._lock:
            self._n[kind] += 1
            self._wall[kind] += wall_s

    # -- derived -------------------------------------------------------
    def _kind_summary(self, kind: str) -> dict:
        peak_f = self.peaks["flops_per_s"]
        peak_b = self.peaks["hbm_bytes_per_s"]
        ridge = peak_f / max(peak_b, 1e-9)
        n, wall = self._n[kind], self._wall[kind]
        fd, bd = self._flops[kind], self._bytes[kind]
        out = {
            "dispatches": n,
            "wall_s": round(wall, 6),
            "flops_per_dispatch": fd,
            "bytes_per_dispatch": bd,
            "flops_source": self._source[kind],
            "achieved_flops_per_s": None,
            "achieved_bytes_per_s": None,
            "arithmetic_intensity": None,
            "ridge_intensity": round(ridge, 3),
            "roofline": None,
            "mfu": None,
            "membw_util": None,
        }
        if bd > 0.0:
            out["arithmetic_intensity"] = round(fd / bd, 3)
        if n == 0 or wall <= 0.0 or fd <= 0.0:
            out["roofline"] = _roofline(out["arithmetic_intensity"], ridge)
            return out
        # achieved rates are per device: the wall is one host-side
        # span during which every mesh device ran its shard of the
        # program, and fd/bd are whole-program (all-shard) totals.
        af = fd * n / wall / self.devices
        ab = bd * n / wall / self.devices if bd > 0.0 else None
        out["achieved_flops_per_s"] = af
        out["achieved_bytes_per_s"] = ab
        out["mfu"] = round(af / peak_f, 6)
        if ab is not None:
            out["membw_util"] = round(ab / peak_b, 6)
        out["roofline"] = _roofline(out["arithmetic_intensity"], ridge)
        return out

    def rates(self, kind: str):
        """(mfu, membw_util) for the gauges; ``(None, None)`` before
        any warm dispatch of ``kind``."""
        with self._lock:
            s = self._kind_summary(kind)
        return s["mfu"], s["membw_util"]

    def summary(self) -> dict:
        """The ``stats()["cost"]`` block: peaks, per-kind roofline
        numbers, and a wall-weighted overall MFU/bandwidth figure."""
        with self._lock:
            kinds = {k: self._kind_summary(k) for k in self.KINDS}
            tot_wall = sum(self._wall.values())
            tot_flops = sum(self._flops[k] * self._n[k] for k in self.KINDS)
            tot_bytes = sum(self._bytes[k] * self._n[k] for k in self.KINDS)
        overall = {"wall_s": round(tot_wall, 6), "mfu": None,
                   "membw_util": None, "achieved_flops_per_s": None,
                   "achieved_bytes_per_s": None}
        if tot_wall > 0.0 and tot_flops > 0.0:
            af = tot_flops / tot_wall / self.devices
            overall["achieved_flops_per_s"] = af
            overall["mfu"] = round(af / self.peaks["flops_per_s"], 6)
        if tot_wall > 0.0 and tot_bytes > 0.0:
            ab = tot_bytes / tot_wall / self.devices
            overall["achieved_bytes_per_s"] = ab
            overall["membw_util"] = round(
                ab / self.peaks["hbm_bytes_per_s"], 6)
        return {
            "device_kind": self.peaks["device_kind"],
            "devices": self.devices,
            "peak_flops_per_s": self.peaks["flops_per_s"],
            "peak_hbm_bytes_per_s": self.peaks["hbm_bytes_per_s"],
            "peak_source": self.peaks["source"],
            "kinds": kinds,
            "overall": overall,
        }


class LoopPhaseAccumulator:
    """Attributes engine-loop wall time to named host-side phases.

    The loop thread brackets each phase with :meth:`add` (measured
    boundary-to-boundary, so per-iteration phase seconds sum to the
    iteration wall by construction) and reports device dispatches
    through :meth:`dispatch`, which also accumulates the *warm* walls
    into the device-busy pool — the same walls, at the same call sites,
    that the usage ledger charges, so
    ``device_idle_fraction == 1 - occupancy-ledger busy / devices /
    wall`` reconciles to float precision.
    """

    PHASES = ("sweep", "admission", "prefill_dispatch",
              "decode_dispatch", "deliver", "observe")

    def __init__(self):
        self._lock = threading.Lock()
        self._phase = {p: 0.0 for p in self.PHASES}
        self._busy = 0.0
        self._iters = 0
        self._t0 = time.monotonic()

    def add(self, phase: str, seconds: float) -> None:
        if seconds <= 0.0:
            return
        with self._lock:
            self._phase[phase] += seconds

    def dispatch(self, phase: str, wall_s: float, warm: bool = True
                 ) -> None:
        """One device dispatch inside ``phase``: the wall always counts
        toward the phase; only warm walls count as device-busy."""
        if wall_s <= 0.0:
            return
        with self._lock:
            self._phase[phase] += wall_s
            if warm:
                self._busy += wall_s

    def iteration(self) -> None:
        with self._lock:
            self._iters += 1

    def summary(self) -> dict:
        """The ``stats()["loop"]`` block.  ``fractions`` divide each
        phase by the *accounted* wall (the sum of phase seconds), so
        they sum to 1.0 exactly; ``wall_s`` is the accumulator's
        lifetime for context, and ``device_idle_fraction`` is
        ``1 - busy / accounted wall`` — the share of loop time the
        device sat idle, decomposed by the non-dispatch phases."""
        with self._lock:
            phases = dict(self._phase)
            busy = self._busy
            iters = self._iters
            wall = time.monotonic() - self._t0
        accounted = sum(phases.values())
        fractions = {p: (phases[p] / accounted if accounted > 0.0 else 0.0)
                     for p in self.PHASES}
        return {
            "iterations": iters,
            "wall_s": round(wall, 6),
            "accounted_s": round(accounted, 6),
            "phases": {p: round(v, 6) for p, v in phases.items()},
            "fractions": {p: round(v, 6) for p, v in fractions.items()},
            "device_busy_s": round(busy, 9),
            "device_busy_fraction": round(
                busy / accounted if accounted > 0.0 else 0.0, 6),
            "device_idle_fraction": round(
                1.0 - (busy / accounted if accounted > 0.0 else 0.0), 6),
        }
