"""Named training metrics (a copy of ``bigdl_tpu/optim/metrics.py``,
which needs no framework): thread-safe host-side aggregates fed by the
training loop, such as the summed step time."""

from __future__ import annotations

import threading
from typing import Dict


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def set(self, name: str, value: float, parallelism: int = 1) -> None:
        with self._lock:
            self._values[name] = float(value)
            self._counts[name] = int(parallelism)

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0.0) + float(value)
            self._counts.setdefault(name, 1)

    def get(self, name: str):
        """(value, parallelism) — average = value / parallelism."""
        with self._lock:
            return self._values.get(name, 0.0), self._counts.get(name, 1)

    def summary(self, unit: str = "s", scale: float = 1e9) -> str:
        with self._lock:
            lines = ["========== Metrics Summary =========="]
            for name in self._values:
                avg = self._values[name] / max(self._counts[name], 1) / scale
                lines.append(f"{name} : {avg} {unit}")
            lines.append("=====================================")
            return "\n".join(lines)
