"""TensorBoard summaries (port of ``bigdl_tpu/visualization``).

``TrainSummary`` / ``ValidationSummary`` plug into the Optimizer via
``set_train_summary`` / ``set_validation_summary`` and read back with
``read_scalar``.
"""

from __future__ import annotations

import os
from typing import Optional

from bigdl_tpu_torch.visualization.tensorboard import FileWriter, read_scalar


class Summary:
    """Base writer bound to logDir/appName (≙ visualization/Summary.scala:32)."""

    folder = ""

    def __init__(self, log_dir: str, app_name: str):
        self.log_dir = log_dir
        self.app_name = app_name
        self._dir = os.path.join(log_dir, app_name, self.folder)
        self._writer = FileWriter(self._dir)

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self._writer.add_scalar(tag, value, step)
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self._writer.add_histogram(tag, values, step)
        return self

    def read_scalar(self, tag: str):
        self._writer.flush()
        return read_scalar(self._dir, tag)

    def flush(self) -> "Summary":
        self._writer.flush()
        return self

    def close(self) -> None:
        self._writer.close()


class TrainSummary(Summary):
    """Training-side scalars: Loss / Throughput / LearningRate (+ optional
    Parameters histograms; ≙ visualization/TrainSummary.scala:32)."""

    folder = "train"

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name)
        self._triggers = {}

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        """≙ TrainSummary.setSummaryTrigger — gate optional tags
        ("Parameters", "LearningRate") on a Trigger."""
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(Summary):
    """Validation metric scalars (≙ visualization/ValidationSummary.scala)."""

    folder = "validation"
