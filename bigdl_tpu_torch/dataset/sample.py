"""Sample: one training record of feature and label arrays (port of
``bigdl_tpu/dataset/sample.py``, dense features only: sparse features
come with the sparse layers).

Features and labels are numpy arrays on the host; they reach the device
when a MiniBatch is staged there.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Sample:
    __slots__ = ("features", "labels")

    def __init__(self, features, labels=None):
        if isinstance(features, np.ndarray) or not isinstance(
                features, (list, tuple)):
            features = [features]
        self.features: List[np.ndarray] = [np.asarray(f) for f in features]
        if labels is None:
            labels = []
        elif isinstance(labels, np.ndarray) or not isinstance(
                labels, (list, tuple)):
            labels = [labels]
        self.labels: List[np.ndarray] = [np.asarray(x) for x in labels]

    def feature(self, index: int = 0) -> np.ndarray:
        return self.features[index]

    def label(self, index: int = 0) -> Optional[np.ndarray]:
        return self.labels[index] if self.labels else None

    def num_feature(self) -> int:
        return len(self.features)

    def num_label(self) -> int:
        return len(self.labels)

    def __repr__(self):
        f = ",".join(str(x.shape) for x in self.features)
        lab = ",".join(str(x.shape) for x in self.labels)
        return f"Sample(features=[{f}], labels=[{lab}])"
