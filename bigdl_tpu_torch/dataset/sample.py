"""Sample: one training record of feature and label arrays (port of
``bigdl_tpu/dataset/sample.py``).

Features and labels are numpy arrays on the host, and a sparse feature
stays a ``SparseTensor`` (``nn/sparse.py``), which ``SampleToMiniBatch``
batches into a ``SparseMiniBatch``; they reach the device when the batch
is staged there.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from bigdl_tpu_torch.nn.sparse import SparseTensor


def _as_feature(f):
    return f if isinstance(f, SparseTensor) else np.asarray(f)


class Sample:
    __slots__ = ("features", "labels")

    def __init__(self, features, labels=None):
        if isinstance(features, np.ndarray) or not isinstance(
                features, (list, tuple)):
            features = [features]
        self.features: List[np.ndarray] = [_as_feature(f) for f in features]
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
