"""DataFrame estimators (port of ``bigdl_tpu/dlframes/dlframes.py``).

A sklearn-style estimator over DataFrame columns, the role Spark-ML's
Estimator / Transformer played in the reference: ``fit`` builds
``Sample``s from the feature and label columns and drives the port's
``Optimizer`` on the device of the model's parameters, and
``transform`` runs the model in eval mode under ``no_grad``, batch by
batch, and appends the prediction column. ``get_params`` /
``set_params`` follow the sklearn contract (``sklearn.base.clone``
rebuilds an estimator from them), under the JAX package's names and
``_param_names``.

A DataFrame here is anything with ``df[col].tolist()`` (read),
``df.copy()``, ``df[col] = values`` and ``len(df)``: pandas is imported
only by ``DLImageReader``, which builds one. The JAX package pads the
tail batch so ``jit`` sees one shape; eager PyTorch needs no padding,
except that a lone tail row is stacked with a copy of itself
(``optim.evaluator.no_lone_row``), and the predictions of every row,
tail rows included, are the same.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.optim.evaluator import model_device, no_lone_row
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger


class _Params:
    """sklearn-style param plumbing shared by estimator and model."""

    _param_names: Sequence[str] = ()

    def get_params(self, deep: bool = True) -> dict:
        return {k: getattr(self, k) for k in self._param_names}

    def set_params(self, **kv) -> "_Params":
        for k, v in kv.items():
            if k not in self._param_names:
                raise ValueError(
                    f"unknown param {k!r}; valid: {sorted(self._param_names)}")
            setattr(self, k, v)
        return self

    # the reference's setter chains (setFeaturesCol etc.)
    def _chain(self, name, value):
        setattr(self, name, value)
        return self


def _column_array(df, col: str, size: Sequence[int]) -> np.ndarray:
    """A column of scalars / lists / arrays as an (n,) + size f32
    array."""
    vals = df[col].tolist()
    return np.asarray(
        [np.asarray(v, np.float32).reshape(tuple(size)) for v in vals],
        np.float32)


class DLEstimator(_Params):
    """``DLEstimator(model, criterion, feature_size, label_size)
    .set_features_col("f").set_label_col("l").fit(df) -> DLModel``."""

    # the constructor's arguments, so that sklearn's clone
    # (type(est)(**est.get_params())) rebuilds the estimator
    _param_names = ("model", "criterion", "feature_size", "label_size",
                    "features_col", "label_col", "prediction_col",
                    "batch_size", "max_epoch", "learning_rate",
                    "learning_rate_decay")

    def __init__(self, model: Module, criterion, feature_size: Sequence[int],
                 label_size: Sequence[int], features_col: str = "features",
                 label_col: str = "label", prediction_col: str = "prediction",
                 batch_size: int = 32, max_epoch: int = 50,
                 learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0):
        self.model = model
        self.criterion = criterion
        # stored as given: sklearn's clone wants them unmodified
        self.feature_size = feature_size
        self.label_size = label_size
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.batch_size = batch_size
        self.max_epoch = max_epoch
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.optim_method: Optional[OptimMethod] = None
        self.end_when: Optional[Trigger] = None
        self.validation: Optional[tuple] = None
        self.train_summary = None
        self.validation_summary = None

    # ------------------------------------------------ reference setters
    def set_features_col(self, v):
        return self._chain("features_col", v)

    def set_label_col(self, v):
        return self._chain("label_col", v)

    def set_prediction_col(self, v):
        return self._chain("prediction_col", v)

    def set_batch_size(self, v):
        return self._chain("batch_size", v)

    def set_max_epoch(self, v):
        return self._chain("max_epoch", v)

    def set_learning_rate(self, v):
        return self._chain("learning_rate", v)

    def set_learning_rate_decay(self, v):
        return self._chain("learning_rate_decay", v)

    def set_optim_method(self, m: OptimMethod):
        return self._chain("optim_method", m)

    def set_end_when(self, t: Trigger):
        return self._chain("end_when", t)

    def set_validation(self, trigger, df, methods, batch_size):
        """Validate on ``df`` whenever ``trigger`` fires."""
        self.validation = (trigger, df, methods, batch_size)
        return self

    def set_train_summary(self, s):
        return self._chain("train_summary", s)

    def set_validation_summary(self, s):
        return self._chain("validation_summary", s)

    # -------------------------------------------------------------- fit
    def _samples(self, df, with_label=True):
        feats = _column_array(df, self.features_col, self.feature_size)
        if not with_label:
            return [Sample(f) for f in feats]
        labels = _column_array(df, self.label_col, self.label_size)
        return [Sample(f, l) for f, l in zip(feats, labels)]

    def _make_model(self, trained: Module) -> "DLModel":
        m = DLModel(trained, self.feature_size)
        m.features_col = self.features_col
        m.prediction_col = self.prediction_col
        m.batch_size = self.batch_size
        return m

    def fit(self, df) -> "DLModel":
        """Train the model on ``df`` (on its parameters' device) and
        return the fitted :class:`DLModel`."""
        from bigdl_tpu_torch.optim.optimizer import Optimizer

        samples = self._samples(df)
        method = self.optim_method or SGD(
            learning_rate=self.learning_rate,
            learning_rate_decay=self.learning_rate_decay)
        end = self.end_when or Trigger.max_epoch(self.max_epoch)
        opt = Optimizer(model=self.model, dataset=samples,
                        criterion=self.criterion,
                        batch_size=self.batch_size, end_when=end)
        opt.set_optim_method(method)
        if self.validation is not None:
            trig, vdf, methods, vbatch = self.validation
            opt.set_validation(trig, self._samples(vdf), methods, vbatch)
        if self.train_summary is not None:
            opt.set_train_summary(self.train_summary)
        if self.validation_summary is not None:
            opt.set_validation_summary(self.validation_summary)
        trained = opt.optimize()
        return self._make_model(trained)


class DLModel(_Params):
    """A fitted model: ``transform(df)`` appends the prediction
    column."""

    _param_names = ("model", "feature_size", "features_col",
                    "prediction_col", "batch_size")

    def __init__(self, model: Module, feature_size: Sequence[int],
                 features_col: str = "features",
                 prediction_col: str = "prediction", batch_size: int = 32):
        self.model = model
        self.feature_size = feature_size
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.batch_size = batch_size
        model.evaluate()

    def set_features_col(self, v):
        return self._chain("features_col", v)

    def set_prediction_col(self, v):
        return self._chain("prediction_col", v)

    def set_batch_size(self, v):
        return self._chain("batch_size", v)

    @torch.no_grad()
    def _forward_all(self, df) -> np.ndarray:
        feats = _column_array(df, self.features_col, self.feature_size)
        self.model.evaluate()
        dev = model_device(self.model)
        outs = []
        bs = int(self.batch_size)
        for i in range(0, len(feats), bs):
            chunk = feats[i:i + bs]
            x = torch.from_numpy(no_lone_row(chunk)).to(dev)
            outs.append(self.model(x)[:len(chunk)].float().cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0,))

    def _predictions(self, raw: np.ndarray):
        return [r.tolist() for r in raw]

    def transform(self, df):
        out = df.copy()
        out[self.prediction_col] = self._predictions(self._forward_all(df))
        return out


class DLClassifier(DLEstimator):
    """A scalar class-id label; predictions are argmax + 1 (1-based, the
    Torch convention)."""

    _param_names = tuple(p for p in DLEstimator._param_names
                         if p != "label_size")

    def __init__(self, model: Module, criterion, feature_size: Sequence[int],
                 **kw):
        super().__init__(model, criterion, feature_size, label_size=[1], **kw)

    def _make_model(self, trained: Module) -> "DLClassifierModel":
        m = DLClassifierModel(trained, self.feature_size)
        m.features_col = self.features_col
        m.prediction_col = self.prediction_col
        m.batch_size = self.batch_size
        return m


class DLClassifierModel(DLModel):
    """Predicts the 1-based class (argmax + 1) as int64."""

    def _predictions(self, raw: np.ndarray):
        return (np.argmax(raw, axis=-1) + 1).astype(np.int64).tolist()


class DLImageReader:
    """Image files into a pandas DataFrame of decoded pixel arrays."""

    @staticmethod
    def read_images(paths, to_chw: bool = True):
        """``paths``: an iterable of file paths or a glob pattern. Returns
        a pandas DataFrame with columns (origin, height, width,
        n_channels, data)."""
        import glob as _glob

        import pandas as pd

        if isinstance(paths, str):
            paths = sorted(_glob.glob(paths))
        rows = []
        for p in paths:
            arr = _decode_image(p)  # decoded as HWC (or HW)
            h, w = arr.shape[0], arr.shape[1]
            c = arr.shape[2] if arr.ndim == 3 else 1
            if to_chw and arr.ndim == 3:
                arr = np.transpose(arr, (2, 0, 1))
            rows.append({"origin": p, "height": h, "width": w,
                         "n_channels": c, "data": arr.astype(np.float32)})
        return pd.DataFrame(rows)


def _decode_image(path: str) -> np.ndarray:
    """``.npy`` read as is; PNG / JPEG through PIL where installed."""
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "reading encoded images needs PIL; store .npy arrays instead"
        ) from e
    return np.asarray(Image.open(path), np.float32)
