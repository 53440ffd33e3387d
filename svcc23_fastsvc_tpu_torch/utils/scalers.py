"""Feature normalisation scalers, on the host, in numpy.

Counterpart of `svcc23_fastsvc_tpu/utils/scalers.py`: `StandardScaler`
and `MinMaxScaler` with sklearn's `partial_fit` moment maths and
attributes (stage 3 fits the PPG scaler of FastSVC with it), and
`save_scaler` / `load_scaler` for the recipe's `stats.joblib`.

`save_scaler` writes a joblib pickle of the port's own class, which the
JAX package's `load_scaler` reads as it is. `load_scaler` never imports
the class a file names: a restricted unpickler maps the JAX package's
scalers and sklearn's `StandardScaler` / `MinMaxScaler` onto the port's,
lets numpy's and joblib's array records through, and refuses every other
global. `joblib` is imported only when a file is read or written.
"""

from __future__ import annotations

import numpy as np


class StandardScaler:
    """Incremental mean / std scaler (sklearn-compatible attributes)."""

    def __init__(self):
        self.n_samples_seen_ = 0
        self.mean_ = None
        self.var_ = None

    @property
    def scale_(self):
        return np.sqrt(self.var_)

    def partial_fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[:, None]
        n = X.shape[0]
        if self.n_samples_seen_ == 0:
            self.mean_ = X.mean(axis=0)
            self.var_ = X.var(axis=0)
            self.n_samples_seen_ = n
            return self
        total = self.n_samples_seen_ + n
        new_mean = X.mean(axis=0)
        new_var = X.var(axis=0)
        delta = new_mean - self.mean_
        m_a = self.var_ * self.n_samples_seen_
        m_b = new_var * n
        m2 = m_a + m_b + delta ** 2 * self.n_samples_seen_ * n / total
        self.mean_ = self.mean_ + delta * n / total
        self.var_ = m2 / total
        self.n_samples_seen_ = total
        return self

    def transform(self, X):
        return (np.asarray(X) - self.mean_) / self.scale_

    def inverse_transform(self, X):
        return np.asarray(X) * self.scale_ + self.mean_


class MinMaxScaler:
    """Incremental min / max scaler to feature_range (sklearn-compatible
    attributes)."""

    def __init__(self, feature_range=(0.0, 1.0)):
        self.feature_range = feature_range
        self.data_min_ = None
        self.data_max_ = None

    @property
    def scale_(self):
        lo, hi = self.feature_range
        rng = self.data_max_ - self.data_min_
        rng = np.where(rng == 0, 1.0, rng)
        return (hi - lo) / rng

    @property
    def min_(self):
        return self.feature_range[0] - self.data_min_ * self.scale_

    def partial_fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[:, None]
        mn, mx = X.min(axis=0), X.max(axis=0)
        if self.data_min_ is None:
            self.data_min_, self.data_max_ = mn, mx
        else:
            self.data_min_ = np.minimum(self.data_min_, mn)
            self.data_max_ = np.maximum(self.data_max_, mx)
        return self

    def transform(self, X):
        return np.asarray(X) * self.scale_ + self.min_

    def inverse_transform(self, X):
        return (np.asarray(X) - self.min_) / self.scale_


# the scaler classes a stats file may name, and the port's class for each
_SCALERS = {
    (module, cls.__name__): cls
    for cls in (StandardScaler, MinMaxScaler)
    for module in (__name__, "svcc23_fastsvc_tpu.utils.scalers",
                   "sklearn.preprocessing._data")
}
# globals of numpy's and joblib's array records, loaded as they are
_ARRAYS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("joblib.numpy_pickle", "NumpyArrayWrapper"),
}


def save_scaler(scaler, path: str):
    import joblib

    joblib.dump(scaler, path)


def load_scaler(path: str):
    """A scaler from a `stats.joblib` written by this package, by the JAX
    package or by sklearn, as the port's class."""
    import pickle

    from joblib.numpy_pickle import NumpyUnpickler

    class _Unpickler(NumpyUnpickler):
        def find_class(self, module, name):
            if (module, name) in _SCALERS:
                return _SCALERS[module, name]
            if (module, name) in _ARRAYS:
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"{path}: global {module}.{name} is not a scaler or an "
                "array record")

    with open(path, "rb") as f:
        return _Unpickler(path, f, True).load()
