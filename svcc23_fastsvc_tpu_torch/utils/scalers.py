"""Feature normalisation scalers, on the host, in numpy.

Counterpart of `svcc23_fastsvc_tpu/utils/scalers.py`: `StandardScaler`
and `MinMaxScaler` with sklearn's `partial_fit` moment maths and
attributes (stage 3 fits the PPG scaler of FastSVC with it), and
`save_scaler` / `load_scaler` for the recipe's `stats.joblib`.

Neither function needs joblib. `save_scaler` writes a plain pickle of the
port's own class, which joblib's `load` (the JAX package's `load_scaler`)
reads as it is. `load_scaler` reads that and what `joblib.dump` writes: a
pickle in which each ndarray is a `joblib.numpy_pickle.NumpyArrayWrapper`
record with the array's bytes inline right after it. It never imports
the class a file names: a restricted unpickler maps the JAX package's
scalers and sklearn's `StandardScaler` / `MinMaxScaler` onto the port's,
reads numpy's and joblib's array records, and refuses every other global.
"""

from __future__ import annotations

import pickle

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
# globals of numpy's array records, loaded as they are (joblib's
# NumpyArrayWrapper is read by `_ArrayRecord`)
_ARRAYS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}
_WRAPPER = ("joblib.numpy_pickle", "NumpyArrayWrapper")


class _ArrayRecord:
    """joblib's `NumpyArrayWrapper`: an array's subclass, shape, order and
    dtype, its bytes written into the file right after the record (after
    a padding byte and that many pad bytes, where the record has
    `numpy_array_alignment_bytes`), or pickled there for object dtypes."""

    def read(self, unpickler) -> np.ndarray:
        f, dtype = unpickler.file, self.dtype
        if dtype.hasobject:
            arr = _Unpickler(unpickler.path, f).load()
            if not isinstance(arr, np.ndarray):
                raise pickle.UnpicklingError(
                    f"{unpickler.path}: an object array record holds "
                    f"{type(arr).__name__}")
            return arr
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            f.read(f.read(1)[0])
        count = int(np.prod(self.shape, dtype=np.int64))
        data = f.read(count * dtype.itemsize)
        if len(data) != count * dtype.itemsize:
            raise pickle.UnpicklingError(
                f"{unpickler.path}: the file ends inside an array")
        arr = np.frombuffer(data, dtype, count=count)
        if self.order == "F":
            arr = arr.reshape(self.shape[::-1]).T
        else:
            arr = arr.reshape(self.shape)
        return arr.astype(dtype.newbyteorder("="))


class _Unpickler(pickle._Unpickler):
    """A stats file's pickle, with joblib's array records read in place.
    Only the globals of `_SCALERS`, `_ARRAYS` and joblib's record load."""

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, path: str, f):
        super().__init__(f)
        self.path, self.file = path, f

    def find_class(self, module, name):
        if (module, name) in _SCALERS:
            return _SCALERS[module, name]
        if (module, name) == _WRAPPER:
            return _ArrayRecord
        if (module, name) in _ARRAYS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{self.path}: global {module}.{name} is not a scaler or an "
            "array record")

    def load_build(self):
        super().load_build()
        if isinstance(self.stack[-1], _ArrayRecord):
            self.stack[-1] = self.stack[-1].read(self)

    dispatch[pickle.BUILD[0]] = load_build


def save_scaler(scaler, path: str):
    """Write a scaler (or a dict of them) as a pickle that joblib's `load`,
    and so the JAX package's `load_scaler`, reads: protocol 4, arrays as
    numpy pickles them."""
    with open(path, "wb") as f:
        pickle.dump(scaler, f, protocol=4)


def load_scaler(path: str):
    """A scaler from a `stats.joblib` written by this package, by the JAX
    package or by sklearn (`joblib.dump`, uncompressed), as the port's
    class."""
    with open(path, "rb") as f:
        if f.read(1) != pickle.PROTO:
            raise ValueError(f"{path}: not an uncompressed pickle (a "
                             "compressed joblib file is not supported)")
        f.seek(0)
        return _Unpickler(path, f).load()
