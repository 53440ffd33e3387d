"""The port's stats files without joblib (`svcc23_fastsvc_tpu_torch/utils/
scalers.py`) against joblib and the JAX package.

Stats that `joblib.dump` writes (the JAX package's scalers through its
`save_scaler`, sklearn's `StandardScaler` / `MinMaxScaler`, the B02 dict
of scalers, arrays in F order and of object dtype) are read by the port's
`load_scaler`; stats the port's `save_scaler` writes are read by JAX
`load_scaler` (`joblib.load`). The transforms are equal bit for bit.
"""

import os
import pickle

import joblib
import numpy as np
import pytest
from sklearn import preprocessing as skp

from svcc23_fastsvc_tpu.utils import scalers as js
from svcc23_fastsvc_tpu_torch.utils import scalers as ts

X = np.random.default_rng(3).standard_normal((90, 5)) * [1, 2, 3, 4, 5] + 2


def _fit(module, kind):
    s = getattr(module, kind)()
    for chunk in np.array_split(X, [30, 55]):
        s.partial_fit(chunk)
    return s


def _equal_transform(got, want):
    np.testing.assert_array_equal(got.transform(X), want.transform(X))
    np.testing.assert_array_equal(got.inverse_transform(X),
                                  want.inverse_transform(X))


@pytest.mark.parametrize("kind", ["StandardScaler", "MinMaxScaler"])
def test_jax_and_sklearn_joblib_dumps_are_read(tmp_path, kind):
    path = str(tmp_path / "stats.joblib")
    for want in (_fit(js, kind), getattr(skp, kind)().fit(X)):
        joblib.dump(want, path)
        got = ts.load_scaler(path)
        assert type(got) is getattr(ts, kind)
        _equal_transform(got, want)


def test_b02_dict_f_order_and_object_arrays_are_read(tmp_path):
    want = {"ppg": _fit(js, "MinMaxScaler"), "mcep": _fit(js, "StandardScaler"),
            "f": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
            "o": np.array(["spkA", 1, None], dtype=object)}
    path = str(tmp_path / "stats_b02.joblib")
    js.save_scaler(want, path)
    got = ts.load_scaler(path)
    for k in ("ppg", "mcep"):
        _equal_transform(got[k], want[k])
    np.testing.assert_array_equal(got["f"], want["f"])
    assert got["f"].flags.f_contiguous
    assert got["o"].dtype == object and list(got["o"]) == ["spkA", 1, None]


def test_port_stats_are_read_by_jax_load_scaler(tmp_path):
    want = {"ppg": _fit(ts, "MinMaxScaler"),
            "mcep": _fit(ts, "StandardScaler")}
    path = str(tmp_path / "stats_b02.joblib")
    ts.save_scaler(want, path)
    got = js.load_scaler(path)
    for k, w in want.items():
        _equal_transform(got[k], w)
        _equal_transform(got[k], _fit(js, type(w).__name__))
    back = ts.load_scaler(path)
    for k, w in want.items():
        assert type(back[k]) is type(w)
        _equal_transform(back[k], w)


def test_compressed_files_and_foreign_globals_raise(tmp_path):
    joblib.dump(_fit(js, "StandardScaler"), str(tmp_path / "z.joblib"),
                compress=3)
    with pytest.raises(ValueError, match="compressed"):
        ts.load_scaler(str(tmp_path / "z.joblib"))
    joblib.dump({"f": os.system}, str(tmp_path / "bad.joblib"))
    with pytest.raises(pickle.UnpicklingError, match="not a scaler"):
        ts.load_scaler(str(tmp_path / "bad.joblib"))
