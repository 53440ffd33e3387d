"""HDF5 utterance store: one .h5 per utterance with named datasets, read
and written.

`h5py` is imported only when a file is read or written, so the package
imports where it is missing.
"""

from __future__ import annotations

import os


def read_hdf5(path: str, dataset_name: str):
    """Read one dataset from an hdf5 file."""
    import h5py

    if not os.path.exists(path):
        raise FileNotFoundError(f"no such hdf5 file: {path}")
    with h5py.File(path, "r") as f:
        if dataset_name not in f:
            raise KeyError(f"dataset {dataset_name!r} not in {path}")
        return f[dataset_name][()]


def write_hdf5(path: str, dataset_name: str, data):
    """Write one dataset into an hdf5 file (creating dirs as needed),
    replacing a dataset of that name."""
    import h5py
    import numpy as np

    data = np.asarray(data)
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with h5py.File(path, "a") as f:
        if dataset_name in f:
            del f[dataset_name]
        f.create_dataset(dataset_name, data=data)
