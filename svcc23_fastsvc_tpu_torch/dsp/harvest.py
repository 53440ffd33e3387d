"""ctypes binding of the repository's native Harvest-style F0 estimator.

Counterpart of `svcc23_fastsvc_tpu/dsp/harvest.py`, over the same source,
`native/harvest.cpp`: serial heuristic DSP that stays on the host. The
source is compiled with the host `g++` into `svcc23_fastsvc_tpu_torch/
_build/` at first use (`utils/host_build.py`). When the library cannot be
built or loaded this raises: there is no fallback to another estimator.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..utils import host_build

SOURCE = os.path.join(host_build.NATIVE_DIR, "harvest.cpp")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = host_build.load(SOURCE, "harvest")
        lib.harvest_f0.restype = ctypes.c_int
        lib.harvest_f0.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # x
            ctypes.c_long,                    # length
            ctypes.c_double,                  # fs
            ctypes.c_double,                  # f0_floor
            ctypes.c_double,                  # f0_ceil
            ctypes.c_double,                  # frame_period_ms
            ctypes.POINTER(ctypes.c_double),  # f0_out
            ctypes.c_long,                    # n_frames_cap
        ]
        _lib = lib
        return lib


def harvest_f0(
    x,
    *,
    fs: int,
    f0_floor: float = 70.0,
    f0_ceil: float = 340.0,
    frame_period_ms: float = 10.0,
) -> np.ndarray:
    """Harvest-style F0: (T,) signal -> (T // hop + 1,) Hz in f64, 0 =
    unvoiced, hop = round(fs * frame_period_ms / 1000) (pyworld.harvest's
    frame count at that frame period)."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
    hop = round(fs * frame_period_ms / 1000.0)
    n_frames = len(x) // hop + 1
    out = np.zeros(n_frames, dtype=np.float64)
    rc = _load().harvest_f0(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(x), float(fs), float(f0_floor), float(f0_ceil),
        float(frame_period_ms),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_frames,
    )
    if rc != 0:
        raise RuntimeError(f"harvest_f0 failed with code {rc}")
    return out
