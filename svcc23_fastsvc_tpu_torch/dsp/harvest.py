"""ctypes binding of the repository's native Harvest-style F0 estimator.

Counterpart of `svcc23_fastsvc_tpu/dsp/harvest.py`, over the same source,
`native/harvest.cpp`: serial heuristic DSP that stays on the host. The
source is compiled with the host `g++` and the flags of `native/Makefile`
into `svcc23_fastsvc_tpu_torch/_build/` at first use, under a name that
carries a hash of the source, the flags and the target that
`-march=native` resolves to, so that a library built for one CPU is never
loaded on another. Nothing is written into `native/`. When the library
cannot be built or loaded this raises: there is no fallback to another
estimator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "harvest.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("Harvest needs a C++ compiler: no g++ on PATH "
                           "(or set CXX)")
    return cxx


def library_path(cxx: str) -> str:
    """Path of the library for the current source, flags and host CPU."""
    # the target -march=native stands for on this host, as g++ hands it
    # on to cc1plus
    probe = subprocess.run(
        [cxx, "-march=native", "-E", "-v", "-x", "c++", os.devnull],
        capture_output=True, text=True, timeout=60)
    target = [ln for ln in probe.stderr.splitlines() if "-march=" in ln]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update("\n".join(target).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libharvest_{h.hexdigest()[:16]}.so")


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.isfile(SOURCE):
            raise RuntimeError(f"Harvest source missing: {SOURCE}")
        cxx = _cxx()
        path = library_path(cxx)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                                     capture_output=True, text=True,
                                     timeout=BUILD_TIMEOUT_S)
                if out.returncode != 0:
                    raise RuntimeError(
                        f"building Harvest failed:\n{out.stderr[-3000:]}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(path)
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
