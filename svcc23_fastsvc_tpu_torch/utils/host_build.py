"""Host C++ libraries built from the repository's `native/` sources.

The port's two host libraries, Harvest (`dsp/harvest.py`) and the batch
assembler (`data/native_batch.py`), are compiled from the shared sources
in `native/` with the host `g++` and the flags of `native/Makefile` into
`svcc23_fastsvc_tpu_torch/_build/` at first use. A library's name carries
a hash of its source, the flags and the target that `-march=native`
resolves to, so that a library built for one CPU is never loaded on
another. Nothing is written into `native/`. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()


def cxx() -> str:
    """The host C++ compiler: $CXX, else g++ on PATH."""
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("the native libraries need a C++ compiler: no g++ "
                           "on PATH (or set CXX)")
    return found


def library_path(source: str, stem: str, compiler: str) -> str:
    """Path of `stem`'s library for `source`, the flags and the host CPU."""
    # the target -march=native stands for on this host, as g++ hands it
    # on to cc1plus
    probe = subprocess.run(
        [compiler, "-march=native", "-E", "-v", "-x", "c++", os.devnull],
        capture_output=True, text=True, timeout=60)
    target = [ln for ln in probe.stderr.splitlines() if "-march=" in ln]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update("\n".join(target).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def load(source: str, stem: str) -> ctypes.CDLL:
    """Build the C++ file `source` into `_build/lib<stem>_<hash>.so` unless
    it is there, and load it."""
    with _lock:
        if not os.path.isfile(source):
            raise RuntimeError(f"native source missing: {source}")
        compiler = cxx()
        path = library_path(source, stem, compiler)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                out = subprocess.run([compiler, *CXX_FLAGS, "-o", tmp, source],
                                     capture_output=True, text=True,
                                     timeout=BUILD_TIMEOUT_S)
                if out.returncode != 0:
                    raise RuntimeError(f"building {source} failed:\n"
                                       f"{out.stderr[-3000:]}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return ctypes.CDLL(path)
