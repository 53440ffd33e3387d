"""ctypes binding of the native batch assembler (`native/batch_assembler.cpp`).

Counterpart of `svcc23_fastsvc_tpu/data/native_batch.py`, over the same
source, built with the host g++ into `svcc23_fastsvc_tpu_torch/_build/` at
first use (`utils/host_build.py`). Two layers:

- `assemble_batch`: the four window copies of a whole batch in C++
  threads, with the GIL released. `FastSVCBatcher`'s vectorised path takes
  it; the crops are still drawn by the batcher's numpy generator, so the
  batches are those of the numpy copies, byte for byte.
- `NativeBatchProducer`: the whole producer loop in C++ threads (crop
  draws from a per-thread splitmix64 stream, assembly, a ring of slots);
  Python hands out zero-copy numpy views of filled slots. Each thread's
  stream is fixed by `seed`; the interleave of threads is not.

Where the library cannot be built or loaded this raises. The JAX package
falls back to its Python `BatcherPool` there; the port does not, so a
configuration asking for the native producer gets it or stops.
`make_native_producer` returns None for the one configuration the
producer does not take, `aux_context_window` != 0 (its gather has no
context frames): that is a route, not a failure.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..utils import host_build

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_long)

SOURCE = os.path.join(host_build.NATIVE_DIR, "batch_assembler.cpp")

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = host_build.load(SOURCE, "batch")
        lib.assemble_fastsvc_batch.restype = ctypes.c_int
        lib.assemble_fastsvc_batch.argtypes = [
            _f32p, _f32p, _f32p, _f32p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            _i64p, _i64p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            _f32p, _f32p, _f32p, _f32p,
            ctypes.c_int,
        ]
        lib.producer_start.restype = ctypes.c_void_p
        lib.producer_start.argtypes = [
            _f32p, _f32p, _f32p, _f32p, _f32p, _i64p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            _f32p, _f32p, _f32p, _f32p, _f32p, _i64p, _i64p,
            ctypes.c_long, ctypes.c_int, ctypes.c_ulonglong,
        ]
        lib.producer_next.restype = ctypes.c_long
        lib.producer_next.argtypes = [ctypes.c_void_p]
        lib.producer_release.restype = None
        lib.producer_release.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.producer_stop.restype = None
        lib.producer_stop.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _p(a, ptype=_f32p):
    return a.ctypes.data_as(ptype)


def assemble_batch(packed: dict, rows: np.ndarray, starts: np.ndarray,
                   frames: int, hop: int, *, n_threads: int = 4) -> dict:
    """B windows of `frames` frames from the packed store (`FastSVCBatcher.
    _pack`'s layout) at utterances `rows` and frame `starts`: audio (B, L,
    1), f0 (B, F, 1), ppg (B, F, D), lft (B, L, 1), L = frames * hop."""
    lib = _load()
    B, L, D = len(rows), frames * hop, packed["ppg"].shape[-1]
    out = {
        "audio": np.empty((B, L, 1), np.float32),
        "f0": np.empty((B, frames, 1), np.float32),
        "ppg": np.empty((B, frames, D), np.float32),
        "lft": np.empty((B, L, 1), np.float32),
    }
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    rc = lib.assemble_fastsvc_batch(
        _p(packed["audio"]), _p(packed["f0"]), _p(packed["ppg"]),
        _p(packed["lft"]),
        packed["audio"].shape[0], packed["audio"].shape[1],
        packed["f0"].shape[1], D,
        _p(rows, _i64p), _p(starts, _i64p), B, frames, hop,
        _p(out["audio"]), _p(out["f0"]), _p(out["ppg"]), _p(out["lft"]),
        n_threads)
    if rc != 0:
        raise RuntimeError(f"assemble_fastsvc_batch failed: {rc}")
    return out


def assemble_batch_plain(packed: dict, rows: np.ndarray, starts: np.ndarray,
                         frames: int, hop: int) -> dict:
    """Plain numpy version of `assemble_batch`: one slice copy a window."""
    B, L = len(rows), frames * hop
    out = {
        "audio": np.empty((B, L, 1), np.float32),
        "f0": np.empty((B, frames, 1), np.float32),
        "ppg": np.empty((B, frames, packed["ppg"].shape[-1]), np.float32),
        "lft": np.empty((B, L, 1), np.float32),
    }
    for i in range(B):
        r, f0s, a0 = rows[i], starts[i], starts[i] * hop
        out["audio"][i, :, 0] = packed["audio"][r, a0:a0 + L]
        out["f0"][i, :, 0] = packed["f0"][r, f0s:f0s + frames]
        out["ppg"][i] = packed["ppg"][r, f0s:f0s + frames]
        out["lft"][i, :, 0] = packed["lft"][r, a0:a0 + L]
    return out


class NativeBatchProducer:
    """Iterator of training batches made by C++ threads.

    A batch is a set of zero-copy views of one slot of the ring. `hold`
    slots stay valid after each `next`: a caller that keeps K batches
    before it copies them (the trainer stacks K for a K-step call) passes
    hold >= K. `close` stops the threads; call it before dropping the
    producer's arrays.
    """

    is_prefetching = True  # the trainer does not wrap it in a thread

    def __init__(self, packed: dict, *, batch_size: int, frames: int,
                 hop: int, acw: int = 0, use_spk_emb: bool = True,
                 n_threads: int = 3, depth: int | None = None,
                 hold: int = 2, seed: int = 0, collect_crops: bool = False):
        lib = _load()
        self._lib = lib
        B, F, L = batch_size, frames, frames * hop
        D = packed["ppg"].shape[-1]
        self._hold = max(1, hold)
        depth = depth if depth is not None else self._hold + n_threads + 2
        if depth < self._hold + 2:
            raise ValueError(f"depth {depth} < hold {self._hold} + 2")
        # the threads read the store for the producer's lifetime
        self._packed = {k: np.ascontiguousarray(v) for k, v in packed.items()}
        p = self._packed
        p["n_frames"] = np.ascontiguousarray(p["n_frames"], dtype=np.int64)
        emb = p.get("spk_emb") if use_spk_emb else None
        s = self._slots = {
            "audio": np.empty((depth, B, L), np.float32),
            "f0": np.empty((depth, B, F), np.float32),
            "ppg": np.empty((depth, B, F, D), np.float32),
            "lft": np.empty((depth, B, L), np.float32),
            "rows": np.empty((depth, B), np.int64),
            "starts": np.empty((depth, B), np.int64),
        }
        if emb is not None:
            s["spk_emb"] = np.empty((depth, B, emb.shape[-1]), np.float32)
        self._handle = lib.producer_start(
            _p(p["audio"]), _p(p["f0"]), _p(p["ppg"]), _p(p["lft"]),
            _p(emb) if emb is not None else None, _p(p["n_frames"], _i64p),
            p["audio"].shape[0], p["audio"].shape[1], p["f0"].shape[1], D,
            emb.shape[-1] if emb is not None else 0,
            B, F, hop, acw,
            _p(s["audio"]), _p(s["f0"]), _p(s["ppg"]), _p(s["lft"]),
            _p(s["spk_emb"]) if emb is not None else None,
            _p(s["rows"], _i64p), _p(s["starts"], _i64p),
            depth, n_threads, seed)
        if not self._handle:
            raise RuntimeError("producer_start failed")
        self._use_emb = emb is not None
        self._collect_crops = collect_crops
        self._live: list = []  # slots handed out and not yet released
        self.batches = 0  # batches handed out

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is None:
            raise StopIteration
        while len(self._live) >= self._hold:
            self._lib.producer_release(self._handle, self._live.pop(0))
        slot = self._lib.producer_next(self._handle)
        if slot < 0:
            raise StopIteration
        self._live.append(slot)
        s = self._slots
        out = {"audio": s["audio"][slot][..., None],
               "f0": s["f0"][slot][..., None],
               "ppg": s["ppg"][slot],
               "lft": s["lft"][slot][..., None]}
        if self._use_emb:
            out["spk_emb"] = s["spk_emb"][slot]
        if self._collect_crops:
            out["_rows"] = s["rows"][slot]
            out["_starts"] = s["starts"][slot]
        self.batches += 1
        return out

    def close(self):
        if self._handle is not None:
            self._lib.producer_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_native_producer(batcher, *, n_threads: int = 3, seed: int = 0,
                         hold: int = 2):
    """A `NativeBatchProducer` over a `FastSVCBatcher`'s packed store, or
    None where the batcher crops context frames (`acw` != 0), which the
    producer does not; raises where the library cannot be had."""
    if batcher.acw != 0:
        return None
    if batcher._packed is None:
        batcher._pack()
    return NativeBatchProducer(
        batcher._packed, batch_size=batcher.batch_size,
        frames=batcher.batch_frames, hop=batcher.hop_size, acw=batcher.acw,
        use_spk_emb=batcher.use_spk_emb, n_threads=n_threads, seed=seed,
        hold=hold)
