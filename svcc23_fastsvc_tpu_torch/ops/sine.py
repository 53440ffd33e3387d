"""Sine excitation from frame-rate F0 (kernel B).

`sine_excitation` maps (B, Tf) frame F0 to the (B, Tf*hop) NSF sine
amp * sin(2*pi*phase), zero where f0 <= 0, with

    rad[f]    = (f0[f] / sr) mod 1
    phase     = prefix[f] + rad[f] * (s + 1)      (sample s of frame f)
    prefix[f] = sum_{f' < f} hop * rad[f']        (taken mod 1)

which equals the reference's sin(2*pi*cumsum(repeat(f0, hop)/sr mod 1)).
It replaces the TPU kernel `svcc23_fastsvc_tpu/ops/pallas_kernels.py::
sine_excitation`. The CUDA source is `csrc/sine_excitation.cu`: one launch,
no scratch; its header says how the TPU kernel's sequential phase carry
became a prefix each block of threads sums for its own tile of frames.

Both versions reduce each frame's increment mod 1 before summing, so the
phase stays below 2 and keeps f32 precision however long the utterance;
the sine is periodic, so only the rounding changes.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it takes `sine_excitation_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def sine_excitation_plain(f0, *, hop: int, sr: float, amp: float = 0.1):
    """Plain PyTorch version: frame prefix in f64 (mod 1), samples in f32."""
    f0 = f0.float()
    # divided in f64 and rounded: on CUDA, dividing by a Python scalar
    # multiplies by its rounded reciprocal, an error the prefix adds up
    rad = torch.remainder((f0.double() / float(sr)).float(), 1.0)
    inc = torch.remainder(rad * float(hop), 1.0).double()
    prefix = torch.cumsum(inc, dim=1) - inc
    prefix = (prefix - torch.floor(prefix)).float()
    s = torch.arange(1, hop + 1, dtype=torch.float32, device=f0.device)
    phase = prefix[:, :, None] + rad[:, :, None] * s
    sine = torch.sin(phase * (2.0 * math.pi)) * float(amp)
    sine = torch.where(f0[:, :, None] > 0, sine, torch.zeros_like(sine))
    return sine.reshape(f0.shape[0], -1)


def sine_excitation(f0, *, hop: int, sr: float, amp: float = 0.1):
    """(B, Tf) frame F0 -> (B, Tf*hop) f32 sine excitation."""
    if f0.dim() != 2:
        raise ValueError(f"want f0 (B, Tf), got {tuple(f0.shape)}")
    if f0.device.type == "cpu":
        return sine_excitation_plain(f0, hop=hop, sr=sr, amp=amp)
    if f0.device.type != "cuda":
        raise ValueError(f"no sine_excitation kernel for device {f0.device}")
    f0 = f0.float().contiguous()
    B, Tf = f0.shape
    out = torch.empty((B, Tf * hop), dtype=torch.float32, device=f0.device)
    if out.numel() == 0:
        return out
    fn = _build.kernel("sine_excitation_f32", _ARGTYPES)
    err = fn(f0.data_ptr(), out.data_ptr(), B, Tf, hop, float(sr),
             float(amp), _build.stream_handle(f0.device))
    _build.check(err, "sine_excitation_f32")
    sine_excitation.launches += 1
    return out


sine_excitation.launches = 0
