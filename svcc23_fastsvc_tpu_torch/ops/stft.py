"""STFT ops of the training losses.

Counterpart of `svcc23_fastsvc_tpu/ops/stft.py` (`hann_window`,
`frame_signal`, `stft`, `stft_magnitude`), with torch.stft semantics:
center=True reflect padding of fft_size // 2 on both sides, a periodic
Hann window of win_length zero-padded (centred) to fft_size, and the
reference loss's 1e-7 clamp of the power before the square root. The JAX
package never had a Pallas kernel here; the FFT is `torch.fft.rfft`
(cuFFT on the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None):
    """Periodic Hann window (torch.hann_window / scipy fftbins=True), made
    in f64 and rounded, as the JAX package makes it. It is made on `device`:
    a copy from the host would sync the stream in every training step, and
    a captured step (train/graphs.py) may not copy from the host at all."""
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)
    return w.to(dtype)


def frame_signal(x, frame_length: int, hop: int):
    """Split (..., T) into (..., n_frames, frame_length) frames,
    n_frames = 1 + (T - frame_length) // hop."""
    return x.unfold(-1, frame_length, hop)


def stft(x, fft_size: int, hop: int, win_length: int | None = None):
    """Complex STFT of (..., T) -> (..., n_frames, fft_size // 2 + 1)."""
    win_length = win_length or fft_size
    window = hann_window(win_length, x.dtype, x.device)
    lpad = (fft_size - win_length) // 2
    window = F.pad(window, (lpad, fft_size - win_length - lpad))
    pad = fft_size // 2
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    x = x.reshape(*lead, x.shape[-1])
    return torch.fft.rfft(frame_signal(x, fft_size, hop) * window, dim=-1)


def stft_magnitude(x, fft_size: int, hop: int, win_length: int | None = None):
    """Magnitude spectrogram with the reference's 1e-7 power clamp:
    (..., n_frames, fft_size // 2 + 1)."""
    z = stft(x, fft_size, hop, win_length)
    return torch.sqrt(torch.clamp(z.real ** 2 + z.imag ** 2, min=1e-7))
