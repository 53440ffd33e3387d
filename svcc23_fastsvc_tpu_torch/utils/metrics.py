"""Objective quality metrics: log-mel L1 and mel-cepstral distortion
between two waveforms.

Counterpart of `svcc23_fastsvc_tpu/utils/metrics.py`, in torch on the
inputs' device (cuFFT and one mel or freqt matrix product on the card).
`wav_mcd` takes mel-cepstra of the STFT power spectrum through
`dsp/world.py::sp2mc` with the sampling rate's all-pass warp, the mcep
definition the B02 recipe trains on; frames are aligned by index.
"""

from __future__ import annotations

import math

import torch

from ..dsp.world import mcepalpha, sp2mc
from ..ops.stft import mel_filterbank, stft_magnitude


def log_mel_spectrogram(x, *, sr: int = 16000, n_fft: int = 1024,
                        hop: int = 256, n_mels: int = 80):
    """(..., T) -> (..., frames, n_mels) log-mel."""
    power = stft_magnitude(x, n_fft, hop, n_fft, power=True, clamp_min=1e-10)
    mel = power @ mel_filterbank(sr, n_fft, n_mels, dtype=power.dtype,
                                 device=power.device)
    return torch.log(torch.clamp(mel, min=1e-10))


def mel_l1(x, y, *, sr: int = 16000, n_fft: int = 1024, hop: int = 256,
           n_mels: int = 80):
    """Mean |log-mel(x) - log-mel(y)| over the frames of the common
    length."""
    T = min(x.shape[-1], y.shape[-1])
    kw = dict(sr=sr, n_fft=n_fft, hop=hop, n_mels=n_mels)
    return (log_mel_spectrogram(x[..., :T], **kw)
            - log_mel_spectrogram(y[..., :T], **kw)).abs().mean()


def wav_mcd(x, y, *, sr: int = 16000, n_fft: int = 1024, hop: int = 256,
            order: int = 24):
    """Mel-cepstral distortion (dB) between two aligned (T,) waveforms."""
    T = min(x.shape[-1], y.shape[-1])
    alpha = mcepalpha(sr)
    px, py = (stft_magnitude(a[..., :T], n_fft, hop, n_fft, power=True,
                             clamp_min=1e-10) for a in (x, y))
    return mcd(sp2mc(px, order, alpha), sp2mc(py, order, alpha))


def mcd(mcep_x, mcep_y, *, exclude_c0: bool = True):
    """Mel-cepstral distortion in dB between (F, M) mel-cepstra, over the
    frames of the common length."""
    F = min(len(mcep_x), len(mcep_y))
    a, b = torch.as_tensor(mcep_x)[:F], torch.as_tensor(mcep_y)[:F]
    if exclude_c0:
        a, b = a[:, 1:], b[:, 1:]
    k = 10.0 / math.log(10.0) * math.sqrt(2.0)
    return k * torch.sqrt(((a - b) ** 2).sum(1)).mean()
