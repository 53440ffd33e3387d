"""STFT ops of the training losses and of the front end's features.

Counterpart of `svcc23_fastsvc_tpu/ops/stft.py` (`hann_window`,
`frame_signal`, `stft`, `stft_magnitude`, the librosa-0.8.1 auxiliaries
`fft_frequencies`, `a_weighting_db`, `power_to_db`, `db_to_amplitude`,
`loudness_extract` and its frame-rate half `loudness_extract_frames`, and
the slaney `mel_filterbank`), with torch.stft
semantics: center=True pads fft_size // 2 on both sides (reflect unless
`pad_mode="constant"`), a window of win_length (periodic Hann unless one is
given) zero-padded (centred) to fft_size, and the reference loss's 1e-7
clamp of the power before the square root. The JAX package never had a
Pallas kernel here; the FFT is `torch.fft.rfft` (cuFFT on the card). The
mel filterbank and the A-weighting are built in numpy in f64, as the JAX
package builds them, and then cast.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .resample import nearest_upsample


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


def stft(x, fft_size: int, hop: int, win_length: int | None = None, *,
         window=None, center: bool = True, pad_mode: str = "reflect"):
    """Complex STFT of (..., T) -> (..., n_frames, fft_size // 2 + 1).

    `window` (win_length,) replaces the periodic Hann window; with
    center=True the signal is padded fft_size // 2 on both sides, by
    reflection or (pad_mode="constant") with zeros."""
    win_length = win_length or fft_size
    if window is None:
        window = hann_window(win_length, x.dtype, x.device)
    lpad = (fft_size - win_length) // 2
    window = F.pad(window, (lpad, fft_size - win_length - lpad))
    if center:
        pad = fft_size // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode)
        x = x.reshape(*lead, x.shape[-1])
    return torch.fft.rfft(frame_signal(x, fft_size, hop) * window, dim=-1)


def stft_magnitude(x, fft_size: int, hop: int, win_length: int | None = None,
                   *, window=None, center: bool = True,
                   pad_mode: str = "reflect", power: bool = False,
                   clamp_min: float = 1e-7):
    """Magnitude (or, with power=True, power) spectrogram, the power
    clamped below at clamp_min (the reference loss's 1e-7 by default):
    (..., n_frames, fft_size // 2 + 1)."""
    z = stft(x, fft_size, hop, win_length, window=window, center=center,
             pad_mode=pad_mode)
    p = torch.clamp(z.real ** 2 + z.imag ** 2, min=clamp_min)
    return p if power else torch.sqrt(p)


# ---------------------------------------------------------------------------
# librosa-0.8.1-compatible auxiliaries of the feature extraction
# ---------------------------------------------------------------------------


def fft_frequencies(sr: int, n_fft: int) -> np.ndarray:
    return np.linspace(0, sr / 2.0, 1 + n_fft // 2, endpoint=True)


def a_weighting_db(frequencies, min_db: float = -80.0) -> np.ndarray:
    """A-weighting in dB per frequency (librosa 0.8.1 constants)."""
    f_sq = np.asarray(frequencies, dtype=np.float64) ** 2
    const = np.array([12200.0, 20.6, 107.7, 737.9]) ** 2
    with np.errstate(divide="ignore"):
        weights = 2.0 + 20.0 * (
            np.log10(const[0])
            + 2 * np.log10(np.where(f_sq > 0, f_sq, 1e-300))
            - np.log10(f_sq + const[0])
            - np.log10(f_sq + const[1])
            - 0.5 * np.log10(f_sq + const[2])
            - 0.5 * np.log10(f_sq + const[3])
        )
    if min_db is not None:
        weights = np.maximum(min_db, weights)
    return weights


def power_to_db(S, ref: float = 1.0, amin: float = 1e-10,
                top_db: float = 80.0):
    """librosa.power_to_db: the top_db floor is relative to the max of all
    of S, so S is one utterance, never a padded batch."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def db_to_amplitude(S_db, ref: float = 1.0):
    return ref * torch.pow(10.0, 0.5 * S_db / 10.0)


def loudness_extract_frames(audio, sampling_rate: int, hop_length: int,
                            n_fft: int = 2048):
    """A-weighted log-loudness per frame: (T,) -> (T // hop_length + 1,).

    librosa.stft(hop) -> power -> A-weighting + power_to_db (80 dB below
    the utterance's max) -> db_to_amplitude -> mean over frequency ->
    log(. + 1e-5) (the B02 recipe's frame-rate loudness)."""
    power = stft_magnitude(audio, n_fft, hop_length, n_fft, power=True,
                           clamp_min=0.0).T  # (freq, frames)
    weights = torch.as_tensor(
        a_weighting_db(fft_frequencies(sampling_rate, n_fft)),
        dtype=power.dtype, device=power.device)
    loud = db_to_amplitude(power_to_db(power) + weights[:, None])
    return torch.log(loud.mean(dim=0) + 1e-5)


def loudness_extract(audio, sampling_rate: int, hop_length: int,
                     n_fft: int = 2048):
    """A-weighted log-loudness at sample rate: (T,) ->
    ((T // hop + 1) * hop_length,), `loudness_extract_frames` repeated
    hop_length times (FastSVC's)."""
    loud = loudness_extract_frames(audio, sampling_rate, hop_length, n_fft)
    return nearest_upsample(loud[None, :, None], hop_length, axis=1)[0, :, 0]


# ---------------------------------------------------------------------------
# Mel filterbank (slaney scale and norm, librosa-compatible)
# ---------------------------------------------------------------------------


def _hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
        freqs,
    )


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, *, htk: bool = False,
                   norm: str | None = "slaney", dtype=torch.float32,
                   device=None):
    """(n_freqs, n_mels) triangular mel filterbank, librosa-compatible."""
    if fmax is None:
        fmax = sr / 2.0
    return torch.tensor(_mel_weights(sr, n_fft, n_mels, fmin, fmax, htk, norm),
                        dtype=dtype, device=device)


@lru_cache(maxsize=16)
def _mel_weights(sr, n_fft, n_mels, fmin, fmax, htk, norm) -> np.ndarray:
    """The filterbank in f64, built once per set of arguments (tens of ms
    of numpy) and read-only."""
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_pts = _mel_to_hz(
        np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2),
        htk,
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
        weights *= enorm[:, None]
    weights = np.ascontiguousarray(weights.T)
    weights.setflags(write=False)
    return weights
