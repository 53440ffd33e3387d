"""Silence trimming with librosa.effects.trim semantics, on the host.

Counterpart of `svcc23_fastsvc_tpu/dsp/trim.py`: frame-wise RMS (frames
centred, zero-padded) in dB relative to the signal's loudest frame; the
span from the first to the last frame above -top_db is kept.
"""

from __future__ import annotations

import numpy as np


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    pad = frame_length // 2
    yp = np.pad(y.astype(np.float64), (pad, pad))
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = (
        np.arange(n_frames)[:, None] * hop_length
        + np.arange(frame_length)[None, :]
    )
    return np.sqrt(np.mean(yp[idx] ** 2, axis=1))


def trim_silence(
    y: np.ndarray,
    *,
    top_db: float = 60.0,
    frame_length: int = 2048,
    hop_length: int = 512,
):
    """Trim silence off both ends. Returns (trimmed, (start, end))."""
    rms = _frame_rms(y, frame_length, hop_length)
    power_db = 20.0 * np.log10(np.maximum(rms, 1e-10))
    threshold = power_db.max() - top_db
    keep = np.nonzero(power_db > threshold)[0]
    if len(keep) == 0:
        return y[:0], (0, 0)
    start = int(keep[0] * hop_length)
    end = min(int((keep[-1] + 1) * hop_length), len(y))
    return y[start:end], (start, end)
