"""Multi-resolution STFT loss.

Counterpart of `svcc23_fastsvc_tpu/losses/stft_loss.py`: per resolution,
spectral convergence (a Frobenius ratio over the whole batch) plus the L1
distance of log magnitudes, both averaged over the resolutions.

Under data parallelism (`group`, the step's data group) the ratio stays
batch-global: its two squared norms are summed across the ranks before
the ratio, with autograd (`parallel.mesh.psum`), as JAX psums them over
the shard_map axis. Each rank's gradient is then the group size times its
share of the global one, and the step's gradient mean restores the
global gradient exactly; a per-rank ratio averaged afterwards would not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..ops.stft import stft_magnitude
from ..parallel.mesh import psum


def stft_loss(x, y, fft_size: int, hop: int, win_length: int, group=None):
    """Single-resolution (sc_loss, mag_loss) on (B, T) signals; `group`
    sums the spectral convergence's norms across the data group."""
    x_mag = stft_magnitude(x, fft_size, hop, win_length)
    y_mag = stft_magnitude(y, fft_size, hop, win_length)
    diff_sq = psum(torch.sum(torch.square(y_mag - x_mag)), group)
    ref_sq = psum(torch.sum(torch.square(y_mag)), group)
    sc = torch.sqrt(diff_sq) / torch.sqrt(ref_sq)
    mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    return sc, mag


@dataclass(frozen=True)
class MultiResolutionSTFTLoss:
    """Default FastSVC config: 6 resolutions (conf/fastsvc.yaml)."""

    fft_sizes: Sequence[int] = (2048, 1024, 512, 256, 128, 64)
    hop_sizes: Sequence[int] = (512, 256, 128, 64, 32, 16)
    win_lengths: Sequence[int] = (2048, 1024, 512, 256, 128, 64)

    def __post_init__(self):
        if not (len(self.fft_sizes) == len(self.hop_sizes)
                == len(self.win_lengths)):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ "
                             "in length")

    def __call__(self, x, y, group=None):
        """x, y: predicted and target signals (B, T) or (B, T, C); `group`
        the data group whose ranks hold the rest of the batch, or None."""
        if x.dim() == 3:  # (B, T, C) -> (B*C, T)
            x = x.movedim(-1, 1).reshape(-1, x.shape[1])
            y = y.movedim(-1, 1).reshape(-1, y.shape[1])
        sc_total, mag_total = 0.0, 0.0
        for fft, hop, win in zip(self.fft_sizes, self.hop_sizes,
                                 self.win_lengths):
            sc, mag = stft_loss(x, y, fft, hop, win, group)
            sc_total = sc_total + sc
            mag_total = mag_total + mag
        n = len(self.fft_sizes)
        return sc_total / n, mag_total / n
