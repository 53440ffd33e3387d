"""F0 helpers: the YIN estimator, the per-speaker log-F0 statistics and
the conversion between speakers (decode's F0 mean shift), and the
vocoder's pitch-dependent dilation factors.

Counterpart of `svcc23_fastsvc_tpu/dsp/f0.py`. `yin_f0` runs in torch on
the signal's device: the difference function of every frame at once
through an FFT autocorrelation, then the cumulative-mean normalisation,
the first dip under the threshold (else the global minimum) and a
parabolic refinement, as the JAX function computes them.
"""

from __future__ import annotations

import math

import numpy as np


def yin_f0(
    x,
    *,
    sr: int = 16000,
    hop: int = 160,
    frame_length: int = 1024,
    f0_floor: float = 70.0,
    f0_ceil: float = 340.0,
    threshold: float = 0.15,
):
    """YIN F0 of a mono signal (T,) -> (T // hop + 1,) Hz, 0 = unvoiced.

    Frames are centred at k * hop (zero-padded), the frame count of
    WORLD's harvest at shiftms = hop / sr * 1000."""
    import torch  # here, so that the host-only F0 statistics start fast
    import torch.nn.functional as F

    T = x.shape[-1]
    n_frames = T // hop + 1
    W = frame_length // 2  # integration window
    tau_max = min(int(sr / f0_floor) + 1, W - 1)
    tau_min = max(int(sr / f0_ceil) - 1, 2)

    pad = frame_length // 2
    xp = F.pad(x, (pad, pad + n_frames * hop + frame_length - T))
    frames = xp.unfold(-1, frame_length, hop)[:n_frames]  # (F, L)

    # d(tau) = r(0) + r_tau(0) - 2 ac(tau): the energies from a cumulative
    # sum of squares, ac(tau) = sum_j x[j + tau] x[j] over the first W
    # samples through the FFT of the whole frame
    csum = torch.cumsum(frames * frames, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=-1)
    e0 = csum[:, W] - csum[:, 0]
    taus = torch.arange(tau_max + 1, device=x.device)
    e_tau = csum[:, taus + W] - csum[:, taus]  # (F, tau_max + 1)

    n_fft = 1 << int(math.ceil(math.log2(frame_length + W)))
    fx = torch.fft.rfft(frames, n_fft, dim=-1)
    fw = torch.fft.rfft(frames[:, :W], n_fft, dim=-1)
    ac = torch.fft.irfft(fx * torch.conj(fw), n_fft, dim=-1)[:, :tau_max + 1]
    d = torch.clamp(e0[:, None] + e_tau - 2.0 * ac, min=0.0)

    # cumulative-mean-normalised difference, 1 at tau = 0
    tau_idx = torch.arange(1, tau_max + 1, device=x.device)
    cum = torch.cumsum(d[:, 1:], dim=-1)
    cmndf = d[:, 1:] * tau_idx / torch.clamp(cum, min=1e-12)
    cmndf = torch.cat([torch.ones_like(d[:, :1]), cmndf], dim=-1)
    valid = (taus >= tau_min) & (taus <= tau_max)
    cmndf_v = torch.where(valid, cmndf, torch.inf)

    # the first local minimum under the threshold, else the global minimum
    edge = torch.zeros_like(cmndf_v[:, :1], dtype=torch.bool)
    inner = ((cmndf_v[:, 1:-1] <= cmndf_v[:, :-2])
             & (cmndf_v[:, 1:-1] <= cmndf_v[:, 2:]))
    cand = (cmndf_v < threshold) & torch.cat([edge, inner, edge], dim=-1)
    first_cand = torch.argmax(cand.to(torch.uint8), dim=-1)
    tau_star = torch.where(cand.any(dim=-1), first_cand,
                           torch.argmin(cmndf_v, dim=-1))

    # parabolic interpolation around tau_star
    def at(t):
        return cmndf.gather(1, t[:, None])[:, 0]

    y0 = at(torch.clamp(tau_star - 1, 0, tau_max))
    y1 = at(tau_star)
    y2 = at(torch.clamp(tau_star + 1, 0, tau_max))
    denom = y0 + y2 - 2.0 * y1
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (y0 - y2) / denom,
                        torch.zeros_like(denom))
    tau_ref = tau_star + torch.clamp(delta, -1.0, 1.0)

    f0 = sr / torch.clamp(tau_ref, min=1.0)
    voiced = (y1 < threshold) & (f0 >= f0_floor) & (f0 <= f0_ceil)
    voiced &= e0 / W > 1e-8  # silence gate
    return torch.where(voiced, f0, torch.zeros_like(f0))


class F0Statistics:
    """Counterpart of `svcc23_fastsvc_tpu/dsp/f0.py::F0Statistics`: the
    log-F0 mean and std over the voiced frames of a speaker's utterances,
    and the conversion exp((std_t / std_s)(log f0 - mean_s) + mean_t) on
    voiced frames."""

    def estimate(self, f0list):
        vals = np.concatenate(
            [np.log(np.asarray(f0)[np.asarray(f0) > 0]) for f0 in f0list]
        )
        return np.array([np.mean(vals), np.std(vals)])

    def convert(self, f0, orgf0stats, tarf0stats):
        f0 = np.asarray(f0, dtype=np.float64)
        cvf0 = np.zeros_like(f0)
        nz = f0 > 0
        cvf0[nz] = np.exp(
            (tarf0stats[1] / orgf0stats[1]) * (np.log(f0[nz]) - orgf0stats[0])
            + tarf0stats[0]
        )
        return cvf0


def dilated_factor(batch_f0, fs: int, dense_factor: int):
    """Pitch-dependent dilation factors fs / (f0 * dense_factor), in f64,
    unvoiced frames taking 1 (`svcc23_fastsvc_tpu/dsp/f0.py::
    dilated_factor`)."""
    f0 = np.asarray(batch_f0, dtype=np.float64).copy()
    f0[f0 == 0] = fs / dense_factor
    factors = np.ones(f0.shape) * fs / f0 / dense_factor
    factors[factors <= 0] = 1
    return factors
