"""WORLD-style spectral analysis of the B02 recipe: mel-cepstrum, coded
band aperiodicity, continuous log-F0 and V/UV from a signal and its F0.

Counterpart of `svcc23_fastsvc_tpu/dsp/world.py`, in torch on the
signal's device, every frame at once:

  * `cheaptrick`: the F0-adaptive Hann(3 T0) window (an (F, fft_size)
    gather), the power spectrum (`torch.fft.rfft`), rectangular smoothing
    of width 2 f0 / 3 through the cumulative integral (one gather at
    floor(q / df) and the bin after it), and the cepstral liftering;
  * `band_aperiodicity`: the normalised correlation of each 3 kHz band at
    the fractional pitch lag, the lag a phase shift of the band spectrum;
    `code_aperiodicity` its dB;
  * `d4c_aperiodicity`: the D4C group-delay statistic, the JAX module's
    measured comparison point (not the pipeline's default);
  * `sp2mc` / `mc2sp` through SPTK's `freqt` recursion, which is linear in
    its input: the recursion runs once per (n_in, order, alpha) on the
    identity in numpy f64 and is applied as one matrix product on the
    device (the JAX scan is ~30,000 steps a call at 24 kHz);
  * `mcepalpha`, `world_fft_size` and `continuous_lf0` stay on the host
    in numpy, as in the JAX module.

The smoothing's cumulative integral is summed, gathered and differenced
in f64 and the result rounded to the input's dtype. The JAX module keeps
it in f32, where the difference of two sums near the frame's whole energy
loses the quiet bins (their envelope falls to the 1e-12 floor, and the
mel-cepstrum of such frames moves by tenths); in f64 the port's f32
result stays near the f64 one, on the card as on the CPU. The
interpolation positions keep the JAX module's f32 expression order, since
the floor of an f32 picks the bin. `world_analyze`, the B02 pipeline's
entry, takes numpy input, runs on `device` (cuda raises without a CUDA
device) in f64 by default and returns f32 numpy.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..train.checkpoint import _device

# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def world_fft_size(fs: int, f0_floor: float = 71.0) -> int:
    return 1 << int(math.ceil(math.log2(3.0 * fs / f0_floor + 1.0)))


@lru_cache(maxsize=16)
def mcepalpha(fs: int, start: float = 0.0, stop: float = 1.0,
              step: float = 0.001, num_points: int = 1000) -> float:
    """All-pass warping coefficient best matching the mel scale at fs
    (pysptk.util.mcepalpha's brute-force fit over 1000 alphas)."""
    alphas = np.arange(start, stop, step)
    omega = np.linspace(0, 0.5, num_points + 1)[1:]
    mel = 1000.0 / np.log(2.0) * np.log(1.0 + omega * fs / 1000.0)
    mel /= mel[-1]
    best, best_err = 0.0, np.inf
    two_pi_om = 2 * np.pi * omega
    for a in alphas:
        warp = np.arctan((1 - a * a) * np.sin(two_pi_om)
                         / ((1 + a * a) * np.cos(two_pi_om) - 2 * a))
        warp = np.where(warp < 0, warp + np.pi, warp)
        warp /= warp[-1]
        err = np.sum((warp - mel) ** 2)
        if err < best_err:
            best, best_err = a, err
    return float(best)


def continuous_lf0(f0):
    """(F,) F0 -> (lf0 (F,), vuv (F,)) f32, log-F0 linearly interpolated
    over unvoiced gaps and held at the ends (reference preprocess_b02.py:
    49-105, 297-303)."""
    f0 = np.asarray(f0, dtype=np.float64).copy()
    lf0 = f0.copy()
    nz = f0 > 0
    lf0[nz] = np.log(f0[nz])
    vuv = (lf0 != 0).astype(np.float32)
    idx = np.where(lf0 > 0)[0]
    if len(idx) == 0:
        return lf0.astype(np.float32), vuv
    lf0[0] = lf0[idx[0]]
    lf0[-1] = lf0[idx[-1]]
    idx = np.where(lf0 > 0)[0]
    zero = np.where(lf0 <= 0)[0]
    if len(zero):
        lf0[zero] = np.interp(zero, idx, lf0[idx])
    return lf0.astype(np.float32), vuv


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _frames(x, positions, offsets):
    """(F, len(offsets)) samples x[positions + offsets], 0 outside x."""
    T = x.shape[0]
    idx = positions[:, None] + offsets[None, :]
    return torch.where((idx >= 0) & (idx < T), x[idx.clamp(0, T - 1)], 0.0)


def _linear_smoothing(spec, width_hz, fs, fft_size):
    """WORLD LinearSmoothing: rectangular smoothing of per-frame width
    width_hz over the (F, n_bins) one-sided spectrum, mirrored at DC and
    Nyquist, as the difference of its cumulative integral (f64) linearly
    interpolated at f +- width / 2."""
    n_bins = spec.shape[1]
    df = fs / fft_size
    pad = n_bins // 2
    ext = torch.cat([spec[:, 1:pad + 1].flip(1), spec,
                     spec[:, -pad - 1:-1].flip(1)], 1)
    n_ext = ext.shape[1]
    cum = torch.cumsum(ext, 1, dtype=torch.float64) * df
    cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], 1)
    freqs = torch.arange(n_bins, device=spec.device, dtype=spec.dtype) * df

    def interp_cum(q):
        pos = q / df
        lo = torch.floor(pos).long().clamp(0, n_ext - 1)
        frac = (pos - lo).double()
        at_lo = cum.gather(1, lo)
        return at_lo + frac * (cum.gather(1, (lo + 1).clamp(0, n_ext))
                               - at_lo)

    q_hi = freqs[None, :] + width_hz[:, None] / 2 + pad * df
    q_lo = freqs[None, :] - width_hz[:, None] / 2 + pad * df
    return ((interp_cum(q_hi) - interp_cum(q_lo)).to(spec.dtype)
            / width_hz[:, None])


# ---------------------------------------------------------------------------
# CheapTrick spectral envelope
# ---------------------------------------------------------------------------


def cheaptrick(x, f0, positions, *, fs: int, fft_size: int = 0,
               q1: float = -0.15, default_f0: float = 500.0):
    """F0-adaptive power envelope per frame.

    x (T,) signal, f0 (F,) per-frame F0 (0 = unvoiced -> default_f0),
    positions (F,) integer frame centres, all on one device ->
    (F, fft_size // 2 + 1) in x's dtype."""
    if fft_size == 0:
        fft_size = world_fft_size(fs)
    half = fft_size // 2
    f0v = torch.where(f0 > 0, f0, default_f0)
    f0v = torch.clamp(f0v, min=3.0 * fs / fft_size)  # the window must fit

    # F0-adaptive windowing (WORLD GetWindowedWaveform)
    base = torch.arange(-half, half, device=x.device)
    seg = _frames(x, positions, base)
    t_rel = base.to(x.dtype)[None, :] / fs  # seconds from the frame centre
    in_win = t_rel.abs() <= 1.5 / f0v[:, None]
    window = torch.where(
        in_win, 0.5 * torch.cos(math.pi * t_rel * f0v[:, None] / 1.5) + 0.5,
        0.0)
    wsum = window.sum(1, keepdim=True)
    seg = seg * window
    seg = seg - window * (seg.sum(1, keepdim=True) / wsum)
    power = torch.fft.rfft(seg, fft_size, dim=1).abs() ** 2

    smoothed = _linear_smoothing(power, 2.0 * f0v / 3.0, fs, fft_size)
    smoothed = torch.clamp(smoothed, min=1e-12)

    # liftering (SmoothingWithRecovery)
    cep = torch.fft.irfft(torch.log(smoothed), fft_size, dim=1)[:, :half + 1]
    tau = torch.arange(half + 1, device=x.device, dtype=x.dtype) / fs
    arg = f0v[:, None] * tau[None, :]
    ls = torch.where(arg > 1e-9, torch.sin(math.pi * arg) / (math.pi * arg),
                     1.0)
    lq = (1.0 + 2.0 * q1) + 2.0 * q1 * torch.cos(2.0 * math.pi * arg)
    cep = cep * ls * lq
    full = torch.cat([cep, cep[:, 1:-1].flip(1)], 1)
    return torch.exp(torch.fft.rfft(full, dim=1).real)


# ---------------------------------------------------------------------------
# band aperiodicity (the pipeline's) and its coding
# ---------------------------------------------------------------------------


def band_aperiodicity(x, f0, positions, *, fs: int, n_bands: int | None = None,
                      frame_length: int = 0):
    """Per-frame, per-band aperiodicity in (0, 1]: band b covers
    [3 kHz b, 3 kHz (b + 1)); periodicity is the normalised correlation of
    the band-passed rectangular frame with itself delayed by the exact
    (fractional) pitch lag, a phase shift of the band spectrum, over the
    samples the circular delay does not wrap; aperiodicity =
    sqrt(max(1 - periodicity, 1e-6)), 0.999999 where unvoiced. All bands
    at once: (F, n_bands)."""
    if n_bands is None:
        n_bands = max(int(fs / 2 / 3000) - 1, 1)
    if frame_length == 0:
        frame_length = world_fft_size(fs) // 2
    half = frame_length // 2
    dev = x.device
    seg = _frames(x, positions, torch.arange(-half, half, device=dev))
    spec = torch.fft.rfft(seg, dim=1)
    n_bins = spec.shape[1]
    freqs = np.arange(n_bins) * fs / frame_length  # f64, as in JAX

    f0v = torch.where(f0 > 0, f0, 500.0)
    lag_f = torch.clamp(fs / f0v, 1.0, half - 1.0)  # fractional pitch lag
    lag_i = torch.ceil(lag_f).long()
    overlap = (torch.arange(frame_length, device=dev)[None, :]
               < (frame_length - lag_i[:, None]))[:, None, :].to(x.dtype)
    rot = torch.exp(2j * math.pi * torch.as_tensor(
        freqs, dtype=x.dtype, device=dev)[None, :] * lag_f[:, None] / fs)
    masks = torch.as_tensor(np.stack([
        (freqs >= 3000.0 * b) & (freqs < 3000.0 * (b + 1))
        for b in range(n_bands)]), dtype=x.dtype, device=dev)
    sel = spec[:, None, :] * masks  # (F, n_bands, n_bins)
    band = torch.fft.irfft(sel, frame_length, dim=2)
    shifted = torch.fft.irfft(sel * rot[:, None, :], frame_length, dim=2)
    r = (band * shifted * overlap).sum(2)
    e1 = (band.square() * overlap).sum(2)
    e2 = (shifted.square() * overlap).sum(2)
    periodicity = torch.clamp(
        r / torch.sqrt(torch.clamp(e1 * e2, min=1e-20)), 0.0, 1.0)
    ap = torch.sqrt(torch.clamp(1.0 - periodicity, min=1e-6))
    return torch.where(f0[:, None] > 0, ap, 0.999999)


def code_aperiodicity(ap_bands):
    """Coded band aperiodicity in dB (WORLD code_aperiodicity)."""
    return 20.0 * torch.log10(ap_bands)


# ---------------------------------------------------------------------------
# D4C aperiodicity (group-delay statistic, Morise 2016)
# ---------------------------------------------------------------------------


_D4C_FLOOR_F0 = 47.0  # WORLD kFloorF0D4C
_D4C_FREQ_INTERVAL = 3000.0  # WORLD kFrequencyInterval


def _d4c_fft_size(fs: int) -> int:
    return 1 << (1 + int(math.ceil(math.log2(4.0 * fs / _D4C_FLOOR_F0 + 1.0))))


def _nuttall(n: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n)
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * t)
            + 0.144232 * np.cos(4 * np.pi * t)
            - 0.012604 * np.cos(6 * np.pi * t)).astype(np.float32)


def _windowed_buffer(x, positions, f0v, fs, fft_size, ratio, kind):
    """WORLD GetWindowedWaveform: (F, fft_size) buffers holding the
    f0-adaptive window of span ratio * T0 at the buffer's start, the
    window-weighted mean removed. kind: "hanning" | "blackman"."""
    T = x.shape[0]
    halfw = torch.round(ratio * fs / f0v / 2.0).long()
    j = torch.arange(fft_size, device=x.device)[None, :]
    src = positions[:, None] - halfw[:, None] + j
    valid = j <= 2 * halfw[:, None]
    seg = torch.where(valid & (src >= 0) & (src < T),
                      x[src.clamp(0, T - 1)], 0.0)
    p = (j - halfw[:, None]).to(x.dtype) / fs * f0v[:, None] * (2.0 / ratio)
    if kind == "hanning":
        win = 0.5 * torch.cos(math.pi * p) + 0.5
    else:  # blackman
        win = (0.42 + 0.5 * torch.cos(math.pi * p)
               + 0.08 * torch.cos(2 * math.pi * p))
    win = torch.where(valid, win, 0.0)
    seg = seg * win
    return seg - win * (
        seg.sum(1, keepdim=True)
        / torch.clamp(win.sum(1, keepdim=True), min=1e-12))


def _dc_correction(spec, f0v, fs, fft_size):
    """WORLD DCCorrection: bins below f0 get the value mirrored at f0 - f
    added (linearly interpolated)."""
    n_bins = spec.shape[1]
    df = fs / fft_size
    freqs = torch.arange(n_bins, device=spec.device, dtype=spec.dtype) * df
    q = (f0v[:, None] - freqs[None, :]) / df
    lo = torch.floor(q).long().clamp(0, n_bins - 1)
    frac = q - lo
    mirrored = spec.gather(1, lo) * (1 - frac) + (
        spec.gather(1, (lo + 1).clamp(0, n_bins - 1)) * frac)
    return torch.where(freqs[None, :] < f0v[:, None], spec + mirrored, spec)


def d4c_aperiodicity(x, f0, positions, *, fs: int,
                     n_bands: int | None = None, fft_size: int = 0):
    """Per-frame, per-band aperiodicity in (0, 1] from D4C's group-delay
    statistic: the static centroid of two Blackman(4 T0) windows at
    +- T0 / 4, the DC-corrected, f0-smoothed Hanning(4 T0) power, their
    ratio smoothed at f0 / 2 minus its f0 smoothing, then per 3 kHz band
    the share of a Nuttall-windowed segment's power outside its top
    peaks, in dB, revised by min(0, ap + (f0 - 100) / 50). Band b is
    centred at 3 kHz (b + 1). (F, n_bands)."""
    if fft_size == 0:
        fft_size = _d4c_fft_size(fs)
    if n_bands is None:
        n_bands = max(int(fs / 2 / _D4C_FREQ_INTERVAL) - 1, 1)
    f0v = torch.where(f0 > 0, torch.clamp(f0, min=_D4C_FLOOR_F0), 500.0)
    pos = positions.long()
    n_bins = fft_size // 2 + 1
    ramp = torch.arange(fft_size, device=x.device,
                        dtype=x.dtype)[None, :] + 1.0

    # 1. static centroid
    def centroid_at(shift_sign):
        shift = torch.round(shift_sign * 0.25 * fs / f0v).long()
        seg = _windowed_buffer(x, pos + shift, f0v, fs, fft_size, 4.0,
                               "blackman")
        seg = seg / torch.sqrt(torch.clamp((seg * seg).sum(1, keepdim=True),
                                           min=1e-30))
        S = torch.fft.rfft(seg, fft_size, dim=1)
        W = torch.fft.rfft(seg * ramp, fft_size, dim=1)
        return S.real * W.real + S.imag * W.imag

    static_centroid = _dc_correction(centroid_at(-1.0) + centroid_at(1.0),
                                     f0v, fs, fft_size)

    # 2. smoothed power spectrum
    seg = _windowed_buffer(x, pos, f0v, fs, fft_size, 4.0, "hanning")
    power = torch.fft.rfft(seg, fft_size, dim=1).abs() ** 2
    power = _dc_correction(power, f0v, fs, fft_size)
    power = _linear_smoothing(power, f0v, fs, fft_size)

    # 3. static group delay; a relative power floor keeps near-empty
    # regions from overflowing the band statistic
    floor = 1e-12 * power.amax(1, keepdim=True)
    sgd = static_centroid / torch.maximum(power, floor)
    sgd = _linear_smoothing(sgd, f0v / 2.0, fs, fft_size)
    sgd = sgd - _linear_smoothing(sgd, f0v, fs, fft_size)

    # 4. coarse aperiodicity, every band at once
    half_win = int(_D4C_FREQ_INTERVAL * fft_size / fs)
    span = 2 * half_win + 1
    win = torch.as_tensor(_nuttall(span), dtype=sgd.dtype, device=x.device)
    boundary = int(round(fft_size * 8.0 / span))
    segs = torch.stack([
        sgd[:, lo:lo + span] for lo in (
            int(_D4C_FREQ_INTERVAL * (b + 1) * fft_size / fs) - half_win
            for b in range(n_bands))], 1) * win
    p = torch.fft.rfft(segs, fft_size, dim=2).abs() ** 2
    csum = torch.cumsum(torch.sort(p, dim=2).values, 2)
    ap_db = 10.0 * torch.log10(
        torch.clamp(csum[:, :, n_bins - 2 - boundary], min=1e-30)
        / torch.clamp(csum[:, :, -1], min=1e-30))
    ap_db = torch.clamp(ap_db + ((f0v - 100.0) / 50.0)[:, None], max=0.0)
    ap = torch.pow(10.0, ap_db / 20.0)
    return torch.where(f0[:, None] > 0, torch.clamp(ap, 1e-6, 0.999999),
                       0.999999)


# ---------------------------------------------------------------------------
# mel-cepstrum (SPTK sp2mc / mc2sp)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def freqt_matrix(n_in: int, order: int, alpha: float) -> np.ndarray:
    """(n_in, order + 1) f64 matrix A with freqt(c) = c @ A: SPTK's
    frequency-transform recursion (over the input coefficients from the
    last to the first, each an update of the warped cepstrum from its
    lowest coefficient up) run on the identity. Read-only."""
    eye = np.eye(n_in)
    wc = np.zeros((n_in, order + 1))
    for i in range(n_in - 1, -1, -1):
        prev, wc = wc, np.empty_like(wc)
        wc[:, 0] = eye[:, i] + alpha * prev[:, 0]
        if order >= 1:
            wc[:, 1] = (1 - alpha ** 2) * prev[:, 0] + alpha * prev[:, 1]
        for m in range(2, order + 1):
            wc[:, m] = prev[:, m - 1] + alpha * (prev[:, m] - wc[:, m - 1])
    wc.setflags(write=False)
    return wc


def freqt(c, order: int, alpha: float):
    """SPTK freqt: (F, M + 1) cepstra -> (F, order + 1) warped cepstra, one
    matrix product in c's dtype on c's device."""
    a = freqt_matrix(c.shape[1], order, float(alpha))
    return c @ torch.tensor(a, dtype=c.dtype, device=c.device)


def sp2mc(powerspec, order: int, alpha: float):
    """Power spectrum (F, n_fft // 2 + 1) -> mel-cepstrum (F, order + 1)
    (pysptk sp2mc)."""
    n_bins = powerspec.shape[1]
    c = torch.fft.irfft(torch.log(powerspec), dim=1)[:, :n_bins]
    c = torch.cat([c[:, :1] / 2.0, c[:, 1:]], 1)
    return freqt(c, order, alpha)


def mc2sp(mc, alpha: float, fft_size: int):
    """Inverse of sp2mc: mel-cepstrum -> (F, fft_size // 2 + 1) power."""
    c = freqt(mc, fft_size // 2, -alpha)
    c = torch.cat([c[:, :1] * 2.0, c[:, 1:]], 1)
    sym = torch.cat([c, c[:, 1:-1].flip(1)], 1)
    return torch.exp(torch.fft.rfft(sym, dim=1).real)


# ---------------------------------------------------------------------------
# the B02 bundle
# ---------------------------------------------------------------------------


def world_analyze(x, f0, *, fs: int, hop: int, mcep_order: int = 59,
                  alpha: float | None = None, device="cuda",
                  dtype=torch.float64):
    """(mcep (F, mcep_order + 1), bap (F, n_bands), lf0 (F,), vuv (F,)) as
    f32 numpy from a numpy signal and its F0 at frames hop samples apart:
    CheapTrick, sp2mc, band aperiodicity and its coding on `device`,
    computed in `dtype` from the signal rounded to f32, the continuous
    log-F0 on the host.

    The compute dtype is f64 by default (the JAX function computes in
    f32). In f32 the quiet bins of a frame keep the FFT's round-off
    relative to its loudest bin, which the log envelope and the band
    correlation near periodicity 1 magnify: on 8 x 4 s of singing
    (chip_smoke.py phase 24, NVIDIA H100 80GB HBM3, 700 W) the f32 mcep
    was 4.7e-4 from f64 on the CPU and 1.5e-3 on the card (cuFFT), the
    bap up to 2.7e-3 dB on both; in f64 the card's mcep is 3.7e-5 from
    the CPU's and its bap equal."""
    if alpha is None:
        alpha = mcepalpha(fs)
    device = _device(device)
    f0t = torch.as_tensor(np.asarray(f0, np.float32), device=device).to(dtype)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)
    positions = torch.arange(f0t.shape[0], device=device) * hop
    with torch.inference_mode():
        mcep = sp2mc(cheaptrick(xt, f0t, positions, fs=fs), mcep_order,
                     alpha)
        bap = code_aperiodicity(band_aperiodicity(xt, f0t, positions,
                                                  fs=fs))
        mcep, bap = (a.float().cpu().numpy() for a in (mcep, bap))
    lf0, vuv = continuous_lf0(np.asarray(f0))
    return mcep, bap, lf0, vuv
