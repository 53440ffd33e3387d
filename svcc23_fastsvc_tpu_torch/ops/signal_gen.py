"""NSF-style excitation signal generation.

Counterpart of `svcc23_fastsvc_tpu/ops/signal_gen.py`: frame-rate F0
(B, T', 1) becomes a sample-rate excitation (B, T'*hop, C), one channel per
signal type: "sine" (the FastSVC recipe's only type), "noise" (standard
Gaussian noise, the B02 vocoder's second channel) and "uv" (the V/UV flag).
The sine goes through the `sine_excitation` kernel on the card; all noise,
the sine's V/UV-gated noise floor included, comes from the caller's
`torch.Generator` (set `noise_amp=0` for a deterministic sine).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .resample import nearest_upsample
from .sine import sine_excitation


def continuous_f0(f0):
    """Continuous-F0 track: linear interpolation through unvoiced regions.

    f0: (B, T, 1) with 0 marking unvoiced frames. Leading/trailing unvoiced
    runs take the nearest voiced value; an all-unvoiced track stays 0.
    """
    x = f0[..., 0]
    B, T = x.shape
    voiced = x > 0
    idx = torch.arange(T, device=x.device).expand(B, T)
    prev = torch.cummax(torch.where(voiced, idx, torch.full_like(idx, -1)),
                        dim=1).values
    nxt = torch.flip(
        torch.cummin(torch.flip(torch.where(voiced, idx,
                                            torch.full_like(idx, T)), [1]),
                     dim=1).values,
        [1],
    )
    vp = torch.gather(x, 1, prev.clamp(0, T - 1))
    vn = torch.gather(x, 1, nxt.clamp(0, T - 1))
    has_prev, has_next = prev >= 0, nxt <= T - 1
    denom = torch.clamp(nxt - prev, min=1).to(x.dtype)
    w = (idx - prev).to(x.dtype) / denom
    interp = vp + (vn - vp) * w
    zero = torch.zeros_like(x)
    cf0 = torch.where(has_prev & has_next, interp,
                      torch.where(has_prev, vp, torch.where(has_next, vn, zero)))
    return torch.where(voiced, x, cf0)[..., None]


@dataclass(frozen=True)
class SignalGenerator:
    """Builds generator input excitation from frame-rate F0.

    Call with f0 (B, T_frames, 1); returns (B, T_frames*hop, C), C =
    len(signal_types), the channels drawn in that order from one generator.
    sine_f0_type "f0" gates the sine by V/UV; "contf0" drives an ungated
    sine from the continuous-F0 track.
    """

    sample_rate: int = 16000
    hop_size: int = 160
    sine_amp: float = 0.1
    noise_amp: float = 0.003
    signal_types: tuple = ("sine",)
    sine_f0_type: str = "f0"

    def __post_init__(self):
        for t in self.signal_types:
            if t not in ("sine", "noise", "uv"):
                raise ValueError(f"unsupported signal type: {t}")
        if self.sine_f0_type not in ("f0", "contf0"):
            raise ValueError(f"unsupported sine_f0_type: {self.sine_f0_type}")

    def __call__(self, f0, generator: "torch.Generator | None" = None):
        outs = []
        for typ in self.signal_types:
            if typ == "sine":
                outs.append(self.sinusoid(f0, generator))
            elif typ == "noise":
                outs.append(self.random_noise(f0, generator))
            else:
                outs.append(self.vuv_binary(f0))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

    def random_noise(self, f0, generator=None):
        B, T, _ = f0.shape
        return torch.randn((B, T * self.hop_size, 1), generator=generator,
                           dtype=f0.dtype, device=f0.device)

    def sinusoid(self, f0, generator=None):
        src_f0 = continuous_f0(f0) if self.sine_f0_type == "contf0" else f0
        # the kernel gates by f0 > 0: the V/UV gate for "f0", and a no-op on
        # the strictly positive continuous track
        sine = sine_excitation(src_f0[:, :, 0], hop=self.hop_size,
                               sr=self.sample_rate, amp=self.sine_amp)
        sine = sine[:, :, None].to(f0.dtype)
        if self.noise_amp > 0:
            vuv = self.vuv_binary(f0)
            namp = vuv * self.noise_amp + (1.0 - vuv) * (self.noise_amp / 3.0)
            noise = torch.randn(sine.shape, generator=generator,
                                dtype=sine.dtype, device=sine.device)
            sine = sine + noise * namp
        return sine

    def vuv_binary(self, f0):
        return nearest_upsample((f0 > 0).to(f0.dtype), self.hop_size)
