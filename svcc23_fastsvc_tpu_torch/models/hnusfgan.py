"""HN-uSFGAN vocoder (the B02 recipe's synthesis stage).

Counterpart of `svcc23_fastsvc_tpu/models/hnusfgan.py` as `nn.Module`s:
sine | noise excitation -> a harmonic network of pitch-adaptive blocks and a
noise network of fixed-dilation blocks, mixed by a periodicity estimator,
then a filter network of fixed blocks, all conditioned on WORLD features
upsampled to sample rate. Tensors are channels-last (B, T, C), as in the
JAX package. Parameters keep the reference torch module tree and state-dict
keys (the ones `svcc23_fastsvc_tpu/compat/torch_weights.py::
convert_hnusfgan` reads): `conv_first_{sine,noise}`, `upsample_net.conv_in`
and `upsample_net.upsample.up_layers.{2k+1}` (Conv2d (1, 1, 1, 2s+1)),
`{harmonic,noise,filter}_network.conv_dilated.{i}`,
`periodicity_estimator.layers.{2k}` and `conv_last.{1,3}`; placeholders
keep each conv at its reference index.

`ResidualBlocks` dispatches as the JAX package does, without its kernel
switches, with weight norm folded or live (the blocks take the effective
weights): an adaptive block runs `ops.pd_block.pd_adaptive_block` when the
dilation factors are frame-constant (`pd_frame_hop` > 0, T % hop == 0), and
every (K=3) fixed block runs `pd_fixed_block`, or, where chaining is on
(`FASTSVC_PD_CHAIN` >= 2, see `chain_max`), a run of them runs as one
`pd_fixed_chain`, grouped by the JAX package's rule; each launches its CUDA
kernel on a CUDA tensor and takes its plain version on a CPU one. With
per-sample dilation factors an adaptive block gathers per sample
(`pd_indexing`) and
runs the same block math as the plain version (`ops.pd_block.
adaptive_block_gathered`). The reference's skip convs are dead computation
there and here: they keep their parameters and are never applied.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
from torch import nn

from ..ops.conv import conv_weight, edge_pad1d
from ..ops.pd_block import (
    adaptive_block_gathered,
    fixed_chain_offsets,
    frame_shifts,
    masked_gather,
    pd_adaptive_block,
    pd_block_halo,
    pd_fixed_block,
    pd_fixed_chain,
    shift_gather,
)
from ..ops.resample import nearest_upsample
from .fastsvc import Conv1d, _placeholders

# the adaptive kernels' shift clamp, as the JAX package sizes it (for f0 >=
# 37.5 Hz nothing is clamped, at 16 or 24 kHz)
PD_HALO_FS = 24000


def chain_max() -> int:
    """The longest run of fixed blocks that runs as one `pd_fixed_chain`:
    FASTSVC_PD_CHAIN, read as the JAX package's `_chain_max` reads it
    (default "0"; below 2, or not an integer, turns chaining off). The JAX
    package also asks its pd-kernel mode and a TPU self-check; the port's
    blocks always run its kernels, so the variable alone decides."""
    try:
        n = int(os.environ.get("FASTSVC_PD_CHAIN", "0"))
    except ValueError:
        return 1
    return n if n >= 2 else 1


def chain_halo_max() -> int:
    """The halo budget of a chain, in the JAX kernel's 32-aligned rows:
    FASTSVC_PD_CHAIN_HALO, default 160 (the (1, 2, 4, 8, 16) filter-cycle
    prefix, or five d=1 noise blocks), as the JAX `_chain_halo_max`."""
    try:
        return int(os.environ.get("FASTSVC_PD_CHAIN_HALO", "160"))
    except ValueError:
        return 160


def pd_indexing(x, d, dilation: int):
    """Per-sample pitch gather: (xP, xF) = x at round(t -/+ d * dilation),
    zero outside [0, T). x (B, T, C), d (B, T) f32. The index is rounded
    after the add, half to even, as in the reference."""
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    return (masked_gather(x, torch.round(t - d * dilation).long()),
            masked_gather(x, torch.round(t + d * dilation).long()))


def pd_indexing_framewise(x, d, dilation: int, hop: int):
    """`pd_indexing` for frame-constant d: one shift round(d * dilation) per
    frame of `hop` samples. Equal to the per-sample form except where
    d * dilation is exactly half an integer (rounded once per frame here).
    Falls back to `pd_indexing` when T % hop != 0."""
    T = x.shape[1]
    if T % hop:
        return pd_indexing(x, d, dilation)
    shifts = torch.round(d[:, ::hop] * dilation).to(torch.int32)
    return shift_gather(x, shifts, hop)


def _block_params(**convs):
    """The {"w": WIO view[, "b"]} dicts `ops.pd_block` takes."""
    return {k: {"w": m.wio()} if m.bias is None else
            {"w": m.wio(), "b": m.bias} for k, m in convs.items()}


class FixedBlock(nn.Module):
    """Gated block with a fixed-dilation K=3 conv (reflect padded)."""

    def __init__(self, residual_channels=64, gate_channels=128,
                 skip_channels=64, aux_channels=80, dilation=1,
                 use_weight_norm=True, *, device=None, generator=None):
        super().__init__()
        kw = dict(weight_norm=use_weight_norm, device=device,
                  generator=generator)
        R, G = residual_channels, gate_channels
        self.dilation = dilation
        self.conv = Conv1d(R, G, 3, **kw)
        self.conv1x1_aux = Conv1d(aux_channels, G, 1, bias=False, **kw)
        self.conv1x1_out = Conv1d(G // 2, R, 1, **kw)
        self.conv1x1_skip = Conv1d(G // 2, skip_channels, 1, **kw)

    def block_params(self):
        return _block_params(conv=self.conv, aux=self.conv1x1_aux,
                             out=self.conv1x1_out)

    def forward(self, x, c):
        return pd_fixed_block(x, c, self.block_params(),
                              dilation=self.dilation)


class AdaptiveBlock(nn.Module):
    """Pitch-adaptive gated block: 1x1 convs on x, its pitch-lagged past
    xP and future xF."""

    def __init__(self, residual_channels=64, gate_channels=128,
                 skip_channels=64, aux_channels=80, use_weight_norm=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(weight_norm=use_weight_norm, device=device,
                  generator=generator)
        R, G = residual_channels, gate_channels
        self.convP = Conv1d(R, G, 1, **kw)
        self.convC = Conv1d(R, G, 1, **kw)
        self.convF = Conv1d(R, G, 1, **kw)
        self.conv1x1_aux = Conv1d(aux_channels, G, 1, bias=False, **kw)
        self.conv1x1_out = Conv1d(G // 2, R, 1, **kw)
        self.conv1x1_skip = Conv1d(G // 2, skip_channels, 1, **kw)

    def block_params(self):
        return _block_params(convC=self.convC, convP=self.convP,
                             convF=self.convF, aux=self.conv1x1_aux,
                             out=self.conv1x1_out)

    def forward(self, xC, xP, xF, c):
        """The block on gathered xP, xF (the per-sample path)."""
        return adaptive_block_gathered(xC, xP, xF, c, self.block_params())


class ResidualBlocks(nn.Module):
    """Adaptive blocks (dilations 2^(i % per cycle)) then fixed blocks, or
    the reverse with cascade_mode 1."""

    def __init__(self, blockA, cycleA, blockF, cycleF, cascade_mode=0,
                 residual_channels=64, gate_channels=128, skip_channels=64,
                 aux_channels=80, use_weight_norm=True, pd_frame_hop=0, *,
                 device=None, generator=None):
        super().__init__()
        cycleA, cycleF = max(cycleA, 1), max(cycleF, 1)
        if blockA % cycleA or blockF % cycleF:
            raise ValueError("blocks must be a multiple of their cycle")
        per_a, per_f = max(blockA // cycleA, 1), max(blockF // cycleF, 1)
        kw = dict(residual_channels=residual_channels,
                  gate_channels=gate_channels, skip_channels=skip_channels,
                  aux_channels=aux_channels, use_weight_norm=use_weight_norm,
                  device=device, generator=generator)
        adaptive = [(2 ** (i % per_a), AdaptiveBlock(**kw))
                    for i in range(blockA)]
        fixed = [(2 ** (i % per_f),
                  FixedBlock(dilation=2 ** (i % per_f), **kw))
                 for i in range(blockF)]
        blocks = adaptive + fixed if cascade_mode == 0 else fixed + adaptive
        self.dilations = [d for d, _ in blocks]
        self.conv_dilated = nn.ModuleList(b for _, b in blocks)
        self.pd_frame_hop = pd_frame_hop

    def plan(self, T: int):
        """The order of launches for a stream of T samples, as JAX
        `ResidualBlocks.apply` groups it: ("chain", [i, ..]) for a run of
        fixed blocks that starts at dilation 1 and grows while the next
        block is fixed, up to `chain_max()` blocks and while the run's
        32-aligned halo (`fixed_chain_offsets`) stays within
        `chain_halo_max()` and T >= 2 halo, kept when it holds 2 or more;
        ("fixed", i) and ("adaptive", i) for the rest. Runs need T % 32 ==
        0, as in the JAX package, so both chain the same runs."""
        n_max = chain_max() if T % 32 == 0 else 1
        halo_max = chain_halo_max()
        fixed = [isinstance(b, FixedBlock) for b in self.conv_dilated]
        steps, i = [], 0
        while i < len(fixed):
            if not fixed[i]:
                steps.append(("adaptive", i))
                i += 1
                continue
            run = []
            if n_max >= 2 and self.dilations[i] == 1:
                j = i
                while j < len(fixed) and fixed[j] and len(run) < n_max:
                    halo = fixed_chain_offsets(
                        [self.dilations[k] for k in run + [j]])[-1]
                    if halo > halo_max or T < 2 * halo:
                        break
                    run.append(j)
                    j += 1
            if len(run) >= 2:
                steps.append(("chain", run))
                i = run[-1] + 1
            else:
                steps.append(("fixed", i))
                i += 1
        return steps

    def forward(self, x, c, d):
        """x (B, T, R), c (B, T, aux), d (B, T) f32 dilation factors."""
        hop = self.pd_frame_hop
        framewise = hop > 0 and x.shape[1] % hop == 0
        # the kernels take contiguous streams (the periodicity estimator's
        # channels-first conv output can leave the mixed source transposed)
        x, c = x.contiguous(), c.contiguous()
        shifts = {}  # by dilation, for the adaptive kernel
        for kind, i in self.plan(x.shape[1]):
            if kind == "chain":
                x = pd_fixed_chain(
                    x, c, [self.conv_dilated[k].block_params() for k in i],
                    dilations=[self.dilations[k] for k in i])
                continue
            dil, blk = self.dilations[i], self.conv_dilated[i]
            if kind == "fixed":
                x = blk(x, c)
            elif framewise:
                if dil not in shifts:
                    shifts[dil] = frame_shifts(
                        d, dil, hop, pd_block_halo(dil, PD_HALO_FS, hop=hop))
                x = pd_adaptive_block(x, c, shifts[dil], blk.block_params(),
                                      hop=hop)
            else:
                x = blk(x, *pd_indexing(x, d, dil), c)
        return x


class PeriodicityEstimator(nn.Module):
    """Edge-padded conv stack, relu between layers, sigmoid at the end."""

    def __init__(self, in_channels=62, residual_channels=64, conv_layers=3,
                 kernel_size=5, dilation=1, use_weight_norm=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(weight_norm=use_weight_norm, device=device,
                  generator=generator)
        convs, cin = {}, in_channels
        for i in range(conv_layers):
            convs[2 * i] = Conv1d(cin, residual_channels, kernel_size, **kw)
            cin = residual_channels
        last = convs[2 * (conv_layers - 1)]
        with torch.no_grad():  # reference init: sigmoid starts near 0.5
            v = torch.randn(last.wio().shape, generator=generator,
                            device=device).permute(2, 1, 0) * 1e-4
            if last.folded:
                last.weight.copy_(v)
            else:
                last.weight_v.copy_(v)
                last.weight_g.copy_(v.norm(dim=(1, 2), keepdim=True))
        self.layers = _placeholders(2 * conv_layers, convs)
        self.n_layers, self.kernel_size = conv_layers, kernel_size
        self.dilation = dilation

    def forward(self, x):
        pad = self.kernel_size // 2 * self.dilation
        for i in range(self.n_layers):
            x = self.layers[2 * i](edge_pad1d(x, pad), dilation=self.dilation,
                                   padding=0)
            x = torch.relu(x) if i < self.n_layers - 1 else torch.sigmoid(x)
        return x


class TimeConv2d(nn.Module):
    """torch Conv2d(1, 1, (1, K), bias=False) as the upsampler uses it: one
    K-tap time kernel for every channel. Weight (1, 1, 1, K), or weight-norm
    weight_g (1, 1, 1, 1) / weight_v; initialised to 1/K."""

    def __init__(self, kernel_size, weight_norm=True, *, device=None):
        super().__init__()
        w = torch.full((1, 1, 1, kernel_size), 1.0 / kernel_size,
                       device=device)
        if weight_norm:
            self.weight_g = nn.Parameter(w.norm().reshape(1, 1, 1, 1))
            self.weight_v = nn.Parameter(w)
        else:
            self.weight = nn.Parameter(w)

    @property
    def folded(self) -> bool:
        return "weight" in self._parameters

    def taps(self):
        """The (K,) time kernel."""
        if self.folded:
            return self.weight.reshape(-1)
        k = self.weight_v.shape[-1]  # as a WIO (K, 1, 1) weight
        return conv_weight({"v": self.weight_v.reshape(k, 1, 1),
                            "g": self.weight_g.reshape(1)}).reshape(-1)

    def fold_weight_norm_(self):
        if self.folded:
            return
        with torch.no_grad():
            w = self.taps().reshape(self.weight_v.shape).clone()
        del self.weight_g, self.weight_v
        self.weight = nn.Parameter(w)


class ConvInUpsampleNetwork(nn.Module):
    """Aux-feature upsampler: a VALID context conv, then per scale s a
    nearest stretch and a (2s+1)-tap time kernel shared by all channels."""

    def __init__(self, upsample_scales=(5, 4, 3, 2), aux_channels=62,
                 aux_context_window=2, use_weight_norm=True, *, device=None,
                 generator=None):
        super().__init__()
        self.upsample_scales = tuple(upsample_scales)
        self.conv_in = Conv1d(aux_channels, aux_channels,
                              2 * aux_context_window + 1, bias=False,
                              weight_norm=use_weight_norm, device=device,
                              generator=generator)
        self.upsample = nn.Module()
        self.upsample.up_layers = _placeholders(
            2 * len(self.upsample_scales),
            {2 * i + 1: TimeConv2d(2 * s + 1, use_weight_norm, device=device)
             for i, s in enumerate(self.upsample_scales)})

    def forward(self, c):
        """(B, T', aux) padded by aux_context_window -> (B, (T'-2acw) *
        prod(scales), aux)."""
        c = self.conv_in(c, padding=0)
        for i, s in enumerate(self.upsample_scales):
            c = nearest_upsample(c, s)
            T = c.shape[1]
            # 2s+1 shifted adds, as the JAX package lowers the (1, 2s+1) conv
            w = self.upsample.up_layers[2 * i + 1].taps()
            xp = torch.nn.functional.pad(c, (0, 0, s, s))
            c = sum(w[k] * xp[:, k:k + T] for k in range(2 * s + 1))
        return c


class HNUSFGANGenerator(nn.Module):
    """Harmonic-plus-noise unified source-filter GAN generator."""

    def __init__(self, harmonic_params=None, noise_params=None,
                 filter_params=None, in_channels: int = 1,
                 out_channels: int = 1, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64,
                 aux_channels: int = 62, aux_context_window: int = 2,
                 upsample_scales: Sequence[int] = (5, 4, 3, 2),
                 periodicity_layers: int = 3, periodicity_kernel: int = 5,
                 use_weight_norm: bool = True, pd_frame_hop: int = 0, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        wn = dict(weight_norm=use_weight_norm, **kw)
        common = dict(residual_channels=residual_channels,
                      gate_channels=gate_channels,
                      skip_channels=skip_channels, aux_channels=aux_channels,
                      use_weight_norm=use_weight_norm,
                      pd_frame_hop=pd_frame_hop, **kw)

        def net(params, default):
            # the reference injects the channel sizes into these dicts;
            # accept either form
            p = dict(default if params is None else params)
            return ResidualBlocks(**{k: v for k, v in p.items()
                                     if k not in common}, **common)

        self.aux_context_window = aux_context_window
        self.conv_first_sine = Conv1d(in_channels, residual_channels, 1, **wn)
        self.conv_first_noise = Conv1d(in_channels, residual_channels, 1, **wn)
        self.upsample_net = ConvInUpsampleNetwork(
            upsample_scales, aux_channels, aux_context_window,
            use_weight_norm, **kw)
        self.harmonic_network = net(harmonic_params, dict(
            blockA=20, cycleA=4, blockF=0, cycleF=0, cascade_mode=0))
        self.noise_network = net(noise_params, dict(
            blockA=0, cycleA=0, blockF=5, cycleF=5, cascade_mode=0))
        self.filter_network = net(filter_params, dict(
            blockA=0, cycleA=0, blockF=30, cycleF=3, cascade_mode=0))
        self.periodicity_estimator = PeriodicityEstimator(
            aux_channels, residual_channels, periodicity_layers,
            periodicity_kernel, use_weight_norm=use_weight_norm, **kw)
        self.conv_last = _placeholders(4, {
            1: Conv1d(skip_channels, skip_channels, 1, **wn),
            3: Conv1d(skip_channels, out_channels, 1, **wn)})

    def fold_weight_norm_(self):
        """Fold every conv's weight norm in place (reference remove_weight_norm)."""
        for m in self.modules():
            if isinstance(m, (Conv1d, TimeConv2d)):
                m.fold_weight_norm_()
        return self

    def _conv_last(self, x):
        x = self.conv_last[1](torch.relu(x))
        return self.conv_last[3](torch.relu(x))

    def forward(self, x, c, d):
        """x (B, T, 2) sine | noise excitation, c (B, T' + 2 acw, aux)
        features, d (B, T) f32 dilation factors -> (waveform (B, T, out),
        source (B, T, out))."""
        c = self.upsample_net(c)
        a = self.periodicity_estimator(c)
        h = self.harmonic_network(self.conv_first_sine(x[..., :1]), c, d)
        n = self.noise_network(self.conv_first_noise(x[..., 1:]), c, d)
        s = a * h + (1.0 - a) * n
        out = self.filter_network(s, c, d)
        return self._conv_last(out), self._conv_last(s)
