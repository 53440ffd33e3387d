"""FastSVC generator (paper Fig. 3-4), the MelGAN multi-scale discriminator
and the HiFiGAN multi-scale + multi-period discriminator.

Counterpart of `svcc23_fastsvc_tpu/models/fastsvc.py::FastSVCGenerator`,
`MelGANMultiScaleDiscriminator` and `HiFiGANMultiScaleMultiPeriod
Discriminator` as `nn.Module`s. Public tensors are
channels-last (B, T, C), as in the JAX package. Parameters keep the
reference torch module tree and state-dict keys (the ones
`svcc23_fastsvc_tpu/compat/torch_weights.py::convert_fastsvc_generator`
and `convert_melgan_msd` read), with torch Conv1d layout (O, I, K) and
weight norm stored as `weight_g` (O, 1, 1) / `weight_v`. Where the reference
wraps a conv in an `nn.Sequential` of parameter-free layers (activation,
resampling), an `nn.ModuleList` with `nn.Identity` placeholders keeps the
conv at the same index, so the keys line up; `forward` calls the convs
directly.

Like the JAX model, the downsampling chains run once per forward and keep
every tap, and `_film_pair` fuses the sine and loudness FiLM output convs
into one (K, 2C, 2C) conv for inference. With the down-chain mode on
(`ops.down_chain.set_down_chain_mode("1")`, default "0") and grad off, each
DownsampleBlock runs as one `down_chain_fwd` kernel in place of its three
window convs and residual matmul. Training runs the unfused forward
with weight norm live: `Conv1d.wio()` builds the effective weight from
`weight_g`/`weight_v` inside the graph, so their gradients come back in the
parameters' own (O, I, K) layout.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.conv import (
    avg_pool1d,
    conv1d,
    conv2d,
    conv_weight,
    instance_norm,
    l2_normalize,
    leaky_relu,
    linear,
    reflect_pad1d,
)
from ..ops.down_chain import down_chain_fwd, down_chain_mode, down_chain_takes
from ..ops.resample import nearest_downsample, nearest_upsample


def _uniform(shape, bound, device, generator):
    t = torch.empty(shape, device=device)
    return t.uniform_(-bound, bound, generator=generator)


class Conv1d(nn.Module):
    """Conv parameters in torch layout (O, I/groups, K), optionally
    weight-normed.

    Initialised as torch.nn.Conv1d (uniform, bound 1/sqrt(K*C_in/groups));
    weight norm starts at g = ||v|| per output channel, as torch weight_norm
    does.
    """

    def __init__(self, in_channels, out_channels, kernel_size, *, groups=1,
                 bias=True, weight_norm=True, device=None, generator=None):
        super().__init__()
        in_pg = in_channels // groups
        bound = 1.0 / math.sqrt(kernel_size * in_pg)
        w = _uniform((out_channels, in_pg, kernel_size), bound, device,
                     generator)
        if weight_norm:
            self.weight_g = nn.Parameter(
                torch.sqrt(torch.sum(w * w, dim=(1, 2), keepdim=True)))
            self.weight_v = nn.Parameter(w)
        else:
            self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(_uniform((out_channels,), bound, device,
                                           generator))
                     if bias else None)
        self.kernel_size = kernel_size
        self.groups = groups

    def wio(self):
        """Effective weight as a WIO (K, C_in, C_out) view."""
        if self.folded:
            return self.weight.permute(2, 1, 0)
        return conv_weight({"v": self.weight_v.permute(2, 1, 0),
                            "g": self.weight_g.reshape(-1)})

    @property
    def folded(self) -> bool:
        return "weight" in self._parameters

    def fold_weight_norm_(self):
        """Replace weight_g/weight_v by the folded `weight` (remove_weight_norm)."""
        if self.folded:
            return
        with torch.no_grad():
            w = self.wio().permute(2, 1, 0).contiguous()
        del self.weight_g, self.weight_v
        self.weight = nn.Parameter(w)

    def forward(self, x, *, dilation: int = 1, input_leaky=None, stride=1,
                padding=None):
        """padding None is "same" padding (K-1)/2 * dilation."""
        if padding is None:
            padding = (self.kernel_size - 1) // 2 * dilation
        return conv1d(x, self.wio(), self.bias, stride=stride,
                      padding=padding, dilation=dilation, groups=self.groups,
                      input_leaky=input_leaky)


class Linear(nn.Module):
    """torch.nn.Linear parameters (weight (O, I)), default init."""

    def __init__(self, in_features, out_features, *, device=None,
                 generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(
            _uniform((out_features, in_features), bound, device, generator))
        self.bias = nn.Parameter(
            _uniform((out_features,), bound, device, generator))

    def forward(self, x):
        return linear(x, {"w": self.weight.t(), "b": self.bias})


def _placeholders(n, modules: dict):
    """ModuleList of n entries: `modules[i]` at index i, nn.Identity elsewhere."""
    return nn.ModuleList([modules.get(i, nn.Identity()) for i in range(n)])


class UpsampleBlock(nn.Module):
    """FastSVC upsampling block (Fig. 4a)."""

    def __init__(self, in_channels, mid_channels, scale, spk_emb_size=512,
                 use_spk_emb=True, use_weight_norm=True, *, device=None,
                 generator=None):
        super().__init__()
        C = mid_channels
        kw = dict(weight_norm=use_weight_norm, device=device,
                  generator=generator)
        self.scale = scale
        self.conv_first = Conv1d(in_channels, C, 3, **kw)
        self.upsample_block0 = _placeholders(3, {2: Conv1d(C, C, 3, **kw)})
        self.conv_block1 = _placeholders(2, {1: Conv1d(C, C, 3, **kw)})
        self.conv_block2 = _placeholders(2, {1: Conv1d(C, C, 3, **kw)})
        self.conv_block3 = _placeholders(2, {1: Conv1d(C, C, 3, **kw)})
        self.residual_block = _placeholders(2, {1: Conv1d(C, C, 3, **kw)})
        self.emb_projector = (
            Linear(spk_emb_size, C, device=device, generator=generator)
            if use_spk_emb else None
        )

    @staticmethod
    def _affine(x, film, lft, proj):
        if lft is None:  # pre-summed (scale, shift) from _film_pair
            scale, shift = film
        else:
            scale = film[0] + lft[0]
            shift = film[1] + lft[1]
        x = scale * x + shift
        if proj is not None:
            x = instance_norm(x, axis=1) + proj[:, None, :]
        return x

    def forward(self, x, film, lft=None, spk_emb=None):
        """x: (B, T, C_in); film/lft: (scale, shift) pairs at (B, T*s, C),
        or lft=None with film holding the pre-summed pair."""
        proj = None
        if spk_emb is not None and self.emb_projector is not None:
            proj = self.emb_projector(l2_normalize(spk_emb, axis=-1))
        x = self.conv_first(x)
        xu = nearest_upsample(x, self.scale)
        xr = self.residual_block[1](xu)
        # leaky_relu commutes with nearest upsampling, so it fuses into
        # up_conv's input as in the JAX model
        h = leaky_relu(self.upsample_block0[2](xu, input_leaky=0.2))
        h = self._affine(h, film, lft, proj)
        h = self.conv_block1[1](h, dilation=3, input_leaky=0.2)
        x_ = h + xr
        h = self._affine(x_, film, lft, proj)
        h = self.conv_block2[1](h, dilation=9, input_leaky=0.2)
        h = self._affine(h, film, lft, proj)
        h = self.conv_block3[1](h, dilation=27, input_leaky=0.2)
        return h + x_


class DownsampleBlock(nn.Module):
    """FastSVC downsampling block (Fig. 4b)."""

    def __init__(self, in_channels, mid_channels, scale, use_weight_norm=True,
                 *, device=None, generator=None):
        super().__init__()
        C = mid_channels
        kw = dict(weight_norm=use_weight_norm, device=device,
                  generator=generator)
        self.scale = scale
        self.in_channels, self.mid_channels = in_channels, C
        self.residual_block = nn.ModuleList([Conv1d(in_channels, C, 1, **kw)])
        self.downsample_block = _placeholders(7, {
            2: Conv1d(in_channels, C, 3, **kw),
            4: Conv1d(C, C, 3, **kw),
            6: Conv1d(C, C, 3, **kw),
        })

    def block_params(self):
        """The JAX layout {"conv1", "conv2", "conv3", "res_conv"}, each
        {"w": WIO view, "b"}, on the effective weights (folded or live)."""
        convs = {"conv1": self.downsample_block[2],
                 "conv2": self.downsample_block[4],
                 "conv3": self.downsample_block[6],
                 "res_conv": self.residual_block[0]}
        return {k: {"w": m.wio(), "b": m.bias} for k, m in convs.items()}

    def forward(self, x):
        # the 1x1 residual conv commutes with the nearest downsample, so both
        # paths share one downsampled input (JAX model, same numerics)
        xd = nearest_downsample(x, self.scale)
        if (down_chain_mode() == "1" and not torch.is_grad_enabled()
                and down_chain_takes(self.in_channels, self.mid_channels)):
            # the fused forward (ops/down_chain.py); it takes no strided view
            return down_chain_fwd(xd.contiguous(), self.block_params())
        return self.unfused(xd)

    def unfused(self, xd):
        """The block on its downsampled input as three window convs and the
        residual matmul (what `down_chain_fwd` replaces)."""
        r = self.residual_block[0](xd)
        h = self.downsample_block[2](xd, dilation=1, input_leaky=0.2)
        h = self.downsample_block[4](h, dilation=2, input_leaky=0.2)
        h = self.downsample_block[6](h, dilation=4, input_leaky=0.2)
        return h + r


class FiLMBlock(nn.Module):
    """FastSVC FiLM block (Fig. 4c)."""

    def __init__(self, channels, use_weight_norm=True, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(weight_norm=use_weight_norm, device=device,
                  generator=generator)
        self.conv = Conv1d(channels, channels, 3, **kw)
        self.conv_scale = Conv1d(channels, channels, 3, **kw)
        self.conv_shift = Conv1d(channels, channels, 3, **kw)

    def forward(self, x):
        h = leaky_relu(self.conv(x))
        return self.conv_scale(h), self.conv_shift(h)


def _film_pair(film_sine: FiLMBlock, film_lft: FiLMBlock, x_sine, x_lft):
    """Sine and loudness FiLM nets evaluated with one fused output conv.

    The consumer only uses s_scale + l_scale and s_shift + l_shift, so the
    four output convs collapse into one conv over the concatenated hidden
    states with a (K, 2C, 2C) block weight.
    """
    hs = leaky_relu(film_sine.conv(x_sine))
    hl = leaky_relu(film_lft.conv(x_lft))
    w_s = torch.cat([film_sine.conv_scale.wio(), film_sine.conv_shift.wio()],
                    dim=-1)
    w_l = torch.cat([film_lft.conv_scale.wio(), film_lft.conv_shift.wio()],
                    dim=-1)
    w = torch.cat([w_s, w_l], dim=1)
    b = torch.cat([
        film_sine.conv_scale.bias + film_lft.conv_scale.bias,
        film_sine.conv_shift.bias + film_lft.conv_shift.bias,
    ])
    both = conv1d(torch.cat([hs, hl], dim=-1), w, b, padding=1)
    C = w_s.shape[1]
    return both[..., :C], both[..., C:]


class FastSVCGenerator(nn.Module):
    """FastSVC waveform generator.

    PPG frames (B, T', in_channels) + sample-rate sine and loudness
    (B, T'*hop, 1) + speaker embedding (B, spk_emb_size) -> waveform
    (B, T'*hop, out_channels), hop = prod(upsampling_scales).
    """

    def __init__(self, in_channels: int = 144,
                 mid_channels: Sequence[int] = (192, 96, 48, 24),
                 upsampling_scales: Sequence[int] = (2, 4, 4, 5),
                 out_channels: int = 1, spk_emb_size: int = 512,
                 use_spk_emb: bool = True, use_weight_norm: bool = True,
                 *, device=None, generator=None):
        super().__init__()
        self.mid_channels = tuple(mid_channels)
        self.upsampling_scales = tuple(upsampling_scales)
        kw = dict(device=device, generator=generator)
        ups, c_in = [], in_channels
        for scale, c in zip(self.upsampling_scales, self.mid_channels):
            ups.append(UpsampleBlock(c_in, c, scale, spk_emb_size,
                                     use_spk_emb, use_weight_norm, **kw))
            c_in = c
        self.upsampling_nets = nn.ModuleList(ups)
        # scales: reversed upsampling scales, last dropped, 1 prepended
        down_scales = [1] + list(self.upsampling_scales[::-1][:-1])

        def chain():
            blocks, c_in = [], 1
            for scale, c in zip(down_scales, self.mid_channels[::-1]):
                blocks.append(DownsampleBlock(c_in, c, scale,
                                              use_weight_norm, **kw))
                c_in = c
            return nn.ModuleList(blocks)

        self.downsampling_lft = chain()
        self.downsampling_sine = chain()
        self.film_lft = nn.ModuleList(
            FiLMBlock(c, use_weight_norm, **kw) for c in self.mid_channels[::-1])
        self.film_sine = nn.ModuleList(
            FiLMBlock(c, use_weight_norm, **kw) for c in self.mid_channels[::-1])
        self.conv_last = Conv1d(self.mid_channels[-1], out_channels, 1,
                                weight_norm=use_weight_norm, **kw)

    @property
    def hop_size(self) -> int:
        return math.prod(self.upsampling_scales)

    def fold_weight_norm_(self):
        """Fold every conv's weight norm in place (reference remove_weight_norm)."""
        for m in self.modules():
            if isinstance(m, Conv1d):
                m.fold_weight_norm_()
        return self

    def forward(self, ppg, sine, lft, spk_emb=None, *, fuse_film: bool = False,
                f32_out: bool = False):
        """ppg (B, T', C_in), sine/lft (B, T, 1), spk_emb (B, S) or None
        -> (B, T, out_channels). `fuse_film` evaluates the FiLM output convs
        fused (_film_pair), as inference does; numerics are the same.
        `f32_out` returns the last conv's f32 sums, unrounded, for a
        bf16 forward whose output feeds f32 losses: XLA keeps them so in
        the JAX step (its `.astype(f32)` of the bf16 output is elided), and
        a rounded output roughly triples the bf16 gradient's distance from
        f32 through the log-STFT loss."""
        lft_taps, h = [], lft
        for blk in self.downsampling_lft:
            h = blk(h)
            lft_taps.append(h)
        sine_taps, h = [], sine
        for blk in self.downsampling_sine:
            h = blk(h)
            sine_taps.append(h)

        x = ppg
        n = len(self.upsampling_scales)
        for idx, blk in enumerate(self.upsampling_nets):
            d = n - idx - 1
            if fuse_film:
                film, lpair = _film_pair(self.film_sine[d], self.film_lft[d],
                                         sine_taps[d], lft_taps[d]), None
            else:
                film = self.film_sine[d](sine_taps[d])
                lpair = self.film_lft[d](lft_taps[d])
            x = blk(x, film, lpair, spk_emb)
        if f32_out and x.dtype in (torch.bfloat16, torch.float16):
            # bf16 products are exact in f32: the same sums, not rounded
            last = self.conv_last
            return conv1d(x.float(), last.wio().float(),
                          None if last.bias is None else last.bias.float(),
                          padding=0)
        return self.conv_last(x)

    def inference(self, ppg, f0, lft, signal_generator, spk_emb=None,
                  generator=None):
        """Single or batched utterance inference with the fused FiLM path.

        ppg (T', C) or (B, T', C); f0 (.., T', 1) frame rate; lft (.., T, 1)
        sample rate.
        """
        squeeze = ppg.dim() == 2
        if squeeze:
            ppg, f0, lft = ppg[None], f0[None], lft[None]
            if spk_emb is not None and spk_emb.dim() == 1:
                spk_emb = spk_emb[None]
        sine = signal_generator(f0, generator)
        out = self(ppg, sine, lft, spk_emb, fuse_film=True)
        return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# MelGAN multi-scale discriminator (JAX package models/fastsvc.py:395-536).
# ---------------------------------------------------------------------------


class MelGANDiscriminator(nn.Module):
    """Single-scale MelGAN discriminator.

    Reference module tree: `layers.0` = (ReflectionPad1d, Conv1d, LeakyReLU),
    `layers.j` = (Conv1d, LeakyReLU) for the strided grouped convs and the
    K0 conv, the last layer a bare Conv1d; the placeholders keep each conv
    at its reference index.
    """

    def __init__(self, in_channels=1, out_channels=1, kernel_sizes=(5, 3),
                 channels=16, max_downsample_channels=1024,
                 downsample_scales=(4, 4, 4, 4), negative_slope=0.2,
                 use_weight_norm=True, *, device=None, generator=None):
        super().__init__()
        k0, k1 = kernel_sizes
        kw = dict(weight_norm=use_weight_norm, device=device,
                  generator=generator)
        self.negative_slope = negative_slope
        # (stride, padding, reflect padding) of each conv, in order
        self.specs = [(1, 0, (k0 * k1 - 1) // 2)]
        layers = [_placeholders(3, {1: Conv1d(in_channels, channels,
                                              k0 * k1, **kw)})]
        in_chs = channels
        for s in downsample_scales:
            out_chs = min(in_chs * s, max_downsample_channels)
            layers.append(_placeholders(2, {0: Conv1d(
                in_chs, out_chs, s * 10 + 1, groups=in_chs // 4, **kw)}))
            self.specs.append((s, s * 5, 0))
            in_chs = out_chs
        out_chs = min(in_chs * 2, max_downsample_channels)
        layers.append(_placeholders(2, {0: Conv1d(in_chs, out_chs, k0, **kw)}))
        self.specs.append((1, (k0 - 1) // 2, 0))
        layers.append(Conv1d(out_chs, out_channels, k1, **kw))
        self.specs.append((1, (k1 - 1) // 2, 0))
        self.layers = nn.ModuleList(layers)

    def convs(self):
        last = len(self.layers) - 1
        for j, layer in enumerate(self.layers):
            yield layer if j == last else layer[1 if j == 0 else 0]

    def forward(self, x):
        """x (B, T, 1) -> list of every layer's output (the last: logits)."""
        outs = []
        n = len(self.specs)
        for i, (conv, (stride, pad, reflect)) in enumerate(
                zip(self.convs(), self.specs)):
            if reflect:
                x = reflect_pad1d(x, reflect)
            x = conv(x, stride=stride, padding=pad)
            if i < n - 1:  # the final layer has no activation
                x = leaky_relu(x, self.negative_slope)
            outs.append(x)
        return outs


class MelGANMultiScaleDiscriminator(nn.Module):
    """MelGAN discriminators on the signal and its 2x, 4x, ... average-pooled
    versions (AvgPool1d with count_include_pad=False between scales)."""

    def __init__(self, in_channels=1, out_channels=1, scales=3,
                 kernel_sizes=(5, 3), channels=16,
                 max_downsample_channels=1024, downsample_scales=(4, 4, 4, 4),
                 pooling_kernel=4, pooling_stride=2, pooling_padding=1,
                 negative_slope=0.2, use_weight_norm=True, *, device=None,
                 generator=None):
        super().__init__()
        self.pooling = (pooling_kernel, pooling_stride, pooling_padding)
        self.discriminators = nn.ModuleList(
            MelGANDiscriminator(
                in_channels, out_channels, tuple(kernel_sizes), channels,
                max_downsample_channels, tuple(downsample_scales),
                negative_slope, use_weight_norm, device=device,
                generator=generator)
            for _ in range(scales))

    @classmethod
    def from_config(cls, params: dict, **kw):
        """Build from the recipe's `discriminator_params`."""
        pool = params.get("downsample_pooling_params", {})
        act = params.get("nonlinear_activation_params", {})
        return cls(
            in_channels=params.get("in_channels", 1),
            out_channels=params.get("out_channels", 1),
            scales=params.get("scales", 3),
            kernel_sizes=tuple(params.get("kernel_sizes", (5, 3))),
            channels=params.get("channels", 16),
            max_downsample_channels=params.get("max_downsample_channels",
                                               1024),
            downsample_scales=tuple(params.get("downsample_scales",
                                               (4, 4, 4, 4))),
            pooling_kernel=pool.get("kernel_size", 4),
            pooling_stride=pool.get("stride", 2),
            pooling_padding=pool.get("padding", 1),
            negative_slope=act.get("negative_slope", 0.2),
            use_weight_norm=params.get("use_weight_norm", True),
            **kw,
        )

    def forward(self, x):
        """x (B, T, 1) -> per scale, the list of its layers' outputs."""
        outs = []
        for d in self.discriminators:
            outs.append(d(x))
            x = avg_pool1d(x, *self.pooling, count_include_pad=False)
        return outs


# ---------------------------------------------------------------------------
# HiFiGAN discriminators (reference fastsvc.py:631-1143)
# ---------------------------------------------------------------------------


class Conv2d(nn.Module):
    """Conv2d parameters in torch layout (O, I, kh, kw), optionally
    weight-normed (`weight_g` (O, 1, 1, 1), `weight_v`), initialised as
    torch.nn.Conv2d (uniform, bound 1/sqrt(kh*kw*C_in))."""

    def __init__(self, in_channels, out_channels, kernel_size, *,
                 weight_norm=True, device=None, generator=None):
        super().__init__()
        kh, kw = kernel_size
        bound = 1.0 / math.sqrt(kh * kw * in_channels)
        w = _uniform((out_channels, in_channels, kh, kw), bound, device,
                     generator)
        if weight_norm:
            self.weight_g = nn.Parameter(
                torch.sqrt(torch.sum(w * w, dim=(1, 2, 3), keepdim=True)))
            self.weight_v = nn.Parameter(w)
        else:
            self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(_uniform((out_channels,), bound, device,
                                          generator))

    def hwio(self):
        """Effective weight as an HWIO (kh, kw, C_in, C_out) view."""
        if "weight" in self._parameters:
            return self.weight.permute(2, 3, 1, 0)
        return conv_weight({"v": self.weight_v.permute(2, 3, 1, 0),
                            "g": self.weight_g.reshape(-1)})

    def forward(self, x, *, stride=1, padding=0):
        """NHWC x -> NHWC, through `ops.conv.conv2d` (cuDNN on the card)."""
        return conv2d(x, self.hwio(), self.bias, stride=stride,
                      padding=padding)


class HiFiGANPeriodDiscriminator(nn.Module):
    """HiFiGAN period discriminator (reference fastsvc.py:631-759): the
    signal reflect-padded to a multiple of `period`, folded to (T/P, P) and
    scored by (k0, 1) convs strided along T, then a (k1 - 1, 1) output
    conv. Weight-normed by default. Keys: `convs.{j}.0`, `output_conv`."""

    def __init__(self, in_channels=1, out_channels=1, period=3,
                 kernel_sizes=(5, 3), channels=32,
                 downsample_scales=(3, 3, 3, 3, 1),
                 max_downsample_channels=1024, negative_slope=0.1,
                 use_weight_norm=True, *, device=None, generator=None):
        super().__init__()
        k0, k1 = kernel_sizes
        kw = dict(weight_norm=use_weight_norm, device=device,
                  generator=generator)
        self.period, self.kernel_sizes = period, (k0, k1)
        self.negative_slope = negative_slope
        self.strides = tuple(downsample_scales)
        convs, in_chs, out_chs = [], in_channels, channels
        for _ in downsample_scales:
            # the reference's (Conv2d, LeakyReLU) Sequential
            convs.append(_placeholders(2, {0: Conv2d(in_chs, out_chs,
                                                     (k0, 1), **kw)}))
            in_chs = out_chs
            out_chs = min(out_chs * 4, max_downsample_channels)
        self.convs = nn.ModuleList(convs)
        self.output_conv = Conv2d(in_chs, out_channels, (k1 - 1, 1), **kw)

    def forward(self, x, return_fmaps: bool = False):
        """x (B, T, C) -> logits (B, N) [, the layers' activations]."""
        B, T, C = x.shape
        if T % self.period:
            x = reflect_pad1d(x, (0, self.period - T % self.period))
            T = x.shape[1]
        x = x.reshape(B, T // self.period, self.period, C)
        k0, k1 = self.kernel_sizes
        fmaps = []
        for (conv, _), s in zip(self.convs, self.strides):
            x = leaky_relu(conv(x, stride=(s, 1),
                                padding=((k0 - 1) // 2, 0)),
                           self.negative_slope)
            fmaps.append(x)
        out = self.output_conv(x, padding=((k1 - 1) // 2, 0)).reshape(B, -1)
        return (out, fmaps) if return_fmaps else out


class HiFiGANScaleDiscriminator(nn.Module):
    """HiFiGAN scale discriminator (reference fastsvc.py:818-975): a K0
    conv, grouped strided K1 convs, a K2 conv and a K3 output conv, all
    zero "same" padded. The reference's weight norm tests
    `isinstance(m, nn.Conv2d)` on Conv1d layers and never applies, so these
    convs are plain, as in the JAX model. Keys: `layers.{j}.0`,
    `last_layer`."""

    def __init__(self, in_channels=1, out_channels=1,
                 kernel_sizes=(15, 41, 5, 3), channels=128,
                 max_downsample_channels=1024, max_groups=16,
                 downsample_scales=(2, 2, 4, 4, 1), negative_slope=0.1, *,
                 device=None, generator=None):
        super().__init__()
        k = kernel_sizes
        # (K, C_in, C_out, stride, groups) of each conv, the JAX model's
        defs = [(k[0], in_channels, channels, 1, 1)]
        in_chs = out_chs = channels
        groups = 4
        for s in downsample_scales:
            defs.append((k[1], in_chs, out_chs, s, groups))
            in_chs = out_chs
            out_chs = min(in_chs * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        out_chs = min(in_chs * 2, max_downsample_channels)
        defs.append((k[2], in_chs, out_chs, 1, 1))
        defs.append((k[3], out_chs, out_channels, 1, 1))
        self.specs = [(kk, s) for kk, _, _, s, _ in defs]
        self.negative_slope = negative_slope

        def conv(kk, cin, cout, s, g):
            return Conv1d(cin, cout, kk, groups=g, weight_norm=False,
                          device=device, generator=generator)

        self.layers = nn.ModuleList(
            _placeholders(2, {0: conv(*d)}) for d in defs[:-1])
        self.last_layer = conv(*defs[-1])

    def forward(self, x, return_fmaps: bool = False):
        """x (B, T, C) -> logits (B, T', out_channels) [, activations]."""
        fmaps = []
        for (conv, _), (kk, s) in zip(self.layers, self.specs):
            x = leaky_relu(conv(x, stride=s, padding=(kk - 1) // 2),
                           self.negative_slope)
            fmaps.append(x)
        kk, _ = self.specs[-1]
        x = self.last_layer(x, padding=(kk - 1) // 2)
        return (x, fmaps) if return_fmaps else x


def _sub_params(params: dict, *, keep_weight_norm: bool) -> dict:
    """A sub-discriminator's keyword arguments from the reference config:
    the activation's slope kept, the options the models have no use for
    dropped (as the JAX model's `_scale_sub` / `_period_sub` drop them)."""
    p = dict(params)
    act = p.pop("nonlinear_activation_params", {})
    for key in ("bias", "nonlinear_activation", "use_spectral_norm"):
        p.pop(key, None)
    if not keep_weight_norm:
        p.pop("use_weight_norm", None)
    for key in ("kernel_sizes", "downsample_scales"):
        if key in p:
            p[key] = tuple(p[key])
    p["negative_slope"] = act.get("negative_slope", 0.1)
    return p


class HiFiGANMultiScaleMultiPeriodDiscriminator(nn.Module):
    """HiFiGAN MSD + MPD (reference fastsvc.py:1055-1143): scale
    discriminators on the signal and its average-pooled versions
    (AvgPool1d with count_include_pad, between scales), then one period
    discriminator per period. Output: a flat list of logits, MSD first
    (with `return_fmaps`, also the flat list of every activation)."""

    def __init__(self, scales=3, pooling_kernel=4, pooling_stride=2,
                 pooling_padding=2, periods=(2, 3, 5, 7, 11),
                 scale_params=None, period_params=None, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.pooling = (pooling_kernel, pooling_stride, pooling_padding)
        self.msd = nn.Module()
        self.msd.discriminators = nn.ModuleList(
            HiFiGANScaleDiscriminator(**_sub_params(
                scale_params or {}, keep_weight_norm=False), **kw)
            for _ in range(scales))
        self.mpd = nn.Module()
        self.mpd.discriminators = nn.ModuleList(
            HiFiGANPeriodDiscriminator(period=p, **_sub_params(
                period_params or {}, keep_weight_norm=True), **kw)
            for p in periods)

    @classmethod
    def from_config(cls, params: dict, **kw):
        """Build from the recipe's `discriminator_params`, with the JAX
        model's `from_config` defaults."""
        pool = params.get("scale_downsample_pooling_params", {})
        return cls(
            scales=params.get("scales", 3),
            pooling_kernel=pool.get("kernel_size", 4),
            pooling_stride=pool.get("stride", 2),
            pooling_padding=pool.get("padding", 2),
            periods=tuple(params.get("periods", (2, 3, 5, 7, 11))),
            scale_params=params.get("scale_discriminator_params", {}),
            period_params=params.get("period_discriminator_params", {}),
            **kw)

    def forward(self, x, return_fmaps: bool = False):
        outs, fmaps = [], []
        h = x
        for d in self.msd.discriminators:
            out, f = d(h, return_fmaps=True)
            outs.append(out)
            fmaps.extend(f)
            h = avg_pool1d(h, *self.pooling)
        for d in self.mpd.discriminators:
            out, f = d(x, return_fmaps=True)
            outs.append(out)
            fmaps.extend(f)
        return (outs, fmaps) if return_fmaps else outs
