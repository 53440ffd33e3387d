"""x-vector speaker embedding extractor (TDNN).

Counterpart of `svcc23_fastsvc_tpu/models/xvector.py`: 24-mel log-fbank
(25 ms / 10 ms, zero-padded frames) -> sentence mean normalisation -> 5
TDNN blocks (dilated Conv1d with reflect "same" padding, ReLU, batch norm)
-> statistics pooling (mean and population std) -> 512-d linear
embedding. The modules keep SpeechBrain's Xvector tree, so its
`embedding_model.ckpt` keys load as they are: `blocks.{3i}.conv` (Conv1d),
`blocks.{3i+2}.norm` (BatchNorm1d), `blocks.15` the pooling and
`blocks.16.w` (Linear). Inference only: batch norm always uses its
running statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import mel_filterbank, stft_magnitude
from ..train.checkpoint import _device
from .conformer_ppg import _batch_norm_eval, load_reference_state


def fbank_features(wav, *, sr: int = 16000, n_mels: int = 24,
                   win: int = 400, hop: int = 160, n_fft: int = 400):
    """(B, T) -> (B, F, n_mels) log-mel filterbank (SpeechBrain-style)."""
    power = stft_magnitude(wav, n_fft, hop, win, pad_mode="constant",
                           power=True, clamp_min=0.0)
    mel = power @ mel_filterbank(sr, n_fft, n_mels, dtype=power.dtype,
                                 device=power.device)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def sentence_norm(x):
    """Per-utterance mean normalisation over frames (SpeechBrain
    InputNormalization, norm_type "sentence", std off)."""
    return x - x.mean(dim=1, keepdim=True)


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, d: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, dilation=d)


class _Norm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = nn.BatchNorm1d(c)


class _Linear(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w = nn.Linear(din, dout)


class StatisticsPooling(nn.Module):
    """(B, C, T) -> (B, 2C): mean and population std (ddof 0) over T."""

    def forward(self, h):
        mean = h.mean(dim=-1)
        std = torch.std(h, dim=-1, correction=0)
        return torch.cat([mean, std], dim=-1)


class XVector(nn.Module):
    def __init__(self, in_dim: int = 24,
                 tdnn_channels: Sequence[int] = (512, 512, 512, 512, 1500),
                 tdnn_kernels: Sequence[int] = (5, 3, 3, 1, 1),
                 tdnn_dilations: Sequence[int] = (1, 2, 3, 1, 1),
                 emb_dim: int = 512):
        super().__init__()
        blocks, cin = [], in_dim
        for c, k, d in zip(tdnn_channels, tdnn_kernels, tdnn_dilations):
            blocks += [_Conv(cin, c, k, d), nn.ReLU(), _Norm(c)]
            cin = c
        blocks += [StatisticsPooling(), _Linear(2 * cin, emb_dim)]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, feats):
        """(B, F, in_dim) normalised fbanks -> (B, emb_dim): JAX
        `XVector.apply`."""
        h = feats.transpose(1, 2)  # (B, C, F)
        for i in range(0, len(self.blocks) - 2, 3):
            conv = self.blocks[i].conv
            pad = (conv.kernel_size[0] - 1) // 2 * conv.dilation[0]
            if pad:  # SpeechBrain's "same" padding reflects
                h = F.pad(h, (pad, pad), mode="reflect")
            h = torch.relu(conv(h))
            h = _batch_norm_eval(self.blocks[i + 2].norm, h)
        return self.blocks[-1].w(self.blocks[-2](h))

    def encode(self, wav):
        """(T,) or (B, T) waveform at 16 kHz -> (B, emb_dim)."""
        if wav.dim() == 1:
            wav = wav[None]
        return self(sentence_norm(fbank_features(wav)))


def load_xvector_model(checkpoint_path: str, *, device="cuda") -> XVector:
    """A SpeechBrain `embedding_model.ckpt` state dict -> XVector in eval
    mode on `device` (cuda raises without a CUDA device)."""
    device = _device(device)
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    model = load_reference_state(XVector(), sd)
    return model.to(device).eval()
