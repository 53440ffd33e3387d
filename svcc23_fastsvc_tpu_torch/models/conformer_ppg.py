"""Frozen conformer PPG extractor (144-d phonetic posteriorgrams at 10 ms).

Counterpart of `svcc23_fastsvc_tpu/models/conformer_ppg.py`: STFT ->
log-mel 80 -> utterance MVN -> Conv2dNoSubsampling embed -> 16 macaron
conformer blocks (attention_dim 144, 4 heads, rel-pos attention, conv
module k 15) -> layer norm. The modules keep the reference espnet module
tree, so their state-dict keys are the reference checkpoint's
("encoder.embed.conv.0.weight", "encoder.encoders.3.self_attn.linear_pos.
weight", ...) and a reference `24epoch.pth` loads with `load_state_dict`
(`load_ppg_model`). Inference only: batch norm always uses its running
statistics. On the card the STFT runs on cuFFT and the matmuls and convs
on cuBLAS and cuDNN; attention is explicit `torch.matmul` plus espnet's
rel shift, as in the JAX package (no Pallas kernel there).

The reference quirks the released checkpoint expects are kept:
  * the frontend STFT has a rectangular window of win_length ones,
    zero-padded centred to n_fft, with reflect padding;
  * utterance MVN divides by sqrt(std), i.e. var ** 0.25;
  * layer norm eps is 1e-12 (espnet), not torch's 1e-5;
  * the rel-pos table is the legacy reversed one, pos_emb[t] = PE(L-1-t),
    L = max(5000, T), built in f64.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import mel_filterbank, stft_magnitude
from ..train.checkpoint import _device


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------


def frontend_logmel(speech, *, fs: int = 16000, n_fft: int = 1024,
                    win_length: int = 800, hop_length: int = 160,
                    n_mels: int = 80):
    """(T,) or (B, T) speech -> (B, T', n_mels) log-mel with the
    reference's rectangular-window STFT and librosa-0.8.1 slaney mel."""
    if speech.dim() == 1:
        speech = speech[None]
    window = torch.ones(win_length, dtype=speech.dtype, device=speech.device)
    power = stft_magnitude(speech, n_fft, hop_length, win_length,
                           window=window, power=True, clamp_min=0.0)
    mel = power @ mel_filterbank(fs, n_fft, n_mels, norm="slaney",
                                 dtype=power.dtype, device=power.device)
    return torch.log(mel + 1e-20)


def utterance_mvn(x, *, norm_means=True, norm_vars=True, eps=1e-20):
    """(B, T, D) per-utterance normalisation with the var ** 0.25 quirk."""
    mean = x.mean(dim=1, keepdim=True)
    if norm_means:
        x = x - mean
        if norm_vars:
            var = (x * x).mean(dim=1, keepdim=True)
            std = torch.clamp(torch.sqrt(var), min=eps)
            x = x / torch.sqrt(std)  # sic: the reference divides by sqrt(std)
        return x
    if norm_vars:
        y = x - mean
        var = (y * y).mean(dim=1, keepdim=True)
        x = x / torch.clamp(torch.sqrt(var), min=eps)
    return x


# ---------------------------------------------------------------------------
# conformer pieces
# ---------------------------------------------------------------------------


def layer_norm(d: int) -> nn.LayerNorm:
    """espnet's LayerNorm: torch's with eps 1e-12."""
    return nn.LayerNorm(d, eps=1e-12)


def swish(x):
    return x * torch.sigmoid(x)


def rel_positional_encoding(T: int, d_model: int, dtype=torch.float32,
                            device=None):
    """(1, T, d_model): the legacy reversed table, built in f64 and sliced
    to T."""
    pe = _reversed_table(max(5000, T), d_model)
    return torch.tensor(pe[None, :T], dtype=dtype, device=device)


@lru_cache(maxsize=8)
def _reversed_table(L: int, d_model: int) -> np.ndarray:
    """pe[t] = PE(L - 1 - t) in f64, built once per (L, d_model) (tens of
    ms of numpy at L 5000) and read-only."""
    position = np.arange(L - 1, -1, -1.0, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((L, d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    pe.setflags(write=False)
    return pe


def _rel_shift(x):
    """espnet's legacy rel_shift: pad a zero column, then reshape so that
    each row rolls left by its index."""
    b, h, t1, t2 = x.shape
    x_padded = torch.cat([x.new_zeros(b, h, t1, 1), x], dim=-1)
    x_padded = x_padded.view(b, h, t2 + 1, t1)
    return x_padded[:, :, 1:].reshape(b, h, t1, t2)


class RelPositionMultiHeadedAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int):
        super().__init__()
        self.h, self.d_k = n_head, d_model // n_head
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(self.h, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(self.h, self.d_k))

    def forward(self, x, pos_emb, mask=None):
        """x (B, T, D), pos_emb (1, T, D), mask (B, T) True on frames."""
        B, T, D = x.shape

        def heads(t):  # (b, T, D) -> (b, h, T, d_k)
            return t.view(t.shape[0], -1, self.h, self.d_k).transpose(1, 2)

        q = heads(self.linear_q(x))
        k = heads(self.linear_k(x))
        v = heads(self.linear_v(x))
        p = heads(self.linear_pos(pos_emb))
        q_u = q + self.pos_bias_u[None, :, None, :]
        q_v = q + self.pos_bias_v[None, :, None, :]
        matrix_ac = torch.matmul(q_u, k.transpose(-2, -1))
        matrix_bd = _rel_shift(torch.matmul(q_v, p.transpose(-2, -1)))
        scores = (matrix_ac + matrix_bd) / math.sqrt(self.d_k)
        if mask is not None:
            keep = mask[:, None, None, :]
            scores = scores.masked_fill(~keep, -math.inf)
        attn = torch.softmax(scores, dim=-1)
        if mask is not None:
            attn = attn.masked_fill(~keep, 0.0)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, D)
        return self.linear_out(out)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, hidden: int):
        super().__init__()
        self.w_1 = nn.Linear(d_model, hidden)
        self.w_2 = nn.Linear(hidden, d_model)

    def forward(self, x):
        return self.w_2(swish(self.w_1(x)))


def _batch_norm_eval(bn: nn.BatchNorm1d, h):
    """Batch norm with its running statistics, whatever the module's mode."""
    return F.batch_norm(h, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)


class ConvolutionModule(nn.Module):
    """Pointwise conv, GLU, depthwise conv, batch norm, swish, pointwise
    conv on (B, T, D)."""

    def __init__(self, channels: int, kernel_size: int = 15):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size,
                                        padding=(kernel_size - 1) // 2,
                                        groups=channels)
        self.norm = nn.BatchNorm1d(channels)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        h = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        h = swish(_batch_norm_eval(self.norm, self.depthwise_conv(h)))
        return self.pointwise_conv2(h).transpose(1, 2)


class EncoderLayer(nn.Module):
    """Macaron conformer block, normalize_before=True."""

    def __init__(self, d_model: int, n_head: int, linear_units: int,
                 cnn_kernel: int):
        super().__init__()
        self.self_attn = RelPositionMultiHeadedAttention(n_head, d_model)
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units)
        self.feed_forward_macaron = PositionwiseFeedForward(d_model,
                                                            linear_units)
        self.conv_module = ConvolutionModule(d_model, cnn_kernel)
        self.norm_ff = layer_norm(d_model)
        self.norm_mha = layer_norm(d_model)
        self.norm_ff_macaron = layer_norm(d_model)
        self.norm_conv = layer_norm(d_model)
        self.norm_final = layer_norm(d_model)

    def forward(self, x, pos_emb, mask=None):
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), pos_emb, mask)
        x = x + self.conv_module(self.norm_conv(x))
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class RelPositionalEncoding(nn.Module):
    """Scales x by sqrt(d_model) and gives the reversed position table."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x):
        pos_emb = rel_positional_encoding(x.shape[1], self.d_model, x.dtype,
                                          x.device)
        return x * math.sqrt(self.d_model), pos_emb


class Conv2dNoSubsampling(nn.Module):
    """2 x (conv 5x5, stride 1, + relu), then Linear(C * F -> D), the
    (C, F) flattened channel-major, as torch's NCHW gives it."""

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(1, odim, 5, 1, 2), nn.ReLU(),
            nn.Conv2d(odim, odim, 5, 1, 2), nn.ReLU(),
        )
        self.out = nn.Sequential(nn.Linear(odim * idim, odim),
                                 RelPositionalEncoding(odim))

    def forward(self, feats):
        h = self.conv(feats[:, None])  # (B, C, T, F)
        b, c, t, f = h.shape
        return self.out(h.transpose(1, 2).reshape(b, t, c * f))


class ConformerEncoder(nn.Module):
    def __init__(self, input_size: int, attention_dim: int,
                 attention_heads: int, linear_units: int, num_blocks: int,
                 cnn_module_kernel: int):
        super().__init__()
        self.embed = Conv2dNoSubsampling(input_size, attention_dim)
        self.encoders = nn.ModuleList(
            EncoderLayer(attention_dim, attention_heads, linear_units,
                         cnn_module_kernel)
            for _ in range(num_blocks))
        self.after_norm = layer_norm(attention_dim)

    def forward(self, feats, mask=None):
        x, pos_emb = self.embed(feats)
        for layer in self.encoders:
            x = layer(x, pos_emb, mask)
        return self.after_norm(x)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


class ConformerPPG(nn.Module):
    """Frontend + encoder. `forward` is JAX `ConformerPPG.apply`, `encode`
    its `encode` (normalised features in)."""

    def __init__(self, input_size: int = 80, attention_dim: int = 144,
                 attention_heads: int = 4, linear_units: int = 576,
                 num_blocks: int = 16, cnn_module_kernel: int = 15,
                 fs: int = 16000, n_fft: int = 1024, win_length: int = 800,
                 hop_length: int = 160):
        super().__init__()
        self.input_size, self.fs, self.n_fft = input_size, fs, n_fft
        self.win_length, self.hop_length = win_length, hop_length
        self.encoder = ConformerEncoder(input_size, attention_dim,
                                        attention_heads, linear_units,
                                        num_blocks, cnn_module_kernel)

    def features(self, speech):
        """(T,) or (B, T) speech -> (B, T', input_size) normalised
        log-mel."""
        return utterance_mvn(frontend_logmel(
            speech, fs=self.fs, n_fft=self.n_fft, win_length=self.win_length,
            hop_length=self.hop_length, n_mels=self.input_size))

    def encode(self, feats, mask=None):
        """(B, T, input_size) normalised features -> (B, T, attention_dim);
        mask (B, T), True on frames, masks attention's keys."""
        return self.encoder(feats, mask)

    def forward(self, speech, mask=None):
        """(B, T) or (T,) speech -> (B, T', attention_dim) PPG."""
        return self.encode(self.features(speech), mask)


def encoder_state_dict(sd) -> dict:
    """The encoder's entries of a reference state dict, under "encoder.":
    full-model keys ("encoder.encoders.0....", other modules' dropped) or
    bare encoder keys ("encoders.0....")."""
    if any(k.startswith("encoder.") for k in sd):
        return {k: v for k, v in sd.items() if k.startswith("encoder.")}
    return {f"encoder.{k}": v for k, v in sd.items()}


def load_reference_state(model: nn.Module, sd: dict):
    """load_state_dict that also takes a reference state dict without
    batch norm's num_batches_tracked; any other key missing or left over
    raises."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state dict does not fit {type(model).__name__}: "
                       f"missing {missing[:8]}, unexpected {unexpected[:8]}")
    return model


def load_ppg_model(checkpoint_path: str, *, num_blocks: int = 16,
                   device="cuda") -> ConformerPPG:
    """A reference `24epoch.pth`-style checkpoint (a state dict, maybe
    under "model") -> ConformerPPG in eval mode on `device` (cuda raises
    without a CUDA device)."""
    device = _device(device)
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    model = ConformerPPG(num_blocks=num_blocks)
    load_reference_state(model, encoder_state_dict(sd))
    return model.to(device).eval()
