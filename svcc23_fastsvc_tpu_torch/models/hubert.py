"""HuBERT-soft unit extractor (the B02 recipe's linguistic features).

Counterpart of `svcc23_fastsvc_tpu/models/hubert.py`: a CNN feature
extractor (7 convs of 512 channels, the first followed by a GroupNorm of
one channel a group, exact-erf GELU after each) -> feature projection
(LayerNorm, Linear to 768) -> a grouped conv positional embedding (kernel
128, 16 groups, weight norm at dim 2, last frame dropped) -> LayerNorm ->
12 post-norm transformer layers (12 heads, FFN 3072, GELU) -> the 256-d
soft-unit projection. With `hop10ms` the last extractor conv has stride
1, the reference's 10 ms hop (reference preprocess_b02.py:214-215); the
input is zero-padded by 40 samples on both sides, as bshall's `units()`.

The modules keep bshall's Hubert tree, so its state-dict keys load by
`load_state_dict`: `feature_extractor.conv0..6` and `.norm0`,
`feature_projection.norm` / `.projection`, `positional_embedding.conv`
(`weight_g`, `weight_v`, `bias`), `norm`, `encoder.layers.i.self_attn.
in_proj_weight` / `in_proj_bias` / `out_proj`, `.linear1`, `.linear2`,
`.norm1`, `.norm2`, and `proj`. Attention is written out as the JAX
package writes it (a matmul, softmax, a matmul, in the input's dtype),
not torch's fused encoder path. Inference only, one utterance a call:
norm0's statistics span the whole time axis, so padding an utterance to
batch it with others would change every one of its frames.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..train.checkpoint import _device


class FeatureExtractor(nn.Module):
    def __init__(self, conv_dim: int = 512, hop10ms: bool = True):
        super().__init__()
        C = conv_dim
        self.conv0 = nn.Conv1d(1, C, 10, 5, bias=False)
        self.norm0 = nn.GroupNorm(C, C)
        for i in range(1, 5):
            setattr(self, f"conv{i}", nn.Conv1d(C, C, 3, 2, bias=False))
        self.conv5 = nn.Conv1d(C, C, 2, 2, bias=False)
        self.conv6 = nn.Conv1d(C, C, 2, 1 if hop10ms else 2, bias=False)

    def forward(self, x):
        """(B, 1, T) -> (B, conv_dim, T')."""
        x = F.gelu(self.norm0(self.conv0(x)))
        for i in range(1, 7):
            x = F.gelu(getattr(self, f"conv{i}")(x))
        return x


class FeatureProjection(nn.Module):
    def __init__(self, conv_dim: int = 512, d_model: int = 768):
        super().__init__()
        self.norm = nn.LayerNorm(conv_dim)
        self.projection = nn.Linear(conv_dim, d_model)

    def forward(self, x):
        return self.projection(self.norm(x))


class _WeightNormConv(nn.Module):
    """A grouped, "same"-padded Conv1d in weight-norm form: weight =
    weight_g * weight_v / ||weight_v|| over dims (0, 1) (torch
    `weight_norm(..., dim=2)`), the keys bshall's checkpoint holds."""

    def __init__(self, d_model: int, kernel_size: int, groups: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel_size))
        self.weight_v = nn.Parameter(
            torch.empty(d_model, d_model // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(d_model))
        nn.init.normal_(self.weight_v, std=0.01)
        self.groups = groups

    def forward(self, x):
        v = self.weight_v
        w = v * (self.weight_g / torch.linalg.vector_norm(
            v, dim=(0, 1), keepdim=True))
        return F.conv1d(x, w, self.bias, padding=w.shape[-1] // 2,
                        groups=self.groups)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, d_model: int = 768, kernel_size: int = 128,
                 groups: int = 16):
        super().__init__()
        self.conv = _WeightNormConv(d_model, kernel_size, groups)

    def forward(self, x):
        """(B, T, D) -> GELU of the conv, its last frame dropped."""
        return F.gelu(self.conv(x.transpose(1, 2))[:, :, :-1]).transpose(1, 2)


class SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj, out_proj),
    applied as explicit matmuls and a softmax."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.n_heads = n_heads

    def forward(self, x):
        B, T, D = x.shape
        hd = D // self.n_heads
        q, k, v = (t.reshape(B, T, self.n_heads, hd).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight,
                                     self.in_proj_bias).chunk(3, dim=-1))
        scores = (q @ k.transpose(2, 3)) / math.sqrt(hd)
        out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2)
        return self.out_proj(out.reshape(B, T, D))


class EncoderLayer(nn.Module):
    """torch's post-norm TransformerEncoderLayer (GELU), inference."""

    def __init__(self, d_model: int, n_heads: int, ff_dim: int):
        super().__init__()
        self.self_attn = SelfAttention(d_model, n_heads)
        self.linear1 = nn.Linear(d_model, ff_dim)
        self.linear2 = nn.Linear(ff_dim, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, n_layers: int, n_heads: int,
                 ff_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d_model, n_heads, ff_dim)
                                    for _ in range(n_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class HubertSoft(nn.Module):
    def __init__(self, d_model: int = 768, n_layers: int = 12,
                 n_heads: int = 12, ff_dim: int = 3072, conv_dim: int = 512,
                 unit_dim: int = 256, hop10ms: bool = True):
        super().__init__()
        self.feature_extractor = FeatureExtractor(conv_dim, hop10ms)
        self.feature_projection = FeatureProjection(conv_dim, d_model)
        self.positional_embedding = PositionalConvEmbedding(d_model)
        self.norm = nn.LayerNorm(d_model)
        self.encoder = TransformerEncoder(d_model, n_layers, n_heads, ff_dim)
        self.proj = nn.Linear(d_model, unit_dim)

    def forward(self, wav):
        """Soft units of a 16 kHz waveform: (T,) or (1, T) -> (1, T', 256),
        T' about T / 160 with hop10ms (JAX `HubertSoft.apply`)."""
        if wav.dim() == 1:
            wav = wav[None]
        x = F.pad(wav, (40, 40))[:, None, :]
        x = self.feature_projection(self.feature_extractor(x).transpose(1, 2))
        x = self.norm(x + self.positional_embedding(x))
        return self.proj(self.encoder(x))


def _n_layers(sd) -> int:
    layers = {k.split(".")[2] for k in sd if k.startswith("encoder.layers.")}
    if not layers:
        raise KeyError("no encoder.layers.* keys in the HuBERT state dict")
    return len(layers)


# the positional conv's key prefixes JAX `convert_hubert_state_dict` reads
_POS_FOLDED_NORM = "encoder.pos_conv_embed.conv"  # weight norm over (1, 2)
_POS_PREFIXES = ("positional_embedding.conv", "encoder.pos_conv.0")


def hubert_state_dict(sd) -> dict:
    """A bshall checkpoint's state dict (or the checkpoint, its state dict
    under "hubert") -> the port's state dict, reading the keys JAX
    `convert_hubert_state_dict` reads and ignoring the rest (the
    training-only `masked_spec_embed` and `label_embedding`). The
    positional conv may come as `positional_embedding.conv` weight_g /
    weight_v (kept) or weight, as `encoder.pos_conv.0`, or as
    `encoder.pos_conv_embed.conv` (norm over dims (1, 2), as JAX folds
    it); a folded weight w is kept as weight_v = w, weight_g = ||w||."""
    if isinstance(sd, dict) and "hubert" in sd:
        sd = sd["hubert"]

    def t(key):
        return torch.as_tensor(sd[key]).detach().float().cpu()

    out = {}
    n_layers = _n_layers(sd)
    names = ([f"feature_extractor.conv{i}.weight" for i in range(7)]
             + [f"{m}.{p}" for m in ("feature_extractor.norm0",
                                     "feature_projection.norm",
                                     "feature_projection.projection",
                                     "norm", "proj")
                for p in ("weight", "bias")])
    for i in range(n_layers):
        b = f"encoder.layers.{i}"
        names += [f"{b}.self_attn.in_proj_weight",
                  f"{b}.self_attn.in_proj_bias"]
        names += [f"{b}.{m}.{p}" for m in ("self_attn.out_proj", "linear1",
                                          "linear2", "norm1", "norm2")
                  for p in ("weight", "bias")]
    for k in names:
        out[k] = t(k)

    dst = "positional_embedding.conv"
    if f"{_POS_FOLDED_NORM}.weight_v" in sd:
        v = t(f"{_POS_FOLDED_NORM}.weight_v")
        g = t(f"{_POS_FOLDED_NORM}.weight_g")
        w = g * v / torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True)
        bias = t(f"{_POS_FOLDED_NORM}.bias")
    else:
        src = next((p for p in _POS_PREFIXES
                    if f"{p}.weight_v" in sd or f"{p}.weight" in sd),
                   _POS_PREFIXES[1])
        bias = t(f"{src}.bias")
        if f"{src}.weight_v" in sd:
            v, g = t(f"{src}.weight_v"), t(f"{src}.weight_g")
            if src == dst:
                out.update({f"{dst}.weight_v": v, f"{dst}.weight_g": g,
                            f"{dst}.bias": bias})
                return out
            w = g * v / torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True)
        else:
            w = t(f"{src}.weight")
    out[f"{dst}.weight_v"] = w
    out[f"{dst}.weight_g"] = torch.linalg.vector_norm(w, dim=(0, 1),
                                                      keepdim=True)
    out[f"{dst}.bias"] = bias
    return out


def hubert_widths(sd: dict) -> dict:
    """HubertSoft's constructor widths read off a port state dict."""
    conv0 = sd["feature_extractor.conv0.weight"]
    in_proj = sd["encoder.layers.0.self_attn.in_proj_weight"]
    return {
        "conv_dim": conv0.shape[0],
        "d_model": in_proj.shape[1],
        "ff_dim": sd["encoder.layers.0.linear1.weight"].shape[0],
        "unit_dim": sd["proj.weight"].shape[0],
        "n_layers": _n_layers(sd),
    }


def load_hubert_soft(checkpoint_path: str, *, device="cuda") -> HubertSoft:
    """A bshall hubert-soft checkpoint -> HubertSoft (10 ms hop, 12 heads)
    in eval mode on `device` (cuda raises without a CUDA device); the
    widths are the checkpoint's."""
    device = _device(device)
    sd = hubert_state_dict(torch.load(checkpoint_path, map_location="cpu",
                                      weights_only=True))
    model = HubertSoft(**hubert_widths(sd))
    model.load_state_dict(sd)
    return model.to(device).eval()


def bshall_checkpoint(model: HubertSoft, *, seed: int = 0) -> dict:
    """`model`'s weights in a bshall checkpoint's layout: the state dict
    under "hubert", with the training-only `masked_spec_embed` and
    `label_embedding` (100 labels) such a file also holds, drawn from
    `seed`."""
    sd = dict(model.state_dict())
    gen = torch.Generator().manual_seed(seed)
    sd["masked_spec_embed"] = torch.rand(model.norm.weight.shape[0],
                                         generator=gen)
    sd["label_embedding.weight"] = torch.randn(
        100, model.proj.weight.shape[0], generator=gen)
    return {"hubert": sd}
