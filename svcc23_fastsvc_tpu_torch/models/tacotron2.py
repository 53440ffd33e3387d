"""B02 Tacotron2 acoustic model, inference: PPG (+ log-F0, loudness,
x-vector) -> WORLD features (mcep | bap).

Counterpart of `svcc23_fastsvc_tpu/models/tacotron2.py` for the B02
recipe's stage-5 decode: the primitives (`lstm_cell`,
`lstm_cell_from_gates`, `bilstm` with torch packed-sequence semantics,
`batch_norm` in eval, `instance_norm_global`, `dropout`) and `Tacotron2`
with its free-running decoder. The module tree keeps the reference torch
keys that `svcc23_fastsvc_tpu/compat/torch_weights.py::convert_tacotron2`
reads (`encoder.{input_layer,convs.i.0,convs.i.1,blstm}`,
`prenet.prenet.i.0`, `decs.i.{cell,pj}`, `proj`, `bap_decoder.{0,3,6,9,10}`,
`{logf0,lft}_film_net`, `spk_emb_projection`). The LSTMs and batch norms
are parameter holders (`nn.LSTM`, `nn.LSTMCell`, `nn.BatchNorm1d`); the
forward computes with the primitives, as the JAX model does, so both run
the same arithmetic in f32 and in bf16 (statistics of the norms in f32).

Reference quirks kept, as in the JAX model: InstanceNorm2d on 3-D tensors
normalises each utterance over (T, C); the bap stream's third conv has
kernel 1 and padding 1 (T + 2 frames, cut back at the end); the prenet's
dropout is always on, in decode too. Its keep masks come from an explicit
`prenet_masks` argument or a `torch.Generator`. The teacher-forced branch
and training mode come with B02 training.

Convs go through `ops.conv.conv1d`: the bap stream's K = 3 convs and the
FiLM convs to the window conv, or with `FASTSVC_PALLAS_CONV=1` and
T >= 256 (conv1, conv3 and the FiLM convs) to the fused conv; the
encoder's 512-channel convs and the K = 1, padding-1 conv to `F.conv1d`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import l2_normalize, leaky_relu, linear
from .fastsvc import Conv1d, FiLMBlock, Linear, _placeholders


# ---------------------------------------------------------------------------
# primitives (JAX layout: cell weights (in, 4H) / (H, 4H), gates i, f, g, o)
# ---------------------------------------------------------------------------


def lstm_cell(p, x, h, c):
    """torch LSTMCell math on {"w_ih", "w_hh", "b_ih", "b_hh"}."""
    return lstm_cell_from_gates(p, x @ p["w_ih"] + p["b_ih"], h, c)


def lstm_cell_from_gates(p, gx, h, c):
    """The cell given its input projection gx = x @ w_ih + b_ih."""
    gates = gx + h @ p["w_hh"] + p["b_hh"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _lstm_scan(p, xs, mask=None):
    """Unidirectional LSTM over (B, T, D) -> (B, T, H). `mask` (B, T) freezes
    the state past each length and zeroes the output there. The input
    projection of the whole sequence is one matmul."""
    B, T, _ = xs.shape
    H = p["w_hh"].shape[0]
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    gx = xs @ p["w_ih"] + p["b_ih"]
    outs = []
    for t in range(T):
        h_new, c_new = lstm_cell_from_gates(p, gx[:, t], h, c)
        if mask is None:
            h, c = h_new, c_new
            outs.append(h)
            continue
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        outs.append(torch.where(m, h, torch.zeros_like(h)))
    return torch.stack(outs, dim=1)


def _flip_within_lengths(x, lengths):
    """Reverse each (B, T, D) sequence within its own valid length."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    n = lengths.to(x.device)[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return torch.gather(x, 1, idx[:, :, None].expand_as(x))


def bilstm(p, xs, lengths=None):
    """Bidirectional LSTM with torch packed-sequence semantics: p {"fwd",
    "bwd"} cell params; (B, T, 2H), zeros past each length."""
    if lengths is None:
        fwd = _lstm_scan(p["fwd"], xs)
        bwd = _lstm_scan(p["bwd"], xs.flip(1)).flip(1)
        return torch.cat([fwd, bwd], dim=-1)
    lengths = torch.as_tensor(lengths, device=xs.device)
    mask = torch.arange(xs.shape[1], device=xs.device)[None, :] < \
        lengths[:, None]
    fwd = _lstm_scan(p["fwd"], xs, mask)
    bwd = _lstm_scan(p["bwd"], _flip_within_lengths(xs, lengths), mask)
    return torch.cat([fwd, _flip_within_lengths(bwd, lengths)], dim=-1)


def batch_norm(x, p, eps: float = 1e-5):
    """Eval-mode BatchNorm over (B, T, C) from {"w", "b", "mean", "var"}:
    arithmetic in f32 (f64 for f64 inputs), output in x's dtype."""
    wide = torch.promote_types(x.dtype, torch.float32)
    mean, var, w, b = (p[k].to(wide) for k in ("mean", "var", "w", "b"))
    y = (x.to(wide) - mean) * torch.rsqrt(var + eps) * w + b
    return y.to(x.dtype)


def instance_norm_global(x, eps: float = 1e-5):
    """The reference's InstanceNorm2d on a 3-D tensor: each batch element
    normalised over all its other axes, statistics in f32."""
    wide = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(wide)
    axes = tuple(range(1, x.dim()))
    mean = x32.mean(dim=axes, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=axes, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def dropout(x, rate: float, keep, *, train=True):
    """where(keep, x / (1 - rate), 0) with the given keep mask (JAX draws it
    as bernoulli(key, 1 - rate))."""
    if not train or rate <= 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _seeded_lstm(module, hidden, generator):
    """torch's LSTM init, uniform(+-1/sqrt(hidden)), drawn from `generator`."""
    bound = hidden ** -0.5
    with torch.no_grad():
        for p in module.parameters():
            p.uniform_(-bound, bound, generator=generator)
    return module


def _cell_params(cell: nn.LSTMCell):
    return {"w_ih": cell.weight_ih.t(), "w_hh": cell.weight_hh.t(),
            "b_ih": cell.bias_ih, "b_hh": cell.bias_hh}


def _bn_params(bn: nn.BatchNorm1d):
    return {"w": bn.weight, "b": bn.bias, "mean": bn.running_mean,
            "var": bn.running_var}


def _linear(mod: Linear, x):
    return linear(x, {"w": mod.weight.t(), "b": mod.bias})


# ---------------------------------------------------------------------------
# Tacotron2
# ---------------------------------------------------------------------------


class _Encoder(nn.Module):
    def __init__(self, D, C, H, econv_layers, econv_filts, kw):
        super().__init__()
        self.input_layer = Linear(D, C, **kw)
        self.convs = nn.ModuleList(
            nn.ModuleList([Conv1d(C, C, econv_filts, bias=False,
                                  weight_norm=False, **kw),
                           nn.BatchNorm1d(C, device=kw["device"])])
            for _ in range(econv_layers))
        self.blstm = _seeded_lstm(
            nn.LSTM(C, H // 2, batch_first=True, bidirectional=True,
                    device=kw["device"]), H // 2, kw["generator"])

    def blstm_params(self):
        m = self.blstm
        return {"fwd": {"w_ih": m.weight_ih_l0.t(), "w_hh": m.weight_hh_l0.t(),
                        "b_ih": m.bias_ih_l0, "b_hh": m.bias_hh_l0},
                "bwd": {"w_ih": m.weight_ih_l0_reverse.t(),
                        "w_hh": m.weight_hh_l0_reverse.t(),
                        "b_ih": m.bias_ih_l0_reverse,
                        "b_hh": m.bias_hh_l0_reverse}}

    def forward(self, xs, lengths):
        h = _linear(self.input_layer, xs)
        for conv, bn in self.convs:
            h = torch.relu(batch_norm(conv(h), _bn_params(bn)))
        return bilstm(self.blstm_params(), h, lengths)


class _Prenet(nn.Module):
    def __init__(self, din, dim, layers, kw):
        super().__init__()
        self.prenet = nn.ModuleList(
            nn.ModuleList([Linear(din if i == 0 else dim, dim, **kw)])
            for i in range(layers))


class _DecoderLayer(nn.Module):
    def __init__(self, din, H, kw):
        super().__init__()
        self.cell = _seeded_lstm(nn.LSTMCell(din, H, device=kw["device"]),
                                 H, kw["generator"])
        self.pj = Linear(H, H, **kw)


class Tacotron2(nn.Module):
    """Acoustic model (reference tacotron2.py:381-580), inference.

    `forward(features (B, T, input_dim), lengths (B,) or None, lft and
    logf0 (B, T, 1), spk_embs (B, S) or (B, 1, S) or None)` -> (B, T,
    output_dim + bap_out), free-running.
    """

    def __init__(self, input_dim: int = 256, output_dim: int = 60,
                 hidden_dim: int = 1024, dec_layers: int = 2,
                 prenet_layers: int = 2, prenet_dim: int = 256,
                 prenet_dropout_rate: float = 0.5, multi_speaker: bool = True,
                 spk_emb_dim: int = 512, integrate_logf0: bool = True,
                 econv_layers: int = 3, econv_chans: int = 512,
                 econv_filts: int = 5, bap_dim_in: int = 0, bap_out: int = 3,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.output_dim = output_dim
        self.prenet_layers = prenet_layers
        self.prenet_dim = prenet_dim
        self.prenet_dropout_rate = prenet_dropout_rate
        self.multi_speaker = multi_speaker
        self.integrate_logf0 = integrate_logf0
        self.encoder = _Encoder(input_dim, econv_chans, hidden_dim,
                                econv_layers, econv_filts, kw)
        self.prenet = _Prenet(output_dim, prenet_dim, prenet_layers, kw)
        prev = output_dim if prenet_layers == 0 else prenet_dim
        self.decs = nn.ModuleList(
            _DecoderLayer(hidden_dim + prev if i == 0 else hidden_dim,
                          hidden_dim, kw)
            for i in range(dec_layers))
        self.proj = Linear(hidden_dim, output_dim, **kw)
        bd = bap_dim_in or input_dim + 2
        # the reference's 258 -> 86 -> 43 -> 21 -> 3
        c1, c2, c3 = max(bd // 3, 1), max(bd // 6, 1), max(bd // 12, 1)
        conv = dict(weight_norm=False, **kw)
        self.bap_decoder = _placeholders(11, {
            0: Conv1d(bd, c1, 3, **conv),
            3: Conv1d(c1, c2, 3, **conv),
            6: Conv1d(c2, c3, 1, **conv),
            9: Conv1d(c3, bap_out, 3, **conv),
            10: nn.BatchNorm1d(bap_out, device=device),
        })
        if integrate_logf0:
            self.logf0_film_net = FiLMBlock(1, use_weight_norm=False, **kw)
            self.lft_film_net = FiLMBlock(1, use_weight_norm=False, **kw)
        if multi_speaker:
            self.spk_emb_projection = Linear(hidden_dim + spk_emb_dim,
                                             hidden_dim, **kw)

    def _bap(self, feats, logf0, lft):
        d = self.bap_decoder
        x = torch.cat([feats, logf0, lft], dim=-1)
        x = leaky_relu(d[0](x, padding=2, dilation=2))
        x = leaky_relu(d[3](x, padding=2, dilation=2))
        x = leaky_relu(d[6](x, padding=1))  # T + 2 frames: the quirk
        x = d[9](x, padding=2, dilation=2)
        return batch_norm(x, _bn_params(d[10]))

    def prenet_masks(self, T: int, B: int, *, generator=None, device=None):
        """Keep masks of the prenet's always-on dropout for a T-frame decode:
        (T, prenet_layers, B, prenet_dim) booleans, Bernoulli(1 - rate)."""
        shape = (T, self.prenet_layers, B, self.prenet_dim)
        return torch.rand(shape, generator=generator,
                          device=device) < 1.0 - self.prenet_dropout_rate

    def forward(self, features, lengths, lft, logf0, spk_embs=None, *,
                prenet_masks=None, generator=None):
        """`prenet_masks` (see `prenet_masks`) or, without them, masks drawn
        from `generator` (a `torch.Generator` on the features' device)."""
        B, T, _ = features.shape
        enc = self.encoder(features, lengths)
        bap = instance_norm_global(self._bap(features, logf0, lft))
        enc = instance_norm_global(enc)
        if self.integrate_logf0:
            f0_scale, f0_shift = self.logf0_film_net(logf0)
            l_scale, l_shift = self.lft_film_net(lft)
            enc = (f0_scale + l_scale) * enc + (f0_shift + l_shift)
        if self.multi_speaker and spk_embs is not None:
            if spk_embs.dim() == 2:
                spk_embs = spk_embs[:, None, :]
            se = l2_normalize(spk_embs, axis=-1).expand(B, enc.shape[1], -1)
            enc = _linear(self.spk_emb_projection, torch.cat([enc, se], -1))
        if prenet_masks is None:
            prenet_masks = self.prenet_masks(T, B, generator=generator,
                                             device=features.device)
        z = self._decode(enc, prenet_masks)
        preds = _linear(self.proj, z)  # on the stacked outputs, as JAX does
        n = min(preds.shape[1], bap.shape[1])
        return torch.cat([preds[:, :n], bap[:, :n]], dim=-1)

    def _decode(self, enc, masks):
        """The free-running decoder: per frame the prenet of the previous
        prediction, the cells and their projections; (B, T, H) of the last
        layer. The encoder half of cell 0's input projection runs on all
        frames at once."""
        B, T, Hc = enc.shape
        cells = [_cell_params(d.cell) for d in self.decs]
        H = cells[0]["w_hh"].shape[0]
        z = [enc.new_zeros((B, H)) for _ in cells]
        c = [enc.new_zeros((B, H)) for _ in cells]
        prev = enc.new_zeros((B, self.output_dim))
        gx_enc = enc @ cells[0]["w_ih"][:Hc] + cells[0]["b_ih"]
        w_pre = cells[0]["w_ih"][Hc:]
        outs = []
        for t in range(T):
            x = prev
            for j, (lin,) in enumerate(self.prenet.prenet):
                x = dropout(torch.relu(_linear(lin, x)),
                            self.prenet_dropout_rate, masks[t, j])
            h, c[0] = lstm_cell_from_gates(cells[0], gx_enc[:, t] + x @ w_pre,
                                           z[0], c[0])
            z_prev = list(z)
            z[0] = torch.tanh(_linear(self.decs[0].pj, h))
            for i in range(1, len(cells)):
                h, c[i] = lstm_cell(cells[i], z[i - 1], z_prev[i], c[i])
                z[i] = torch.tanh(_linear(self.decs[i].pj, h))
            outs.append(z[-1])
            prev = _linear(self.proj, z[-1])
        return torch.stack(outs, dim=1)
