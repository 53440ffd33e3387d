"""B02 Tacotron2 acoustic model: PPG (+ log-F0, loudness, x-vector) ->
WORLD features (mcep | bap), in inference and in training.

Counterpart of `svcc23_fastsvc_tpu/models/tacotron2.py`: the primitives
(`lstm_cell`, `lstm_cell_from_gates`, `bilstm` with torch packed-sequence
semantics, `batch_norm` in eval and `batch_norm_train`, `instance_norm_global`,
`dropout`), `Tacotron2` with its free-running decoder (the recipe's
stage-5 decode) and its teacher-forced, train-mode forward (stage-4
training), and the sub-frequency discriminators `SubFreqDiscriminator` /
`MultiSubFreqDiscriminator`. The module tree keeps the reference torch
keys that `svcc23_fastsvc_tpu/compat/torch_weights.py::convert_tacotron2`
and `convert_subfreq_discriminator` read (`encoder.{input_layer,convs.i.0,
convs.i.1,blstm}`, `prenet.prenet.i.0`, `decs.i.{cell,pj}`, `proj`,
`bap_decoder.{0,3,6,9,10}`, `{logf0,lft}_film_net`, `spk_emb_projection`;
`{low,mid,high}_discriminator.layers.j[.0]`). The LSTMs and batch norms
are parameter holders (`nn.LSTM`, `nn.LSTMCell`, `nn.BatchNorm1d`, whose
running statistics are the model's batch-norm state); the forward
computes with the primitives, as the JAX model does, so both run the same
arithmetic in f32 and in bf16 (statistics of the norms in f32).

Reference quirks kept, as in the JAX model: InstanceNorm2d on 3-D tensors
normalises each utterance over (T, C); the bap stream's third conv has
kernel 1 and padding 1 (T + 2 frames, cut back at the end); the prenet's
dropout is always on, in decode and evaluation too. Random draws (dropout
keep masks, the discriminator's window starts) come from explicit
arguments or from a `torch.Generator`: JAX's key splits cannot be
reproduced by one, so the tests pass the masks JAX drew.

Convs go through `ops.conv.conv1d`: the bap stream's K = 3 convs and the
FiLM convs to the window conv (with grad enabled, its dx and wgrad kernels
in the backward), or with `FASTSVC_PALLAS_CONV=1` and T >= 256 (conv1,
conv3 and the FiLM convs at full width) to the fused conv; the encoder's
512-channel convs and the K = 1, padding-1 conv to `F.conv1d`; the
discriminators' 2-D convs to `ops.conv.conv2d` (cuDNN), as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.conv import conv2d, l2_normalize, leaky_relu, linear
from ..parallel.mesh import psum
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


def batch_norm_train(x, p, momentum: float = 0.1, eps: float = 1e-5,
                     group=None):
    """Train-mode BatchNorm over (B, T, C): (y, new running statistics).

    Batch statistics over all B * T frames, padding included, in f32 (f64
    for f64 inputs); y in x's dtype; the new statistics {"mean", "var"} are
    (1 - momentum) * running + momentum * batch, with the batch variance
    unbiased, as torch's BatchNorm1d and the JAX package compute them.

    With a data `group` the statistics are the whole group's batch, as in
    JAX's GSPMD step: the sums and the frame count are summed across the
    ranks (with autograd) before each division, so y and the new running
    statistics are those of one process on the global batch, on every
    rank."""
    wide = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(wide)
    if group is None:
        mean = x32.mean(dim=(0, 1))
        var = torch.square(x32 - mean).mean(dim=(0, 1))
        n = x.shape[0] * x.shape[1]
        unbiased = (var * n / max(n - 1, 1)).detach()
    else:
        # a filled tensor, not one made from host data: capturable
        n = psum(torch.full((), x.shape[0] * x.shape[1], dtype=wide,
                            device=x.device), group)
        mean = psum(x32.sum(dim=(0, 1)), group) / n
        var = psum(torch.square(x32 - mean).sum(dim=(0, 1)), group) / n
        unbiased = (var * n / torch.clamp(n - 1, min=1)).detach()
    new_stats = {
        "mean": (1 - momentum) * p["mean"].to(wide) + momentum * mean.detach(),
        "var": (1 - momentum) * p["var"].to(wide) + momentum * unbiased,
    }
    y = (x32 - mean) * torch.rsqrt(var + eps) * p["w"].to(wide) \
        + p["b"].to(wide)
    return y.to(x.dtype), new_stats


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


def keep_mask(shape, rate: float, *, generator=None, device=None):
    """A dropout keep mask: Bernoulli(1 - rate) booleans, drawn from
    `generator`; None when the rate is 0 (no dropout, no draw)."""
    if rate <= 0.0:
        return None
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


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

    def forward(self, xs, lengths, *, train=False, masks=None, rate=0.0,
                group=None):
        """(B, T, 2H) and each batch norm's new statistics (its stored ones
        in eval). In train mode `masks[i]` is the keep mask of the dropout
        after conv i, or None. `group`: the data group whose ranks hold
        the rest of the batch (the batch norms' statistics span it)."""
        h = _linear(self.input_layer, xs)
        stats = []
        for i, (conv, bn) in enumerate(self.convs):
            p = _bn_params(bn)
            if train:
                h, new = batch_norm_train(conv(h), p, group=group)
            else:
                h, new = batch_norm(conv(h), p), {"mean": p["mean"],
                                                  "var": p["var"]}
            stats.append(new)
            h = torch.relu(h)
            if train and masks is not None and masks[i] is not None:
                h = dropout(h, rate, masks[i])
        return bilstm(self.blstm_params(), h, lengths), stats


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
    """Acoustic model (reference tacotron2.py:381-580).

    Free-running (decode): `forward(features (B, T, input_dim), lengths
    (B,) or None, lft and logf0 (B, T, 1), spk_embs (B, S) or (B, 1, S) or
    None)` -> (B, T, output_dim + bap_out).

    Teacher-forced (training, evaluation): `forward(..., targets (B, T,
    output_dim + bap_out), train=)` -> (pred, lengths, bn_state) as the JAX
    model's `apply` returns them; bn_state {"encoder": [stats per conv],
    "bap": stats} holds the batch norms' new running statistics (their
    stored ones in eval), which `set_bn_state` writes back.
    """

    def __init__(self, input_dim: int = 256, output_dim: int = 60,
                 hidden_dim: int = 1024, dec_layers: int = 2,
                 dec_dropout_rate: float = 0.2, enc_dropout_rate: float = 0.5,
                 prenet_layers: int = 2, prenet_dim: int = 256,
                 prenet_dropout_rate: float = 0.5, multi_speaker: bool = True,
                 spk_emb_dim: int = 512, integrate_logf0: bool = True,
                 econv_layers: int = 3, econv_chans: int = 512,
                 econv_filts: int = 5, bap_dim_in: int = 0, bap_out: int = 3,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.output_dim = output_dim
        self.hidden_dim = hidden_dim
        self.econv_chans = econv_chans
        self.dec_dropout_rate = dec_dropout_rate
        self.enc_dropout_rate = enc_dropout_rate
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

    def _bap(self, feats, logf0, lft, *, train=False, group=None):
        d = self.bap_decoder
        x = torch.cat([feats, logf0, lft], dim=-1)
        x = leaky_relu(d[0](x, padding=2, dilation=2))
        x = leaky_relu(d[3](x, padding=2, dilation=2))
        x = leaky_relu(d[6](x, padding=1))  # T + 2 frames: the quirk
        x = d[9](x, padding=2, dilation=2)
        p = _bn_params(d[10])
        if train:
            return batch_norm_train(x, p, group=group)
        return batch_norm(x, p), {"mean": p["mean"], "var": p["var"]}

    def prenet_masks(self, T: int, B: int, *, generator=None, device=None):
        """Keep masks of the prenet's always-on dropout for a T-frame decode:
        (T, prenet_layers, B, prenet_dim) booleans, Bernoulli(1 - rate)."""
        shape = (T, self.prenet_layers, B, self.prenet_dim)
        return torch.rand(shape, generator=generator,
                          device=device) < 1.0 - self.prenet_dropout_rate

    def train_draws(self, B: int, T: int, *, train: bool = True,
                    generator=None, device=None) -> dict:
        """The keep masks of one teacher-forced forward, drawn from
        `generator`: {"enc": one (B, T, econv_chans) mask per encoder conv,
        "prenet": one (B, T, prenet_dim) mask per prenet layer (its dropout
        is on in eval too), "dec": (T, dec_layers, B, hidden_dim), the
        decoder cells' dropout}; a mask is None where its rate is 0 or, for
        the encoder and decoder, out of train mode."""
        def draw(shape, rate):
            return keep_mask(shape, rate, generator=generator, device=device)

        enc_rate = self.enc_dropout_rate if train else 0.0
        dec_rate = self.dec_dropout_rate if train else 0.0
        return {
            "enc": [draw((B, T, self.econv_chans), enc_rate)
                    for _ in self.encoder.convs],
            "prenet": [draw((B, T, self.prenet_dim), self.prenet_dropout_rate)
                       for _ in range(self.prenet_layers)],
            "dec": draw((T, len(self.decs), B, self.hidden_dim), dec_rate),
        }

    @torch.no_grad()
    def set_bn_state(self, bn_state: dict):
        """Write the running statistics of a train-mode forward (its
        bn_state) into the batch norms' buffers."""
        bns = [bn for _, bn in self.encoder.convs] + [self.bap_decoder[10]]
        for bn, st in zip(bns, bn_state["encoder"] + [bn_state["bap"]]):
            bn.running_mean.copy_(st["mean"])
            bn.running_var.copy_(st["var"])

    def forward(self, features, lengths, lft, logf0, spk_embs=None,
                targets=None, *, train=False, draws=None, prenet_masks=None,
                generator=None, group=None):
        """Without `targets`: the free-running decode, on `prenet_masks`
        (see `prenet_masks`) or masks drawn from `generator` (a
        `torch.Generator` on the features' device). With `targets`: the
        teacher-forced forward, on `draws` (see `train_draws`) or draws
        from `generator`; in train mode the batch norms' statistics span
        the data `group`'s rows when one is given."""
        B, T, _ = features.shape
        if targets is None and train:
            raise ValueError("train mode is teacher-forced: give targets")
        if targets is not None and draws is None:
            draws = self.train_draws(B, T, train=train, generator=generator,
                                     device=features.device)
        enc, enc_bns = self.encoder(
            features, lengths, train=train,
            masks=None if draws is None else draws["enc"],
            rate=self.enc_dropout_rate, group=group)
        bap, bap_bn = self._bap(features, logf0, lft, train=train,
                                group=group)
        bap = instance_norm_global(bap)
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
        if targets is None:
            if prenet_masks is None:
                prenet_masks = self.prenet_masks(T, B, generator=generator,
                                                 device=features.device)
            z = self._decode(enc, prenet_masks)
        else:
            z = self._decode_teacher_forced(enc, targets, draws["prenet"],
                                            draws["dec"])
        preds = _linear(self.proj, z)  # on the stacked outputs, as JAX does
        n = min(preds.shape[1], bap.shape[1])
        pred = torch.cat([preds[:, :n], bap[:, :n]], dim=-1)
        if targets is None:
            return pred
        return pred, lengths, {"encoder": enc_bns, "bap": bap_bn}

    def _tail(self, cells, z, c, h, c0, masks):
        """Cell 0's projection and cells 1.., each output through its
        dropout (`masks[i]`, or none) and tanh(pj): the new (z, c)."""
        rate = self.dec_dropout_rate
        new_z, new_c = list(z), list(c)
        if masks is not None:
            h = dropout(h, rate, masks[0])
        new_z[0], new_c[0] = torch.tanh(_linear(self.decs[0].pj, h)), c0
        for i in range(1, len(cells)):
            h, new_c[i] = lstm_cell(cells[i], new_z[i - 1], z[i], c[i])
            if masks is not None:
                h = dropout(h, rate, masks[i])
            new_z[i] = torch.tanh(_linear(self.decs[i].pj, h))
        return new_z, new_c

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
            h, c0 = lstm_cell_from_gates(cells[0], gx_enc[:, t] + x @ w_pre,
                                         z[0], c[0])
            z, c = self._tail(cells, z, c, h, c0, None)
            outs.append(z[-1])
            prev = _linear(self.proj, z[-1])
        return torch.stack(outs, dim=1)

    def _decode_teacher_forced(self, enc, targets, pre_masks, dec_masks):
        """The teacher-forced decoder: the fed-back frames are [0, tgt_0,
        .., tgt_{T-2}], so the prenet (one mask per layer over all frames)
        and all of cell 0's input projection run on every frame at once;
        the cells then step through the frames, with dropout after each
        (`dec_masks[t, i]`) in train mode. (B, T, H) of the last layer; the
        carry is in the encoder's dtype."""
        B, T, _ = enc.shape
        cells = [_cell_params(d.cell) for d in self.decs]
        H = cells[0]["w_hh"].shape[0]
        z = [enc.new_zeros((B, H)) for _ in cells]
        c = [enc.new_zeros((B, H)) for _ in cells]
        pre = torch.cat([enc.new_zeros((B, 1, self.output_dim)),
                         targets[:, :-1, :self.output_dim]], dim=1)
        for j, (lin,) in enumerate(self.prenet.prenet):
            pre = torch.relu(_linear(lin, pre))
            if pre_masks[j] is not None:
                pre = dropout(pre, self.prenet_dropout_rate, pre_masks[j])
        gx0 = torch.cat([enc, pre], dim=-1) @ cells[0]["w_ih"] \
            + cells[0]["b_ih"]
        outs = []
        for t in range(T):
            h, c0 = lstm_cell_from_gates(cells[0], gx0[:, t], z[0], c[0])
            z, c = self._tail(cells, z, c, h, c0,
                              None if dec_masks is None else dec_masks[t])
            outs.append(z[-1])
        return torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# sub-frequency discriminators
# ---------------------------------------------------------------------------


class Conv2d(nn.Module):
    """torch.nn.Conv2d parameters (weight (O, I, kh, kw)), initialised
    uniform(+-1/sqrt(fan_in)) from `generator`, as the JAX model's init."""

    def __init__(self, in_channels, out_channels, kernel_size, *, bias=False,
                 device=None, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(kernel_size * kernel_size * in_channels)
        shape = (out_channels, in_channels, kernel_size, kernel_size)
        self.weight = nn.Parameter(torch.empty(shape, device=device).uniform_(
            -bound, bound, generator=generator))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)

    def forward(self, x, *, padding=0):
        """NHWC x -> NHWC, through `ops.conv.conv2d` on the HWIO weight."""
        return conv2d(x, self.weight.permute(2, 3, 1, 0), self.bias,
                      padding=padding)


class SubFreqDiscriminator(nn.Module):
    """Conv2d stack over one feature band (reference tacotron2.py:628-673):
    `layers` 9 x 9 convs with "same" padding and leaky ReLU, then a 1 x 1
    conv to one logit. (B, T, D') -> (B, T, D') logits."""

    def __init__(self, in_channels: int = 1, layers: int = 4,
                 kernel_size: int = 9, channels: int = 64, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.padding = (kernel_size - 1) // 2
        convs = []
        cin = in_channels
        for _ in range(layers):
            convs.append(nn.ModuleList([Conv2d(cin, channels, kernel_size,
                                               **kw)]))
            cin = channels
        convs.append(Conv2d(cin, 1, 1, bias=True, **kw))
        self.layers = nn.ModuleList(convs)

    def forward(self, x):
        h = x[:, :, :, None]  # NHWC, C = 1
        for (conv,) in self.layers[:-1]:
            h = leaky_relu(conv(h, padding=self.padding))
        return self.layers[-1](h)[:, :, :, 0]


class MultiSubFreqDiscriminator(nn.Module):
    """Three band discriminators over a random `batch_max_frames` window of
    each utterance (reference tacotron2.py:676-745): bands of `unfold_size`
    features at offsets 0, `unfold_step` and 2 * `unfold_step`, scored by
    the high, mid and low discriminators and returned low, mid, high, as
    the JAX model does."""

    def __init__(self, batch_max_frames: int = 50, unfold_size: int = 30,
                 unfold_step: int = 15, *, device=None, generator=None):
        super().__init__()
        self.batch_max_frames = batch_max_frames
        self.unfold_size = unfold_size
        self.unfold_step = unfold_step
        kw = dict(device=device, generator=generator)
        self.low_discriminator = SubFreqDiscriminator(**kw)
        self.mid_discriminator = SubFreqDiscriminator(**kw)
        self.high_discriminator = SubFreqDiscriminator(**kw)

    @classmethod
    def from_config(cls, params: dict, **kw) -> "MultiSubFreqDiscriminator":
        return cls(batch_max_frames=params.get("batch_max_frames", 50), **kw)

    def window_starts(self, lengths, *, generator=None):
        """(B,) int32 window starts, uniform in [0, max(length - F, 1)) as
        the JAX model draws them: every start is 0 where length <= F + 1."""
        u = torch.rand(lengths.shape, generator=generator,
                       device=lengths.device)
        max_start = torch.clamp(lengths - self.batch_max_frames, min=1)
        return (u * max_start).to(torch.int32)

    def slice_windows(self, x, starts):
        """(B, T, D) -> (B, F, D): F frames from each start, the last frame
        repeated past T."""
        T = x.shape[1]
        idx = starts.to(torch.int64)[:, None] + torch.arange(
            self.batch_max_frames, device=x.device)[None, :]
        idx = torch.clamp(idx, max=T - 1)
        return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))

    def forward(self, x, lengths, *, starts=None, generator=None):
        """x (B, T, D >= 2 * unfold_step + unfold_size) -> [low, mid, high]
        logit maps, on windows from `starts` or drawn from `generator`."""
        if starts is None:
            starts = self.window_starts(lengths, generator=generator)
        x = self.slice_windows(x, starts)
        s, z = self.unfold_step, self.unfold_size
        return [self.low_discriminator(x[:, :, 2 * s:2 * s + z]),
                self.mid_discriminator(x[:, :, s:s + z]),
                self.high_discriminator(x[:, :, 0:z])]
