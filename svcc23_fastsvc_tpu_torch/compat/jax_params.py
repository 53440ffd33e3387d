"""Carry weights from the JAX package's layout to the port.

`generator_state_dict_from_jax`, `melgan_msd_state_dict_from_jax`,
`hnusfgan_state_dict_from_jax`, `tacotron2_state_dict_from_jax` and
`subfreq_discriminator_state_dict_from_jax` are the inverses of the JAX
package's `compat/torch_weights.py::convert_fastsvc_generator`,
`convert_melgan_msd`, `convert_hnusfgan`, `convert_tacotron2` and
`convert_subfreq_discriminator`, and `conformer_ppg_state_dict_from_jax`
and `xvector_state_dict_from_jax` those of `models/conformer_ppg.py::
convert_ppg_state_dict` and `models/xvector.py::
convert_xvector_state_dict`; `downsample_block_state_dict_from_jax`
carries one of the generator's DownsampleBlocks. Each takes a JAX param
pytree as numpy arrays, either in weight-norm form ({"v", "g", "b"} leaves,
WIO v) or folded ({"w", "b"}), and returns a state dict with the reference
torch keys that `models.fastsvc.FastSVCGenerator`, `DownsampleBlock`,
`MelGANMultiScaleDiscriminator`, `models.hnusfgan.HNUSFGANGenerator`,
`models.tacotron2.Tacotron2`, `MultiSubFreqDiscriminator`,
`models.conformer_ppg.ConformerPPG` or `models.xvector.XVector` loads
(built with `use_weight_norm` matching the form). No JAX import: the arrays only
need `numpy.asarray`.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _conv(sd, prefix, p):
    if "v" in p:
        v = np.asarray(p["v"])
        sd[f"{prefix}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
        sd[f"{prefix}.weight_v"] = _t(v.transpose(2, 1, 0))
    else:
        sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).transpose(2, 1, 0))
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def generator_state_dict_from_jax(params) -> dict:
    """JAX FastSVCGenerator params -> the port's `state_dict`."""
    sd = {}
    for i, blk in enumerate(params["up"]):
        pre = f"upsampling_nets.{i}"
        _conv(sd, f"{pre}.conv_first", blk["conv_first"])
        _conv(sd, f"{pre}.upsample_block0.2", blk["up_conv"])
        _conv(sd, f"{pre}.conv_block1.1", blk["conv1"])
        _conv(sd, f"{pre}.conv_block2.1", blk["conv2"])
        _conv(sd, f"{pre}.conv_block3.1", blk["conv3"])
        _conv(sd, f"{pre}.residual_block.1", blk["res_conv"])
        if "emb_projector" in blk:
            ep = blk["emb_projector"]
            sd[f"{pre}.emb_projector.weight"] = _t(np.asarray(ep["w"]).T)
            sd[f"{pre}.emb_projector.bias"] = _t(ep["b"])
    for name in ("lft", "sine"):
        for i, blk in enumerate(params[f"down_{name}"]):
            sd.update(downsample_block_state_dict_from_jax(
                blk, prefix=f"downsampling_{name}.{i}."))
        for i, blk in enumerate(params[f"film_{name}"]):
            pre = f"film_{name}.{i}"
            for key in ("conv", "conv_scale", "conv_shift"):
                _conv(sd, f"{pre}.{key}", blk[key])
    _conv(sd, "conv_last", params["conv_last"])
    return sd


def downsample_block_state_dict_from_jax(params, prefix: str = "") -> dict:
    """JAX DownsampleBlock params -> the port's `DownsampleBlock`
    `state_dict` (keys under `prefix`)."""
    sd = {}
    _conv(sd, f"{prefix}residual_block.0", params["res_conv"])
    _conv(sd, f"{prefix}downsample_block.2", params["conv1"])
    _conv(sd, f"{prefix}downsample_block.4", params["conv2"])
    _conv(sd, f"{prefix}downsample_block.6", params["conv3"])
    return sd


def melgan_msd_state_dict_from_jax(params) -> dict:
    """JAX MelGANMultiScaleDiscriminator params -> the port's `state_dict`."""
    sd = {}
    for i, disc in enumerate(params["discriminators"]):
        last = len(disc["layers"]) - 1
        for j, p in enumerate(disc["layers"]):
            base = f"discriminators.{i}.layers.{j}"
            # layer 0 sits after its ReflectionPad1d; the last is bare
            _conv(sd, f"{base}.1" if j == 0 else base if j == last
                  else f"{base}.0", p)
    return sd


def _time_conv2d(sd, prefix, p):
    """A WIO (2s+1, 1, 1) time kernel as the reference's Conv2d weight
    (1, 1, 1, 2s+1)."""
    if "v" in p:
        sd[f"{prefix}.weight_g"] = _t(np.asarray(p["g"]).reshape(1, 1, 1, 1))
        sd[f"{prefix}.weight_v"] = _t(np.asarray(p["v"]).reshape(1, 1, 1, -1))
    else:
        sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).reshape(1, 1, 1, -1))


_BLOCK_KEYS = {"convP": "convP", "convC": "convC", "convF": "convF",
               "conv": "conv", "aux": "conv1x1_aux", "out": "conv1x1_out",
               "skip": "conv1x1_skip"}


def hnusfgan_state_dict_from_jax(params) -> dict:
    """JAX HNUSFGANGenerator params -> the port's `state_dict`."""
    sd = {}
    _conv(sd, "conv_first_sine", params["conv_first_sine"])
    _conv(sd, "conv_first_noise", params["conv_first_noise"])
    up = params["upsample"]
    _conv(sd, "upsample_net.conv_in", up["conv_in"])
    for i, p in enumerate(up["up_convs"]):
        _time_conv2d(sd, f"upsample_net.upsample.up_layers.{2 * i + 1}", p)
    for net in ("harmonic", "noise", "filter"):
        for i, blk in enumerate(params[net]["blocks"]):
            for key, p in blk.items():
                _conv(sd, f"{net}_network.conv_dilated.{i}.{_BLOCK_KEYS[key]}",
                      p)
    for i, p in enumerate(params["periodicity"]["layers"]):
        _conv(sd, f"periodicity_estimator.layers.{2 * i}", p)
    _conv(sd, "conv_last.1", params["last1"])
    _conv(sd, "conv_last.3", params["last2"])
    return sd


def _linear_sd(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _cell_sd(sd, prefix, p, suffix=""):
    for name in ("ih", "hh"):
        sd[f"{prefix}.weight_{name}{suffix}"] = _t(np.asarray(p[f"w_{name}"]).T)
        sd[f"{prefix}.bias_{name}{suffix}"] = _t(p[f"b_{name}"])


def _bn_sd(sd, prefix, p):
    for key, name in (("w", "weight"), ("b", "bias"), ("mean", "running_mean"),
                      ("var", "running_var")):
        sd[f"{prefix}.{name}"] = _t(p[key])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def tacotron2_state_dict_from_jax(params) -> dict:
    """JAX Tacotron2 params (batch-norm running statistics included) -> the
    port's `state_dict`."""
    sd = {}
    enc = params["encoder"]
    _linear_sd(sd, "encoder.input_layer", enc["input_layer"])
    for i, cp in enumerate(enc["convs"]):
        _conv(sd, f"encoder.convs.{i}.0", cp["conv"])
        _bn_sd(sd, f"encoder.convs.{i}.1", cp["bn"])
    _cell_sd(sd, "encoder.blstm", enc["blstm"]["fwd"], "_l0")
    _cell_sd(sd, "encoder.blstm", enc["blstm"]["bwd"], "_l0_reverse")
    for i, lp in enumerate(params["prenet"]):
        _linear_sd(sd, f"prenet.prenet.{i}.0", lp)
    for i, dp in enumerate(params["decs"]):
        _cell_sd(sd, f"decs.{i}.cell", dp["cell"])
        _linear_sd(sd, f"decs.{i}.pj", dp["pj"])
    _linear_sd(sd, "proj", params["proj"])
    bap = params["bap_decoder"]
    for j, key in ((0, "conv0"), (3, "conv1"), (6, "conv2"), (9, "conv3")):
        _conv(sd, f"bap_decoder.{j}", bap[key])
    _bn_sd(sd, "bap_decoder.10", bap["bn"])
    for name in ("logf0", "lft"):
        if f"{name}_film" in params:
            for key, p in params[f"{name}_film"].items():
                _conv(sd, f"{name}_film_net.{key}", p)
    if "spk_emb_projection" in params:
        _linear_sd(sd, "spk_emb_projection", params["spk_emb_projection"])
    return sd


def subfreq_discriminator_state_dict_from_jax(params) -> dict:
    """JAX MultiSubFreqDiscriminator params -> the port's `state_dict`:
    HWIO conv2d weights as torch's (O, I, kh, kw); each band's convs under
    `{band}_discriminator.layers.j.0` but the last, a bare conv at
    `layers.j`."""
    sd = {}
    for band in ("low", "mid", "high"):
        layers = params[band]["layers"]
        for j, p in enumerate(layers):
            pre = f"{band}_discriminator.layers.{j}"
            if j < len(layers) - 1:
                pre += ".0"
            sd[f"{pre}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
            if "b" in p:
                sd[f"{pre}.bias"] = _t(p["b"])
    return sd


def conformer_ppg_state_dict_from_jax(params) -> dict:
    """JAX ConformerPPG params -> the reference (and the port's) state
    dict under "encoder.": the inverse of JAX `convert_ppg_state_dict`.
    HWIO conv2d weights become (O, I, kh, kw), WIO conv1d weights
    (O, I, K), linear weights (out, in)."""
    sd = {}
    emb = params["embed"]
    for j, key in ((0, "conv0"), (2, "conv2")):
        p = emb[key]
        sd[f"encoder.embed.conv.{j}.weight"] = _t(
            np.asarray(p["w"]).transpose(3, 2, 0, 1))
        sd[f"encoder.embed.conv.{j}.bias"] = _t(p["b"])
    _linear_sd(sd, "encoder.embed.out.0", emb["out"])
    for i, bp in enumerate(params["blocks"]):
        pre = f"encoder.encoders.{i}"
        for name, key in (("feed_forward_macaron", "ff_macaron"),
                          ("feed_forward", "ff")):
            for w in ("w_1", "w_2"):
                _linear_sd(sd, f"{pre}.{name}.{w}", bp[key][w])
        att = bp["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out",
                     "linear_pos"):
            _linear_sd(sd, f"{pre}.self_attn.{name}", att[name])
        for name in ("pos_bias_u", "pos_bias_v"):
            sd[f"{pre}.self_attn.{name}"] = _t(att[name])
        cv = bp["conv"]
        for name, key in (("pointwise_conv1", "pw1"),
                          ("depthwise_conv", "dw"),
                          ("pointwise_conv2", "pw2")):
            _conv(sd, f"{pre}.conv_module.{name}", cv[key])
        _bn_sd(sd, f"{pre}.conv_module.norm", cv["bn"])
        for name in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff",
                     "norm_final"):
            sd[f"{pre}.{name}.weight"] = _t(bp[name]["w"])
            sd[f"{pre}.{name}.bias"] = _t(bp[name]["b"])
    sd["encoder.after_norm.weight"] = _t(params["after_norm"]["w"])
    sd["encoder.after_norm.bias"] = _t(params["after_norm"]["b"])
    return sd


def xvector_state_dict_from_jax(params) -> dict:
    """JAX XVector params -> SpeechBrain's (and the port's) state dict:
    the inverse of JAX `convert_xvector_state_dict`."""
    sd = {}
    for i, bp in enumerate(params["blocks"]):
        _conv(sd, f"blocks.{3 * i}.conv", bp["conv"])
        _bn_sd(sd, f"blocks.{3 * i + 2}.norm", bp["bn"])
    _linear_sd(sd, f"blocks.{3 * len(params['blocks']) + 1}.w", params["fc"])
    return sd
