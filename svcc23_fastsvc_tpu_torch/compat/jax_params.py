"""Carry FastSVC weights from the JAX package's layout to the port.

`generator_state_dict_from_jax` and `melgan_msd_state_dict_from_jax` are the
inverses of the JAX package's `compat/torch_weights.py::
convert_fastsvc_generator` and `convert_melgan_msd`: each takes a JAX param
pytree as numpy arrays, either in weight-norm form ({"v", "g", "b"} leaves,
WIO v) or folded ({"w", "b"}), and returns a state dict with the reference
torch keys that `models.fastsvc.FastSVCGenerator` or
`MelGANMultiScaleDiscriminator` loads (built with `use_weight_norm`
matching the form). No JAX import: the arrays only need `numpy.asarray`.
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
            pre = f"downsampling_{name}.{i}"
            _conv(sd, f"{pre}.residual_block.0", blk["res_conv"])
            _conv(sd, f"{pre}.downsample_block.2", blk["conv1"])
            _conv(sd, f"{pre}.downsample_block.4", blk["conv2"])
            _conv(sd, f"{pre}.downsample_block.6", blk["conv3"])
        for i, blk in enumerate(params[f"film_{name}"]):
            pre = f"film_{name}.{i}"
            for key in ("conv", "conv_scale", "conv_shift"):
                _conv(sd, f"{pre}.{key}", blk[key])
    _conv(sd, "conv_last", params["conv_last"])
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
