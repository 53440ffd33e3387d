"""YAML experiment config: load, dump, and build the models and the train task.

Counterpart of `svcc23_fastsvc_tpu/config.py` for the keys of the recipe's
conf/fastsvc.yaml that decode and training read, of
`svcc23_fastsvc_tpu/bin/synthesize_b02.py::build_vocoder` for the B02
vocoder's config.yml, and of `svcc23_fastsvc_tpu/bin/train_b02.py::
build_b02_task` for the B02 Tacotron2's (conf/taco2.yaml): the acoustic
model, its discriminator and its train task. The merged config is dumped
into the experiment dir as config.yml, which decode reads back.
`yaml` is imported only when a file is read or written, so the package
imports where PyYAML is missing.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import torch

DEFAULTS: Dict[str, Any] = {
    "sampling_rate": 16000,
    "hop_size": 160,
    "generator_type": "FastSVCGenerator",
    "generator_params": {},
    "discriminator_type": "MelGANMultiScaleDiscriminator",
    "discriminator_params": {},
    "stft_loss_params": {
        "fft_sizes": [2048, 1024, 512, 256, 128, 64],
        "hop_sizes": [512, 256, 128, 64, 32, 16],
        "win_lengths": [2048, 1024, 512, 256, 128, 64],
    },
    "lambda_adv": 2.5,
    "batch_size": 32,
    "batch_length": 16000,
    "signal_generator": {
        "sine_amp": 0.1,
        "noise_amp": 0.003,
        "signal_types": ["sine"],
    },
    "aux_context_window": 0,
    "generator_optimizer_params": {"lr": 1e-3, "eps": 1e-6,
                                   "weight_decay": 0.0},
    "generator_scheduler_params": {"step_size": 100000, "gamma": 0.5},
    "generator_grad_norm": 10,
    "discriminator_optimizer_params": {"lr": 1e-3, "eps": 1e-6,
                                       "weight_decay": 0.0},
    "discriminator_scheduler_params": {"step_size": 100000, "gamma": 0.5},
    "discriminator_grad_norm": 1,
    "generator_train_start_steps": 0,
    "discriminator_train_start_steps": 100000,
    "train_max_steps": 600000,
    "save_interval_steps": 50000,
    "eval_interval_steps": 5000,
    "log_interval_steps": 5000,
}


def load_config(path: Optional[str] = None) -> dict:
    cfg = copy.deepcopy(DEFAULTS)
    if path:
        import yaml

        with open(path) as f:
            cfg.update(yaml.safe_load(f) or {})
    return cfg


def dump_config(cfg: dict, outdir: str):
    import yaml

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "config.yml"), "w") as f:
        yaml.safe_dump(cfg, f)


def build_generator(cfg: dict, *, device=None, generator=None, **kw):
    """FastSVCGenerator from `generator_params`; extra keywords go to it."""
    from .models.fastsvc import FastSVCGenerator

    gtype = cfg.get("generator_type", "FastSVCGenerator")
    if gtype != "FastSVCGenerator":
        raise KeyError(f"unknown generator_type {gtype!r}")
    params = dict(cfg.get("generator_params", {}))
    for k in ("in_channels", "out_channels", "spk_emb_size", "use_spk_emb"):
        if k in params:
            kw[k] = params[k]
    for k in ("mid_channels", "upsampling_scales"):
        if k in params:
            kw[k] = tuple(params[k])
    return FastSVCGenerator(**kw, device=device, generator=generator)


def build_discriminator(cfg: dict, *, device=None, generator=None):
    """MelGANMultiScaleDiscriminator or HiFiGANMultiScaleMultiPeriod
    Discriminator (FastSVC), or MultiSubFreqDiscriminator (B02), from
    `discriminator_type` and `discriminator_params`."""
    from .models.fastsvc import (
        HiFiGANMultiScaleMultiPeriodDiscriminator,
        MelGANMultiScaleDiscriminator,
    )
    from .models.tacotron2 import MultiSubFreqDiscriminator

    dtype = cfg.get("discriminator_type", "MelGANMultiScaleDiscriminator")
    classes = {"MelGANMultiScaleDiscriminator": MelGANMultiScaleDiscriminator,
               "HiFiGANMultiScaleMultiPeriodDiscriminator":
                   HiFiGANMultiScaleMultiPeriodDiscriminator,
               "MultiSubFreqDiscriminator": MultiSubFreqDiscriminator}
    if dtype not in classes:
        raise KeyError(f"unknown discriminator_type {dtype!r}")
    return classes[dtype].from_config(
        cfg.get("discriminator_params", {}), device=device,
        generator=generator)


def build_signal_generator(cfg: dict):
    from .ops.signal_gen import SignalGenerator

    sg = cfg.get("signal_generator", {})
    return SignalGenerator(
        sample_rate=cfg.get("sampling_rate", 16000),
        hop_size=cfg.get("hop_size", 160),
        sine_amp=sg.get("sine_amp", 0.1),
        noise_amp=sg.get("noise_amp", 0.003),
        signal_types=tuple(sg.get("signal_types", ["sine"])),
        sine_f0_type=sg.get("sine_f0_type", "f0"),
    )


_VOCODER_NETS = {
    "harmonic_network_params": "harmonic_params",
    "noise_network_params": "noise_params",
    "filter_network_params": "filter_params",
}


def build_vocoder(cfg: dict, *, device=None, generator=None, **kw):
    """HNUSFGANGenerator from a vocoder config's `generator_params` (the
    reference's key names); extra keywords go to it. The dilation factors
    of the pipeline are frame-constant, so `pd_frame_hop` is `hop_size`."""
    from .models.hnusfgan import HNUSFGANGenerator

    gp = dict(cfg.get("generator_params", {}))
    for src, dst in _VOCODER_NETS.items():
        if src in gp:
            kw[dst] = gp[src]
    for k in ("residual_channels", "gate_channels", "skip_channels",
              "aux_channels", "aux_context_window", "out_channels"):
        if k in gp:
            kw[k] = gp[k]
    if "upsample_params" in gp:
        kw["upsample_scales"] = tuple(gp["upsample_params"]["upsample_scales"])
    kw["pd_frame_hop"] = cfg.get("hop_size", 0)
    return HNUSFGANGenerator(**kw, device=device, generator=generator)


# the Tacotron2 keys the JAX package's build_b02_task reads from
# generator_params; the rest stay at the model's defaults
_ACOUSTIC_KEYS = ("input_dim", "output_dim", "hidden_dim", "dec_layers",
                  "multi_speaker", "spk_emb_dim", "integrate_logf0",
                  "econv_chans", "prenet_dim")


def build_acoustic_model(cfg: dict, *, device=None, generator=None):
    """The B02 Tacotron2 from a config's `generator_params`."""
    from .models.tacotron2 import Tacotron2

    gp = cfg.get("generator_params", {})
    kw = {k: gp[k] for k in _ACOUSTIC_KEYS if k in gp}
    return Tacotron2(**kw, device=device, generator=generator)


def parse_compute_dtype(dtype_name):
    """'bfloat16'/'bf16' -> torch.bfloat16; None/'float32'/'f32' -> None."""
    if dtype_name in (None, "float32", "f32"):
        return None
    if dtype_name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise KeyError(f"unknown compute_dtype {dtype_name!r}")


def _optimizer(cfg: dict, who: str, params):
    from .train.state import RefRAdam

    opt = cfg.get(f"{who}_optimizer_params", {})
    sch = cfg.get(f"{who}_scheduler_params", {})
    return RefRAdam(
        params,
        lr=opt.get("lr", 1e-3),
        eps=opt.get("eps", 1e-6),
        weight_decay=opt.get("weight_decay", 0.0),
        grad_norm=cfg.get(f"{who}_grad_norm",
                          10 if who == "generator" else 1),
        scheduler_step_size=sch.get("step_size", 100000),
        scheduler_gamma=sch.get("gamma", 0.5),
    )


def build_train_task(cfg: dict, *, device="cuda", seed: int = 0):
    """G, D (weights from `seed`), their optimizers and the losses, on
    `device`. Params, optimizer state and losses are f32; `compute_dtype`
    bfloat16 runs the convs and matmuls in bf16 (FastSVCTrainTask)."""
    from .losses import MultiResolutionSTFTLoss
    from .train.gan import FastSVCTrainTask

    device = torch.device(device)
    init = torch.Generator().manual_seed(seed)
    gen = build_generator(cfg, generator=init).to(device)
    dis = build_discriminator(cfg, generator=init).to(device)
    stft = cfg.get("stft_loss_params", DEFAULTS["stft_loss_params"])
    return FastSVCTrainTask(
        generator=gen,
        discriminator=dis,
        g_opt=_optimizer(cfg, "generator", gen.parameters()),
        d_opt=_optimizer(cfg, "discriminator", dis.parameters()),
        signal_generator=build_signal_generator(cfg),
        stft_loss=MultiResolutionSTFTLoss(
            tuple(stft["fft_sizes"]), tuple(stft["hop_sizes"]),
            tuple(stft["win_lengths"])),
        lambda_adv=cfg.get("lambda_adv", 2.5),
        compute_dtype=parse_compute_dtype(cfg.get("compute_dtype")),
        rng=torch.Generator(device=device).manual_seed(seed + 1),
    )


def build_b02_task(cfg: dict, *, device="cuda", seed: int = 0):
    """The B02 acoustic model's train task, as the JAX package's
    `bin/train_b02.py::build_b02_task` builds it: the Tacotron2 from
    `generator_params` (`build_acoustic_model`) and the
    MultiSubFreqDiscriminator from `discriminator_params` (weights from
    `seed`), on `device`, with B02's own optimizer defaults (grad norm 1
    for both, no weight decay) and lambda_l1, lambda_adv 1. Params,
    optimizer state and losses are f32; `compute_dtype` bfloat16 runs the
    generator in bf16 (B02TrainTask)."""
    from .models.tacotron2 import MultiSubFreqDiscriminator
    from .train.b02 import B02TrainTask
    from .train.state import RefRAdam

    device = torch.device(device)
    init = torch.Generator().manual_seed(seed)
    gen = build_acoustic_model(cfg, generator=init).to(device)
    dis = MultiSubFreqDiscriminator.from_config(
        cfg.get("discriminator_params", {}), generator=init).to(device)

    def optimizer(who, params):
        opt = cfg.get(f"{who}_optimizer_params", {})
        sch = cfg.get(f"{who}_scheduler_params", {})
        return RefRAdam(params, lr=opt.get("lr", 1e-3),
                        eps=opt.get("eps", 1e-6),
                        grad_norm=cfg.get(f"{who}_grad_norm", 1),
                        scheduler_step_size=sch.get("step_size", 100000),
                        scheduler_gamma=sch.get("gamma", 0.5))

    return B02TrainTask(
        generator=gen,
        discriminator=dis,
        g_opt=optimizer("generator", gen.parameters()),
        d_opt=optimizer("discriminator", dis.parameters()),
        lambda_l1=cfg.get("lambda_l1", 1.0),
        lambda_adv=cfg.get("lambda_adv", 1.0),
        compute_dtype=parse_compute_dtype(cfg.get("compute_dtype")),
        rng=torch.Generator(device=device).manual_seed(seed + 1),
    )
