"""Checkpoints in the reference trainer's `.pkl` layout.

A checkpoint is a `torch.save`d dict, as the reference trainer writes it
and `svcc23_fastsvc_tpu/bin/convert_checkpoint.py` reads it:

    {"model": {"generator": sd, "discriminator": sd},
     "optimizer": {"generator": ..., "discriminator": ...},
     "scheduler": {"generator": ..., "discriminator": ...},
     "steps": int}

State dicts carry the reference keys; the optimizer and scheduler entries
follow torch's optimizer and StepLR layouts (`train.state.RefRAdam`). A
training checkpoint also carries "rng": the excitation noise generator's
state and the batcher's numpy bit-generator state, so that `--resume`
continues bit for bit. A decode-only checkpoint holds the generator and
the steps alone. Orbax checkpoints of the JAX package are not read here:
convert them to this layout first.
"""

from __future__ import annotations

import os

import torch


def _cpu_state(module):
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def _write(path: str, obj: dict):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader never sees half a checkpoint


def load_generator_state(path: str):
    """(generator state dict, steps) from a reference-layout checkpoint."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["model"]["generator"], int(sd.get("steps", 0))


def _device(device):
    """`device` as a torch.device; raises for cuda without a CUDA device
    (no silent CPU fallback: the CPU is asked for with device="cpu")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("loading onto cuda needs a CUDA device; pass "
                           "device='cpu' to load onto the CPU")
    return device


def load_vocoder(path: str, cfg: dict, *, device="cuda", dtype=None):
    """(HN-uSFGAN generator, steps) from a reference-layout checkpoint: built
    from `cfg` (`config.build_vocoder`), weight norm folded, in eval mode on
    `device` with parameters in `dtype` (default f32)."""
    from ..config import build_vocoder

    device = _device(device)
    sd, steps = load_generator_state(path)
    wn = any(k.endswith(".weight_v") for k in sd)
    voc = build_vocoder(cfg, use_weight_norm=wn)
    voc.load_state_dict(sd)
    voc.fold_weight_norm_()
    voc.to(device=device, dtype=dtype or torch.float32).eval()
    return voc, steps


def load_acoustic_model(path: str, cfg: dict, *, device="cuda", dtype=None):
    """(B02 Tacotron2, steps) from a reference-layout checkpoint: built from
    `cfg` (`config.build_acoustic_model`), in eval mode on `device` with
    every floating tensor (batch-norm statistics too) in `dtype` (default
    f32). The reference wrapper's "acoustic_network." prefix is dropped, and
    so is its postnet, which its forward never calls."""
    from ..config import build_acoustic_model

    device = _device(device)
    sd, steps = load_generator_state(path)
    prefix = "acoustic_network."
    sd = {k[len(prefix):] if k.startswith(prefix) else k: v
          for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith("postnet.")}
    model = build_acoustic_model(cfg)
    model.load_state_dict(sd)
    model.to(device=device, dtype=dtype or torch.float32).eval()
    return model, steps


def save_generator_checkpoint(path: str, generator, steps: int):
    """Write `generator`'s weights in the reference layout (no optimizer)."""
    _write(path, {"model": {"generator": _cpu_state(generator)},
                  "steps": int(steps)})


def save_checkpoint(path: str, task, *, batcher_rng=None):
    """The whole training state of a `train.gan.FastSVCTrainTask`."""
    g_opt, d_opt = task.g_opt.state_dict(), task.d_opt.state_dict()
    rng = {"sine": task.rng.get_state() if task.rng is not None else None,
           "batcher": batcher_rng}
    _write(path, {
        "model": {"generator": _cpu_state(task.generator),
                  "discriminator": _cpu_state(task.discriminator)},
        "optimizer": {"generator": g_opt["optimizer"],
                      "discriminator": d_opt["optimizer"]},
        "scheduler": {"generator": g_opt["scheduler"],
                      "discriminator": d_opt["scheduler"]},
        "steps": int(task.step),
        "rng": rng,
    })


def load_checkpoint(path: str, task, *, params_only: bool = False):
    """Restore `task` from `path` and return the checkpoint's "rng" entry
    (None with `params_only`, which loads the weights and nothing else)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    task.generator.load_state_dict(sd["model"]["generator"])
    task.discriminator.load_state_dict(sd["model"]["discriminator"])
    if params_only:
        return None
    task.g_opt.load_state_dict(sd["optimizer"]["generator"],
                               sd["scheduler"]["generator"])
    task.d_opt.load_state_dict(sd["optimizer"]["discriminator"],
                               sd["scheduler"]["discriminator"])
    task.step = int(sd["steps"])
    rng = sd.get("rng") or {}
    if rng.get("sine") is not None and task.rng is not None:
        task.rng.set_state(rng["sine"])
    return rng


def checkpoint_path(outdir: str, steps: int) -> str:
    return os.path.join(outdir, f"checkpoint-{steps}steps.pkl")


def latest_checkpoint(outdir: str):
    """The checkpoint of the most steps under `outdir`, or None."""
    if not os.path.isdir(outdir):
        return None
    found = []
    for name in os.listdir(outdir):
        if name.startswith("checkpoint-") and name.endswith("steps.pkl"):
            try:
                found.append((int(name[len("checkpoint-"):-len("steps.pkl")]),
                              name))
            except ValueError:
                continue
    return os.path.join(outdir, max(found)[1]) if found else None
