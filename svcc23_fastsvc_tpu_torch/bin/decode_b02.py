"""B02 acoustic-model decode CLI on PyTorch (the recipe's stage 5).

Counterpart of `svcc23_fastsvc_tpu/bin/decode_b02.py`: load a Tacotron2
checkpoint (reference `.pkl` layout) and its config, and for every target
speaker shift each source utterance's F0 by whole semitones from the
speakers' mean log-F0 (relative to C4), pad it to `max_frames`, run the
free-running decoder and write an h5 bundle per utterance and speaker with
mcep, bap, lf0, lft, ppg, f0 and wave, which `bin/synthesize_b02.py` turns
into audio (stage 7).

    python -m svcc23_fastsvc_tpu_torch.bin.decode_b02 --dumpdir D \
        --checkpoint exp/checkpoint-50000steps.pkl --outdir out \
        --spk-emb-file E.h5 --f0-stats stats.yml --speakers SPK [SPK ...] \
        [--config exp/config.yml] [--infer-dtype bf16] [--device cuda]

The decode dtype is the flag, else the config's infer_dtype, else its
compute_dtype (the recipe's taco2.yaml: bf16), else f32; every floating
tensor of the model is cast, batch-norm statistics too. The prenet's
dropout is always on (a reference quirk): its masks are drawn from a
`torch.Generator` seeded with `--seed`.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import time

import numpy as np
import torch

from ..config import load_config, parse_compute_dtype
from ..data.dataset import B02Dataset
from ..data.hdf5 import read_hdf5, write_hdf5
from ..ops.conv import decide_conv_lowering
from ..train.checkpoint import load_acoustic_model
from .common import (
    disable_tf32,
    log_kernel_launches,
    setup_logging,
    utt_speaker,
)

_C4_HZ = 440.0 * 2 ** (3 / 12 - 1)
_C4_CENT = 4800.0


def semitone_shift(src_lf0_mean: float, tgt_lf0_mean: float) -> int:
    """Whole semitones from the source's to the target's mean log-F0
    (reference decode_b02.py:310-323)."""
    def cent(lf0_mean):
        return (1200 * math.log(math.exp(lf0_mean) / _C4_HZ) / math.log(2)
                + _C4_CENT)

    return round((cent(tgt_lf0_mean) - cent(src_lf0_mean)) / 100)


def decode_batch(model, ppg, lengths, lft, lf0, emb, *, generator_rng=None,
                 prenet_masks=None):
    """One padded batch, no file I/O: ppg (B, T, D), lengths (B,), lft and
    lf0 (B, T, 1), emb (B, S) on the model's device -> (B, T, output_dim +
    3) f32 mcep | bap. The inputs are cast to the model's dtype; the
    prenet's masks are `prenet_masks` or drawn from `generator_rng`."""
    dtype = next(model.parameters()).dtype
    with torch.inference_mode():
        y = model(ppg.to(dtype), lengths, lft.to(dtype), lf0.to(dtype),
                  emb.to(dtype), prenet_masks=prenet_masks,
                  generator=generator_rng)
    return y.float()


def decode_b02(dumpdir: str, checkpoint: str, outdir: str, *,
               spk_emb_file: str, f0_stats: dict, speakers,
               config_path: str = None, max_frames: int = 400,
               infer_dtype: str = None, device: str = "cuda", seed: int = 0):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decode on cuda needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    cfg = load_config(config_path or os.path.join(
        os.path.dirname(checkpoint), "config.yml"))
    dtype = parse_compute_dtype(
        infer_dtype or cfg.get("infer_dtype", cfg.get("compute_dtype")))
    model, steps = load_acoustic_model(checkpoint, cfg, device=device,
                                       dtype=dtype)
    logging.info("loaded B02 checkpoint step %d from %s (%s, %s; conv "
                 "lowering %s)", steps, checkpoint, device,
                 dtype or torch.float32, decide_conv_lowering(device))
    rng = torch.Generator(device=device).manual_seed(seed)
    ds = B02Dataset(dumpdir)
    os.makedirs(outdir, exist_ok=True)
    frames, wall = 0, 0.0
    for trgspk in speakers:
        emb = np.asarray(read_hdf5(spk_emb_file, trgspk),
                         np.float32).reshape(1, -1)
        for i in range(len(ds)):
            utt_id, wave, f0, ppg, lft, lf0, *_ = ds[i]
            shift = semitone_shift(f0_stats[utt_speaker(utt_id)]["lf0_mean"],
                                   f0_stats[trgspk]["lf0_mean"])
            ratio = 2.0 ** (shift / 12.0)
            lf0_c = np.asarray(lf0, np.float32).reshape(-1, 1) * ratio
            f0_c = np.asarray(f0, np.float32).reshape(-1, 1) * ratio
            lft = np.asarray(lft, np.float32).reshape(-1, 1)
            L = min(len(ppg), max_frames)
            padded = []
            for a in (ppg, lft, lf0_c):
                p = np.zeros((1, max_frames, a.shape[-1]), np.float32)
                p[0, :L] = a[:L]
                padded.append(torch.from_numpy(p).to(device))
            t0 = time.perf_counter()
            pred = decode_batch(
                model, padded[0], torch.tensor([L], device=device),
                padded[1], padded[2], torch.from_numpy(emb).to(device),
                generator_rng=rng)[0, :L].cpu().numpy()
            wall += time.perf_counter() - t0
            frames += max_frames
            out = os.path.join(outdir, f"{utt_id}_{trgspk}.h5")
            n = model.output_dim
            for name, data in (("mcep", pred[:, :n]), ("bap", pred[:, n:]),
                               ("lf0", lf0_c[:L]), ("lft", lft[:L]),
                               ("ppg", np.asarray(ppg)[:L]),
                               ("f0", f0_c[:L]),
                               ("wave", np.asarray(wave, np.float32))):
                write_hdf5(out, name, data)
    logging.info("decoded %d utterances x %d speakers -> %s (%.0f frames/s)",
                 len(ds), len(speakers), outdir, frames / max(wall, 1e-9))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Decode B02 (PyTorch)")
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="Tacotron2 checkpoint, reference .pkl layout")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--spk-emb-file", required=True)
    parser.add_argument("--f0-stats", required=True,
                        help="yaml with per-speaker lf0_mean/lf0_scale")
    parser.add_argument("--speakers", nargs="+", required=True)
    parser.add_argument("--config", default=None,
                        help="default: config.yml beside the checkpoint")
    parser.add_argument("--max-frames", type=int, default=400)
    parser.add_argument("--infer-dtype", default=None,
                        choices=[None, "f32", "float32", "bf16", "bfloat16"],
                        help="decode dtype (default: config infer_dtype, "
                             "else compute_dtype, else f32)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the prenet's dropout masks")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    disable_tf32()
    import yaml

    with open(args.f0_stats) as f:
        f0_stats = yaml.safe_load(f)
    decode_b02(args.dumpdir, args.checkpoint, args.outdir,
               spk_emb_file=args.spk_emb_file, f0_stats=f0_stats,
               speakers=args.speakers, config_path=args.config,
               max_frames=args.max_frames, infer_dtype=args.infer_dtype,
               device=args.device, seed=args.seed)
    log_kernel_launches()


if __name__ == "__main__":
    main()
