"""Any-to-any conversion (decode) CLI on PyTorch.

Counterpart of `svcc23_fastsvc_tpu/bin/decode_fastsvc.py`: load a generator
checkpoint (reference `.pkl` layout) and its config, fold weight norm, and
for every target speaker mean-shift the source F0 (std forced to 1), look up
the target x-vector, synthesize and write PCM16 wavs. Utterances are
bucketed by padded frame count and synthesized in batches; throughput is
logged as audio-seconds per second.

    python -m svcc23_fastsvc_tpu_torch.bin.decode_fastsvc --dumpdir D \
        --checkpoint exp/checkpoint-400000steps.pkl --outdir out \
        --f0-stats-dir F --spk-emb-file E.h5 [--infer-dtype bf16] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ..config import (
    build_generator,
    build_signal_generator,
    load_config,
    parse_compute_dtype,
)
from ..data.dataset import FastSVCDataset
from ..data.hdf5 import read_hdf5
from ..dsp.f0 import F0Statistics
from ..train.checkpoint import load_generator_state
from .common import disable_tf32, setup_logging, utt_speaker, write_wav


# utterances are padded to a multiple of this many frames and synthesized
# in batches of up to BATCH_SIZE per padded length, as the JAX CLI does
PAD_MULTIPLE = 100
BATCH_SIZE = 16


def load_f0_stats(path: str):
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f)
    return np.array([d["f0_mean"], d["f0_std"]])


def load_generator(checkpoint: str, cfg: dict, *, device, dtype=None):
    """Generator from a reference-layout checkpoint, weight norm folded, in
    eval mode on `device` with parameters in `dtype` (default f32)."""
    sd, steps = load_generator_state(checkpoint)
    wn = any(k.endswith(".weight_v") for k in sd)
    gen = build_generator(cfg, device="cpu", use_weight_norm=wn)
    gen.load_state_dict(sd)
    gen.fold_weight_norm_()
    gen.to(device=device, dtype=dtype or torch.float32).eval()
    return gen, steps


def synthesize(generator, sig_gen, ppg, f0, lft, emb, *, generator_rng):
    """Batched conversion core, no file I/O.

    ppg (B, T', C), f0 (B, T', 1), lft (B, T'*hop, 1), emb (B, S) on the
    generator's device -> (B, T'*hop, 1) f32 audio. The excitation is made
    in f32 and cast, with the other inputs, to the generator's dtype.
    """
    dtype = next(generator.parameters()).dtype
    with torch.inference_mode():
        sine = sig_gen(f0.float(), generator_rng)
        y = generator(ppg.to(dtype), sine.to(dtype), lft.to(dtype),
                      emb.to(dtype), fuse_film=True)
    return y.float()


def decode(
    dumpdir: str,
    checkpoint: str,
    outdir: str,
    *,
    f0_stats_dir: str,
    spk_emb_file: str,
    convert_to_speakers=None,
    config_path: str = None,
    infer_dtype: str = None,
    device: str = "cuda",
):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decode on cuda needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    cfg = load_config(config_path or os.path.join(
        os.path.dirname(checkpoint), "config.yml"))
    sr, hop = cfg["sampling_rate"], cfg["hop_size"]
    # synthesis dtype: the flag, else the config's infer_dtype, else its
    # training compute_dtype, else f32; audio is written from f32
    idt = parse_compute_dtype(
        infer_dtype or cfg.get("infer_dtype", cfg.get("compute_dtype")))
    generator, steps = load_generator(checkpoint, cfg, device=device, dtype=idt)
    logging.info("loaded checkpoint step %d from %s (%s, %s)", steps,
                 checkpoint, device, idt or torch.float32)
    sig_gen = build_signal_generator(cfg)
    rng = torch.Generator(device=device).manual_seed(0)

    ds = FastSVCDataset(dumpdir)
    stats = F0Statistics()
    speakers = convert_to_speakers or cfg.get("convert_to_speakers", [])
    os.makedirs(outdir, exist_ok=True)
    total_audio_s, total_wall = 0.0, 0.0
    for trgspk in speakers:
        trg_emb = np.asarray(read_hdf5(spk_emb_file, trgspk),
                             np.float32).reshape(-1)
        trg_stats = load_f0_stats(os.path.join(f0_stats_dir, f"{trgspk}.yml"))
        trg_stats[1] = 1.0  # mean-only shift

        buckets: dict = {}
        for i in range(len(ds)):
            utt_id, _, f0, ppg, lft, _ = ds[i]
            Tf = len(ppg)
            Tp = ((Tf + PAD_MULTIPLE - 1) // PAD_MULTIPLE) * PAD_MULTIPLE
            buckets.setdefault(Tp, []).append((utt_id, f0, ppg, lft, Tf))

        for Tp, items in sorted(buckets.items()):
            for start in range(0, len(items), BATCH_SIZE):
                chunk = items[start:start + BATCH_SIZE]
                Bc = len(chunk)
                D = chunk[0][2].shape[-1]
                ppg_p = np.zeros((Bc, Tp, D), np.float32)
                f0_p = np.zeros((Bc, Tp, 1), np.float32)
                lft_p = np.zeros((Bc, Tp * hop, 1), np.float32)
                for bi, (utt_id, f0, ppg, lft, Tf) in enumerate(chunk):
                    src_stats = load_f0_stats(os.path.join(
                        f0_stats_dir, f"{utt_speaker(utt_id)}.yml"))
                    src_stats[1] = 1.0
                    ppg_p[bi, :Tf] = ppg
                    f0_p[bi, :Tf, 0] = stats.convert(
                        np.asarray(f0).squeeze(), src_stats, trg_stats)
                    lft_p[bi, :Tf * hop, 0] = np.asarray(lft).squeeze()[:Tf * hop]
                emb_p = np.broadcast_to(trg_emb, (Bc, trg_emb.shape[0])).copy()

                t0 = time.perf_counter()
                y = synthesize(
                    generator, sig_gen,
                    *(torch.from_numpy(a).to(device)
                      for a in (ppg_p, f0_p, lft_p, emb_p)),
                    generator_rng=rng,
                ).cpu().numpy()
                total_wall += time.perf_counter() - t0
                for bi, (utt_id, _, _, _, Tf) in enumerate(chunk):
                    out = y[bi, :Tf * hop, 0]
                    total_audio_s += len(out) / sr
                    write_wav(os.path.join(outdir, f"{utt_id}_to_{trgspk}.wav"),
                              out, sr)
    rtf = total_wall / max(total_audio_s, 1e-9)
    logging.info(
        "decoded %.1f audio-s in %.2f s (RTF %.4f, %.0f audio-s/s)",
        total_audio_s, total_wall, rtf, total_audio_s / max(total_wall, 1e-9),
    )
    return rtf


def main(argv=None):
    parser = argparse.ArgumentParser(description="Decode FastSVC (PyTorch)")
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="generator checkpoint, reference .pkl layout")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--f0-stats-dir", required=True)
    parser.add_argument("--spk-emb-file", required=True)
    parser.add_argument("--speakers", nargs="*", default=None)
    parser.add_argument("--config", default=None,
                        help="default: config.yml beside the checkpoint")
    parser.add_argument("--infer-dtype", default=None,
                        choices=[None, "f32", "float32", "bf16", "bfloat16"],
                        help="synthesis dtype (default: the config's "
                             "infer_dtype, else its compute_dtype, else f32)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    disable_tf32()
    decode(
        args.dumpdir, args.checkpoint, args.outdir,
        f0_stats_dir=args.f0_stats_dir, spk_emb_file=args.spk_emb_file,
        convert_to_speakers=args.speakers, config_path=args.config,
        infer_dtype=args.infer_dtype, device=args.device,
    )


if __name__ == "__main__":
    main()
