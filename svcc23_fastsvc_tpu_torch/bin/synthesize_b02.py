"""B02 vocoder synthesis CLI on PyTorch (the recipe's stage 7).

Counterpart of `svcc23_fastsvc_tpu/bin/synthesize_b02.py`: load an
HN-uSFGAN checkpoint (reference `.pkl` layout) and its config, fold weight
norm, and for every decoded h5 bundle (wave, mcep, bap, f0) make the
excitation from the F0, the dilation factors, and the aux features
replication-padded by the context window, run the vocoder and write a
PCM16 wav. Logs the real-time factor and audio-seconds per second.

    python -m svcc23_fastsvc_tpu_torch.bin.synthesize_b02 --dumpdir D \
        --checkpoint voc/checkpoint-400000steps.pkl --outdir wav \
        [--config voc/config.yml] [--infer-dtype bf16] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ..config import parse_compute_dtype
from ..data.dataset import USFGANDataset
from ..ops.signal_gen import SignalGenerator
from ..train.checkpoint import load_vocoder
from .common import disable_tf32, setup_logging, write_wav


def read_config(path: str) -> dict:
    """The vocoder's config.yml as it stands (no FastSVC defaults)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def signal_generator(cfg: dict) -> SignalGenerator:
    """The excitation of the config's `signal_generator`; B02's default
    signal types are sine | noise."""
    sg = cfg.get("signal_generator", {})
    return SignalGenerator(
        sample_rate=cfg["sampling_rate"],
        hop_size=cfg["hop_size"],
        sine_amp=sg.get("sine_amp", 0.1),
        noise_amp=sg.get("noise_amp", 0.003),
        signal_types=tuple(sg.get("signal_types", ["sine", "noise"])),
        sine_f0_type=sg.get("sine_f0_type", "f0"),
    )


def vocode(vocoder, sig_gen, f0, aux, df, *, generator_rng):
    """One batch, no file I/O: f0 (B, T', 1) frame rate, aux (B, T' + 2 acw,
    A), df (B, T'*hop) on the vocoder's device -> (B, T'*hop, 1) f32 audio.
    The excitation is made in f32 and cast, with aux, to the vocoder's
    dtype; the dilation factors stay f32."""
    dtype = next(vocoder.parameters()).dtype
    with torch.inference_mode():
        x = sig_gen(f0.float(), generator_rng)
        y, _ = vocoder(x.to(dtype), aux.to(dtype), df.float())
    return y.float()


def synthesize_b02(dumpdir: str, checkpoint: str, outdir: str, *,
                   config_path: str = None, infer_dtype: str = None,
                   device: str = "cuda"):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("synthesis on cuda needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    cfg = read_config(config_path or os.path.join(
        os.path.dirname(checkpoint), "config.yml"))
    sr, hop = cfg["sampling_rate"], cfg["hop_size"]
    vocoder, steps = load_vocoder(checkpoint, cfg, device=device,
                                  dtype=parse_compute_dtype(infer_dtype))
    logging.info("loaded vocoder step %d from %s (%s, %s)", steps, checkpoint,
                 device, next(vocoder.parameters()).dtype)
    sig_gen = signal_generator(cfg)
    acw = cfg.get("aux_context_window", vocoder.aux_context_window)
    ds = USFGANDataset(dumpdir, sample_rate=sr, hop_size=hop,
                       dense_factor=cfg.get("dense_factor", 4))
    os.makedirs(outdir, exist_ok=True)
    total_audio, total_wall = 0.0, 0.0
    for i in range(len(ds)):
        utt_id, _, aux, df, f0 = ds[i]
        # replication pad by the context window (the reference's pad_fn)
        aux = np.concatenate([np.repeat(aux[:1], acw, 0), aux,
                              np.repeat(aux[-1:], acw, 0)], 0)
        t0 = time.perf_counter()
        y = vocode(
            vocoder, sig_gen,
            torch.from_numpy(np.asarray(f0, np.float32)).reshape(1, -1, 1)
            .to(device),
            torch.from_numpy(np.asarray(aux, np.float32))[None].to(device),
            torch.from_numpy(np.asarray(df, np.float32))[None].to(device),
            generator_rng=torch.Generator(device=device).manual_seed(i),
        )[0, :, 0].cpu().numpy()
        total_wall += time.perf_counter() - t0
        total_audio += len(y) / sr
        write_wav(os.path.join(outdir, f"{utt_id}_gen.wav"), y, sr)
    rtf = total_wall / max(total_audio, 1e-9)
    logging.info("synthesized %d utterances (RTF %.4f, %.0f audio-s/s)",
                 len(ds), rtf, total_audio / max(total_wall, 1e-9))
    return rtf


def main(argv=None):
    parser = argparse.ArgumentParser(description="Synthesize B02 (PyTorch)")
    parser.add_argument("--dumpdir", required=True,
                        help="decoded h5 bundles: wave, mcep, bap, f0")
    parser.add_argument("--checkpoint", required=True,
                        help="vocoder checkpoint, reference .pkl layout")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--config", default=None,
                        help="default: config.yml beside the checkpoint")
    parser.add_argument("--infer-dtype", default=None,
                        choices=[None, "f32", "float32", "bf16", "bfloat16"],
                        help="vocoder dtype (default f32); audio is "
                             "written from f32")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    disable_tf32()
    synthesize_b02(args.dumpdir, args.checkpoint, args.outdir,
                   config_path=args.config, infer_dtype=args.infer_dtype,
                   device=args.device)


if __name__ == "__main__":
    main()
