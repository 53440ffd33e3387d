"""Objective evaluation: mel L1 and MCD between two wav sets.

Counterpart of `svcc23_fastsvc_tpu/bin/evaluate.py`: hypotheses are paired
with references by utterance id (equal stems, or one a prefix of the
other), both resampled to `--sr` on the host, and `utils/metrics.py` runs
on `--device` (cuda raises without a CUDA device). Prints one JSON line:
mel_l1_mean, mcd_mean (dB), n_pairs and the per-utterance values.

    python -m svcc23_fastsvc_tpu_torch.bin.evaluate --ref-dir wav/ref \
        --hyp-dir exp/wav [--sr 16000] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..train.checkpoint import _device
from ..utils.metrics import mel_l1, wav_mcd
from .common import disable_tf32, read_wav, resample, setup_logging


def pair_metrics(ref, ref_sr: int, hyp, hyp_sr: int, *, sr: int = 16000,
                 device="cuda"):
    """(mel L1, MCD in dB) of one pair of numpy waveforms, each resampled
    to sr on the host."""
    xa, xb = (torch.as_tensor(resample(a, s, sr), dtype=torch.float32,
                              device=device)
              for a, s in ((ref, ref_sr), (hyp, hyp_sr)))
    with torch.inference_mode():
        return (float(mel_l1(xa, xb, sr=sr)), float(wav_mcd(xa, xb, sr=sr)))


def evaluate_dirs(ref_dir: str, hyp_dir: str, *, sr: int = 16000,
                  device="cuda"):
    device = _device(device)
    refs = {
        os.path.splitext(f)[0]: os.path.join(ref_dir, f)
        for f in os.listdir(ref_dir) if f.endswith(".wav")
    }
    results, mcds = {}, {}
    for f in sorted(os.listdir(hyp_dir)):
        if not f.endswith(".wav"):
            continue
        stem = os.path.splitext(f)[0]
        match = next((r for r in refs if stem == r or stem.startswith(r)
                      or r.startswith(stem)), None)
        if match is None:
            continue
        results[stem], mcds[stem] = pair_metrics(
            *read_wav(refs[match]), *read_wav(os.path.join(hyp_dir, f)),
            sr=sr, device=device)
    return {
        "mel_l1_mean": (float(np.mean(list(results.values())))
                        if results else float("nan")),
        "mcd_mean": float(np.mean(list(mcds.values()))) if mcds else
        float("nan"),
        "n_pairs": len(results),
        "per_utt": results,
        "per_utt_mcd": mcds,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="mel L1 and MCD")
    parser.add_argument("--ref-dir", required=True)
    parser.add_argument("--hyp-dir", required=True)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    disable_tf32()
    out = evaluate_dirs(args.ref_dir, args.hyp_dir, sr=args.sr,
                        device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
