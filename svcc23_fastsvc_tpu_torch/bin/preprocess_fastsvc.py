"""Stage 1: wav.scp -> one HDF5 feature dump per utterance.

Counterpart of `svcc23_fastsvc_tpu/bin/preprocess_fastsvc.py`. Per
utterance: optional silence trimming, resampling to 16 kHz and to the
config's sampling rate (host, `resample_poly`), F0 at 10 ms on the 16 kHz
audio (Harvest on the host, or YIN on the device), A-weighted loudness at
sample rate (device), linguistic features at 10 ms on the 16 kHz audio
(device: the conformer PPG, or an 80-d log-mel), the PPG stretched x1.5
for 24 kHz targets, all trimmed to a common length and written as
wave / f0 / ppg / lft (and spk_emb) datasets, the layout the JAX CLI
writes and `FastSVCDataset` reads.

    python -m svcc23_fastsvc_tpu_torch.bin.preprocess_fastsvc \
        --wav-scp data/train/wav.scp --dumpdir dump/train/raw \
        --config conf/fastsvc.yaml --f0-config conf/f0.yaml \
        --spk-emb-file dump/spk_embs.h5 [--linguistic conformer \
        --ppg-checkpoint 24epoch.pth] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..config import load_config
from ..data.dataset import validate_length
from ..data.hdf5 import read_hdf5, write_hdf5
from ..dsp.f0 import yin_f0
from ..ops.resample import nearest_resize
from ..ops.stft import loudness_extract, mel_filterbank, stft_magnitude
from ..train.checkpoint import _device
from .common import (
    disable_tf32,
    iter_wav_scp,
    resample,
    setup_logging,
    utt_speaker,
)


def logmel_extract(audio16k, *, n_mels=80, n_fft=1024, hop=160):
    """10 ms-hop 80-d log-mel linguistic features (T', n_mels) of a 16 kHz
    tensor (T,): Hann window of 800, the recipe's stand-in for PPGs."""
    power = stft_magnitude(audio16k, n_fft, hop, 800, power=True,
                           clamp_min=0.0)
    mel = power @ mel_filterbank(16000, n_fft, n_mels, dtype=power.dtype,
                                 device=power.device)
    return torch.log(torch.clamp(mel, min=1e-10))


def extract_features(
    utt_id: str,
    audio,
    sr: int,
    cfg: dict,
    *,
    f0min: float,
    f0max: float,
    linguistic: str = "logmel",
    ppg_model=None,
    device="cuda",
):
    """The FastSVC feature bundle of one utterance (numpy f32 arrays):
    wave (T,), f0 (T',), ppg (T', C), lft (T,), T = T' * hop_size."""
    if cfg.get("trim_silence"):
        from ..dsp.trim import trim_silence

        audio, _ = trim_silence(
            np.asarray(audio),
            top_db=cfg.get("trim_threshold_in_db", 60),
            frame_length=cfg.get("trim_frame_size", 2048),
            hop_length=cfg.get("trim_hop_size", 512),
        )
    device = torch.device(device)
    target_sr = cfg["sampling_rate"]
    hop = cfg["hop_size"]
    audio16 = resample(audio, sr, 16000)
    audio_t = resample(audio, sr, target_sr)
    x16 = torch.as_tensor(audio16, dtype=torch.float32, device=device)

    # F0 at the PPG frame rate (shiftms on the 16 kHz audio)
    shiftms = cfg.get("shiftms", 10)
    f0_method = cfg.get("f0_method", "harvest")
    if f0_method == "harvest":
        from ..dsp.harvest import harvest_f0

        f0 = harvest_f0(audio16, fs=16000, f0_floor=f0min, f0_ceil=f0max,
                        frame_period_ms=shiftms).astype(np.float32)
    elif f0_method == "yin":
        f0 = yin_f0(x16, sr=16000, hop=int(16000 * shiftms / 1000),
                    f0_floor=f0min, f0_ceil=f0max).cpu().numpy()
    else:
        raise ValueError(f"unknown f0_method {f0_method!r}")

    with torch.inference_mode():
        # A-weighted loudness at sample rate
        lft = loudness_extract(
            torch.as_tensor(audio_t, dtype=torch.float32, device=device),
            target_sr, cfg.get("lft_hop_size", 64))
        # linguistic features at 10 ms on the 16 kHz audio
        if linguistic == "conformer":
            if ppg_model is None:
                raise ValueError("--ppg-checkpoint required for conformer "
                                 "features")
            ppg = ppg_model(x16)[0]
        elif linguistic == "logmel":
            ppg = logmel_extract(x16)
        else:
            raise ValueError(f"unknown linguistic extractor {linguistic!r}")
        # 24 kHz targets stretch the PPG x1.5
        if target_sr == 24000:
            ppg = nearest_resize(ppg[None], int(len(ppg) * 1.5), axis=1)[0]
        lft, ppg = lft.cpu().numpy(), ppg.cpu().numpy()

    # frame-rate features to common frames, sample-rate ones to hop x frames
    f0, ppg, audio_al, lft_al = validate_length([f0, ppg], [audio_t, lft], hop)
    return {
        "wave": audio_al.astype(np.float32),
        "f0": np.asarray(f0, np.float32),
        "ppg": np.asarray(ppg, np.float32),
        "lft": lft_al.astype(np.float32),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="FastSVC feature extraction")
    parser.add_argument("--wav-scp", "--scp", required=True)
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--f0-config", default=None, help="per-speaker f0 yaml")
    parser.add_argument("--spk-emb-file", default=None,
                        help="spk_embs.h5 with per-speaker embeddings")
    parser.add_argument("--linguistic", default="logmel",
                        choices=["logmel", "conformer"])
    parser.add_argument("--ppg-checkpoint", default=None)
    parser.add_argument("--n-shards", type=int, default=1,
                        help="split the scp across N processes")
    parser.add_argument("--shard-id", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    disable_tf32()
    device = _device(args.device)

    cfg = load_config(args.config)
    f0_ranges = {}
    if args.f0_config:
        import yaml

        with open(args.f0_config) as f:
            f0_ranges = yaml.safe_load(f) or {}

    ppg_model = None
    if args.linguistic == "conformer":
        from ..models.conformer_ppg import load_ppg_model

        ppg_model = load_ppg_model(args.ppg_checkpoint, device=device)

    os.makedirs(args.dumpdir, exist_ok=True)
    n = 0
    for idx, (utt_id, audio, sr) in enumerate(iter_wav_scp(args.wav_scp)):
        if idx % args.n_shards != args.shard_id:
            continue
        spk = utt_speaker(utt_id)
        rng = f0_ranges.get(spk, {})
        feats = extract_features(
            utt_id, audio, sr, cfg,
            f0min=rng.get("minf0", 70.0), f0max=rng.get("maxf0", 340.0),
            linguistic=args.linguistic, ppg_model=ppg_model, device=device,
        )
        if args.spk_emb_file:
            feats["spk_emb"] = np.asarray(
                read_hdf5(args.spk_emb_file, spk), np.float32).reshape(1, -1)
        out = os.path.join(args.dumpdir, f"{utt_id}.h5")
        for name, arr in feats.items():
            write_hdf5(out, name, arr)
        n += 1
    logging.info("processed %d utterances -> %s", n, args.dumpdir)


if __name__ == "__main__":
    main()
