"""B02 stage 1: wav.scp -> one HDF5 feature dump per utterance, with WORLD
features.

Counterpart of `svcc23_fastsvc_tpu/bin/preprocess_b02.py`. Per utterance:
optional silence trimming, resampling to 16 kHz and to the config's
sampling rate (host, `resample_poly`), F0 at `shiftms` on the target-rate
audio (Harvest on the host, or YIN on the device), WORLD analysis (mcep of
`mcep_dim` + 1, coded band aperiodicity, continuous log-F0, V/UV; device,
`dsp/world.py`), frame-rate A-weighted loudness at `hop_size` (device),
linguistic features at 10 ms on the 16 kHz audio (device: HuBERT-soft
units, or an 80-d log-mel), stretched x1.5 for 24 kHz targets, all trimmed
to a common frame count and written as wave / f0 / lf0 / vuv / ppg / mcep /
bap / lft (and spk_emb) datasets, the layout the JAX CLI writes and
`B02Dataset` reads.

The JAX arithmetic is kept, quirks included: WORLD frames sit
`int(sampling_rate * shiftms / 1000)` samples apart (`world_hop`), 159 at
taco2.yaml's shiftms 6.6666666666, while Harvest rounds its hop (160) and
loudness and the wave use hop_size (160).

    python -m svcc23_fastsvc_tpu_torch.bin.preprocess_b02 \
        --wav-scp data/train/wav.scp --dumpdir dump/train \
        --config conf/taco2.yaml --f0-config conf/f0.yaml \
        --spk-emb-file dump/spk_embs.h5 [--linguistic hubert \
        --hubert-checkpoint hubert-soft.pt] [--device cpu]
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
from ..dsp.world import world_analyze
from ..ops.resample import nearest_resize
from ..ops.stft import loudness_extract_frames
from ..train.checkpoint import _device
from .common import (
    disable_tf32,
    iter_wav_scp,
    resample,
    setup_logging,
    utt_speaker,
)
from .preprocess_fastsvc import logmel_extract


def world_hop(sampling_rate: int, shiftms: float) -> int:
    """Samples between WORLD frames: int(sr * shiftms / 1000), truncated
    as in the JAX CLI (159 at 24 kHz and shiftms 6.6666666666)."""
    return int(sampling_rate * shiftms / 1000)


def extract_b02_features(utt_id, audio, sr, cfg, *, f0min, f0max,
                         linguistic="logmel", ppg_model=None, device="cuda"):
    """The B02 feature bundle of one utterance (numpy f32): wave (T,),
    f0 / lf0 / vuv / lft (T', 1), ppg (T', C), mcep (T', mcep_dim + 1),
    bap (T', 3), T = T' * hop_size. `ppg_model` maps a 16 kHz tensor (T,)
    to units (1, T'', C) (a `HubertSoft`)."""
    if cfg.get("trim_silence"):
        from ..dsp.trim import trim_silence

        audio, _ = trim_silence(
            np.asarray(audio),
            top_db=cfg.get("trim_threshold_in_db", 60),
            frame_length=cfg.get("trim_frame_size", 2048),
            hop_length=cfg.get("trim_hop_size", 512),
        )
    device = _device(device)
    target_sr = cfg["sampling_rate"]
    hop = cfg["hop_size"]
    shiftms = cfg.get("shiftms", 160 / target_sr * 1000)
    audio16 = resample(audio, sr, 16000)
    audio_t = resample(audio, sr, target_sr)
    x_t = torch.as_tensor(audio_t, dtype=torch.float32, device=device)
    x16 = torch.as_tensor(audio16, dtype=torch.float32, device=device)

    f0_hop = world_hop(target_sr, shiftms)
    f0_method = cfg.get("f0_method", "harvest")
    if f0_method == "harvest":
        from ..dsp.harvest import harvest_f0

        f0 = harvest_f0(audio_t, fs=target_sr, f0_floor=f0min, f0_ceil=f0max,
                        frame_period_ms=shiftms).astype(np.float32)
    elif f0_method == "yin":
        f0 = yin_f0(x_t, sr=target_sr, hop=f0_hop, f0_floor=f0min,
                    f0_ceil=f0max).cpu().numpy()
    else:
        raise ValueError(f"unknown f0_method {f0_method!r}")

    mcep, bap, lf0, vuv = world_analyze(
        audio_t, f0, fs=target_sr, hop=f0_hop,
        mcep_order=cfg.get("mcep_dim", 59), device=device)
    with torch.inference_mode():
        lft = loudness_extract_frames(x_t, target_sr, hop)
        if linguistic == "hubert":
            if ppg_model is None:
                raise ValueError("--hubert-checkpoint required")
            ppg = ppg_model(x16)[0]
        elif linguistic == "logmel":
            ppg = logmel_extract(x16)
        else:
            raise ValueError(f"unknown linguistic extractor {linguistic!r}")
        if target_sr == 24000:
            ppg = nearest_resize(ppg[None], int(len(ppg) * 1.5), axis=1)[0]
        lft, ppg = lft.cpu().numpy(), ppg.cpu().numpy()

    f0, lf0, vuv, ppg, mcep, bap, lft = validate_length(
        [f0, lf0, vuv, ppg, mcep, bap, lft])
    n = len(f0)
    return {
        "wave": np.asarray(audio_t[:n * hop], np.float32),
        "f0": f0.astype(np.float32).reshape(-1, 1),
        "lf0": lf0.astype(np.float32).reshape(-1, 1),
        "vuv": vuv.astype(np.float32).reshape(-1, 1),
        "ppg": ppg.astype(np.float32),
        "mcep": mcep.astype(np.float32),
        "bap": bap.astype(np.float32),
        "lft": lft.astype(np.float32).reshape(-1, 1),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="B02 feature extraction")
    parser.add_argument("--wav-scp", "--scp", required=True)
    parser.add_argument("--dumpdir", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--f0-config", default=None,
                        help="per-speaker f0 yaml")
    parser.add_argument("--spk-emb-file", default=None,
                        help="spk_embs.h5 with per-speaker embeddings")
    parser.add_argument("--linguistic", default="logmel",
                        choices=["logmel", "hubert"])
    parser.add_argument("--hubert-checkpoint", default=None)
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
    if args.linguistic == "hubert":
        from ..models.hubert import load_hubert_soft

        ppg_model = load_hubert_soft(args.hubert_checkpoint, device=device)

    os.makedirs(args.dumpdir, exist_ok=True)
    n = 0
    for idx, (utt_id, audio, sr) in enumerate(iter_wav_scp(args.wav_scp)):
        if idx % args.n_shards != args.shard_id:
            continue
        spk = utt_speaker(utt_id)
        rng = f0_ranges.get(spk, {})
        feats = extract_b02_features(
            utt_id, audio, sr, cfg,
            f0min=rng.get("minf0", 100.0), f0max=rng.get("maxf0", 1000.0),
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
