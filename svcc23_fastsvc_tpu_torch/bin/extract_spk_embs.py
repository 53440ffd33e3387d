"""Stage 0: per-speaker embeddings -> one spk_embs.h5.

Counterpart of `svcc23_fastsvc_tpu/bin/extract_spk_embs.py`: the average
embedding of each speaker's utterances (the prefix of the utterance id
before the first underscore), written as a (1, dim) f32 dataset named
after the speaker. Modes:

  xvector : the x-vector TDNN (`models/xvector.py`) from a SpeechBrain
            `embedding_model.ckpt`, on --device (cuda by default; it raises
            without a GPU), each utterance resampled to 16 kHz on the host
  ingest  : the average of precomputed per-utterance embeddings (an h5
            with one dataset per utterance id)
  hash    : a deterministic unit vector seeded by the speaker id, for
            smoke tests and recipes without the checkpoint; not for real
            conversion quality

    python -m svcc23_fastsvc_tpu_torch.bin.extract_spk_embs \
        --wav-scp data/train/wav.scp --out-file dump/spk_embs.h5 \
        --mode xvector --checkpoint embedding_model.ckpt [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import logging
from collections import defaultdict

import numpy as np
import torch

from ..data.hdf5 import read_hdf5, write_hdf5
from .common import (
    disable_tf32,
    iter_wav_scp,
    read_wav_scp,
    resample,
    setup_logging,
    utt_speaker,
)


def hash_embedding(spk: str, dim: int = 512) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(spk.encode()).digest()[:8], "little")
    v = np.random.default_rng(seed).standard_normal(dim)
    return (v / np.linalg.norm(v)).astype(np.float32)


def speaker_embeddings(wav_scp: str, mode: str = "hash", *, dim: int = 512,
                       checkpoint: str = None, embeddings_file: str = None,
                       device="cuda") -> dict:
    """speaker id -> (dim,) f32 average embedding."""
    per_spk = defaultdict(list)
    if mode == "hash":
        for utt in read_wav_scp(wav_scp):
            spk = utt_speaker(utt)
            per_spk.setdefault(spk, [hash_embedding(spk, dim)])
    elif mode == "ingest":
        for utt in read_wav_scp(wav_scp):
            per_spk[utt_speaker(utt)].append(
                np.asarray(read_hdf5(embeddings_file, utt)).reshape(-1))
    elif mode == "xvector":
        from ..models.xvector import load_xvector_model

        model = load_xvector_model(checkpoint, device=device)
        dev = next(model.parameters()).device
        with torch.inference_mode():
            for utt, audio, sr in iter_wav_scp(wav_scp):
                wav = torch.as_tensor(resample(audio, sr, 16000),
                                      dtype=torch.float32, device=dev)
                per_spk[utt_speaker(utt)].append(
                    model.encode(wav)[0].cpu().numpy().reshape(-1))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return {spk: np.mean(np.stack(embs), axis=0).astype(np.float32)
            for spk, embs in per_spk.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Speaker embeddings")
    parser.add_argument("--wav-scp", required=True)
    parser.add_argument("--out-file", required=True, help="output spk_embs.h5")
    parser.add_argument("--mode", default="hash",
                        choices=["xvector", "ingest", "hash"])
    parser.add_argument("--checkpoint", default=None, help="x-vector weights")
    parser.add_argument("--embeddings-file", default=None,
                        help="ingest: h5 with per-utterance embeddings")
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)
    disable_tf32()
    embs = speaker_embeddings(
        args.wav_scp, args.mode, dim=args.dim, checkpoint=args.checkpoint,
        embeddings_file=args.embeddings_file, device=args.device)
    for spk, emb in embs.items():
        write_hdf5(args.out_file, spk, emb.reshape(1, -1))
    logging.info("wrote %d speaker embeddings -> %s", len(embs), args.out_file)


if __name__ == "__main__":
    main()
