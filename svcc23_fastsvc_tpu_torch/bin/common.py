"""Shared CLI helpers: logging, TF32 off, deterministic cuDNN for
training, speaker ids, WAV output."""

from __future__ import annotations

import logging

import numpy as np
import torch
from scipy.io import wavfile


def setup_logging(verbose: int = 1):
    level = logging.WARNING if verbose <= 0 else (
        logging.INFO if verbose == 1 else logging.DEBUG
    )
    logging.basicConfig(
        level=level,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s",
        force=True,
    )


def disable_tf32():
    """Keep f32 matmuls and cuDNN convs in full f32 (PyTorch lets cuDNN use
    TF32 by default): the port's f32 contract. bf16 compute never uses
    TF32, so nothing is lost there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def deterministic_cudnn():
    """Use cuDNN's deterministic algorithms, as training does: its default
    ones sum in a run-dependent order, and two f32 steps from one state gave
    different G and D gradients on the H100 (the JAX step gives equal
    bits). Synthesis leaves cuDNN at its defaults."""
    torch.backends.cudnn.deterministic = True


def write_wav(path: str, audio, sr: int):
    """Write float audio in [-1, 1] as PCM16."""
    audio = np.asarray(audio, dtype=np.float64).squeeze()
    pcm = np.clip(audio, -1.0, 1.0 - 1.0 / (1 << 15))
    wavfile.write(path, sr, (pcm * (1 << 15)).astype(np.int16))


def utt_speaker(utt_id: str) -> str:
    """Speaker id convention: the prefix before the first underscore."""
    return utt_id.split("_")[0]
