"""Shared CLI helpers: logging, TF32 off, deterministic cuDNN for
training, speaker ids, WAV input and output, wav.scp parsing, resampling.

WAV I/O is scipy's (PCM16/24/32 and float) and resampling is polyphase
(`scipy.signal.resample_poly`), as in `svcc23_fastsvc_tpu/bin/common.py`:
both stay on the host.
"""

from __future__ import annotations

import logging
from math import gcd
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from scipy.io import wavfile
from scipy.signal import resample_poly


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


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file to float64 in [-1, 1]."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data / (1 << 15)
    elif data.dtype == np.int32:
        data = data / (1 << 31)
    elif data.dtype == np.uint8:
        data = (data.astype(np.float64) - 128.0) / 128.0
    else:
        data = data.astype(np.float64)
    return np.asarray(data, dtype=np.float64), sr


def write_wav(path: str, audio, sr: int):
    """Write float audio in [-1, 1] as PCM16."""
    audio = np.asarray(audio, dtype=np.float64).squeeze()
    pcm = np.clip(audio, -1.0, 1.0 - 1.0 / (1 << 15))
    wavfile.write(path, sr, (pcm * (1 << 15)).astype(np.int16))


def read_wav_scp(path: str) -> Dict[str, str]:
    """Parse a Kaldi wav.scp (utt_id -> wav path); pipe entries raise."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt, wav = line.split(maxsplit=1)
            if wav.endswith("|"):
                raise ValueError(
                    "pipe-style wav.scp entries are not supported; "
                    f"got {wav!r}"
                )
            out[utt] = wav
    return out


def iter_wav_scp(path: str) -> Iterator[Tuple[str, np.ndarray, int]]:
    for utt, wav_path in read_wav_scp(path).items():
        audio, sr = read_wav(wav_path)
        yield utt, audio, sr


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling from sr to target_sr (the input when equal)."""
    if sr == target_sr:
        return audio
    g = gcd(sr, target_sr)
    return resample_poly(audio, target_sr // g, sr // g)


def utt_speaker(utt_id: str) -> str:
    """Speaker id convention: the prefix before the first underscore."""
    return utt_id.split("_")[0]


def summary_writer(logdir: str):
    """A tensorboardX SummaryWriter on `logdir`, or None with a warning
    where tensorboardX is not installed (scalars then go to the log
    only)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logging.warning("tensorboardX unavailable; scalar logging disabled")
        return None
    return SummaryWriter(logdir)
