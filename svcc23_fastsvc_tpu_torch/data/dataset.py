"""Utterance datasets over a dump directory of .h5 feature files.

Counterparts of `svcc23_fastsvc_tpu/data/dataset.py`'s `FastSVCDataset`
(per utterance: utt_id, wave (T,), f0 (T',), ppg (T', C), lft (T,),
spk_emb (1, S)), `USFGANDataset` (the B02 vocoder's: utt_id, wave,
aux = mcep | bap, sample-rate dilation factors, f0) and `B02Dataset` (the
B02 acoustic model's fields).
"""

from __future__ import annotations

import fnmatch
import os
from typing import List, Optional

import numpy as np

from .hdf5 import read_hdf5


def find_files(root_dir: str) -> List[str]:
    """Recursively collect the .h5 files under root_dir, sorted."""
    files = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, "*.h5"):
            files.append(os.path.join(root, filename))
    return sorted(files)


class FastSVCDataset:
    """Features of every utterance under a dump directory, read on demand."""

    FIELDS = ("wave", "f0", "ppg", "lft", "spk_emb")

    def __init__(self, root_dir: str):
        files = find_files(root_dir)
        if not files:
            raise FileNotFoundError(f"no .h5 files under {root_dir}")
        self.files = files
        self.utt_ids = [os.path.splitext(os.path.basename(f))[0] for f in files]

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        items = tuple(np.asarray(read_hdf5(self.files[idx], name))
                      for name in self.FIELDS)
        return (self.utt_ids[idx],) + items


def validate_length(xs, ys=None, hop_size: Optional[int] = None):
    """Trim frame-rate arrays xs (and sample-rate arrays ys) to a common
    length: every x to the shortest, and every y to that many frames times
    hop_size, fewer frames if a y is shorter."""
    min_len_x = min(len(x) for x in xs)
    if ys is not None:
        min_len_y = min(len(y) for y in ys)
        if min_len_y < min_len_x * hop_size:
            min_len_x = min_len_y // hop_size
        min_len_y = min_len_x * hop_size
        xs = [x[:min_len_x] for x in xs]
        ys = [y[:min_len_y] for y in ys]
        return xs + ys
    return [x[:min_len_x] for x in xs]


class USFGANDataset:
    """Vocoder inputs of every utterance under a dump directory: per item
    (utt_id, wave, aux = mcep | bap (T', A), df (T'*hop,), f0 (T',)), with
    the pitch-dependent dilation factors (f64) repeated to sample rate."""

    def __init__(self, root_dir: str, *, sample_rate: int = 24000,
                 hop_size: int = 160, dense_factor: int = 4):
        files = find_files(root_dir)
        if not files:
            raise FileNotFoundError(f"no .h5 files under {root_dir}")
        self.files = files
        self.utt_ids = [os.path.splitext(os.path.basename(f))[0] for f in files]
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.dense_factor = dense_factor

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        from ..dsp.f0 import dilated_factor

        f = self.files[idx]
        audio = np.asarray(read_hdf5(f, "wave")).reshape(-1)
        mcep = np.asarray(read_hdf5(f, "mcep"))
        bap = np.asarray(read_hdf5(f, "bap"))
        f0 = np.asarray(read_hdf5(f, "f0")).reshape(-1)
        f0, aux = validate_length([f0, np.concatenate([mcep, bap], axis=1)])
        f0, audio = validate_length([f0], [audio], self.hop_size)
        df = np.repeat(dilated_factor(f0, self.sample_rate,
                                      self.dense_factor),
                       self.hop_size, axis=0)
        return self.utt_ids[idx], audio, aux, df, f0


class B02Dataset:
    """The B02 acoustic model's fields of every utterance under a dump
    directory, per item (utt_id, wave, f0, ppg (T', 256), lft (T', 1), lf0
    (T', 1), vuv, mcep (T', 60), bap (T', 3), spk_emb), read on first use
    and, with allow_cache, kept (decode reads each utterance once per
    target speaker; the scalers' fit reads each once)."""

    FIELDS = ("wave", "f0", "ppg", "lft", "lf0", "vuv", "mcep", "bap",
              "spk_emb")

    def __init__(self, root_dir: str, *, allow_cache: bool = True):
        files = find_files(root_dir)
        if not files:
            raise FileNotFoundError(f"no .h5 files under {root_dir}")
        self.files = files
        self.utt_ids = [os.path.splitext(os.path.basename(f))[0] for f in files]
        self._cache = {} if allow_cache else None

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        item = (self.utt_ids[idx],) + tuple(
            np.asarray(read_hdf5(self.files[idx], name))
            for name in self.FIELDS)
        if self._cache is not None:
            self._cache[idx] = item
        return item
