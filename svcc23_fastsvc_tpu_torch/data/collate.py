"""Fixed-shape random-crop batches for GAN training.

Counterpart of `svcc23_fastsvc_tpu/data/collate.py::FastSVCBatcher` (numpy
only): per step, `batch_size` utterances drawn with replacement and a
frame-aligned random window of `batch_length` samples from each, as one
batch dict of static shapes. The sine excitation is not made here: the
train step makes it on the device from the window's F0. Crops come from a
seeded numpy Generator, so a run is reproducible.

Items are the port's `FastSVCDataset` layout: (utt_id, wave (T,), f0 (T',),
ppg (T', C), lft (T,), spk_emb (1, S)).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator

import numpy as np


class FastSVCBatcher:
    """Infinite iterator of fixed-shape training batches."""

    def __init__(self, dataset, *, batch_size: int = 32,
                 batch_length: int = 16000, hop_size: int = 160,
                 aux_context_window: int = 0, use_spk_emb: bool = True,
                 seed: int = 0):
        batch_length -= batch_length % hop_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.batch_length = batch_length
        self.batch_frames = batch_length // hop_size
        self.hop_size = hop_size
        self.acw = aux_context_window
        self.use_spk_emb = use_spk_emb
        self.rng = np.random.default_rng(seed)
        # utterances long enough for one window (the reference warns and
        # skips the others in its collater)
        self.valid_idx = []
        for i in range(len(dataset)):
            if len(dataset[i][3]) - 2 * self.acw > self.batch_frames:
                self.valid_idx.append(i)
            else:
                logging.warning("utterance %d shorter than batch window; "
                                "dropped", i)
        if not self.valid_idx:
            raise ValueError("no utterance long enough for the batch window")
        self._packed = None

    def _pack(self):
        """All valid utterances stacked into padded arrays, so that a batch
        of crops is B slice copies."""
        items = [self.dataset[i][1:] for i in self.valid_idx]
        n, hop = len(items), self.hop_size
        max_frames = max(len(it[2]) for it in items)
        L = max_frames * hop
        packed = {
            "audio": np.zeros((n, L), np.float32),
            "f0": np.zeros((n, max_frames), np.float32),
            "ppg": np.zeros((n, max_frames, items[0][2].shape[-1]),
                            np.float32),
            "lft": np.zeros((n, L), np.float32),
            "n_frames": np.zeros((n,), np.int64),
        }
        if self.use_spk_emb:
            packed["spk_emb"] = np.stack([
                np.asarray(it[4], np.float32).reshape(-1) for it in items])
        for i, (audio, f0, ppg, lft, _) in enumerate(items):
            nf = len(ppg)
            packed["audio"][i, :nf * hop] = np.asarray(audio).reshape(-1)[
                :nf * hop]
            packed["f0"][i, :nf] = np.asarray(f0).reshape(-1)[:nf]
            packed["ppg"][i, :nf] = ppg[:nf]
            packed["lft"][i, :nf * hop] = np.asarray(lft).reshape(-1)[
                :nf * hop]
            packed["n_frames"][i] = nf
        self._packed = packed

    def sample_batch(self) -> Dict[str, np.ndarray]:
        if self.acw == 0:
            return self._sample_batch_vectorized()
        return self._sample_batch_loop()

    def _sample_batch_vectorized(self) -> Dict[str, np.ndarray]:
        if self._packed is None:
            self._pack()
        p = self._packed
        B, F, L = self.batch_size, self.batch_frames, self.batch_length
        rows = self.rng.integers(0, p["audio"].shape[0], size=B)
        max_start = p["n_frames"][rows] - F
        start = (self.rng.random(B) * (max_start - self.acw)).astype(
            np.int64) + self.acw
        s0 = start * self.hop_size
        out = {
            "audio": np.empty((B, L, 1), np.float32),
            "f0": np.empty((B, F, 1), np.float32),
            "ppg": np.empty((B, F, p["ppg"].shape[-1]), np.float32),
            "lft": np.empty((B, L, 1), np.float32),
        }
        for i in range(B):
            r, f0s, a0 = rows[i], start[i], s0[i]
            out["audio"][i, :, 0] = p["audio"][r, a0:a0 + L]
            out["f0"][i, :, 0] = p["f0"][r, f0s:f0s + F]
            out["ppg"][i] = p["ppg"][r, f0s:f0s + F]
            out["lft"][i, :, 0] = p["lft"][r, a0:a0 + L]
        if self.use_spk_emb:
            out["spk_emb"] = p["spk_emb"][rows]
        return out

    def _sample_batch_loop(self) -> Dict[str, np.ndarray]:
        """Crops with aux_context_window frames of ppg context each side."""
        B, F, L = self.batch_size, self.batch_frames, self.batch_length
        picks = self.rng.choice(self.valid_idx, size=B, replace=True)
        out = {"audio": np.empty((B, L, 1), np.float32),
               "f0": np.empty((B, F, 1), np.float32),
               "lft": np.empty((B, L, 1), np.float32)}
        ppgs, embs = [], []
        for bi, idx in enumerate(picks):
            audio, f0, ppg, lft, emb = self.dataset[idx][1:]
            start = int(self.rng.integers(self.acw,
                                          len(ppg) - F - self.acw))
            s0 = start * self.hop_size
            out["audio"][bi, :, 0] = audio[s0:s0 + L]
            out["f0"][bi, :, 0] = f0[start:start + F]
            ppgs.append(ppg[start - self.acw:start + self.acw + F])
            out["lft"][bi, :, 0] = lft[s0:s0 + L]
            embs.append(np.asarray(emb, np.float32).reshape(-1))
        out["ppg"] = np.stack(ppgs).astype(np.float32)
        if self.use_spk_emb:
            out["spk_emb"] = np.stack(embs)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.sample_batch()
