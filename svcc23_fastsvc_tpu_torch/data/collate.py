"""Fixed-shape training batches: random crops for FastSVC, padded
utterances for the B02 acoustic model.

Counterpart of `svcc23_fastsvc_tpu/data/collate.py::FastSVCBatcher` and
`B02Batcher` (numpy only). FastSVCBatcher: per step, `batch_size`
utterances drawn with replacement and a frame-aligned random window of
`batch_length` samples from each, as one batch dict of static shapes.
The sine excitation is not made here: the train step makes it on the
device from the window's F0. Crops come from a
seeded numpy Generator, so a run is reproducible; the windows of a batch
are copied by the native assembler's threads (`data/native_batch.py::
assemble_batch`), as the JAX batcher copies them.

Items are the port's `FastSVCDataset` layout: (utt_id, wave (T,), f0 (T',),
ppg (T', C), lft (T,), spk_emb (1, S)).

B02Batcher: per step, `batch_size` utterances drawn with replacement, each
padded (or cut) to `max_frames` with its length in "lengths"; items are
the port's `B02Dataset` layout (utt_id, wave, f0, ppg, lft, lf0, vuv,
mcep, bap, spk_emb), the targets mcep | bap.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator

import numpy as np

from .native_batch import assemble_batch


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
        B, F = self.batch_size, self.batch_frames
        rows = self.rng.integers(0, p["audio"].shape[0], size=B)
        max_start = p["n_frames"][rows] - F
        start = (self.rng.random(B) * (max_start - self.acw)).astype(
            np.int64) + self.acw
        out = assemble_batch(p, rows, start, F, self.hop_size)
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


class B02Batcher:
    """Infinite iterator of fixed-shape B02 batches (the reference's sort
    and pad collater, train_b02.py:425-474, at a static shape): ppg, lft,
    lf0, spk_emb, targets and lengths; the masked loss and the
    length-aware BLSTM make the padding inert. The same numpy draws as the
    JAX package's batcher from the same seed."""

    def __init__(self, dataset, *, batch_size: int = 16,
                 max_frames: int = 400, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_frames = max_frames
        self.rng = np.random.default_rng(seed)

    def sample_batch(self) -> Dict[str, np.ndarray]:
        B, F = self.batch_size, self.max_frames
        picks = self.rng.choice(len(self.dataset), size=B, replace=True)
        _, _, _, ppg, _, _, _, mcep, bap, emb = self.dataset[picks[0]]
        batch = {
            "ppg": np.zeros((B, F, ppg.shape[-1]), np.float32),
            "lft": np.zeros((B, F, 1), np.float32),
            "lf0": np.zeros((B, F, 1), np.float32),
            "spk_emb": np.zeros((B, np.asarray(emb).size), np.float32),
            "targets": np.zeros((B, F, mcep.shape[-1] + bap.shape[-1]),
                                np.float32),
            "lengths": np.zeros((B,), np.int32),
        }
        for bi, idx in enumerate(picks):
            _, _, _, ppg, lft, lf0, _, mcep, bap, emb = self.dataset[idx]
            L = min(len(ppg), len(mcep), len(lf0), len(lft), F)
            batch["ppg"][bi, :L] = ppg[:L]
            batch["lft"][bi, :L] = np.asarray(lft).reshape(-1, 1)[:L]
            batch["lf0"][bi, :L] = np.asarray(lf0).reshape(-1, 1)[:L]
            batch["spk_emb"][bi] = np.asarray(emb, np.float32).reshape(-1)
            batch["targets"][bi, :L] = np.concatenate([mcep[:L], bap[:L]],
                                                      axis=-1)
            batch["lengths"][bi] = L
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.sample_batch()
