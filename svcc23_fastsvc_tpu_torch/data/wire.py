"""Host-to-device wire format of training batches.

Counterpart of `svcc23_fastsvc_tpu/data/wire.py`. `WirePacker` (host side)
ships the information and not the padding, exactly for the recipe's data
under bf16 compute:

* `audio` f32 -> int16: the dumps' audio is 16-bit PCM decoded as k/32768,
  so the round trip is exact (the first batch's error is logged);
* `ppg` f32 -> bf16: the step casts ppg to bf16 before its first use, so
  rounding it on the host gives the same values;
* `lft` f32 -> frame rate: the dumps store loudness repeated hop times per
  frame, so `lft[::hop]` holds all of it (checked on the first batch; if it
  does not hold, lft goes full rate in bf16 instead, and the log says so);
* `f0` and `spk_emb` are small and stay f32.

numpy has no bf16 without ml_dtypes, so the bf16 fields are CPU torch
tensors; the rest are numpy arrays. `unpack_batch` inverts the format on
the device, inside the step, and leaves an f32 batch as it is.
"""

from __future__ import annotations

import logging

import numpy as np
import torch


def _is_hop_constant(lft: np.ndarray, hop: int) -> bool:
    """True iff the time axis (-2) is constant within every hop window."""
    t = lft.shape[-2]
    if t % hop:
        return False
    shaped = lft.reshape(*lft.shape[:-2], t // hop, hop, lft.shape[-1])
    return bool(np.all(shaped == shaped[..., :1, :]))


def _bf16(a: np.ndarray):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


class WirePacker:
    """Callable packing host batches ((B, T, C) numpy) into the wire format.

    The lft and audio checks are made on the first batch, logged, and kept.
    """

    def __init__(self, *, hop_size: int):
        self.hop_size = int(hop_size)
        self._lft_frame: bool | None = None
        self._audio_checked = False

    def __call__(self, batch: dict) -> dict:
        out = dict(batch)
        audio = out.get("audio")
        if isinstance(audio, np.ndarray) and audio.dtype == np.float32:
            q = np.clip(np.round(audio * 32768.0), -32768, 32767)
            if not self._audio_checked:
                err = float(np.abs(q / 32768.0 - audio).max())
                logging.info(
                    "wire: audio f32->int16, first-batch round-trip "
                    "maxdiff %.2e%s", err,
                    " (exact: PCM16-derived)" if err == 0.0 else "")
                self._audio_checked = True
            out["audio"] = q.astype(np.int16)
        lft = out.get("lft")
        if isinstance(lft, np.ndarray) and lft.dtype == np.float32 \
                and audio is not None:
            if self._lft_frame is None:
                self._lft_frame = _is_hop_constant(lft, self.hop_size)
                logging.info("wire: lft %s", "frame-rate f32 (hop-constant)"
                             if self._lft_frame else
                             "NOT hop-constant -> full-rate bf16 fallback")
            if self._lft_frame:
                out["lft"] = np.ascontiguousarray(lft[..., ::self.hop_size, :])
            else:
                out["lft"] = _bf16(lft)
        ppg = out.get("ppg")
        if isinstance(ppg, np.ndarray) and ppg.dtype == np.float32:
            out["ppg"] = _bf16(ppg)
        return out


def to_device(batch: dict, device) -> dict:
    """Every array of a host batch as a tensor on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items() if v is not None}


def unpack_batch(batch: dict, *, hop_size: int) -> dict:
    """Invert `WirePacker` on the device; an f32 batch passes unchanged."""
    out = dict(batch)
    audio = out.get("audio")
    if audio is not None and audio.dtype == torch.int16:
        # 1/32768 is a power of two: multiplying is exact
        audio = audio.float() * (1.0 / 32768.0)
        out["audio"] = audio
    lft = out.get("lft")
    if lft is not None and audio is not None and \
            lft.shape[-2] != audio.shape[-2]:
        if lft.shape[-2] * hop_size != audio.shape[-2]:
            raise ValueError(f"wire: lft frames {lft.shape[-2]} x hop "
                             f"{hop_size} != audio samples "
                             f"{audio.shape[-2]}")
        out["lft"] = torch.repeat_interleave(lft, hop_size, dim=-2)
    return out
