"""Masked losses for padded variable-length sequence batches.

Counterpart of `svcc23_fastsvc_tpu/losses/masked.py`: MSE over the frames
before each sequence's length only.
"""

from __future__ import annotations

import torch


def length_mask(lengths, max_len: int):
    """(B,) lengths -> (B, max_len) boolean mask of the valid frames."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def masked_mse_loss(x, y, lengths):
    """Mean squared error over the valid frames of (B, T, D) sequences,
    both cut to the shorter T."""
    T = min(x.shape[1], y.shape[1])
    x, y = x[:, :T], y[:, :T]
    mask = length_mask(torch.clamp(lengths, max=T), T)[..., None]
    sq = torch.square(x - y) * mask
    denom = torch.sum(mask) * x.shape[-1]
    return torch.sum(sq) / torch.clamp(denom, min=1)
