"""Masked losses for padded variable-length sequence batches.

Counterpart of `svcc23_fastsvc_tpu/losses/masked.py`: MSE over the frames
before each sequence's length only. Under data parallelism the numerator
and the count of valid elements are summed across the data group before
the division (with autograd), so the loss is the global batch's, as in
JAX's GSPMD step, whatever lengths each rank holds.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import psum


def length_mask(lengths, max_len: int):
    """(B,) lengths -> (B, max_len) boolean mask of the valid frames."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def masked_mse_loss(x, y, lengths, group=None):
    """Mean squared error over the valid frames of (B, T, D) sequences,
    both cut to the shorter T; over the whole data `group`'s rows when
    given."""
    T = min(x.shape[1], y.shape[1])
    x, y = x[:, :T], y[:, :T]
    mask = length_mask(torch.clamp(lengths, max=T), T)[..., None]
    sq = torch.square(x - y) * mask
    denom = psum(torch.sum(mask) * x.shape[-1], group)
    return psum(torch.sum(sq), group) / torch.clamp(denom, min=1)
