"""Ops: primitives, resampling, excitation, STFT.

The CUDA kernels' wrappers live in `ops.window_conv` (forward, dx, wgrad),
`ops.fused_conv` (the fused conv's forward and one-pass backward, behind
`conv.set_pallas_conv_mode`), `ops.sine`, `ops.pd_block` (the vocoder's
gated blocks and their chain) and `ops.down_chain` (a whole
DownsampleBlock).
"""

from .conv import (  # noqa: F401
    avg_pool1d,
    conv1d,
    conv_weight,
    edge_pad1d,
    fold_weight_norm,
    instance_norm,
    l2_normalize,
    leaky_relu,
    linear,
    reflect_pad1d,
    wn_weight,
)
from .resample import nearest_downsample, nearest_resize, nearest_upsample  # noqa: F401
from .signal_gen import SignalGenerator, continuous_f0  # noqa: F401
