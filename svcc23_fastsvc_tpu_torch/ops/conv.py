"""Convolution, pooling and normalisation primitives, channels-last.

Counterpart of `svcc23_fastsvc_tpu/ops/conv.py`: tensors are (B, T, C) and
conv weights WIO (K, C_in/groups, C_out), as in the JAX package, so the
tests compare like with like.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .window_conv import WindowConv1d, window_conv

# The window-conv kernels are written for the generator's widths, up to its
# fused FiLM conv's 2 x 192 channels. Wider convs (the MelGAN
# discriminator's 512-channel layers) go to cuDNN, as the JAX package sends
# them to XLA's conv (its window-conv gate is 128 channels).
WINDOW_CONV_MAX_CHANNELS = 384


def conv1d(x, weight, bias=None, *, stride: int = 1, padding=0,
           dilation: int = 1, groups: int = 1, input_leaky=None):
    """1-D conv on (B, T, C_in) with WIO weight (K, C_in/groups, C_out).

    `padding` is an int (symmetric zero pad), a (lo, hi) pair or "VALID".
    Odd-K, stride-1, ungrouped convs with "same" padding (K-1)/2 * dilation
    go to the window-conv kernel, which applies `input_leaky` to its input
    as it loads it; with grad enabled through `WindowConv1d`, whose backward
    is the window-conv dx and wgrad kernels. K=1 convs with no padding are
    pointwise products and go to torch.matmul, as the JAX package leaves
    them to XLA. Every other conv (strided, grouped, unpadded) goes to
    `F.conv1d`: the JAX package computes those outside any Pallas kernel.
    """
    if isinstance(padding, str):
        if padding != "VALID":
            raise ValueError(f"conv1d padding {padding!r}: want an int, a "
                             "(lo, hi) pair or 'VALID'")
        lo = hi = 0
    elif isinstance(padding, int):
        lo = hi = padding
    else:
        lo, hi = padding
    K, in_pg, c_out = weight.shape
    if stride == 1 and groups == 1:
        if K == 1 and lo == hi == 0:
            if input_leaky is not None:
                x = leaky_relu(x, input_leaky)
            out = x @ weight[0]
            return out if bias is None else out + bias
        if (K % 2 == 1 and lo == hi == (K - 1) // 2 * dilation
                and max(in_pg, c_out) <= WINDOW_CONV_MAX_CHANNELS):
            x = x.contiguous()
            if torch.is_grad_enabled():
                return WindowConv1d.apply(x, weight, bias, dilation,
                                          input_leaky)
            return window_conv(x, weight, bias, dilation, input_leaky)
    if input_leaky is not None:
        x = leaky_relu(x, input_leaky)
    if lo != hi:
        x = F.pad(x, (0, 0, lo, hi))
        lo = 0
    out = F.conv1d(x.transpose(1, 2), weight.permute(2, 1, 0), bias,
                   stride=stride, padding=lo, dilation=dilation, groups=groups)
    return out.transpose(1, 2)


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)


def wn_weight(params):
    """Effective weight from weight-norm params {"v" (K, I, O), "g" (O,)}."""
    v = params["v"]
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(v.dim() - 1)),
                                keepdim=True))
    return params["g"] * v / norm


def _is_wn_leaf(d) -> bool:
    return isinstance(d, dict) and "v" in d and "g" in d


def fold_weight_norm(params):
    """Recursively fold {"v","g"} weight-norm params into plain {"w"} params."""
    if _is_wn_leaf(params):
        out = {"w": wn_weight(params)}
        if "b" in params:
            out["b"] = params["b"]
        return out
    if isinstance(params, dict):
        return {k: fold_weight_norm(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(fold_weight_norm(v) for v in params)
    return params


def conv_weight(params):
    """Effective weight for either plain {"w"} or weight-norm {"v","g"}."""
    return params["w"] if "w" in params else wn_weight(params)


def instance_norm(x, *, eps: float = 1e-5, axis: int = 1):
    """InstanceNorm without affine params over the time axis of (B, T, C)."""
    mean = x.mean(dim=axis, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axis, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def avg_pool1d(x, kernel_size: int, stride: int, padding: int = 0,
               count_include_pad: bool = True):
    """torch.nn.AvgPool1d on (B, T, C)."""
    out = F.avg_pool1d(x.transpose(1, 2), kernel_size, stride, padding,
                       count_include_pad=count_include_pad)
    return out.transpose(1, 2)


def reflect_pad1d(x, pad):
    """Reflection padding on the time axis of (B, T, C)."""
    lo, hi = (pad, pad) if isinstance(pad, int) else pad
    return F.pad(x.transpose(1, 2), (lo, hi), mode="reflect").transpose(1, 2)


def l2_normalize(x, axis: int = -1, eps: float = 1e-12):
    """torch F.normalize semantics: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def linear(x, params):
    """x @ w (+ b) with w stored (in, out), as in the JAX package."""
    out = x @ params["w"]
    return out + params["b"] if "b" in params else out
