"""Convolution, pooling and normalisation primitives, channels-last.

Counterpart of `svcc23_fastsvc_tpu/ops/conv.py`: tensors are (B, T, C) and
conv weights WIO (K, C_in/groups, C_out), as in the JAX package, so the
tests compare like with like.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import fused_conv as _fused
from .window_conv import WindowConv1d, window_conv

# The window-conv kernels are written for the generator's widths, up to its
# fused FiLM conv's 2 x 192 channels. Wider convs (the MelGAN
# discriminator's 512-channel layers) go to cuDNN, as the JAX package sends
# them to XLA's conv (its window-conv gate is 128 channels).
WINDOW_CONV_MAX_CHANNELS = 384

# The fused-conv lowering (ops/fused_conv.py, kernels #5 and #6), switched
# as the JAX package switches its `pallas_conv1d`: "0" off (the default),
# "1" on, "auto" on for CUDA tensors once a one-time probe on the device has
# held the kernels to their plain versions. It takes a conv before the
# window conv, up to 192 channels (the JAX gate).
_PALLAS_CONV_MODE = os.environ.get("FASTSVC_PALLAS_CONV", "0")
PALLAS_CONV_MAX_CHANNELS = 192
_PROBED: set = set()  # devices whose probe passed in "auto" mode


def set_pallas_conv_mode(mode: str) -> None:
    """Set the fused-conv lowering mode: "0", "1" or "auto"."""
    if mode not in ("0", "1", "auto"):
        raise ValueError(f"bad pallas conv mode: {mode!r}")
    global _PALLAS_CONV_MODE
    _PALLAS_CONV_MODE = mode
    _PROBED.clear()


def pallas_conv_mode() -> str:
    if _PALLAS_CONV_MODE not in ("0", "1", "auto"):
        raise ValueError(f"bad FASTSVC_PALLAS_CONV: {_PALLAS_CONV_MODE!r}")
    return _PALLAS_CONV_MODE


def fused_conv_selfcheck(device) -> None:
    """The "auto" probe: the fused forward and all three gradients against
    their plain versions on `device`, at one f32 and one bf16 shape (the
    JAX package's probe shapes and tolerances, 10x for the gradients).
    Raises when they disagree or the kernels fail."""
    gen = torch.Generator().manual_seed(17)
    for B, T, cin, cout, dil, slope, dtype, tol in (
        (2, 750, 24, 48, 3, 0.2, torch.float32, 2e-4),
        (2, 512, 96, 96, 27, None, torch.bfloat16, 2e-2),
    ):
        lo = hi = dil
        x, g = (torch.randn((B, T, c), generator=gen).to(device, dtype)
                for c in (cin, cout))
        w = (0.2 * torch.randn((3, cin, cout), generator=gen)).to(device,
                                                                   dtype)
        b = torch.randn((cout,), generator=gen).to(device, dtype)
        got = (_fused.fused_conv1d(x, w, b, lo, hi, dil, slope),
               *_fused.fused_conv1d_bwd(x, g, w, lo, hi, dil, slope))
        want = (_fused.fused_conv1d_plain(x, w, b, lo, hi, dil, slope),
                *_fused.fused_conv1d_bwd_plain(x, g, w, lo, hi, dil, slope))
        for name, a, c, t in zip(("y", "dx", "dw", "db"), got, want,
                                 (tol, 10 * tol, 10 * tol, 10 * tol)):
            if not torch.allclose(a.float(), c.float(), rtol=t, atol=t):
                err = (a.float() - c.float()).abs().max().item()
                raise RuntimeError(
                    f"fused-conv probe on {device}: {name} {dtype} differs "
                    f"from its plain version by {err} (tolerance {t})")


def _fused_conv_enabled(device) -> bool:
    mode = pallas_conv_mode()
    if mode != "auto":
        return mode == "1"
    device = torch.device(device)
    if device.type != "cuda":
        return False
    key = str(device) if device.index is not None else \
        f"cuda:{torch.cuda.current_device()}"
    if key not in _PROBED:
        fused_conv_selfcheck(key)
        _PROBED.add(key)
    return True


def decide_conv_lowering(device="cuda") -> str:
    """Take the fused-conv decision for `device` now (running the "auto"
    probe, which raises when it fails) and name the active lowerings:
    "fused+window" or "window"."""
    return ("fused+" if _fused_conv_enabled(device) else "") + "window"


def conv1d(x, weight, bias=None, *, stride: int = 1, padding=0,
           dilation: int = 1, groups: int = 1, input_leaky=None):
    """1-D conv on (B, T, C_in) with WIO weight (K, C_in/groups, C_out).

    `padding` is an int (symmetric zero pad), a (lo, hi) pair or "VALID".
    With the fused-conv mode on (`set_pallas_conv_mode`), a conv of at most
    192 channels that `fused_conv1d_supported` takes (K in [2, 5], lo + hi
    = (K-1) * dilation <= 64, T >= 256) goes to the fused-conv kernel,
    through `FusedConv1d` with grad enabled, as the JAX package sends it to
    `pallas_conv1d`. Otherwise odd-K, stride-1, ungrouped convs with "same"
    padding (K-1)/2 * dilation go to the window-conv kernel, which applies `input_leaky` to its input
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
    if (max(in_pg, c_out) <= PALLAS_CONV_MAX_CHANNELS
            and _fused_conv_enabled(x.device)
            and _fused.fused_conv1d_supported(
                tuple(x.shape), tuple(weight.shape), stride=stride,
                groups=groups, lo=lo, hi=hi, dilation=dilation)):
        x = x.contiguous()
        if torch.is_grad_enabled():
            return _fused.FusedConv1d.apply(x, weight, bias, lo, hi,
                                            dilation, input_leaky)
        return _fused.fused_conv1d(x, weight, bias, lo, hi, dilation,
                                   input_leaky)
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


def edge_pad1d(x, pad: int):
    """Edge (replicate) padding on the time axis of (B, T, C): jnp.pad's
    mode="edge", torch's padding_mode="replicate"."""
    if pad == 0:
        return x
    B, _, C = x.shape
    return torch.cat([x[:, :1].expand(B, pad, C), x,
                      x[:, -1:].expand(B, pad, C)], dim=1)


def l2_normalize(x, axis: int = -1, eps: float = 1e-12):
    """torch F.normalize semantics: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def linear(x, params):
    """x @ w (+ b) with w stored (in, out), as in the JAX package."""
    out = x @ params["w"]
    return out + params["b"] if "b" in params else out
