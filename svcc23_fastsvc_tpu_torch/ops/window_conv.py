"""Stride-1 "same" dilated conv with a fused input leaky-relu, and its
backward.

`window_conv` computes, on channels-last (B, T, Cin) input and a WIO
(K, Cin, Cout) weight,

    y[t] = sum_k act(x)[t - lo + k*dil] @ w[k] + b,   lo = (K-1)/2 * dil,

with zero padding and act = leaky_relu(., slope) applied in f32 (or none).
`window_conv_dx` and `window_conv_wgrad` are its input and weight/bias
gradients, and `WindowConv1d` the autograd Function that joins the three,
with the semantics of `svcc23_fastsvc_tpu/ops/conv.py::window_conv1d` and
its custom VJP: the forward saves the pre-activation x and the weight; dx
is the conv of g with the weight reversed in K and transposed, times the
leaky derivative of x in f32; dw and db are summed in f32 and cast to the
weight's dtype.

The three replace the TPU kernels of `svcc23_fastsvc_tpu/ops/
pallas_window_conv.py` (`window_conv_fwd`, `window_conv_dx`,
`window_conv_wgrad`). The CUDA sources are `csrc/window_conv.cuh` (forward
and dx) and `csrc/window_conv_grad.cu` (dx entry, wgrad); their headers say
what bounds them on the H100 and how they are tiled.

On a CUDA tensor each wrapper launches its kernel or raises. On a CPU
tensor it takes its plain PyTorch version (`*_plain`), which the tests and
`chip_smoke.py` hold the kernels against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_DX_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
_WGRAD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# wgrad splits its B*T rows over enough blocks to fill an H100 (132 SMs, 4
# blocks each); the split depends on the shapes alone, so the sums do too
_WGRAD_BLOCKS = 4 * 132
_WGRAD_ROWS = 32  # rows per row tile, kRows in csrc/window_conv_grad.cu


def _wide(t):
    """t in f32, or f64 where it is f64 (a CPU reference in double)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _activate(x, slope):
    """act(x) in f32, rounded to x's dtype as the kernels store it."""
    h = _wide(x)
    if slope is not None:
        h = _wide(F.leaky_relu(h, slope).to(x.dtype))
    return h


def window_conv_plain(x, weight, bias, dilation: int, slope):
    """Plain PyTorch version: K shifted slices, one matmul each, f32 sums."""
    K = weight.shape[0]
    lo = (K - 1) // 2 * dilation
    T = x.shape[1]
    hp = F.pad(_activate(x, slope), (0, 0, lo, lo))
    w = _wide(weight)
    y = hp[:, 0:T] @ w[0]
    for k in range(1, K):
        y = y + hp[:, k * dilation:k * dilation + T] @ w[k]
    if bias is not None:
        y = y + _wide(bias)
    return y.to(x.dtype)


def _leaky_grad(dxc, x, slope):
    """dxc * where(x >= 0, 1, slope) in f32, cast back to dxc's dtype."""
    mask = torch.where(_wide(x) >= 0.0, 1.0, float(slope))
    return (_wide(dxc) * mask).to(dxc.dtype)


def window_conv_dx_plain(g, weight, dilation: int, x=None, slope=None):
    """Plain PyTorch version of the input gradient."""
    dxc = window_conv_plain(g, weight.flip(0).transpose(1, 2), None,
                            dilation, None)
    return dxc if slope is None else _leaky_grad(dxc, x, slope)


def window_conv_wgrad_plain(x, g, K: int, dilation: int, slope):
    """Plain PyTorch version: (dw (K, Cin, Cout), db (Cout,)), both f32
    (f64 for f64 inputs)."""
    lo = (K - 1) // 2 * dilation
    B, T, cin = x.shape
    hp = F.pad(_activate(x, slope), (0, 0, lo, lo))
    g2 = _wide(g).reshape(B * T, -1)
    dw = torch.stack([
        hp[:, k * dilation:k * dilation + T].reshape(B * T, cin).t() @ g2
        for k in range(K)
    ])
    return dw, g2.sum(0)


def _check(x, weight, bias, dilation):
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError(f"want x (B, T, Cin) and w (K, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    K, cin, cout = weight.shape
    if K % 2 == 0 or cin != x.shape[2] or dilation < 1:
        raise ValueError(f"unsupported conv: K={K} dilation={dilation} "
                         f"x {tuple(x.shape)} w {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} for {cout} outputs")
    for t in (weight, bias):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError("x, weight and bias must share dtype and device")


def _cuda_only(name, *tensors):
    """Raise unless every tensor is a contiguous f32/bf16 CUDA tensor."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {t0.device}")
    if t0.dtype not in _SUFFIX:
        raise ValueError(f"{name} kernel takes f32 or bf16, not {t0.dtype}")
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs")


def window_conv(x, weight, bias=None, dilation: int = 1, slope=None):
    """(B, T, Cin) -> (B, T, Cout) same-padding K-tap conv, K odd."""
    _check(x, weight, bias, dilation)
    if x.device.type == "cpu":
        return window_conv_plain(x, weight, bias, dilation, slope)
    _cuda_only("window_conv", x, bias)
    B, T, cin = x.shape
    K, _, cout = weight.shape
    y = torch.empty((B, T, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    name = f"window_conv_fwd_{_SUFFIX[x.dtype]}"
    fn = _build.kernel(name, _ARGTYPES)
    swk, swi, swo = weight.stride()
    err = fn(x.data_ptr(), weight.data_ptr(),
             None if bias is None else bias.data_ptr(), y.data_ptr(),
             B, T, cin, cout, K, dilation, swk, swi, swo,
             0 if slope is None else 1, 0.0 if slope is None else float(slope),
             _build.stream_handle(x.device))
    _build.check(err, name)
    window_conv.launches += 1
    return y


def window_conv_dx(g, weight, dilation: int, x=None, slope=None):
    """Input gradient of `window_conv`: (B, T, Cout) g -> (B, T, Cin).

    With `slope`, x is the forward's pre-activation input and the result is
    multiplied by where(x >= 0, 1, slope) in f32.
    """
    K, cin, cout = weight.shape
    _check(g, weight.transpose(1, 2), None, dilation)
    if slope is not None and (x is None or x.shape[:2] != g.shape[:2]
                              or x.shape[2] != cin or x.dtype != g.dtype):
        raise ValueError("dx with a leaky slope needs the forward's input x")
    if g.device.type == "cpu":
        return window_conv_dx_plain(g, weight, dilation, x, slope)
    _cuda_only("window_conv_dx", g, x if slope is not None else None)
    B, T, _ = g.shape
    dx = torch.empty((B, T, cin), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    name = f"window_conv_dx_{_SUFFIX[g.dtype]}"
    fn = _build.kernel(name, _DX_ARGTYPES)
    swk, swi, swo = weight.stride()
    # the K flip: start at the last tap and step back (torch has no
    # negative strides, the kernel's pointer arithmetic has)
    last = weight.data_ptr() + (K - 1) * swk * weight.element_size()
    err = fn(g.data_ptr(), last,
             None if slope is None else x.data_ptr(), dx.data_ptr(),
             B, T, cout, cin, K, dilation, -swk, swo, swi,
             0.0 if slope is None else float(slope),
             _build.stream_handle(g.device))
    _build.check(err, name)
    window_conv_dx.launches += 1
    return dx


def _wgrad_splits(B, T, K, cin, cout):
    """How many slots wgrad sums its row tiles into (a fixed partition)."""
    ti = 32 if cin <= 32 else 64
    tco = 32 if cout <= 32 else 64
    out_tiles = -(-cout // tco) * K * -(-cin // ti)
    n_tiles = B * -(-T // _WGRAD_ROWS)
    return max(1, min(n_tiles, -(-_WGRAD_BLOCKS // out_tiles)))


def window_conv_wgrad(x, g, K: int, dilation: int = 1, slope=None):
    """Weight and bias gradients of `window_conv`: (dw (K, Cin, Cout) f32,
    db (Cout,) f32) from the forward's input x and the cotangent g."""
    if x.dim() != 3 or g.dim() != 3 or x.shape[:2] != g.shape[:2]:
        raise ValueError(f"want x (B, T, Cin) and g (B, T, Cout), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if K % 2 == 0 or dilation < 1 or x.dtype != g.dtype or \
            x.device != g.device:
        raise ValueError(f"unsupported wgrad: K={K} dilation={dilation} "
                         f"{x.dtype}/{g.dtype} on {x.device}/{g.device}")
    if x.device.type == "cpu":
        return window_conv_wgrad_plain(x, g, K, dilation, slope)
    _cuda_only("window_conv_wgrad", x, g)
    B, T, cin = x.shape
    cout = g.shape[2]
    if B * T == 0 or cin * cout == 0:
        return (torch.zeros((K, cin, cout), device=x.device),
                torch.zeros((cout,), device=x.device))
    dw = torch.empty((K, cin, cout), dtype=torch.float32, device=x.device)
    db = torch.empty((cout,), dtype=torch.float32, device=x.device)
    n_splits = _wgrad_splits(B, T, K, cin, cout)
    part_w = torch.empty((n_splits, K, cin, cout), dtype=torch.float32,
                         device=x.device)
    part_b = torch.empty((n_splits, cout), dtype=torch.float32,
                         device=x.device)
    name = f"window_conv_wgrad_{_SUFFIX[x.dtype]}"
    fn = _build.kernel(name, _WGRAD_ARGTYPES)
    err = fn(x.data_ptr(), g.data_ptr(), part_w.data_ptr(), part_b.data_ptr(),
             dw.data_ptr(), db.data_ptr(), B, T, cin, cout, K, dilation,
             0 if slope is None else 1, 0.0 if slope is None else float(slope),
             n_splits, _build.stream_handle(x.device))
    _build.check(err, name)
    window_conv_wgrad.launches += 1
    return dw, db


window_conv.launches = 0
window_conv_dx.launches = 0
window_conv_wgrad.launches = 0


class WindowConv1d(torch.autograd.Function):
    """`window_conv` with its backward on `window_conv_dx` and
    `window_conv_wgrad` (the JAX package's `window_conv1d` custom VJP)."""

    @staticmethod
    def forward(ctx, x, weight, bias, dilation, slope):
        ctx.save_for_backward(x, weight)
        ctx.dilation, ctx.slope = dilation, slope
        ctx.has_bias = bias is not None
        return window_conv(x, weight, bias, dilation, slope)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = window_conv_dx(g, weight, ctx.dilation, x, ctx.slope)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw32, db32 = window_conv_wgrad(x, g, weight.shape[0],
                                           ctx.dilation, ctx.slope)
            dw = dw32.to(weight.dtype)
            db = db32.to(weight.dtype) if ctx.has_bias else None
        return dx, dw, db, None, None
