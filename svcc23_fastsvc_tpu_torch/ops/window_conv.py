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
what bounds them on the H100 and how each variant is tiled. Which variant
runs, and its tiles, slabs and slots, is `fwd_plan` and `wgrad_plan` here:
functions of dtype and shapes alone, checked by the C entries.

On a CUDA tensor each wrapper launches its kernel or raises. On a CPU
tensor it takes its plain PyTorch version (`*_plain`), which the tests and
`chip_smoke.py` hold the kernels against.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float] + [
    ctypes.c_int] * 3 + [ctypes.c_void_p]
_DX_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
_WGRAD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# The kernels' plans. Each is a function of dtype and shapes alone, and the
# C entries check it against the instances compiled in csrc/ (a plan that
# matches none is refused with a CUDA error, never run).
#
# Forward (and dx, and the fused conv's forward): variant ids and tiles of
# csrc/window_conv.cuh::dispatch_window_conv, (tm rows, tn columns).
FWD_VARIANTS = {"mma": 0, "ffma": 1}
_MMA_KC = 32  # the mma forward's input channels per chunk (kMmaKC)
_FWD_MMA_TILES = ((256, 24), (256, 48), (256, 64), (128, 128))
# ffma: 8 rows a thread, or 4 where 8 would leave more than half of an
# H100's SMs without a block (4 rows a thread measured slower at 96 blocks,
# faster at 16)
_FWD_FFMA_TILES = ((256, 32), (128, 32), (128, 64), (64, 64))
_SMS = 132
# wgrad: variant ids of csrc/window_conv_grad.cu; the slots fill an H100
# (132 SMs, 3 blocks each) and hold at most _WGRAD_MAX_WORDS f32 words
WGRAD_VARIANTS = {"mma": 0, "ffma": 1, "stream": 2}
_WGRAD_BLOCKS = 3 * 132
_WGRAD_MAX_WORDS = 16 * 2 ** 20
# rows of one row tile: the mma variant's 128 halve the halo a d27 window
# re-reads per row; the ffma variant's f32 window keeps to 64
_WGRAD_ROWS = {"mma": 128, "ffma": 64}
_WGRAD_MMA_MAX_PPW = 3   # (tap, 16-channel) pairs per warp, 8 warps
_WGRAD_FFMA_OCS = 32     # output channels per ffma slab
_STREAM_MAX_K = 7


@functools.lru_cache(maxsize=None)
def fwd_plan(dtype, B: int, T: int, cin: int, cout: int) -> dict:
    """The forward kernel's variant and tile for a (B, T, Cin) -> Cout conv
    (cached: callers read it and never change it).

    bf16 with Cin a multiple of 8 and at least 16 runs on the tensor cores
    ("mma"), everything else (f32 always, bf16 at Cin = 1 and other widths)
    on the FFMA loop. The mma tile is the one that computes the fewest
    padding columns, the widest on a tie; rows follow from it. The ffma
    tile is 32 or 64 columns wide, with the taller rows unless they leave
    fewer blocks than half the SMs.
    """
    if dtype == torch.bfloat16 and cin % 8 == 0 and cin >= 16:
        tm, tn = min(_FWD_MMA_TILES,
                     key=lambda t: (-(-cout // t[1]) * t[1], -t[1]))
        return {"variant": "mma", "tm": tm, "tn": tn}
    tall, short = [t for t in _FWD_FFMA_TILES if t[1] == (32 if cout <= 32
                                                          else 64)]
    blocks = B * -(-T // tall[0]) * -(-cout // tall[1])
    tm, tn = tall if 2 * blocks >= _SMS else short
    return {"variant": "ffma", "tm": tm, "tn": tn}


@functools.lru_cache(maxsize=None)
def wgrad_plan(dtype, B: int, T: int, K: int, cin: int, cout: int) -> dict:
    """The weight gradient's variant, row tile, channel slabs and slots
    (cached: callers read it and never change it).

    Cin = 1 streams its rows ("stream", a row is a unit of the partition);
    bf16 with Cin a multiple of 8 and at least 16 and Cout a multiple of 8
    runs on the tensor cores ("mma"); the rest on the FFMA loop. The B*T
    rows are cut into `units` (row tiles of `rows` rows of one utterance,
    or single rows), and slot s sums units [units*s//n_slots,
    units*(s+1)//n_slots) of every channel slab into a scratch slot of its
    own: the fewest slots that give `_WGRAD_BLOCKS` blocks, at most one per
    unit, and at most `_WGRAD_MAX_WORDS` words of scratch.
    """
    epc = 8 if dtype == torch.bfloat16 else 4  # elements in 16 bytes
    tile = epc if cout % epc == 0 else 1
    if cin == 1 and K <= _STREAM_MAX_K and cout // tile <= 256:
        plan = {"variant": "stream", "rows": 1, "ics": 1, "tile_n": tile,
                "ppw": 0, "units": B * T}
    elif dtype == torch.bfloat16 and cin % 8 == 0 and cin >= 16 \
            and cout % 8 == 0:
        ics = min(64, -(-cin // 16) * 16)
        while K * ics // 16 > 8 * _WGRAD_MMA_MAX_PPW:
            ics -= 16
        plan = {"variant": "mma", "rows": _WGRAD_ROWS["mma"], "ics": ics,
                "tile_n": 24 if cout <= 24 else 48,
                "ppw": -(-(K * ics // 16) // 8)}
    else:
        plan = {"variant": "ffma", "rows": _WGRAD_ROWS["ffma"],
                "ics": 4 * min(8, 64 // K), "tile_n": _WGRAD_FFMA_OCS,
                "ppw": 0}
    if plan["variant"] != "stream":
        plan["units"] = B * -(-T // plan["rows"])
    plan["n_islabs"] = -(-cin // plan["ics"])
    plan["n_oslabs"] = 1 if plan["variant"] == "stream" else \
        -(-cout // plan["tile_n"])
    groups = plan["n_islabs"] * plan["n_oslabs"]
    words = K * cin * cout + cout
    plan["n_slots"] = max(1, min(plan["units"], -(-_WGRAD_BLOCKS // groups),
                                 _WGRAD_MAX_WORDS // words))
    return plan


def pack_scratch(plan: dict, K: int, cin: int, cout: int, device):
    """The mma forward's scratch for its packed weight (K, Cout, Cin padded
    to a whole chunk) in bf16, or None for the ffma variant."""
    if plan["variant"] != "mma":
        return None
    return torch.empty(K * cout * -(-cin // _MMA_KC) * _MMA_KC,
                       dtype=torch.bfloat16, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def slot_units(plan: dict, slot: int) -> range:
    """The units (row tiles, or rows) that `slot` of a wgrad plan sums."""
    n, s = plan["units"], plan["n_slots"]
    return range(n * slot // s, n * (slot + 1) // s)


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


def _aligned16(name, *tensors):
    """Raise unless every tensor starts on a 16-byte boundary: the kernels
    copy rows in 16-byte segments (fresh allocations always qualify)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned inputs")


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
    plan = fwd_plan(x.dtype, B, T, cin, cout)
    _aligned16("window_conv", x)
    name = f"window_conv_fwd_{_SUFFIX[x.dtype]}"
    fn = _build.kernel(name, _ARGTYPES)
    swk, swi, swo = weight.stride()
    wpack = pack_scratch(plan, K, cin, cout, x.device)
    err = fn(x.data_ptr(), weight.data_ptr(), _ptr(bias), y.data_ptr(),
             _ptr(wpack), B, T, cin, cout, K, dilation, swk, swi, swo,
             0 if slope is None else 1, 0.0 if slope is None else float(slope),
             FWD_VARIANTS[plan["variant"]], plan["tm"], plan["tn"],
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
    plan = fwd_plan(g.dtype, B, T, cout, cin)  # the dx conv: Cout -> Cin
    _aligned16("window_conv_dx", g)
    name = f"window_conv_dx_{_SUFFIX[g.dtype]}"
    fn = _build.kernel(name, _DX_ARGTYPES)
    swk, swi, swo = weight.stride()
    # the K flip: start at the last tap and step back (torch has no
    # negative strides, the kernel's pointer arithmetic has)
    last = weight.data_ptr() + (K - 1) * swk * weight.element_size()
    wpack = pack_scratch(plan, K, cout, cin, g.device)
    err = fn(g.data_ptr(), last,
             None if slope is None else x.data_ptr(), dx.data_ptr(),
             _ptr(wpack), B, T, cout, cin, K, dilation, -swk, swo, swi,
             0.0 if slope is None else float(slope),
             FWD_VARIANTS[plan["variant"]], plan["tm"], plan["tn"],
             _build.stream_handle(g.device))
    _build.check(err, name)
    window_conv_dx.launches += 1
    return dx


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
    plan = wgrad_plan(x.dtype, B, T, K, cin, cout)
    _aligned16("window_conv_wgrad", x, g)
    n_slots = plan["n_slots"]
    part_w = torch.empty((n_slots, K, cin, cout), dtype=torch.float32,
                         device=x.device)
    part_b = torch.empty((n_slots, cout), dtype=torch.float32,
                         device=x.device)
    name = f"window_conv_wgrad_{_SUFFIX[x.dtype]}"
    fn = _build.kernel(name, _WGRAD_ARGTYPES)
    err = fn(x.data_ptr(), g.data_ptr(), part_w.data_ptr(), part_b.data_ptr(),
             dw.data_ptr(), db.data_ptr(), B, T, cin, cout, K, dilation,
             0 if slope is None else 1, 0.0 if slope is None else float(slope),
             WGRAD_VARIANTS[plan["variant"]], plan["rows"], n_slots,
             plan["ics"], plan["n_islabs"], plan["n_oslabs"], plan["tile_n"],
             plan["ppw"], _build.stream_handle(x.device))
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
