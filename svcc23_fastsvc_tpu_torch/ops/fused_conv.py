"""Fused stride-1 conv with an asymmetric "same" padding and a fused input
leaky-relu, and its one-pass backward.

Counterpart of `svcc23_fastsvc_tpu/ops/pallas_conv.py`. `fused_conv1d`
computes, on channels-last (B, T, Cin) input and a WIO (K, Cin, Cout)
weight, K in [2, 5], pads (lo, hi) with lo + hi = (K-1)*dilation,

    y[t] = sum_k act(x)[t - lo + k*dil] @ w[k] + b,

with zero padding and act = leaky_relu(., slope) computed as the JAX
kernel's `_leaky` computes it: the slope rounded to x's dtype, the product
rounded to it. `fused_conv1d_bwd` computes dx, dw and db in one pass over
(x, g): dx is the conv of g with pads (hi, lo) and the weight reversed in K
and transposed, times where(x >= 0, 1, slope) in f32, rounded once; dw
(K, Cin, Cout) and db (Cout,) are f32 sums. `FusedConv1d` is the autograd
Function that joins the two, as `pallas_conv1d`'s custom VJP does: the
forward saves the pre-activation x and the weight; dw is cast to the
weight's dtype, db from f32 to it.

The kernels replace `pallas_conv.py::_fwd_call` (#5) and `_bwd_call` (#6);
their source is `csrc/fused_conv.cu`, whose header says what bounds them on
the H100. The forward runs #2's template on `window_conv.fwd_plan`; the
backward's variant (tensor cores, FFMA or a stream at Cin = 1), row tile,
channel slabs and slots are `bwd_plan`'s, from dtype and shapes alone. `ops.conv.conv1d` routes a conv here when the mode (the
`FASTSVC_PALLAS_CONV` environment variable, as in the JAX package) is on
and `fused_conv1d_supported` holds.

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
from .window_conv import (
    FWD_VARIANTS,
    _aligned16,
    _ptr,
    fwd_plan,
    pack_scratch,
)

HALO = 64  # the largest reach (K-1)*dilation, as in the JAX kernel
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float] + [
    ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_float] + [
    ctypes.c_int] * 6 + [ctypes.c_void_p]

# The backward's plan (csrc/fused_conv.cu): variant ids, rows of a row tile
# per variant, and the limits of its instances. The slots of the mma and
# ffma variants fill an H100 at one block per SM (their shared memory), the
# stream variant's at three; the slot scratch holds at most _MAX_SLOT_WORDS
# f32 words (64 MB).
BWD_VARIANTS = {"mma": 0, "ffma": 1, "stream": 2}
# rows of a row tile: the stream variant's 256; the others' 256 where a
# slab is at most _WIDE_SLAB channels wide (the per-tile costs are spread
# over four times the rows), else 64
BWD_ROWS = {"mma": (64, 256), "ffma": (64, 256), "stream": (256,)}
_WIDE_SLAB = 32
_BWD_BLOCKS_PER_SM = {"mma": 1, "ffma": 1, "stream": 3}
_SMS = 132
_MAX_SLOT_WORDS = 1 << 24
_SMEM_BYTES = 232448       # shared memory a block may use on the H100
_MMA_PAIRS_PER_WARP = {64: 9, 256: 3}  # the mma instances' PW
_MMA_DW_TILES = 3          # kBwDwTiles
_MMA_MAX_SLAB = 96         # kBwMmaMaxSlab
_MMA_MAX_OUT = 192         # kBwMaxOut
_FFMA_UNITS = 4 * 256      # kBwUnits x threads
_FFMA_MAX_SLAB = 128       # kBwFfMaxSlab
_STREAM_MAX_OUT = 64       # kStreamMaxOut


def fused_conv1d_supported(x_shape, w_shape, *, stride, groups, lo, hi,
                           dilation) -> bool:
    """The JAX package's `pallas_conv1d_supported`: stride 1, ungrouped,
    K in [2, 5], reach (K-1)*dilation <= 64, 0 <= lo, hi <= 64, lo + hi the
    reach (the output as long as the input) and T >= 256."""
    if stride != 1 or groups != 1 or len(x_shape) != 3:
        return False
    K = w_shape[0]
    span = (K - 1) * dilation
    if not 2 <= K <= 5 or span > HALO:
        return False
    if lo < 0 or hi < 0 or max(lo, hi) > HALO or lo + hi != span:
        return False
    return x_shape[1] >= 256


def _wide(t):
    """t in f32, or f64 where it is f64 (a CPU reference in double)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def stream_slope(slope, dtype) -> float:
    """The leaky slope rounded to the stream dtype, as the JAX kernel's
    `x * slope` rounds the Python float."""
    return float(torch.tensor(slope, dtype=dtype))


def _activate(x, slope):
    """act(x) as the JAX kernel computes it, widened for the sums."""
    h = _wide(x)
    if slope is not None:
        neg = (h * stream_slope(slope, x.dtype)).to(x.dtype)
        h = torch.where(h >= 0, h, _wide(neg))
    return h


def fused_conv1d_plain(x, weight, bias, lo: int, hi: int, dilation: int,
                       slope=None):
    """Plain PyTorch version: K shifted slices, one matmul each, f32 sums."""
    K = weight.shape[0]
    T = x.shape[1]
    hp = F.pad(_activate(x, slope), (0, 0, lo, hi))
    w = _wide(weight)
    y = hp[:, 0:T] @ w[0]
    for k in range(1, K):
        y = y + hp[:, k * dilation:k * dilation + T] @ w[k]
    if bias is not None:
        y = y + _wide(bias)
    return y.to(x.dtype)


def fused_conv1d_bwd_plain(x, g, weight, lo: int, hi: int, dilation: int,
                           slope=None):
    """Plain PyTorch version of the backward: (dx in x's dtype, dw
    (K, Cin, Cout) and db (Cout,) in f32, f64 for f64 inputs)."""
    K, cin, _ = weight.shape
    B, T, _ = x.shape
    span = (K - 1) * dilation
    gw = _wide(g)
    gp = F.pad(gw, (0, 0, span - lo, span - hi))
    wt = _wide(weight).transpose(1, 2)
    dx = gp[:, 0:T] @ wt[K - 1]
    for k in range(1, K):
        dx = dx + gp[:, k * dilation:k * dilation + T] @ wt[K - 1 - k]
    if slope is not None:  # the mask's slope in f32 (f64 for f64 inputs)
        s = torch.tensor(slope, dtype=dx.dtype)
        dx = dx * torch.where(_wide(x) >= 0, torch.ones_like(s), s)
    hp = F.pad(_activate(x, slope), (0, 0, lo, hi))
    g2 = gw.reshape(B * T, -1)
    dw = torch.stack([
        hp[:, k * dilation:k * dilation + T].reshape(B * T, cin).t() @ g2
        for k in range(K)
    ])
    return dx.to(x.dtype), dw, g2.sum(0)


def _check(x, weight, bias, lo, hi, dilation):
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError(f"want x (B, T, Cin) and w (K, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    K, cin, cout = weight.shape
    if not fused_conv1d_supported(tuple(x.shape), tuple(weight.shape),
                                  stride=1, groups=1, lo=lo, hi=hi,
                                  dilation=dilation) or cin != x.shape[2]:
        raise ValueError(f"unsupported fused conv: x {tuple(x.shape)} w "
                         f"{tuple(weight.shape)} pads ({lo}, {hi}) "
                         f"dilation {dilation}")
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


def fused_conv1d(x, weight, bias=None, lo: int = 1, hi: int = 1,
                 dilation: int = 1, slope=None):
    """(B, T, Cin) -> (B, T, Cout): the forward kernel (#5)."""
    _check(x, weight, bias, lo, hi, dilation)
    if x.device.type == "cpu":
        return fused_conv1d_plain(x, weight, bias, lo, hi, dilation, slope)
    _cuda_only("fused_conv1d", x, bias)
    B, T, cin = x.shape
    K, _, cout = weight.shape
    y = torch.empty((B, T, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    plan = fwd_plan(x.dtype, B, T, cin, cout)  # #2's template and plan
    _aligned16("fused_conv1d", x)
    name = f"fused_conv_fwd_{_SUFFIX[x.dtype]}"
    fn = _build.kernel(name, _FWD_ARGTYPES)
    swk, swi, swo = weight.stride()
    wpack = pack_scratch(plan, K, cin, cout, x.device)
    err = fn(x.data_ptr(), weight.data_ptr(), _ptr(bias), y.data_ptr(),
             _ptr(wpack), B, T, cin, cout, K, dilation, lo, swk, swi, swo,
             0 if slope is None else 1,
             0.0 if slope is None else stream_slope(slope, x.dtype),
             FWD_VARIANTS[plan["variant"]], plan["tm"], plan["tn"],
             _build.stream_handle(x.device))
    _build.check(err, name)
    fused_conv1d.launches += 1
    return y


def _odd_ld(cols: int) -> int:
    """odd_ld in csrc/window_conv.cuh: an odd number of 16-byte bf16 units
    holding at least `cols`."""
    return 8 * ((cols // 8 + 1) | 1)


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _dw_groups(cout: int) -> int:
    """dw_groups in csrc/fused_conv.cu: the mma dw's groups of three n8
    output tiles, a power of two."""
    wq = 1
    while wq * _MMA_DW_TILES < cout // 8:
        wq *= 2
    return wq


def bwd_smem_bytes(variant: str, rows: int, isl: int, K: int, cout: int,
                   stages: int, span: int = HALO) -> int:
    """Shared memory of a backward block (mma_bwd_smem, ffma_bwd_smem,
    stream_bwd_smem in csrc/fused_conv.cu), at the largest reach unless
    `span` says otherwise."""
    wrows = rows + span
    if variant == "mma":
        gld = _odd_ld(_up(cout, 16))
        return 2 * (stages * wrows * (_odd_ld(_up(isl, 16)) + gld)
                    + K * isl * gld)
    if variant == "ffma":
        ocp = _up(cout, 8)
        area = max(stages * wrows * (_up(isl, 4) + 4 + ocp + 4), 256 * 33)
        return 4 * (area + K * ocp * _up(isl, 8))
    return 4 * (2 * wrows * (cout + 2) + K * cout + 256 * (K + 1))


@functools.lru_cache(maxsize=None)
def bwd_plan(dtype, B: int, T: int, K: int, cin: int, cout: int) -> dict:
    """The one-pass backward's variant, row tile, input-channel slabs,
    stages and slots (cached: callers read it and never change it).

    Cin = 1 streams ("stream") up to 64 output channels; bf16 with Cin and
    Cout multiples of 8, Cin >= 16 and Cout <= 192 runs on the tensor cores
    ("mma"); the rest on the FFMA loop ("ffma"). A block holds its slab of
    the weight and the dw sums of that slab, so the input channels are cut
    into slabs of `isl` only where one block cannot hold all of them: the
    widest slab whose dw pairs (mma) or units (ffma) the block's threads
    hold and whose stages fit in shared memory at the largest reach. A
    slab of at most 32 channels takes 256-row tiles, else 64. Two stages
    where they fit, else one. The B*T rows are cut into tiles of `rows`
    rows of one utterance, and slot s sums tiles [tiles*s//n_slots,
    tiles*(s+1)//n_slots) of every slab: the fewest slots that fill the
    SMs, at most one per tile and `_MAX_SLOT_WORDS` words of scratch.
    """
    def fits(variant, rows, isl, stages=1):
        return bwd_smem_bytes(variant, rows, isl, K, cout, stages) \
            <= _SMEM_BYTES

    if cin == 1 and cout <= _STREAM_MAX_OUT and fits("stream", 256, 1, 2):
        variant, isl = "stream", 1
    elif dtype == torch.bfloat16 and cin % 8 == 0 and cin >= 16 \
            and cout % 8 == 0 and cout <= _MMA_MAX_OUT:
        variant = "mma"
        pairs = (8 // _dw_groups(cout)) * _MMA_PAIRS_PER_WARP[64]
        isl = min(_MMA_MAX_SLAB, 16 * (pairs // K), _up(cin, 16))
        while isl > 16 and not fits("mma", 64, isl):
            isl -= 16
    else:
        variant = "ffma"
        isl = min(_FFMA_MAX_SLAB, _up(cin, 8))
        while isl > 8 and (K * (isl // 4) * _up(cout, 8) // 8 > _FFMA_UNITS
                           or not fits("ffma", 64, isl)):
            isl -= 8
    rows = BWD_ROWS[variant][0]
    if variant != "stream" and isl <= _WIDE_SLAB and fits(variant, 256, isl) \
            and (variant == "ffma" or K * -(-isl // 16) <= (
                8 // _dw_groups(cout)) * _MMA_PAIRS_PER_WARP[256]):
        rows = 256
    stages = 2 if fits(variant, rows, isl, 2) else 1
    n_islabs = -(-cin // isl)
    tiles = B * -(-T // rows)
    blocks = _BWD_BLOCKS_PER_SM[variant] * _SMS
    n_slots = max(1, min(tiles, -(-blocks // n_islabs),
                         _MAX_SLOT_WORDS // (K * cin * cout + cout)))
    return {"variant": variant, "rows": rows, "isl": isl,
            "n_islabs": n_islabs, "stages": stages, "tiles": tiles,
            "n_slots": n_slots}


def slot_tiles(plan: dict, slot: int) -> range:
    """The row tiles that `slot` of a backward plan sums."""
    n, s = plan["tiles"], plan["n_slots"]
    return range(n * slot // s, n * (slot + 1) // s)


def fused_conv1d_bwd(x, g, weight, lo: int, hi: int, dilation: int,
                     slope=None, *, need_dx: bool = True):
    """The one-pass backward kernel (#6): (dx or None, dw (K, Cin, Cout)
    f32, db (Cout,) f32) from the forward's pre-activation input x, the
    cotangent g and the weight."""
    _check(x, weight, None, lo, hi, dilation)
    if g.shape != x.shape[:2] + (weight.shape[2],) or g.dtype != x.dtype \
            or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype} and w "
                         f"{tuple(weight.shape)}")
    if x.device.type == "cpu":
        dx, dw, db = fused_conv1d_bwd_plain(x, g, weight, lo, hi, dilation,
                                            slope)
        return (dx if need_dx else None), dw, db
    _cuda_only("fused_conv1d_bwd", x, g)
    B, T, cin = x.shape
    K, _, cout = weight.shape
    dev = x.device
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty((K, cin, cout), dtype=torch.float32, device=dev)
    db = torch.empty((cout,), dtype=torch.float32, device=dev)
    plan = bwd_plan(x.dtype, B, T, K, cin, cout)
    _aligned16("fused_conv1d_bwd", x, g)
    n_slots = plan["n_slots"]
    part_w = torch.empty((n_slots, K, cin, cout), dtype=torch.float32,
                         device=dev)
    part_b = torch.empty((n_slots, cout), dtype=torch.float32, device=dev)
    name = f"fused_conv_bwd_{_SUFFIX[x.dtype]}"
    fn = _build.kernel(name, _BWD_ARGTYPES)
    swk, swi, swo = weight.stride()
    err = fn(x.data_ptr(), g.data_ptr(), weight.data_ptr(),
             None if dx is None else dx.data_ptr(), part_w.data_ptr(),
             part_b.data_ptr(), dw.data_ptr(), db.data_ptr(),
             B, T, cin, cout, K, dilation, lo, swk, swi, swo,
             0 if slope is None else 1,
             0.0 if slope is None else stream_slope(slope, x.dtype),
             0.0 if slope is None else float(slope),
             BWD_VARIANTS[plan["variant"]], plan["rows"], n_slots,
             plan["isl"], plan["n_islabs"], plan["stages"],
             _build.stream_handle(dev))
    _build.check(err, name)
    fused_conv1d_bwd.launches += 1
    return dx, dw, db


fused_conv1d.launches = 0
fused_conv1d_bwd.launches = 0


class FusedConv1d(torch.autograd.Function):
    """`fused_conv1d` with its backward on `fused_conv1d_bwd` (the JAX
    package's `pallas_conv1d` custom VJP)."""

    @staticmethod
    def forward(ctx, x, weight, bias, lo, hi, dilation, slope):
        ctx.save_for_backward(x, weight)
        ctx.conv = (lo, hi, dilation, slope)
        ctx.has_bias = bias is not None
        return fused_conv1d(x, weight, bias, lo, hi, dilation, slope)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw32, db32 = fused_conv1d_bwd(
            x, g.contiguous(), weight, *ctx.conv,
            need_dx=ctx.needs_input_grad[0])
        db = db32.to(weight.dtype) if ctx.has_bias else None
        return dx, dw32.to(weight.dtype), db, None, None, None, None
