"""Gated residual blocks of the HN-uSFGAN vocoder, one kernel each.

`pd_adaptive_block` computes, on channels-last (B, T, R) x and (B, T, A) c,

    h = x @ wC + xP @ wP + xF @ wF + c @ wA + ((bC + bP) + bF)
    z = tanh(h[..., :G/2]) * sigmoid(h[..., G/2:])
    y = (z @ wO + bO + x) * sqrt(0.5)

with xP[t] = x[t - s], xF[t] = x[t + s] (zero outside [0, T)), s the pitch
shift of t's frame (`shifts` (B, T / hop) int32). `pd_fixed_block` is the
same block with the taps of a reflect-padded K=3 dilated conv in place of
the pitch gather: x[t - dil] @ w[0] + x[t] @ w[1] + x[t + dil] @ w[2].
Products are summed in f32, the gate runs in f32, z is rounded to x's type
before the out product, and y is cast to x's type.

`pd_fixed_chain` applies K fixed blocks back to back in one kernel, each
stage reflect-padding its own input, as the blocks applied one after
another do (each stage's output rounded to x's type, each stage on the
block kernels' own code at its widths: the same bits).

They replace the TPU kernels `svcc23_fastsvc_tpu/ops/pallas_pd_block.py::
pd_adaptive_block`, `pd_fixed_block` and `pd_fixed_chain`; the CUDA
sources are `csrc/pd_block.cuh` (the block's math on a group of rows),
`csrc/pd_block.cu` and `csrc/pd_chain.cu`, whose headers say how the TPU
kernels' halo windows became per-row source indices and what bounds the
kernels on the H100. Which of the block kernels' variants runs (tensor
cores in bf16, FFMA otherwise, and a walk that streams the weights for
widths past R 64, G 128 or 3R + A 272) and its tile is `block_plan`, a
function of dtype and widths alone that the C entries check; `chain_plan`
adds the chain's grid, the run of rows each block of threads takes and its
scratch. Every width the JAX kernels take runs on the card.

`params` follow the JAX package's block layout: {"convC", "convP",
"convF", "aux", "out"} (adaptive) or {"conv", "aux", "out"} (fixed), each
{"w": WIO (K, C_in, C_out)[, "b": (C_out,)]}; a weight may be any strided
view (the vocoder passes views of its torch-layout parameters).

On a CUDA tensor each wrapper launches its kernel or raises. On a CPU
tensor it takes its plain PyTorch version (`*_plain`), which the tests and
`chip_smoke.py` hold the kernels against.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .conv import reflect_pad1d

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the widths the mma and ffma walks hold (their whole gate weight in shared
# memory); the wide walk takes the rest
MAX_RESIDUAL = 64  # kMaxR in csrc/pd_block.cuh
MAX_GATE = 128     # 2 * kMaxHalf
MAX_FEATURES = 272  # kMaxFeatures in csrc/pd_block.cuh: 3R + A at most
MAX_CHAIN = 16     # kMaxChain in csrc/pd_chain.cu
_MAX_WIDTH = 1 << 20  # R, A and G the C entries take


class _Weights(ctypes.Structure):
    """PdBlockWeights in csrc/pd_block.cuh: every field 8 bytes, same order."""

    _fields_ = [
        ("w", ctypes.c_void_p * 3),
        ("w_si", ctypes.c_longlong * 3), ("w_so", ctypes.c_longlong * 3),
        ("wa", ctypes.c_void_p),
        ("wa_si", ctypes.c_longlong), ("wa_so", ctypes.c_longlong),
        ("bg", ctypes.c_void_p * 3),
        ("wo", ctypes.c_void_p),
        ("wo_si", ctypes.c_longlong), ("wo_so", ctypes.c_longlong),
        ("bo", ctypes.c_void_p),
    ]


class _Args(ctypes.Structure):
    """PdBlockArgs in csrc/pd_block.cu: every field 8 bytes, same order."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("c", ctypes.c_void_p),
        ("shifts", ctypes.c_void_p),
        ("wt", _Weights),
        ("y", ctypes.c_void_p), ("zbuf", ctypes.c_void_p),
        ("B", ctypes.c_longlong), ("T", ctypes.c_longlong),
        ("R", ctypes.c_longlong), ("A", ctypes.c_longlong),
        ("G", ctypes.c_longlong), ("hop", ctypes.c_longlong),
        ("n_frames", ctypes.c_longlong), ("dil", ctypes.c_longlong),
        ("variant", ctypes.c_longlong), ("tile_rows", ctypes.c_longlong),
        ("n_blocks", ctypes.c_longlong),
    ]


class _ChainArgs(ctypes.Structure):
    """PdChainArgs in csrc/pd_chain.cu: every field 8 bytes, same order."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("c", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p), ("zbuf", ctypes.c_void_p),
        ("B", ctypes.c_longlong), ("T", ctypes.c_longlong),
        ("R", ctypes.c_longlong), ("A", ctypes.c_longlong),
        ("G", ctypes.c_longlong), ("K", ctypes.c_longlong),
        ("variant", ctypes.c_longlong), ("tile_rows", ctypes.c_longlong),
        ("n_blocks", ctypes.c_longlong), ("seg_rows", ctypes.c_longlong),
        ("region_rows", ctypes.c_longlong),
        ("dil", ctypes.c_longlong * MAX_CHAIN),
        ("blk", _Weights * MAX_CHAIN),
    ]


_ARGTYPES = [ctypes.POINTER(_Args), ctypes.c_void_p]
_CHAIN_ARGTYPES = [ctypes.POINTER(_ChainArgs), ctypes.c_void_p]

# The block kernels' plan: variant ids of csrc/pd_block.cuh's enum, and the
# rows of a tile each variant's instance is compiled for. The grid is
# persistent: one block per SM of an H100, at most one per tile.
BLOCK_VARIANTS = {"mma": 0, "ffma": 1, "wide": 2}
_BLOCK_TILE_ROWS = {"mma": 128, "ffma": 256, "wide": 64}
_SMS = 132
_SMEM_BYTES = 232448  # shared memory a block may use on the H100


def _mma_smem_bytes(R: int, A: int) -> int:
    """mma_smem_bytes in csrc/pd_block.cu: two stages of 128 gathered rows
    and the gate weight (rows of 3R + A features padded to 16, plus eight),
    Wo, the biases and the run of c's rows."""
    ld = -(-(3 * R + A) // 16) * 16 + 8
    return (2 * (2 * 128 + MAX_GATE) * ld + 2 * MAX_RESIDUAL * 72
            + 4 * (MAX_GATE + MAX_RESIDUAL) + ((128 * A * 2 + 31) & ~15))


def _held(R: int, A: int, G: int) -> bool:
    """Whether the mma and ffma walks hold a block of these widths: its
    whole gate weight in shared memory, R <= 64, G <= 128 and 3R + A <= 272
    (the vocoders here have 3R + A of 254-255)."""
    return R <= MAX_RESIDUAL and G <= MAX_GATE and 3 * R + A <= MAX_FEATURES


@functools.lru_cache(maxsize=None)
def block_plan(dtype, B: int, T: int, R: int, A: int, G: int) -> dict:
    """The block kernels' variant, tile rows and grid for (B, T, R) x,
    (B, T, A) c and a G-wide gate (cached: callers read it and never change
    it). The chain's stages take the same variant.

    bf16 with R a multiple of 8 runs on the tensor cores ("mma": the taps'
    rows come in as 16-byte copies) where its shared memory holds the
    widths; f32, and bf16 otherwise, on the FFMA loop ("ffma"); widths
    neither holds (`_held`) on the FFMA walk that streams the weights
    ("wide", with `z_elems` of scratch for its gate outputs). Only R < 1,
    A < 0, an odd G or widths past 2^20 raise. The grid is the smaller of
    the tile count and the SM count; block i takes tiles i, i + n_blocks,
    ... (mma and ffma load the block's weights once).
    """
    if not (1 <= R <= _MAX_WIDTH and 0 <= A <= _MAX_WIDTH
            and 2 <= G <= _MAX_WIDTH and G % 2 == 0):
        raise ValueError(f"the block kernels take R >= 1, A >= 0 and an even "
                         f"G >= 2 (each up to 2^20), got R={R} A={A} G={G}")
    if not _held(R, A, G):
        variant = "wide"
    elif dtype == torch.bfloat16 and R % 8 == 0 \
            and _mma_smem_bytes(R, A) <= _SMEM_BYTES:
        variant = "mma"
    else:
        variant = "ffma"
    rows = _BLOCK_TILE_ROWS[variant]
    tiles = B * -(-T // rows)
    n_blocks = max(1, min(tiles, _SMS))
    return {"variant": variant, "tile_rows": rows, "tiles": tiles,
            "n_blocks": n_blocks,
            "z_elems": n_blocks * rows * (G // 2) if variant == "wide"
            else 0}


@functools.lru_cache(maxsize=None)
def chain_plan(dtype, B: int, T: int, R: int, A: int, G: int,
               dilations: tuple) -> dict:
    """The chain kernel's plan: `block_plan`'s variant and tile rows (its
    stages run the block kernels' walks), a grid of one block of threads per
    SM (at most one per tile), the run of `seg_rows` of the flattened
    (B * T) rows each takes, and the rows of each of its two scratch regions
    (its run and the halo, sum(dilations) rows, on either side), and the
    wide walk's z scratch. Up to MAX_CHAIN blocks, any dilations; widths
    raise as in `block_plan`."""
    if not 1 <= len(dilations) <= MAX_CHAIN:
        raise ValueError(f"the chain kernel takes 1 to {MAX_CHAIN} blocks, "
                         f"got {len(dilations)}")
    bp = block_plan(dtype, B, T, R, A, G)
    seg = -(-B * T // bp["n_blocks"])
    n_blocks = -(-B * T // seg)  # every block of threads has rows
    region = seg + 2 * sum(dilations)
    return {"variant": bp["variant"], "tile_rows": bp["tile_rows"],
            "n_blocks": n_blocks, "seg_rows": seg, "region_rows": region,
            "scratch_rows": 2 * n_blocks * region if len(dilations) > 1
            else 0,
            "z_elems": n_blocks * bp["tile_rows"] * (G // 2)
            if bp["variant"] == "wide" else 0}


def pd_block_halo(dilation: int, fs: int, dense: int = 4,
                  f0_floor: float = 37.5, hop: int = 160) -> int:
    """The largest pitch shift the adaptive block takes at this dilation:
    round(d * dil) with d = fs / (f0 * dense) <= fs / (f0_floor * dense),
    plus one, rounded up to a multiple of lcm(hop, 32). The caller clamps
    the shifts to it (the JAX package's halo rule; f0 below f0_floor is out
    of contract)."""
    reach = int(math.ceil(dilation * fs / (f0_floor * dense))) + 1
    g = hop * 32 // math.gcd(hop, 32)
    return g * max(1, -(-reach // g))


def frame_shifts(d, dilation: int, hop: int, halo: int):
    """(B, T) f32 dilation factors -> (B, T / hop) int32 shifts
    clip(round(d[:, ::hop] * dilation), 0, halo), rounded half to even."""
    s = torch.round(d[:, ::hop] * dilation)
    return s.clamp(0, halo).to(torch.int32)


def masked_gather(x, idx):
    """x[b, idx[b, t]] over (B, T, C) x, zero where idx is outside [0, T)."""
    B, T, C = x.shape
    valid = (idx >= 0) & (idx <= T - 1)
    g = torch.gather(x, 1, idx.clamp(0, T - 1)[:, :, None].expand(B, T, C))
    return torch.where(valid[:, :, None], g, torch.zeros_like(g))


def shift_gather(x, shifts, hop: int):
    """(xP, xF): x[t - s] and x[t + s] with s = shifts[:, t // hop], zero
    outside [0, T)."""
    s = torch.repeat_interleave(shifts.long(), hop, dim=1)
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    return masked_gather(x, t - s), masked_gather(x, t + s)


def _wide(t):
    """t in f32, or f64 where it is f64 (a CPU reference in double)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _gated(x, taps, c, wa, bg, wo, bo):
    """The block math shared by both plain versions; `taps` are the (input,
    weight) pairs in the JAX kernels' order of summation."""
    h = None
    for xt, w in taps:
        p = _wide(xt) @ _wide(w)
        h = p if h is None else h + p
    h = h + _wide(c) @ _wide(wa) + _wide(bg)
    g2 = h.shape[-1] // 2
    z = (torch.tanh(h[..., :g2]) * torch.sigmoid(h[..., g2:])).to(x.dtype)
    out = _wide(z) @ _wide(wo) + _wide(bo)
    return ((out + _wide(x)) * math.sqrt(0.5)).to(x.dtype)


def adaptive_block_gathered(x, xP, xF, c, params):
    """The adaptive block's math on gathered xP, xF (any gather: the
    vocoder's per-sample one too)."""
    w = {k: params[k]["w"][0] for k in ("convC", "convP", "convF")}
    bg = (params["convC"]["b"] + params["convP"]["b"]) + params["convF"]["b"]
    return _gated(x, [(x, w["convC"]), (xP, w["convP"]), (xF, w["convF"])],
                  c, params["aux"]["w"][0], bg, params["out"]["w"][0],
                  params["out"]["b"])


def pd_adaptive_block_plain(x, c, shifts, params, *, hop: int):
    """Plain PyTorch version: the frame-shift gather, then the block math."""
    return adaptive_block_gathered(x, *shift_gather(x, shifts, hop), c,
                                   params)


def pd_fixed_block_plain(x, c, params, *, dilation: int):
    """Plain PyTorch version: reflect pad, the three conv taps as shifted
    slices, then the block math."""
    T = x.shape[1]
    xp = reflect_pad1d(x, dilation)
    w = params["conv"]["w"]
    return _gated(x, [(xp[:, k * dilation:k * dilation + T], w[k])
                      for k in range(3)],
                  c, params["aux"]["w"][0], params["conv"]["b"],
                  params["out"]["w"][0], params["out"]["b"])


def fixed_chain_offsets(dilations):
    """The JAX chain kernel's 32-aligned stage offsets: stage j reads stage
    j-1 at +-d_j, so A_j >= A_{j-1} + d_j, rounded up to 32 rows; the last
    is the chain's halo. The card's kernel needs only the exact reach, the
    sum of the dilations; the model groups its runs of blocks by this halo,
    so both packages chain the same runs."""
    offs, cur = [], 0
    for d in dilations:
        cur = 32 * max(1, -(-(cur + d) // 32))
        offs.append(cur)
    return offs


def pd_fixed_chain_plain(x, c, params_list, *, dilations):
    """Plain PyTorch version: the fixed blocks one after another, each
    reflect-padding its own input."""
    for params, dil in zip(params_list, dilations):
        x = pd_fixed_block_plain(x, c, params, dilation=dil)
    return x


def _check(x, c, R, A, G):
    if x.dim() != 3 or c.dim() != 3 or c.shape[:2] != x.shape[:2]:
        raise ValueError(f"want x (B, T, R) and c (B, T, A), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if x.shape[2] != R or c.shape[2] != A or G % 2:
        raise ValueError(f"block weights ({R}, {A}, {G}) do not fit x "
                         f"{tuple(x.shape)} and c {tuple(c.shape)}")


def _check_fixed(x, c, params):
    """The fixed block's (taps, wa, biases, wo, bo), after checking that
    its weights fit x and c."""
    w = params["conv"]["w"]
    if w.shape[0] != 3:
        raise ValueError(f"a fixed block takes a K=3 conv, got K={w.shape[0]}")
    R, G = w.shape[1:]
    _check(x, c, R, params["aux"]["w"].shape[1], G)
    return ((w[0], w[1], w[2]), params["aux"]["w"][0], [params["conv"]["b"]],
            params["out"]["w"][0], params["out"]["b"])


def _cuda_args(name, x, c, parts):
    """Raise unless the kernel takes x, c and the blocks' weights `parts`."""
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"{name} kernel takes f32 or bf16, not {x.dtype}")
    for taps, wa, biases, wo, bo in parts:
        for t in (c, wa, wo, bo, *taps, *biases):
            if t.dtype != x.dtype or t.device != x.device:
                raise ValueError(f"{name}: x, c and the weights must share "
                                 "dtype and device")
        for t in (bo, *biases):
            if not t.is_contiguous():
                raise ValueError(f"{name} needs contiguous biases")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"{name} needs contiguous x and c")
    if x.shape[0] * x.shape[1] >= 2 ** 31:
        raise ValueError(f"{name} takes fewer than 2^31 rows")


def _fill(wt, taps, wa, biases, wo, bo):
    """One block's pointers and strides into a _Weights."""
    for i, w in enumerate(taps):
        wt.w[i] = w.data_ptr()
        wt.w_si[i], wt.w_so[i] = w.stride()
    wt.wa, (wt.wa_si, wt.wa_so) = wa.data_ptr(), wa.stride()
    for i, bias in enumerate(biases):
        wt.bg[i] = bias.data_ptr()
    wt.wo, (wt.wo_si, wt.wo_so) = wo.data_ptr(), wo.stride()
    wt.bo = bo.data_ptr()


def _run(name, x, args, argtypes):
    """Launch `name`_f32 or _bf16 with its argument structure on x's
    stream."""
    full = f"{name}_{_SUFFIX[x.dtype]}"
    fn = _build.kernel(full, argtypes)
    _build.check(fn(ctypes.byref(args), _build.stream_handle(x.device)), full)


def _zbuf(x, plan):
    """The wide walk's scratch for its gate outputs (empty for the
    others)."""
    return torch.empty(plan["z_elems"], dtype=x.dtype, device=x.device)


def _launch(name, x, c, parts, *, shifts=None, hop=0, dilation=0):
    """Fill PdBlockArgs with the plan and launch `name`_f32 or _bf16 on x's
    stream."""
    _cuda_args(name, x, c, [parts])
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    B, T, R = x.shape
    plan = block_plan(x.dtype, B, T, R, *parts[1].shape)
    # the kernels copy x's and c's rows in 16-byte pieces (fresh
    # allocations always qualify)
    if x.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError(f"{name} needs x and c 16-byte aligned")
    zbuf = _zbuf(x, plan)
    a = _Args()
    a.x, a.c, a.y = x.data_ptr(), c.data_ptr(), y.data_ptr()
    a.zbuf = zbuf.data_ptr() if zbuf.numel() else None
    a.shifts = None if shifts is None else shifts.data_ptr()
    _fill(a.wt, *parts)
    a.B, a.T, a.R, a.A, a.G = B, T, R, *parts[1].shape
    a.hop, a.dil = hop, dilation
    a.n_frames = 0 if shifts is None else shifts.shape[1]
    a.variant = BLOCK_VARIANTS[plan["variant"]]
    a.tile_rows, a.n_blocks = plan["tile_rows"], plan["n_blocks"]
    _run(name, x, a, _ARGTYPES)
    return y


def pd_adaptive_block(x, c, shifts, params, *, hop: int):
    """Adaptive block: (B, T, R) -> (B, T, R), T % hop == 0, shifts (B,
    T / hop) int32 (clamped by the caller, see `frame_shifts`; a tap past
    either end of the stream reads zero, whatever the shift)."""
    wC, wP, wF = (params[k]["w"] for k in ("convC", "convP", "convF"))
    R, G = wC.shape[1:]
    _check(x, c, R, params["aux"]["w"].shape[1], G)
    B, T, _ = x.shape
    if hop < 1 or T % hop or tuple(shifts.shape) != (B, T // hop):
        raise ValueError(f"want T % hop == 0 and shifts (B, T / hop), got T="
                         f"{T} hop={hop} shifts {tuple(shifts.shape)}")
    if x.device.type == "cpu":
        return pd_adaptive_block_plain(x, c, shifts, params, hop=hop)
    shifts = shifts.to(device=x.device, dtype=torch.int32).contiguous()
    y = _launch("pd_adaptive_block", x, c,
                ((wP[0], wC[0], wF[0]), params["aux"]["w"][0],
                 [params[k]["b"] for k in ("convC", "convP", "convF")],
                 params["out"]["w"][0], params["out"]["b"]),
                shifts=shifts, hop=hop)
    pd_adaptive_block.launches += 1
    return y


def pd_fixed_block(x, c, params, *, dilation: int):
    """Fixed block: (B, T, R) -> (B, T, R), K=3 conv weight, T > dilation."""
    parts = _check_fixed(x, c, params)
    if not 1 <= dilation < x.shape[1]:
        raise ValueError(f"pd_fixed_block needs 1 <= dilation < T, got "
                         f"dilation={dilation} T={x.shape[1]}")
    if x.device.type == "cpu":
        return pd_fixed_block_plain(x, c, params, dilation=dilation)
    y = _launch("pd_fixed_block", x, c, parts, dilation=dilation)
    pd_fixed_block.launches += 1
    return y


def pd_fixed_chain(x, c, params_list, *, dilations):
    """K fixed blocks back to back: (B, T, R) -> (B, T, R), block j at
    dilation dilations[j]. T must be at least twice the JAX kernel's chain
    halo (`fixed_chain_offsets`), as the JAX function requires; unlike it,
    any T (not only multiples of 32) is taken. On the card up to MAX_CHAIN
    blocks, at any widths and dilations."""
    dilations = tuple(int(d) for d in dilations)
    K = len(dilations)
    if K < 1 or len(params_list) != K:
        raise ValueError(f"pd_fixed_chain: {len(params_list)} blocks for "
                         f"dilations {dilations}")
    if min(dilations) < 1:
        raise ValueError(f"pd_fixed_chain: dilations {dilations} below 1")
    parts = [_check_fixed(x, c, p) for p in params_list]
    T = x.shape[1]
    halo = fixed_chain_offsets(dilations)[-1]
    if T < 2 * halo:
        raise ValueError(f"pd_fixed_chain: T ({T}) must be >= 2 * chain "
                         f"halo ({2 * halo})")
    if x.device.type == "cpu":
        return pd_fixed_chain_plain(x, c, params_list, dilations=dilations)
    if K > MAX_CHAIN:
        raise ValueError(f"pd_fixed_chain kernel takes up to {MAX_CHAIN} "
                         f"blocks, got {K}")
    _cuda_args("pd_fixed_chain", x, c, parts)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    B, _, R = x.shape
    A, G = parts[0][1].shape
    if any(tuple(p[1].shape) != (A, G) for p in parts):
        raise ValueError("pd_fixed_chain: the blocks' widths differ")
    plan = chain_plan(x.dtype, B, T, R, A, G, dilations)
    # the stages copy their input rows in 16-byte pieces
    if x.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("pd_fixed_chain needs x and c 16-byte aligned")
    scratch = torch.empty((plan["scratch_rows"], R), dtype=x.dtype,
                          device=x.device)
    zbuf = _zbuf(x, plan)
    a = _ChainArgs()
    a.x, a.c, a.y = x.data_ptr(), c.data_ptr(), y.data_ptr()
    a.scratch = scratch.data_ptr() if scratch.numel() else None
    a.zbuf = zbuf.data_ptr() if zbuf.numel() else None
    a.B, a.T, a.R, a.A, a.G, a.K = B, T, R, A, G, K
    a.variant = BLOCK_VARIANTS[plan["variant"]]
    a.tile_rows, a.n_blocks = plan["tile_rows"], plan["n_blocks"]
    a.seg_rows, a.region_rows = plan["seg_rows"], plan["region_rows"]
    for j, (d, p) in enumerate(zip(dilations, parts)):
        a.dil[j] = d
        _fill(a.blk[j], *p)
    _run("pd_fixed_chain", x, a, _CHAIN_ARGTYPES)
    pd_fixed_chain.launches += 1
    return y


pd_adaptive_block.launches = 0
pd_fixed_block.launches = 0
pd_fixed_chain.launches = 0
