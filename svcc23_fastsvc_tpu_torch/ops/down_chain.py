"""One FastSVC DownsampleBlock forward in one kernel (the down chain).

`down_chain_fwd` computes, on the nearest-downsampled channels-last input
x (B, T, Cin),

    h1 = conv1(leaky(x)), h2 = conv2(leaky(h1)), h3 = conv3(leaky(h2))
    y  = h3 + (x @ Wr + br)

with conv_j a K=3 "same" conv at dilation dilations[j] (1, 2, 4) and zero
padding, leaky slope 0.2 applied in f32 and rounded to x's type, sums in
f32 and each h_j rounded to x's type. The 1x1 residual stays in f32 and is
added to the rounded h3 before the one final rounding, as the TPU kernel
does; the unfused block (three window convs and a matmul) rounds the
residual first, so the two differ by at most one bf16 ulp (equal in f32).

It replaces the TPU kernel `svcc23_fastsvc_tpu/ops/pallas_down_chain.py::
down_chain_fwd`; the CUDA source is `csrc/down_chain.cu`, whose header
says how the TPU kernel's aligned halo window became the exact reach and
what bounds the kernel on the H100. Its variant (tensor cores in bf16, FFMA
in f32), row tile and grid are `down_plan`, a function of dtype, widths and
dilations alone that the C entry checks. The kernel reads the four weights
from a copy packed into its chunks' layout (`pack_weights`, one small kernel
of its own), made once for each set of weights and kept while they stay
unchanged. The kernel is forward only; the model routes a DownsampleBlock
to it when the down-chain mode is on (`set_down_chain_mode("1")`, default
"0") and grad is off.

`params` follow the JAX package's block layout {"conv1", "conv2",
"conv3", "res_conv"}, each {"w": WIO (K, C_in, C_out), "b": (C_out,)}; a
weight may be any strided view (the model passes views of its torch-layout
parameters). On a CUDA tensor the wrapper launches its kernel or raises. On
a CPU tensor it takes its plain PyTorch version (`down_chain_fwd_plain`),
which the tests and `chip_smoke.py` hold the kernel against.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build
# the JAX kernel's 32-aligned stage offsets, the same rule as the pd chain's
# (the card's kernel needs only the exact reach, sum(dilations))
from .pd_block import fixed_chain_offsets as chain_offsets  # noqa: F401
from .window_conv import _wide, window_conv_plain

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_CHANNELS = 192  # kMaxChannels in csrc/down_chain.cu
MAX_REACH = 32      # kMaxReach: the sum of the three dilations
SLOPE = 0.2
_CONVS = ("conv1", "conv2", "conv3", "res_conv")
_MODES = ("0", "1")
_mode = "0"


def set_down_chain_mode(mode: str) -> None:
    """"1" routes `models.fastsvc.DownsampleBlock` to `down_chain_fwd`
    when grad is off; "0" (the default) keeps its three window convs and
    the residual matmul. Spelled as the JAX package's
    `set_pallas_conv_mode`."""
    global _mode
    if mode not in _MODES:
        raise ValueError(f"down-chain mode {mode!r}: want one of {_MODES}")
    _mode = mode


def down_chain_mode() -> str:
    return _mode


class _Args(ctypes.Structure):
    """DownChainArgs in csrc/down_chain.cu: every field 8 bytes, same
    order."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
        ("w", ctypes.c_void_p * 4),
        ("w_sk", ctypes.c_longlong * 4), ("w_si", ctypes.c_longlong * 4),
        ("w_so", ctypes.c_longlong * 4),
        ("b", ctypes.c_void_p * 4),
        ("wpack", ctypes.c_void_p),
        ("B", ctypes.c_longlong), ("T", ctypes.c_longlong),
        ("Cin", ctypes.c_longlong), ("C", ctypes.c_longlong),
        ("dil", ctypes.c_longlong * 3),
        ("variant", ctypes.c_longlong), ("tile_rows", ctypes.c_longlong),
        ("n_blocks", ctypes.c_longlong),
    ]


_ARGTYPES = [ctypes.POINTER(_Args), ctypes.c_void_p]

# The kernel's plan, as csrc/down_chain.cu sizes it: variant ids of its
# enum; at most kMaxMt m16 tiles a warp (mma) or kMaxRpt rows a thread
# (ffma) in a stage; weight chunks of 32 (mma) or 16 (ffma) input channels,
# two in shared memory.
DOWN_VARIANTS = {"mma": 0, "ffma": 1}
_THREADS, _MAX_MT, _MAX_RPT, _MAX_TILE = 256, 3, 8, 1024
_CHUNK = {"mma": 32, "ffma": 16}
_CHUNK_LD = 40  # kChLd
_SMS = 132
_SMEM_BYTES = 232448  # shared memory a block of threads may use
_SM_SMEM = 233472     # an SM's, with 1 KB held for each block of threads
# a tile's fixed cost in the cost's units (one m16-tile row group of one
# 16-deep feature step): its window's load, the act pass and the barriers
_TILE_COST = 512


def _np(c):
    """dc_np: the output columns a stage computes."""
    return 24 if c <= 24 else 48 if c <= 48 else 96 if c <= 96 else 192


def _nt(c):
    return 3 if _np(c) == 24 else 6


def _wm(c):
    return 8 // (_np(c) // 8 // _nt(c))


def _ty(c):
    return _THREADS // (_np(c) // 8)


def _kd(variant, cs):
    return (cs + 15) & ~15 if variant == "mma" else (cs + 3) & ~3


def _ld(variant, cs):
    kd = _kd(variant, cs)
    return 8 * ((kd // 8) | 1) if variant == "mma" else kd + 4


def _buf_elems(variant, c):
    return (3 * _np(c) * _CHUNK_LD if variant == "mma"
            else 3 * _CHUNK["ffma"] * _np(c))


def pack_elems(variant, cin, c):
    """dc_pack_off(.., 4, ..): the packed weights' elements."""
    ch = _CHUNK[variant]
    return sum(-(-_kd(variant, cs) // ch) * K * _np(c) * ch
               for K, cs in ((3, cin), (3, c), (3, c), (1, cin)))


def smem_bytes(variant, S, H, cin, c):
    """dc_smem_bytes: x's S rows, two stage buffers of the window and two
    chunk buffers, for a tile of S rows at reach H."""
    ldx, ldc = _ld(variant, cin), _ld(variant, c)
    rows = S + 2 * H + 16
    esize = 2 if variant == "mma" else 4
    return ((S + 16) * ldx + rows * (max(ldx, ldc) + ldc)
            + 2 * _buf_elems(variant, c)) * esize


def max_tile(variant, cin, c, dilations):
    """dc_max_tile: the largest S whose stage-1 rows fit the warps' m16
    tiles (mma) or the threads' rows (ffma) and whose shared memory fits."""
    rows1 = (16 * _MAX_MT * _wm(c) if variant == "mma"
             else _MAX_RPT * _ty(c))
    S = min(_MAX_TILE, rows1 - 2 * (dilations[1] + dilations[2]))
    while S >= 1 and smem_bytes(variant, S, sum(dilations), cin, c) \
            > _SMEM_BYTES:
        S -= 1
    return S


def blocks_per_sm(variant, c, smem):
    """Blocks of threads an SM holds: two for the 24-column tensor-core
    instance (its launch bounds leave it 128 registers a thread) where
    their shared memory fits, else one."""
    two = variant == "mma" and _nt(c) == 3 and 2 * (smem + 1024) <= _SM_SMEM
    return 2 if two else 1


@functools.lru_cache(maxsize=None)
def down_plan(dtype, B: int, T: int, cin: int, c: int,
              dilations=(1, 2, 4)) -> dict:
    """The kernel's variant (bf16 on the tensor cores, f32 on the FFMA
    loop), row tile S and grid (cached: callers read it and never change
    it). S is the one, up to `max_tile`, that gives the fewest waves of the
    card's blocks of threads times the cost of a tile: each stage's rows in
    the variant's row groups times its features, plus a fixed cost a tile
    (its window's load and the barriers between the stages' chunks); the
    larger on a tie. The grid is the smaller of the tile count and the
    blocks the card holds at once."""
    variant = "mma" if dtype == torch.bfloat16 else "ffma"
    top = max_tile(variant, cin, c, dilations)
    if top < 1:
        raise ValueError(f"down_chain_fwd holds no tile at {cin} -> {c}, "
                         f"dilations {dilations}")
    d1, d2, d3 = dilations
    H = d1 + d2 + d3
    group = 16 * _wm(c) if variant == "mma" else _ty(c)
    best = None
    for S in range(1, top + 1):
        slots = _SMS * blocks_per_sm(variant, c,
                                     smem_bytes(variant, S, H, cin, c))
        waves = -(-B * -(-T // S) // slots)
        work = sum(-(-n // group) * K * _kd(variant, cs) for n, K, cs in (
            (S + 2 * (d2 + d3), 3, cin), (S + 2 * d3, 3, c), (S, 3, c),
            (S, 1, cin)))
        cost = waves * (work + _TILE_COST)
        if best is None or cost <= best[0]:
            best = (cost, S, slots)
    _, S, slots = best
    tiles = B * -(-T // S)
    return {"variant": variant, "tile_rows": S, "tiles": tiles,
            "n_blocks": max(1, min(tiles, slots)),
            "smem": smem_bytes(variant, S, H, cin, c)}


def down_chain_fwd_plain(x, params, *, dilations=(1, 2, 4)):
    """Plain PyTorch version: three window convs with the leaky on their
    input, then the f32 residual added before the final rounding."""
    h = x
    for name, d in zip(_CONVS[:3], dilations):
        h = window_conv_plain(h, params[name]["w"], params[name]["b"], d,
                              SLOPE)
    res = params["res_conv"]
    r = _wide(x) @ _wide(res["w"][0]) + _wide(res["b"])
    return (_wide(h) + r).to(x.dtype)


def _check(x, params, dilations):
    """(Cin, C) after checking the shapes."""
    if x.dim() != 3:
        raise ValueError(f"want x (B, T, Cin), got {tuple(x.shape)}")
    if len(dilations) != 3 or min(dilations) < 1:
        raise ValueError(f"down_chain_fwd takes three dilations >= 1, got "
                         f"{tuple(dilations)}")
    cin, c = x.shape[2], params["conv1"]["w"].shape[2]
    want = {"conv1": (3, cin, c), "conv2": (3, c, c), "conv3": (3, c, c),
            "res_conv": (1, cin, c)}
    for name, shape in want.items():
        w, b = params[name]["w"], params[name].get("b")
        if tuple(w.shape) != shape or b is None or tuple(b.shape) != (c,):
            raise ValueError(f"down_chain_fwd: {name} weight "
                             f"{tuple(w.shape)} (want {shape}) with a ({c},) "
                             "bias")
        for t in (w, b):
            if t.dtype != x.dtype or t.device != x.device:
                raise ValueError("down_chain_fwd: x and the weights must "
                                 "share dtype and device")
    return cin, c


def down_chain_takes(cin: int, c: int, dilations=(1, 2, 4)) -> bool:
    """Whether the kernel takes a block of these widths and dilations."""
    return (max(cin, c) <= MAX_CHANNELS and len(dilations) == 3
            and min(dilations) >= 1 and sum(dilations) <= MAX_REACH)


def _fill_weights(a, params):
    """The four weights' pointers and strides, and the biases', into a."""
    for i, name in enumerate(_CONVS):
        w = params[name]["w"]
        a.w[i] = w.data_ptr()
        a.w_sk[i], a.w_si[i], a.w_so[i] = w.stride()
        a.b[i] = params[name]["b"].data_ptr()


def _launch(name, x, a):
    """Launch C entry `name`_f32 or _bf16 with `a` on x's stream."""
    full = f"{name}_{_SUFFIX[x.dtype]}"
    fn = _build.kernel(full, _ARGTYPES)
    _build.check(fn(ctypes.byref(a), _build.stream_handle(x.device)), full)


# packed weights by the weights they were packed from: each key holds the
# four weights' address, version counter, shape and strides, and the entry
# holds the weights themselves, so no other tensor can take their memory
# while it lives; an in-place change to a weight (an optimizer step,
# load_state_dict) moves its version and so misses
_PACKED = collections.OrderedDict()
_PACKED_MAX = 64


def pack_weights(x, params):
    """The four weights of `params` in the kernel's chunk layout, for x's
    dtype and device: packed by `down_chain_pack_kernel` (csrc/
    down_chain.cu) on a set of weights seen for the first time, else the
    copy packed before. Weights that keep no version counter (inference
    tensors) are packed every call."""
    cin, c = x.shape[2], params["conv1"]["w"].shape[2]
    variant = "mma" if x.dtype == torch.bfloat16 else "ffma"
    ws = [params[n]["w"] for n in _CONVS]
    key = None
    if not any(w.is_inference() for w in ws):
        key = (variant, cin, c, str(x.device)) + tuple(
            (w.data_ptr(), w._version, tuple(w.shape), w.stride()) for w in ws)
        hit = _PACKED.get(key)
        if hit is not None:
            _PACKED.move_to_end(key)
            return hit[1]
    wpack = torch.empty(pack_elems(variant, cin, c), dtype=x.dtype,
                        device=x.device)
    a = _Args()
    _fill_weights(a, params)
    a.wpack, a.Cin, a.C = wpack.data_ptr(), cin, c
    a.variant = DOWN_VARIANTS[variant]
    _launch("down_chain_pack", x, a)
    pack_weights.launches += 1
    if key is not None:
        _PACKED[key] = (ws, wpack)
        if len(_PACKED) > _PACKED_MAX:
            _PACKED.popitem(last=False)
    return wpack


def down_chain_fwd(x, params, *, dilations=(1, 2, 4)):
    """(B, T, Cin) -> (B, T, C), any T >= 1 (the JAX kernel's T % 32 and
    T >= 2 halo rules are not needed here), channels <= MAX_CHANNELS,
    sum(dilations) <= MAX_REACH on the card."""
    dilations = tuple(int(d) for d in dilations)
    cin, c = _check(x, params, dilations)
    if x.device.type == "cpu":
        return down_chain_fwd_plain(x, params, dilations=dilations)
    if x.device.type != "cuda":
        raise ValueError(f"no down_chain_fwd kernel for device {x.device}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"down_chain_fwd kernel takes f32 or bf16, not "
                         f"{x.dtype}")
    if not down_chain_takes(cin, c, dilations):
        raise ValueError(f"down_chain_fwd kernel takes channels <= "
                         f"{MAX_CHANNELS} and dilations summing to <= "
                         f"{MAX_REACH}, got {cin} -> {c}, {dilations}")
    if not x.is_contiguous() or not all(params[n]["b"].is_contiguous()
                                        for n in _CONVS):
        raise ValueError("down_chain_fwd needs a contiguous x and biases")
    B, T, _ = x.shape
    y = torch.empty((B, T, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    # the window's rows come in as 16-byte copies
    if x.data_ptr() % 16:
        raise ValueError("down_chain_fwd needs x 16-byte aligned")
    plan = down_plan(x.dtype, B, T, cin, c, dilations)
    wpack = pack_weights(x, params)
    a = _Args()
    a.x, a.y, a.wpack = x.data_ptr(), y.data_ptr(), wpack.data_ptr()
    _fill_weights(a, params)
    a.B, a.T, a.Cin, a.C = B, T, cin, c
    for j, d in enumerate(dilations):
        a.dil[j] = d
    a.variant = DOWN_VARIANTS[plan["variant"]]
    a.tile_rows, a.n_blocks = plan["tile_rows"], plan["n_blocks"]
    _launch("down_chain_fwd", x, a)
    down_chain_fwd.launches += 1
    return y


down_chain_fwd.launches = 0
pack_weights.launches = 0
