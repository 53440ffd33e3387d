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
what bounds the kernel on the H100. The kernel is forward only; the model
routes a DownsampleBlock to it when the down-chain mode is on
(`set_down_chain_mode("1")`, default "0") and grad is off.

`params` follow the JAX package's block layout {"conv1", "conv2",
"conv3", "res_conv"}, each {"w": WIO (K, C_in, C_out), "b": (C_out,)}; a
weight may be any strided view (the model passes views of its torch-layout
parameters). On a CUDA tensor the wrapper launches its kernel or raises. On
a CPU tensor it takes its plain PyTorch version (`down_chain_fwd_plain`),
which the tests and `chip_smoke.py` hold the kernel against.
"""

from __future__ import annotations

import ctypes

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
        ("B", ctypes.c_longlong), ("T", ctypes.c_longlong),
        ("Cin", ctypes.c_longlong), ("C", ctypes.c_longlong),
        ("dil", ctypes.c_longlong * 3),
    ]


_ARGTYPES = [ctypes.POINTER(_Args), ctypes.c_void_p]


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
    a = _Args()
    a.x, a.y = x.data_ptr(), y.data_ptr()
    for i, name in enumerate(_CONVS):
        w = params[name]["w"]
        a.w[i] = w.data_ptr()
        a.w_sk[i], a.w_si[i], a.w_so[i] = w.stride()
        a.b[i] = params[name]["b"].data_ptr()
    a.B, a.T, a.Cin, a.C = B, T, cin, c
    for j, d in enumerate(dilations):
        a.dil[j] = d
    name = f"down_chain_fwd_{_SUFFIX[x.dtype]}"
    fn = _build.kernel(name, _ARGTYPES)
    _build.check(fn(ctypes.byref(a), _build.stream_handle(x.device)), name)
    down_chain_fwd.launches += 1
    return y


down_chain_fwd.launches = 0
