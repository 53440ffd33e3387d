"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (`-m cuda`) and skips where
there is none. The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu_torch.models.fastsvc import FastSVCGenerator
from svcc23_fastsvc_tpu_torch.models.hnusfgan import HNUSFGANGenerator
from svcc23_fastsvc_tpu_torch.ops import _build
from svcc23_fastsvc_tpu_torch.ops import conv as conv_mod
from svcc23_fastsvc_tpu_torch.ops import down_chain as dc_mod
from svcc23_fastsvc_tpu_torch.ops import fused_conv as fc_mod
from svcc23_fastsvc_tpu_torch.ops import pd_block as pb_mod
from svcc23_fastsvc_tpu_torch.ops.down_chain import (
    down_chain_fwd,
    down_chain_fwd_plain,
    down_plan,
    set_down_chain_mode,
)
from svcc23_fastsvc_tpu_torch.ops.fused_conv import (
    FusedConv1d,
    bwd_plan,
    fused_conv1d,
    fused_conv1d_bwd,
    fused_conv1d_bwd_plain,
    fused_conv1d_plain,
)
from svcc23_fastsvc_tpu_torch.ops.pd_block import (
    block_plan,
    chain_plan,
    pd_adaptive_block,
    pd_adaptive_block_plain,
    pd_block_halo,
    pd_fixed_block,
    pd_fixed_block_plain,
    pd_fixed_chain,
    pd_fixed_chain_plain,
)
from svcc23_fastsvc_tpu_torch.ops.sine import (
    sine_excitation,
    sine_excitation_plain,
)
from svcc23_fastsvc_tpu_torch.ops.window_conv import (
    WindowConv1d,
    fwd_plan,
    wgrad_plan,
    window_conv,
    window_conv_dx,
    window_conv_dx_plain,
    window_conv_plain,
    window_conv_wgrad,
    window_conv_wgrad_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv_case(B, T, Cin, Cout, K, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, T, Cin)).astype(np.float32)
    w = (r.standard_normal((K, Cin, Cout)) / np.sqrt(K * Cin)).astype(np.float32)
    b = r.standard_normal(Cout).astype(np.float32)
    return x, w, b


# B, T, Cin, Cout, K, dilation, slope, bias
CASES = [
    (2, 131, 1, 8, 3, 1, 0.2, True),
    (2, 131, 8, 12, 3, 3, None, True),
    (1, 97, 12, 8, 3, 27, 0.2, False),
    (2, 75, 24, 24, 3, 9, 0.2, True),
    (1, 61, 5, 70, 5, 27, 0.2, True),     # K = 5: > 48 KB of shared memory
    (2, 300, 384, 384, 3, 1, None, True),  # the fused FiLM width
    (1, 1000, 144, 192, 3, 1, None, True),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,Cin,Cout,K,dil,slope,bias", CASES)
def test_window_conv_kernel_matches_plain(cuda, dtype, tol, B, T, Cin, Cout,
                                          K, dil, slope, bias):
    x, w, b = (torch.from_numpy(a).to(cuda, dtype)
               for a in _conv_case(B, T, Cin, Cout, K, seed=T + Cin))
    b = b if bias else None
    before = window_conv.launches
    got = window_conv(x, w, b, dil, slope)
    torch.cuda.synchronize()
    assert window_conv.launches == before + 1
    want = window_conv_plain(x, w, b, dil, slope).float()
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item()


def test_window_conv_kernel_takes_a_strided_weight_view(cuda):
    x, w, b = (torch.from_numpy(a).to(cuda)
               for a in _conv_case(2, 200, 16, 24, 3, seed=3))
    w_oik = w.permute(2, 1, 0).contiguous()
    view = w_oik.permute(2, 1, 0)  # the generator's torch-layout weights
    assert not view.is_contiguous()
    got = window_conv(x, view, b, 3, 0.2)
    want = window_conv_plain(x, w, b, 3, 0.2)
    assert (got - want).abs().max().item() <= 2e-4 * want.abs().max().item()


def test_window_conv_kernel_rejects_a_noncontiguous_input(cuda):
    x = torch.zeros((2, 8, 16), device=cuda).transpose(0, 1)
    w = torch.zeros((3, 16, 4), device=cuda)
    with pytest.raises(ValueError):
        window_conv(x, w, None, 1, None)


# B, T, Cin, Cout, K, dilation, slope: the generator's training convs in
# small, plus edges (Cin = 1, ragged tiles, K = 5, channels past 64)
GRAD_CASES = [
    (2, 1601, 1, 24, 3, 1, 0.2),
    (2, 1600, 24, 24, 3, 27, 0.2),
    (2, 321, 48, 48, 3, 9, None),
    (1, 97, 12, 70, 5, 4, 0.2),
    (3, 200, 192, 192, 3, 1, 0.2),
    (2, 100, 144, 192, 3, 1, None),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,Cin,Cout,K,dil,slope", GRAD_CASES)
def test_window_conv_dx_kernel_matches_plain(cuda, dtype, tol, B, T, Cin,
                                             Cout, K, dil, slope):
    x, w, _ = _conv_case(B, T, Cin, Cout, K, seed=T + Cout)
    g = np.random.default_rng(T).standard_normal((B, T, Cout))
    x, w, g = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w, g))
    before = window_conv_dx.launches
    got = window_conv_dx(g, w, dil, x, slope)
    torch.cuda.synchronize()
    assert window_conv_dx.launches == before + 1
    want = window_conv_dx_plain(g, w, dil, x, slope).float()
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,Cin,Cout,K,dil,slope", GRAD_CASES)
def test_window_conv_wgrad_kernel_matches_plain(cuda, dtype, tol, B, T, Cin,
                                                Cout, K, dil, slope):
    x, _, _ = _conv_case(B, T, Cin, Cout, K, seed=T + Cin)
    g = np.random.default_rng(T + 1).standard_normal((B, T, Cout))
    x, g = (torch.from_numpy(a).to(cuda, dtype) for a in (x, g))
    before = window_conv_wgrad.launches
    dw, db = window_conv_wgrad(x, g, K, dil, slope)
    torch.cuda.synchronize()
    assert window_conv_wgrad.launches == before + 1
    want_w, want_b = window_conv_wgrad_plain(x, g, K, dil, slope)
    assert dw.dtype == db.dtype == torch.float32
    for got, want in ((dw, want_w), (db, want_b)):
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= tol * want.abs().max().item()
    # a fixed partition and no atomics: the same sums every run
    dw2, db2 = window_conv_wgrad(x, g, K, dil, slope)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


def test_window_conv_function_on_the_card_matches_the_cpu(cuda):
    x, w, b = _conv_case(2, 500, 24, 48, 3, seed=11)
    g = np.random.default_rng(12).standard_normal((2, 500, 48)).astype(
        np.float32)
    outs = []
    for dev in ("cpu", cuda):
        args = [torch.from_numpy(a).to(dev).requires_grad_()
                for a in (x, w, b)]
        y = WindowConv1d.apply(*args, 9, 0.2)
        grads = torch.autograd.grad(y, args, torch.from_numpy(g).to(dev))
        outs.append([t.detach().cpu() for t in (y, *grads)])
    for got, want in zip(outs[1], outs[0]):
        err = (got - want).abs().max().item()
        assert err <= 2e-4 * want.abs().max().item()


# B, T, Cin, Cout, K, dilation, slope, bias: the edges of the forward's and
# wgrad's variants (mma for bf16 at Cin a multiple of 8 and >= 16, ffma,
# stream at Cin = 1): T a multiple of no row tile, Cin 16 / 24 / 40 (MMA
# depth 16 / 32 padded / 32 + 8), d27 with T below its 54-row halo, K = 5,
# no bias, the 384-channel FiLM width, Cout 1; the last two grids large
# enough for the ffma tiles of 8 rows a thread (the others take 4)
VARIANT_CASES = [
    (2, 300, 16, 24, 3, 1, 0.2, True),
    (2, 300, 24, 24, 3, 27, 0.2, False),
    (1, 517, 40, 48, 3, 9, None, True),
    (2, 40, 24, 24, 3, 27, 0.2, True),
    (1, 200, 48, 40, 5, 3, 0.2, True),
    (2, 100, 384, 384, 3, 1, None, False),
    (1, 333, 1, 24, 3, 1, 0.2, True),
    (2, 129, 24, 1, 3, 9, 0.2, True),
    (8, 4100, 24, 40, 3, 9, 0.2, True),
    (4, 9000, 16, 24, 3, 27, None, True),
]


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,Cin,Cout,K,dil,slope,bias", VARIANT_CASES)
def test_window_conv_variants_match_plain(cuda, dtype, tol, B, T, Cin, Cout,
                                          K, dil, slope, bias):
    x, w, b = (torch.from_numpy(a).to(cuda, dtype)
               for a in _conv_case(B, T, Cin, Cout, K, seed=T + Cin + K))
    g = torch.from_numpy(np.random.default_rng(T + 5).standard_normal(
        (B, T, Cout))).to(cuda, dtype)
    b = b if bias else None
    mma = lambda cin: dtype == torch.bfloat16 and cin % 8 == 0 and cin >= 16
    assert fwd_plan(dtype, B, T, Cin, Cout)["variant"] == (
        "mma" if mma(Cin) else "ffma")
    assert fwd_plan(dtype, B, T, Cout, Cin)["variant"] == (
        "mma" if mma(Cout) else "ffma")  # dx, its mask epilogue included
    assert wgrad_plan(dtype, B, T, K, Cin, Cout)["variant"] == (
        "stream" if Cin == 1 else
        "mma" if mma(Cin) and Cout % 8 == 0 else "ffma")
    _close(window_conv(x, w, b, dil, slope),
           window_conv_plain(x, w, b, dil, slope), tol)
    _close(window_conv_dx(g, w, dil, x, slope),
           window_conv_dx_plain(g, w, dil, x, slope), tol)
    dw, db = window_conv_wgrad(x, g, K, dil, slope)
    want_w, want_b = window_conv_wgrad_plain(x, g, K, dil, slope)
    _close(dw, want_w, tol)
    _close(db, want_b, tol)
    # a fixed partition and no atomics, in every variant: the same bits
    dw2, db2 = window_conv_wgrad(x, g, K, dil, slope)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
def test_window_conv_variants_take_the_strided_weight_view(cuda, dtype, tol):
    # the generator's torch-layout weight (Cout, Cin, K) seen as (K, Cin,
    # Cout), through the forward and through dx's negative K stride
    x, w, b = (torch.from_numpy(a).to(cuda, dtype)
               for a in _conv_case(2, 300, 48, 24, 3, seed=9))
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 300, 24))).to(cuda, dtype)
    view = w.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    assert not view.is_contiguous()
    _close(window_conv(x, view, b, 9, 0.2),
           window_conv_plain(x, w, b, 9, 0.2), tol)
    _close(window_conv_dx(g, view, 9, x, 0.2),
           window_conv_dx_plain(g, w, 9, x, 0.2), tol)


# B, T, Cin, Cout, K, dilation, lo: the fused conv's forward (#5, on #2's
# template) with its window started at t0 - lo, lo != hi
FUSED_LO_CASES = [
    (2, 300, 24, 24, 3, 9, 5),
    (1, 260, 48, 48, 5, 3, 0),
    (2, 257, 1, 24, 3, 1, 2),
    (1, 300, 40, 16, 3, 27, 50),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,Cin,Cout,K,dil,lo", FUSED_LO_CASES)
def test_fused_conv_forward_with_lo_not_hi_matches_plain(cuda, dtype, tol, B,
                                                         T, Cin, Cout, K,
                                                         dil, lo):
    hi = (K - 1) * dil - lo
    x, w, b = (torch.from_numpy(a).to(cuda, dtype)
               for a in _conv_case(B, T, Cin, Cout, K, seed=lo + T))
    _close(fused_conv1d(x, w, b, lo, hi, dil, 0.2),
           fused_conv1d_plain(x, w, b, lo, hi, dil, 0.2), tol)


# Tf > 1024 gives each thread of the prefix scan a run of several frames
@pytest.mark.parametrize("B,Tf", [(8, 400), (3, 77), (1, 1), (2, 3000),
                                  (1, 2049)])
def test_sine_kernel_matches_plain(cuda, B, Tf):
    r = np.random.default_rng(7)
    f0 = np.where(r.random((B, Tf)) > 0.3, r.uniform(80, 300, (B, Tf)), 0.0)
    f0 = torch.from_numpy(f0.astype(np.float32)).to(cuda)
    before = sine_excitation.launches
    got = sine_excitation(f0, hop=160, sr=16000, amp=0.1)
    torch.cuda.synchronize()
    assert sine_excitation.launches == before + 1
    want = sine_excitation_plain(f0, hop=160, sr=16000, amp=0.1)
    assert (got - want).abs().max().item() <= 2e-4


def test_generator_on_the_card_matches_the_cpu(cuda):
    g = torch.Generator().manual_seed(0)
    model = FastSVCGenerator(in_channels=8, mid_channels=(16, 8),
                             upsampling_scales=(4, 5), spk_emb_size=12,
                             generator=g).eval()
    r = np.random.default_rng(1)
    ins = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
           for s in ((2, 10, 8), (2, 200, 1), (2, 200, 1), (2, 12))]
    with torch.no_grad():
        want = model(*ins, fuse_film=True)
        before = window_conv.launches
        got = model.to(cuda)(*(t.to(cuda) for t in ins), fuse_film=True)
        torch.cuda.synchronize()
    # 3 per down block x 2 chains x 2, 3 FiLM + 6 up convs x 2 blocks
    assert window_conv.launches - before == 12 + 6 + 12
    assert (got.cpu() - want).abs().max().item() <= 1e-3 * want.abs().max().item()


def _block_weights(kind, R, G, A, seed, strided):
    """Block params as WIO weights: contiguous, or (strided) the permuted
    views of torch-layout (O, I, K) parameters the vocoder passes."""
    r = np.random.default_rng(seed)

    def conv(K, cin, cout, bias=True):
        w = r.standard_normal((cout, cin, K)) / np.sqrt(K * cin)
        w = torch.from_numpy(w.astype(np.float32))
        p = {"w": w.permute(2, 1, 0) if strided
             else w.permute(2, 1, 0).contiguous()}
        if bias:
            p["b"] = torch.from_numpy(
                (0.1 * r.standard_normal(cout)).astype(np.float32))
        return p

    if kind == "fixed":
        p = {"conv": conv(3, R, G)}
    else:
        p = {k: conv(1, R, G) for k in ("convC", "convP", "convF")}
    p["aux"] = conv(1, A, G, bias=False)
    p["out"] = conv(1, G // 2, R)
    return p


def _to(params, device, dtype):
    return {k: {n: t.to(device, dtype) for n, t in v.items()}
            for k, v in params.items()}


def _block_inputs(B, T, R, A, seed):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((B, T, R)).astype(np.float32))
    c = torch.from_numpy(r.standard_normal((B, T, A)).astype(np.float32))
    return x, c


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


DTYPES = [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)]


# B, T, R, G, A, hop, dilation, shift range, strided weights
ADAPTIVE_CASES = [
    (2, 3200, 64, 128, 62, 160, 4, (20, 140), True),  # vocoder widths
    (2, 3200, 16, 32, 10, 160, 1, (0, 40), False),
    (1, 2000, 8, 16, 10, 100, 2, (0, 30), True),
    (2, 960, 64, 128, 62, 160, 16, "halo", True),  # clamp, past both ends
    (2, 960, 16, 32, 10, 160, 1, "any", False),  # negative and int32 extremes
    (2, 3200, 64, 128, 63, 160, 2, (0, 60), True),  # odd aux: c by elements
    (1, 1600, 12, 24, 10, 160, 1, (0, 40), False),  # R % 8: bf16 on ffma
    (2, 1600, 64, 128, 96, 160, 2, (0, 60), True),  # 3R + A = 288: wide
    (1, 1000, 72, 160, 7, 100, 1, "any", False),  # R 72, G 160: wide
]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,R,G,A,hop,dil,srange,strided", ADAPTIVE_CASES)
def test_pd_adaptive_block_kernel_matches_plain(cuda, dtype, tol, B, T, R, G,
                                                A, hop, dil, srange, strided):
    x, c = (t.to(cuda, dtype) for t in _block_inputs(B, T, R, A, seed=T + R))
    params = _to(_block_weights("adaptive", R, G, A, dil, strided), cuda,
                 dtype)
    r = np.random.default_rng(dil)
    F = T // hop
    if srange == "halo":  # every shift at the clamp: all of xP, xF is zero
        s = np.full((B, F), pd_block_halo(dil, 24000, hop=hop))
    elif srange == "any":  # shifts the caller's clamp never gives
        s = r.choice([-2 ** 31, -5000, -30, -1, 0, 7, 2 ** 31 - 1], (B, F))
    else:
        s = r.integers(srange[0], srange[1] + 1, (B, F))
    shifts = torch.from_numpy(s.astype(np.int32)).to(cuda)
    before = pd_adaptive_block.launches
    got = pd_adaptive_block(x, c, shifts, params, hop=hop)
    torch.cuda.synchronize()
    assert pd_adaptive_block.launches == before + 1
    _close(got, pd_adaptive_block_plain(x, c, shifts, params, hop=hop), tol)


# B, T, R, G, A, dilation, strided weights
FIXED_CASES = [
    (2, 3200, 64, 128, 62, 1, True),     # vocoder widths
    (2, 1007, 16, 32, 10, 8, False),     # T not a multiple of 32
    (1, 333, 64, 128, 62, 300, True),    # reflection reaches deep
    (2, 24000, 64, 128, 62, 512, True),  # the filter net's largest dilation
    (2, 1000, 64, 128, 63, 3, True),     # odd aux (B02 features: 63)
    (1, 700, 12, 24, 10, 5, False),      # R % 8: bf16 on ffma
    (1, 900, 64, 128, 80, 2, True),      # 3R + A = 272: bf16 on ffma
    (1, 900, 64, 128, 81, 2, True),      # 3R + A = 273: the wide walk
    (2, 1000, 64, 160, 62, 7, True),     # G = 160: wide
    (1, 333, 130, 300, 15, 100, False),  # R, G past both chunks: wide
]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,R,G,A,dil,strided", FIXED_CASES)
def test_pd_fixed_block_kernel_matches_plain(cuda, dtype, tol, B, T, R, G, A,
                                             dil, strided):
    x, c = (t.to(cuda, dtype) for t in _block_inputs(B, T, R, A, seed=T + R))
    params = _to(_block_weights("fixed", R, G, A, dil, strided), cuda, dtype)
    before = pd_fixed_block.launches
    got = pd_fixed_block(x, c, params, dilation=dil)
    torch.cuda.synchronize()
    assert pd_fixed_block.launches == before + 1
    _close(got, pd_fixed_block_plain(x, c, params, dilation=dil), tol)


def _bf16_values(r, lo, hi, shape):
    """bf16 values of magnitude in [lo, hi] and random sign, as f64."""
    v = r.uniform(lo, hi, shape) * r.choice([-1.0, 1.0], shape)
    return torch.from_numpy(v).to(torch.bfloat16).double()


@pytest.mark.parametrize("kind", ["fixed", "adaptive"])
def test_bf16_block_gate_is_f32_at_large_negative_b(cuda, kind):
    """The gate runs in f32 in the tensor-core variant too, where
    sigmoid(b) is far below a hardware tanh's 2^-11 error. With x = 0, one
    feature of c set to +-1 a row, Wo = I and no out bias, h = +-Wa + bg is
    exact in f32 and y is z * sqrt(0.5), each rounded once: y must be the
    value the exact z (f64) gives, rounded to bf16, and where the exact z
    lies within 2^-18 (relative) of a bf16 rounding boundary, the value of
    either neighbour. b runs over [-30, -6], a over +-[0.25, 12]."""
    R, G, A, B, T, hop = 64, 128, 62, 1, 1280, 160
    r = np.random.default_rng(21)
    wa = torch.cat([_bf16_values(r, 0.25, 12, (A, G // 2)),
                    _bf16_values(r, 0.25, 12, (A, G // 2))], 1)
    bg = torch.cat([torch.zeros(G // 2), torch.full((G // 2,), -18.0)])
    bg = bg.double()
    c = torch.zeros((B, T, A), dtype=torch.float64)
    c[0, torch.arange(T), torch.from_numpy(r.integers(0, A, T))] = \
        torch.from_numpy(r.choice([-1.0, 1.0], T))
    # the exact gate, and the two roundings either side of a boundary
    h = c @ wa + bg
    z = torch.tanh(h[..., :G // 2]) * torch.sigmoid(h[..., G // 2:])
    sqrt_half = torch.tensor(0.5 ** 0.5, dtype=torch.float32)
    y_lo, y_hi = ((z * f).to(torch.bfloat16).float() * sqrt_half
                  for f in (1 - 2 ** -18, 1 + 2 ** -18))
    y_lo, y_hi = y_lo.to(torch.bfloat16), y_hi.to(torch.bfloat16)

    def conv(w, b=None):
        p = {"w": w.to(cuda, torch.bfloat16)}
        if b is not None:
            p["b"] = b.to(cuda, torch.bfloat16)
        return p
    zero_w = torch.zeros((1, R, G))
    params = {"aux": conv(wa[None]), "out": conv(torch.eye(R)[None],
                                                 torch.zeros(R))}
    x = torch.zeros((B, T, R), dtype=torch.bfloat16, device=cuda)
    cd = c.to(cuda, torch.bfloat16)
    if kind == "fixed":
        params["conv"] = conv(torch.zeros((3, R, G)), bg)
        got = pd_fixed_block(x, cd, params, dilation=3)
    else:
        params["convC"] = conv(zero_w, bg)
        params["convP"] = conv(zero_w, torch.zeros(G))
        params["convF"] = conv(zero_w, torch.zeros(G))
        shifts = torch.zeros((B, T // hop), dtype=torch.int32, device=cuda)
        got = pd_adaptive_block(x, cd, shifts, params, hop=hop)
    assert block_plan(torch.bfloat16, B, T, R, A, G)["variant"] == "mma"
    got = got.cpu()
    ok = (got == y_lo) | (got == y_hi)
    assert ok.all().item(), (z[~ok][:4], got[~ok][:4], y_lo[~ok][:4])


def test_pd_block_entry_refuses_a_plan_no_instance_takes(cuda):
    """The C entry checks the plan: an unknown tile, an mma plan in f32 or a
    grid with more blocks of threads than tiles (640 rows are 3 tiles of
    256) returns a CUDA error before any launch."""
    x, c = (t.to(cuda) for t in _block_inputs(1, 640, 64, 62, seed=4))
    params = _to(_block_weights("fixed", 64, 128, 62, 4, False), cuda,
                 torch.float32)
    parts = pb_mod._check_fixed(x, c, params)
    y = torch.empty_like(x)
    fn = _build.kernel("pd_fixed_block_f32", pb_mod._ARGTYPES)
    for variant, rows in (("ffma", 128), ("mma", 128), ("mma", 256),
                          ("ffma", 256)):
        a = pb_mod._Args()
        a.x, a.c, a.y, a.shifts = x.data_ptr(), c.data_ptr(), y.data_ptr(), None
        pb_mod._fill(a.wt, *parts)
        a.B, a.T, a.R, a.A, a.G, a.hop, a.n_frames, a.dil = 1, 640, 64, 62, \
            128, 0, 0, 2
        a.variant, a.tile_rows = pb_mod.BLOCK_VARIANTS[variant], rows
        a.n_blocks = 5
        assert fn(ctypes.byref(a), _build.stream_handle(x.device)) != 0
    # the wide walk without its z scratch, and the ffma walk at widths it
    # does not hold (G 160)
    wide = _to(_block_weights("fixed", 64, 160, 62, 4, False), cuda,
               torch.float32)
    zbuf = torch.empty(5 * 64 * 80, device=cuda)
    for variant, rows, z in (("wide", 64, None), ("ffma", 256, zbuf)):
        a = pb_mod._Args()
        a.x, a.c, a.y, a.shifts = x.data_ptr(), c.data_ptr(), y.data_ptr(), None
        a.zbuf = None if z is None else z.data_ptr()
        pb_mod._fill(a.wt, *pb_mod._check_fixed(x, c, wide))
        a.B, a.T, a.R, a.A, a.G, a.hop, a.n_frames, a.dil = 1, 640, 64, 62, \
            160, 0, 0, 2
        a.variant, a.tile_rows = pb_mod.BLOCK_VARIANTS[variant], rows
        a.n_blocks = 2
        assert fn(ctypes.byref(a), _build.stream_handle(x.device)) != 0
    # the chain's f32 entry refuses the tensor-core variant, an unknown one,
    # the ffma variant at the mma tile, scratch regions too short for the
    # reach and a grid that leaves rows out
    chain = _build.kernel("pd_fixed_chain_f32", pb_mod._CHAIN_ARGTYPES)
    plan = chain_plan(torch.float32, 1, 640, 64, 62, 128, (2, 4))
    scratch = torch.empty((plan["scratch_rows"], 64), device=cuda)
    for change in ({"variant": pb_mod.BLOCK_VARIANTS["mma"]},
                   {"variant": 7}, {"tile_rows": 128},
                   {"region_rows": plan["region_rows"] - 1},
                   {"seg_rows": plan["seg_rows"] - 1}):
        a = pb_mod._ChainArgs()
        a.x, a.c, a.y = x.data_ptr(), c.data_ptr(), y.data_ptr()
        a.scratch = scratch.data_ptr()
        a.B, a.T, a.R, a.A, a.G, a.K = 1, 640, 64, 62, 128, 2
        a.variant = pb_mod.BLOCK_VARIANTS[plan["variant"]]
        for k in ("tile_rows", "n_blocks", "seg_rows", "region_rows"):
            setattr(a, k, plan[k])
        for k, v in change.items():
            setattr(a, k, v)
        for j, d in enumerate((2, 4)):
            a.dil[j] = d
            pb_mod._fill(a.blk[j], *parts)
        assert chain(ctypes.byref(a), _build.stream_handle(x.device)) != 0


def test_pd_block_kernels_reject_a_gate_too_wide(cuda):
    """A gate of 256 is past what the mma and ffma walks hold, as the JAX
    kernels' is not: it runs on the wide walk and matches the plain
    version; an odd gate, which no kernel takes, is still refused."""
    x, c = (t.to(cuda) for t in _block_inputs(1, 320, 64, 10, seed=0))
    params = _to(_block_weights("fixed", 64, 256, 10, 0, False), cuda,
                 torch.float32)
    assert block_plan(torch.float32, 1, 320, 64, 10, 256)["variant"] == "wide"
    _close(pd_fixed_block(x, c, params, dilation=1),
           pd_fixed_block_plain(x, c, params, dilation=1), 2e-4)
    odd = _to(_block_weights("fixed", 64, 255, 10, 0, False), cuda,
              torch.float32)
    with pytest.raises(ValueError):
        pd_fixed_block(x, c, odd, dilation=1)


@pytest.mark.parametrize("folded", [True, False])
def test_vocoder_on_the_card_matches_the_cpu(cuda, folded):
    """Folded or with weight norm live, every block launches its kernel."""
    g = torch.Generator().manual_seed(0)
    hop = 40
    model = HNUSFGANGenerator(
        harmonic_params=dict(blockA=4, cycleA=2, blockF=0, cycleF=0),
        noise_params=dict(blockA=0, cycleA=0, blockF=2, cycleF=2),
        filter_params=dict(blockA=0, cycleA=0, blockF=3, cycleF=1),
        residual_channels=16, gate_channels=32, skip_channels=16,
        aux_channels=10, upsample_scales=(5, 4, 2), pd_frame_hop=hop,
        generator=g).eval()
    if folded:
        model.fold_weight_norm_()
    r = np.random.default_rng(2)
    B, Tf = 2, 30
    f0 = r.uniform(80, 400, (B, Tf))
    d = np.repeat(8000 / (f0 * 4), hop, axis=1).astype(np.float32)
    ins = [torch.from_numpy(a) for a in (
        (0.1 * r.standard_normal((B, Tf * hop, 2))).astype(np.float32),
        r.standard_normal((B, Tf + 4, 10)).astype(np.float32), d)]
    with torch.no_grad():
        want = model(*ins)
        before = (pd_adaptive_block.launches, pd_fixed_block.launches)
        got = model.to(cuda)(*(t.to(cuda) for t in ins))
        torch.cuda.synchronize()
    assert (pd_adaptive_block.launches - before[0],
            pd_fixed_block.launches - before[1]) == (4, 5)
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * b.abs().max().item()


# B, T, R, G, A, dilations, strided weights
CHAIN_CASES = [
    (2, 3200, 64, 128, 62, (1, 2, 4, 8, 16), True),  # a filter cycle's prefix
    (2, 3200, 64, 128, 62, (1, 1, 1, 1, 1), True),   # the noise net
    # T just above 2 x the JAX halo; at these widths the tiles are 196
    # rows, so the last tile of T = 402 has 10 rows, within the reach of T
    (2, 321, 64, 128, 62, (1, 2, 4, 8, 16), False),
    (1, 402, 64, 128, 62, (1, 2, 4, 8, 16), True),
    (1, 1007, 16, 32, 10, (1, 2, 4), False),         # T not a multiple of 32
    (2, 960, 64, 128, 62, (2,), True),               # one block
    (1, 1500, 8, 16, 10, (64, 64), False),           # a long reach, 2 tiles
    # reaches past 159 rows (FASTSVC_PD_CHAIN_HALO above its default),
    # a run of MAX_CHAIN blocks, and runs of rows that cross utterances
    (3, 2400, 64, 128, 62, (1, 2, 4, 8, 16, 32, 64, 128), True),
    (2, 3072, 16, 32, 10, (1, 2, 4, 8, 16, 32, 64, 128, 256), False),
    (2, 1056, 64, 128, 63, (1,) * 16, True),
    (40, 320, 64, 128, 62, (1, 2, 4, 8, 16), True),
    (2, 3200, 64, 128, 96, (1, 2, 4, 8, 16), True),  # 3R + A = 288: wide
    (3, 700, 72, 160, 10, (1, 3), False),  # wide, runs across utterances
]


def _chain_weights(R, G, A, dils, strided, device, dtype):
    return [_to(_block_weights("fixed", R, G, A, 40 + j, strided), device,
                dtype) for j in range(len(dils))]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,R,G,A,dils,strided", CHAIN_CASES)
def test_pd_fixed_chain_kernel_matches_plain(cuda, dtype, tol, B, T, R, G, A,
                                             dils, strided):
    x, c = (t.to(cuda, dtype) for t in _block_inputs(B, T, R, A, seed=T + A))
    params = _chain_weights(R, G, A, dils, strided, cuda, dtype)
    before = pd_fixed_chain.launches
    got = pd_fixed_chain(x, c, params, dilations=dils)
    torch.cuda.synchronize()
    assert pd_fixed_chain.launches == before + 1
    _close(got, pd_fixed_chain_plain(x, c, params, dilations=dils), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pd_fixed_chain_kernel_gives_the_block_kernels_bits(cuda, dtype):
    """Each stage runs the routine of the block kernels' variant at these
    widths (FFMA in f32, the tensor cores in bf16), in the same order of
    summation, and rounds its output to the stream type, so the chain
    equals the blocks one after another bit for bit."""
    dils = (1, 2, 4, 8, 16)
    x, c = (t.to(cuda, dtype) for t in _block_inputs(2, 3000, 64, 62, seed=9))
    params = _chain_weights(64, 128, 62, dils, True, cuda, dtype)
    want = x
    for p, d in zip(params, dils):
        want = pd_fixed_block(want, c, p, dilation=d)
    got = pd_fixed_chain(x, c, params, dilations=dils)
    assert torch.equal(got, want)
    # and on the wide walk, at widths the other two do not hold
    x, c = (t.to(cuda, dtype) for t in _block_inputs(2, 1500, 64, 96, seed=9))
    params = _chain_weights(64, 128, 96, dils, True, cuda, dtype)
    assert chain_plan(dtype, 2, 1500, 64, 96, 128, dils)["variant"] == "wide"
    want = x
    for p, d in zip(params, dils):
        want = pd_fixed_block(want, c, p, dilation=d)
    assert torch.equal(pd_fixed_chain(x, c, params, dilations=dils), want)


def test_pd_fixed_chain_kernel_refuses_a_reach_too_long(cuda):
    """The card's chain has no reach limit of its own: 160 rows of reach,
    once past its shared memory, now run and give the blocks' bits. What
    it refuses is the JAX function's rule (T at least twice the chain's
    32-aligned halo) and runs longer than MAX_CHAIN."""
    x, c = (t.to(cuda) for t in _block_inputs(1, 960, 16, 10, seed=0))
    params = _chain_weights(16, 32, 10, (80, 80), False, cuda, torch.float32)
    want = x
    for p in params:
        want = pd_fixed_block(want, c, p, dilation=80)
    assert torch.equal(pd_fixed_chain(x, c, params, dilations=(80, 80)), want)
    with pytest.raises(ValueError, match=r"2 \* chain"):  # T < 2 x 192
        pd_fixed_chain(x[:, :380], c[:, :380], params, dilations=(80, 80))
    many = _chain_weights(16, 32, 10, (1,) * 17, False, cuda, torch.float32)
    with pytest.raises(ValueError):  # 17 blocks > MAX_CHAIN
        pd_fixed_chain(x, c, many, dilations=(1,) * 17)


def _down_params(cin, C, seed, strided, device, dtype):
    r = np.random.default_rng(seed)
    out = {}
    for name, K, ci in (("conv1", 3, cin), ("conv2", 3, C), ("conv3", 3, C),
                        ("res_conv", 1, cin)):
        w = torch.from_numpy((r.standard_normal((C, ci, K))
                              / np.sqrt(K * ci)).astype(np.float32))
        w = w.permute(2, 1, 0) if strided else w.permute(2, 1, 0).contiguous()
        b = torch.from_numpy((0.1 * r.standard_normal(C)).astype(np.float32))
        out[name] = {"w": w.to(device, dtype), "b": b.to(device, dtype)}
    return out


# B, T, Cin, C, dilations, strided weights
DOWN_CASES = [
    (2, 1600, 1, 24, (1, 2, 4), True),    # the generator's blocks, short
    (2, 960, 24, 48, (1, 2, 4), True),
    (2, 544, 48, 96, (1, 2, 4), True),
    (2, 200, 96, 192, (1, 2, 4), True),
    (1, 100, 24, 48, (1, 2, 4), False),   # T not a multiple of 32
    (2, 20, 8, 16, (1, 2, 4), False),     # T below 2 x the JAX halo
    (1, 5, 4, 24, (1, 2, 4), False),      # T below the reach
    (2, 300, 16, 40, (2, 3, 5), False),   # other dilations, C % 32 != 0
    (8, 800, 96, 192, (1, 2, 4), True),   # the decode batch's last block
    (2, 257, 192, 192, (8, 8, 16), False),  # the widest, the longest reach
    (3, 130, 5, 12, (1, 2, 4), False),    # C % 8 != 0
]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,Cin,C,dils,strided", DOWN_CASES)
def test_down_chain_kernel_matches_plain(cuda, dtype, tol, B, T, Cin, C, dils,
                                         strided):
    r = np.random.default_rng(T + C)
    x = torch.from_numpy(r.standard_normal((B, T, Cin)).astype(np.float32))
    x = x.to(cuda, dtype)
    params = _down_params(Cin, C, T, strided, cuda, dtype)
    before = down_chain_fwd.launches
    got = down_chain_fwd(x, params, dilations=dils)
    torch.cuda.synchronize()
    assert down_chain_fwd.launches == before + 1
    _close(got, down_chain_fwd_plain(x, params, dilations=dils), tol)


def test_down_chain_kernel_rejects_a_strided_input(cuda):
    x = torch.zeros((64, 2, 24), device=cuda).transpose(0, 1)
    with pytest.raises(ValueError):
        down_chain_fwd(x, _down_params(24, 48, 0, False, cuda, torch.float32))


def test_down_chain_entry_refuses_a_plan_no_instance_takes(cuda):
    """The C entry checks the plan: the other dtype's variant, a tile past
    what the variant holds, an unknown variant or no packed-weight scratch
    returns a CUDA error before any launch."""
    x = torch.zeros((2, 640, 24), device=cuda)
    params = _down_params(24, 48, 0, False, cuda, torch.float32)
    y = torch.empty((2, 640, 48), device=cuda)
    plan = down_plan(torch.float32, 2, 640, 24, 48, (1, 2, 4))
    wpack = torch.empty(dc_mod.pack_elems("ffma", 24, 48), device=cuda)
    fn = _build.kernel("down_chain_fwd_f32", dc_mod._ARGTYPES)
    top = dc_mod.max_tile("ffma", 24, 48, (1, 2, 4))
    for variant, rows, scratch in (("mma", plan["tile_rows"], True),
                                   ("ffma", top + 1, True), (5, 64, True),
                                   ("ffma", plan["tile_rows"], False)):
        a = dc_mod._Args()
        a.x, a.y = x.data_ptr(), y.data_ptr()
        a.wpack = wpack.data_ptr() if scratch else None
        for i, name in enumerate(dc_mod._CONVS):
            w = params[name]["w"]
            a.w[i] = w.data_ptr()
            a.w_sk[i], a.w_si[i], a.w_so[i] = w.stride()
            a.b[i] = params[name]["b"].data_ptr()
        a.B, a.T, a.Cin, a.C = 2, 640, 24, 48
        for j, d in enumerate((1, 2, 4)):
            a.dil[j] = d
        a.variant = dc_mod.DOWN_VARIANTS.get(variant, variant)
        a.tile_rows, a.n_blocks = rows, plan["n_blocks"]
        assert fn(ctypes.byref(a), _build.stream_handle(x.device)) != 0
    # the pack entry refuses the other dtype's layout and no destination
    pack = _build.kernel("down_chain_pack_f32", dc_mod._ARGTYPES)
    for variant, dest in (("mma", True), ("ffma", False)):
        a = dc_mod._Args()
        dc_mod._fill_weights(a, params)
        a.wpack = wpack.data_ptr() if dest else None
        a.Cin, a.C = 24, 48
        a.variant = dc_mod.DOWN_VARIANTS[variant]
        assert pack(ctypes.byref(a), _build.stream_handle(x.device)) != 0


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_down_chain_packs_a_set_of_weights_once(cuda, dtype, tol):
    """The weights are packed on their first call and the copy is reused
    while they stay unchanged: two calls launch one pack and two chains; a
    weight changed in place (its version moves) is packed again, and the
    result follows the new weight."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((2, 300, 24)).astype(np.float32))
    x = x.to(cuda, dtype)
    params = _down_params(24, 48, 7, True, cuda, dtype)
    before = (dc_mod.pack_weights.launches, down_chain_fwd.launches)
    first = down_chain_fwd(x, params)
    again = down_chain_fwd(x, params)
    torch.cuda.synchronize()
    assert (dc_mod.pack_weights.launches - before[0],
            down_chain_fwd.launches - before[1]) == (1, 2)
    assert torch.equal(first, again)
    params["conv2"]["w"].mul_(0.5)
    got = down_chain_fwd(x, params)
    torch.cuda.synchronize()
    assert dc_mod.pack_weights.launches - before[0] == 2
    _close(got, down_chain_fwd_plain(x, params), tol)


def test_generator_with_the_down_chain_on_the_card_matches_the_cpu(cuda):
    g = torch.Generator().manual_seed(0)
    model = FastSVCGenerator(in_channels=8, mid_channels=(16, 8),
                             upsampling_scales=(4, 5), spk_emb_size=12,
                             generator=g).eval()
    r = np.random.default_rng(1)
    ins = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
           for s in ((2, 10, 8), (2, 200, 1), (2, 200, 1), (2, 12))]
    set_down_chain_mode("1")
    try:
        with torch.no_grad():
            want = model(*ins, fuse_film=True)
            before = (window_conv.launches, down_chain_fwd.launches)
            got = model.to(cuda)(*(t.to(cuda) for t in ins), fuse_film=True)
            torch.cuda.synchronize()
    finally:
        set_down_chain_mode("0")
    # 2 down blocks x 2 chains; 3 FiLM + 6 up convs x 2 blocks
    assert (window_conv.launches - before[0],
            down_chain_fwd.launches - before[1]) == (6 + 12, 4)
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item()


def test_vocoder_with_chains_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """FASTSVC_PD_CHAIN=5: the noise net's five blocks and the filter net's
    (1, 2, 1, 2, 1) run as two chains, its last block alone."""
    monkeypatch.setenv("FASTSVC_PD_CHAIN", "5")
    g = torch.Generator().manual_seed(0)
    hop = 40
    model = HNUSFGANGenerator(
        harmonic_params=dict(blockA=4, cycleA=2, blockF=0, cycleF=0),
        noise_params=dict(blockA=0, cycleA=0, blockF=5, cycleF=5),
        filter_params=dict(blockA=0, cycleA=0, blockF=6, cycleF=3),
        residual_channels=16, gate_channels=32, skip_channels=16,
        aux_channels=10, upsample_scales=(5, 4, 2), pd_frame_hop=hop,
        generator=g).eval().fold_weight_norm_()
    r = np.random.default_rng(2)
    B, Tf = 2, 32
    f0 = r.uniform(80, 400, (B, Tf))
    d = np.repeat(8000 / (f0 * 4), hop, axis=1).astype(np.float32)
    ins = [torch.from_numpy(a) for a in (
        (0.1 * r.standard_normal((B, Tf * hop, 2))).astype(np.float32),
        r.standard_normal((B, Tf + 4, 10)).astype(np.float32), d)]
    counters = (pd_adaptive_block, pd_fixed_chain, pd_fixed_block)
    with torch.no_grad():
        want = model(*ins)
        before = [k.launches for k in counters]
        got = model.to(cuda)(*(t.to(cuda) for t in ins))
        torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [4, 2, 1]
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * b.abs().max().item()


def _wide_vocoder(R, G, A, generator):
    return HNUSFGANGenerator(
        harmonic_params=dict(blockA=2, cycleA=2, blockF=0, cycleF=0),
        noise_params=dict(blockA=0, cycleA=0, blockF=2, cycleF=2),
        filter_params=dict(blockA=0, cycleA=0, blockF=2, cycleF=1),
        residual_channels=R, gate_channels=G, skip_channels=R,
        aux_channels=A, upsample_scales=(5, 4, 2), pd_frame_hop=40,
        generator=generator).eval().fold_weight_norm_()


@pytest.mark.parametrize("chain,launches", [("0", [2, 4, 0]),
                                            ("5", [2, 0, 2])])
@pytest.mark.parametrize("R,G,A", [(64, 128, 96), (64, 160, 62)])
def test_vocoder_wider_than_the_shared_walks_on_the_card_matches_the_cpu(
        cuda, monkeypatch, R, G, A, chain, launches):
    """3R + A = 288 > 272, or G = 160 > 128: the JAX vocoder runs these
    widths, so the port's does too: every block and chain launches its
    kernel on the wide walk (two adaptive blocks and four fixed ones, or
    the fixed ones as two chains with FASTSVC_PD_CHAIN=5)."""
    monkeypatch.setenv("FASTSVC_PD_CHAIN", chain)
    monkeypatch.delenv("FASTSVC_PD_CHAIN_HALO", raising=False)
    model = _wide_vocoder(R, G, A, torch.Generator().manual_seed(5))
    r = np.random.default_rng(6)
    B, Tf, hop = 2, 32, 40
    assert block_plan(torch.float32, B, Tf * hop, R, A, G)["variant"] == \
        "wide"
    f0 = r.uniform(80, 400, (B, Tf))
    d = np.repeat(8000 / (f0 * 4), hop, axis=1).astype(np.float32)
    ins = [torch.from_numpy(a) for a in (
        (0.1 * r.standard_normal((B, Tf * hop, 2))).astype(np.float32),
        r.standard_normal((B, Tf + 4, A)).astype(np.float32), d)]
    counters = (pd_adaptive_block, pd_fixed_block, pd_fixed_chain)
    with torch.no_grad():
        want = model(*ins)
        before = [k.launches for k in counters]
        got = model.to(cuda)(*(t.to(cuda) for t in ins))
        torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == launches
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * b.abs().max().item()


def test_vocoder_chain_past_the_old_reach_on_the_card_matches_the_cpu(
        cuda, monkeypatch):
    """FASTSVC_PD_CHAIN=10 and FASTSVC_PD_CHAIN_HALO=512 group the filter
    cycle (1, 2, ..., 128) into one run of 8 blocks, 255 rows of reach (past
    the old kernel's 159): it runs as one chain on the card, equal to the
    same module on the CPU."""
    monkeypatch.setenv("FASTSVC_PD_CHAIN", "10")
    monkeypatch.setenv("FASTSVC_PD_CHAIN_HALO", "512")
    model = HNUSFGANGenerator(
        harmonic_params=dict(blockA=2, cycleA=2, blockF=0, cycleF=0),
        noise_params=dict(blockA=0, cycleA=0, blockF=2, cycleF=2),
        filter_params=dict(blockA=0, cycleA=0, blockF=10, cycleF=1),
        residual_channels=16, gate_channels=32, skip_channels=16,
        aux_channels=10, upsample_scales=(5, 4, 2), pd_frame_hop=40,
        generator=torch.Generator().manual_seed(7)).eval().fold_weight_norm_()
    r = np.random.default_rng(8)
    B, Tf, hop = 2, 40, 40
    f0 = r.uniform(80, 400, (B, Tf))
    d = np.repeat(8000 / (f0 * 4), hop, axis=1).astype(np.float32)
    ins = [torch.from_numpy(a) for a in (
        (0.1 * r.standard_normal((B, Tf * hop, 2))).astype(np.float32),
        r.standard_normal((B, Tf + 4, 10)).astype(np.float32), d)]
    plan = model.filter_network.plan(Tf * hop)
    assert plan[0] == ("chain", list(range(8)))
    counters = (pd_adaptive_block, pd_fixed_chain, pd_fixed_block)
    with torch.no_grad():
        want = model(*ins)
        before = [k.launches for k in counters]
        got = model.to(cuda)(*(t.to(cuda) for t in ins))
        torch.cuda.synchronize()
    # the noise net's (1, 2) is a chain too; the filter net's last two
    # blocks (256, 512) stay alone
    assert [k.launches - b for k, b in zip(counters, before)] == [2, 2, 2]
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * b.abs().max().item()


def test_train_step_is_bit_stable_on_the_card(cuda):
    """Two gan_steps from one state give equal gradients under cuDNN's
    deterministic algorithms, which the training CLI sets."""
    from svcc23_fastsvc_tpu_torch.bin.common import deterministic_cudnn
    from svcc23_fastsvc_tpu_torch.config import build_train_task

    cfg = {"sampling_rate": 4000, "hop_size": 20,
           "generator_params": dict(in_channels=8, mid_channels=[16, 8],
                                    upsampling_scales=[4, 5],
                                    spk_emb_size=12, use_spk_emb=True),
           "discriminator_params": {"scales": 2, "channels": 4,
                                    "max_downsample_channels": 32,
                                    "downsample_scales": [4, 4]},
           "stft_loss_params": {"fft_sizes": [64, 128], "hop_sizes": [16, 32],
                                "win_lengths": [64, 128]}}
    r = np.random.default_rng(3)
    batch = {k: torch.from_numpy(v.astype(np.float32)).to(cuda) for k, v in {
        "ppg": r.standard_normal((4, 40, 8)),
        "f0": r.uniform(80, 300, (4, 40, 1)),
        "lft": r.standard_normal((4, 800, 1)),
        "spk_emb": r.standard_normal((4, 12)),
        "audio": 0.3 * r.standard_normal((4, 800, 1))}.items()}
    runs = []
    saved = torch.backends.cudnn.deterministic
    deterministic_cudnn()
    try:
        for _ in range(2):
            task = build_train_task(cfg, device=cuda, seed=1)
            log = []
            for opt in (task.g_opt, task.d_opt):
                def rec(grads, step=opt.step):
                    log.append([g.detach().clone() for g in grads])
                    return step(grads)
                opt.step = rec
            task.gan_step(batch)
            runs.append(log)
    finally:
        torch.backends.cudnn.deterministic = saved
    for ga, gb in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(ga, gb))


# B, T, Cin, Cout, K, dilation, (lo, hi), slope, bias: the JAX kernel's
# test cases (tests/test_pallas_conv.py), K = 2 and K = 4 with pads past
# one side, T that divides no tile (300, 750, 3000), windows past both ends
# at d = 27, and the Tacotron2 bap stream's widths (86 -> 43 at T = 400,
# 21 -> 3 at its T + 2 = 402)
FUSED_CASES = [
    (2, 1600, 24, 24, 3, 27, (27, 27), None, True),
    (2, 1600, 24, 24, 3, 1, (1, 1), 0.2, True),
    (1, 960, 48, 48, 3, 9, (9, 9), 0.2, False),
    (2, 320, 1, 24, 3, 1, (1, 1), None, True),
    (2, 640, 24, 24, 2, 1, (1, 0), None, True),
    (2, 320, 192, 192, 3, 3, (3, 3), 0.2, True),
    (2, 750, 24, 24, 3, 9, (9, 9), 0.2, True),
    (1, 3000, 48, 48, 3, 27, (27, 27), None, True),
    (2, 300, 24, 48, 3, 1, (1, 1), 0.2, False),
    (2, 300, 24, 24, 4, 1, (2, 1), 0.2, True),
    (2, 257, 12, 20, 4, 16, (0, 48), 0.2, True),
    (1, 300, 8, 8, 5, 16, (64, 0), None, True),
    (4, 400, 86, 43, 3, 2, (2, 2), None, True),
    (4, 402, 21, 3, 3, 2, (2, 2), None, True),
]


def _fused_case(B, T, Cin, Cout, K, dtype, device, seed):
    x, w, b = _conv_case(B, T, Cin, Cout, K, seed)
    g = np.random.default_rng(seed + 1).standard_normal((B, T, Cout))
    return (torch.from_numpy(a).to(device, dtype) for a in (x, w, b, g))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T,Cin,Cout,K,dil,pads,slope,bias", FUSED_CASES)
def test_fused_conv_kernels_match_plain(cuda, dtype, tol, B, T, Cin, Cout, K,
                                        dil, pads, slope, bias):
    x, w, b, g = _fused_case(B, T, Cin, Cout, K, dtype, cuda, T + Cout)
    b = b if bias else None
    lo, hi = pads
    before = (fused_conv1d.launches, fused_conv1d_bwd.launches)
    y = fused_conv1d(x, w, b, lo, hi, dil, slope)
    grads = fused_conv1d_bwd(x, g, w, lo, hi, dil, slope)
    torch.cuda.synchronize()
    assert (fused_conv1d.launches, fused_conv1d_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _close(y, fused_conv1d_plain(x, w, b, lo, hi, dil, slope), tol)
    for got, want in zip(grads, fused_conv1d_bwd_plain(x, g, w, lo, hi, dil,
                                                        slope)):
        _close(got, want, tol)
    # a fixed partition of the rows and no atomics: the same sums every run
    again = fused_conv1d_bwd(x, g, w, lo, hi, dil, slope)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


def test_fused_conv_kernels_take_a_strided_weight_view(cuda):
    x, w, b, g = _fused_case(2, 400, 16, 24, 3, torch.float32, cuda, 5)
    view = w.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    assert not view.is_contiguous()
    _close(fused_conv1d(x, view, b, 2, 4, 3, 0.2),
           fused_conv1d_plain(x, w, b, 2, 4, 3, 0.2), 2e-4)
    for got, want in zip(fused_conv1d_bwd(x, g, view, 2, 4, 3, 0.2),
                         fused_conv1d_bwd_plain(x, g, w, 2, 4, 3, 0.2)):
        _close(got, want, 2e-4)


def test_fused_conv_backward_entry_refuses_a_plan_no_instance_takes(cuda):
    """The C entry checks the plan (variant, row tile, slab) before any
    launch: an unknown row tile, mma in f32 or a slab the slot scratch was
    not sized for returns a CUDA error."""
    x, w, _, g = _fused_case(2, 640, 24, 24, 3, torch.float32, cuda, 7)
    plan = bwd_plan(torch.float32, 2, 640, 3, 24, 24)
    n = plan["n_slots"]
    part_w = torch.empty((n, 3, 24, 24), device=cuda)
    part_b = torch.empty((n, 24), device=cuda)
    dx, dw, db = (torch.empty_like(x), torch.empty((3, 24, 24), device=cuda),
                  torch.empty(24, device=cuda))
    fn = _build.kernel("fused_conv_bwd_f32", fc_mod._BWD_ARGTYPES)
    for variant, rows, isl, n_islabs in (("ffma", 128, 24, 1),
                                         ("mma", 64, 32, 1),
                                         ("ffma", 64, 24, 2)):
        err = fn(x.data_ptr(), g.data_ptr(), w.data_ptr(), dx.data_ptr(),
                 part_w.data_ptr(), part_b.data_ptr(), dw.data_ptr(),
                 db.data_ptr(), 2, 640, 24, 24, 3, 1, 1, *w.stride(), 1, 0.2,
                 0.2, fc_mod.BWD_VARIANTS[variant], rows, n, isl, n_islabs, 1,
                 _build.stream_handle(x.device))
        assert err != 0


def test_mma_instances_run_on_the_tensor_cores(cuda):
    """The bf16 mma instances of the fused-conv backward (#6), the gated
    blocks (#8, #10), the chain (#9) and the down chain (#7) hold HMMA
    instructions in their SASS."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        pytest.skip("the toolkit has no cuobjdump")
    out = subprocess.run([tool, "-sass", _build.build()], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            fn = name if any(k in name for k in (
                "fused_bwd_mma", "pd_block_mma", "pd_chain_mma",
                "down_chain_mma")) else None
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    assert sum("fused_bwd_mma" in k for k in counts) == 2
    assert sum("pd_block_mma" in k for k in counts) == 2
    assert sum("pd_chain_mma" in k for k in counts) == 1
    assert sum("down_chain_mma" in k for k in counts) == 2
    assert all(n > 0 for n in counts.values()), counts


def test_fused_conv_backward_can_skip_dx(cuda):
    x, w, _, g = _fused_case(2, 300, 1, 24, 3, torch.float32, cuda, 6)
    dx, dw, db = fused_conv1d_bwd(x, g, w, 1, 1, 1, 0.2, need_dx=False)
    _, want_w, want_b = fused_conv1d_bwd_plain(x, g, w, 1, 1, 1, 0.2)
    assert dx is None
    _close(dw, want_w, 2e-4)
    _close(db, want_b, 2e-4)


def test_fused_conv_function_on_the_card_matches_the_cpu(cuda):
    x, w, b = _conv_case(2, 500, 24, 48, 3, seed=11)
    g = np.random.default_rng(12).standard_normal((2, 500, 48)).astype(
        np.float32)
    outs = []
    for dev in ("cpu", cuda):
        args = [torch.from_numpy(a).to(dev).requires_grad_()
                for a in (x, w, b)]
        y = FusedConv1d.apply(*args, 9, 9, 9, 0.2)
        grads = torch.autograd.grad(y, args, torch.from_numpy(g).to(dev))
        outs.append([t.detach().cpu() for t in (y, *grads)])
    for got, want in zip(outs[1], outs[0]):
        _close(got, want, 2e-4)


def test_generator_step_with_the_switch_on_the_card_matches_the_cpu(cuda):
    """A small generator's forward and parameter gradients with
    FASTSVC_PALLAS_CONV=1, card against CPU (plain versions): its T = 600
    convs take #5 and #6, the rest the window conv."""
    model = FastSVCGenerator(in_channels=8, mid_channels=(16, 8),
                             upsampling_scales=(4, 5), spk_emb_size=12,
                             generator=torch.Generator().manual_seed(0))
    r = np.random.default_rng(2)
    ins = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
           for s in ((2, 30, 8), (2, 600, 1), (2, 600, 1), (2, 12))]
    saved = conv_mod.pallas_conv_mode()
    conv_mod.set_pallas_conv_mode("1")
    try:
        outs = []
        for dev in ("cpu", cuda):
            m = model.to(dev)
            m.zero_grad()
            before = (fused_conv1d.launches, fused_conv1d_bwd.launches)
            y = m(*(t.to(dev) for t in ins))
            (y * y).sum().backward()
            if dev == cuda:
                torch.cuda.synchronize()
                assert (fused_conv1d.launches - before[0],
                        fused_conv1d_bwd.launches - before[1]) == (17, 17)
            # copies: moving the module moves its grads' storage too
            outs.append([t.detach().cpu().clone() for t in
                         (y, *(p.grad for p in m.parameters()))])
    finally:
        conv_mod.set_pallas_conv_mode(saved)
    y_cpu, *g_cpu = outs[0]
    y_gpu, *g_gpu = outs[1]
    _close(y_gpu, y_cpu, 1e-4)
    scale = max(g.abs().max().item() for g in g_cpu)
    for a, c in zip(g_gpu, g_cpu):
        assert (a - c).abs().max().item() <= 1e-3 * scale
