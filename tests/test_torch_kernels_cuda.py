"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (`-m cuda`) and skips where
there is none. The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu_torch.models.fastsvc import FastSVCGenerator
from svcc23_fastsvc_tpu_torch.models.hnusfgan import HNUSFGANGenerator
from svcc23_fastsvc_tpu_torch.ops.down_chain import (
    down_chain_fwd,
    down_chain_fwd_plain,
    set_down_chain_mode,
)
from svcc23_fastsvc_tpu_torch.ops.pd_block import (
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


def test_pd_block_kernels_reject_a_gate_too_wide(cuda):
    x, c = (t.to(cuda) for t in _block_inputs(1, 320, 64, 10, seed=0))
    params = _to(_block_weights("fixed", 64, 256, 10, 0, False), cuda,
                 torch.float32)
    with pytest.raises(ValueError):
        pd_fixed_block(x, c, params, dilation=1)


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
    """Each stage sums in the block kernel's order and rounds its output to
    the stream type, so the chain equals the blocks one after another."""
    dils = (1, 2, 4, 8, 16)
    x, c = (t.to(cuda, dtype) for t in _block_inputs(2, 3000, 64, 62, seed=9))
    params = _chain_weights(64, 128, 62, dils, True, cuda, dtype)
    want = x
    for p, d in zip(params, dils):
        want = pd_fixed_block(want, c, p, dilation=d)
    got = pd_fixed_chain(x, c, params, dilations=dils)
    assert torch.equal(got, want)


def test_pd_fixed_chain_kernel_refuses_a_reach_too_long(cuda):
    x, c = (t.to(cuda) for t in _block_inputs(1, 960, 16, 10, seed=0))
    params = _chain_weights(16, 32, 10, (80, 80), False, cuda, torch.float32)
    with pytest.raises(ValueError):  # 160 rows of reach > MAX_CHAIN_REACH
        pd_fixed_chain(x, c, params, dilations=(80, 80))


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
