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
