"""The port's fused conv (`ops/fused_conv.py`, kernels #5 and #6) and its
switch (`ops/conv.py::set_pallas_conv_mode`) against the JAX package.

`fused_conv1d_plain` and `FusedConv1d`'s backward on the CPU are held to
JAX `pallas_conv1d` (interpret mode off the TPU, as tests/test_pallas_conv.py
runs it) at that file's nine f32 cases and its bf16 case, with its
tolerances; the port's gate to JAX's over a grid; a small FastSVC generator
under mode "1" to the JAX generator under mode "1" (the calls it makes, its
output and its parameter gradients); the small HN-uSFGAN makes no fused
call in either package. Inputs are made with numpy from a seed. Every test
that switches a package's mode restores the mode it found.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svcc23_fastsvc_tpu.models.fastsvc import FastSVCGenerator as JaxGen
from svcc23_fastsvc_tpu.ops import conv as jconv
from svcc23_fastsvc_tpu.ops import pallas_conv as jpc
from svcc23_fastsvc_tpu_torch.compat import generator_state_dict_from_jax
from svcc23_fastsvc_tpu_torch.models.fastsvc import FastSVCGenerator
from svcc23_fastsvc_tpu_torch.ops import conv as tconv
from svcc23_fastsvc_tpu_torch.ops import fused_conv as fc


def _t(a, dtype=torch.float32):
    """numpy or JAX array -> torch, through f32 (exact for bf16 values)."""
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


@pytest.fixture
def modes():
    """Restore both packages' fused-conv modes after the test."""
    saved = (jconv._PALLAS_CONV_MODE, tconv._PALLAS_CONV_MODE)
    yield
    jconv.set_pallas_conv_mode(saved[0])
    tconv.set_pallas_conv_mode(saved[1])


@pytest.fixture
def calls(monkeypatch):
    """The fused-conv calls each package makes: x shapes, JAX and port."""
    seen = {"jax": [], "port": []}
    jfwd, tfwd = jpc.pallas_conv1d, fc.fused_conv1d

    def jspy(x, *a):
        seen["jax"].append(tuple(x.shape))
        return jfwd(x, *a)

    def tspy(x, *a, **kw):
        seen["port"].append(tuple(x.shape))
        return tfwd(x, *a, **kw)

    monkeypatch.setattr(jpc, "pallas_conv1d", jspy)
    monkeypatch.setattr(fc, "fused_conv1d", tspy)
    return seen


# tests/test_pallas_conv.py's cases: B, T, Ci, Co, K, d, slope, bias
CASES = [
    (2, 1600, 24, 24, 3, 27, None, True),
    (2, 1600, 24, 24, 3, 1, 0.2, True),
    (1, 960, 48, 48, 3, 9, 0.2, False),
    (2, 320, 1, 24, 3, 1, None, True),
    (2, 640, 24, 24, 2, 1, None, True),  # K=2, pads (1, 0)
    (2, 320, 192, 192, 3, 3, 0.2, True),
    (2, 750, 24, 24, 3, 9, 0.2, True),
    (1, 3000, 48, 48, 3, 27, None, True),
    (2, 300, 24, 48, 3, 1, 0.2, False),
]


def _pads(K, d):
    span = (K - 1) * d
    return (1, 0) if K == 2 else (span // 2, span - span // 2)


def _port_fwd_bwd(x, w, b, g, lo, hi, d, slope, dtype):
    args = [_t(a, dtype).requires_grad_() if a is not None else None
            for a in (x, w, b)]
    y = fc.FusedConv1d.apply(*args, lo, hi, d, slope)
    y.backward(_t(g, dtype))
    return y.detach(), [a.grad for a in args if a is not None]


@pytest.mark.parametrize("B,T,Ci,Co,K,d,slope,use_bias", CASES)
def test_plain_and_backward_match_jax_kernel(B, T, Ci, Co, K, d, slope,
                                             use_bias):
    lo, hi = _pads(K, d)
    r = np.random.default_rng(1234)
    x = r.standard_normal((B, T, Ci)).astype(np.float32)
    w = (r.standard_normal((K, Ci, Co)) * 0.3).astype(np.float32)
    b = r.standard_normal((Co,)).astype(np.float32) if use_bias else None
    g = r.standard_normal((B, T, Co)).astype(np.float32)
    jb = None if b is None else jnp.asarray(b)
    want = jpc.pallas_conv1d(jnp.asarray(x), jnp.asarray(w), jb, lo, hi, d,
                             slope)
    argnums = (0, 1, 2) if use_bias else (0, 1)
    jgrads = jax.grad(
        lambda x_, w_, b_: jnp.sum(
            jpc.pallas_conv1d(x_, w_, b_, lo, hi, d, slope) * g),
        argnums)(jnp.asarray(x), jnp.asarray(w), jb)
    y, grads = _port_fwd_bwd(x, w, b, g, lo, hi, d, slope, torch.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert len(grads) == len(jgrads)
    for got, ref in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=3e-4)


def test_bf16_matches_jax_kernel():
    """tests/test_pallas_conv.py's bf16 case: the output within 2e-2, the
    gradients within JAX's own 5e-2 / 5e-1 (bf16 sums over B*T terms)."""
    B, T, Ci, Co, K, d = 2, 750, 24, 24, 3, 9
    r = np.random.default_rng(7)
    x, w, b, g = (jnp.asarray(r.standard_normal(s) * sc, jnp.bfloat16)
                  for s, sc in (((B, T, Ci), 1.0), ((K, Ci, Co), 0.3),
                                ((Co,), 1.0), ((B, T, Co), 1.0)))
    want = jpc.pallas_conv1d(x, w, b, d, d, d, 0.2)
    jgrads = jax.grad(
        lambda x_, w_, b_: jnp.sum(
            jpc.pallas_conv1d(x_, w_, b_, d, d, d, 0.2).astype(jnp.float32)
            * g.astype(jnp.float32)), (0, 1, 2))(x, w, b)
    y, grads = _port_fwd_bwd(x, w, b, g, d, d, d, 0.2, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    for got, ref in zip(grads, jgrads):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=5e-2,
                                   atol=5e-1)


def test_leaky_slope_rounds_as_the_jax_kernel_in_bf16():
    """The activation multiplies by the slope rounded to bf16 (JAX `_leaky`
    multiplies in the stream dtype), so a K=2 conv of a one-hot weight
    returns JAX's activated input bit for bit."""
    x = jnp.asarray(np.random.default_rng(3).standard_normal((1, 256, 4)),
                    jnp.bfloat16)
    w = jnp.asarray(np.eye(4)[None].repeat(2, 0) * [[[1.0]], [[0.0]]],
                    jnp.bfloat16)
    want = np.asarray(jpc.pallas_conv1d(x, w, None, 0, 1, 1, 0.2),
                      np.float32)
    got = fc.fused_conv1d(_t(x, torch.bfloat16), _t(w, torch.bfloat16), None,
                          0, 1, 1, 0.2)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gate_agrees_with_jax():
    n = 0
    for K, d, T, C, stride, groups in itertools.product(
            (1, 2, 3, 4, 5, 6), (1, 2, 9, 16, 27, 33), (200, 255, 256, 750),
            (24, 192), (1, 2), (1, 4)):
        span = (K - 1) * d
        for lo, hi in {(span // 2, span - span // 2), (0, span), (span, 0),
                       (1, 1), (0, 0), (65, span - 65)}:
            shapes = ((2, T, C), (K, C // groups, C))
            kw = dict(stride=stride, groups=groups, lo=lo, hi=hi, dilation=d)
            want = jpc.pallas_conv1d_supported(*shapes, **kw)
            assert fc.fused_conv1d_supported(*shapes, **kw) == want, (
                shapes, kw)
            n += want
    assert n > 100


def test_modes_are_checked(modes, monkeypatch):
    with pytest.raises(ValueError):
        tconv.set_pallas_conv_mode("on")
    monkeypatch.setattr(tconv, "_PALLAS_CONV_MODE", "yes")
    with pytest.raises(ValueError):
        tconv.decide_conv_lowering("cpu")
    tconv.set_pallas_conv_mode("1")
    assert tconv.decide_conv_lowering("cpu") == "fused+window"
    tconv.set_pallas_conv_mode("0")
    assert tconv.decide_conv_lowering("cpu") == "window"
    # "auto" takes the kernel on CUDA tensors only, after its probe
    tconv.set_pallas_conv_mode("auto")
    assert tconv.decide_conv_lowering("cpu") == "window"


def test_auto_probe_passes_and_a_failing_probe_raises(modes, monkeypatch):
    tconv.fused_conv_selfcheck("cpu")  # the plain versions agree with each other
    real = fc.fused_conv1d
    monkeypatch.setattr(fc, "fused_conv1d",
                        lambda *a, **kw: real(*a, **kw) * 1.5)
    with pytest.raises(RuntimeError, match="probe"):
        tconv.fused_conv_selfcheck("cpu")
    # in "auto" mode a CUDA device runs the probe, and its failure raises
    # rather than pinning the process to the window conv
    ran = []

    def probe(device):
        ran.append(device)
        raise RuntimeError("fused-conv probe failed")

    monkeypatch.setattr(tconv, "fused_conv_selfcheck", probe)
    tconv.set_pallas_conv_mode("auto")
    with pytest.raises(RuntimeError, match="probe failed"):
        tconv.decide_conv_lowering("cuda:0")
    assert ran == ["cuda:0"]
    monkeypatch.setattr(tconv, "fused_conv_selfcheck", ran.append)
    assert tconv.decide_conv_lowering("cuda:0") == "fused+window"
    assert tconv.decide_conv_lowering("cuda:0") == "fused+window"
    assert ran == ["cuda:0", "cuda:0"]  # probed once per device


def test_generator_under_the_switch_matches_jax(modes, calls):
    """JAX's small generator (tests/test_pallas_conv.py), 30 frames: the
    T = 600 level's convs (3 in each of the two first DownsampleBlocks, 3
    in each of its two FiLM blocks, 5 in the last UpsampleBlock) take the
    fused conv in both packages, the T = 120 and 30 levels the other
    lowering. Same calls, output and parameter gradients."""
    kw = dict(in_channels=8, mid_channels=(16, 8), upsampling_scales=(4, 5),
              spk_emb_size=16)
    jgen = JaxGen(**kw)
    params = jgen.init(jax.random.PRNGKey(0))
    r = np.random.default_rng(1234)
    T = 30 * 20
    ins = [r.standard_normal(s).astype(np.float32)
           for s in ((2, 30, 8), (2, T, 1), (2, T, 1), (2, 16))]
    ins[1] *= 0.1

    def loss(p):
        y = jgen.apply(p, *map(jnp.asarray, ins))
        return jnp.sum(y * y), y

    jconv.set_pallas_conv_mode("1")
    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    port = FastSVCGenerator(**kw)
    port.load_state_dict(generator_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    tconv.set_pallas_conv_mode("1")
    y = port(*map(torch.from_numpy, ins))
    (y * y).sum().backward()
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 17
    assert set(calls["port"]) == {(2, 600, 1), (2, 600, 8)}
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    want_g = generator_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    got_g = {k: p.grad for k, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    for k, ref in want_g.items():
        np.testing.assert_allclose(got_g[k].numpy(), ref.numpy(), rtol=2e-4,
                                   atol=1e-3, err_msg=k)


def test_generator_under_the_switch_launches_no_kernel_on_the_cpu(modes):
    """On CPU tensors the wrappers take their plain versions: the launch
    counts stay where they were, forward and backward."""
    tconv.set_pallas_conv_mode("1")
    port = FastSVCGenerator(in_channels=8, mid_channels=(16, 8),
                            upsampling_scales=(4, 5), spk_emb_size=16,
                            generator=torch.Generator().manual_seed(0))
    r = np.random.default_rng(5)
    ins = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
           for s in ((1, 15, 8), (1, 300, 1), (1, 300, 1), (1, 16))]
    before = (fc.fused_conv1d.launches, fc.fused_conv1d_bwd.launches)
    port(*ins).sum().backward()
    assert (fc.fused_conv1d.launches, fc.fused_conv1d_bwd.launches) == before


def test_hnusfgan_makes_no_fused_call(modes, calls):
    """The vocoder's FixedBlock reflect-pads, then convs VALID, and its
    periodicity estimator edge-pads: lo + hi is not the reach, so neither
    package sends a vocoder conv to the fused conv."""
    from svcc23_fastsvc_tpu.models.hnusfgan import HNUSFGANGenerator as JaxV
    from svcc23_fastsvc_tpu_torch.compat import hnusfgan_state_dict_from_jax
    from svcc23_fastsvc_tpu_torch.models.hnusfgan import HNUSFGANGenerator

    kw = dict(
        harmonic_params=dict(blockA=2, cycleA=2, blockF=0, cycleF=0,
                             cascade_mode=0),
        noise_params=dict(blockA=0, cycleA=0, blockF=2, cycleF=2,
                          cascade_mode=0),
        filter_params=dict(blockA=0, cycleA=0, blockF=3, cycleF=3,
                           cascade_mode=0),
        residual_channels=8, gate_channels=16, skip_channels=8,
        aux_channels=10, aux_context_window=2, upsample_scales=(4, 5),
    )
    jvoc = JaxV(**kw)
    params = jvoc.init(jax.random.PRNGKey(0))
    r = np.random.default_rng(9)
    B, Tf, hop = 2, 20, 20
    T = (Tf - 4) * hop
    x = (r.standard_normal((B, T, 2)) * 0.1).astype(np.float32)
    c = r.standard_normal((B, Tf, 10)).astype(np.float32)
    d = (r.random((B, T)) * 2 + 0.5).astype(np.float32)
    jconv.set_pallas_conv_mode("1")
    jax.make_jaxpr(jvoc.apply)(params, x, c, d)
    port = HNUSFGANGenerator(**kw, pd_frame_hop=hop)
    port.load_state_dict(hnusfgan_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    tconv.set_pallas_conv_mode("1")
    with torch.no_grad():
        port.eval()(*map(torch.from_numpy, (x, c, d)))
    assert calls == {"jax": [], "port": []}


def test_trainer_decides_the_conv_lowering_at_init(modes, caplog):
    """As the JAX trainer does: the lowering (and in "auto" mode the probe)
    is decided before the first step, kept and logged."""
    import logging
    from types import SimpleNamespace

    from svcc23_fastsvc_tpu_torch.train.loop import Trainer

    task = SimpleNamespace(device=torch.device("cpu"))
    with caplog.at_level(logging.INFO):
        tconv.set_pallas_conv_mode("1")
        on = Trainer(task, None, config={}, outdir="unused")
        tconv.set_pallas_conv_mode("0")
        off = Trainer(task, None, config={}, outdir="unused")
    assert (on.conv_lowering, off.conv_lowering) == ("fused+window", "window")
    assert "conv lowering: fused+window" in caplog.text


def test_conv1d_routes_by_the_gate(modes, calls):
    """Under mode "1" `conv1d` sends a conv to the fused conv when both its
    widths are at most 192 and the rule holds, and to the other lowerings
    otherwise, with the same output."""
    tconv.set_pallas_conv_mode("1")
    r = np.random.default_rng(8)
    for cin, cout, T, K, pad, dil, fused in (
            (24, 192, 256, 3, 2, 2, True), (24, 193, 256, 3, 2, 2, False),
            (193, 24, 256, 3, 1, 1, False), (8, 8, 255, 3, 1, 1, False),
            (8, 8, 300, 2, (1, 0), 1, True), (8, 8, 300, 3, 1, 1, True),
            (8, 8, 300, 1, 1, 1, False)):
        x = torch.from_numpy(r.standard_normal((1, T, cin)).astype(np.float32))
        w = torch.from_numpy(r.standard_normal((K, cin, cout)).astype(
            np.float32))
        before = len(calls["port"])
        got = tconv.conv1d(x, w, padding=pad, dilation=dil, input_leaky=0.2)
        assert len(calls["port"]) - before == int(fused), (cin, cout, T, K)
        tconv.set_pallas_conv_mode("0")
        want = tconv.conv1d(x, w, padding=pad, dilation=dil, input_leaky=0.2)
        tconv.set_pallas_conv_mode("1")
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
